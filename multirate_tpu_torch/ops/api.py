"""User API: stateless ``filt``, streaming ``FIRFilter``, phase and reset
control, taps for a phase, and the time-major block step.

Counterpart of ``multirate_tpu/ops/api.py`` (the reference's surface:
stateless filt, Filters.jl:858-873; FIRFilter, Filters.jl:150-198;
setphase :207-232; reset :244-260; tapsforphase :677-690, 764-775) on top
of the block step:

    params = make_kernel(h, ratio=Fraction(147, 160), device="cuda")
    state  = init_state(params, batch_shape)
    y, count, state = filt_block(params, state, x_block)

The port runs where its tensors live. A torch input runs on its own
device; a numpy input runs on ``device=`` if one is given, else on the
card. The CPU is used only when the caller names it (or hands over CPU
tensors), and nothing moves a GPU computation to the CPU.

Signals are float32, float64, complex64 or complex128 for every filter
type, and bfloat16 and int8 for the quantized modes of the rational
family (``ops/quant.py`` for the int8 helpers); at an arbitrary or Farrow
rate a bfloat16 or int8 signal is widened to float32 and gives float32
outputs. The output type is JAX's
(``filt``'s docstring); ``make_kernel``'s ``store_dtype`` narrows a
rational-family kernel's outputs.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

from . import indexing as _idx
from .compute import filt_block_raw, filt_block_tm_raw
from .params import (PHASE_ONE, FIRArbitrary, FIRFarrow, FIRInterpolator,
                     FIRRational, FilterState, default_device, init_state,
                     make_kernel, to_tensor)

__all__ = [
    "filt", "filt_block", "filt_block_tm", "FIRFilter", "setphase", "reset",
    "tapsforphase", "outputlength", "inputlength", "nextphase",
    "max_outputs",
]

outputlength = _idx.outputlength
inputlength = _idx.inputlength
nextphase = _idx.nextphase
max_outputs = _idx.max_outputs

filt_block = filt_block_raw
filt_block_tm = filt_block_tm_raw


def _kernel_for(h, ratio_or_rate, nphi, polyorder, device):
    """The kernel for a ratio (Fraction, int or (L, M)) or a float rate,
    as JAX ``filt`` and ``FIRFilter`` dispatch (``api.py:83``)."""
    if isinstance(ratio_or_rate, float):
        return make_kernel(h, rate=ratio_or_rate, nphi=nphi,
                           polyorder=polyorder, device=device)
    return make_kernel(h, ratio=ratio_or_rate, device=device)


def _as_signal(x, device) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is (and must agree with
    ``device`` if one is given); a numpy array goes to ``device``, else to
    the card."""
    if isinstance(x, torch.Tensor):
        if device is not None and x.device != torch.device(device):
            raise ValueError(f"x is on {x.device}, device={device!r} asked")
        return x
    return to_tensor(x, default_device() if device is None else device)


def filt(h, x, ratio_or_rate=Fraction(1, 1), nphi: int = 32,
         polyorder=None, device=None):
    """One-shot stateless filtering and resampling.

    - ``filt(h, x, L_over_M)`` with a Fraction, int or (L, M) tuple: the
      single-rate, interpolating, decimating or rational polyphase
      resampler (reference: Filters.jl:858-861).
    - ``filt(h, x, rate: float, nphi=32)``: arbitrary-rate resampling with
      derivative-bank linear interpolation (Filters.jl:864-867).
    - ``filt(h, x, rate: float, nphi, polyorder)``: Farrow polynomial
      resampling (Filters.jl:870-873).

    ``x`` has leading channel dims; time is the last axis. On x's device.

    The output type is JAX's (``compute._out_dtype`` there): the promoted
    type of taps and signal, ``torch.promote_types(taps, x)``. So float32
    in gives float32 out, float64 taps with a float32 signal give float64
    (numpy's default taps, and what ``firdes`` returns), float32 taps with
    a complex64 signal complex64, float64 taps with a complex64 signal
    complex128, and complex taps with a real signal a complex output. The
    quantized modes: bfloat16 taps and signal give float32 accumulators,
    int8 taps and signal exact int32 accumulators. At an arbitrary or
    Farrow rate a bfloat16 or int8 signal gives float32 outputs (widened
    to float32 before the kernel, with float32 or bfloat16 taps).
    """
    x = _as_signal(x, device)
    params = _kernel_for(h, ratio_or_rate, nphi, polyorder, x.device)
    state = init_state(params, x.shape[:-1], x.dtype)
    y, _, _ = filt_block(params, state, x)
    return y


class FIRFilter:
    """Streaming (stateful) filter object, the reference's FIRFilter
    (Filters.jl:150-198).

    ``FIRFilter(h)`` or ``FIRFilter(h, Fraction(L, M))`` picks the
    single-rate, interpolator, decimator or rational kernel by the shape of
    the ratio; ``FIRFilter(h, rate: float, nphi=32)`` the arbitrary-rate
    resampler and ``FIRFilter(h, rate, nphi, polyorder)`` the Farrow
    resampler. ``filt(x)`` consumes a chunk and returns exactly the
    producible outputs; history, phase and deficit carry to the next
    chunk, so the concatenated chunked output equals the whole-vector
    output (index decisions exactly; values to the reduction order of the
    output type).

    Taps and chunks may be float32, float64, complex64 or complex128 (and
    bfloat16 or int8 in the rational family's quantized modes); each
    chunk's output has the promoted type of taps and chunk, as for
    ``filt``: float64 taps with a float32 chunk give float64, float32 taps
    with a complex64 chunk complex64, float64 taps with a complex64 chunk
    complex128. A chunk of another type than the last casts the carried
    history to its own type.

    The stream runs on ``device`` if one is given, else on the device of
    torch taps; with numpy taps and no ``device``, on its first chunk's
    device (a numpy chunk's: the card). Until then the kernel waits on the
    CPU, where it was built.
    """

    def __init__(self, h, ratio_or_rate=Fraction(1, 1), nphi: int = 32,
                 polyorder=None, device=None):
        # the device the stream is pinned to, if the caller named one
        # (explicitly or through torch taps); else its first chunk's
        self.device = (torch.device(device) if device is not None
                       else h.device if isinstance(h, torch.Tensor)
                       else None)
        self.params = _kernel_for(h, ratio_or_rate, nphi, polyorder,
                                  self.device or "cpu")
        if self.device is not None:  # "cuda" names the card's index
            self.device = self.params.device
        self.state: FilterState | None = None

    @property
    def history(self):
        return None if self.state is None else self.state.history

    def _pin(self, device):
        """Pin the stream, its kernel and any state, to ``device``."""
        self.params = self.params.to(device)
        self.device = self.params.device
        if self.state is not None:  # a setphase before the first chunk
            self.state = FilterState(
                history=self.state.history.to(self.device),
                phase=self.state.phase, deficit=self.state.deficit)

    def _ensure_state(self, x):
        if self.device is None:  # the first chunk pins the stream
            self._pin(x.device)
        if self.state is None:
            self.state = init_state(self.params, x.shape[:-1], x.dtype)
        elif self.state.history.shape[:-1] != x.shape[:-1]:
            # re-initializing would silently drop phase, deficit and
            # history (and a prior setphase): require an explicit reset
            raise ValueError(
                f"chunk batch shape {tuple(x.shape[:-1])} differs from the "
                f"live stream's {tuple(self.state.history.shape[:-1])}; "
                f"call reset() before a stream with a new batch shape")

    def filt(self, x):
        """Filter a chunk, carrying streaming state across calls."""
        x = _as_signal(x, self.device)
        self._ensure_state(x)
        y, _, self.state = filt_block(self.params, self.state, x)
        return y

    __call__ = filt

    def reset(self):
        """Zero history and phase state (bug-fixed reference reset,
        Filters.jl:244-260)."""
        if self.state is not None:
            self.state = reset(self.params, self.state)
        return self

    def setphase(self, phi: float):
        if self.state is None:
            self.state = init_state(self.params)
        self.state = setphase(self.params, self.state, phi)
        return self

    def outputlength(self, inlen: int) -> int:
        return _idx.outputlength(self.params, inlen, state=self.state)

    def inputlength(self, outlen: int) -> int:
        return _idx.inputlength(self.params, outlen, state=self.state)


def setphase(params, state: FilterState, phi) -> FilterState:
    """Set the kernel phase; valid input is [0, 1] (Filters.jl:207-232).

    - interpolator/rational: 1-based phase index floor(phi * nphi) + 1,
      clamped to [1, nphi] (the bug-fixed semantics of the JAX package);
    - arbitrary: accumulator u = round(phi * nphi * 2^32)
      (Filters.jl:216-222);
    - Farrow: u = round(phi * (nphi - 1) * 2^32) (Filters.jl:224-229).
    """
    if not 0.0 <= phi <= 1.0:
        raise ValueError("phase must be in [0, 1]")
    if isinstance(params, (FIRInterpolator, FIRRational)):
        p = min(int(math.floor(phi * params.nphi)) + 1, params.nphi)
    elif isinstance(params, FIRArbitrary):
        p = round(phi * params.nphi * PHASE_ONE)
    elif isinstance(params, FIRFarrow):
        p = round(phi * (params.nphi - 1) * PHASE_ONE)
    else:
        raise TypeError(
            f"setphase not supported for {type(params).__name__}")
    return FilterState(history=state.history, phase=p, deficit=state.deficit)


def tapsforphase(params, phase: float) -> torch.Tensor:
    """Taps for a (possibly fractional) 1-based phase index.

    Arbitrary kernel: pfb[:, p] + alpha * dpfb[:, p] in the taps' type,
    for phase in [1, nphi + 1] (Filters.jl:677-690); Farrow kernel: the
    polynomial fit evaluated in float64 (complex128 for complex taps), for
    phase in [0, nphi + 1] (Filters.jl:764-775). On the kernel's device.
    """
    if isinstance(params, FIRArbitrary):
        if not 1 <= phase <= params.nphi + 1:
            raise ValueError("phase must be in [1, nphi + 1]")
        alpha, pidx = math.modf(phase)
        pidx = int(pidx)
        if pidx == params.nphi + 1:  # the right edge: bank nphi at alpha 1
            pidx, alpha = params.nphi, 1.0
        return params.pfb[:, pidx - 1] + alpha * params.dpfb[:, pidx - 1]
    if isinstance(params, FIRFarrow):
        if not 0 <= phase <= params.nphi + 1:
            raise ValueError("phase must be in [0, nphi + 1]")
        powers = float(phase) ** torch.arange(
            params.polyorder + 1, dtype=torch.float64,
            device=params.device)
        return powers.to(params.coeffs.dtype) @ params.coeffs
    raise TypeError(
        f"tapsforphase not supported for {type(params).__name__}")


def reset(filt_or_params, state: FilterState | None = None):
    """Reset to initial state. With a FIRFilter, resets in place; with
    (params, state), returns a fresh state of the same shape, dtype and
    device."""
    if isinstance(filt_or_params, FIRFilter):
        return filt_or_params.reset()
    h = state.history
    return init_state(filt_or_params, h.shape[:-1], h.dtype, device=h.device)
