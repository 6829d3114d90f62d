"""User API for the rational family: stateless ``filt``, streaming
``FIRFilter``, phase and reset control.

Counterpart of ``multirate_tpu/ops/api.py`` (the reference's surface:
stateless filt, Filters.jl:858-861; FIRFilter, Filters.jl:150-198;
setphase :207-232; reset :244-260) on top of the block step:

    params = make_kernel(h, ratio=Fraction(147, 160), device="cuda")
    state  = init_state(params, batch_shape)
    y, count, state = filt_block(params, state, x_block)

The port runs where its tensors live. A torch input runs on its own
device; a numpy input needs an explicit ``device=``. Nothing moves a GPU
computation to the CPU.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

from . import indexing as _idx
from .compute import filt_block_raw
from .params import (FIRInterpolator, FIRRational, FilterState, init_state,
                     make_kernel)

__all__ = [
    "filt", "filt_block", "FIRFilter", "setphase", "reset",
    "outputlength", "inputlength", "nextphase", "max_outputs",
]

outputlength = _idx.outputlength
inputlength = _idx.inputlength
nextphase = _idx.nextphase
max_outputs = _idx.max_outputs

filt_block = filt_block_raw


def _as_signal(x, device) -> torch.Tensor:
    """``x`` as a tensor on its device: a tensor stays where it is (and must
    agree with ``device`` if one is given); a numpy array needs one."""
    if isinstance(x, torch.Tensor):
        if device is not None and x.device != torch.device(device):
            raise ValueError(f"x is on {x.device}, device={device!r} asked")
        return x
    if device is None:
        raise ValueError("a numpy input needs an explicit device=")
    return torch.as_tensor(x, device=device)


def filt(h, x, ratio=Fraction(1, 1), device=None):
    """One-shot stateless filtering / rational resampling.

    ``filt(h, x, L_over_M)`` with a Fraction, int or (L, M) tuple runs the
    single-rate, interpolating, decimating or rational polyphase resampler
    (reference: Filters.jl:858-861). ``x`` is float32 with leading
    channel dims; time is the last axis. Returns a float32 tensor on x's
    device.
    """
    x = _as_signal(x, device)
    params = make_kernel(h, ratio=ratio, device=x.device)
    state = init_state(params, x.shape[:-1], x.dtype)
    y, _, _ = filt_block(params, state, x)
    return y


class FIRFilter:
    """Streaming (stateful) filter object, the reference's FIRFilter
    (Filters.jl:150-198).

    ``FIRFilter(h)`` or ``FIRFilter(h, Fraction(L, M))`` picks the
    single-rate, interpolator, decimator or rational kernel by the shape of
    the ratio. ``filt(x)`` consumes a chunk and returns exactly the
    producible outputs; history, phase and deficit carry to the next
    chunk, so the concatenated chunked output equals the whole-vector
    output (index decisions exactly; values to float32 reduction order).

    The stream runs on ``device`` if one is given, else on the device of
    torch taps; with numpy taps and no ``device``, it runs where its first
    chunk lies. A numpy chunk needs a ``device``.
    """

    def __init__(self, h, ratio=Fraction(1, 1), device=None):
        self.params = make_kernel(h, ratio=ratio, device=device)
        # the device the stream is pinned to, if the caller named one
        # (explicitly or through torch taps); else its first chunk's
        self.device = (torch.device(device) if device is not None
                       else h.device if isinstance(h, torch.Tensor)
                       else None)
        self.state: FilterState | None = None

    @property
    def history(self):
        return None if self.state is None else self.state.history

    def _ensure_state(self, x):
        if x.device != self.params.device:
            if self.state is not None or self.device is not None:
                raise ValueError(f"chunk is on {x.device}, the stream on "
                                 f"{self.params.device}")
            self.params = self.params.to(x.device)
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

    Interpolator/rational: 1-based phase index floor(phi * nphi) + 1,
    clamped to [1, nphi] (the bug-fixed semantics of the JAX package).
    """
    if not 0.0 <= phi <= 1.0:
        raise ValueError("phase must be in [0, 1]")
    if isinstance(params, (FIRInterpolator, FIRRational)):
        p = min(int(math.floor(phi * params.nphi)) + 1, params.nphi)
        return FilterState(history=state.history, phase=p,
                           deficit=state.deficit)
    raise TypeError(f"setphase not supported for {type(params).__name__}")


def reset(filt_or_params, state: FilterState | None = None):
    """Reset to initial state. With a FIRFilter, resets in place; with
    (params, state), returns a fresh state of the same shape, dtype and
    device."""
    if isinstance(filt_or_params, FIRFilter):
        return filt_or_params.reset()
    h = state.history
    return init_state(filt_or_params, h.shape[:-1], h.dtype, device=h.device)
