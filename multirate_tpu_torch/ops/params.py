"""Rational-family kernel parameters and the streaming FilterState.

Counterpart of ``multirate_tpu/ops/params.py``. The reference holds mutable
kernel objects (Filters.jl:15-80) plus a ``FIRFilter`` wrapper with a
mutable ``history`` vector (Filters.jl:151-155). Here a kernel is a frozen
dataclass of one float32 filter-bank tensor plus static integers, and all
cross-call streaming state lives in a small ``FilterState``:

    y, count, state' = filt_block(params, state, x_block)

What the JAX kernels carry only to feed TPU kernels is left out: the
banded matrix ``k_super``, the zero-copy K stacks ``k_zc_hi``/``k_zc_lo``
(441x264x640 bf16, twice, at the 147//160 headline) and the MXU grouping
``sc_group``. The Hopper kernel computes every output straight from the
polyphase bank, so nothing else is needed.

Taps are stored as float32. Float64 and complex taps, the bf16/int8
quantized modes and ``store_dtype`` are later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from . import pfb as _pfb

__all__ = [
    "FIRStandard", "FIRInterpolator", "FIRDecimator", "FIRRational",
    "FilterState", "init_state", "make_kernel",
]

_ARB_TODO = ("arbitrary-rate and Farrow resampling are not ported yet "
             "(ROADMAP queue 1, item 1: the arbitrary/Farrow slice)")


def _host_taps(h) -> np.ndarray:
    """Taps as a real float32 host array (the port's only tap dtype)."""
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu().numpy()
    h = np.asarray(h)
    if np.iscomplexobj(h):
        raise NotImplementedError(
            "complex taps are not ported yet (ROADMAP queue 1, item 3)")
    return h.astype(np.float32)


def _device_of(h, device):
    """The device a kernel's bank lives on: ``device`` if given, else the
    taps' own device (the CPU for numpy taps, as ``torch.as_tensor``)."""
    if device is not None:
        return torch.device(device)
    return h.device if isinstance(h, torch.Tensor) else torch.device("cpu")


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device).contiguous()


class _Kernel:
    """Shared behaviour: the bank's device and a copy moved elsewhere."""

    @property
    def device(self) -> torch.device:
        return self.bank.device

    def to(self, device):
        name = "pfb" if hasattr(self, "pfb") else "taps_rev"
        return dataclasses.replace(
            self, **{name: _to(getattr(self, name), device)})

    @property
    def h_min(self) -> int:
        """History the filter math needs and the port carries:
        taps_per_phi - 1 samples (the reference's shiftin! depth,
        Filters.jl:151-155). The JAX rational kernel carries ZC_S whole
        stream rows for its zero-copy TPU kernel, a TPU layout choice."""
        return self.taps_per_phi - 1


@dataclasses.dataclass(frozen=True)
class FIRStandard(_Kernel):
    """Single-rate FIR kernel (reference: Filters.jl:15-24).

    ``taps_rev`` are the time-flipped taps, so the dot with a forward
    window of ``hlen`` samples ending at the current input sample is the
    causal convolution (the reference's flipud, Filters.jl:21).
    """

    taps_rev: torch.Tensor
    hlen: int = 0

    @classmethod
    def create(cls, h, device=None) -> "FIRStandard":
        dev = _device_of(h, device)
        h = _host_taps(h)
        return cls(taps_rev=_to(h[::-1].copy(), dev), hlen=h.shape[0])

    @property
    def taps_per_phi(self) -> int:
        return self.hlen

    @property
    def bank(self) -> torch.Tensor:
        return self.taps_rev.view(-1, 1)


@dataclasses.dataclass(frozen=True)
class FIRInterpolator(_Kernel):
    """Integer interpolator (L//1) kernel (reference: Filters.jl:28-41)."""

    pfb: torch.Tensor  # (taps_per_phi, L), rows time-flipped
    interpolation: int = 1
    taps_per_phi: int = 0

    @classmethod
    def create(cls, h, interpolation: int, device=None) -> "FIRInterpolator":
        dev = _device_of(h, device)
        bank = _pfb.taps2pfb(_host_taps(h), interpolation)
        return cls(pfb=_to(bank, dev), interpolation=interpolation,
                   taps_per_phi=bank.shape[0])

    @property
    def nphi(self) -> int:
        return self.interpolation

    @property
    def bank(self) -> torch.Tensor:
        return self.pfb


@dataclasses.dataclass(frozen=True)
class FIRDecimator(_Kernel):
    """Integer decimator (1//M) kernel (reference: Filters.jl:45-58)."""

    taps_rev: torch.Tensor
    hlen: int = 0
    decimation: int = 1

    @classmethod
    def create(cls, h, decimation: int, device=None) -> "FIRDecimator":
        dev = _device_of(h, device)
        h = _host_taps(h)
        return cls(taps_rev=_to(h[::-1].copy(), dev), hlen=h.shape[0],
                   decimation=decimation)

    @property
    def taps_per_phi(self) -> int:
        return self.hlen

    @property
    def bank(self) -> torch.Tensor:
        return self.taps_rev.view(-1, 1)


@dataclasses.dataclass(frozen=True)
class FIRRational(_Kernel):
    """Rational (L//M) polyphase resampler kernel (reference:
    Filters.jl:62-80). Phase and input index are closed-form affine
    functions of the output ordinal (SURVEY.md section 3.1), so a whole
    block of outputs is one kernel launch."""

    pfb: torch.Tensor  # (taps_per_phi, L), rows time-flipped
    interpolation: int = 1  # L
    decimation: int = 1     # M
    taps_per_phi: int = 0

    @classmethod
    def create(cls, h, interpolation: int, decimation: int,
               device=None) -> "FIRRational":
        dev = _device_of(h, device)
        bank = _pfb.taps2pfb(_host_taps(h), interpolation)
        return cls(pfb=_to(bank, dev), interpolation=interpolation,
                   decimation=decimation, taps_per_phi=bank.shape[0])

    @property
    def nphi(self) -> int:
        return self.interpolation

    @property
    def bank(self) -> torch.Tensor:
        return self.pfb


@dataclasses.dataclass(frozen=True)
class FilterState:
    """All cross-call streaming state.

    - ``history``: the last ``h_min`` input samples,
      zeros initially, shape (..., h_min) with the leading dims the
      channel dims (the reference's FIRFilter.history, Filters.jl:151-155).
    - ``phase``: Python int. For FIRRational the 1-based phase index of the
      next output (Filters.jl:68); carried unchanged (0) otherwise.
    - ``deficit``: Python int, the 1-based index into the next input block
      of the first sample that produces an output (the reference's
      ``inputDeficit``, Filters.jl:543-547, 602-606).

    ``phase`` and ``deficit`` are host ints, the JAX package's host mirror
    (``indexing.host_carry``) made the state itself: counts and the next
    state are exact on the host and no device value is ever read back.
    """

    history: torch.Tensor
    phase: int
    deficit: int


def init_state(params, batch_shape=(), dtype=torch.float32,
               device=None) -> FilterState:
    """Initial state: zero history, phase 1 (rational) or 0, deficit 1.

    The history lives on ``device``, by default the kernel's own device.
    """
    dev = params.device if device is None else torch.device(device)
    hist = torch.zeros((*batch_shape, params.h_min), dtype=dtype,
                       device=dev)
    return FilterState(history=hist,
                       phase=1 if isinstance(params, FIRRational) else 0,
                       deficit=1)


def make_kernel(h, ratio=None, rate=None, device=None):
    """Build the right kernel for a resampling spec.

    Dispatch mirrors the reference's FIRFilter constructors
    (Filters.jl:158-198): a rational ``ratio`` selects standard, decimator,
    interpolator or rational by its shape. A real ``rate`` (arbitrary or
    Farrow resampling) raises NotImplementedError until that slice is
    ported. The bank lives on ``device``, by default the taps' device.
    """
    if (ratio is None) == (rate is None):
        raise ValueError("specify exactly one of ratio= or rate=")
    if rate is not None or isinstance(ratio, float):
        raise NotImplementedError(_ARB_TODO)
    r = Fraction(*ratio) if isinstance(ratio, tuple) else Fraction(ratio)
    L, M = r.numerator, r.denominator
    if L == M == 1:
        return FIRStandard.create(h, device=device)
    if L == 1:
        return FIRDecimator.create(h, M, device=device)
    if M == 1:
        return FIRInterpolator.create(h, L, device=device)
    return FIRRational.create(h, L, M, device=device)
