"""Kernel parameters and the streaming FilterState.

Counterpart of ``multirate_tpu/ops/params.py``. The reference holds mutable
kernel objects (Filters.jl:15-147) plus a ``FIRFilter`` wrapper with a
mutable ``history`` vector (Filters.jl:151-155). Here a kernel is a frozen
dataclass of filter-bank tensors plus static numbers, and all
cross-call streaming state lives in a small ``FilterState``:

    y, count, state' = filt_block(params, state, x_block)

What the JAX kernels carry only to feed TPU kernels is left out: the
banded matrix ``k_super``, the zero-copy K stacks ``k_zc_hi``/``k_zc_lo``
(441x264x640 bf16, twice, at the 147//160 headline), the MXU grouping
``sc_group`` and the arbitrary/Farrow tile plans ``gridsel_meta``,
``ratgrid_meta`` and ``k_ratgrid``. The Hopper kernels compute every output
straight from a polyphase bank, so nothing else is needed.

Banks keep their taps' type (``storage_dtype``): float32, float64,
complex64 and complex128, and for the rational family also bfloat16 and
int8 (the quantized modes, ``ops/quant.py``); any other real type becomes
float32. Rational-family kernels may also carry a narrow ``store_dtype``
for their outputs. The arbitrary table (``pfb``, ``dpfb``) and the Farrow
table are in the taps' type too; the Farrow fit ``coeffs`` is float64, or
complex128 for complex taps, as JAX keeps it. These banks replace the K
stacks and tap planes of every TPU kernel mode: the float32, bf16, int8,
float64 and complex modes of ``rational_supercycle_zc``,
``rational_supercycle_grouped`` and ``rational_supercycle_pallas``, and
the float32, float64 and complex modes of the arbitrary/Farrow kernels
(``gridsel``, ``select4``, ``select3``, ``select``).

A kernel lives on the device it is given, else on the device of torch
taps, else on the card (``default_device``): the CPU only when named.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from . import pfb as _pfb

__all__ = [
    "PHASE_FRAC_BITS", "PHASE_ONE",
    "FIRStandard", "FIRInterpolator", "FIRDecimator", "FIRRational",
    "FIRArbitrary", "FIRFarrow",
    "FilterState", "init_state", "make_kernel", "default_device",
    "to_tensor", "storage_dtype", "store_dtype_of",
]

# Fixed-point scale of the arbitrary/Farrow phase accumulator u: 32
# fractional bits, so the interpolation factor alpha is exact to 2^-32.
# indexing._muladd_divmod keeps every accumulator product exact, so the
# only static bound is nphi << 32 and delta_fx below 2^44 (_delta_fx).
PHASE_FRAC_BITS = 32
PHASE_ONE = 1 << PHASE_FRAC_BITS


def default_device() -> torch.device:
    """The device of a computation whose caller named none: the card. The
    CPU is used only when the caller names it."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


def to_tensor(a, device=None) -> torch.Tensor:
    """A tensor as it is, or a numpy array as a tensor in its own dtype, on
    ``device`` if one is given. numpy has no bfloat16 of its own: an array
    whose ``dtype.name`` is "bfloat16" (as JAX hands them over) converts
    through float32, which holds its values exactly."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t if device is None else t.to(device)


_QUANTIZED = (torch.bfloat16, torch.int8)
_WIDE = (torch.float32, torch.float64, torch.complex64, torch.complex128)
_STORE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def storage_dtype(dtype: torch.dtype, quantized: bool = True) -> torch.dtype:
    """The type a bank or history of ``dtype`` values is stored in:
    float32, float64, complex64 and complex128 stay, and so do bfloat16
    and int8 where the quantized modes apply (``quantized``: the rational
    family); any other complex type becomes complex64 and any other type
    float32."""
    if dtype in _WIDE or (quantized and dtype in _QUANTIZED):
        return dtype
    return torch.complex64 if dtype.is_complex else torch.float32


def store_dtype_of(sd):
    """A ``store_dtype`` as a torch dtype: None, or bfloat16 or float16
    named by a torch or numpy dtype (JAX's) or a string."""
    if sd is None:
        return None
    if isinstance(sd, torch.dtype):
        name = str(sd).removeprefix("torch.")
    else:
        name = sd if isinstance(sd, str) else np.dtype(sd).name
    if name not in _STORE_DTYPES:
        raise ValueError(f"store_dtype {sd!r}: bfloat16 or float16 only")
    return _STORE_DTYPES[name]


def _host_taps(h, quantized: bool = True):
    """(host taps, bank dtype): the taps' storage type, and the taps as a
    host array in it (bfloat16 values ride in float32 exactly: numpy has
    no bfloat16 of its own)."""
    t = to_tensor(h).detach().cpu()
    dtype = storage_dtype(t.dtype, quantized)
    host = t.to(torch.float32 if dtype == torch.bfloat16 else dtype)
    return host.numpy(), dtype


def _device_of(h, device):
    """The device a kernel's bank lives on: ``device`` if given, else the
    taps' own device for torch taps, else the card."""
    if device is not None:
        return torch.device(device)
    return h.device if isinstance(h, torch.Tensor) else default_device()


def _to(t, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(t, dtype=dtype, device=device).contiguous()


class _Kernel:
    """Shared behaviour: the bank's device and a copy moved elsewhere."""

    @property
    def device(self) -> torch.device:
        return self.bank.device

    def to(self, device):
        """A copy with every tensor field on ``device``."""
        moved = {f.name: _to(getattr(self, f.name), device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)

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
    store_dtype: torch.dtype | None = None  # narrow outputs (make_kernel)

    @classmethod
    def create(cls, h, device=None) -> "FIRStandard":
        taps, dtype = _host_taps(h)
        return cls(taps_rev=_to(taps[::-1].copy(), _device_of(h, device),
                                dtype),
                   hlen=taps.shape[0])

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
    store_dtype: torch.dtype | None = None

    @classmethod
    def create(cls, h, interpolation: int, device=None) -> "FIRInterpolator":
        taps, dtype = _host_taps(h)
        bank = _pfb.taps2pfb(taps, interpolation)
        return cls(pfb=_to(bank, _device_of(h, device), dtype),
                   interpolation=interpolation, taps_per_phi=bank.shape[0])

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
    store_dtype: torch.dtype | None = None

    @classmethod
    def create(cls, h, decimation: int, device=None) -> "FIRDecimator":
        taps, dtype = _host_taps(h)
        return cls(taps_rev=_to(taps[::-1].copy(), _device_of(h, device),
                                dtype),
                   hlen=taps.shape[0], decimation=decimation)

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
    store_dtype: torch.dtype | None = None

    @classmethod
    def create(cls, h, interpolation: int, decimation: int,
               device=None) -> "FIRRational":
        taps, dtype = _host_taps(h)
        bank = _pfb.taps2pfb(taps, interpolation)
        return cls(pfb=_to(bank, _device_of(h, device), dtype),
                   interpolation=interpolation, decimation=decimation,
                   taps_per_phi=bank.shape[0])

    @property
    def nphi(self) -> int:
        return self.interpolation

    @property
    def bank(self) -> torch.Tensor:
        return self.pfb


def _delta_fx(nphi: int, rate: float) -> int:
    """Phase step nphi/rate in exact int64 fixed point (Filters.jl:113)."""
    from .indexing import ACCUM_OPERAND_BITS

    dfx = round(nphi / rate * PHASE_ONE)
    if dfx <= 0:
        raise ValueError(f"rate {rate} too large for nphi {nphi}")
    if (nphi << PHASE_FRAC_BITS) >= (1 << ACCUM_OPERAND_BITS) or \
            dfx >= (1 << ACCUM_OPERAND_BITS):
        raise ValueError(
            f"nphi={nphi}, rate={rate} out of the exact-arithmetic range "
            f"(need nphi <= 2048 and nphi/rate < 4096)")
    return dfx


def _check_rate(rate) -> float:
    rate = float(rate)
    if not rate > 0:
        raise ValueError("rate must be greater than 0")
    return rate


@dataclasses.dataclass(frozen=True)
class FIRArbitrary(_Kernel):
    """Arbitrary real-rate resampler with a derivative filter bank
    (reference: Filters.jl:84-117, after Harris sec. 7.6.1).

    ``table`` stacks two (taps_per_phi, nphi) banks: ``pfb`` from h and
    ``dpfb`` from dh = [diff(h); 0]. An output at phase p with fraction
    alpha takes taps pfb[:, p] + alpha * dpfb[:, p]: first-order
    interpolation that never needs the next input sample. bfloat16 taps
    give a float32 table of the values JAX's bfloat16 banks hold: the
    taps, and their differences rounded to bfloat16.
    """

    table: torch.Tensor  # (2, taps_per_phi, nphi): pfb, dpfb
    nphi: int = 32
    taps_per_phi: int = 0
    rate: float = 1.0
    delta_fx: int = 0  # nphi/rate in PHASE_FRAC_BITS fixed point

    @classmethod
    def create(cls, h, rate: float, nphi: int = 32,
               device=None) -> "FIRArbitrary":
        rate = _check_rate(rate)
        taps, dtype = _host_taps(h, quantized=False)
        dh = np.concatenate([np.diff(taps), np.zeros(1, dtype=taps.dtype)])
        if to_tensor(h).dtype == torch.bfloat16:
            # JAX takes the diff in bfloat16: dh holds it rounded, in float32
            dh = torch.from_numpy(dh).to(torch.bfloat16).float().numpy()
        table = np.stack([_pfb.taps2pfb(taps, nphi),
                          _pfb.taps2pfb(dh, nphi)])
        return cls(table=_to(table, _device_of(h, device), dtype),
                   nphi=nphi, taps_per_phi=table.shape[1], rate=rate,
                   delta_fx=_delta_fx(nphi, rate))

    def astype(self, dtype: torch.dtype) -> "FIRArbitrary":
        """This kernel with its table in ``dtype``, a type at least as wide
        (an exact cast, as JAX's ``pfb.astype`` before its TPU kernel)."""
        if dtype == self.table.dtype:
            return self
        return dataclasses.replace(self, table=self.table.to(dtype))

    @property
    def pfb(self) -> torch.Tensor:
        return self.table[0]

    @property
    def dpfb(self) -> torch.Tensor:
        return self.table[1]

    @property
    def bank(self) -> torch.Tensor:
        return self.table


def farrow_table(coeffs, nphi: int) -> torch.Tensor:
    """The Farrow tap polynomials re-centred at each phase, in float64
    (complex128 for complex coefficients), on ``coeffs``' device.

    ``coeffs`` (P+1, T), a tensor or an array, gives tap t at the 1-based
    fractional phase psi as sum_k coeffs[k, t] * psi^k. Returns (P+1, T,
    nphi) with
    table[p, t, phi] = sum_{k >= p} coeffs[k, t] * binom(k, p) * (phi+1)^(k-p),
    so tap t at psi = phi + 1 + alpha is sum_p table[p, t, phi] * alpha^p
    for alpha in [0, 1): a short, well-conditioned polynomial the kernel
    evaluates in the table's type (Horner over psi up to nphi + 1 would
    cancel terms of size psi^P).
    """
    c = torch.as_tensor(coeffs)
    c = c.to(torch.complex128 if c.is_complex() else torch.float64)
    P1 = c.shape[0]
    psi0 = torch.arange(1, nphi + 1, dtype=torch.float64, device=c.device)
    table = torch.zeros((P1, c.shape[1], nphi), dtype=c.dtype,
                        device=c.device)
    for p in range(P1):
        for k in range(p, P1):
            table[p] += (math.comb(k, p) * c[k][:, None]
                         * psi0[None, :] ** (k - p))
    return table


@dataclasses.dataclass(frozen=True)
class FIRFarrow(_Kernel):
    """Farrow polynomial-interpolation resampler (reference:
    Filters.jl:123-147).

    Each bank tap row is fitted with a degree-``polyorder`` polynomial
    across phases (pfb2pnfb, Filters.jl:311-321): ``coeffs`` (P+1, T),
    kept in float64 (complex128 for complex taps) as JAX keeps it. The
    kernel reads ``table``, the same polynomials re-centred at each phase
    (``farrow_table``) in the taps' type.
    """

    pfb: torch.Tensor     # (taps_per_phi, nphi), the taps' type
    coeffs: torch.Tensor  # (polyorder+1, taps_per_phi) float64/complex128
    table: torch.Tensor   # (polyorder+1, taps_per_phi, nphi), pfb's type
    nphi: int = 32
    taps_per_phi: int = 0
    rate: float = 1.0
    delta_fx: int = 0
    polyorder: int = 4

    @classmethod
    def create(cls, h, rate: float, nphi: int, polyorder: int,
               device=None) -> "FIRFarrow":
        rate = _check_rate(rate)
        bank = _pfb.taps2pfb(_host_taps(h, quantized=False)[0], nphi)
        return cls.from_fit(bank, _pfb.pfb2pnfb(bank, polyorder), nphi,
                            rate, _delta_fx(nphi, rate),
                            _device_of(h, device))

    @classmethod
    def from_fit(cls, pfb, coeffs, nphi: int, rate: float, delta_fx: int,
                 device) -> "FIRFarrow":
        """The kernel from a bank and its fit (the JAX kernel's fields)."""
        pfb = to_tensor(pfb)
        dtype = storage_dtype(pfb.dtype, quantized=False)
        coeffs = np.array(coeffs)  # a copy: JAX's are read-only
        coeffs = coeffs.astype(np.complex128 if np.iscomplexobj(coeffs)
                               else np.float64)
        return cls(pfb=_to(pfb, device, dtype), coeffs=_to(coeffs, device),
                   table=_to(farrow_table(coeffs, nphi), device, dtype),
                   nphi=nphi, taps_per_phi=coeffs.shape[1], rate=rate,
                   delta_fx=delta_fx, polyorder=coeffs.shape[0] - 1)

    def astype(self, dtype: torch.dtype) -> "FIRFarrow":
        """This kernel with its table in ``dtype``, a type at least as
        wide. A wider table is re-centred anew from ``coeffs``, so it
        carries no float32 rounding (JAX casts the float64 fit itself)."""
        if dtype == self.table.dtype:
            return self
        return dataclasses.replace(
            self, table=farrow_table(self.coeffs, self.nphi).to(dtype))

    @property
    def bank(self) -> torch.Tensor:
        return self.table


@dataclasses.dataclass(frozen=True)
class FilterState:
    """All cross-call streaming state.

    - ``history``: the last ``h_min`` input samples,
      zeros initially, shape (..., h_min) with the leading dims the
      channel dims (the reference's FIRFilter.history, Filters.jl:151-155).
    - ``phase``: Python int. For FIRRational the 1-based phase index of the
      next output (Filters.jl:68); for FIRArbitrary/FIRFarrow the
      fixed-point accumulator u = (acc - 1) * 2^PHASE_FRAC_BITS in
      [0, nphi << PHASE_FRAC_BITS) (Filters.jl:97, 131); carried
      unchanged (0) otherwise.
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

    ``dtype`` is the signal's type, complex included (a block casts the
    history to its signal's type, as JAX's [history ++ x] does). The
    history lives on ``device``, by default the kernel's own device.
    """
    dev = params.device if device is None else torch.device(device)
    hist = torch.zeros((*batch_shape, params.h_min), dtype=dtype,
                       device=dev)
    return FilterState(history=hist,
                       phase=1 if isinstance(params, FIRRational) else 0,
                       deficit=1)


def make_kernel(h, ratio=None, rate=None, nphi: int = 32, polyorder=None,
                device=None, store_dtype=None):
    """Build the right kernel for a resampling spec.

    Dispatch mirrors the reference's FIRFilter constructors
    (Filters.jl:158-198): a rational ``ratio`` selects standard, decimator,
    interpolator or rational by its shape; a real ``rate`` selects
    FIRArbitrary, or FIRFarrow when ``polyorder`` is given. A float
    ``ratio`` is a rate, as ``filt`` treats it. The banks live on
    ``device``, else on torch taps' own device, else on the card.

    ``store_dtype`` (rational family only, JAX ``params.py:517-561``):
    bfloat16 or float16 outputs, computed at full precision and rounded
    once to nearest even when stored.
    """
    if (ratio is None) == (rate is None):
        raise ValueError("specify exactly one of ratio= or rate=")
    if isinstance(ratio, float):
        ratio, rate = None, ratio
    if rate is not None:
        if store_dtype is not None:
            raise ValueError(
                "store_dtype applies to the rational family only")
        if polyorder is None:
            return FIRArbitrary.create(h, rate, nphi, device=device)
        return FIRFarrow.create(h, rate, nphi, polyorder, device=device)
    store = store_dtype_of(store_dtype)
    r = Fraction(*ratio) if isinstance(ratio, tuple) else Fraction(ratio)
    L, M = r.numerator, r.denominator
    if L == M == 1:
        p = FIRStandard.create(h, device=device)
    elif L == 1:
        p = FIRDecimator.create(h, M, device=device)
    elif M == 1:
        p = FIRInterpolator.create(h, L, device=device)
    else:
        p = FIRRational.create(h, L, M, device=device)
    return dataclasses.replace(p, store_dtype=store)
