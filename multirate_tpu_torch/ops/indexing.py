"""Closed-form index math, in torch int64 and Python ints.

Counterpart of ``multirate_tpu/ops/indexing.py``. Every control recurrence
of the reference (the rational phase stepper, Filters.jl:558-568 with
nextphase :433-439, and the arbitrary/Farrow phase accumulators,
Filters.jl:663-673, 780-792) is affine in the output ordinal ``n``, so a
block of outputs has its input-index and phase vectors in one shot, and
the output count and next state in closed form.

Conventions: input indices are 1-based into the current block (index 1 is
the first sample of the block; the window for input index i is the
taps_per_phi samples of [history, x] ending at x[i]). Phase columns are
0-based. For output ordinal n with 1-based entry phase phi0 and entry
deficit d0, the total phase is t_n = (phi0 - 1) + n*M; then
phi_n = t_n mod L and in_n = d0 + t_n div L.

The accumulator family keeps u in int64 fixed point with PHASE_FRAC_BITS
fractional bits, u = (reference acc - 1) * 2^FRAC. For output n from entry
(u0, d0), with D = nphi << FRAC:

    u_n = u0 + n * delta_fx,  in_n = d0 + u_n div D,
    phi_n = (u_n mod D) >> FRAC,  alpha_n = (u_n mod 2^FRAC) * 2^-FRAC.

The scalar functions accept Python ints or int64 tensors. Python ints are
exact at any stream offset, which is why the streaming state keeps
``(phase, deficit)`` on the host (``host_carry``) and never reads a count
back from the device.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .params import (PHASE_FRAC_BITS, PHASE_ONE, FIRArbitrary,
                     FIRDecimator, FIRFarrow, FIRInterpolator, FIRRational,
                     FIRStandard)

__all__ = [
    "rational_indices", "rational_count", "rational_carry",
    "accum_indices", "accum_count", "accum_carry", "host_carry",
    "nextphase", "outputlength", "inputlength", "max_outputs",
]

_ACCUM = (FIRArbitrary, FIRFarrow)


def _floordiv(a, b):
    if isinstance(a, torch.Tensor):
        return torch.div(a, b, rounding_mode="floor")
    return a // b


def _clamp0(c):
    if isinstance(c, torch.Tensor):
        return torch.clamp(c, min=0)
    return max(c, 0)


def rational_indices(L: int, M: int, phi0, d0, n: int, device=None):
    """(in_idx[n] 1-based, phi[n] 0-based), int64 tensors of ``n`` outputs."""
    t = (phi0 - 1) + torch.arange(n, dtype=torch.int64, device=device) * M
    return d0 + _floordiv(t, L), torch.remainder(t, L)


def rational_count(L: int, M: int, phi0, d0, xlen):
    """Number of outputs producible from ``xlen`` block samples.

    The reference's outputlength algebra ceil((effective_len * L - phi0 +
    1) / M) with effective_len = xlen - d0 + 1 (Filters.jl:352-357,
    371-373), clamped at 0 for blocks shorter than the deficit
    (Filters.jl:543-547).
    """
    return _clamp0(_floordiv((xlen - d0 + 1) * L - phi0, M) + 1)


def rational_carry(L: int, M: int, phi0, d0, xlen):
    """(count, phi0', d0') carried into the next block (Filters.jl:568, 571)."""
    count = rational_count(L, M, phi0, d0, xlen)
    t_end = (phi0 - 1) + count * M
    return count, (t_end % L) + 1, d0 + _floordiv(t_end, L) - xlen


# The accumulator products (n * delta_fx, xlen * D) wrap int64 once they
# pass 2^63: at nphi 1024 and rate 0.3, delta_fx is near 2^43.7, so n *
# delta_fx wraps near n = 2^19.3 outputs. Every product below goes through
# ``_muladd_divmod``: base-2^16 long division that never forms a * b.

_LIMB_MASK = (1 << 16) - 1
# _muladd_divmod needs (den << 16) and (2^16 * b) to fit in int64.
ACCUM_OPERAND_BITS = 44


def _muladd_divmod(a, b: int, c, den: int):
    """Exact (q, r) = divmod(a * b + c, den) without ever forming a * b.

    ``a`` and ``c`` are Python ints or int64 tensors of either sign; ``b``
    and ``den`` are positive Python ints below 2^44. On tensors, base-2^16
    long division over a's limbs: the largest intermediate is
    (den << 16) + (2^16 - 1) * b < 2^61. The quotient must fit int64.
    """
    if not (0 < b < (1 << ACCUM_OPERAND_BITS)
            and 0 < den < (1 << ACCUM_OPERAND_BITS)):
        raise ValueError(
            f"static operands out of range for exact divmod: b={b} den={den}"
            f" (must be in (0, 2^{ACCUM_OPERAND_BITS}))")
    if not isinstance(a, torch.Tensor) and not isinstance(c, torch.Tensor):
        return divmod(int(a) * b + int(c), den)
    a = torch.as_tensor(a, dtype=torch.int64)
    top = (a >> 48) * b                  # the top limb keeps the sign
    q = _floordiv(top, den)
    r = top - q * den
    for shift in (32, 16, 0):
        acc = (r << 16) + ((a >> shift) & _LIMB_MASK) * b
        q = (q << 16) + _floordiv(acc, den)
        r = torch.remainder(acc, den)
    acc = r + c
    return q + _floordiv(acc, den), torch.remainder(acc, den)


def accum_indices(nphi: int, delta_fx: int, u0, d0, n: int, device=None):
    """(in_idx 1-based int64, phi 0-based int64, frac float64 in [0, 1))
    for ``n`` outputs."""
    D = nphi << PHASE_FRAC_BITS
    steps = torch.arange(n, dtype=torch.int64, device=device)
    q, rem = _muladd_divmod(steps, delta_fx, u0, D)
    frac = (rem & (PHASE_ONE - 1)).to(torch.float64) * 2.0 ** -PHASE_FRAC_BITS
    return d0 + q, rem >> PHASE_FRAC_BITS, frac


def accum_count(nphi: int, delta_fx: int, u0, d0, xlen):
    """Number of outputs with input index <= xlen (exact)."""
    D = nphi << PHASE_FRAC_BITS
    # ((xlen - d0 + 1) * D - 1 - u0) // delta_fx + 1, overflow-free
    q, _ = _muladd_divmod(xlen - d0 + 1, D, -1 - u0, delta_fx)
    return _clamp0(q + 1)


def accum_carry(nphi: int, delta_fx: int, u0, d0, xlen):
    """(count, u0', d0') carried into the next block (Filters.jl:734)."""
    D = nphi << PHASE_FRAC_BITS
    count = accum_count(nphi, delta_fx, u0, d0, xlen)
    q, r = _muladd_divmod(count, delta_fx, u0, D)
    return count, r, d0 + q - xlen


def host_carry(params, phase: int, deficit: int, xlen: int):
    """Exact (count, phase', deficit') as Python ints for one block.

    The same update as ``rational_carry`` with each family's fixed entry
    (standard and interpolator keep their state, the decimator runs at
    phase 1), or as ``accum_carry`` for the accumulator family. The
    compute layer takes the count and the next state from
    here, so no device value is ever read back to size an output.
    """
    phase, deficit, xlen = int(phase), int(deficit), int(xlen)
    if isinstance(params, FIRStandard):
        return xlen, phase, deficit
    if isinstance(params, FIRInterpolator):
        return params.interpolation * xlen, phase, deficit
    if isinstance(params, FIRDecimator):
        c, _, d = rational_carry(1, params.decimation, 1, deficit, xlen)
        return c, phase, d
    if isinstance(params, FIRRational):
        return rational_carry(params.interpolation, params.decimation,
                              phase, deficit, xlen)
    if isinstance(params, _ACCUM):
        return accum_carry(params.nphi, params.delta_fx, phase, deficit,
                           xlen)
    raise TypeError(f"unknown kernel {type(params)}")


# --------------------------------------------------------------------------- #
# Public length algebra (reference parity: Filters.jl:341-439)
# --------------------------------------------------------------------------- #

def _ratio(ratio) -> tuple[int, int]:
    r = Fraction(*ratio) if isinstance(ratio, tuple) else Fraction(ratio)
    return r.numerator, r.denominator


def nextphase(currentphase: int, ratio) -> int:
    """Next 1-based phase index after one output (Filters.jl:433-439)."""
    L, M = _ratio(ratio)
    nxt = currentphase + M % L
    return nxt - L if nxt > L else nxt


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _entry(params, state, initial_phi):
    if not isinstance(initial_phi, (int, np.integer)):
        raise TypeError(
            "the third positional slot is initial_phi (an int); pass a "
            "FilterState as state=... keyword")
    if state is None:
        return (0 if isinstance(params, _ACCUM) else 1), 1
    return int(state.phase), int(state.deficit)


def outputlength(arg0, inlen=None, initial_phi: int = 1, state=None) -> int:
    """Exact output count for an input length.

    - ``outputlength(inlen, ratio, initial_phi)``: raw rational algebra,
      ceil((inlen*L - phi + 1)/M).
    - ``outputlength(params, inlen, state=s)``: per kernel, from the
      kernel's current phase and deficit (a fresh state by default).
    """
    if isinstance(arg0, (int, np.integer)):
        L, M = _ratio(inlen)
        return _ceil_div(int(arg0) * L - initial_phi + 1, M)
    phi0, d0 = _entry(arg0, state, initial_phi)
    if isinstance(arg0, (FIRStandard, FIRInterpolator, FIRDecimator,
                         FIRRational, *_ACCUM)):
        return host_carry(arg0, phi0, d0, int(inlen))[0]
    raise TypeError(f"unknown kernel {type(arg0)}")


def inputlength(params, outlen=None, initial_phi: int = 1, state=None) -> int:
    """Minimum input length that produces ``outlen`` outputs.

    - ``inputlength(outlen, ratio, initial_phi)``: the raw rational
      algebra of Filters.jl:395-400, ceil((outlen*M + phi - 1)/L).
    - ``inputlength(params, outlen, state=s)``: per kernel, from the
      kernel's current phase and deficit (the decimator uses the deficit,
      fixing the reference's Filters.jl:415).
    """
    if isinstance(params, (int, np.integer)):
        L, M = _ratio(outlen)
        return _ceil_div(int(params) * M + initial_phi - 1, L)
    phi0, d0 = _entry(params, state, initial_phi)
    if isinstance(params, FIRStandard):
        return outlen
    if isinstance(params, FIRInterpolator):
        return _ceil_div(outlen, params.interpolation)
    if isinstance(params, FIRDecimator):
        return d0 + (outlen - 1) * params.decimation
    if isinstance(params, FIRRational):
        L, M = params.interpolation, params.decimation
        return d0 - 1 + _ceil_div((outlen - 1) * M + phi0, L)
    if isinstance(params, _ACCUM):
        # the smallest xlen with accum_count >= outlen
        D = params.nphi << PHASE_FRAC_BITS
        return d0 - 1 + _ceil_div(phi0 + (outlen - 1) * params.delta_fx + 1,
                                  D)
    raise TypeError(f"unknown kernel {type(params)}")


def max_outputs(params, block_len: int) -> int:
    """Worst-case output count for a ``block_len``-sample block (deficit 1,
    smallest entry phase or accumulator)."""
    B = block_len
    if isinstance(params, FIRStandard):
        return B
    if isinstance(params, FIRInterpolator):
        return B * params.interpolation
    if isinstance(params, FIRDecimator):
        return _ceil_div(B, params.decimation)
    if isinstance(params, FIRRational):
        return _ceil_div(B * params.interpolation, params.decimation)
    if isinstance(params, _ACCUM):
        return (B * (params.nphi << PHASE_FRAC_BITS) - 1) \
            // params.delta_fx + 1
    raise TypeError(f"unknown kernel {type(params)}")
