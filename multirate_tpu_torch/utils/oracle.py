"""Naive reference resamplers — the independent ground truth for tests.

Behavioral reference: Multirate.jl src/NaiveResamplers.jl (the reference's
own oracle module). Pure numpy on host, deliberately simple and slow:
zero-stuff -> causal FIR -> downselect, plus the linear-interpolation walk for
arbitrary rates, and the Farrow method in float64. Copied from
``multirate_tpu/utils/oracle.py`` so the port needs no JAX.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

__all__ = ["naivefilt", "naivefilt_farrow", "causal_fir"]


def causal_fir(h, x):
    """Causal FIR: y[n] = sum_k h[k] x[n-k], len(y) == len(x).

    Equivalent of Julia's Base.filt(h, 1.0, x) (NaiveResamplers.jl:16).
    """
    h = np.asarray(h)
    x = np.asarray(x)
    full = np.convolve(x, h.astype(np.promote_types(h.dtype, x.dtype)))
    return full[: x.shape[0]]


def naivefilt(h, x, resamplerate=Fraction(1, 1), numfilters: int = 32):
    """Naive resampling oracle.

    - Rational (Fraction/int/tuple): zero-stuff by L, causal FIR, take every
      M-th sample (NaiveResamplers.jl:5-18).
    - Float rate: interpolate by ``numfilters`` via the rational path, then
      walk with a linear-interpolation accumulator (delta, phi_stride) =
      modf(numfilters / rate) (NaiveResamplers.jl:24-49).
    """
    h = np.asarray(h)
    x = np.asarray(x)
    if not isinstance(resamplerate, float):
        r = Fraction(*resamplerate) if isinstance(resamplerate, tuple) \
            else Fraction(resamplerate)
        L, M = r.numerator, r.denominator
        stuffed = np.zeros(x.shape[0] * L, dtype=x.dtype)
        stuffed[::L] = x
        y = causal_fir(h, stuffed)
        return y[::M].copy()

    rate = float(resamplerate)
    xi = naivefilt(h, x, Fraction(numfilters, 1))
    xlen = xi.shape[0]
    ylen = math.ceil(xlen * rate)
    y = np.zeros(ylen, dtype=xi.dtype)
    yidx = 0
    xidx = 0
    alpha = 0.0
    delta, stride = math.modf(numfilters / rate)
    stride = int(stride)
    while xidx < xlen - 1:
        lo = xi[xidx]
        hi = xi[xidx + 1]
        y[yidx] = lo + alpha * (hi - lo)
        yidx += 1
        alpha += delta
        xidx += int(math.floor(alpha)) + stride
        alpha = math.fmod(alpha, 1.0)
    return y[:yidx].copy()


def naivefilt_farrow(h, x, rate: float, numfilters: int = 32,
                     polyorder: int = 4):
    """Float64 host oracle of the Farrow method itself.

    The Farrow resampler evaluates a per-tap polynomial fit of the
    filter bank (reference Filters.jl:123-147, 780-836); comparing its
    output against the bank-interpolation oracle (``naivefilt``) measures
    the polynomial fit error (~1e-3 for typical banks), not kernel
    correctness. This oracle reproduces the polynomial method in float64
    with the exact integer index walk, so kernels can be held to their
    own numerical error.

    Complex signals and taps go by linearity, their real and imaginary
    parts each through the float64 method (the JAX package's copy casts
    to float64 and drops the imaginary parts).
    """
    x, h = np.asarray(x), np.asarray(h)
    if np.iscomplexobj(x) or np.iscomplexobj(h):
        def part(hp, xp):
            return naivefilt_farrow(hp, xp, rate, numfilters, polyorder)
        if np.iscomplexobj(x):
            return part(h, x.real) + 1j * part(h, x.imag)
        return part(h.real, x) + 1j * part(h.imag, x)

    from ..ops import indexing as idx
    from ..ops import pfb as _pfb
    from ..ops.params import _delta_fx

    h64 = np.asarray(h, np.float64)
    x64 = np.asarray(x, np.float64)
    bank = _pfb.taps2pfb(h64, numfilters)
    C = np.asarray(_pfb.pfb2pnfb(bank, polyorder), np.float64)  # (P1, T)
    T = bank.shape[0]
    dfx = _delta_fx(numfilters, float(rate))
    n_max = idx.accum_count(numfilters, dfx, 0, 1, x64.shape[0])
    inp, phi, frac = (v.numpy() for v in idx.accum_indices(
        numfilters, dfx, 0, 1, n_max))
    xext = np.concatenate([np.zeros(T - 1, np.float64), x64])
    W = np.lib.stride_tricks.sliding_window_view(xext, T)[inp - 1]
    psi = 1.0 + phi.astype(np.float64) + frac
    powers = psi[:, None] ** np.arange(C.shape[0], dtype=np.float64)[None]
    return np.sum(W * (powers @ C), axis=1)
