"""Naive reference resamplers — the independent ground truth for tests.

Behavioral reference: Multirate.jl src/NaiveResamplers.jl (the reference's
own oracle module). Pure numpy on host, deliberately simple and slow:
zero-stuff -> causal FIR -> downselect, plus the linear-interpolation walk for
arbitrary rates. Copied from ``multirate_tpu/utils/oracle.py`` so the port
needs no JAX; the Farrow-method oracle comes with the arbitrary/Farrow port.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

__all__ = ["naivefilt", "causal_fir"]


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
