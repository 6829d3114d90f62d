"""Polyphase filter bank construction and polynomial (Farrow) banks.

Behavioral reference: Multirate.jl src/Filters.jl:271-338 (taps2pfb,
pfb2pnfb) and src/support.jl:85-88 (polyfit). Host-side numpy:
bank construction is one-time setup, the banks then live on device.

Layout convention (same as the reference's): ``pfb[t, p]`` is tap-row ``t`` of
phase ``p`` with the rows *time-flipped*, so the dot product of column ``p``
with a forward-in-time window of ``taps_per_phi`` input samples ending at the
current input sample is a convolution. Example (reference Filters.jl:276-281):
``taps2pfb(1..9, 4)`` = [[9,0,0,0], [5,6,7,8], [1,2,3,4]].
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["taps2pfb", "polyfit", "polyval", "pfb2pnfb"]


def taps2pfb(h, nphi: int) -> np.ndarray:
    """Reshape taps ``h`` into a (taps_per_phi, nphi) polyphase bank.

    Zero-pads ``h`` up to a multiple of ``nphi`` and flips the rows so each
    column, dotted with a forward-in-time signal window, computes a
    convolution (reference: Filters.jl:284-298).
    """
    h = np.asarray(h)
    hlen = h.shape[0]
    taps_per_phi = math.ceil(hlen / nphi) if hlen else 1
    padded = np.zeros(taps_per_phi * nphi, dtype=h.dtype)
    padded[:hlen] = h
    return padded.reshape(taps_per_phi, nphi)[::-1, :].copy()


def polyfit(y, polyorder: int) -> np.ndarray:
    """Least-squares polynomial fit of ``y`` over abscissae 1..len(y).

    Returns ascending coefficients c such that
    ``p(x) = sum_k c[k] * x**k`` minimizes ``|p(1..n) - y|``
    (reference: support.jl:85-88, which returns a Polynomials.Poly).
    """
    y = np.asarray(y)
    y = y.astype(np.complex128 if np.iscomplexobj(y) else np.float64)
    n = y.shape[0]
    x = np.arange(1, n + 1, dtype=np.float64)
    A = x[:, None] ** np.arange(polyorder + 1)[None, :]
    coeffs, *_ = np.linalg.lstsq(A.astype(y.dtype), y, rcond=None)
    return coeffs


def polyval(coeffs, x):
    """Evaluate ascending-coefficient polynomial(s) at ``x`` (Horner)."""
    coeffs = np.asarray(coeffs)
    result = np.zeros_like(np.asarray(x, dtype=np.float64) * coeffs[..., 0])
    for k in range(coeffs.shape[-1] - 1, -1, -1):
        result = result * x + coeffs[..., k]
    return result


def pfb2pnfb(pfb: np.ndarray, polyorder: int) -> np.ndarray:
    """Fit each PFB *row* (one tap position across all phases) with a
    degree-``polyorder`` polynomial over x = 1..nphi.

    Returns a coefficient matrix ``C`` of shape (polyorder+1, taps_per_phi):
    ``C[k, t]`` is the x**k coefficient of tap-row ``t``'s polynomial, so
    the taps for fractional phase ``x`` are the row vector
    ``[1, x, x^2, ...] @ C`` — one small matmul per output block.
    (Reference: Filters.jl:311-321 returns a Vector{Poly}.)
    """
    taps_per_phi, nphi = pfb.shape
    x = np.arange(1, nphi + 1, dtype=np.float64)
    A = x[:, None] ** np.arange(polyorder + 1)[None, :]
    # One batched lstsq: solve A @ C = pfb.T for C (polyorder+1, taps_per_phi).
    # Complex banks fit in complex128 (a float64 cast would silently drop
    # the imaginary part of every Farrow tap polynomial).
    dt = np.complex128 if np.iscomplexobj(pfb) else np.float64
    C, *_ = np.linalg.lstsq(A.astype(dt), np.asarray(pfb, dtype=dt).T,
                            rcond=None)
    return C
