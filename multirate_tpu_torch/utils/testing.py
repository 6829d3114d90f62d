"""Differential-test helpers with first-divergence diagnostics.

The reference's custom vector isapprox reports the index of the first
failing element (runtests.jl:18-35); these helpers do the same, plus dump a
side-by-side neighborhood for debugging.
"""

from __future__ import annotations

import numpy as np

__all__ = ["first_divergence", "assert_close", "rms"]


def rms(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128).ravel()
    b = np.asarray(b, dtype=np.complex128).ravel()
    n = min(a.size, b.size)
    if n == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.abs(a[:n] - b[:n]) ** 2)))


def first_divergence(a, b, rtol: float, atol: float):
    """Index of the first element where a and b differ beyond tolerance,
    or -1 if all close."""
    a = np.asarray(a)
    b = np.asarray(b)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    if not bad.any():
        return -1
    return int(np.argwhere(bad)[0][-1])


def assert_close(actual, expected, rtol=None, atol=0.0, label: str = ""):
    """Elementwise comparison with index-of-first-divergence reporting.

    Default rtol is sqrt(eps) of the wider real dtype — the same bound as
    Julia's isapprox default used throughout the reference tests."""
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (
        f"{label}: shape mismatch {actual.shape} vs {expected.shape}")
    if rtol is None:
        rdt = np.finfo(np.promote_types(
            actual.real.dtype, expected.real.dtype)).eps
        rtol = float(np.sqrt(rdt))
    i = first_divergence(actual, expected, rtol, atol)
    if i >= 0:
        lo, hi = max(0, i - 3), i + 4
        raise AssertionError(
            f"{label}: first divergence at index {i} (rtol={rtol}, "
            f"atol={atol})\nactual  [{lo}:{hi}] = {actual[..., lo:hi]}\n"
            f"expected[{lo}:{hi}] = {expected[..., lo:hi]}\n"
            f"rms = {rms(actual, expected)}")
