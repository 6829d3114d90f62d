"""Differential-test helpers with first-divergence diagnostics.

The reference's custom vector isapprox reports the index of the first
failing element (runtests.jl:18-35); these helpers do the same, plus dump a
side-by-side neighborhood for debugging. ``ulps_apart`` measures narrow
(bfloat16, float16) outputs in units of their own spacing, and
``rel_max_err`` real or complex outputs against the largest magnitude.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["first_divergence", "assert_close", "rms", "ulps_apart",
           "rel_max_err"]

# significant bits and the exponent of the smallest spacing (subnormal)
_SPACING = {torch.bfloat16: (8, -133), torch.float16: (11, -24)}


def ulps_apart(a: torch.Tensor, b: torch.Tensor, dtype,
               floor: float = 0.0) -> float:
    """The largest |a - b| in ulps of ``dtype`` (torch.bfloat16 or
    torch.float16), the spacing at the larger of |a| and |b|: at most 1
    where both are the same value rounded apart once. ``floor`` is the
    least spacing counted, so that outputs near zero, whose accumulators
    were summed in another order, are held to the accumulator's own
    tolerance (an absolute ``floor``) rather than to their tiny ulp."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    bits, tiny = _SPACING[dtype]
    a, b = a.double(), b.double()
    exp = torch.frexp(torch.maximum(a.abs(), b.abs())).exponent
    ulp = torch.ldexp(torch.ones_like(a), torch.clamp(exp - bits, min=tiny))
    return float(((a - b).abs() / ulp.clamp(min=floor)).max())


def rel_max_err(got, want) -> float:
    """max|got - want| / max|want| over real or complex arrays or tensors
    (on any device), in complex128: the modulus of a complex difference,
    never its real part alone. Shapes must agree; 0 for empty arrays."""
    got, want = (v.detach().cpu().to(torch.complex128).numpy()
                 if isinstance(v, torch.Tensor)
                 else np.asarray(v).astype(np.complex128)
                 for v in (got, want))
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {got.shape}, {want.shape}")
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


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
