"""Debug utilities: the cross-path check and the sequential index replay.

Counterpart of ``multirate_tpu/utils/debug.py``. The remaining risk
classes are kernel bugs and index-math bugs:

- ``check_block(...)``: a differential check of one block. It runs the
  chosen path (the CUDA kernels on a CUDA tensor) and ``path="windows"``,
  the plain PyTorch version, on the same device and compares them, then
  validates the closed-form index vectors against a literal replay of the
  reference's sequential recurrences (Filters.jl:558-568 / :663-673) in
  exact integer arithmetic.
- ``check_indices(...)``: that replay alone.

The JAX package's ``interpret_kernels`` (Pallas interpreter mode, the
TPU kernels' sanitizer) has no counterpart: ``path="windows"`` is the
port's plain version of every kernel, on any device.
"""

from __future__ import annotations

import torch

from ..ops import indexing as idx
from ..ops.compute import filt_block_raw
from ..ops.params import (PHASE_FRAC_BITS, FIRArbitrary, FIRDecimator,
                          FIRFarrow, FIRRational)

__all__ = ["check_block", "check_indices"]


def check_indices(params, phase0: int, deficit0: int, xlen: int) -> int:
    """Replay the reference's sequential index recurrence and assert the
    closed-form vectors match exactly. Returns the output count."""
    if isinstance(params, (FIRRational, FIRDecimator)):
        L = getattr(params, "interpolation", 1)
        M = params.decimation
        phi0 = phase0 if isinstance(params, FIRRational) else 1
        n = int(idx.rational_count(L, M, phi0, deficit0, xlen))
        if n:
            inp, phic = idx.rational_indices(L, M, phi0, deficit0, n)
            inp, phic = inp.tolist(), phic.tolist()
            i, p = deficit0, phi0
            for k in range(n):
                assert inp[k] == i, (k, inp[k], i)
                assert phic[k] == p - 1, (k, phic[k], p)
                i += (p + M - 1) // L
                p += M % L
                if p > L:
                    p -= L
        return n
    if isinstance(params, (FIRArbitrary, FIRFarrow)):
        D = params.nphi << PHASE_FRAC_BITS
        n = int(idx.accum_count(params.nphi, params.delta_fx, phase0,
                                deficit0, xlen))
        if n:
            inp, phic, _ = idx.accum_indices(
                params.nphi, params.delta_fx, phase0, deficit0, n)
            inp, phic = inp.tolist(), phic.tolist()
            u, i = phase0, deficit0
            for k in range(n):
                assert inp[k] == i, (k, inp[k], i)
                assert phic[k] == (u % D) >> PHASE_FRAC_BITS, (k, phic[k])
                u2 = u + params.delta_fx
                i += u2 // D - u // D
                u = u2
        return n
    return xlen  # standard / interpolator: trivially arange


def check_block(params, state, x, path: str = "auto",
                rtol: float = 1e-4, atol: float = 1e-5):
    """Run ``path`` and the plain ``windows`` path on one block on x's
    device and demand elementwise agreement (counts and next states
    exactly); also validate the index math. Returns the chosen path's
    (y, count, new_state)."""
    y, count, st = filt_block_raw(params, state, x, path)
    y_ref, count_ref, st_ref = filt_block_raw(params, state, x, "windows")
    assert count == count_ref, f"count mismatch: {count} vs {count_ref}"
    assert (st.phase, st.deficit) == (st_ref.phase, st_ref.deficit), \
        f"state mismatch: {(st.phase, st.deficit)} vs " \
        f"{(st_ref.phase, st_ref.deficit)}"
    close = torch.isclose(y, y_ref, rtol=rtol, atol=atol)
    if not bool(close.all()):
        bad = tuple(torch.nonzero(~close)[0].tolist())
        raise AssertionError(
            f"path '{path}' diverges from windows at {bad}: "
            f"{y[bad].item()} vs {y_ref[bad].item()}")
    check_indices(params, state.phase, state.deficit, x.shape[-1])
    return y, count, st
