"""The port's rational index algebra (torch int64 and Python ints) equals the
JAX package's exactly, over a seeded sweep of L, M, entry phase, entry
deficit and block length. Indices, counts and states are integers: the
tolerance is zero."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import multirate_tpu as mr
from multirate_tpu.ops import indexing as jidx
from multirate_tpu_torch.ops import indexing as tidx
import multirate_tpu_torch as mt

RATIOS = [(1, 1), (4, 1), (1, 4), (3, 5), (5, 3), (147, 160), (160, 147),
          (7, 1), (1, 9)]


def _sweep(seed, n=40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        L, M = RATIOS[rng.integers(len(RATIOS))]
        phi0 = int(rng.integers(1, L + 1))
        d0 = int(rng.integers(1, M // L + 3))
        xlen = int(rng.choice([0, 1, 2, d0 - 1, 97, 4096, 80007,
                               int(rng.integers(0, 10**6)), 2**40 + 3]))
        yield L, M, phi0, d0, max(xlen, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indices_equal(seed):
    for L, M, phi0, d0, _ in _sweep(seed):
        n = 300
        ti, tp = tidx.rational_indices(L, M, phi0, d0, n)
        ji, jp = jidx.rational_indices(L, M, phi0, d0, n)
        assert ti.dtype == tp.dtype == torch.int64
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_and_carry_equal(seed):
    for L, M, phi0, d0, xlen in _sweep(seed):
        want = tuple(int(v) for v in jidx.rational_carry(L, M, phi0, d0, xlen))
        assert tidx.rational_carry(L, M, phi0, d0, xlen) == want
        assert tidx.rational_count(L, M, phi0, d0, xlen) == want[0]
        # the same algebra on int64 tensors
        got = tidx.rational_carry(L, M, torch.tensor(phi0), torch.tensor(d0),
                                  torch.tensor(xlen))
        assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("ratio", [Fraction(*r) for r in RATIOS])
def test_host_carry_and_lengths_equal(ratio):
    h = np.random.default_rng(3).standard_normal(37).astype(np.float32)
    jp = mr.make_kernel(h, ratio=ratio)
    tp = mt.make_kernel(h, ratio=ratio)
    assert type(tp).__name__ == type(jp).__name__
    rng = np.random.default_rng(ratio.numerator * 1000 + ratio.denominator)
    L, M = ratio.numerator, ratio.denominator
    for _ in range(30):
        phase = int(rng.integers(1, L + 1)) if L > 1 and M > 1 else 0
        deficit = int(rng.integers(1, M // L + 3))
        xlen = int(rng.integers(0, 5000))
        assert tidx.host_carry(tp, phase, deficit, xlen) == \
            jidx.host_carry(jp, phase, deficit, xlen)
        st = mt.FilterState(history=torch.zeros(0), phase=phase or 1,
                            deficit=deficit)
        assert mt.outputlength(tp, xlen, state=st) == \
            mr.outputlength(jp, xlen, state=st)
        outlen = int(rng.integers(1, 3000))
        assert mt.inputlength(tp, outlen, state=st) == \
            mr.inputlength(jp, outlen, state=st)
        phi = int(rng.integers(1, L + 1))
        assert mt.outputlength(xlen, ratio, phi) == \
            mr.outputlength(xlen, ratio, phi)
        assert mt.inputlength(outlen, ratio, phi) == \
            mr.inputlength(outlen, ratio, phi)
        assert mt.nextphase(phi, ratio) == mr.nextphase(phi, ratio)
        assert mt.nextphase(phi, (L, M)) == mr.nextphase(phi, (L, M))
        assert mt.max_outputs(tp, xlen) == mr.max_outputs(jp, xlen)
    assert mt.outputlength(tp, 1000) == mr.outputlength(jp, 1000)


def test_length_algebra_rejects_a_state_in_the_phase_slot():
    tp = mt.make_kernel(np.ones(8, np.float32), ratio=Fraction(3, 5))
    st = mt.init_state(tp)
    with pytest.raises(TypeError, match="initial_phi"):
        mt.outputlength(tp, 100, st)
    with pytest.raises(TypeError, match="initial_phi"):
        mt.inputlength(tp, 100, st)
