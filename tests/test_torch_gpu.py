"""The CUDA kernels against their plain versions on the card: polyphase
(rational family, in float32 and in the quantized modes) and resample
(arbitrary rate and Farrow, channel-major and time-major).

Marked ``gpu``: it skips without a CUDA device. It imports no JAX, so it
runs on a machine with the card alone:

    python -m pytest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: max|dy| <= 1e-5 * max|y| (the same float32 products, summed in
another order; bf16 products are exact in float32); int8 equal (exact
integer sums); narrow stores within one ulp of the store type; counts and
states exact.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import multirate_tpu_torch as mt
from multirate_tpu_torch.ops.cuda import polyphase as pp
from multirate_tpu_torch.ops.cuda import resample as rs
from multirate_tpu_torch.utils.testing import ulps_apart

TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,taps_per_phase", [
    (Fraction(147, 160), 24), (Fraction(3, 5), 24), (Fraction(1, 4), 24),
    (Fraction(4, 1), 24), (Fraction(1, 1), 24),
    (Fraction(1000, 999), 30),   # bank read from global memory
    (Fraction(1, 200), 1)])      # tile shrunk to fit its span
def test_kernel_matches_plain_on_gpu(ratio, taps_per_phase):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    L, M = ratio.numerator, ratio.denominator
    h = rng.standard_normal(taps_per_phase * L * (M if L == 1 else 1)
                            + 3).astype(np.float32)
    p = mt.make_kernel(h, ratio=ratio, device="cuda")
    x = torch.from_numpy(
        rng.standard_normal((2, 30_011)).astype(np.float32)).cuda()
    st = mt.init_state(p, (2,))
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    before = pp.launches["f32"]
    yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
    yp, cp, sp = mt.filt_block(p, st, x, path="windows")
    torch.cuda.synchronize()
    assert pp.launches["f32"] == before + 1
    assert ck == cp == yk.shape[-1]
    assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
    assert torch.equal(sk.history, sp.history)
    assert float((yk - yp).abs().max()) <= TOL * float(yp.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("time_major", [False, True], ids=["cm", "tm"])
@pytest.mark.parametrize("polyorder", [None, 4], ids=["arbitrary", "farrow"])
@pytest.mark.parametrize("rate,nphi", [
    (1 / 2.123456789, 32), (0.9173, 7), (1.0, 32), (2.5, 32),
    (0.01, 32)])                 # spans that shrink the tile
def test_resample_matches_plain_on_gpu(rate, nphi, polyorder, time_major):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    h = rng.standard_normal(10 * nphi + 3).astype(np.float32)
    p = mt.make_kernel(h, rate=rate, nphi=nphi, polyorder=polyorder,
                       device="cuda")
    x = torch.from_numpy(
        rng.standard_normal((40, 30_011)).astype(np.float32)).cuda()
    st = mt.setphase(p, mt.init_state(p, (40,)), 0.37)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    step = mt.filt_block_tm if time_major else mt.filt_block
    xs = x.t().contiguous() if time_major else x
    count = rs.launches_tm if time_major else rs.launches
    yk, ck, sk = step(p, st, xs, path="kernel")
    yp, cp, sp = step(p, st, xs, path="windows")
    torch.cuda.synchronize()
    assert (rs.launches_tm if time_major else rs.launches) == count + 1
    assert ck == cp == yk.shape[0 if time_major else -1]
    assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
    assert torch.equal(sk.history, sp.history)
    assert float((yk - yp).abs().max()) <= TOL * float(yp.abs().max())


# entry point: (storage dtype of taps and signal, store_dtype)
QUANT_MODES = {
    "bf16": (torch.bfloat16, None),
    "s8": (torch.int8, None),
    "f32_bf16out": (torch.float32, torch.bfloat16),
    "f32_f16out": (torch.float32, torch.float16),
    "bf16_bf16out": (torch.bfloat16, torch.bfloat16),
    "bf16_f16out": (torch.bfloat16, torch.float16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,taps_per_phase", [
    (Fraction(147, 160), 24), (Fraction(1, 1), 24), (Fraction(1, 4), 24),
    (Fraction(4, 1), 37),
    (Fraction(1000, 999), 30)])  # bank read from global memory
@pytest.mark.parametrize("mode", list(QUANT_MODES))
def test_quantized_kernel_matches_plain_on_gpu(mode, ratio, taps_per_phase):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype, store = QUANT_MODES[mode]
    rng = np.random.default_rng(7)
    L, M = ratio.numerator, ratio.denominator
    n_taps = taps_per_phase * L * (M if L == 1 else 1) + 3
    if dtype == torch.int8:
        h = torch.from_numpy(rng.integers(-127, 128, n_taps).astype(np.int8))
        x = torch.from_numpy(
            rng.integers(-127, 128, (2, 30_011)).astype(np.int8))
    else:
        h = torch.from_numpy(rng.standard_normal(n_taps).astype(np.float32))
        x = torch.from_numpy(
            rng.standard_normal((2, 30_011)).astype(np.float32))
    p = mt.make_kernel(h.to(dtype), ratio=ratio, device="cuda",
                       store_dtype=store)
    x = x.to(dtype).cuda()
    st = mt.init_state(p, (2,), dtype)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    before = pp.launches[mode]
    yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
    yp, cp, sp = mt.filt_block(p, st, x, path="windows")
    torch.cuda.synchronize()
    assert pp.launches[mode] == before + 1
    assert ck == cp == yk.shape[-1]
    assert yk.dtype == yp.dtype == (store or pp.ACCUMULATOR[dtype])
    assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
    assert torch.equal(sk.history, sp.history)
    if dtype == torch.int8:
        assert torch.equal(yk, yp)
    elif store is None:
        assert float((yk - yp).abs().max()) <= TOL * float(yp.abs().max())
    else:
        # float32 sums in another order, rounded once: one ulp, or TOL
        assert ulps_apart(yk, yp, store,
                          TOL * float(yp.abs().max())) <= 1
