"""The CUDA kernels against their plain versions on the card: polyphase
(rational family, in float32, the quantized modes, float64 and complex)
and resample (arbitrary rate and Farrow, channel-major and time-major in
float32, channel-major in float64 and complex).

Marked ``gpu``: it skips without a CUDA device. It imports no JAX, so it
runs on a machine with the card alone:

    python -m pytest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: max|dy| <= 1e-5 * max|y| (the same float32 products, summed in
another order; bf16 products are exact in float32; complex64 the same);
1e-12 * max|y| for float64 and complex128; int8 equal (exact integer
sums); narrow stores within one ulp of the store type; counts and states
exact.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import multirate_tpu_torch as mt
from multirate_tpu_torch.ops.cuda import polyphase as pp
from multirate_tpu_torch.ops.cuda import resample as rs
from multirate_tpu_torch.utils.testing import rel_max_err, ulps_apart

TOL = 1e-5
TOL_WIDE = 1e-12
# entry point: (signal dtype, taps dtype), the same for both kernels
WIDE = {"f64": (torch.float64, torch.float64),
        "c64": (torch.complex64, torch.float32),
        "c64c": (torch.complex64, torch.complex64),
        "c128": (torch.complex128, torch.float64),
        "c128c": (torch.complex128, torch.complex128)}


def _wide(rng, shape, dtype):
    v = torch.from_numpy(rng.standard_normal(shape))
    if dtype.is_complex:
        v = torch.complex(v, torch.from_numpy(rng.standard_normal(shape)))
    return v.to(dtype)


def _tol(dtype):
    return TOL if dtype in (torch.float32, torch.complex64) else TOL_WIDE


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
    count = rs.launches_tm if time_major else rs.launches["f32"]
    yk, ck, sk = step(p, st, xs, path="kernel")
    yp, cp, sp = step(p, st, xs, path="windows")
    torch.cuda.synchronize()
    assert (rs.launches_tm if time_major else rs.launches["f32"]) \
        == count + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,taps_per_phase", [
    (Fraction(147, 160), 24), (Fraction(3, 5), 24), (Fraction(1, 4), 24),
    (Fraction(4, 1), 24), (Fraction(1, 1), 24),
    (Fraction(147, 160), 48)])   # a complex128 bank read from global memory
@pytest.mark.parametrize("entry", list(WIDE))
def test_wide_kernel_matches_plain_on_gpu(entry, ratio, taps_per_phase):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xt, ht = WIDE[entry]
    rng = np.random.default_rng(8)
    L, M = ratio.numerator, ratio.denominator
    h = _wide(rng, taps_per_phase * L * (M if L == 1 else 1) + 3, ht)
    p = mt.make_kernel(h, ratio=ratio, device="cuda")
    x = _wide(rng, (2, 30_011), xt).cuda()
    st = mt.init_state(p, (2,), xt)
    if L > 1:
        st = mt.setphase(p, st, 0.37)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    before = pp.launches[entry]
    yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
    yp, cp, sp = mt.filt_block(p, st, x, path="windows")
    torch.cuda.synchronize()
    assert pp.launches[entry] == before + 1
    assert ck == cp == yk.shape[-1] and yk.dtype == yp.dtype == xt
    assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
    assert torch.equal(sk.history, sp.history)
    assert rel_max_err(yk, yp) <= _tol(xt)


@pytest.mark.gpu
@pytest.mark.parametrize("time_major", [False, True], ids=["cm", "tm"])
@pytest.mark.parametrize("polyorder", [None, 4], ids=["arbitrary", "farrow"])
@pytest.mark.parametrize("rate,nphi", [(1 / 2.123456789, 32), (0.9173, 7),
                                       (2.5, 32)])
@pytest.mark.parametrize("entry", list(WIDE))
def test_wide_resample_matches_plain_on_gpu(entry, rate, nphi, polyorder,
                                            time_major):
    # time-major blocks of these types run the channel-major kernel on the
    # transpose: its entry point counts, the time-major one does not
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xt, ht = WIDE[entry]
    rng = np.random.default_rng(9)
    h = _wide(rng, 10 * nphi + 3, ht)
    p = mt.make_kernel(h, rate=rate, nphi=nphi, polyorder=polyorder,
                       device="cuda")
    x = _wide(rng, (3, 30_011), xt).cuda()
    st = mt.setphase(p, mt.init_state(p, (3,), xt), 0.37)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    step = mt.filt_block_tm if time_major else mt.filt_block
    xs = x.t().contiguous() if time_major else x
    before = (rs.launches[entry], rs.launches_tm)
    yk, ck, sk = step(p, st, xs, path="kernel")
    yp, cp, sp = step(p, st, xs, path="windows")
    torch.cuda.synchronize()
    assert (rs.launches[entry], rs.launches_tm) == (before[0] + 1,
                                                    before[1])
    assert ck == cp == yk.shape[0 if time_major else -1]
    assert yk.dtype == yp.dtype == xt
    assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
    assert torch.equal(sk.history, sp.history)
    assert rel_max_err(yk, yp) <= _tol(xt)
