"""The CUDA kernels against their plain versions on the card: polyphase
(rational family, in float32, the quantized modes, float64 and complex),
resample (arbitrary rate and Farrow, channel-major and time-major in
float32, channel-major in float64 and complex) and the copy and expand
probes; and the runtime on the card: StreamingResampler's block loop
with no synchronizing call, and a profiler trace holding the kernel.

Marked ``gpu``: it skips without a CUDA device. It imports no JAX, so it
runs on a machine with the card alone:

    python -m pytest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: max|dy| <= 1e-5 * max|y| (the same float32 products, summed in
another order; bf16 products are exact in float32; complex64 the same);
1e-12 * max|y| for float64 and complex128; int8 equal (exact integer
sums); narrow stores within one ulp of the store type; counts and states
exact; the probes bit for bit.
"""

import json
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import multirate_tpu_torch as mt
from multirate_tpu_torch.ops.cuda import polyphase as pp
from multirate_tpu_torch.ops.cuda import probe
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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4096, 100_003])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.complex128])
def test_probe_copy_matches_plain_on_gpu(dtype, offset, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(10)
    buf = _wide(rng, n + offset, dtype if dtype != torch.int8
                else torch.float64)
    buf = (buf * 16).to(dtype) if dtype == torch.int8 else buf
    x = buf.cuda()[offset:]  # a source at an odd element offset
    before = probe.launches["copy"]
    y = probe.copy(x)
    torch.cuda.synchronize()
    assert probe.launches["copy"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y.view(torch.uint8),
                       probe.copy_plain(x).view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 128), (777, 128), (33, 4)])
@pytest.mark.parametrize("ratio", [1, 2, 4, 8])
@pytest.mark.parametrize("odt", [torch.float32, torch.bfloat16,
                                 torch.float16, torch.int8])
def test_probe_expand_matches_plain_on_gpu(odt, ratio, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(
        np.float32)).cuda()
    name = probe.EXPAND[odt]
    before = probe.launches[name]
    y = probe.expand(x, ratio, odt)
    torch.cuda.synchronize()
    assert probe.launches[name] == before + 1
    want = probe.expand_plain(x, ratio, odt)
    assert y.dtype == want.dtype and torch.equal(y, want)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [Fraction(147, 160), 0.76543])
def test_stream_push_loop_never_syncs_on_gpu(spec):
    # per-block counts are host ints and blocks go up through pinned
    # memory: the loop makes no synchronizing call
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    h = (mt.firdes(24 * 7, 0.5 / 7, mt.kaiser, beta=7.0) * 7
         ).astype(np.float32)
    x = rng.standard_normal(5 * 4096 + 999).astype(np.float32)
    s = mt.io.StreamingResampler(mt.FIRFilter(h, spec, device="cuda"),
                                 block_size=4096)
    s.push(x[:10])  # first use: builds and loads outside the guard
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        i = 10
        while i < len(x):
            n = min(int(rng.integers(100, 5000)), len(x) - i)
            s.push(x[i:i + n])
            i += n
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = s.flush()
    whole = mt.filt(h, torch.from_numpy(x).cuda(), spec).cpu().numpy()
    assert got.shape == whole.shape
    assert rel_max_err(got, whole) <= 1e-6


@pytest.mark.gpu
def test_trace_holds_the_polyphase_kernel_on_gpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = mt.models.DATToCD(device="cuda")
    x = torch.randn(1 << 16, device="cuda")
    d(x)  # build and load outside the trace
    d.reset()
    with mt.utils.trace(str(tmp_path)):
        with mt.utils.annotate("resample-block"):
            d(x)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert "resample-block" in names
    assert any("mr_polyphase_f32" in n for e, n in zip(events, names)
               if e.get("cat") == "kernel")
