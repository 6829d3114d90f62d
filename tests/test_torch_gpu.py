"""The CUDA kernels against their plain versions on the card: polyphase
(rational family, in float32, the quantized modes, float64 and complex),
resample (arbitrary rate and Farrow, channel-major and time-major in
float32, channel-major in float64 and complex; each compiled variant and
the general one, equal bit for bit) and the copy and expand
probes; the runtime on the card: StreamingResampler's block loop
with no synchronizing call, and a profiler trace holding the kernel;
the parallel layer on four gloo ranks sharing the card (halo through the
host) against ``filt`` of the whole signal; and bf16 and int8 signals at
an arbitrary or Farrow rate (widened to float32) against the plain
version.

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


# the polyphase kernel's variants: each compiled T of the register and
# sliding variants, L = 1 (broadcast) and the general variant's geometries
# (T outside the set; Q = 1031, more groups than a block's threads; a
# 48-tap complex128 bank over 96 KB, read from global memory)
VARIANT_GEOMETRIES = [(24, 147, 160), (37, 7, 6), (37, 4, 1), (24, 4, 1),
                      (147, 1, 1), (147, 1, 4), (24, 1, 1), (30, 1000, 999),
                      (24, 1031, 1030), (48, 147, 160)]


def _signal(rng, shape, dtype):
    if dtype == torch.int8:
        return torch.from_numpy(np.clip(rng.standard_normal(shape) * 30,
                                        -127, 127).astype(np.int8))
    return _wide(rng, shape, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "general"], ids=["planned",
                                                            "general"])
@pytest.mark.parametrize("T,L,M", VARIANT_GEOMETRIES)
@pytest.mark.parametrize("entry", sorted(set(pp.ENTRIES.values())))
def test_polyphase_variants_match_plain_on_gpu(entry, T, L, M, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x_dt, b_dt, o_dt = {v: k for k, v in pp.ENTRIES.items()}[entry]
    rng = np.random.default_rng(11)
    xlen = 80_007
    x = _signal(rng, (2, xlen), x_dt).cuda()
    hist = _signal(rng, (2, T - 1), x_dt).cuda()
    bank = _signal(rng, (T, L), b_dt).cuda()
    for C, (phi0, d0) in ((1, (1, 1)), (2, (L // 2 + 1, 3))):
        n_all = ((xlen - d0) * L - (phi0 - 1)) // M + 1
        tile = pp.plan(T, L, M, n_all, x_dt, b_dt, C).tile_outputs
        for n in (n_all, 1, 33, min(tile + 1, n_all)):
            args = (x[:C], hist[:C], bank, L, M, phi0, d0, n)
            p = pp.plan(T, L, M, n, x_dt, b_dt, C, variant)
            key = f"{entry}/{p.variant}"
            before = pp.launches_by_variant[key]
            y = pp.polyphase(*args, out_dtype=o_dt, variant=variant)
            yp = pp.polyphase_plain(*args, out_dtype=o_dt)
            torch.cuda.synchronize()
            assert pp.launches_by_variant[key] == before + 1
            assert y.dtype == yp.dtype and y.shape == yp.shape
            if x_dt == torch.int8:
                assert torch.equal(y, yp)
            elif o_dt in (torch.bfloat16, torch.float16):
                assert ulps_apart(y, yp, o_dt,
                                  TOL * float(yp.abs().max())) <= 1
            else:
                assert rel_max_err(y, yp) <= _tol(o_dt)


# the resample kernel's variants: each compiled (T, P+1) pair (10 with 2
# and 5 for bench.py's bank, 73 with 2 for models.Resampler's design, all
# at nphi 32) in every entry point, channel-major with 1 channel (runs of
# outputs a thread), 3 and 64 channels (groups of 8 sharing taps), and
# float32 time-major; each planned and with the general variant forced
RESAMPLE_KINDS = {"t10p2": (10, None), "t10p5": (10, 4), "t73p2": (73, None)}
RESAMPLE_LAYOUTS = {"cm1": (1, 600_000, False), "cm3": (3, 30_011, False),
                    "cm64": (64, 20_011, False), "tm64": (64, 20_011, True)}
RESAMPLE_CASES = [(e, k, lay) for e in ("f32", *WIDE) for k in RESAMPLE_KINDS
                  for lay in RESAMPLE_LAYOUTS
                  if e == "f32" or not RESAMPLE_LAYOUTS[lay][2]]


def _resample_case(entry, kind, layout, device):
    """The kernel and seeded signal of one RESAMPLE_CASES case: T*32 taps,
    so the bank has exactly T taps a phase and the case plans ``kind``."""
    xt, ht = WIDE.get(entry, (torch.float32, torch.float32))
    T, po = RESAMPLE_KINDS[kind]
    C, xlen, tm = RESAMPLE_LAYOUTS[layout]
    rng = np.random.default_rng(12)
    h = _wide(rng, T * 32, ht)
    rate = 0.9173 if C == 64 else 1 / 2.123456789
    p = mt.make_kernel(h, rate=rate, nphi=32, polyorder=po, device=device)
    return p, _wide(rng, (C, xlen), xt).to(device)


@pytest.mark.parametrize("entry,kind,layout", RESAMPLE_CASES)
def test_resample_cases_plan_their_variant(entry, kind, layout):
    # on the CPU: each case below launches the compiled variant it names
    p, x = _resample_case(entry, kind, layout, "cpu")
    C, xlen, tm = RESAMPLE_LAYOUTS[layout]
    n = mt.outputlength(p, xlen)
    plan = rs.plan(p.taps_per_phi, p.table.shape[0], p.nphi, p.delta_fx, n,
                   C, x.dtype, p.table.dtype, tm)
    assert plan.variant == kind
    assert plan.channels == (32 if tm else (8 if C >= 8 else 1))


@pytest.mark.gpu
@pytest.mark.parametrize("entry,kind,layout", RESAMPLE_CASES)
def test_resample_variants_match_plain_on_gpu(entry, kind, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xt, _ = WIDE.get(entry, (torch.float32, torch.float32))
    C, xlen, tm = RESAMPLE_LAYOUTS[layout]
    p, x = _resample_case(entry, kind, layout, "cuda")
    st = mt.setphase(p, mt.init_state(p, (C,), xt), 0.37)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    n, _, _ = mt.ops.indexing.host_carry(p, st.phase, st.deficit, xlen)
    xs = x.t().contiguous() if tm else x
    args = (xs, st.history.contiguous(), p, st.phase, st.deficit, n)
    assert rs.plan(p.taps_per_phi, p.table.shape[0], p.nphi, p.delta_fx, n,
                   C, xt, p.table.dtype, tm).variant == kind
    kern = rs.resample_tm if tm else rs.resample
    plain = rs.resample_tm_plain if tm else rs.resample_plain
    want = plain(*args)
    got = {}
    for variant in (None, "general"):
        key = f"{'tm' if tm else entry}/{variant or kind}"
        before = rs.launches_by_variant[key]
        got[variant] = kern(*args, variant=variant)
        torch.cuda.synchronize()
        assert rs.launches_by_variant[key] == before + 1
        assert got[variant].dtype == want.dtype == xt
        assert got[variant].shape == want.shape
        assert rel_max_err(got[variant], want) <= _tol(xt)
    assert torch.equal(got[None], got["general"])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4096, 100_003,
                               # one 32 KB chunk of float32, several and a
                               # partial last one, more than one per block
                               8192, 24_676, 17_301_509])
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
@pytest.mark.parametrize("shape", [(1, 128), (777, 128), (33, 4), (45, 12),
                                   (29, 20), (1001, 20)])
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


def _gpu_sharded_cases():
    """The sharding cases on the card (numpy inputs, seeded): the rational
    specs and float64 arbitrary rates on (2, 2), the 64-channel Farrow on
    (4, 1) and (1, 4), bf16 and int8 on (2, 2), a block shorter than
    h_min on (1, 4)."""
    rng = np.random.default_rng(13)
    cases = []
    for spec in (Fraction(1, 1), Fraction(4, 1), Fraction(1, 4),
                 Fraction(7, 5), Fraction(147, 160)):
        cases.append(dict(id=f"rat{spec}", mesh=(2, 2), kind="resample",
                          h=rng.standard_normal(48).astype(np.float32),
                          x=rng.standard_normal((8, 16_000)).astype(
                              np.float32), kw={"ratio": spec}))
    h_arb = (mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32)
    for rate in (0.8112, 1.618):
        cases.append(dict(id=f"arb{rate}", mesh=(2, 2), kind="resample",
                          h=h_arb, x=rng.standard_normal((4, 16_000)),
                          kw={"rate": rate}))
    x_far = rng.standard_normal((64, 8_000)).astype(np.float32)
    for mesh in ((4, 1), (1, 4)):
        cases.append(dict(id=f"farrow{mesh}", mesh=mesh, kind="resample",
                          h=h_arb.astype(np.float32), x=x_far,
                          kw={"rate": 0.9173, "nphi": 32, "polyorder": 4}))
    h_q = (mt.firdes(24 * 21, 0.5 / 21, mt.kaiser, beta=7.0) * 21
           ).astype(np.float32)
    x_q = rng.standard_normal((4, 64_000)).astype(np.float32)
    cases.append(dict(id="bf16", mesh=(2, 2), kind="stream", h=h_q, x=x_q,
                      dtype="bfloat16", kw={"ratio": Fraction(147, 160)}))
    cases.append(dict(id="int8", mesh=(2, 2), kind="stream",
                      h=np.asarray(mt.quant.quantize_taps(h_q)[0]),
                      x=mt.quant.quantize_signal(x_q, device="cpu")[0].numpy(),
                      kw={"ratio": Fraction(147, 160)}))
    cases.append(dict(id="short", mesh=(1, 4), kind="short",
                      h=rng.standard_normal(300),
                      x=rng.standard_normal((1, 800)),
                      kw={"ratio": Fraction(1, 1)}))
    return cases


@pytest.mark.gpu
def test_sharded_ranks_match_unsharded_on_gpu():
    """Four gloo ranks on one card (halo and history staged through the
    host) against ``filt`` of the whole signal on the card: counts and
    states exact, outputs within 1e-5 * max|y|, int8 equal, bf16 within
    one bf16 ulp of max|y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multirate_tpu_torch.parallel.multihost import spawn_world
    from multirate_tpu_torch.utils.testing import sharded_cases

    cases = _gpu_sharded_cases()
    mt.filt(np.ones(8, np.float32), torch.ones(64, device="cuda"),
            0.5)  # build the kernels here; the ranks load them
    mt.filt(np.ones(8, np.float32), torch.ones(64, device="cuda"), 1)
    ranks = spawn_world(sharded_cases, 4, args=(cases,), device="cuda:0",
                        timeout_s=300)
    for c in cases:
        got = ranks[0][c["id"]]
        for r in ranks[1:]:
            for k, v in got.items():
                if isinstance(v, np.ndarray):
                    assert np.array_equal(r[c["id"]][k], v), (c["id"], k)
        if c["kind"] == "short":
            assert "h_min" in got["raised"]
            continue
        h = torch.from_numpy(c["h"])
        x = torch.from_numpy(c["x"]).cuda()
        if c.get("dtype") == "bfloat16":
            h, x = h.to(torch.bfloat16), x.to(torch.bfloat16)
        p = mt.make_kernel(h, device="cuda", **c["kw"])
        want, count, st = mt.filt_block(
            p, mt.init_state(p, x.shape[:-1], x.dtype), x)
        assert got["y"].shape == tuple(want.shape), c["id"]
        if c["kind"] == "stream":
            assert sum(got["counts"][0]) == count
            hist, phase, deficit = got["state"]
            assert (phase, deficit) == (st.phase, st.deficit)
            assert np.array_equal(hist, st.history.float().cpu().numpy())
            assert got["compact_device"]
        if c["id"] == "int8":
            assert np.array_equal(got["y"], want.cpu().numpy())
        else:
            tol = 2.0 ** -8 if c["id"] == "bf16" else TOL
            assert rel_max_err(got["y"], want) <= tol, c["id"]


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 64])
@pytest.mark.parametrize("rate", [1 / 2.123456789, 0.4709, 0.9173])
@pytest.mark.parametrize("polyorder", [None, 4], ids=["arbitrary", "farrow"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_widened_rate_matches_plain_on_gpu(dtype, polyorder, rate, channels):
    """bf16 and int8 signals at a rate run the float32 kernel after one
    cast: counts and states exact, outputs within 1e-5 * max|y| of the
    plain version on the same widened values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(14)
    h = (mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32
         ).astype(np.float32)
    p = mt.make_kernel(h, rate=rate, nphi=32, polyorder=polyorder,
                       device="cuda")
    x = torch.from_numpy(rng.standard_normal((channels, 20_011)).astype(
        np.float32) * (40 if dtype == torch.int8 else 1)).cuda().to(dtype)
    for phase in (None, 0.37):
        st = mt.init_state(p, (channels,), dtype)
        if phase is not None:
            st = mt.setphase(p, st, phase)
        before = rs.launches["f32"]
        yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
        yp, cp, sp = mt.filt_block(p, st, x, path="windows")
        torch.cuda.synchronize()
        assert rs.launches["f32"] == before + 1
        assert yk.dtype == yp.dtype == torch.float32
        assert ck == cp == yk.shape[-1]
        assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
        assert sk.history.dtype == dtype and torch.equal(sk.history,
                                                         sp.history)
        assert rel_max_err(yk, yp) <= TOL
