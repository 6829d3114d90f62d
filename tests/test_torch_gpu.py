"""The CUDA kernels against their plain versions on the card: polyphase
(rational family, in float32, the quantized modes, float64 and complex),
resample (arbitrary rate and Farrow, channel-major and time-major in
float32, channel-major in float64 and complex; each compiled variant and
the general one, equal bit for bit; the grouped one-channel path and its
producer-fed float32 form equal to the run path bit for bit, chunked ==
whole) and the copy and expand
probes; the runtime on the card: StreamingResampler's block loop
with no synchronizing call, and a profiler trace holding the kernel;
the parallel layer on four gloo ranks sharing the card (halo through the
host) against ``filt`` of the whole signal, and on four NCCL ranks with a
card each (a host of four cards), bit for bit, with no step that waits
for the card; the narrow-read entries of
both kernels (int16, uint8, float16, bfloat16 and int8 samples against
float32 taps, float32 or float16 outputs), each against its plain version
and bit-equal to the float32 entry on the widened values, on every
variant, through the block entry points with one launch and no float32
one; and the integer words (``i32``, ``i64``: equal to the plain version)
and the real signals against complex taps (float32, float64 and the
narrow reads), each bit-equal to the complex-sample entry on the samples
cast to complex, on every variant, through the block entry points with
one launch of their own entry; empty chunks (no launch, the state as it
was) and one tap a phase (T = 1, a (C, 0) history) in every family, and
``FIRFilter``'s history carried in place on the card (one ``data_ptr``).

Marked ``gpu``: it skips without a CUDA device. It imports no JAX, so it
runs on a machine with the card alone:

    python -m pytest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: max|dy| <= 1e-5 * max|y| (the same float32 products, summed in
another order; bf16 products are exact in float32; complex64 the same);
1e-12 * max|y| for float64 and complex128; int8 equal (exact integer
sums) and so are the integer words; narrow stores within one ulp of the
store type; counts and states exact; the probes, the narrow reads against
the float32 entry and the real-sample entries against the complex-sample
entry bit for bit (``torch.equal``: a zero's sign aside).
"""

import itertools
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
from multirate_tpu_torch.ops.dtypes import NARROW
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
    entry = "f32_tm" if time_major else "f32"
    count = rs.launches[entry]
    yk, ck, sk = step(p, st, xs, path="kernel")
    yp, cp, sp = step(p, st, xs, path="windows")
    torch.cuda.synchronize()
    assert rs.launches[entry] == count + 1
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
    before = (rs.launches[entry], rs.launches["f32_tm"])
    yk, ck, sk = step(p, st, xs, path="kernel")
    yp, cp, sp = step(p, st, xs, path="windows")
    torch.cuda.synchronize()
    assert (rs.launches[entry], rs.launches["f32_tm"]) == (before[0] + 1,
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
    if dtype in (torch.int32, torch.int64):  # words over their whole range
        info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
        return torch.from_numpy(rng.integers(info.min, info.max, shape,
                                             dtype=info.dtype,
                                             endpoint=True))
    if dtype == torch.int8:
        return torch.from_numpy(np.clip(rng.standard_normal(shape) * 30,
                                        -127, 127).astype(np.int8))
    if dtype == torch.int16:  # PCM whose sums stay in float16's range
        return torch.from_numpy((rng.standard_normal(shape) * 100).astype(
            np.int16))
    if dtype == torch.uint8:  # offset-binary I/Q
        return torch.from_numpy(np.clip(128 + 40 * rng.standard_normal(
            shape), 0, 255).astype(np.uint8))
    return _wide(rng, shape, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "general", "reg.tma"],
                         ids=["planned", "general", "reg.tma"])
@pytest.mark.parametrize("T,L,M", VARIANT_GEOMETRIES)
@pytest.mark.parametrize("entry", sorted(set(pp.ENTRIES.values())))
def test_polyphase_variants_match_plain_on_gpu(entry, T, L, M, variant):
    # reg.tma, named, runs with no tile threshold where it can (float32 at
    # 147//160 on one channel: the two channels' rows of 80,007 samples
    # are not all 16-byte aligned), each output reg's bits; elsewhere the
    # wrapper refuses it
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
        aligned = pp.rows_aligned(x[:C])
        for n in (n_all, 1, 33, min(tile + 1, n_all)):
            args = (x[:C], hist[:C], bank, L, M, phi0, d0, n)
            try:
                p = pp.plan(T, L, M, n, x_dt, b_dt, C, variant,
                            aligned=aligned)
            except ValueError:
                assert variant == "reg.tma"
                with pytest.raises(ValueError, match="reg.tma"):
                    pp.polyphase(*args, out_dtype=o_dt, variant=variant)
                continue
            key = f"{entry}/{p.variant}"
            before = pp.launches_by_variant[key]
            y = pp.polyphase(*args, out_dtype=o_dt, variant=variant)
            yp = pp.polyphase_plain(*args, out_dtype=o_dt)
            torch.cuda.synchronize()
            assert pp.launches_by_variant[key] == before + 1
            assert y.dtype == yp.dtype and y.shape == yp.shape
            if o_dt in (torch.int32, torch.int64):
                assert torch.equal(y, yp)
            elif o_dt in (torch.bfloat16, torch.float16):
                assert ulps_apart(y, yp, o_dt,
                                  TOL * float(yp.abs().max())) <= 1
            else:
                assert rel_max_err(y, yp) <= _tol(o_dt)
            if p.variant == "reg.tma":
                assert torch.equal(y, pp.polyphase(*args, out_dtype=o_dt,
                                                   variant="reg"))


@pytest.mark.gpu
@pytest.mark.parametrize("C,cuts", [
    # one channel of 1,000,003 samples in chunks of 300,004, 400,004 and
    # 299,995 (each starts at a 16-byte boundary: no row of a multiple of 4)
    (1, (0, 300_004, 700_008, 1_000_003)),
    # eight channels, rows whole 16-byte words
    (8, (0, 120_000, 200_004, 333_336))])
def test_reg_tma_chunked_equals_whole_and_reg_on_gpu(C, cuts, monkeypatch):
    # every aligned launch through reg.tma (no tile threshold), entered
    # mid-stream so that each chunk's first tile reaches into a real
    # history and its last tile is ragged: chunked == whole bit for bit,
    # and both equal reg's outputs and the plain version's
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(26)
    h = (mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    p = mt.make_kernel(h, ratio=Fraction(147, 160), device="cuda")
    x = _wide(rng, (C, cuts[-1]), torch.float32).cuda()
    st = mt.init_state(p, (C,))
    _, _, st = mt.filt_block(p, st, _wide(rng, (C, 777), torch.float32)
                             .cuda(), path="windows")
    monkeypatch.setattr(pp, "TMA_MIN_TILES", 1)
    before = pp.launches_by_variant["f32/reg.tma"]
    yw, _, sw = mt.filt_block(p, st, x, path="kernel")
    parts, s = [], st
    for a, b in zip(cuts, cuts[1:]):
        yc, _, s = mt.filt_block(p, s, x[:, a:b], path="kernel")
        parts.append(yc)
    torch.cuda.synchronize()
    assert pp.launches_by_variant["f32/reg.tma"] == before + len(cuts)
    assert torch.equal(torch.cat(parts, dim=-1), yw)
    assert (s.phase, s.deficit) == (sw.phase, sw.deficit)
    monkeypatch.setattr(pp, "TMA_MIN_TILES", 1 << 62)
    before = pp.launches_by_variant["f32/reg"]
    yr, _, _ = mt.filt_block(p, st, x, path="kernel")
    torch.cuda.synchronize()
    assert pp.launches_by_variant["f32/reg"] == before + 1
    assert torch.equal(yr, yw)
    yp, _, _ = mt.filt_block(p, st, x, path="windows")
    assert rel_max_err(yw, yp) <= TOL


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
        key = f"{entry}{'_tm' if tm else ''}/{variant or kind}"
        before = rs.launches_by_variant[key]
        got[variant] = kern(*args, variant=variant)
        torch.cuda.synchronize()
        assert rs.launches_by_variant[key] == before + 1
        assert got[variant].dtype == want.dtype == xt
        assert got[variant].shape == want.shape
        assert rel_max_err(got[variant], want) <= _tol(xt)
    assert torch.equal(got[None], got["general"])


# the grouped one-channel path (``t10p2.grouped``, ``t10p5.grouped``) and
# its producer-fed form for float32 samples (``t10p2.grouped.tma``,
# ``t10p5.grouped.tma``): forced through ``variant=`` against the run path,
# bit for bit, at the harness rate (243 outputs keep a phase) and at 0.9173
# (no stride keeps one: a thread's phase changes at every output), float32
# and int16 reads (int16 has no grouped.tma form)
GROUPED_KINDS = {"t10p2": None, "t10p5": 4}


def _grouped_args(kind, x_dt, rate, xlen, offset=0, seed=24):
    """A one-channel call entered mid-stream (phase 0.37, after 777
    samples), so that its first tile reads a real history; x starts
    ``offset`` samples into its allocation (``offset`` % 4 floats past a
    16-byte boundary)."""
    rng = np.random.default_rng(seed)
    p = mt.make_kernel(rng.standard_normal(320).astype(np.float32),
                       rate=rate, nphi=32, polyorder=GROUPED_KINDS[kind],
                       device="cuda")
    x = _wide(rng, (1, xlen + offset), torch.float32)
    x = (x * 3000).to(x_dt) if x_dt == torch.int16 else x
    x = x.cuda()[:, offset:]
    st = mt.setphase(p, mt.init_state(p, (1,), x_dt), 0.37)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    n, _, _ = mt.ops.indexing.host_carry(p, st.phase, st.deficit,
                                         x.shape[-1])
    return x, st.history.contiguous(), p, st.phase, st.deficit, n


def _launched_once(args, variant):
    """y of one launch of ``variant``, checked to be the only launch."""
    entry = rs.ENTRIES[args[0].dtype, torch.float32, torch.float32]
    before = dict(rs.launches_by_variant)
    y = rs.resample(*args, variant=variant)
    torch.cuda.synchronize()
    after = dict(rs.launches_by_variant)
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {f"{entry}/{variant}": 1}
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [1 / 2.123456789, 0.9173],
                         ids=["refrate", "0.9173"])
@pytest.mark.parametrize("x_dt", [torch.float32, torch.int16],
                         ids=["f32", "s16"])
@pytest.mark.parametrize("kind", list(GROUPED_KINDS))
def test_grouped_path_equals_run_path_on_gpu(kind, x_dt, rate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _grouped_args(kind, x_dt, rate, 700_001)
    fed = [rs.GROUPED[kind]]
    if x_dt == torch.float32:
        fed.append(rs.GROUPED_TMA[kind])
    else:
        with pytest.raises(ValueError, match="grouped.tma"):
            rs.resample(*args, variant=rs.GROUPED_TMA[kind])
    want = _launched_once(args, kind)
    for variant in fed:
        assert torch.equal(_launched_once(args, variant), want)
    assert rel_max_err(want, rs.resample_plain(*args)) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (samples, x's offset in floats, outputs mod 4): outputs not a
    # multiple of the tile (972 outputs) nor of 4 (the last tile's outputs
    # past a 16-byte word stored by hand), x off a 16-byte boundary by 1-3
    # floats (the producer's first words by hand), and a call of fewer
    # outputs than a tile (a grid of one block, whose only tile reads the
    # history)
    (700_001, 0, 0), (700_003, 0, 1), (700_006, 0, 2), (700_008, 1, 3),
    (700_010, 2, 0), (700_013, 3, 2), (1_500, 0, 3), (1_500, 3, 3)])
@pytest.mark.parametrize("kind", list(GROUPED_KINDS))
def test_grouped_tma_edges_equal_run_path_on_gpu(kind, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xlen, offset, n_mod_4 = case
    args = _grouped_args(kind, torch.float32, 1 / 2.123456789, xlen, offset,
                         seed=27)
    n = args[-1]
    tma = rs.GROUPED_TMA[kind]
    plan = rs.plan(10, args[2].table.shape[0], 32, args[2].delta_fx, n, 1,
                   torch.float32, torch.float32, False, tma)
    assert args[0].data_ptr() % 16 == 4 * offset and n % 4 == n_mod_4
    assert n % plan.tile and (plan.grid == 1) == (n < plan.tile)
    want = _launched_once(args, kind)
    assert torch.equal(_launched_once(args, tma), want)
    assert torch.equal(_launched_once(args, rs.GROUPED[kind]), want)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dt", [torch.float32, torch.int16],
                         ids=["f32", "s16"])
@pytest.mark.parametrize("kind", list(GROUPED_KINDS))
def test_grouped_path_chunked_equals_whole_on_gpu(kind, x_dt):
    # chunks large enough that each plans a grouped path (float32: its
    # grouped.tma form; int16: grouped), cut inside tiles and off 16-byte
    # boundaries, through filt_block's kernel path: chunked == whole bit
    # for bit, one grouped launch a call
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(25)
    h = (mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=5.65326) * 32
         ).astype(np.float32)
    p = mt.make_kernel(h, rate=1 / 2.123456789, nphi=32,
                       polyorder=GROUPED_KINDS[kind], device="cuda")
    x = _wide(rng, (1, 9_000_017), torch.float32)
    x = ((x * 3000).to(x_dt) if x_dt == torch.int16 else x).cuda()
    st = mt.init_state(p, (1,), x_dt)
    entry = rs.ENTRIES[x_dt, torch.float32, torch.float32]
    fed = rs.GROUPED_TMA if x_dt == torch.float32 else rs.GROUPED
    key = f"{entry}/{fed[kind]}"
    before = rs.launches_by_variant[key]
    yw, cw, sw = mt.filt_block(p, st, x, path="kernel")
    parts, s = [], st
    for a, b in ((0, 3_000_001), (3_000_001, 5_999_999),
                 (5_999_999, 9_000_017)):
        yc, _, s = mt.filt_block(p, s, x[:, a:b], path="kernel")
        parts.append(yc)
    torch.cuda.synchronize()
    assert rs.launches_by_variant[key] == before + 4
    assert torch.equal(torch.cat(parts, dim=-1), yw)
    assert (s.phase, s.deficit) == (sw.phase, sw.deficit)
    assert torch.equal(s.history, sw.history)


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


@pytest.fixture(scope="module")
def kernels_built():
    """Both kernel libraries built and loaded before this module's first
    profiler session: a library built in a process after a profiler
    session there has no kernel events in that process's later traces
    (seen with torch 2.11 on the H100; one built before, or only loaded
    after, records them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multirate_tpu_torch.ops.cuda import build, polyphase, resample

    build.load("polyphase", polyphase.SIGNATURES)
    build.load("resample", resample.SIGNATURES)


@pytest.mark.gpu
def test_trace_holds_the_polyphase_kernel_on_gpu(tmp_path, kernels_built):
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



LAUNCH_APIS = ("cuda_runtime", "cuda_driver")


@pytest.mark.gpu
@pytest.mark.parametrize("spec,kernel", [(Fraction(147, 160), "polyphase"),
                                         (1 / 2.123456789, "resample")],
                         ids=["polyphase", "resample"])
def test_launch_spans_hold_their_kernel_launches_on_gpu(tmp_path, spec,
                                                        kernel,
                                                        kernels_built):
    """Each ``mr.kernel.launch`` span lies in its ``mr.api.filt`` span,
    and each kernel's launch call (by correlation id) in a
    ``mr.kernel.launch`` event of the trace, on the profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multirate_tpu_torch.utils import profiling

    h = np.random.default_rng(14).standard_normal(320).astype(np.float32)
    f = mt.FIRFilter(h, spec, device="cuda")
    x = torch.randn(4, 1 << 16, device="cuda")
    f.filt(x)  # build and load outside the trace
    with mt.utils.trace(str(tmp_path)):
        for _ in range(3):
            f.filt(x)
        torch.cuda.synchronize()
    spans = profiling.spans()
    filts = {s[1]: s for s in spans if s[0] == "mr.api.filt"}
    launch = [s for s in spans if s[0] == "mr.kernel.launch"]
    assert len(filts) == len(launch) == 3
    for s in launch:
        parent = filts[s[2]]
        assert s[3] == parent[1] == parent[3]
        assert parent[4] <= s[4] <= s[5] <= parent[5]
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        events = json.load(fh)["traceEvents"]
    assert not [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("mr.")]
    boxes = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "cpu_op"
             and e.get("name") == "mr.kernel.launch"]
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel" and kernel in e.get("name", "")}
    calls = [e for e in events if e.get("cat") in LAUNCH_APIS
             and e.get("args", {}).get("correlation") in kernels]
    assert len(boxes) == len(kernels) == len(calls) == 3, (
        len(boxes), len(kernels), len(calls),
        sorted({e["name"][:60] for e in events if e.get("cat") == "kernel"}))
    for e in calls:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in boxes), e

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
def test_nccl_sharded_stream_equals_filt_on_four_cards():
    """The 64-channel Farrow stream at 0.9173 split by time over a (1, 4)
    mesh of NCCL ranks, one card each, its state carried over three
    super-blocks: each rank's outputs are its slice of ``FIRFilter.filt``
    on the whole super-blocks, bit for bit, the counts and the carried
    state exact, and no step waits for the card (each runs under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from multirate_tpu_torch.parallel.multihost import spawn_world
    from multirate_tpu_torch.utils.testing import sharded_stream

    calls, N = 3, 4 * 65_536
    h = (mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=5.65326)
         * 32).astype(np.float32)
    x = np.random.default_rng(18).standard_normal(
        (64, calls * N)).astype(np.float32)
    kw = {"rate": 0.9173, "nphi": 32, "polyorder": 4}
    f = mt.FIRFilter(h, 0.9173, nphi=32, polyorder=4, device="cuda")
    xd = torch.from_numpy(x).cuda()
    whole = [f.filt(xd[:, c * N:(c + 1) * N]).cpu() for c in range(calls)]
    ranks = spawn_world(sharded_stream, 4, args=(h, x, kw, calls),
                        backend="nccl", timeout_s=300)
    for c, want in enumerate(whole):
        counts = ranks[0]["counts"][c]
        assert sum(counts) == want.shape[-1]
        edges = np.cumsum([0] + counts)
        for k, r in enumerate(ranks):
            assert r["counts"][c] == counts
            got = torch.from_numpy(r["y"][c])
            part = want[:, edges[k]:edges[k + 1]]
            assert torch.equal(got, part), (
                c, k, float((got - part).abs().max()))
    for r in ranks:
        hist, phase, deficit = r["state"]
        assert (phase, deficit) == (f.state.phase, f.state.deficit)
        assert np.array_equal(hist, f.state.history.cpu().numpy())
        assert [s[0] for s in r["spans"]].count("mr.parallel.step") == 2


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 64])
@pytest.mark.parametrize("rate", [1 / 2.123456789, 0.4709, 0.9173])
@pytest.mark.parametrize("polyorder", [None, 4], ids=["arbitrary", "farrow"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_widened_rate_matches_plain_on_gpu(dtype, polyorder, rate, channels):
    """bf16 and int8 signals at a rate run their narrow-read entry in one
    launch, no float32 one: counts and states exact, outputs within
    1e-5 * max|y| of the plain version on the same widened values."""
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
        entry = NARROW[dtype]
        before = (rs.launches[entry], rs.launches["f32"])
        yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
        yp, cp, sp = mt.filt_block(p, st, x, path="windows")
        torch.cuda.synchronize()
        assert (rs.launches[entry], rs.launches["f32"]) == (before[0] + 1,
                                                           before[1])
        assert yk.dtype == yp.dtype == torch.float32
        assert ck == cp == yk.shape[-1]
        assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
        assert sk.history.dtype == dtype and torch.equal(sk.history,
                                                         sp.history)
        assert rel_max_err(yk, yp) <= TOL


# the narrow-read entries: each bit-equal to the float32 entry on the
# widened values, on every variant (xlen 80,007 and 20,011: the second
# channel's rows are not 16-byte aligned, so they stage sample by sample)
NARROW_PP = [n for k, n in pp.ENTRIES.items() if k[0] in NARROW
             and k[1] == torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "general"], ids=["planned",
                                                            "general"])
@pytest.mark.parametrize("T,L,M", VARIANT_GEOMETRIES)
@pytest.mark.parametrize("entry", NARROW_PP)
def test_narrow_polyphase_equals_float32_entry_on_gpu(entry, T, L, M,
                                                      variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x_dt, b_dt, o_dt = {v: k for k, v in pp.ENTRIES.items()}[entry]
    rng = np.random.default_rng(15)
    x = _signal(rng, (2, 80_007), x_dt).cuda()
    hist = _signal(rng, (2, T - 1), x_dt).cuda()
    bank = _signal(rng, (T, L), b_dt).cuda()
    for C, (phi0, d0) in ((1, (1, 1)), (2, (L // 2 + 1, 3))):
        n = ((80_007 - d0) * L - (phi0 - 1)) // M + 1
        args = (x[:C], hist[:C], bank, L, M, phi0, d0, n)
        y = pp.polyphase(*args, out_dtype=o_dt, variant=variant)
        wide = pp.polyphase(x[:C].float(), hist[:C].float(), *args[2:],
                            out_dtype=o_dt, variant=variant)
        torch.cuda.synchronize()
        assert y.dtype == o_dt and torch.equal(y, wide)


NARROW_RS = [(k, tm) for tm, table in ((False, rs.ENTRIES),
                                       (True, rs.TM_ENTRIES))
             for k in table if k[0] in NARROW and k[1] == torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("C,xlen", [(1, 200_003), (3, 20_011), (64, 20_011)])
@pytest.mark.parametrize("kind", list(RESAMPLE_KINDS))
@pytest.mark.parametrize("types,time_major", NARROW_RS,
                         ids=[f"{rs.ENTRIES[k]}{'_tm' if tm else ''}"
                              for k, tm in NARROW_RS])
def test_narrow_resample_equals_float32_entry_on_gpu(types, time_major,
                                                     kind, C, xlen):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x_dt, _, o_dt = types
    T, po = RESAMPLE_KINDS[kind]
    rng = np.random.default_rng(16)
    h = _wide(rng, T * 32, torch.float32)
    p = mt.make_kernel(h, rate=1 / 2.123456789, nphi=32, polyorder=po,
                       device="cuda")
    x = _signal(rng, (C, xlen), x_dt).cuda()
    st = mt.setphase(p, mt.init_state(p, (C,), x_dt), 0.37)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    n, _, _ = mt.ops.indexing.host_carry(p, st.phase, st.deficit, xlen)
    xs = x.t().contiguous() if time_major else x
    hist = st.history.contiguous()
    kern = rs.resample_tm if time_major else rs.resample
    plain = rs.resample_tm_plain if time_major else rs.resample_plain
    want = plain(xs, hist, p, st.phase, st.deficit, n, o_dt)
    for variant in (None, "general"):
        y = kern(xs, hist, p, st.phase, st.deficit, n, variant=variant,
                 out_dtype=o_dt)
        wide = kern(xs.float(), hist.float(), p, st.phase, st.deficit, n,
                    variant=variant).to(o_dt)
        torch.cuda.synchronize()
        assert y.dtype == o_dt and torch.equal(y, wide)
        if o_dt == torch.float16:
            assert ulps_apart(y, want, o_dt,
                              TOL * float(want.float().abs().max())) <= 1
        else:
            assert rel_max_err(y, want) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("taps", [torch.float32, torch.float16])
@pytest.mark.parametrize("spec", [Fraction(147, 160), 1 / 2.123456789],
                         ids=["rational", "arbitrary"])
@pytest.mark.parametrize("dtype", list(NARROW))
def test_narrow_block_runs_one_narrow_launch_on_gpu(dtype, spec, taps):
    # the block entry point reads the narrow samples in the kernel: one
    # launch of the narrow-read entry, none of a float32 one, no cast
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(17)
    h = (mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
         if isinstance(spec, Fraction) else
         mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32)
    kw = ({"ratio": spec} if isinstance(spec, Fraction)
          else {"rate": spec, "nphi": 32})
    p = mt.make_kernel(torch.from_numpy(h).to(taps), device="cuda", **kw)
    x = _signal(rng, (2, 40_011), dtype).cuda()
    st = mt.init_state(p, (2,), dtype)
    mod = pp if isinstance(spec, Fraction) else rs
    before = dict(mod.launches)
    yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in mod.launches.items()
                if v != before[k]}
    yp, cp, sp = mt.filt_block(p, st, x, path="windows")
    out = mt.ops.dtypes.out_dtype(p.tap_type, dtype)
    types = {v: k for k, v in mod.ENTRIES.items()}
    (name, n), = launched.items()
    assert n == 1 and types[name] == (dtype, torch.float32, out)
    assert yk.dtype == yp.dtype == out and ck == cp
    assert sk.history.dtype == dtype and torch.equal(sk.history, sp.history)
    if out == torch.float16:
        assert ulps_apart(yk, yp, out, TOL * float(yp.float().abs().max())) \
            <= 1
    else:
        assert rel_max_err(yk, yp) <= TOL


# the real-sample entries against complex taps: each bit-equal to the
# complex-sample entry on the samples cast to complex, on the same variant
PAIRS_PP = [n for k, n in pp.ENTRIES.items()
            if k[1].is_complex and not k[0].is_complex]
PAIRS_RS = [k for k in rs.ENTRIES if k[1].is_complex and not k[0].is_complex]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "general"], ids=["planned",
                                                            "general"])
@pytest.mark.parametrize("T,L,M", VARIANT_GEOMETRIES)
@pytest.mark.parametrize("entry", PAIRS_PP)
def test_real_sample_polyphase_equals_complex_entry_on_gpu(entry, T, L, M,
                                                           variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x_dt, b_dt, o_dt = {v: k for k, v in pp.ENTRIES.items()}[entry]
    rng = np.random.default_rng(18)
    x = _signal(rng, (2, 80_007), x_dt).cuda()
    hist = _signal(rng, (2, T - 1), x_dt).cuda()
    bank = _signal(rng, (T, L), b_dt).cuda()
    for C, (phi0, d0) in ((1, (1, 1)), (2, (L // 2 + 1, 3))):
        n = ((80_007 - d0) * L - (phi0 - 1)) // M + 1
        args = (x[:C], hist[:C], bank, L, M, phi0, d0, n)
        p = pp.plan(T, L, M, n, x_dt, b_dt, C, variant)
        y = pp.polyphase(*args, variant=variant)
        wide = pp.polyphase(x[:C].to(b_dt), hist[:C].to(b_dt), *args[2:],
                            variant=p.variant)
        torch.cuda.synchronize()
        assert y.dtype == o_dt and torch.equal(y, wide)


@pytest.mark.gpu
@pytest.mark.parametrize("C,xlen", [(1, 200_003), (3, 20_011), (64, 20_011)])
@pytest.mark.parametrize("kind", list(RESAMPLE_KINDS))
@pytest.mark.parametrize("types", PAIRS_RS, ids=[rs.ENTRIES[k]
                                                 for k in PAIRS_RS])
def test_real_sample_resample_equals_complex_entry_on_gpu(types, kind, C,
                                                          xlen):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x_dt, t_dt, o_dt = types
    T, po = RESAMPLE_KINDS[kind]
    rng = np.random.default_rng(19)
    p = mt.make_kernel(_wide(rng, T * 32, t_dt), rate=1 / 2.123456789,
                       nphi=32, polyorder=po, device="cuda")
    x = _signal(rng, (C, xlen), x_dt).cuda()
    st = mt.setphase(p, mt.init_state(p, (C,), x_dt), 0.37)
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    n, _, _ = mt.ops.indexing.host_carry(p, st.phase, st.deficit, xlen)
    hist = st.history.contiguous()
    want = rs.resample_plain(x, hist, p, st.phase, st.deficit, n)
    got = {}
    for variant in (None, "general"):
        got[variant] = rs.resample(x, hist, p, st.phase, st.deficit, n,
                                   variant=variant)
        wide = rs.resample(x.to(t_dt), hist.to(t_dt), p, st.phase,
                           st.deficit, n, variant=variant)
        torch.cuda.synchronize()
        assert got[variant].dtype == o_dt
        assert torch.equal(got[variant], wide)
        assert rel_max_err(got[variant], want) <= _tol(o_dt)
    assert torch.equal(got[None], got["general"])


@pytest.mark.gpu
@pytest.mark.parametrize("pair", [
    (torch.int16, torch.int32, "i32"), (torch.int32, torch.int64, "i64"),
    (torch.uint32, torch.uint32, "i32"), (torch.complex64, torch.float32,
                                          "f32c"),
    (torch.complex64, torch.int16, "s16c"),
    (torch.complex128, torch.float64, "f64c")], ids=lambda p: str(p))
@pytest.mark.parametrize("spec", [Fraction(147, 160), Fraction(1, 4)],
                         ids=["rational", "decimator"])
def test_pair_block_runs_one_launch_of_its_entry_on_gpu(spec, pair):
    # an integer pair or a real signal against complex taps is one launch
    # of its own entry, with no cast to a float or complex signal
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tap, sig, entry = pair
    rng = np.random.default_rng(20)
    h = mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
    if tap.is_complex:
        h = h * np.exp(0.5j * np.pi * np.arange(len(h)))
        x = _signal(rng, (2, 40_011), sig).cuda()
    else:
        h = np.clip(np.round(h * 2 ** 15), 0 if tap == torch.uint32
                    else -2 ** 15, 2 ** 15 - 1)
        x = _signal(rng, (2, 40_011), torch.int64 if sig.itemsize == 8
                    else torch.int32).to(sig).cuda()
    p = mt.make_kernel(torch.from_numpy(h).to(tap), ratio=spec,
                       device="cuda")
    st = mt.init_state(p, (2,), sig)
    before = dict(pp.launches)
    yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in pp.launches.items()
                if v != before[k]}
    yp, cp, sp = mt.filt_block(p, st, x, path="windows")
    assert launched == {entry: 1}
    assert yk.dtype == yp.dtype and ck == cp
    assert sk.history.dtype == sig and torch.equal(sk.history, sp.history)
    if yk.dtype.is_complex:
        assert rel_max_err(yk, yp) <= _tol(yk.dtype)
    else:
        assert torch.equal(yk, yp)


# one tap a phase (T = 1) in each family, the geometries of the smoke's
# phase 3j: (make_kernel keywords, taps)
ONE_TAP = {"1//1": ({"ratio": Fraction(1, 1)}, 1),
           "4//1": ({"ratio": Fraction(4, 1)}, 4),
           "1//4": ({"ratio": Fraction(1, 4)}, 1),
           "3//2": ({"ratio": Fraction(3, 2)}, 3),
           "arbitrary": ({"rate": 0.77, "nphi": 32}, 32),
           "farrow": ({"rate": 1.3, "nphi": 32, "polyorder": 4}, 32)}


def _launch_counts():
    return (dict(pp.launches), dict(pp.launches_by_variant),
            dict(rs.launches), dict(rs.launches_by_variant))


@pytest.mark.gpu
@pytest.mark.parametrize("one_tap", [True, False], ids=["T1", "T24"])
@pytest.mark.parametrize("family", list(ONE_TAP))
def test_empty_chunk_launches_nothing_on_gpu(family, one_tap):
    # an empty chunk mid-stream: no launch of either kernel, the state
    # exactly as it was, an empty output of JAX's type
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw, n = ONE_TAP[family]
    rng = np.random.default_rng(21)
    h = rng.standard_normal(n * (1 if one_tap else 24)).astype(np.float32)
    p = mt.make_kernel(h, device="cuda", **kw)
    x = torch.from_numpy(rng.standard_normal((2, 5000)).astype(
        np.float32)).cuda()
    _, _, st = mt.filt_block(p, mt.init_state(p, (2,)), x, path="kernel")
    torch.cuda.synchronize()
    before = _launch_counts()
    for path in ("kernel", "auto"):
        y, c, st2 = mt.filt_block(p, st, x[:, :0], path=path)
        torch.cuda.synchronize()
        assert _launch_counts() == before
        assert c == 0 and y.shape == (2, 0) and y.dtype == torch.float32
        assert y.device == x.device
        assert (st2.phase, st2.deficit) == (st.phase, st.deficit)
        assert torch.equal(st2.history, st.history)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "general"], ids=["planned",
                                                            "general"])
@pytest.mark.parametrize("family", list(ONE_TAP))
def test_one_tap_a_phase_matches_plain_on_gpu(family, variant):
    # T = 1 (a (C, 0) history) through each kernel's planned and general
    # variant, against the plain version, and chunked == whole
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw, n = ONE_TAP[family]
    rng = np.random.default_rng(22)
    p = mt.make_kernel(rng.standard_normal(n).astype(np.float32),
                       device="cuda", **kw)
    assert p.taps_per_phi == 1 and p.h_min == 0
    x = torch.from_numpy(rng.standard_normal((2, 30_011)).astype(
        np.float32)).cuda()
    st = mt.init_state(p, (2,))
    if family not in ("1//1", "1//4"):
        st = mt.setphase(p, st, 0.37)
    n_out, _, _ = mt.ops.indexing.host_carry(p, st.phase, st.deficit,
                                             x.shape[-1])
    hist = st.history
    assert hist.shape == (2, 0)
    if family in ("arbitrary", "farrow"):
        args = (x, hist, p, st.phase, st.deficit, n_out)
        y = rs.resample(*args, variant=variant)
        yp = rs.resample_plain(*args)
    else:
        from multirate_tpu_torch.ops import compute

        # (L, M, phi0, d0) as the block step enters the family
        geometry = compute._IMPL[type(p)](p, st)[1]
        args = (x, hist, p.bank, *geometry, n_out)
        y = pp.polyphase(*args, variant=variant)
        yp = pp.polyphase_plain(*args)
    torch.cuda.synchronize()
    assert y.shape == yp.shape == (2, n_out)
    assert rel_max_err(y, yp) <= TOL
    # chunked == whole through the block entry points
    yw, cw, sw = mt.filt_block(p, st, x, path="kernel")
    parts, s = [], st
    for a, b in ((0, 0), (0, 1), (1, 777), (777, 777), (777, 30_011)):
        yc, _, s = mt.filt_block(p, s, x[:, a:b], path="kernel")
        parts.append(yc)
    assert torch.equal(torch.cat(parts, dim=-1), yw) and cw == n_out
    assert (s.phase, s.deficit) == (sw.phase, sw.deficit)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [Fraction(147, 160), 0.77],
                         ids=["rational", "arbitrary"])
def test_firfilter_history_stays_in_place_on_gpu(spec):
    # FIRFilter on the card carries its history in place (one data_ptr),
    # bit-equal to a filt_block loop over the same chunks, chunks shorter
    # than h_min and empty ones included
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(23)
    h = (mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, 60_000)).astype(
        np.float32)).cuda()
    f = mt.FIRFilter(h, spec, device="cuda")
    p = f.kernel
    st = mt.init_state(p, (2,))
    sizes = itertools.cycle([5, 0, 3, 1000, 0, 17, 2, 4096, 1])
    at, ptr = 0, None
    while at < x.shape[-1]:
        xb = x[:, at:at + next(sizes)]
        at += xb.shape[-1]
        y = f.filt(xb)
        yw, _, st = mt.filt_block(p, st, xb)
        ptr = ptr or f.history.data_ptr()
        assert f.history.data_ptr() == ptr
        assert torch.equal(y, yw)
    torch.cuda.synchronize()
    assert torch.equal(f.history, st.history)
    assert (f.state.phase, f.state.deficit) == (st.phase, st.deficit)
