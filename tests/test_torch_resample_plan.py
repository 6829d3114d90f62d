"""The resample kernel's launch planner and index walk on the CPU: which
variant each main-path row takes, the grid it gets, and the kernel's
division-free walk against the accumulator algebra.

``ops/cuda/resample.plan`` asks the planner library (``csrc/mr_plan.cpp``,
built with g++) on the call's shape; the CUDA launcher
(``csrc/resample.cu``) takes its (variant, tile, channels, run, grid) as
given and refuses a plan it cannot run, both with the geometry of
``csrc/geometry.cuh``, so what is checked here is what the card runs.
``walk_positions`` transcribes the kernel's walk (tile bases in exact
integers, then digit additions with carries); it must give exactly the
(window, phase, fraction) of ``indexing.accum_indices`` for every
output. Exact: plans and indices are integers.
"""

import math

import numpy as np
import pytest
import torch

import multirate_tpu_torch as mt
from multirate_tpu_torch.ops import indexing as idx
from multirate_tpu_torch.ops.cuda import resample as rs
from multirate_tpu_torch.ops.params import PHASE_FRAC_BITS, _delta_fx

F32, F64, C64, C128 = (torch.float32, torch.float64, torch.complex64,
                       torch.complex128)
R_REF = 1.0 / 2.123456789
N_HEAD = 8_000_000
N_CH, XLEN_CH = 64, 125_000
COMPILED = {"t10p2", "t10p5", "t73p2"}
NARROW_READS = (torch.int16, torch.bfloat16)


@pytest.fixture(scope="module")
def taps():
    return (mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32
            ).astype(np.float32)


def _params(h, rate, polyorder=None, nphi=32):
    return mt.make_kernel(h, rate=rate, nphi=nphi, polyorder=polyorder,
                          device="cpu")


def _span(tile, nphi, delta_fx, T):
    """Input samples a tile of ``tile`` outputs reads, at most."""
    D = nphi << PHASE_FRAC_BITS
    return (D - 1 + (tile - 1) * delta_fx) // D + T


def _grouped_tma_smem(tile, T, P1, nphi, delta_fx, depth):
    """A grouped.tma block's shared bytes: 8 stages' two mbarriers and
    16-byte headers, the table by phase, ``depth`` ring stages of a span
    after up to 3 samples of alignment (whole 16-byte words), and two
    unpadded output stages."""
    def up16(b):
        return -(-b // 16) * 16

    nb = (_span(tile, nphi, delta_fx, T) + 6) // 4 * 4
    return (8 * 32 + up16(nphi * -(-T * P1 // 4) * 4 * 4) + depth * nb * 4
            + 2 * up16(tile * 4))


def _grouped_smem(tile, T, P1, nphi, delta_fx, xsz):
    """A grouped block's shared bytes: the table by phase (rows of T*(P+1)
    words in whole 16-byte loads), a double buffer of spans as stored
    (xsz bytes a sample, rows in whole 16-byte chunks with room for a
    first sample 15 bytes in) and one widened to float32 for a narrow
    read, and the tile's outputs, a word of padding every 32."""
    def up16(b):
        return -(-b // 16) * 16

    v = 16 // xsz
    rows = -(-(_span(tile, nphi, delta_fx, T) + v - 1) // v) * v
    b = up16(nphi * -(-T * P1 // 4) * 4 * 4) + 2 * up16(rows * xsz)
    if xsz != 4:
        b += up16(rows * 4)
    return b + up16((tile + tile // 32) * 4)


def _plan(p, n_out, C, x_dtype, table_dtype, time_major=False,
          variant=None):
    return rs.plan(p.taps_per_phi, p.table.shape[0], p.nphi, p.delta_fx,
                   n_out, C, x_dtype, table_dtype, time_major, variant)


# bench.py's rows and chip_smoke.py's: (rate, polyorder, channels, samples
# a channel, signal, table, time-major)
MAIN_PATH = {
    "arbitrary_0.4709": (0.4709, None, 1, N_HEAD, F32, F32, False),
    "arbitrary_refrate": (R_REF, None, 1, N_HEAD, F32, F32, False),
    "farrow_refrate": (R_REF, 4, 1, N_HEAD, F32, F32, False),
    "farrow_0.4709": (0.4709, 4, 1, N_HEAD, F32, F32, False),
    "farrow_64ch_batched": (0.9173, 4, N_CH, XLEN_CH, F32, F32, False),
    "farrow_64ch_tmajor": (0.9173, 4, N_CH, XLEN_CH, F32, F32, True),
    "arbitrary_refrate_f64": (R_REF, None, 1, N_HEAD, F64, F64, False),
    "farrow_0.4709_f64": (0.4709, 4, 1, N_HEAD, F64, F64, False),
    "resample_c64": (R_REF, None, 1, N_HEAD, C64, F32, False),
    "resample_c64c": (R_REF, None, 1, N_HEAD, C64, C64, False),
    "resample_c128": (R_REF, None, 1, N_HEAD, C128, F64, False),
    "resample_c128c": (R_REF, None, 1, N_HEAD, C128, C128, False),
}


@pytest.mark.parametrize("row", list(MAIN_PATH))
def test_main_path_rows_take_a_compiled_variant(taps, row):
    rate, po, C, xlen, x_dt, t_dt, tm = MAIN_PATH[row]
    p = _params(taps, rate, po)
    n = mt.outputlength(p, xlen)
    plan = _plan(p, n, C, x_dt, t_dt, tm)
    base = "t10p2" if po is None else "t10p5"
    # one float32 channel at 1/2.123456789 groups its outputs by phase
    # (243 outputs keep a phase), fed by a producer warp (grouped.tma); the
    # rest run (0.4709 has no such stride)
    grouped = C == 1 and x_dt == t_dt == F32 and rate == R_REF
    assert plan.variant == (f"{base}.grouped.tma" if grouped else base)
    assert plan.grid >= 2 * 132
    assert plan.channels == (32 if tm else (8 if C >= 8 else 1))
    assert 0 < plan.smem <= 226 * 1024


def test_resampler_block_takes_t73p2_and_fills_the_card():
    k = mt.models.Resampler(R_REF, device="cpu").kernel
    n = mt.outputlength(k, 1 << 16)
    assert (k.taps_per_phi, k.table.shape[0], k.nphi) == (73, 2, 32)
    for variant in (None, "general"):
        plan = _plan(k, n, 1, F32, F32, variant=variant)
        assert plan.variant == (variant or "t73p2")
        assert plan.grid >= 2 * 132  # 31 blocks in the first design


@pytest.mark.parametrize("dtypes", [(F32, F32), (F64, F64), (C64, F32),
                                    (C64, C64), (C128, F64), (C128, C128)])
@pytest.mark.parametrize("rate,run", [(R_REF, 8), (0.4709, 8), (0.3, 1),
                                      (0.9173, 1), (1.0, 1), (2.5, 1)])
def test_one_channel_rows_run_8_outputs_a_thread_only_near_an_odd_step(
        taps, dtypes, rate, run):
    # at 1/2.123456789 eight outputs step 16.99 samples: lanes 8 outputs
    # apart load window words on 32 banks; the other rates have no run
    # whose step lies within 1/32 of an odd number of samples
    # (float32 rows group by phase unless the run path is named: the run
    # path's runs are what is checked here)
    p = _params(taps, rate)
    n = mt.outputlength(p, N_HEAD)
    plan = _plan(p, n, 1, *dtypes, variant="t10p2")
    assert plan.tile >= 512 and plan.run == run
    assert plan.threads * plan.run <= plan.tile
    # 8 channels a block, time-major blocks and small tiles run 1
    assert _plan(p, n // 8, N_CH, *dtypes).run == 1
    assert _plan(p, 30_000, 1, *dtypes).run == 1


@pytest.mark.parametrize("case", [
    # (T, P+1, nphi, rate): no compiled pair
    (7, 3, 1024, 0.3),
    (10, 3, 32, 0.4709),
    (73, 5, 32, 0.4709),
    (9, 2, 32, 0.4709),
])
def test_other_pairs_take_the_general_variant(case):
    T, P1, nphi, rate = case
    delta = _delta_fx(nphi, rate)
    assert rs.plan(T, P1, nphi, delta, 100_000, 1, F32,
                   F32).variant == "general"


def test_rate_001_and_a_large_table_take_the_general_variant(taps):
    # rate 0.01 at a compiled pair still plans the compiled variant, with a
    # tile shrunk to fit its spans of about 100 samples an output
    p = _params(taps, 0.01)
    plan = _plan(p, 200_000, N_CH, F32, F32)
    assert plan.variant == "t10p2" and plan.smem <= 226 * 1024
    # T = 7, P+1 = 3 at rate 0.01: general
    delta = _delta_fx(32, 0.01)
    assert rs.plan(7, 3, 32, delta, 200_000, 1, F32, F32).variant \
        == "general"
    # a (5, 10, 2048) float32 table (400 KB) and a (5, 10, 256) complex128
    # one (200 KB), over 96 KB: read through L1, general
    big = _params(np.random.default_rng(0).standard_normal(20_480)
                  .astype(np.float32), 0.9, 4, nphi=2048)
    assert big.table.numel() * 4 > 96 * 1024
    assert _plan(big, 20_000, 2, F32, F32).variant == "general"
    delta = _delta_fx(32, R_REF)
    assert rs.plan(10, 5, 256, delta, 50_000, 1, C128, C128).variant \
        == "general"


def test_a_named_variant_that_cannot_run_raises(taps):
    p = _params(taps, R_REF)
    with pytest.raises(ValueError, match="t10p5"):
        _plan(p, 1000, 1, F32, F32, variant="t10p5")
    with pytest.raises(ValueError, match="unknown variant"):
        _plan(p, 1000, 1, F32, F32, variant="fast")
    big = _params(np.random.default_rng(0).standard_normal(20_480)
                  .astype(np.float32), 0.9, 1, nphi=2048)
    with pytest.raises(ValueError, match="t10p2"):
        _plan(big, 1000, 1, F32, F32, variant="t10p2")


def test_launch_counts_cover_every_entry_and_variant():
    assert set(rs.launches_by_variant) == {
        f"{e}/{v}" for e in (*rs.ENTRIES.values(), *rs.TM_ENTRIES.values())
        for v in rs.VARIANTS}
    assert set(rs.COMPILED.values()) == COMPILED <= set(rs.VARIANTS)


@pytest.mark.parametrize("variant", [None, "general", "t10p5.grouped",
                                     "t10p5.grouped.tma"])
@pytest.mark.parametrize("time_major", [False, True])
def test_cpu_wrapper_takes_a_variant_and_runs_the_plain_version(
        taps, variant, time_major):
    # grouped.tma takes one channel only: the three here are refused
    if (time_major and variant == "t10p5.grouped"
            or variant == "t10p5.grouped.tma"):
        with pytest.raises(ValueError, match=variant):
            _plan(_params(taps, 0.4709, 4), 2000, 3, F32, F32, time_major,
                  variant)
        return
    p = _params(taps, 0.4709, 4)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5000, generator=g)
    hist = torch.randn(3, p.h_min, generator=g)
    n = mt.outputlength(p, 5000 - 1)
    before = (dict(rs.launches), dict(rs.launches_by_variant))
    if time_major:
        y = rs.resample_tm(x.t().contiguous(), hist, p, 0, 1, n,
                           variant=variant)
        want = rs.resample_tm_plain(x.t().contiguous(), hist, p, 0, 1, n)
    else:
        y = rs.resample(x, hist, p, 0, 1, n, variant=variant)
        want = rs.resample_plain(x, hist, p, 0, 1, n)
    assert torch.equal(y, want)
    assert (rs.launches, rs.launches_by_variant) == before
    with pytest.raises(ValueError, match="t73p2"):
        rs.resample(x, hist, p, 0, 1, n, variant="t73p2")


def _walk_equals_accum(plan, nphi, delta_fx, u0, d0, n, blocks=None):
    q, phi, fr = rs.walk_positions(plan, nphi, delta_fx, u0, n, blocks)
    inp, phi_ref, frac_ref = idx.accum_indices(nphi, delta_fx, u0, d0, n)
    assert torch.equal(q + d0, inp)
    assert torch.equal(phi, phi_ref)
    assert torch.equal(fr.double() * 2.0 ** -PHASE_FRAC_BITS, frac_ref)
    assert int(fr.max()) < 1 << PHASE_FRAC_BITS and int(phi.max()) < nphi


def _grouped(plan, rows, stride=243, mult=8):
    """A grouped plan of ``rows`` outputs a thread (the walk reads only the
    variant, the tile, the stride and the multiplier)."""
    return plan._replace(variant="t10p5.grouped", tile=stride * rows, run=1,
                         threads=-(-stride // 32) * 32, stride=stride,
                         mult=mult)


WALK_CASES = [
    # (nphi, rate, polyorder, channels, time-major, outputs)
    (32, 0.4709, None, 1, False, 300_000),   # runs of 8 outputs a thread
    (32, R_REF, 4, 1, False, 70_000),
    (32, 0.9173, 4, N_CH, False, 50_000),    # 8 channels a block
    (32, 0.9173, 4, N_CH, True, 50_000),     # time-major: taps a block
    (7, 0.9173, None, 1, False, 120_000),    # nphi not a power of two
    (7, 2.5, 4, 3, True, 20_000),
    (32, 0.01, None, 1, False, 5_000),       # tiles shrunk to their spans
]


@pytest.mark.parametrize("entry", ["fresh", "mid"])
@pytest.mark.parametrize("case,grouped", [
    *((c, False) for c in WALK_CASES),
    # the grouped path: every one-channel case, forced at the planner's
    # stride (or 256 where the rate has none) for a compiled pair (nphi 7
    # has T = 11: 20 outputs a thread, stride 243), and rate 1 (one phase)
    *((c, True) for c in WALK_CASES if c[3] < 8 and not c[4]),
    ((32, 1.0, 4, 1, False, 40_000), True),
], ids=lambda v: str(v) if isinstance(v, bool) else "-".join(map(str, v)))
def test_walk_equals_accum_indices(taps, entry, case, grouped):
    nphi, rate, po, C, tm, n = case
    h = taps if nphi == 32 else np.random.default_rng(1).standard_normal(
        10 * nphi + 3).astype(np.float32)
    p = _params(h, rate, po, nphi)
    # fresh, or mid-stream: after setphase(0.37) and 12,345 samples
    u0, d0 = 0, 1
    if entry == "mid":
        st = mt.setphase(p, mt.init_state(p, (C,)), 0.37)
        _, u0, d0 = idx.host_carry(p, st.phase, st.deficit, 12_345)
    plan = _plan(p, n, C, F32, F32, tm)
    if grouped and nphi == 32:
        plan = _plan(p, n, C, F32, F32, tm, rs.GROUPED[plan.variant])
    elif grouped:
        plan = _grouped(plan, 20)
    assert plan.variant.endswith(".grouped") == grouped
    assert n > 2 * plan.tile  # every tile boundary inside the run
    _walk_equals_accum(plan, nphi, p.delta_fx, u0, d0, n)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("u0", [0, 3 << 40])
def test_walk_past_2_20_outputs_at_nphi_1024(u0, grouped):
    # delta_fx near 2^43.7: u0 + n*delta_fx passes 2^63 near n = 2^19.3,
    # so the tile bases need 128 bits; grouped, at a stride that keeps no
    # phase (every output a phase of its own)
    rng = np.random.default_rng(2)
    p = _params(rng.standard_normal(2048).astype(np.float32), 0.3, 3,
                nphi=1024)
    n = 1_080_000
    assert n > 1 << 20 and u0 + (n - 1) * p.delta_fx > 1 << 63
    plan = _plan(p, n, 1, F32, F32)
    if grouped:
        plan = _grouped(plan, 31, stride=229, mult=100)
    _walk_equals_accum(plan, 1024, p.delta_fx, u0 % (1024 << 32), 1, n)


@pytest.mark.parametrize("run", [1, 2, 4, 8, 16, "grouped-243-8-20",
                                 "grouped-256-1-32", "grouped-255-1-14",
                                 "grouped-200-7-40", "grouped-129-2-1",
                                 "grouped.tma-42", "grouped.tma-3"])
def test_walk_is_exact_for_every_run(taps, run):
    # a plan is a NamedTuple: the walk for each run the kernel takes, and
    # the grouped path's progressions at strides, multipliers and outputs a
    # thread it takes (the last tile partial), and the planner's grouped.tma
    # plan (multiplier 7, 4 outputs a thread a tile) on its 42 blocks (a
    # short tile each) or on 3 (whole tiles, then a short one, each)
    p = _params(taps, R_REF)
    n = 9_000 if isinstance(run, int) else 40_123
    plan = _plan(p, n, 1, F32, F32)
    blocks = None
    if isinstance(run, int):
        plan = plan._replace(tile=2048, run=run, threads=128)
    elif run.startswith("grouped.tma"):
        plan = _plan(p, n, 1, F32, F32, variant="t10p2.grouped.tma")
        assert (plan.stride, plan.mult, plan.tile, plan.grid) == (
            243, 7, 972, 42)
        blocks = int(run.split("-")[1])
    else:
        stride, mult, rows = map(int, run.split("-")[1:])
        plan = _grouped(plan, rows, stride, mult)
    assert n % plan.tile
    _walk_equals_accum(plan, 32, p.delta_fx, 987_654_321, 4, n, blocks)


@pytest.mark.parametrize("rate", [0.3, R_REF, 0.9173, 1.0, 2.5, 17.0])
@pytest.mark.parametrize("dtypes", [(F32, F32), (F64, F64), (C128, C128),
                                    (torch.int16, F32)])
def test_plans_stay_inside_the_kernel_limits(taps, rate, dtypes):
    for C, tm in ((1, False), (2, False), (N_CH, False), (N_CH, True)):
        if tm and dtypes[1] != F32:
            continue
        p = _params(taps, rate, 4)
        grouped = C < 8 and not tm and dtypes[1] == F32
        tma = C == 1 and not tm and dtypes == (F32, F32)
        for n in (1, 33, 10_000, 10_000_000):
            for variant in (None, "general", "t10p5.grouped",
                            "t10p5.grouped.tma"):
                if (variant == "t10p5.grouped" and not grouped
                        or variant == "t10p5.grouped.tma" and not tma):
                    with pytest.raises(ValueError, match="grouped"):
                        _plan(p, n, C, *dtypes, tm, variant)
                    continue
                plan = _plan(p, n, C, *dtypes, tm, variant)
                span = _span(plan.tile, p.nphi, p.delta_fx, p.taps_per_phi)
                if plan.variant.endswith(".grouped.tma"):
                    # the grouped path's, in tiles of whole 16-byte words,
                    # with a producer warp, a ring of 2-8 stages, two
                    # blocks' shared memory an SM unless named
                    assert plan.tile % plan.stride == 0 and plan.tile % 4 == 0
                    assert plan.tile <= 8192 and plan.stride <= 256
                    assert plan.threads == -(-plan.stride // 32) * 32 + 32
                    assert math.gcd(plan.mult, plan.stride) == 1
                    assert plan.run == 1 and plan.channels == 1
                    assert 2 <= plan.depth <= 8
                    assert plan.smem == _grouped_tma_smem(
                        plan.tile, 10, 5, p.nphi, p.delta_fx, plan.depth)
                    assert plan.smem <= (226 if variant else 110) * 1024
                    assert variant or plan.tile >= 8 * plan.stride
                elif plan.variant.endswith(".grouped"):
                    # whole progressions of the stride, its threads in whole
                    # warps, a multiplier prime to it, one channel a block,
                    # two blocks' shared memory an SM
                    assert plan.tile % plan.stride == 0
                    assert plan.tile <= 8192 and plan.stride <= 256
                    assert plan.threads == -(-plan.stride // 32) * 32
                    assert math.gcd(plan.mult, plan.stride) == 1
                    assert plan.run == 1 and plan.channels == 1
                    assert plan.depth == 0
                    assert plan.smem == _grouped_smem(
                        plan.tile, 10, 5, p.nphi, p.delta_fx,
                        dtypes[0].itemsize) <= 110 * 1024
                    assert variant or plan.tile >= 8 * plan.stride
                else:
                    assert plan.stride == plan.mult == plan.depth == 0
                    assert 0 < plan.tile <= (256 if tm else 1024)
                assert 0 < plan.grid <= 65535
                assert plan.grid <= -(-n // plan.tile) * -(-C // plan.channels)
                assert 0 < plan.smem <= 226 * 1024
                assert plan.run in (1, 2, 4, 8, 16)
                assert plan.run == 1 or (plan.channels == 1
                                         and plan.threads * plan.run
                                         <= plan.tile)
                assert plan.threads % 32 == 0 and plan.threads <= (
                    288 if plan.depth else 256)
                # the last window of a tile stays inside int32 offsets
                assert span < 2**31


def test_stream_blocks_and_chunks_take_a_compiled_variant(taps):
    # 65,536-sample blocks (io.StreamingResampler) and 250,000-sample
    # chunks (chip_smoke's FIRFilter runs) at the harness rate
    p = _params(taps, R_REF)
    for xlen in (1 << 16, 250_000):
        n = mt.outputlength(p, xlen)
        assert _plan(p, n, 1, F32, F32).variant == "t10p2"


CAPTURE_N = 67_108_864  # arb_farrow.capture_block: 1 x 2^26 float32 a call


@pytest.mark.parametrize("row", [
    # (polyorder, samples, signal): capture_block's call (t10p5), a large
    # one-channel arbitrary row (t10p2), and narrow reads against them
    (4, CAPTURE_N, F32), (None, N_HEAD, F32), (4, N_HEAD, torch.int16),
    (None, CAPTURE_N, torch.uint8)])
def test_one_channel_float32_tables_take_the_grouped_path(taps, row):
    po, xlen, x_dt = row
    p = _params(taps, R_REF, po)
    n = mt.outputlength(p, xlen)
    plan = _plan(p, n, 1, x_dt, F32)
    base = "t10p2" if po is None else "t10p5"
    # float32 samples take the grouped.tma form, narrow reads the grouped
    # path itself
    tma = x_dt == F32
    assert plan.variant == (rs.GROUPED_TMA if tma else rs.GROUPED)[base]
    # outputs 243 apart step 516.0000087 samples: their phase holds; lanes
    # 8 outputs apart, 16.99 samples (grouped), or 7 apart, 14.86 samples,
    # whose outputs fall on 32 banks unpadded (grouped.tma)
    assert (plan.stride, plan.mult) == (243, 7 if tma else 8)
    assert plan.tile >= 8 * plan.stride and plan.grid >= 2 * 132
    assert (plan.channels, plan.run) == (1, 1)
    assert (plan.threads, plan.depth) == ((288, 2) if tma else (256, 0))
    # two blocks an SM
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    if (po, xlen, x_dt) == (4, CAPTURE_N, F32):  # 16 tiles a block
        assert plan.tile == 243 * 16
    elif tma:  # 8 M samples: 59 outputs a thread would fill the card
        assert plan.tile == 243 * 12
    # the run path, and for float32 the grouped path, are still there by
    # name
    run = _plan(p, n, 1, x_dt, F32, variant=base)
    assert run.variant == base and run.run == 8
    if tma:
        g = _plan(p, n, 1, x_dt, F32, variant=rs.GROUPED[base])
        assert (g.variant, g.threads, g.mult) == (rs.GROUPED[base], 256, 8)


@pytest.mark.parametrize("rate", [R_REF, 1.0, 0.5, 0.4709, 0.9173, 2.5])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("x_dt", [F32, torch.int16, torch.bfloat16, F64,
                                  C64])
def test_grouped_tma_takes_one_float32_channel_where_grouped_would(
        taps, rate, C, x_dt):
    # over call sizes from a few outputs to capture's: the grouped.tma form
    # exactly where the grouped path would take the call (its int16 twin's
    # plan) and the signal is float32 in one channel; a named grouped.tma
    # is refused for anything else
    p = _params(taps, rate, 4)
    t_dt = x_dt if x_dt in (F64, C64) else F32
    for xlen in (1_000, 100_000, 1 << 20, 1 << 21, 1 << 23, CAPTURE_N):
        n = mt.outputlength(p, xlen)
        plan = _plan(p, n, C, x_dt, t_dt)
        twin = _plan(p, n, C, torch.int16, F32)
        tma = C == 1 and x_dt == F32 and twin.variant == "t10p5.grouped"
        assert (plan.variant == "t10p5.grouped.tma") == tma
        if tma:
            assert plan.smem <= 110 * 1024 and plan.tile % 4 == 0
        elif x_dt == F32 or x_dt in NARROW_READS:
            assert plan.variant == twin.variant
    if C > 1 or x_dt != F32:
        with pytest.raises(ValueError, match="grouped.tma"):
            _plan(p, 100_000, C, x_dt, t_dt, variant="t10p5.grouped.tma")


@pytest.mark.parametrize("why", ["sdr_stream", "t73p2", "complex table",
                                 "float64", "time-major", "8 channels",
                                 "general"])
def test_other_calls_keep_the_run_path(taps, why):
    p = _params(taps, R_REF, 4)
    n = mt.outputlength(p, CAPTURE_N)
    if why == "sdr_stream":
        # 65,536-sample blocks: tiles of 64, as before the grouped path
        plan = _plan(p, mt.outputlength(p, 1 << 16), 1, F32, F32)
        assert plan == rs.Plan("t10p5", 64, 1, 1, 483, 64, plan.smem, 0, 0)
        return
    if why == "t73p2":
        k = mt.models.Resampler(R_REF, device="cpu").kernel
        plan = _plan(k, mt.outputlength(k, CAPTURE_N), 1, F32, F32)
        assert plan.variant == "t73p2"
        return
    args = {"complex table": (1, C64, C64), "float64": (1, F64, F64),
            "time-major": (N_CH, F32, F32, True),
            "8 channels": (8, F32, F32), "general": (1, F32, F32)}[why]
    if why == "general":
        assert _plan(p, n, *args, variant="general").variant == "general"
        return
    assert _plan(p, n, *args).variant == "t10p5"
    with pytest.raises(ValueError, match="t10p5.grouped"):
        _plan(p, n, *args, variant="t10p5.grouped")
