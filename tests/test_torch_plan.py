"""The polyphase kernel's launch planner on the CPU: which variant each
main-path row takes, the grid it gets and the offsets its tiles reach.

``ops/cuda/polyphase.plan`` asks the planner library (``csrc/mr_plan.cpp``,
built with g++) on the call's shape; the CUDA launcher
(``csrc/polyphase.cu``) takes its (variant, tile, grid) as given and
refuses a plan it cannot run, both with the geometry of
``csrc/geometry.cuh``, so what is checked here is what the card runs.
The helpers below transcribe that geometry, to hold the plans to it.
Exact: plans are integers.
"""

import math
from fractions import Fraction

import pytest
import torch

import multirate_tpu_torch as mt
from multirate_tpu_torch.ops.cuda import polyphase as pp

F32, BF16, S8 = torch.float32, torch.bfloat16, torch.int8
F64, C64, C128 = torch.float64, torch.complex64, torch.complex128
N_HEAD = 8_000_000
N_147_160 = mt.outputlength(N_HEAD, Fraction(147, 160))

# bench.py's rows and chip_smoke.py's: (T, L, M, outputs, signal, taps)
MAIN_PATH = {
    "rational_147_160": (24, 147, 160, N_147_160, F32, F32),
    "rational_147_160_bf16": (24, 147, 160, N_147_160, BF16, BF16),
    "rational_147_160_int8": (24, 147, 160, N_147_160, S8, S8),
    "rational_147_160_c64": (24, 147, 160, N_147_160, C64, F32),
    "rational_147_160_f64": (24, 147, 160, N_147_160, F64, F64),
    "interp_4_1": (37, 4, 1, 4 * N_HEAD, F32, F32),
    "interp_4_1_bf16_in": (37, 4, 1, 4 * N_HEAD, BF16, BF16),
    "standard_147taps": (147, 1, 1, N_HEAD, F32, F32),
    "decim_1_4": (147, 1, 4, N_HEAD // 4, F32, F32),
    "stream_block_65536": (24, 147, 160,
                           mt.outputlength(1 << 16, Fraction(147, 160)),
                           F32, F32),
    "fir_1_1_T24": (24, 1, 1, N_HEAD, F32, F32),
    "decim_1_4_T24": (24, 1, 4, N_HEAD // 4, F32, F32),
    "interp_4_1_T24": (24, 4, 1, 4 * N_HEAD, F32, F32),
}
NEW = {"reg", "bcast", "slide", "reg.tma"}
# reg.tma's periods a thread a tile, ring buffers by default and at most
# (csrc/mr_plan.cpp, csrc/geometry.cuh)
TMA_PERIODS, TMA_DEPTH, TMA_MAX_DEPTH = 12, 2, 8
# bytes of a staged tap (bf16 is staged as float)
STAGED = {F32: 4, BF16: 4, S8: 1, F64: 8, C64: 8, C128: 16}


def _shape(ws):
    """reg's outputs a thread R and tap padding E by staged tap size."""
    r = 4 if ws <= 4 else (2 if ws <= 8 else 1)
    return r, (0 if r == 1 else r)


def _period(L, M, R):
    """reg's period: Qp outputs, Pp inputs, G groups of R outputs."""
    g = math.gcd(L, M)
    Q, P = L // g, M // g
    m = 1 if Q >= R else -(-R // Q)
    return m * Q, m * P, -(-m * Q // R)


def _tma_buffer(K, T, L, M, R, E, Pp, G, V=4):
    """Samples of one reg.tma ring buffer: K periods' reads, each up to 3
    words off a 16-byte word and T + E + 3 words rounded up to whole
    16-byte words."""
    base_max = (L - 1 + (G - 1) * R * M) // L
    words = (T + E + 2 * (V - 1)) // V * V
    return -(-((K - 1) * Pp + base_max + V - 1 + words) // V) * V


def _expected(L, M, n, x_dt, b_dt):
    """The new variant for a geometry: the FIR and decimators broadcast
    their one tap vector, interpolators slide, the rest keep taps in
    registers, fed by the producer warp where a float32 call has tiles
    enough."""
    if L == 1:
        return "bcast"
    if M == 1:
        return "slide"
    # 37 groups of 4 outputs, 3 a block: 3 * TMA_PERIODS periods a tile
    tiles = -(-n // (3 * TMA_PERIODS * 147))
    return ("reg.tma" if (x_dt, b_dt) == (F32, F32)
            and tiles >= pp.TMA_MIN_TILES else "reg")


@pytest.mark.parametrize("row", list(MAIN_PATH))
def test_main_path_rows_take_a_new_variant(row):
    T, L, M, n, x_dt, b_dt = MAIN_PATH[row]
    p = pp.plan(T, L, M, n, x_dt, b_dt)
    assert p.variant == _expected(L, M, n, x_dt, b_dt)
    assert p.variant in NEW


@pytest.mark.parametrize("case", [
    # 48 taps at 147//160 in complex128 (chip_smoke 3d's bank over 96 KB)
    (48, 147, 160, 50_000, C128, C128),
    # taps per phase outside the compiled set
    (30, 1000, 999, 30_000, F32, F32),
    (30, 4, 1, 30_000, F32, F32),
    (25, 147, 160, 50_000, F32, F32),
    # windows too far apart for the register variant's padding (M/L > 4/3)
    (24, 3, 5, 100_000, F32, F32),
    # a period of Q = 1031 outputs: more groups of 4 than a block's threads
    (24, 1031, 1030, 100_000, F32, F32),
])
def test_other_geometries_take_the_general_variant(case):
    assert pp.plan(*case).variant == "general"


@pytest.mark.parametrize("row", ["stream_block_65536", "rational_147_160",
                                 "rational_147_160_f64", "decim_1_4",
                                 "standard_147taps", "interp_4_1"])
def test_grid_fills_the_card(row):
    T, L, M, n, x_dt, b_dt = MAIN_PATH[row]
    assert pp.plan(T, L, M, n, x_dt, b_dt).grid >= 2 * 132


def test_stream_block_no_longer_makes_59_blocks():
    T, L, M, n, x_dt, b_dt = MAIN_PATH["stream_block_65536"]
    assert n == 60_212
    for variant in (None, "general"):
        assert pp.plan(T, L, M, n, x_dt, b_dt, variant=variant).grid >= 264


def _tile_reach(p, T, L, M, x_dt, b_dt):
    """The largest in-tile offset a plan makes the kernel compute in int32:
    the general variant's r0 + j*M and its span, the register variant's
    span, the broadcast variant's span."""
    if p.variant == "general":
        return max(L - 1 + (p.tile - 1) * M,
                   (L - 1 + (p.tile - 1) * M) // L + T)
    if p.variant == "bcast":
        return (p.tile - 1) * M + T
    if p.variant == "slide":
        return p.tile * (L // math.gcd(L, M))
    R, E = _shape(STAGED[b_dt])
    _, Pp, G = _period(L, M, R)
    if p.variant == "reg.tma":
        return _tma_buffer(p.tile, T, L, M, R, E, Pp, G)
    return (p.tile - 1) * Pp + (L - 1 + (G - 1) * R * M) // L + T + E


@pytest.mark.parametrize("L,M", [(1, 1), (147, 160), (4, 1), (1, 4),
                                 (1, (1 << 20) - 1), ((1 << 20) - 1, 1),
                                 ((1 << 20) - 1, (1 << 20) - 3),
                                 (1000, 999), (3, (1 << 20) - 5)])
@pytest.mark.parametrize("dtypes", [(F32, F32), (S8, S8), (C128, C128)])
@pytest.mark.parametrize("T", [1, 24, 37, 147])
def test_tile_offsets_stay_inside_int32(L, M, dtypes, T):
    n = 10_000_000
    for variant in (None, "general"):
        p = pp.plan(T, L, M, n, *dtypes, variant=variant)
        assert 0 < p.tile and 0 < p.grid <= 65535
        assert 0 < p.smem <= 227 * 1024
        assert _tile_reach(p, T, L, M, *dtypes) < 2**31


def test_a_named_variant_that_cannot_run_raises():
    with pytest.raises(ValueError, match="reg"):
        pp.plan(30, 147, 160, 1000, F32, F32, variant="reg")
    with pytest.raises(ValueError, match="bcast"):
        pp.plan(24, 147, 160, 1000, F32, F32, variant="bcast")
    with pytest.raises(ValueError, match="unknown variant"):
        pp.plan(24, 147, 160, 1000, F32, F32, variant="fast")


@pytest.mark.parametrize("variant", [None, "general", "reg", "reg.tma"])
def test_cpu_wrapper_takes_a_variant_and_runs_the_plain_version(variant):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5000, generator=g)
    hist = torch.randn(2, 23, generator=g)
    bank = torch.randn(24, 147, generator=g)
    n = mt.outputlength(5000 - 1, Fraction(147, 160))
    args = (x, hist, bank, 147, 160, 1, 1, n)
    before = (dict(pp.launches), dict(pp.launches_by_variant))
    y = pp.polyphase(*args, variant=variant)
    assert torch.equal(y, pp.polyphase_plain(*args))
    assert (pp.launches, pp.launches_by_variant) == before


def test_launch_counts_cover_every_entry_and_variant():
    assert set(pp.launches_by_variant) == {
        f"{e}/{v}" for e in pp.ENTRIES.values() for v in pp.VARIANTS}
    assert {"f32/reg.tma", "f32_bf16out/reg.tma",
            "f32_f16out/reg.tma"} <= set(pp.launches_by_variant)
    assert pp.VARIANTS.index("reg.tma") == 4  # csrc/polyphase.cu kRegTma


MADI_OUT = mt.outputlength(1 << 20, Fraction(147, 160))
# (T, L, M, outputs, signal, taps, channels, aligned): calls the planner
# sends down reg.tma by default
TMA_TAKES = {
    "madi_block": (24, 147, 160, MADI_OUT, F32, F32, 64, True),
    "rational_147_160": (24, 147, 160, N_147_160, F32, F32, 1, True),
    "441_480": (24, 441, 480, N_147_160, F32, F32, 1, True),
    "3_4": (24, 3, 4, 6_000_000, F32, F32, 1, True),  # Qp 6, Pp 8
    "5_4": (24, 5, 4, 6_000_000, F32, F32, 2, True),
    "401_404": (24, 401, 404, 5_000_000, F32, F32, 8, True),  # G 101
}
# calls that keep reg (or another variant) by default
TMA_KEEPS = {
    # small launches: a 65,536-sample stream block, 4 channels of 2^16
    "stream_block": (24, 147, 160, 60_212, F32, F32, 1, True),
    "four_blocks": (24, 147, 160, 60_212, F32, F32, 4, True),
    # the rows of x not all 16-byte aligned (an odd row length, or an
    # offset view)
    "rows_unaligned": (24, 147, 160, MADI_OUT, F32, F32, 64, False),
    # other modes
    "bf16": (24, 147, 160, MADI_OUT, BF16, BF16, 64, True),
    "int8": (24, 147, 160, MADI_OUT, S8, S8, 64, True),
    "c64": (24, 147, 160, MADI_OUT, C64, F32, 64, True),
    "f64": (24, 147, 160, MADI_OUT, F64, F64, 64, True),
    "s16": (24, 147, 160, MADI_OUT, torch.int16, F32, 64, True),
    "f32c": (24, 147, 160, MADI_OUT, F32, C64, 64, True),
    "i32": (24, 147, 160, MADI_OUT, torch.int32, torch.int32, 64, True),
    # T = 37; a period of 6 inputs (not whole 16-byte words); 601 outputs
    # a period, 151 groups: more than a block's consumers
    "T37": (37, 147, 160, MADI_OUT, F32, F32, 64, True),
    "7_6": (24, 7, 6, 6_000_000, F32, F32, 8, True),
    "611_604": (24, 611, 604, 5_000_000, F32, F32, 8, True),
}


@pytest.mark.parametrize("row", list(TMA_TAKES))
def test_calls_with_tiles_and_aligned_words_take_reg_tma(row):
    T, L, M, n, x_dt, b_dt, C, aligned = TMA_TAKES[row]
    p = pp.plan(T, L, M, n, x_dt, b_dt, C, aligned=aligned)
    assert p.variant == "reg.tma" and p.depth == TMA_DEPTH
    assert p.grid >= pp.TMA_MIN_TILES
    assert p.tile_outputs % (L // math.gcd(L, M)) == 0
    # the same call, named, plans the same launch
    assert pp.plan(T, L, M, n, x_dt, b_dt, C, "reg.tma",
                   aligned=aligned) == p


@pytest.mark.parametrize("row", list(TMA_KEEPS))
def test_other_calls_keep_their_variant(row):
    T, L, M, n, x_dt, b_dt, C, aligned = TMA_KEEPS[row]
    p = pp.plan(T, L, M, n, x_dt, b_dt, C, aligned=aligned)
    assert p.variant == "reg" and p.depth == 0
    assert p == pp.plan(T, L, M, n, x_dt, b_dt, C, "reg")
    if row in ("stream_block", "four_blocks"):  # a named reg.tma runs
        assert pp.plan(T, L, M, n, x_dt, b_dt, C, "reg.tma").grid < \
            pp.TMA_MIN_TILES
    else:
        with pytest.raises(ValueError, match="reg.tma"):
            pp.plan(T, L, M, n, x_dt, b_dt, C, "reg.tma", aligned=aligned)


@pytest.mark.parametrize("depth", range(2, TMA_MAX_DEPTH + 1))
@pytest.mark.parametrize("periods", [1, 3, 6, 8, 12, 16])
@pytest.mark.parametrize("row", list(TMA_TAKES))
def test_reg_tma_ring_fits_shared_memory(row, periods, depth):
    T, L, M, n, x_dt, b_dt, C, _ = TMA_TAKES[row]
    # the sweeps' ring depth and periods a thread (tools/polyphase_runs.py)
    def forced():
        return pp._plan(T, L, M, n, x_dt, b_dt, C, "reg.tma", True, 0,
                        depth, periods)

    R, E = _shape(4)
    Qp, Pp, G = _period(L, M, R)
    K = max(1, 128 // G) * periods
    nb = _tma_buffer(K, T, L, M, R, E, Pp, G)
    # barriers, then depth buffers of whole 16-byte words; a ring over
    # 227 KB is planned nowhere (the planned periods fit at every depth)
    smem = 2 * 8 * 8 + depth * nb * 4
    if smem > 227 * 1024:
        with pytest.raises(ValueError, match="reg.tma"):
            forced()
        assert periods > TMA_PERIODS
        return
    p = forced()
    assert p.tile == K and p.depth == depth
    assert nb % 4 == 0 and p.smem == smem
    # a buffer holds every word a tile's threads read: the last group's
    # window in the last period, up to 3 words early, 32 words long
    base_max = (L - 1 + (G - 1) * R * M) // L
    assert 3 + (K - 1) * Pp + base_max + 32 <= nb


@pytest.mark.parametrize("shape,ok", [((1, 5001), True), ((2, 5001), False),
                                      ((2, 5000), True), ((3, 4096), True)])
def test_rows_aligned(shape, ok):
    x = torch.zeros(shape)
    assert x.data_ptr() % 16 == 0 and pp.rows_aligned(x) == ok
    # an offset view: one sample in
    assert not pp.rows_aligned(torch.zeros(shape[1] + 1)[1:].view(1, -1))


def test_a_named_reg_tma_needs_aligned_rows_on_cpu():
    g = torch.Generator().manual_seed(2)
    bank = torch.randn(24, 147, generator=g)
    n = mt.outputlength(5000 - 1, Fraction(147, 160))
    for xlen, ok in ((5000, True), (5001, False)):
        x = torch.randn(2, xlen, generator=g)
        hist = torch.randn(2, 23, generator=g)
        args = (x, hist, bank, 147, 160, 1, 1, n)
        if ok:
            assert torch.equal(pp.polyphase(*args, variant="reg.tma"),
                               pp.polyphase_plain(*args))
        else:
            with pytest.raises(ValueError, match="reg.tma"):
                pp.polyphase(*args, variant="reg.tma")
