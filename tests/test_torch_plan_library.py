"""The planner library (``csrc/mr_plan.cpp``) behind both kernels' ``plan``:
its plans for the benchmark cells' calls and the port's bench rows, pinned;
its sets against the wrappers' public ones; and the build keys of the
geometry header it shares with the kernels (``csrc/geometry.cuh``).

The pinned plans are the ones the Python planners gave before the planner
moved into C++ (the same integers, variant for variant), but for the
one-channel float32 calls at 1/2.123456789 (capture's and two bench rows'),
which take the grouped path's grouped.tma form since: a change to any of
them changes a launch on the card.
"""

import shutil

import pytest
import torch

from multirate_tpu_torch.ops.cuda import build
from multirate_tpu_torch.ops.cuda import polyphase as pp
from multirate_tpu_torch.ops.cuda import resample as rs

F32, BF16, S8 = torch.float32, torch.bfloat16, torch.int8
F64, C64 = torch.float64, torch.complex64

# (T, L, M, n_out, signal, taps, channels) -> plan: the cells' calls (madi:
# 64 x 2^20 at 147//160; pcm: a 65,536-sample block, float32 after the
# ring widens its int16) and the bench rows' (8,000,000 samples)
PP_PINS = {
    "madi_block": ((24, 147, 160, 963380, F32, F32, 64),
                   ("reg.tma", 36, 11712, 46464, 5292, 2)),
    "pcm_block": ((24, 147, 160, 60212, F32, F32, 1),
                  ("reg", 1, 410, 1568, 147, 0)),
    "rational_147_160": ((24, 147, 160, 7350000, F32, F32, 1),
                         ("reg.tma", 36, 1389, 46464, 5292, 2)),
    "rational_147_160_bf16": ((24, 147, 160, 7350000, BF16, BF16, 1),
                              ("reg", 9, 5556, 5952, 1323, 0)),
    "rational_147_160_int8": ((24, 147, 160, 7350000, S8, S8, 1),
                              ("reg", 9, 5556, 3008, 1323, 0)),
    "rational_147_160_c64": ((24, 147, 160, 7350000, C64, F32, 1),
                             ("reg", 9, 5556, 23520, 1323, 0)),
    "rational_147_160_f64": ((24, 147, 160, 7350000, F64, F64, 1),
                             ("reg", 6, 8334, 15840, 882, 0)),
    "standard_147taps": ((147, 1, 1, 8000000, F32, F32, 1),
                         ("bcast", 2304, 3473, 39520, 2304, 0)),
    "decim_1_4": ((147, 1, 4, 2000000, F32, F32, 1),
                  ("bcast", 1152, 1737, 62992, 1152, 0)),
    "interp_4_1": ((37, 4, 1, 32000000, F32, F32, 1),
                   ("slide", 2025, 3951, 49040, 8100, 0)),
    "interp_4_1_bf16out": ((37, 4, 1, 32000000, F32, F32, 1),
                           ("slide", 2025, 3951, 49040, 8100, 0)),
}
# (T, P+1, nphi, delta_fx, n_out, channels, signal, table, time-major) ->
# plan: the cells' calls (capture: 1 x 2^26; sdr: a 65,536-sample block;
# farrow64: a card's 64 x 2^23 at 0.9173) and the bench rows'
R_REF_DELTA, DELTA_4709, DELTA_9173 = 291845678823, 291864415952, 149829884958
RS_PINS = {
    "capture_block": ((10, 5, 32, R_REF_DELTA, 31603593, 1, F32, F32, False),
                      ("t10p5.grouped.tma", 3888, 1, 1, 8129, 288, 104160,
                       243, 7, 2)),
    "sdr_block": ((10, 5, 32, R_REF_DELTA, 30863, 1, F32, F32, False),
                  ("t10p5", 64, 1, 1, 483, 64, 7584, 0, 0)),
    "farrow64_shard": ((10, 5, 32, DELTA_9173, 7694871, 64, F32, F32, False),
                       ("t10p5", 512, 8, 1, 65535, 128, 43008, 0, 0)),
    "arbitrary_0.4709": ((10, 2, 32, DELTA_4709, 3767201, 1, F32, F32,
                          False),
                         ("t10p2", 1024, 1, 8, 3679, 128, 24672, 0, 0)),
    "arbitrary_refrate": ((10, 2, 32, R_REF_DELTA, 3767442, 1, F32, F32,
                           False),
                          ("t10p2.grouped.tma", 2916, 1, 1, 1292, 288,
                           75776, 243, 7, 2)),
    "farrow_refrate": ((10, 5, 32, R_REF_DELTA, 3767442, 1, F32, F32, False),
                       ("t10p5.grouped.tma", 2916, 1, 1, 1292, 288, 79872,
                        243, 7, 2)),
    "farrow_0.4709": ((10, 5, 32, DELTA_4709, 3767201, 1, F32, F32, False),
                      ("t10p5", 1024, 1, 8, 3679, 128, 28512, 0, 0)),
    "farrow_64ch_batched": ((10, 5, 32, DELTA_9173, 114663, 64, F32, F32,
                             False),
                            ("t10p5", 512, 8, 1, 1792, 128, 43008, 0, 0)),
    "farrow_64ch_tmajor": ((10, 5, 32, DELTA_9173, 114663, 64, F32, F32,
                            True),
                           ("t10p5", 128, 32, 1, 1792, 256, 50176, 0, 0)),
}


@pytest.mark.parametrize("row", list(PP_PINS))
def test_polyphase_plans_are_pinned(row):
    args, want = PP_PINS[row]
    assert pp.plan(*args) == pp.Plan(*want)


@pytest.mark.parametrize("row", list(RS_PINS))
def test_resample_plans_are_pinned(row):
    args, want = RS_PINS[row]
    assert rs.plan(*args) == rs.Plan(*want)


def test_pinned_deltas_are_the_rates():
    from multirate_tpu_torch.ops.params import _delta_fx

    assert (_delta_fx(32, 1 / 2.123456789), _delta_fx(32, 0.4709),
            _delta_fx(32, 0.9173)) == (R_REF_DELTA, DELTA_4709, DELTA_9173)


def test_library_sets_equal_the_public_ones():
    # the taps per phase the library plans reg, slide and reg.tma for
    def takes(T, L, M, variant):
        try:
            return pp.plan(T, L, M, 1 << 20, F32, F32, 1, variant).variant
        except ValueError:
            return None

    Ts = range(1, 160)
    assert tuple(T for T in Ts if takes(T, 147, 160, "reg")) == pp.REG_TAPS
    assert tuple(T for T in Ts if takes(T, 4, 1, "slide")) == pp.REG_TAPS
    assert tuple(T for T in Ts
                 if takes(T, 147, 160, "reg.tma")) == pp.TMA_TAPS
    # the (T, P+1) pairs it compiles, their grouped paths (a narrow read,
    # int16, takes the grouped path) and the grouped paths' grouped.tma
    # forms (float32)
    compiled, grouped, tma = {}, {}, {}
    for T in range(1, 80):
        for P1 in range(1, 7):
            p = rs.plan(T, P1, 32, R_REF_DELTA, 1 << 20, 1, F32, F32)
            g = rs.plan(T, P1, 32, R_REF_DELTA, 1 << 20, 1, torch.int16, F32)
            if p.variant != "general":
                compiled[T, P1] = p.variant.split(".")[0]
                if g.variant.endswith(".grouped"):
                    grouped[compiled[T, P1]] = g.variant
                if p.variant.endswith(".grouped.tma"):
                    tma[compiled[T, P1]] = p.variant
    assert compiled == rs.COMPILED and grouped == rs.GROUPED
    assert tma == rs.GROUPED_TMA


def test_an_edit_to_the_shared_header_changes_both_builds_keys(
        tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    names = ("polyphase", "resample", "mr_plan")

    def keys():  # each library's build directory, build/<name>-<hash>
        return [build._recipe(n, ())[3] for n in names]

    before = keys()
    assert before == keys()
    header = csrc / "geometry.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = keys()
    assert all(a != b for a, b in zip(before, after))
