"""The float64 and complex modes of every filter type in the port against
the JAX package, on the CPU: the dtype matrix of ``tests/test_kernels.py``
for all six families against JAX ``windows`` and ``supercycle``, the TPU
kernels' float64 and complex modes in interpret mode, streaming, the
converters, the repaired float64-taps fault and the complex Farrow oracle.

The port runs with ``device="cpu"``, so its wrappers take their plain
versions; the CUDA kernels are held against those on the card
(``chip_smoke.py`` phase 3d, ``tests/test_torch_gpu.py``).

Tolerances, relative to max|y| (the modulus for complex outputs):
- counts, phase, deficit and histories: exact;
- float64 and complex128 outputs: 1e-12 (the same float64 products summed
  in another order; Farrow taps from the same float64 fit);
- complex64 outputs: 1e-5 (float32 products summed in another order, the
  port's float32 tolerance);
- chunked against whole: 1e-14 in float64 and complex128, 1e-6 in
  complex64;
- interpret-mode TPU kernels: 1e-12 in float64 (kernels 2, 3 and 9 run
  float64 at HIGHEST precision); the complex64 planes through the float32
  zero-copy kernel 1e-4 max and 2e-5 RMS (its bf16x3 split, as in
  ``tests/test_torch_polyphase.py``).
"""

import dataclasses
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu_torch.convert import (params_from_jax, state_from_jax,
                                         state_to_jax)
from multirate_tpu_torch.ops import params as tparams
from multirate_tpu_torch.ops.cuda import polyphase as pp
from multirate_tpu_torch.ops.cuda import resample as rs
from multirate_tpu_torch.ops.dtypes import NARROW
from multirate_tpu_torch.utils.oracle import naivefilt_farrow
from multirate_tpu_torch.utils.testing import rel_max_err

CPU = "cpu"
TOL = {np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12,
       np.dtype(np.complex64): 1e-5, np.dtype(np.float32): 1e-5}
TOL_CHUNKED = {np.dtype(np.float64): 1e-14, np.dtype(np.complex128): 1e-14,
               np.dtype(np.complex64): 1e-6}
TOL_ZC_MAX, TOL_ZC_RMS = 1e-4, 2e-5
NP = {"f32": np.float32, "f64": np.float64, "c64": np.complex64,
      "c128": np.complex128}
# (signal, taps): tests/test_kernels.py's matrix, then complex taps
PAIRS = [("f64", "f64"), ("c128", "f64"), ("c64", "f32"), ("f64", "f32"),
         ("f32", "f64"), ("f32", "c64"), ("c64", "c64"), ("f64", "c128"),
         ("c128", "c128")]
# family: a ratio, or (rate, nphi, polyorder)
FAMILIES = {"standard": Fraction(1, 1), "interpolator": Fraction(4, 1),
            "decimator": Fraction(1, 4), "rational": Fraction(147, 160),
            "arbitrary": (0.4709, 32, None), "farrow": (0.9173, 32, 4)}
RATIONAL = ("standard", "interpolator", "decimator", "rational")


def _bench_taps():
    return mr.firdes(320, 0.45, mr.kaiser, samplerate=32, beta=7.0) * 32


def _values(rng, n, dtype):
    """n seeded samples of ``dtype``: standard normal, re and im."""
    v = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dtype)


def _taps(family, dtype, rng):
    """Random taps for the rational family (8 per phase), bench.py's smooth
    320-tap bank for arbitrary/Farrow; complex ones get an imaginary part
    of the same scale (a quarter of the reversed bank, as
    ``tests/test_pallas.py`` makes them)."""
    if family in RATIONAL:
        r = FAMILIES[family]
        return _values(rng, 8 * r.numerator * (r.denominator if
                                              r.numerator == 1 else 1) + 3,
                       dtype)
    h = _bench_taps()
    if np.issubdtype(dtype, np.complexfloating):
        h = h + 0.25j * h[::-1]
    return h.astype(dtype)


def _kernels(family, h):
    """(JAX kernel, port kernel) from the same taps."""
    spec = FAMILIES[family]
    if family in RATIONAL:
        return (mr.make_kernel(h, ratio=spec),
                mt.make_kernel(h, ratio=spec, device=CPU))
    rate, nphi, po = spec
    return (mr.make_kernel(h, rate=rate, nphi=nphi, polyorder=po),
            mt.make_kernel(h, rate=rate, nphi=nphi, polyorder=po,
                           device=CPU))


def _mid_entry(family, jp, tp, x_dtype, rng):
    """(JAX state, port state) after setphase(0.37) where the family has
    one and a 317-sample JAX prefix block: a carried phase, deficit and
    history of the signal's type."""
    js = mr.init_state(jp, (), x_dtype)
    if family not in ("standard", "decimator"):
        js = mr.setphase(jp, js, 0.37)
    pre = _values(rng, 317, x_dtype)
    _, _, js = mr.filt_block(jp, js, jnp.asarray(pre), path="windows")
    ts = state_from_jax(tp, np.asarray(js.history), int(js.phase),
                        int(js.deficit))
    return js, ts


def _compare(jp, tp, js, ts, x, jax_path):
    """One block through both packages: counts, states and the output
    type equal; returns max|dy| / max|y| and y's numpy dtype."""
    yj, cj, sj = mr.filt_block(jp, js, jnp.asarray(x), path=jax_path)
    yt, ct, st = mt.filt_block(tp, ts, torch.from_numpy(x))
    yj = np.asarray(yj)
    assert ct == int(cj) == yt.shape[-1]
    assert yt.numpy().dtype == yj.dtype, (yt.dtype, yj.dtype)
    assert (st.phase, st.deficit) == (int(sj.phase), int(sj.deficit))
    jh = np.asarray(sj.history)
    assert st.history.numpy().dtype == jh.dtype
    np.testing.assert_array_equal(st.history.numpy(),
                                  jh[..., jh.shape[-1] - tp.h_min:])
    return rel_max_err(yt, yj[..., :ct]), yj.dtype


# --------------------------------------------------------------------------- #
# The dtype matrix, every family, against JAX windows and supercycle
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("pair", PAIRS, ids=["_".join(p) for p in PAIRS])
def test_dtype_matrix_matches_jax(family, pair):
    sx, sh = pair
    rng = np.random.default_rng(31)
    h = _taps(family, NP[sh], rng)
    jp, tp = _kernels(family, h)
    assert tp.bank.dtype == tparams.storage_dtype(
        torch.from_numpy(np.zeros(0, NP[sh])).dtype)
    js, ts = _mid_entry(family, jp, tp, NP[sx], rng)
    x = _values(rng, 2003, NP[sx])
    if family == "arbitrary" and (sx, sh) == ("f64", "f32"):
        # JAX windows forms float32 taps here (pfb + alpha * dpfb in the
        # bank's type), 3e-8 from float64 ones; its TPU route casts the
        # banks to float64 first (compute.py:225-227), as the port does
        jp = dataclasses.replace(jp, pfb=jp.pfb.astype(jnp.float64),
                                 dpfb=jp.dpfb.astype(jnp.float64))
    paths = ("windows", "supercycle") if family in RATIONAL else ("windows",)
    for path in paths:
        err, dtype = _compare(jp, tp, js, ts, x, path)
        assert err <= TOL[dtype], (path, err)


def test_float64_taps_with_float32_signal_give_float64():
    # numpy's default taps (and firdes') are float64: JAX promotes, so the
    # output is float64, not a float32 rounding of it
    rng = np.random.default_rng(32)
    h = rng.standard_normal(48)
    x = rng.standard_normal(4000).astype(np.float32)
    y = mt.filt(h, torch.from_numpy(x), Fraction(3, 4))
    yj = np.asarray(mr.filt(h, x, Fraction(3, 4)))
    assert yj.dtype == np.float64 and y.dtype == torch.float64
    assert rel_max_err(y, yj) <= 1e-12


def test_storage_and_operand_types():
    st = tparams.storage_dtype
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128, torch.bfloat16, torch.int8):
        assert st(dt) == dt
    assert st(torch.float16) == torch.float32
    assert st(torch.bfloat16, quantized=False) == torch.float32
    assert st(torch.complex32) == torch.complex64
    h = np.arange(1.0, 9.0)
    f = mt.make_kernel(h, rate=0.9, polyorder=3, device=CPU)
    assert f.pfb.dtype == f.table.dtype == torch.float64
    assert f.coeffs.dtype == torch.float64
    fc = mt.make_kernel(h.astype(np.complex64), rate=0.9, polyorder=3,
                        device=CPU)
    assert fc.pfb.dtype == fc.table.dtype == torch.complex64
    assert fc.coeffs.dtype == torch.complex128
    # a wider table is re-centred from the fit, not widened from float32
    f32 = mt.make_kernel(h.astype(np.float32), rate=0.9, polyorder=3,
                         device=CPU)
    wide = f32.astype(torch.float64)
    assert wide.table.dtype == torch.float64
    assert torch.equal(wide.table, tparams.farrow_table(f32.coeffs, 32))
    assert not torch.equal(wide.table, f32.table.double())
    assert f32.astype(torch.float32) is f32


# --------------------------------------------------------------------------- #
# The TPU kernels' float64 and complex modes, in interpret mode
# --------------------------------------------------------------------------- #

def test_f64_rational_matches_grouped_kernel_interpret():
    from multirate_tpu.ops.compute import _rational_groups

    rng = np.random.default_rng(33)
    jp, tp = _kernels("rational", _taps("rational", np.float64, rng))
    assert jp.k_zc_hi is None and _rational_groups(jp) is not None
    js, ts = _mid_entry("rational", jp, tp, np.float64, rng)
    err, _ = _compare(jp, tp, js, ts, _values(rng, 2003, np.float64),
                      "pallas")
    assert err <= 1e-12, err


def test_f64_decimator_matches_dense_kernel_interpret():
    # no zero-copy plan in float64 and no grouped plan for a decimator:
    # JAX's pallas path runs rational.py's rational_supercycle_pallas
    rng = np.random.default_rng(34)
    jp, tp = _kernels("decimator", _taps("decimator", np.float64, rng))
    assert jp.k_zc_hi is None
    js, ts = _mid_entry("decimator", jp, tp, np.float64, rng)
    err, _ = _compare(jp, tp, js, ts, _values(rng, 2003, np.float64),
                      "pallas")
    assert err <= 1e-12, err


@pytest.mark.parametrize("taps", ["f64", "c128"])
@pytest.mark.parametrize("family", ["arbitrary", "farrow"])
def test_f64_accumulator_matches_winsel_kernel_interpret(family, taps):
    # float64 takes the any-dtype select.py kernels (window_select_pallas,
    # window_select_farrow_pallas); complex taps run them on split banks
    rng = np.random.default_rng(35)
    jp, tp = _kernels(family, _taps(family, NP[taps], rng))
    js, ts = _mid_entry(family, jp, tp, np.float64, rng)
    err, dtype = _compare(jp, tp, js, ts, _values(rng, 2003, np.float64),
                          "winsel")
    assert dtype == NP[taps] and err <= 1e-12, err


def test_c64_signal_matches_planar_zero_copy_interpret():
    # a complex64 signal against float32 taps runs as two float32 planes
    # through the zero-copy kernel (xlen a multiple of M: ROADMAP queue 3)
    from multirate_tpu.ops import indexing as jidx
    from multirate_tpu.ops.compute import _out_dtype, _zc_plan

    rng = np.random.default_rng(36)
    h = (mr.firdes(24 * 147, 0.5 / 147, mr.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    jp, tp = (mr.make_kernel(h, ratio=Fraction(147, 160)),
              mt.make_kernel(h, ratio=Fraction(147, 160), device=CPU))
    x = _values(rng, 160 * 60, np.complex64)
    planes = jnp.asarray(np.stack([x.real, x.imag]))
    assert _zc_plan(jp, planes, _out_dtype(jp, planes),
                    jidx.max_outputs(jp, x.shape[-1])) is not None
    js = mr.init_state(jp, (), jnp.complex64)
    yj, cj, _ = mr.filt_block(jp, js, jnp.asarray(x), path="pallas")
    yt, ct, _ = mt.filt_block(tp, mt.init_state(tp, (), torch.complex64),
                              torch.from_numpy(x))
    assert ct == int(cj) and yt.dtype == torch.complex64
    want = np.asarray(yj)[:ct]
    assert rel_max_err(yt, want) <= TOL_ZC_MAX
    d = yt.numpy().astype(np.complex128) - want
    assert np.sqrt(np.mean(np.abs(d) ** 2) / np.mean(np.abs(want) ** 2)) \
        <= TOL_ZC_RMS


# --------------------------------------------------------------------------- #
# Streaming
# --------------------------------------------------------------------------- #

STREAM_CASES = {"f64": ("f64", "f64"), "c128": ("c128", "c128"),
                "c64": ("c64", "f32")}  # (signal, taps)


@pytest.mark.parametrize("case", list(STREAM_CASES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_firfilter_chunked_equals_whole(family, case):
    sx, sh = STREAM_CASES[case]
    rng = np.random.default_rng(37)
    h = _taps(family, NP[sh], rng)
    x = _values(rng, 6007, NP[sx])
    spec = FAMILIES[family]
    f = mt.FIRFilter(h, *((spec,) if family in RATIONAL else spec),
                     device=CPU)
    p = f.params
    st = mt.init_state(p, (), torch.from_numpy(x[:0]).dtype)
    if family not in ("standard", "decimator"):
        f.setphase(0.37)
        st = mt.setphase(p, st, 0.37)
    whole, count, end = mt.filt_block(p, st, torch.from_numpy(x))
    cuts = np.sort(rng.integers(0, len(x), 9))
    parts = [f.filt(torch.from_numpy(x[a:b]))
             for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(x)])]
    yc = torch.cat(parts)
    assert yc.dtype == whole.dtype and yc.shape[-1] == count
    assert (f.state.phase, f.state.deficit) == (end.phase, end.deficit)
    assert torch.equal(f.state.history, end.history)
    assert f.state.history.dtype == whole.dtype
    assert rel_max_err(yc, whole) <= TOL_CHUNKED[yc.numpy().dtype]


@pytest.mark.parametrize("taps", ["f64", "c64", "c128"])
@pytest.mark.parametrize("family", ["arbitrary", "farrow"])
def test_tapsforphase_keeps_the_taps_type(family, taps):
    # complex banks give complex taps: arbitrary in the bank's type,
    # Farrow from the float64 or complex128 fit, as in JAX
    jp, tp = _kernels(family, _taps(family, NP[taps],
                                    np.random.default_rng(42)))
    for phase in (1 if family == "arbitrary" else 0, 1.25, 17.5, 33):
        got = mt.tapsforphase(tp, phase)
        want = np.asarray(mr.tapsforphase(jp, phase))
        assert got.numpy().dtype == want.dtype
        assert rel_max_err(got, want) <= TOL[want.dtype]


def test_dtype_switch_casts_history():
    # JAX tests/test_streaming.py:162: a float64 chunk after a float32 one
    # casts the carried history; the deficit carries over
    rng = np.random.default_rng(38)
    h = rng.standard_normal(16)
    f = mt.FIRFilter(h, Fraction(1, 4), device=CPU)
    fj = mr.FIRFilter(h, Fraction(1, 4))
    for chunk in (np.ones(3, np.float32), rng.standard_normal(10),
                  _values(rng, 9, np.complex64)):
        y = f.filt(torch.from_numpy(chunk))
        yj = np.asarray(fj.filt(chunk))
        assert y.numpy().dtype == yj.dtype
        assert rel_max_err(y, yj) <= 1e-12
        assert (f.state.phase, f.state.deficit) == (fj._hphase,
                                                    fj._hdeficit)
        assert f.state.history.dtype == torch.from_numpy(chunk).dtype


@pytest.mark.parametrize("case", list(STREAM_CASES))
@pytest.mark.parametrize("kind", ["arbitrary", "farrow"])
def test_filt_block_tm_wide_equals_channel_major(kind, case):
    # JAX tests/test_pallas.py:586: non-float32 time-major blocks run the
    # channel-major block on the transpose and transpose back
    sx, sh = STREAM_CASES[case]
    rng = np.random.default_rng(39)
    h = _taps(kind, NP[sh], rng)
    x = np.stack([_values(rng, 4001, NP[sx]) for _ in range(5)])
    jp, p = _kernels(kind, h)
    s_cm = mt.setphase(p, mt.init_state(p, (5,)), 0.37)
    s_tm = s_cm
    before = dict(rs.launches)
    i = 0
    for n in [1_001, 7, 1, 2_992]:
        blk = torch.from_numpy(x[:, i:i + n])
        y_cm, c_cm, s_cm = mt.filt_block(p, s_cm, blk)
        y_tm, c_tm, s_tm = mt.filt_block_tm(p, s_tm, blk.t().contiguous())
        assert c_cm == c_tm and y_tm.shape == (c_tm, 5)
        assert y_tm.is_contiguous() and y_tm.dtype == y_cm.dtype
        assert (s_cm.phase, s_cm.deficit) == (s_tm.phase, s_tm.deficit)
        assert torch.equal(s_cm.history, s_tm.history)
        assert torch.equal(y_tm.t(), y_cm)
        i += n
    assert rs.launches == before  # plain on the CPU
    y_tm, c, _ = mt.filt_block_tm(p, mt.init_state(p, (5,)),
                                  torch.from_numpy(np.ascontiguousarray(
                                      x.T)))
    yj, cj, _ = mr.filt_block_tm(jp, mr.init_state(jp, (5,), NP[sx]),
                                 jnp.asarray(np.ascontiguousarray(x.T)))
    assert c == int(cj)
    yj = np.asarray(yj)[:c]
    assert rel_max_err(y_tm, yj) <= TOL[yj.dtype]


# --------------------------------------------------------------------------- #
# Converters
# --------------------------------------------------------------------------- #

CONVERT_CASES = {  # name: (family, signal, taps)
    "rational_c128": ("rational", "c64", "c128"),
    "decimator_f64": ("decimator", "f64", "f64"),
    "interpolator_c64": ("interpolator", "c64", "f32"),
    "arbitrary_c64": ("arbitrary", "c64", "c64"),
    "farrow_f64": ("farrow", "f64", "f64"),
    "farrow_c128": ("farrow", "f64", "c128"),
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_convert_round_trips(case):
    family, sx, sh = CONVERT_CASES[case]
    rng = np.random.default_rng(40)
    h = _taps(family, NP[sh], rng)
    jp, ref = _kernels(family, h)
    tp = params_from_jax({k: v for k, v in vars(jp).items()
                          if v is not None}, device=CPU)
    assert type(tp) is type(ref)
    assert tp.bank.dtype == ref.bank.dtype == torch.from_numpy(h).dtype
    assert torch.equal(tp.bank, ref.bank)
    if family == "farrow":
        assert tp.coeffs.dtype == ref.coeffs.dtype == (
            torch.complex128 if sh == "c128" else torch.float64)
        np.testing.assert_array_equal(tp.coeffs.numpy(),
                                      np.asarray(jp.coeffs))
    js, ts = _mid_entry(family, jp, tp, NP[sx], rng)
    hist, phase, deficit = state_to_jax(ts, jp.history_len)
    jh = np.array(js.history)
    assert hist.dtype == jh.dtype and ts.history.dtype == torch.from_numpy(
        jh).dtype
    np.testing.assert_array_equal(hist[..., -tp.h_min:],
                                  jh[..., -tp.h_min:])
    # a stream resumed from the other package's state: the same next block
    x = _values(rng, 1_501, NP[sx])
    js_back = type(js)(history=jnp.asarray(hist), phase=jnp.asarray(phase),
                       deficit=jnp.asarray(deficit))
    yb, cb, _ = mr.filt_block(jp, js_back, jnp.asarray(x), path="windows")
    yo, co, _ = mr.filt_block(jp, js, jnp.asarray(x), path="windows")
    yt, ct, _ = mt.filt_block(tp, ts, torch.from_numpy(x))
    assert ct == int(cb) == int(co)
    np.testing.assert_array_equal(np.asarray(yb), np.asarray(yo))
    yo = np.asarray(yo)[:ct]
    assert rel_max_err(yt, yo) <= TOL[yo.dtype]


# --------------------------------------------------------------------------- #
# The complex Farrow oracle and the wrappers' new entry points
# --------------------------------------------------------------------------- #

def test_complex_naivefilt_farrow():
    from multirate_tpu.utils.oracle import naivefilt_farrow as jax_farrow

    rng = np.random.default_rng(41)
    h = _bench_taps()
    hc = h + 0.25j * h[::-1]
    x = _values(rng, 3000, np.complex128)
    got = naivefilt_farrow(h, x, 0.4709, 32, 4)
    re = naivefilt_farrow(h, x.real, 0.4709, 32, 4)
    im = naivefilt_farrow(h, x.imag, 0.4709, 32, 4)
    np.testing.assert_array_equal(got, re + 1j * im)
    np.testing.assert_allclose(re, jax_farrow(h, x.real, 0.4709, 32, 4),
                               rtol=1e-12, atol=1e-12)
    # the JAX copy drops the imaginary part (ROADMAP queue 3)
    with pytest.warns(np.exceptions.ComplexWarning):
        dropped = jax_farrow(h, x, 0.4709, 32, 4)
    np.testing.assert_array_equal(dropped,
                                  jax_farrow(h, x.real, 0.4709, 32, 4))
    # the port's complex Farrow path agrees with the complex oracle. Complex
    # taps: the port fits the bank as one complex least-squares problem,
    # the oracle as two real ones; the 32-phase Vandermonde fit amplifies
    # their rounding apart to 3e-12 of max|y|, hence 1e-10 there
    n = 1000
    for taps, sig, tol in ((h, x, 1e-12), (hc, x.real, 1e-10),
                           (hc, x, 1e-10)):
        y = mt.filt(taps, torch.from_numpy(sig), 0.4709, 32, 4)
        ref = naivefilt_farrow(taps, sig, 0.4709, 32, 4)
        assert rel_max_err(y[:n], ref[:n]) <= tol


def test_wrappers_take_the_new_types_on_cpu():
    g = torch.Generator().manual_seed(2)
    before = (dict(pp.launches), dict(rs.launches))
    for (xt, bt, out), name in pp.ENTRIES.items():
        if name not in ("f64", "c64", "c64c", "c128", "c128c"):
            continue
        x = torch.randn(2, 300, generator=g, dtype=xt)
        hist = torch.randn(2, 6, generator=g, dtype=xt)
        bank = torch.randn(7, 3, generator=g, dtype=bt)
        n = mt.outputlength(300, Fraction(3, 2))
        y = pp.polyphase(x, hist, bank, 3, 2, 1, 1, n)
        assert y.dtype == out == pp.ACCUMULATOR[xt]
        xext = torch.cat([hist, x], -1).to(torch.complex128)
        want = torch.stack([xext[:, (k * 2) // 3:(k * 2) // 3 + 7]
                            @ bank[:, (k * 2) % 3].to(torch.complex128)
                            for k in range(n)], -1)
        assert rel_max_err(y, want) <= TOL[y.numpy().dtype]
        with pytest.raises(TypeError):  # taps of another type
            pp.polyphase(x, hist, torch.zeros(7, 3, dtype=torch.float16), 3,
                         2, 1, 1, n)
    p = mt.make_kernel(_bench_taps(), rate=0.9173, nphi=32, device=CPU)
    for (xt, tt, out), name in rs.ENTRIES.items():
        if xt in NARROW:  # the narrow reads: test_torch_signal_types.py
            continue
        x = torch.randn(2, 500, generator=g, dtype=xt)
        hist = torch.zeros(2, p.h_min, dtype=xt)
        pk = p.astype(tt)
        n = mt.outputlength(p, 500)
        y = rs.resample(x, hist, pk, 0, 1, n)
        assert y.dtype == out == (tt if tt.is_complex else xt)
        assert y.shape == (2, n)
        if name != "f32":
            with pytest.raises(TypeError, match="time-major"):
                rs.resample_tm(x.t().contiguous(), hist, pk, 0, 1, n)
    assert (pp.launches, rs.launches) == before
