"""The port's arbitrary-rate and Farrow resamplers on the CPU, against the
JAX package: the accumulator algebra, ``filt``, ``filt_block``,
``FIRFilter``, ``filt_block_tm``, ``setphase``, ``tapsforphase``, the
converters and the oracles, at ``bench.py``'s 320-tap bank (nphi 32, 10
taps per phase) and at nphi 7.

Tolerances:
- indices, counts, accumulator and deficit: exact (integers on both sides);
- port vs JAX ``windows``: max|dy| <= 1e-5 * max|y| (both float32 on the
  CPU; the reduction order over the taps differs);
- port vs JAX ``gridsel`` (its TPU kernel in interpret mode):
  5e-5 * max|y|, that kernel's own first-order tap error (2.0e-5 at worst
  on these taps);
- port chunked vs port whole, and time-major vs channel-major: 1e-6 *
  max|y| (the same per-output float32 dot; only the einsum's blocking may
  change);
- against the float64 oracles: relative RMS <= 8e-5 (the JAX package's
  bench tripwire), and <= 1e-4 for arbitrary resampling at the reference's
  harness rate, whose dh = [diff(h); 0] wrap floor is 7.8e-5.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
from multirate_tpu.ops import indexing as jidx
import multirate_tpu_torch as mt
from multirate_tpu_torch.convert import (params_from_jax, state_from_jax,
                                         state_to_jax)
from multirate_tpu_torch.ops import indexing as tidx
from multirate_tpu_torch.ops.cuda import resample as rs
from multirate_tpu_torch.ops.params import _delta_fx, farrow_table
from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow

R_REF = 1.0 / 2.123456789
RATES = [R_REF, 0.4709, 0.9173, 1.0, 1.313, 2.5]
KINDS = {"arbitrary": None, "farrow": 4}
N = 20_000
TOL_JAX, TOL_GRIDSEL, TOL_SAME, TOL_ORACLE = 1e-5, 5e-5, 1e-6, 8e-5
TOL_ORACLE_ARB_REF = 1e-4


@pytest.fixture(scope="module")
def taps():
    return (mr.firdes(320, 0.45, mr.kaiser, samplerate=32, beta=7.0) * 32
            ).astype(np.float32)


@pytest.fixture(scope="module")
def signal():
    return np.random.default_rng(0).standard_normal(N).astype(np.float32)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))


# --------------------------------------------------------------------------- #
# The accumulator algebra
# --------------------------------------------------------------------------- #

def _sweep(seed, n=30):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        nphi = int(rng.choice([1, 7, 32, 1024]))
        rate = float(rng.choice([R_REF, 0.3, 0.9173, 1.0, 2.5, 17.0]))
        dfx = _delta_fx(nphi, rate)
        D = nphi << mt.PHASE_FRAC_BITS
        u0 = int(rng.integers(0, D))
        d0 = int(rng.integers(1, dfx // D + 3))
        xlen = int(rng.choice([0, 1, 2, d0 - 1, 97, 4096, 80007,
                               int(rng.integers(0, 10**6)), 2**40 + 3]))
        yield nphi, dfx, u0, d0, max(xlen, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accum_indices_equal(seed):
    for nphi, dfx, u0, d0, _ in _sweep(seed):
        got = tidx.accum_indices(nphi, dfx, u0, d0, 500)
        want = jidx.accum_indices(nphi, dfx, u0, d0, 500)
        assert got[0].dtype == got[1].dtype == torch.int64
        assert got[2].dtype == torch.float64
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_accum_indices_past_int64_wrap():
    # nphi 1024 at rate 0.3: delta_fx is near 2^43.7, so n * delta_fx
    # wraps int64 near n = 2^19.3; the long division stays exact
    nphi, rate = 1024, 0.3
    p = mt.make_kernel(np.ones(2048, np.float32), rate=rate, nphi=nphi,
                       device="cpu")
    st = mt.setphase(p, mt.init_state(p), 0.37)
    n = (1 << 20) + 4097
    steps = torch.arange(n, dtype=torch.int64)
    assert bool((steps * p.delta_fx < 0).any())  # the naive product wraps
    got = tidx.accum_indices(nphi, p.delta_fx, st.phase, 3, n)
    want = jidx.accum_indices(nphi, p.delta_fx, st.phase, 3, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][-1]) == 3 + (st.phase + (n - 1) * p.delta_fx) // (
        nphi << 32)
    xlen = 3_600_000
    count, u1, d1 = tidx.host_carry(p, st.phase, 3, xlen)
    assert count > 1 << 20
    assert (count, u1, d1) == tuple(
        int(v) for v in jidx.accum_carry(nphi, p.delta_fx, st.phase, 3,
                                         xlen))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_and_carry_equal(seed):
    for nphi, dfx, u0, d0, xlen in _sweep(seed):
        want = tuple(int(v) for v in jidx.accum_carry(nphi, dfx, u0, d0,
                                                      xlen))
        assert tidx.accum_carry(nphi, dfx, u0, d0, xlen) == want
        assert tidx.accum_count(nphi, dfx, u0, d0, xlen) == want[0]
        # the same algebra on int64 tensors
        got = tidx.accum_carry(nphi, dfx, torch.tensor(u0), torch.tensor(d0),
                               torch.tensor(xlen))
        assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("nphi", [32, 7])
def test_host_carry_and_lengths_equal(taps, kind, nphi):
    po = KINDS[kind]
    rng = np.random.default_rng(nphi)
    for rate in RATES:
        tp = mt.make_kernel(taps, rate=rate, nphi=nphi, polyorder=po,
                            device="cpu")
        jp = mr.make_kernel(taps, rate=rate, nphi=nphi, polyorder=po)
        assert type(tp).__name__ == type(jp).__name__
        assert (tp.delta_fx, tp.taps_per_phi, tp.h_min) == (
            jp.delta_fx, jp.taps_per_phi, jp.history_len)
        for _ in range(10):
            u0 = int(rng.integers(0, nphi << 32))
            d0 = int(rng.integers(1, 4))
            xlen = int(rng.integers(0, 5000))
            assert tidx.host_carry(tp, u0, d0, xlen) == \
                jidx.host_carry(jp, u0, d0, xlen)
            st = mt.FilterState(history=torch.zeros(0), phase=u0,
                                deficit=d0)
            assert mt.outputlength(tp, xlen, state=st) == \
                mr.outputlength(jp, xlen, state=st)
            outlen = int(rng.integers(1, 3000))
            assert mt.inputlength(tp, outlen, state=st) == \
                mr.inputlength(jp, outlen, state=st)
            assert mt.max_outputs(tp, xlen) == mr.max_outputs(jp, xlen)
        assert mt.outputlength(tp, 1000) == mr.outputlength(jp, 1000)
        assert mt.inputlength(tp, 1000) == mr.inputlength(jp, 1000)


# --------------------------------------------------------------------------- #
# Outputs against the JAX package
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("nphi", [32, 7])
@pytest.mark.parametrize("rate", RATES, ids=[f"{r:.4g}" for r in RATES])
def test_filt_matches_jax(taps, signal, kind, nphi, rate):
    po = KINDS[kind]
    y = mt.filt(taps, torch.from_numpy(signal), rate, nphi, po)
    yj = np.asarray(mr.filt(taps, signal, rate, nphi, po, path="windows"))
    assert y.dtype == torch.float32 and y.shape == yj.shape
    assert _rel_max(y, yj) <= TOL_JAX


@pytest.mark.parametrize("kind", list(KINDS))
def test_filt_block_mid_stream_matches_jax(taps, signal, kind):
    # setphase, then blocks short enough (1 to 7 samples at a low rate)
    # that the window starts past the history (deficit > 1)
    po = KINDS[kind]
    tp = mt.make_kernel(taps, rate=0.31, nphi=32, polyorder=po, device="cpu")
    jp = mr.make_kernel(taps, rate=0.31, nphi=32, polyorder=po)
    ts = mt.setphase(tp, mt.init_state(tp, (2,)), 0.37)
    js = mr.setphase(jp, mr.init_state(jp, (2,), jnp.float32), 0.37)
    x = np.stack([signal[:3000], signal[3000:6000]])
    i, deficits = 0, set()
    for n in [1, 7, 2, 5, 3, 1, 4, 6, 1, 1, 2, 1500, 3, 1, 7, 1456]:
        yt, ct, ts = mt.filt_block(tp, ts, torch.from_numpy(x[:, i:i + n]))
        yj, cj, js = mr.filt_block(jp, js, jnp.asarray(x[:, i:i + n]),
                                   path="windows")
        assert ct == int(cj) == yt.shape[-1]
        assert (ts.phase, ts.deficit) == (int(js.phase), int(js.deficit))
        np.testing.assert_array_equal(ts.history.numpy(),
                                      np.asarray(js.history))
        if ct:
            assert _rel_max(yt, np.asarray(yj)[:, :ct]) <= TOL_JAX
        deficits.add(ts.deficit)
        i += n
    assert i == x.shape[1] and max(deficits) > 1


def test_gridsel_interpret_within_first_order_error(taps, signal):
    # the TPU kernel (path="gridsel", interpret mode on the CPU) folds the
    # tap polynomial to first order; its own error bounds this tolerance
    tp = mt.make_kernel(taps, rate=0.4709, nphi=32, polyorder=4, device="cpu")
    jp = mr.make_kernel(taps, rate=0.4709, nphi=32, polyorder=4)
    y, c, _ = mt.filt_block(tp, mt.init_state(tp), torch.from_numpy(signal))
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), jnp.float32),
                              jnp.asarray(signal), path="gridsel")
    assert c == int(cj)
    assert _rel_max(y, np.asarray(yj)[:c]) <= TOL_GRIDSEL


# --------------------------------------------------------------------------- #
# Streaming: chunked == whole, time-major == channel-major
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("chunk", [1, 7, 4096])
def test_firfilter_chunked_equals_whole(taps, signal, kind, chunk):
    po = KINDS[kind]
    x = signal[:2000] if chunk == 1 else signal
    f = mt.FIRFilter(taps, R_REF, 32, po)
    parts = [f.filt(torch.from_numpy(x[i:i + chunk]))
             for i in range(0, len(x), chunk)]
    whole = mt.filt(taps, torch.from_numpy(x), R_REF, 32, po)
    yc = torch.cat(parts)
    assert yc.shape == whole.shape
    assert _rel_max(yc, whole) <= TOL_SAME
    count, u1, d1 = tidx.host_carry(f.params, 0, 1, len(x))
    assert (yc.shape[0], f.state.phase, f.state.deficit) == (count, u1, d1)
    jp = mr.make_kernel(taps, rate=R_REF, nphi=32, polyorder=po)
    assert (count, u1, d1) == jidx.host_carry(jp, 0, 1, len(x))
    np.testing.assert_array_equal(f.history.numpy(),
                                  x[len(x) - f.params.h_min:])


@pytest.mark.parametrize("kind", list(KINDS))
def test_filt_block_tm_matches_channel_major(taps, kind):
    po = KINDS[kind]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 9_001)).astype(np.float32)
    p = mt.make_kernel(taps, rate=0.9173, nphi=32, polyorder=po, device="cpu")
    s_cm = mt.setphase(p, mt.init_state(p, (8,)), 0.37)
    s_tm = s_cm
    i = 0
    for n in [4_001, 5, 1, 3_000, 1_994]:
        blk = torch.from_numpy(x[:, i:i + n])
        y_cm, c_cm, s_cm = mt.filt_block(p, s_cm, blk)
        y_tm, c_tm, s_tm = mt.filt_block_tm(p, s_tm, blk.t().contiguous())
        assert c_cm == c_tm and y_tm.shape == (c_tm, 8)
        assert (s_cm.phase, s_cm.deficit) == (s_tm.phase, s_tm.deficit)
        assert torch.equal(s_cm.history, s_tm.history)
        assert s_tm.history.shape == (8, p.h_min)
        if c_cm:
            assert _rel_max(y_tm.t(), y_cm) <= TOL_SAME
        i += n
    # the whole signal: time-major equals JAX's channel-major windows path
    y_tm, _, _ = mt.filt_block_tm(p, mt.init_state(p, (8,)),
                                  torch.from_numpy(np.ascontiguousarray(x.T)))
    yj = mr.filt(taps, x, 0.9173, 32, po, path="windows")
    assert _rel_max(y_tm.t(), yj) <= TOL_JAX


# --------------------------------------------------------------------------- #
# Phase control, taps, converters, oracles
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", list(KINDS))
def test_setphase_and_tapsforphase_match_jax(taps, signal, kind):
    po = KINDS[kind]
    tp = mt.make_kernel(taps, rate=0.4709, nphi=32, polyorder=po, device="cpu")
    jp = mr.make_kernel(taps, rate=0.4709, nphi=32, polyorder=po)
    for phi in (0.0, 0.37, 0.5, 1.0):
        ts = mt.setphase(tp, mt.init_state(tp), phi)
        js = mr.setphase(jp, mr.init_state(jp, (), jnp.float32), phi)
        assert ts.phase == int(js.phase)
    f, fj = mt.FIRFilter(taps, 0.4709, 32, po), mr.FIRFilter(
        taps, 0.4709, 32, po)
    f.setphase(0.37)
    fj.setphase(0.37)
    # under 4096 samples the JAX CPU auto path is ``windows`` for both
    y = f.filt(torch.from_numpy(signal[:4_000]))
    assert _rel_max(y, fj.filt(signal[:4_000])) <= TOL_JAX
    assert (f.state.phase, f.state.deficit) == (fj._hphase, fj._hdeficit)
    assert f.outputlength(999) == fj.outputlength(999)
    assert f.inputlength(999) == fj.inputlength(999)
    f.reset()
    assert (f.state.phase, f.state.deficit) == (0, 1)
    lo = 1 if po is None else 0
    for phase in (lo, 1, 1.25, 17.5, 32.999, 33):
        got = mt.tapsforphase(tp, phase)
        want = np.asarray(mr.tapsforphase(jp, phase))
        assert got.dtype == (torch.float32 if po is None else torch.float64)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="phase"):
        mt.tapsforphase(tp, 34)
    with pytest.raises(TypeError, match="tapsforphase"):
        mt.tapsforphase(
            mt.make_kernel(taps, ratio=Fraction(3, 2), device="cpu"), 1)


@pytest.mark.parametrize("kind", list(KINDS))
def test_convert_round_trips(taps, signal, kind):
    po = KINDS[kind]
    jp = mr.make_kernel(taps, rate=R_REF, nphi=32, polyorder=po)
    tp = params_from_jax({k: v for k, v in vars(jp).items()
                          if v is not None}, device="cpu")
    ref = mt.make_kernel(taps, rate=R_REF, nphi=32, polyorder=po, device="cpu")
    assert type(tp) is type(ref)
    assert (tp.nphi, tp.taps_per_phi, tp.rate, tp.delta_fx) == (
        ref.nphi, ref.taps_per_phi, ref.rate, ref.delta_fx)
    assert torch.equal(tp.table, ref.table)
    js = mr.setphase(jp, mr.init_state(jp, (), jnp.float32), 0.37)
    y0, c0, js = mr.filt_block(jp, js, jnp.asarray(signal[:7_001]),
                               path="windows")
    ts = state_from_jax(tp, np.asarray(js.history), int(js.phase),
                        int(js.deficit))
    hist, phase, deficit = state_to_jax(ts, jp.history_len)
    np.testing.assert_array_equal(hist, np.asarray(js.history))
    assert (int(phase), int(deficit)) == (int(js.phase), int(js.deficit))
    # a stream begun in JAX continues in the port and back in JAX
    y1, c1, ts1 = mt.filt_block(tp, ts, torch.from_numpy(signal[7_001:]))
    js_back = type(js)(history=jnp.asarray(hist), phase=jnp.asarray(phase),
                       deficit=jnp.asarray(deficit))
    y2, c2, js2 = mr.filt_block(jp, js_back, jnp.asarray(signal[7_001:]),
                                path="windows")
    assert c1 == int(c2)
    assert (ts1.phase, ts1.deficit) == (int(js2.phase), int(js2.deficit))
    assert _rel_max(y1, np.asarray(y2)[:c1]) <= TOL_JAX
    both = np.concatenate([np.asarray(y0)[:int(c0)], y1.numpy()])
    js0 = mr.setphase(jp, mr.init_state(jp, (), jnp.float32), 0.37)
    yw, cw, _ = mr.filt_block(jp, js0, jnp.asarray(signal), path="windows")
    assert _rel_max(both, np.asarray(yw)[:int(cw)]) <= TOL_JAX


@pytest.mark.parametrize("kind", list(KINDS))
def test_oracles(taps, signal, kind):
    po = KINDS[kind]
    n = 5_000
    for rate in (R_REF, 0.4709):
        y = mt.filt(taps, torch.from_numpy(signal), rate, 32, po).numpy()
        p = mt.make_kernel(taps, rate=rate, nphi=32, polyorder=po,
                           device="cpu")
        x_in = signal[:mt.inputlength(p, n)].astype(np.float64)
        if po is None:
            ref = naivefilt(taps.astype(np.float64), x_in, rate, 32)
            limit = TOL_ORACLE_ARB_REF if rate == R_REF else TOL_ORACLE
        else:
            ref = naivefilt_farrow(taps, x_in, rate, 32, po)
            from multirate_tpu.utils.oracle import naivefilt_farrow as jref
            np.testing.assert_allclose(ref, jref(taps, x_in, rate, 32, po),
                                       rtol=1e-12, atol=1e-12)
            limit = TOL_ORACLE
        assert len(ref) >= n and _rel_rms(y[:n], ref[:n]) <= limit


# --------------------------------------------------------------------------- #
# The kernel's table and its wrappers on the CPU
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("nphi", [32, 7])
def test_farrow_table_horner_in_float32(taps, nphi):
    # csrc/resample.cu evaluates tap t at psi = phi + 1 + alpha as Horner
    # over alpha in float32 from the float32 re-centred table; that stays
    # within 1e-6 * max|tap| of the float64 fit at psi
    p = mt.make_kernel(taps, rate=0.4709, nphi=nphi, polyorder=4, device="cpu")
    np.testing.assert_allclose(farrow_table(p.coeffs.numpy(), nphi)[0],
                               p.pfb.numpy(), atol=2e-2)  # fit of the bank
    rng = np.random.default_rng(nphi)
    phi = rng.integers(0, nphi, 4000)
    alpha = rng.integers(0, 1 << 32, 4000).astype(np.float32) \
        * np.float32(2.0 ** -32)
    tb = p.table.numpy()
    got = tb[-1][:, phi]
    for k in range(tb.shape[0] - 2, -1, -1):
        got = (got * alpha + tb[k][:, phi]).astype(np.float32)
    psi = 1.0 + phi + alpha.astype(np.float64)
    want = (psi[:, None] ** np.arange(5)) @ p.coeffs.numpy()
    assert np.abs(got.T - want).max() <= 1e-6 * np.abs(want).max()


def test_cpu_wrappers_run_plain_without_counting(taps, signal):
    p = mt.make_kernel(taps, rate=0.9173, nphi=32, polyorder=4, device="cpu")
    x = torch.from_numpy(signal[:4_000]).view(1, -1)
    hist = torch.zeros(1, p.h_min)
    n = mt.outputlength(p, 4_000)
    before = (dict(rs.launches), rs.launches_tm)
    y = rs.resample(x, hist, p, 0, 1, n)
    yt = rs.resample_tm(x.t().contiguous(), hist, p, 0, 1, n)
    assert (rs.launches, rs.launches_tm) == before
    assert torch.equal(y, rs.resample_plain(x, hist, p, 0, 1, n))
    assert torch.equal(yt, y.t())


@pytest.mark.parametrize("bad", ["dtype", "layout", "hist_shape", "kernel",
                                 "u0", "deficit", "too_many", "device"])
def test_wrapper_raises(taps, bad):
    p = mt.make_kernel(taps, rate=0.4709, nphi=32, device="cpu")
    x = torch.randn(2, 500)
    hist, u0, d0 = torch.zeros(2, p.h_min), 0, 1
    n = mt.outputlength(p, 500)
    if bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = torch.randn(500, 2).t()
    elif bad == "hist_shape":
        hist = hist[:, 1:].contiguous()
    elif bad == "kernel":
        p = mt.make_kernel(taps, ratio=Fraction(3, 2), device="cpu")
    elif bad == "u0":
        u0 = -1
    elif bad == "deficit":
        d0 = 0
    elif bad == "too_many":
        n += 1
    elif bad == "device":
        x, hist = x.to("meta"), hist.to("meta")
        p = p.to("meta")
    with pytest.raises((TypeError, ValueError)):
        rs.resample(x, hist, p, u0, d0, n)


def test_make_kernel_dispatch_and_errors(taps):
    assert isinstance(mt.make_kernel(taps, ratio=0.5, device="cpu"),
                      mt.FIRArbitrary)
    assert isinstance(mt.make_kernel(taps, rate=0.5, polyorder=2,
                                     device="cpu"),
                      mt.FIRFarrow)
    assert isinstance(mt.make_kernel(taps, ratio=Fraction(1, 2), device="cpu"),
                      mt.FIRDecimator)
    f = mt.make_kernel(taps, rate=0.5, nphi=7, polyorder=3, device="cpu")
    assert f.coeffs.dtype == torch.float64 and f.coeffs.shape == (4, 46)
    assert f.table.shape == (4, 46, 7) and f.table.dtype == torch.float32
    a = mt.make_kernel(torch.from_numpy(taps), rate=0.5)
    assert a.table.shape == (2, 10, 32) and a.device == torch.device("cpu")
    for bad_rate in (0.0, -1.0):
        with pytest.raises(ValueError, match="rate"):
            mt.make_kernel(taps, rate=bad_rate, device="cpu")
    with pytest.raises(ValueError, match="exact-arithmetic"):
        mt.make_kernel(taps, rate=0.001, nphi=32, device="cpu")
    c = mt.make_kernel(taps.astype(np.complex64), rate=0.5, device="cpu")
    assert c.table.dtype == torch.complex64
    assert mt.filt(taps, torch.zeros(100, dtype=torch.float64),
                   0.5).dtype == torch.float64
    # a bfloat16 signal at a rate is widened to float32 (float32 output)
    xb = torch.from_numpy(np.random.default_rng(3).standard_normal(
        2000).astype(np.float32)).to(torch.bfloat16)
    yb = mt.filt(taps, xb, 0.5, device="cpu")
    assert yb.dtype == torch.float32
    assert torch.equal(yb, mt.filt(taps, xb.float(), 0.5, device="cpu"))
    rat = mt.make_kernel(taps, ratio=Fraction(3, 2), device="cpu")
    st = mt.init_state(rat, (2,))
    with pytest.raises(TypeError, match="time-major"):
        mt.filt_block_tm(rat, st,
                         torch.zeros(100, 2))
    with pytest.raises(ValueError, match="2-D"):
        mt.filt_block_tm(a, mt.init_state(a, (2,)), torch.zeros(2, 3, 100))
    with pytest.raises(ValueError, match="path"):
        mt.filt_block_tm(a, mt.init_state(a, (2,)), torch.zeros(100, 2),
                         path="winsel")
