"""The quantized modes of the rational family in the port against the JAX
package, on the CPU: bf16 taps and signal (float32 outputs), int8 taps and
signal (exact int32 accumulators, ``ops/quant.py``) and narrow output
stores (``make_kernel(store_dtype=)``); the converters for them; and the
device default of the port's entry points.

The port runs with ``device="cpu"``, so the polyphase wrapper takes its
plain version. JAX runs its ``supercycle`` path, plus one interpret-mode
``pallas`` (zero-copy kernel) case per mode, as ``tests/test_kernels.py``
and ``tests/test_quant.py`` run them. Never its ``windows`` path in these
modes: there JAX rounds the rational kernel's bf16 accumulators back to
bf16 and returns int8 accumulators that wrap (ROADMAP queue 3).

Tolerances:
- counts, phase, deficit and histories: exact;
- bf16 mode: max|dy| <= 1e-5 * max|y| against JAX (the same exact bf16
  products, summed in float32 in another order); chunked against whole
  1e-6 * max|y|;
- int8 mode: equal, to JAX and to the exact integer oracle
  (``scipy.signal.upfirdn`` in float64, exact below 2^53), and chunked ==
  whole bit for bit;
- narrow stores: within one ulp of the store type (the spacing at the
  larger magnitude) of JAX, or 1e-5 * max|y| where outputs near zero
  come from float32 sums taken in another order; equal to the port's own
  float32 output rounded.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu.ops import quant as jquant
from multirate_tpu_torch import convert
from multirate_tpu_torch.ops import api as tapi
from multirate_tpu_torch.ops import params as tparams
from multirate_tpu_torch.ops import quant as tquant
from multirate_tpu_torch.ops.cuda import build
from multirate_tpu_torch.ops.cuda import polyphase as pp
from multirate_tpu_torch.utils.testing import ulps_apart

TOL_BF16 = 1e-5
TOL_CHUNKED = 1e-6
BF16_RATIOS = [Fraction(147, 160), Fraction(1, 1), Fraction(1, 4),
               Fraction(4, 1)]
INT8_RATIOS = [Fraction(1, 1), Fraction(1, 4), Fraction(4, 1),
               Fraction(3, 2), Fraction(147, 160)]
CPU = "cpu"


def _ids(ratios):
    return [f"{r.numerator}_{r.denominator}" for r in ratios]


@pytest.fixture(scope="module")
def bf16_data():
    """24*21 random bf16 taps and 40 000 bf16 samples, as numpy arrays of
    JAX's bfloat16 and as torch tensors holding the same values."""
    rng = np.random.default_rng(21)
    hb = np.asarray(jnp.asarray(rng.standard_normal(24 * 21), jnp.bfloat16))
    xb = np.asarray(jnp.asarray(rng.standard_normal(40_000), jnp.bfloat16))
    return (hb, xb, torch.from_numpy(hb.astype(np.float32)).bfloat16(),
            torch.from_numpy(xb.astype(np.float32)).bfloat16())


@pytest.fixture(scope="module")
def int8_taps():
    return np.asarray(mr.firdes(96, 0.2, mr.kaiser, beta=7.0))


def _rel_max(got, want):
    got = np.asarray(torch.as_tensor(got).double())
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_fields(jp):
    return {k: np.asarray(v) for k, v in vars(jp).items()}


# --------------------------------------------------------------------------- #
# bf16 mode
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mid", [False, True], ids=["fresh", "mid"])
@pytest.mark.parametrize("ratio", BF16_RATIOS, ids=_ids(BF16_RATIOS))
def test_bf16_matches_jax_supercycle(bf16_data, ratio, mid):
    hb, xb, hb_t, xb_t = bf16_data
    jp = mr.make_kernel(hb, ratio=ratio)
    tp = mt.make_kernel(hb, ratio=ratio, device=CPU)
    assert tp.bank.dtype == torch.bfloat16
    js = mr.init_state(jp, (), jnp.bfloat16)
    if mid:
        if isinstance(tp, mt.FIRRational):
            js = mr.setphase(jp, js, 0.37)
        _, _, js = mr.filt_block(jp, js, jnp.asarray(xb[:1237]),
                                 path="supercycle")
    ts = convert.state_from_jax(tp, np.asarray(js.history), int(js.phase),
                                int(js.deficit))
    assert ts.history.dtype == torch.bfloat16
    yj, cj, sj = mr.filt_block(jp, js, jnp.asarray(xb), path="supercycle")
    yt, ct, st = mt.filt_block(tp, ts, xb_t)
    cj = int(cj)
    assert yt.dtype == torch.float32 and ct == cj == yt.shape[-1]
    assert (st.phase, st.deficit) == (int(sj.phase), int(sj.deficit))
    jh = np.asarray(sj.history).astype(np.float32)
    np.testing.assert_array_equal(st.history.float().numpy(),
                                  jh[..., jh.shape[-1] - tp.h_min:])
    assert _rel_max(yt, np.asarray(yj)[:cj]) <= TOL_BF16
    if not mid:  # the one-shot entry, with torch bf16 taps
        assert torch.equal(mt.filt(hb_t, xb_t, ratio), yt)


@pytest.mark.parametrize("chunk", [997, 31_013])
@pytest.mark.parametrize("ratio", BF16_RATIOS, ids=_ids(BF16_RATIOS))
def test_bf16_firfilter_chunked_equals_whole(bf16_data, ratio, chunk):
    _, _, hb_t, xb_t = bf16_data
    whole_p = mt.make_kernel(hb_t, ratio=ratio)
    whole, count, end = mt.filt_block(
        whole_p, mt.init_state(whole_p, (), torch.bfloat16), xb_t)
    f = mt.FIRFilter(hb_t, ratio)
    parts = [f.filt(xb_t[i:i + chunk]) for i in range(0, len(xb_t), chunk)]
    yc = torch.cat(parts)
    assert yc.dtype == torch.float32 and yc.shape[-1] == count
    assert _rel_max(yc, whole) <= TOL_CHUNKED
    assert (f.state.phase, f.state.deficit) == (end.phase, end.deficit)
    assert f.state.history.dtype == torch.bfloat16
    assert torch.equal(f.state.history, end.history)


def test_bf16_matches_jax_zero_copy_interpret(bf16_data):
    from multirate_tpu.ops import indexing as jidx
    from multirate_tpu.ops.compute import _out_dtype, _zc_plan

    hb, xb, _, xb_t = bf16_data
    ratio = Fraction(147, 160)
    jp = mr.make_kernel(hb, ratio=ratio)
    xj = jnp.asarray(xb)
    assert _zc_plan(jp, xj, _out_dtype(jp, xj),
                    jidx.max_outputs(jp, xj.shape[-1])) is not None
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), jnp.bfloat16), xj,
                              path="pallas")
    tp = mt.make_kernel(hb, ratio=ratio, device=CPU)
    yt, ct, _ = mt.filt_block(tp, mt.init_state(tp, (), torch.bfloat16),
                              xb_t)
    assert ct == int(cj)
    assert _rel_max(yt, np.asarray(yj)[:ct]) <= TOL_BF16


# --------------------------------------------------------------------------- #
# int8 mode
# --------------------------------------------------------------------------- #

def _upfirdn_int(hq, xq, ratio):
    """The exact integer L//M resample: float64 holds these sums exactly."""
    from scipy.signal import upfirdn

    return upfirdn(hq.astype(np.float64), xq.astype(np.float64),
                   up=ratio.numerator, down=ratio.denominator)


def test_quantizers_match_jax(int8_taps):
    hq_j, sh_j = jquant.quantize_taps(int8_taps)
    hq_t, sh_t = tquant.quantize_taps(int8_taps)
    np.testing.assert_array_equal(hq_t, hq_j)
    assert sh_t == sh_j
    x = np.random.default_rng(7).standard_normal(20_000).astype(np.float32)
    xq_j, sx_j = jquant.quantize_signal(x)
    xq_t, sx_t = tquant.quantize_signal(torch.from_numpy(x))
    assert sx_t == sx_j and xq_t.dtype == torch.int8
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    assert torch.equal(tquant.quantize_signal(x, device=CPU)[0], xq_t)


@pytest.mark.parametrize("ratio", INT8_RATIOS, ids=_ids(INT8_RATIOS))
def test_int8_equals_jax_and_integer_oracle(int8_taps, ratio):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(2000).astype(np.float32) * 0.4
    xq, sx = jquant.quantize_signal(x)
    xq = np.array(xq)
    hq, _ = jquant.quantize_taps(int8_taps)
    # the int32 accumulators
    jp = mr.make_kernel(hq, ratio=ratio)
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), jnp.int8),
                              jnp.asarray(xq), path="supercycle")
    f = tquant.QuantizedFIRFilter(int8_taps, ratio, x_scale=sx, device=CPU)
    assert f.params.bank.dtype == torch.int8
    acc, ct, _ = mt.filt_block(f.params,
                               mt.init_state(f.params, (), torch.int8),
                               torch.from_numpy(xq))
    assert acc.dtype == torch.int32 and ct == int(cj)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(yj)[:ct])
    ref = _upfirdn_int(hq, xq, ratio)
    np.testing.assert_array_equal(acc.numpy().astype(np.float64), ref[:ct])
    assert torch.equal(mt.filt(hq, torch.from_numpy(xq), ratio), acc)
    # the dequantized output: the same float32 product as JAX's
    yf = f.filt(xq)
    jf = jquant.QuantizedFIRFilter(int8_taps, ratio, x_scale=sx)
    np.testing.assert_array_equal(yf.numpy(), np.asarray(jf.filt(xq)))


@pytest.mark.parametrize("ratio", INT8_RATIOS, ids=_ids(INT8_RATIOS))
def test_int8_streaming_bit_exact(int8_taps, ratio):
    x = np.random.default_rng(8).standard_normal(3000).astype(np.float32)
    xq, sx = tquant.quantize_signal(torch.from_numpy(x * 0.4))
    whole = tquant.QuantizedFIRFilter(int8_taps, ratio, x_scale=sx,
                                      device=CPU)
    yw = whole.filt(xq)
    f = tquant.QuantizedFIRFilter(int8_taps, ratio, x_scale=sx, device=CPU)
    yc = torch.cat([f.filt(xq[i:i + 701]) for i in range(0, 3000, 701)])
    assert torch.equal(yc, yw)
    assert (f.state.phase, f.state.deficit) == (whole.state.phase,
                                                whole.state.deficit)
    assert f.state.history.dtype == torch.int8
    assert torch.equal(f.state.history, whole.state.history)


def test_int8_matches_jax_zero_copy_interpret():
    from multirate_tpu.ops import indexing as jidx
    from multirate_tpu.ops.compute import _out_dtype, _zc_plan

    h = (mr.firdes(24 * 21, 0.5 / 21, mr.kaiser, beta=7.0) * 21
         ).astype(np.float32)
    x = np.random.default_rng(9).standard_normal(80_000).astype(np.float32)
    hq, _ = jquant.quantize_taps(h)
    xq, _ = jquant.quantize_signal(x)
    ratio = Fraction(147, 160)
    jp = mr.make_kernel(hq, ratio=ratio)
    assert _zc_plan(jp, xq, _out_dtype(jp, xq),
                    jidx.max_outputs(jp, xq.shape[-1])) is not None
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), jnp.int8), xq,
                              path="pallas")
    tp = mt.make_kernel(hq, ratio=ratio, device=CPU)
    yt, ct, _ = mt.filt_block(tp, mt.init_state(tp, (), torch.int8),
                              torch.from_numpy(np.array(xq)))
    assert ct == int(cj)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj)[:ct])


def test_int8_cascade_output(int8_taps):
    """out="int8" re-quantizes stochastically: within one LSB of the exact
    output over ``out_scale``, and a cascade-grade SNR. The two packages'
    generators differ, so the input is the same pre-quantized block."""
    x = np.random.default_rng(7).standard_normal(2000).astype(np.float32)
    xq, sx = jquant.quantize_signal(x * 0.4)
    xq = np.asarray(xq)
    ratio = Fraction(1, 1)
    g = torch.Generator().manual_seed(3)
    f = tquant.QuantizedFIRFilter(int8_taps, ratio, x_scale=sx, out="int8",
                                  generator=g, device=CPU)
    yq = f.filt(xq)
    assert yq.dtype == torch.int8
    exact = np.asarray(jquant.QuantizedFIRFilter(
        int8_taps, ratio, x_scale=sx).filt(xq), np.float64) / f.out_scale
    assert np.abs(yq.numpy() - exact).max() <= 1.0
    yf = np.asarray(mr.filt(int8_taps, (x * 0.4).astype(np.float64), ratio))
    err = yq.numpy() * f.out_scale - yf
    assert 10 * np.log10(np.mean(yf ** 2) / np.mean(err ** 2)) > 30


def test_stochastic_round_unbiased_and_bounded():
    v = torch.linspace(-126.6, 126.6, 1001)
    g = torch.Generator().manual_seed(0)
    qs = torch.stack([tquant.stochastic_round_int8(v, g)
                      for _ in range(400)]).double()
    assert float((qs - v.double()).abs().max()) <= 1.0
    # unbiased: the mean of 400 draws (std err about 0.5/20) tracks v
    assert float((qs.mean(0) - v.double()).abs().max()) < 0.12
    # one seed, one draw
    a = tquant.stochastic_round_int8(v, torch.Generator().manual_seed(5))
    b = tquant.stochastic_round_int8(v, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def test_quantize_signal_stochastic_path():
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(512).astype(np.float32))
    q1, s1 = tquant.quantize_signal(x, generator=torch.Generator()
                                    .manual_seed(1))
    q2, s2 = tquant.quantize_signal(x)
    assert s1 == s2
    assert int((q1.int() - q2.int()).abs().max()) <= 1


def test_filt_int8_snr_against_float_reference():
    h = np.asarray(mr.firdes(147, 0.2, mr.kaiser, beta=7.0))
    x = np.random.default_rng(7).standard_normal(5000).astype(np.float32)
    for ratio in (Fraction(1, 1), Fraction(147, 160)):
        y8, sx, sh = tquant.filt_int8(h, x * 0.5, ratio, device=CPU)
        yf = np.asarray(mr.filt(h, (x * 0.5).astype(np.float64), ratio))
        assert y8.shape == yf.shape
        err = y8.numpy() - yf
        snr = 10 * np.log10(np.mean(yf ** 2) / np.mean(err ** 2))
        assert snr > 35, (ratio, snr)


def test_quantized_filter_rejects():
    h = np.ones(140_000)  # 140 000 * 128 * 127 >= 2^31
    with pytest.raises(ValueError, match="int32"):
        tquant.QuantizedFIRFilter(h, 1, x_scale=1.0, device=CPU)
    with pytest.raises(ValueError, match="out"):
        tquant.QuantizedFIRFilter(np.ones(8), 1, x_scale=1.0, out="int4",
                                  device=CPU)
    f = tquant.QuantizedFIRFilter(np.ones(8), (3, 2), x_scale=1.0,
                                  device=CPU)
    with pytest.raises(TypeError, match="int8"):
        f.filt(torch.zeros(10))


# --------------------------------------------------------------------------- #
# Narrow stores
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ratio", [Fraction(4, 1), Fraction(147, 160)],
                         ids=["4_1", "147_160"])
def test_store_dtype_bf16_matches_jax(ratio):
    h = np.asarray(mr.firdes(147, 0.2, mr.kaiser, beta=7.0), np.float32)
    x = np.random.default_rng(7).standard_normal(20_000).astype(np.float32)
    jp = mr.make_kernel(h, ratio=ratio, store_dtype=jnp.bfloat16)
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), jnp.float32), x,
                              path="supercycle")
    tp = mt.make_kernel(h, ratio=ratio, store_dtype=torch.bfloat16,
                        device=CPU)
    assert tp.store_dtype == torch.bfloat16
    yt, ct, _ = mt.filt_block(tp, mt.init_state(tp), torch.from_numpy(x))
    assert yt.dtype == torch.bfloat16 and ct == int(cj)
    want = torch.from_numpy(np.asarray(yj)[:ct].astype(np.float32))
    assert ulps_apart(yt, want, torch.bfloat16,
                      TOL_BF16 * float(want.abs().max())) <= 1
    f32 = mt.make_kernel(h, ratio=ratio, device=CPU)
    y32, _, _ = mt.filt_block(f32, mt.init_state(f32), torch.from_numpy(x))
    assert torch.equal(yt, y32.to(torch.bfloat16))


@pytest.mark.parametrize("mode,store", [
    ("f32", torch.float16), ("bf16", torch.bfloat16),
    ("bf16", torch.float16), ("int8", torch.bfloat16)])
def test_store_dtype_in_every_mode(mode, store):
    """The store type is the output type in every mode: the float modes
    round their float32 accumulators once, the int8 mode casts its int32
    ones at the end, as JAX does outside its zero-copy path."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.standard_normal(90).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 5000)).astype(np.float32))
    if mode == "bf16":
        h, x = h.bfloat16(), x.bfloat16()
    elif mode == "int8":
        h, x = (torch.round(t * 25).to(torch.int8) for t in (h, x))
    for ratio in (Fraction(3, 5), Fraction(1, 1)):
        natural = mt.make_kernel(h, ratio=ratio)
        narrow = mt.make_kernel(h, ratio=ratio, store_dtype=store)
        y0, c0, s0 = mt.filt_block(natural, mt.init_state(
            natural, (2,), x.dtype), x)
        y1, c1, s1 = mt.filt_block(narrow, mt.init_state(
            narrow, (2,), x.dtype), x)
        assert y1.dtype == store and c1 == c0
        assert torch.equal(y1, y0.to(store))
        assert torch.equal(s1.history, s0.history)


def test_store_dtype_rules():
    h = np.ones(8, np.float32)
    with pytest.raises(ValueError, match="rational family"):
        mt.make_kernel(h, rate=1.3, store_dtype=torch.bfloat16, device=CPU)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        mt.make_kernel(h, ratio=2, store_dtype=torch.float32, device=CPU)
    for name in (jnp.bfloat16, np.float16, "bfloat16"):
        p = mt.make_kernel(h, ratio=2, store_dtype=name, device=CPU)
        assert p.store_dtype in (torch.bfloat16, torch.float16)
    assert mt.make_kernel(h, ratio=2, device=CPU).store_dtype is None


# --------------------------------------------------------------------------- #
# Converters and mixed operands
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_convert_round_trips_quantized(bf16_data, mode):
    hb, xb, _, _ = bf16_data
    ratio = Fraction(147, 160)
    if mode == "bf16":
        h, x, jdt, tdt = hb, jnp.asarray(xb), jnp.bfloat16, torch.bfloat16
    else:
        h, _ = jquant.quantize_taps(hb.astype(np.float64))
        xq, _ = jquant.quantize_signal(xb.astype(np.float32))
        x, jdt, tdt = jnp.asarray(xq), jnp.int8, torch.int8
    jp = mr.make_kernel(h, ratio=ratio, store_dtype=None)
    tp = convert.params_from_jax(_jax_fields(jp), device=CPU)
    ref = mt.make_kernel(h, ratio=ratio, device=CPU)
    assert type(tp) is mt.FIRRational and tp.bank.dtype == tdt
    assert torch.equal(tp.bank, ref.bank) and tp.store_dtype is None
    js = mr.setphase(jp, mr.init_state(jp, (), jdt), 0.37)
    _, _, js = mr.filt_block(jp, js, x[:20_011], path="supercycle")
    ts = convert.state_from_jax(tp, np.asarray(js.history), int(js.phase),
                                int(js.deficit))
    assert ts.history.dtype == tdt
    # the port computes what JAX computes from the converted state
    yj, cj, sj = mr.filt_block(jp, js, x[20_011:], path="supercycle")
    yt, ct, st = mt.filt_block(tp, ts, torch.from_numpy(
        np.asarray(x[20_011:]).astype(np.float32)).to(tdt))
    assert ct == int(cj)
    if mode == "int8":
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj)[:ct])
    else:
        assert _rel_max(yt, np.asarray(yj)[:ct]) <= TOL_BF16
    # and back: JAX continues from the port's state as from its own
    hist, phase, deficit = convert.state_to_jax(st, jp.history_len)
    back = mr.FilterState(history=jnp.asarray(hist, jdt),
                          phase=jnp.asarray(phase),
                          deficit=jnp.asarray(deficit))
    tail = x[:777]
    y_back, _, _ = mr.filt_block(jp, back, tail, path="supercycle")
    y_own, _, _ = mr.filt_block(jp, sj, tail, path="supercycle")
    np.testing.assert_array_equal(np.asarray(y_back), np.asarray(y_own))


def test_params_from_jax_carries_store_dtype():
    h = np.asarray(mr.firdes(147, 0.2, mr.kaiser, beta=7.0), np.float32)
    jp = mr.make_kernel(h, ratio=Fraction(4, 1), store_dtype=jnp.bfloat16)
    tp = convert.params_from_jax(_jax_fields(jp), device=CPU)
    assert type(tp) is mt.FIRInterpolator
    assert tp.store_dtype == torch.bfloat16
    assert tp.bank.dtype == torch.float32


@pytest.mark.parametrize("pair", ["bf16_f32", "f32_bf16", "int8_f32",
                                  "int8_bf16"])
def test_mixed_operands_run_float32(pair):
    """Taps and signal of different types run the float32 mode on upcast
    operands (JAX promotes them to float32 or bf16, whose products of
    these values are exact in float32 too)."""
    rng = np.random.default_rng(5)
    hf = np.round(rng.standard_normal(60) * 20).astype(np.float32)
    xf = np.round(rng.standard_normal(3000) * 20).astype(np.float32)
    cast = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}
    th, tx = (cast[k] for k in pair.split("_"))
    h, x = torch.from_numpy(hf).to(th), torch.from_numpy(xf).to(tx)
    y = mt.filt(h, x, Fraction(3, 5))
    assert y.dtype == torch.float32
    y32 = mt.filt(torch.from_numpy(hf), torch.from_numpy(xf), Fraction(3, 5))
    assert torch.equal(y, y32)


# --------------------------------------------------------------------------- #
# The wrapper's modes and entry points
# --------------------------------------------------------------------------- #

def test_ulps_apart():
    a = torch.tensor([1.0, 1.5, -3.0, 0.0, 2.0 ** -140])
    b = a + torch.tensor([2.0 ** -7, 2.0 ** -7, -2.0 ** -6, 0.0,
                          2.0 ** -133])
    assert ulps_apart(a, b, torch.bfloat16) == 1.0
    assert ulps_apart(a, a + 2 * (b - a), torch.bfloat16) == 2.0
    # near zero the floor, not the tiny ulp, is the unit
    tiny = torch.tensor([1e-9])
    assert ulps_apart(tiny, 2 * tiny, torch.bfloat16) > 50  # ulp 2^-36 at 2e-9
    assert ulps_apart(tiny, 2 * tiny, torch.bfloat16, 1e-6) <= 1e-3
    assert ulps_apart(torch.tensor([1.0]), torch.tensor([1 + 2.0 ** -10]),
                      torch.float16) == 1.0


def test_entry_points_match_the_source():
    """Every (signal, taps, output) triple the wrapper launches is an entry
    point that csrc/polyphase.cu instantiates with those types."""
    src = (build.CSRC_DIR / "polyphase.cu").read_text()
    ctype = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
             torch.float16: "__half", torch.int8: "int8_t",
             torch.int32: "int32_t", torch.float64: "double",
             torch.complex64: "float2", torch.complex128: "double2",
             torch.int16: "int16_t", torch.uint8: "uint8_t",
             torch.int64: "int64_t"}
    assert src.count("MR_POLYPHASE(") - 1 == len(pp.ENTRIES)  # + #define
    for types, name in pp.ENTRIES.items():
        assert (f"MR_POLYPHASE({name}, "
                + ", ".join(ctype[t] for t in types) + ")") in src
    assert set(pp.launches) == set(pp.ENTRIES.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_wrapper_modes_on_cpu(dtype):
    g = torch.Generator().manual_seed(1)
    x, hist, bank = (torch.randint(-127, 128, s, generator=g).to(dtype)
                     for s in ((2, 400), (2, 6), (7, 3)))
    n = mt.outputlength(400, Fraction(3, 2))
    before = dict(pp.launches)
    y = pp.polyphase(x, hist, bank, 3, 2, 1, 1, n)
    assert pp.launches == before
    assert y.dtype == pp.ACCUMULATOR[dtype]
    # by hand, in int64
    xext = torch.cat([hist, x], -1).long()
    want = torch.stack([xext[:, (k * 2) // 3:(k * 2) // 3 + 7]
                        @ bank[:, (k * 2) % 3].long() for k in range(n)], -1)
    assert torch.equal(y.long(), want)
    with pytest.raises(TypeError):  # float32 taps are a narrow read
        pp.polyphase(x, hist, bank.double(), 3, 2, 1, 1, n)
    with pytest.raises(TypeError):
        pp.polyphase(x, hist, bank, 3, 2, 1, 1, n, out_dtype=torch.float64)
    if dtype == torch.int8:
        with pytest.raises(TypeError):
            pp.polyphase(x, hist, bank, 3, 2, 1, 1, n,
                         out_dtype=torch.bfloat16)


# --------------------------------------------------------------------------- #
# The device default: the card unless the caller names the CPU
# --------------------------------------------------------------------------- #

def test_device_default_without_a_card_raises(monkeypatch, bf16_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = np.ones(24, np.float32)
    x = np.zeros(100, np.float32)
    for call in (lambda: mt.make_kernel(h, ratio=Fraction(3, 2)),
                 lambda: mt.make_kernel(h, rate=0.9),
                 lambda: mt.filt(h, x, Fraction(3, 2)),
                 lambda: mt.FIRFilter(h, Fraction(3, 2)).filt(x),
                 lambda: tquant.quantize_signal(x),
                 lambda: convert.params_from_jax(_jax_fields(
                     mr.make_kernel(h, ratio=Fraction(3, 2))))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # named, or torch tensors: their device
    assert mt.make_kernel(h, ratio=2, device=CPU).device.type == "cpu"
    assert mt.make_kernel(torch.from_numpy(h), ratio=2).device.type == "cpu"
    assert mt.filt(h, torch.from_numpy(x), 2).device.type == "cpu"


def test_device_default_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tparams.default_device() == torch.device("cuda")
    asked = []

    def spy_to(t, device, dtype=None):  # records, then builds on the CPU
        asked.append(torch.device(device))
        return torch.as_tensor(t, dtype=dtype).contiguous()

    def spy_tensor(a, device=None):
        asked.append(torch.device(device))
        return tparams.to_tensor(a)

    monkeypatch.setattr(tparams, "_to", spy_to)
    monkeypatch.setattr(convert, "to_tensor", spy_tensor)
    monkeypatch.setattr(tapi, "to_tensor", spy_tensor)
    h = np.ones(24, np.float32)
    mt.make_kernel(h, ratio=Fraction(3, 2))
    mt.make_kernel(h, ratio=Fraction(1, 4), store_dtype=torch.bfloat16)
    convert.params_from_jax(_jax_fields(mr.make_kernel(h, ratio=4)))
    assert asked == [torch.device("cuda")] * 3
    # a numpy signal asks for the card, and its kernel follows the signal
    # (which the spy left on the CPU)
    asked.clear()
    mt.filt(h, np.zeros(100, np.float32), Fraction(3, 2))
    assert asked == [torch.device("cuda"), torch.device("cpu")]
