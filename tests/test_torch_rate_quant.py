"""bfloat16 and int8 signals at an arbitrary or Farrow rate, on the CPU.

The port widens such a signal (and its history) to float32 before the
kernel and returns float32, as the JAX package's TPU route does
(``pallas/select3.py:344``). JAX's ``windows`` path would round the bf16
products to bf16 (``_row_contract``), so the reference here is JAX
``windows`` given the same values already widened to float32: the signal,
and the bank that JAX's ``make_kernel`` keeps for the taps (for bfloat16
taps, their values and their differences rounded to bfloat16).

Tolerances:
- port vs JAX ``windows`` on the widened values: max|dy| <= 1e-6 * max|y|
  (the same float32 dot; only the einsum's blocking differs);
- against the float64 oracles over the same bf16 or int8 values: relative
  RMS <= 1e-4 for arbitrary resampling at the reference's harness rate
  (the dh = [diff(h); 0] wrap floor, 7.8e-5) and <= 8e-5 otherwise;
- chunked vs whole and time-major vs channel-major: 1e-6 * max|y|;
- counts, accumulator and deficit: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow
from multirate_tpu_torch.utils.testing import rel_max_err

R_REF = 1.0 / 2.123456789
RATES = [R_REF, 0.4709, 0.9173]
KINDS = {"arbitrary": None, "farrow": 4}
N = 12_000
TOL_JAX, TOL_SAME, TOL_ORACLE, TOL_ORACLE_ARB_REF = 1e-6, 1e-6, 8e-5, 1e-4


@pytest.fixture(scope="module")
def taps():
    return (mr.firdes(320, 0.45, mr.kaiser, samplerate=32, beta=7.0) * 32
            ).astype(np.float32)


def _signal(dtype, shape=(N,), seed=0):
    """(the port's bf16 or int8 tensor, its values in float32)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "int8":
        t = torch.from_numpy(np.round(x / np.abs(x).max() * 127)
                             ).to(torch.int8)
    else:
        t = torch.from_numpy(x).to(torch.bfloat16)
    return t, t.float().numpy()


def _taps(taps, kind):
    """(taps for both packages, what JAX's make_kernel takes): float32,
    or bfloat16 (a torch tensor for the port, ml_dtypes for JAX)."""
    if kind == "f32":
        return taps, taps
    return torch.from_numpy(taps).to(torch.bfloat16), np.asarray(
        jnp.asarray(taps, jnp.bfloat16))


def _jax_widened(jtaps, rate, po):
    """JAX's kernel for ``jtaps`` with its banks widened to float32."""
    jp = mr.make_kernel(jtaps, rate=rate, nphi=32, polyorder=po)
    f32 = {"pfb": jp.pfb.astype(jnp.float32)}
    if po is None:
        f32["dpfb"] = jp.dpfb.astype(jnp.float32)
    return dataclasses.replace(jp, **f32)


CASES = [(k, r, s, t) for k in KINDS for r in RATES
         for s in ("bf16", "int8") for t in ("f32", "bf16")]


@pytest.mark.parametrize("kind,rate,sig,tap", CASES,
                         ids=[f"{k}-{r:.4g}-{s}-{t}taps"
                              for k, r, s, t in CASES])
def test_widened_matches_jax_windows(taps, kind, rate, sig, tap):
    po = KINDS[kind]
    ptaps, jtaps = _taps(taps, tap)
    x, xv = _signal(sig, (2, N // 2))
    tp = mt.make_kernel(ptaps, rate=rate, nphi=32, polyorder=po,
                        device="cpu")
    jp = _jax_widened(jtaps, rate, po)
    ts = mt.setphase(tp, mt.init_state(tp, (2,), x.dtype), 0.37)
    js = mr.setphase(jp, mr.init_state(jp, (2,), jnp.float32), 0.37)
    for lo, hi in ((0, 2500), (2500, N // 2)):
        yt, ct, ts = mt.filt_block(tp, ts, x[:, lo:hi])
        yj, cj, js = mr.filt_block(jp, js, jnp.asarray(xv[:, lo:hi]),
                                   path="windows")
        assert yt.dtype == torch.float32 and ct == int(cj)
        assert (ts.phase, ts.deficit) == (int(js.phase), int(js.deficit))
        assert ts.history.dtype == x.dtype
        np.testing.assert_array_equal(ts.history.float().numpy(),
                                      np.asarray(js.history))
        assert rel_max_err(yt, np.asarray(yj)[:, :ct]) <= TOL_JAX


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("sig", ["bf16", "int8"])
def test_oracle_over_the_same_values(taps, kind, sig):
    po = KINDS[kind]
    x, xv = _signal(sig)
    hb = torch.from_numpy(taps).to(torch.bfloat16)
    for rate in (R_REF, 0.4709):
        y = mt.filt(hb, x, rate, 32, po).numpy()
        p = mt.make_kernel(hb, rate=rate, nphi=32, polyorder=po)
        n = 4_000
        x_in = xv[:mt.inputlength(p, n)].astype(np.float64)
        h64 = hb.double().numpy()
        if po is None:
            ref = naivefilt(h64, x_in, rate, 32)
            limit = TOL_ORACLE_ARB_REF if rate == R_REF else TOL_ORACLE
        else:
            ref = naivefilt_farrow(h64, x_in, rate, 32, po)
            limit = TOL_ORACLE
        rms = np.sqrt(np.mean((y[:n] - ref[:n]) ** 2) / np.mean(ref[:n] ** 2))
        assert rms <= limit, (rate, rms)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("sig", ["bf16", "int8"])
def test_firfilter_carries_state_chunked_equals_whole(taps, kind, sig):
    po = KINDS[kind]
    x, _ = _signal(sig, seed=1)
    f = mt.FIRFilter(taps, R_REF, 32, po)
    parts = [f.filt(x[i:i + 997]) for i in range(0, N, 997)]
    whole = mt.filt(taps, x, R_REF, 32, po)
    yc = torch.cat(parts)
    assert yc.dtype == whole.dtype == torch.float32
    assert yc.shape == whole.shape
    assert rel_max_err(yc, whole) <= TOL_SAME
    assert (f.state.phase, f.state.deficit) == mt.ops.indexing.host_carry(
        f.params, 0, 1, N)[1:]
    assert f.history.dtype == x.dtype
    assert torch.equal(f.history, x[N - f.params.h_min:])


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("sig", ["bf16", "int8"])
def test_time_major_matches_channel_major(taps, kind, sig):
    po = KINDS[kind]
    x, _ = _signal(sig, (3, 4_000), seed=2)
    p = mt.make_kernel(taps, rate=0.9173, nphi=32, polyorder=po,
                       device="cpu")
    st = mt.setphase(p, mt.init_state(p, (3,), x.dtype), 0.37)
    yc, cc, sc = mt.filt_block(p, st, x)
    yt, ct, stt = mt.filt_block_tm(p, st, x.t().contiguous())
    assert yt.dtype == torch.float32 and ct == cc
    assert (stt.phase, stt.deficit) == (sc.phase, sc.deficit)
    assert torch.equal(stt.history, sc.history)
    assert rel_max_err(yt.t(), yc) <= TOL_SAME


def test_bf16_taps_bank_holds_jax_values(taps):
    hb = torch.from_numpy(taps).to(torch.bfloat16)
    jb = np.asarray(jnp.asarray(taps, jnp.bfloat16))
    a = mt.make_kernel(hb, rate=0.4709, device="cpu")
    ja = mr.make_kernel(jb, rate=0.4709)
    assert a.table.dtype == torch.float32
    np.testing.assert_array_equal(a.pfb.numpy(),
                                  np.asarray(ja.pfb, np.float32))
    np.testing.assert_array_equal(a.dpfb.numpy(),
                                  np.asarray(ja.dpfb, np.float32))
    f = mt.make_kernel(hb, rate=0.4709, polyorder=4, device="cpu")
    jf = mr.make_kernel(jb, rate=0.4709, polyorder=4)
    np.testing.assert_array_equal(f.pfb.numpy(),
                                  np.asarray(jf.pfb, np.float32))
    np.testing.assert_allclose(f.coeffs.numpy(), np.asarray(jf.coeffs),
                               rtol=1e-12, atol=1e-12)
