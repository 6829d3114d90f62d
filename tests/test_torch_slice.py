"""The port's main path end to end on the CPU, against the JAX package: the
48 kHz -> 44.1 kHz headline (147//160, 24*147 Kaiser taps, float32) through
``filt`` and the streaming ``FIRFilter``, the JAX <-> port converters, and
the import boundary.

Tolerances:
- counts, phase and deficit: exact (host integers on both sides);
- port vs JAX outputs: max|dy| <= 1e-5 * max|y| (both full float32 on the
  CPU; only the reduction order over the 24 taps of a phase differs);
- port chunked vs port whole: max|dy| <= 1e-6 * max|y| (the same per-output
  float32 dot; only the einsum's blocking may change with the block size);
- against the float64 ``naivefilt`` oracle: relative RMS <= 8e-5 (the
  JAX package's bench tripwire).
"""

import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu_torch.convert import state_from_jax, state_to_jax
from multirate_tpu_torch.utils.oracle import naivefilt

RATIO = Fraction(147, 160)
N = 48_000
TOL_JAX, TOL_CHUNKED, TOL_ORACLE = 1e-5, 1e-6, 8e-5
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def headline():
    h = (mr.firdes(24 * 147, 0.5 / 147, mr.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    x = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    return h, x, np.asarray(mr.filt(h, x, RATIO, path="windows"))


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_filt_matches_jax_and_oracle(headline):
    h, x, yj = headline
    y = mt.filt(h, torch.from_numpy(x), RATIO)
    assert y.dtype == torch.float32 and y.shape == (44_100,)
    assert _rel_max(y, yj) <= TOL_JAX
    assert _rel_max(y, mr.filt(h, x, RATIO)) <= TOL_JAX  # JAX auto path
    n = 10_000  # the oracle's first outputs: it is slow by design
    ref = naivefilt(h.astype(np.float64),
                    x[:mt.inputlength(n, RATIO)].astype(np.float64), RATIO)
    rel = np.sqrt(np.mean((y.numpy()[:n] - ref[:n]) ** 2)
                  / np.mean(ref[:n] ** 2))
    assert len(ref) >= n and rel <= TOL_ORACLE
    # numpy input with an explicit device, and the ratio as a tuple
    assert torch.equal(mt.filt(h, x, (147, 160), device="cpu"), y)


CHUNKINGS = {
    "pivot": [1237, N - 1237],
    "odd": [4097] * 11 + [N - 4097 * 11],
    "ones_then_odd": [1] * 500 + [31_013, N - 500 - 31_013],
    "ragged": [0, 7, 1, 160, 147, 9_999, N - 10_314],
}


@pytest.mark.parametrize("chunking", list(CHUNKINGS))
def test_firfilter_chunked_matches_jax(headline, chunking):
    h, x, yj = headline
    chunks = CHUNKINGS[chunking]
    assert sum(chunks) == N
    f, fj = mt.FIRFilter(h, RATIO), mr.FIRFilter(h, RATIO)
    parts, i = [], 0
    for c in chunks:
        y = f.filt(torch.from_numpy(x[i:i + c]))
        yjc = np.asarray(fj.filt(x[i:i + c]))
        assert y.shape == yjc.shape
        assert (f.state.phase, f.state.deficit) == (fj._hphase,
                                                    fj._hdeficit)
        parts.append(y)
        i += c
    yc = torch.cat(parts)
    assert _rel_max(yc, yj) <= TOL_JAX
    assert _rel_max(yc, mt.filt(h, torch.from_numpy(x), RATIO)) \
        <= TOL_CHUNKED
    np.testing.assert_array_equal(
        f.history.numpy(), x[N - f.params.h_min:])


def test_setphase_and_reset_match_jax(headline):
    h, x, _ = headline
    f, fj = mt.FIRFilter(h, RATIO), mr.FIRFilter(h, RATIO)
    f.setphase(0.37)
    fj.setphase(0.37)
    assert f.state.phase == int(fj.state.phase) == 55
    y = f.filt(torch.from_numpy(x[:20_000]))
    assert _rel_max(y, fj.filt(x[:20_000])) <= TOL_JAX
    assert f.outputlength(999) == fj.outputlength(999)
    assert f.inputlength(999) == fj.inputlength(999)
    f.reset()
    assert (f.state.phase, f.state.deficit) == (1, 1)
    assert not f.state.history.any()
    fresh = mt.FIRFilter(h, RATIO)
    assert torch.equal(f.filt(torch.from_numpy(x[:5_000])),
                       fresh.filt(torch.from_numpy(x[:5_000])))
    st = mt.reset(f.params, f.state)
    assert (st.phase, st.deficit, st.history.shape) == (1, 1, (23,))
    with pytest.raises(ValueError, match="phase"):
        f.setphase(1.5)
    with pytest.raises(TypeError, match="setphase"):
        mt.setphase(mt.make_kernel(h, ratio=1, device="cpu"), st, 0.5)


def test_firfilter_channels_and_devices(headline, monkeypatch):
    h, x, _ = headline
    xs = np.stack([x[:9_000], x[9_000:18_000]])
    f = mt.FIRFilter(h, RATIO, device="cpu")
    y = torch.cat([f.filt(xs[:, :4_001]), f.filt(xs[:, 4_001:])], dim=-1)
    for c in range(2):
        assert _rel_max(y[c], mt.filt(h, torch.from_numpy(xs[c]), RATIO)) \
            <= TOL_CHUNKED
    with pytest.raises(ValueError, match="batch shape"):
        f.filt(xs[0])
    with pytest.raises(ValueError, match="device"):
        f.filt(torch.zeros((2, 100), device="meta"))
    # a numpy input with no device runs on the card, never quietly on the
    # CPU: with no card it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        mt.FIRFilter(h, RATIO).filt(x[:100])
    with pytest.raises(RuntimeError, match="device"):
        mt.filt(h, x[:100], RATIO)


def test_convert_round_trips(headline):
    h, x, yj = headline
    jp = mr.make_kernel(h, ratio=RATIO)
    tp = mt.make_kernel(h, ratio=RATIO, device="cpu")
    js = mr.init_state(jp, (), jnp.float32)
    y0, c0, js = mr.filt_block(jp, js, jnp.asarray(x[:20_011]),
                               path="windows")
    # JAX -> port -> JAX: the history the filter needs survives both ways
    ts = state_from_jax(tp, np.asarray(js.history), int(js.phase),
                        int(js.deficit))
    hist, phase, deficit = state_to_jax(ts, jp.history_len)
    assert hist.shape == js.history.shape
    np.testing.assert_array_equal(hist[-tp.h_min:],
                                  np.asarray(js.history)[-tp.h_min:])
    ts2 = state_from_jax(tp, hist, phase, deficit)
    assert torch.equal(ts2.history, ts.history)
    assert (ts2.phase, ts2.deficit) == (ts.phase, ts.deficit)
    # a stream begun in JAX continues in the port, and one begun in the
    # port continues in JAX: both equal the whole-vector JAX output
    y1, c1, ts3 = mt.filt_block(tp, ts, torch.from_numpy(x[20_011:]))
    both = np.concatenate([np.asarray(y0)[:int(c0)], y1.numpy()])
    assert _rel_max(both, yj) <= TOL_JAX
    js_back = type(js)(history=jnp.asarray(hist), phase=jnp.asarray(phase),
                       deficit=jnp.asarray(deficit))
    y2, c2, _ = mr.filt_block(jp, js_back, jnp.asarray(x[20_011:]),
                              path="windows")
    assert int(c2) == c1
    assert _rel_max(np.asarray(y2)[:int(c2)], y1) <= TOL_JAX
    hist3, _, _ = state_to_jax(ts3, jp.history_len)
    np.testing.assert_array_equal(hist3[-tp.h_min:], x[N - tp.h_min:])


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multirate_tpu_torch as m\n"
        "for mod in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'multirate_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr

