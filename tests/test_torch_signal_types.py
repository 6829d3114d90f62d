"""Every signal and tap type the JAX package takes, on the CPU.

The port gives JAX's output type (``_out_dtype``: ``jnp.promote_types`` of
taps and signal under x64, float32 for bfloat16) and JAX's values for
16-bit PCM, uint8, float16, the other integers and bool, against float32,
float64, float16 and bfloat16 taps, in all six filter families; narrow
signals keep a history of their own type; integer taps with integer
signals give JAX's integer type.

References, on the same seeded values:
- JAX ``windows``; for the rational family ``supercycle`` where the
  signal or the taps are bfloat16 (JAX's ``windows`` rounds bf16 products
  and sums to bf16, ROADMAP queue 3);
- at an arbitrary or Farrow rate, JAX's TPU route where ``windows``
  rounds in a narrow type: a bfloat16 signal widened to float32
  (``pallas/select3.py:344``; ``windows`` rounds its products to bf16),
  and bfloat16 or float16 arbitrary banks widened to float32 for a float32
  or wider output (``pfb.astype(dt)`` before the TPU kernel; ``windows``
  rounds each interpolated tap to the taps' type). The float16 banks also
  against JAX ``winsel``, the TPU kernel in interpret mode.

Tolerances:
- float32 outputs: max|dy| <= 1e-5 * max|y| (float32 sums in another
  order; at most 3.3e-7 seen);
- float64: 1e-12 * max|y|;
- float16 outputs: one float16 ulp of max|y| (JAX rounds the samples, the
  taps or the interpolated taps to float16 before its dot; the port widens
  them exactly and rounds once, at the store);
- float16 taps at a rate, against JAX ``winsel``: 1e-5 * max|y| (the TPU
  kernel packs alpha into fewer bits, 4.2e-6 here), against the widened
  banks 1e-6;
- integer outputs, counts, states and chunked against whole: exact;
- integer taps at a rate, against the float64 oracle: relative RMS
  <= 1e-6 (the port's exact taps; JAX truncates alpha to 0 there);
- the sharded path on two gloo ranks against the port's ``filt``: exact;
  against JAX ``windows`` unsharded: 1e-5 * max|y| (float32 outputs).
"""

import dataclasses
import functools
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu.ops import compute as jcompute
from multirate_tpu_torch.ops import dtypes
from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow
from multirate_tpu_torch.utils.testing import rel_max_err

CPU = "cpu"
FAMILIES = {
    "standard": {"ratio": Fraction(1, 1)},
    "interpolator": {"ratio": Fraction(4, 1)},
    "decimator": {"ratio": Fraction(1, 4)},
    "rational": {"ratio": Fraction(7, 5)},
    "arbitrary": {"rate": 0.77, "nphi": 8},
    "farrow": {"rate": 0.4709, "nphi": 8, "polyorder": 3},
}
SIGNALS = ["int16", "uint16", "int32", "int64", "uint8", "bool", "float16",
           "bfloat16", "int8"]
TAPS = ["float32", "float64", "float16", "bfloat16"]
LATTICE = ["bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
           "int32", "int64", "float16", "bfloat16", "float32", "float64",
           "complex64", "complex128"]
N = 1500
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@functools.cache
def _taps():
    return mr.firdes(96, 0.1, mr.kaiser, beta=7.0) * 4


def _np_signal(name, shape, seed=0):
    """Seeded samples of type ``name`` (numpy; bfloat16 as JAX's), with
    sums that stay inside float16's range."""
    v = np.random.default_rng(seed).standard_normal(shape)
    if name == "bool":
        return v > 0
    if name == "uint8":
        return (np.abs(v) * 60).astype(np.uint8)
    if name == "uint16":
        return (np.abs(v) * 1500).astype(np.uint16)
    if name == "int8":
        return np.clip(v * 40, -127, 127).astype(np.int8)
    if name in ("int16", "int32", "int64"):
        return (v * 1500).astype(name)
    return np.asarray(jnp.asarray(v, getattr(jnp, name)))


def _torch(a):
    """A numpy array (bfloat16 ones as JAX hands them over) as a tensor."""
    return mt.ops.params.to_tensor(a)


def _jax_taps(name, h=None):
    return np.asarray(jnp.asarray(_taps() if h is None else h,
                                  getattr(jnp, name)))


def _jax_reference(fam, jp, xs, sig, tap):
    """(y, count) of JAX's reference route for this cell (module
    docstring)."""
    rate = "rate" in FAMILIES[fam]
    xj, path = jnp.asarray(xs), "windows"
    if not rate and "bfloat16" in (sig, tap):
        path = "supercycle"
    if rate and sig == "bfloat16":
        xj = xj.astype(jnp.float32)
    dt = jcompute._out_dtype(jp, jnp.zeros((), xs.dtype))
    if (fam == "arbitrary" and tap in ("bfloat16", "float16")
            and dt != jnp.float16):
        jp = dataclasses.replace(jp, pfb=jp.pfb.astype(jnp.float32),
                                 dpfb=jp.dpfb.astype(jnp.float32))
    y, c, _ = mr.filt_block(jp, mr.init_state(jp, xs.shape[:-1], xj.dtype),
                            xj, path=path)
    return np.asarray(y)[..., :int(c)], int(c), np.dtype(dt)


def _f16_ulps(got, want):
    """max|got - want| in float16 ulps of max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    m = np.abs(want).max()
    return float(np.abs(got - want).max() / 2.0 ** (np.floor(np.log2(m))
                                                     - 10))


# --- the promotion table ---------------------------------------------------

@pytest.mark.parametrize("sig", LATTICE)
def test_promotion_matches_jax(sig):
    for tap in LATTICE:
        got = dtypes.promote_types(getattr(torch, tap), getattr(torch, sig))
        want = jnp.promote_types(getattr(jnp, tap), getattr(jnp, sig))
        assert str(got).removeprefix("torch.") == str(want), (tap, sig)
        out = dtypes.out_dtype(getattr(torch, tap), getattr(torch, sig))
        assert out == (torch.float32 if got == torch.bfloat16 else got)


# --- the type matrix -------------------------------------------------------

@pytest.mark.parametrize("sig", SIGNALS)
@pytest.mark.parametrize("tap", TAPS)
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_signal_and_tap_types_match_jax(fam, tap, sig):
    kw = FAMILIES[fam]
    jt = _jax_taps(tap)
    jp = mr.make_kernel(jt, **kw)
    tp = mt.make_kernel(_torch(jt), **kw, device=CPU)
    xs = _np_signal(sig, (N,))
    yj, cj, dt = _jax_reference(fam, jp, xs, sig, tap)
    x = _torch(xs)
    y, c, st = mt.filt_block(tp, mt.init_state(tp, (), x.dtype), x)
    assert str(y.dtype).removeprefix("torch.") == dt.name
    assert c == cj and st.history.dtype == x.dtype
    if y.dtype == torch.float16:
        assert _f16_ulps(y.double(), yj) <= 1
    else:
        assert rel_max_err(y, yj) <= TOL[y.dtype]


@pytest.mark.parametrize("pair", [("int8", "int16"), ("int16", "int16"),
                                  ("uint8", "uint8"), ("bool", "bool"),
                                  ("int8", "uint8"), ("int16", "bool")],
                         ids="-".join)
@pytest.mark.parametrize("fam", ["standard", "interpolator", "decimator",
                                 "rational"])
def test_integer_outputs_wrap_as_jax(fam, pair):
    # JAX's windows path sums in the integer output type, wrapping; the
    # port's float64 sums are exact and wrap at the end: equal
    tap, sig = pair
    rng = np.random.default_rng(5)
    h = rng.integers(-100, 100, 48).astype(tap)
    xs = (rng.integers(-3000, 3000, N) if sig != "uint8"
          else rng.integers(0, 256, N)).astype(sig)
    jp = mr.make_kernel(h, **FAMILIES[fam])
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), xs.dtype),
                              jnp.asarray(xs), path="windows")
    tp = mt.make_kernel(_torch(h), **FAMILIES[fam], device=CPU)
    x = torch.from_numpy(xs)
    y, c, st = mt.filt_block(tp, mt.init_state(tp, (), x.dtype), x)
    yj = np.asarray(yj)[:int(cj)]
    assert c == int(cj) and str(y.dtype).removeprefix("torch.") == \
        yj.dtype.name
    assert np.array_equal(y.numpy(), yj)
    assert st.history.dtype == x.dtype


@pytest.mark.parametrize("sig", ["float32", "int16"])
@pytest.mark.parametrize("kind", ["arbitrary", "farrow"])
def test_integer_taps_at_a_rate_hold_the_float64_oracle(kind, sig):
    # JAX's integer banks truncate alpha to 0 (ROADMAP queue 3); the port
    # interpolates with the exact taps, as the float64 oracle does
    kw = FAMILIES[kind]
    h = np.round(_taps() * 1000).astype(np.int16)
    xs = _np_signal(sig if sig != "float32" else "float64", (N,))
    if sig == "float32":
        xs = xs.astype(np.float32)
    tp = mt.make_kernel(_torch(h), **kw, device=CPU)
    y = mt.filt_block(tp, mt.init_state(tp, (), _torch(xs).dtype),
                      _torch(xs))[0]
    jdt = jcompute._out_dtype(mr.make_kernel(h, **kw),
                              jnp.zeros((), xs.dtype))
    assert str(y.dtype).removeprefix("torch.") == np.dtype(jdt).name
    hf = h.astype(np.float64)
    ref = (naivefilt(hf, xs.astype(np.float64), kw["rate"], kw["nphi"])
           if kind == "arbitrary" else
           naivefilt_farrow(hf, xs.astype(np.float64), kw["rate"],
                            kw["nphi"], kw["polyorder"]))[:y.shape[-1]]
    if y.dtype.is_floating_point:
        d = y.double().numpy() - ref
        assert np.sqrt(np.mean(d * d) / np.mean(ref * ref)) <= 1e-6
    else:  # the nearest integer to the exact result, wrapped as JAX wraps
        d = y.numpy().astype(np.int64) - np.round(ref).astype(np.int64)
        assert set(np.unique(d % 65536)) <= {0, 1, 65535}


# --- float16 taps at a rate ------------------------------------------------

def test_float16_taps_at_a_rate_match_the_tpu_kernel():
    # JAX's float16 bank holds the taps and their differences rounded to
    # float16; the port's float32 table holds the same values, so it
    # agrees with JAX's TPU kernel (winsel, interpret mode)
    kw = FAMILIES["arbitrary"]
    h = (mr.firdes(64, 0.4, mr.kaiser, samplerate=8, beta=7.0) * 8
         ).astype(np.float16)
    xs = np.random.default_rng(1).standard_normal(3000).astype(np.float32)
    jp = mr.make_kernel(h, **kw)
    tp = mt.make_kernel(_torch(h), **kw, device=CPU)
    assert tp.tap_type == torch.float16
    assert np.array_equal(tp.dpfb.numpy(), np.asarray(jp.dpfb, np.float32))
    y = mt.filt_block(tp, mt.init_state(tp, (), torch.float32),
                      torch.from_numpy(xs))[0]
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), jnp.float32),
                              jnp.asarray(xs), path="winsel")
    assert y.dtype == torch.float32 and y.shape[-1] == int(cj)
    assert rel_max_err(y, np.asarray(yj)[:int(cj)]) <= 1e-5


@pytest.mark.parametrize("sig", ["float32", "complex64"])
def test_float16_taps_at_a_rate_match_jax_widened_banks(sig):
    kw = FAMILIES["arbitrary"]
    h = _jax_taps("float16")
    rng = np.random.default_rng(2)
    xs = rng.standard_normal(N).astype(np.float32)
    if sig == "complex64":
        xs = (xs + 1j * rng.standard_normal(N)).astype(np.complex64)
    jp = mr.make_kernel(h, **kw)
    jw = dataclasses.replace(jp, pfb=jp.pfb.astype(jnp.float32),
                             dpfb=jp.dpfb.astype(jnp.float32))
    yj, cj, _ = mr.filt_block(jw, mr.init_state(jw, (), xs.dtype),
                              jnp.asarray(xs), path="windows")
    tp = mt.make_kernel(_torch(h), **kw, device=CPU)
    x = torch.from_numpy(xs)
    y = mt.filt_block(tp, mt.init_state(tp, (), x.dtype), x)[0]
    assert y.dtype == x.dtype
    assert rel_max_err(y, np.asarray(yj)[:int(cj)]) <= 1e-6


# --- streaming and state in the narrow types ---------------------------------

@pytest.mark.parametrize("fam", list(FAMILIES))
def test_int16_chunked_equals_whole(fam):
    h = torch.from_numpy(_taps().astype(np.float32))
    xs = torch.from_numpy(_np_signal("int16", (2, 6000), seed=3))
    kw = FAMILIES[fam]
    spec = kw.get("ratio", kw.get("rate"))
    args = (kw.get("nphi", 32), kw.get("polyorder"))
    whole = mt.filt(h, xs, spec, *args, device=CPU)
    f = mt.FIRFilter(h, spec, *args, device=CPU)
    rng = np.random.default_rng(4)
    parts, i = [], 0
    while i < xs.shape[-1]:
        n = int(rng.integers(1, 900))
        parts.append(f.filt(xs[:, i:i + n]))
        i += n
        assert f.state.history.dtype == torch.int16
    assert torch.equal(torch.cat(parts, -1), whole)
    assert torch.equal(f.state.history, xs[:, xs.shape[-1]
                                           - f.params.h_min:])


@pytest.mark.parametrize("sig", ["int16", "uint8", "float16", "bfloat16",
                                 "int8"])
@pytest.mark.parametrize("tap", ["float32", "float16"])
def test_time_major_narrow_matches_channel_major(tap, sig):
    kw = FAMILIES["farrow"]
    tp = mt.make_kernel(_torch(_jax_taps(tap)), **kw, device=CPU)
    x = _torch(_np_signal(sig, (3, 2000), seed=6))
    st = mt.setphase(tp, mt.init_state(tp, (3,), x.dtype), 0.37)
    y, c, s = mt.filt_block(tp, st, x)
    yt, ct, stt = mt.filt_block_tm(tp, st, x.t().contiguous())
    assert ct == c and torch.equal(yt, y.t())
    assert torch.equal(stt.history, s.history)
    assert s.history.dtype == x.dtype
    assert (stt.phase, stt.deficit) == (s.phase, s.deficit)


def test_dat_to_cd_on_16bit_pcm():
    # 48,000 samples of 16-bit PCM in, 44,100 float32 samples out, as JAX's
    pcm = _np_signal("int16", (48_000,), seed=7)
    from multirate_tpu.models import DATToCD

    yj = np.asarray(DATToCD()(jnp.asarray(pcm)))
    m = mt.models.DATToCD(device=CPU)
    y = m(torch.from_numpy(pcm))
    assert y.dtype == torch.float32 and y.shape == (44_100,) == yj.shape
    assert m._filter.state.history.dtype == torch.int16
    assert rel_max_err(y, yj) <= 1e-5


def test_stream_takes_16bit_pcm():
    # the ring converts int16 PCM to float32 in [-1, 1), as JAX's does
    from multirate_tpu.io import StreamingResampler as JaxStream
    from multirate_tpu_torch.io import StreamingResampler

    pcm = _np_signal("int16", (30_000,), seed=8)
    h = (mr.firdes(24 * 21, 0.5 / 21, mr.kaiser, beta=7.0) * 21
         ).astype(np.float32)
    s = StreamingResampler(mt.FIRFilter(h, Fraction(21, 23), device=CPU),
                           block_size=4096)
    sj = JaxStream(mr.FIRFilter(h, Fraction(21, 23)), block_size=4096)
    outs, outs_j = [], []
    for i in range(0, len(pcm), 2500):
        s.push(pcm[i:i + 2500])
        sj.push(pcm[i:i + 2500])
        outs.append(s.pull())
        outs_j.append(np.asarray(sj.pull()))
    y = np.concatenate([*outs, s.flush()])
    yj = np.concatenate([*outs_j, np.asarray(sj.flush())])
    assert y.shape == yj.shape
    assert rel_max_err(y, yj) <= 1e-5


@pytest.mark.parametrize("sig", ["int16", "uint8", "float16", "uint16"])
@pytest.mark.parametrize("spec", [Fraction(147, 160), 0.77],
                         ids=["rational", "arbitrary"])
def test_converters_carry_narrow_histories(spec, sig):
    from multirate_tpu_torch.convert import (params_from_jax,
                                             state_from_jax, state_to_jax)

    h = (mr.firdes(24 * 21, 0.5 / 21, mr.kaiser, beta=7.0) * 21
         ).astype(np.float32)
    xs = _np_signal(sig, (6000,), seed=9)
    fj = mr.FIRFilter(h, spec)
    fj.filt(jnp.asarray(xs[:3001]))
    assert np.asarray(fj.state.history).dtype == xs.dtype
    jp = fj.params
    tp = params_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                          for k, v in vars(jp).items()}, device=CPU)
    st = state_from_jax(tp, np.asarray(fj.state.history),
                        int(fj.state.phase), int(fj.state.deficit))
    assert st.history.dtype == _torch(xs).dtype
    y, _, st2 = mt.filt_block(tp, st, _torch(xs[3001:]))
    yj = np.asarray(fj.filt(jnp.asarray(xs[3001:])))
    assert rel_max_err(y, yj) <= 1e-5
    hist, phase, deficit = state_to_jax(st2, jp.history_len)
    assert hist.dtype == xs.dtype
    assert np.array_equal(hist[..., -tp.h_min:],
                          np.asarray(fj.state.history)[..., -tp.h_min:])
    assert (int(phase), int(deficit)) == (int(fj.state.phase),
                                          int(fj.state.deficit))


@pytest.mark.parametrize("sig", ["int16", "uint8", "float16", "bfloat16"])
def test_checkpoint_files_carry_narrow_histories(sig, tmp_path):
    from multirate_tpu.utils import load_state as jax_load_state
    from multirate_tpu.utils import save_state as jax_save_state
    from multirate_tpu_torch.utils import load_state, save_state

    h = (mr.firdes(24 * 21, 0.5 / 21, mr.kaiser, beta=7.0) * 21
         ).astype(np.float32)
    xs = _np_signal(sig, (6000,), seed=10)
    x = _torch(xs)
    f = mt.FIRFilter(h, 1.2345, device=CPU)
    f.filt(x[:3001])
    path = str(tmp_path / "port.npz")
    save_state(path, f.state)
    y = f.filt(x[3001:])
    g = mt.FIRFilter(h, 1.2345, device=CPU)
    g.state = load_state(path, device=CPU)
    assert g.state.history.dtype == x.dtype
    assert torch.equal(g.filt(x[3001:]), y)
    # the file in JAX, and JAX's file in the port
    fj = mr.FIRFilter(h, 1.2345)
    fj.filt(jnp.asarray(xs[:10]))
    fj.state = jax_load_state(path)
    yj = np.asarray(fj.filt(jnp.asarray(xs[3001:]).astype(
        jnp.float32 if sig == "bfloat16" else xs.dtype)))
    assert rel_max_err(y, yj) <= 1e-5
    if sig != "bfloat16":  # numpy holds no bfloat16 for JAX to save
        jax_save_state(str(tmp_path / "jax.npz"), fj.state)
        back = load_state(str(tmp_path / "jax.npz"), device=CPU)
        assert back.history.dtype == x.dtype


@pytest.mark.parametrize("tap", ["float16", "int16", "bfloat16"])
@pytest.mark.parametrize("spec", [Fraction(7, 5), 0.77],
                         ids=["rational", "arbitrary"])
def test_params_from_jax_keep_the_taps_type(spec, tap):
    from multirate_tpu_torch.convert import params_from_jax

    h = (_jax_taps(tap) if tap != "int16"
         else np.round(_taps() * 1000).astype(np.int16))
    jp = mr.make_kernel(h, **({"ratio": spec} if isinstance(spec, Fraction)
                              else {"rate": spec, "nphi": 8}))
    tp = params_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                          for k, v in vars(jp).items()}, device=CPU)
    assert tp.tap_type == getattr(torch, tap)
    for sig in ("int8", "float32"):
        x = _torch(_np_signal(sig, (500,)))
        y = mt.filt_block(tp, mt.init_state(tp, (), x.dtype), x)[0]
        want = jcompute._out_dtype(jp, jnp.zeros((), x.numpy().dtype))
        assert str(y.dtype).removeprefix("torch.") == np.dtype(want).name


# --- the parallel layer ----------------------------------------------------

SHARD_SPECS = {"rat": {"ratio": Fraction(147, 160)},
               "arb": {"rate": 0.77, "nphi": 8}}


@functools.cache
def _shard_cases():
    cases, rng = [], np.random.default_rng(11)
    h = rng.standard_normal(147 * 6).astype(np.float32)
    for sig in ("int16", "uint8"):
        x = _np_signal(sig, (2, 3200), seed=12)
        for mesh in ((1, 2), (2, 1)):
            for name, kw in SHARD_SPECS.items():
                cases.append(dict(id=f"{sig}-{mesh[0]}x{mesh[1]}-{name}",
                                  mesh=mesh, kind="resample", h=h, x=x,
                                  kw=kw))
            cases.append(dict(id=f"{sig}-{mesh[0]}x{mesh[1]}-stream",
                              mesh=mesh, kind="stream", blocks=2, h=h, x=x,
                              kw=SHARD_SPECS["rat"]))
    return cases


@pytest.fixture(scope="module")
def shard_results():
    from multirate_tpu_torch.parallel.multihost import spawn_world
    from multirate_tpu_torch.utils.testing import sharded_cases

    return spawn_world(sharded_cases, 2, args=(_shard_cases(),),
                       device=CPU)


def _jax_unsharded(case):
    """JAX's ``windows`` output for a shard case, unsharded: one block, or
    two streamed super-blocks and the state after them."""
    jp = mr.make_kernel(case["h"], **case["kw"])
    x = jnp.asarray(case["x"])
    st = mr.init_state(jp, (2,), x.dtype)
    cuts = (0, 1600, 3200) if case["kind"] == "stream" else (0, 3200)
    ys = []
    for a, b in zip(cuts, cuts[1:]):
        y, c, st = mr.filt_block(jp, st, x[:, a:b], path="windows")
        ys.append(np.asarray(y)[:, :int(c)])
    return np.concatenate(ys, -1), st


@pytest.mark.parametrize("case", _shard_cases(), ids=lambda c: c["id"])
def test_sharded_narrow_signals_equal_filt(shard_results, case):
    # against the port's unsharded path exactly, and against JAX unsharded
    # at the float32 tolerance
    h, x = torch.from_numpy(case["h"]), torch.from_numpy(case["x"])
    params = mt.make_kernel(h, **case["kw"], device=CPU)
    if case["kind"] == "resample":
        want = mt.filt_block(params, mt.init_state(params, (2,), x.dtype),
                             x)[0]
    else:  # two streamed super-blocks, and the state after them
        f = mt.FIRFilter(h, case["kw"]["ratio"], device=CPU)
        want = torch.cat([f.filt(x[:, :1600]), f.filt(x[:, 1600:])], -1)
    yj, sj = _jax_unsharded(case)
    for rank in shard_results:
        got = rank[case["id"]]
        assert np.array_equal(got["y"], want.numpy())
        assert got["y"].dtype == yj.dtype == np.float32
        assert got["y"].shape == yj.shape
        assert rel_max_err(got["y"], yj) <= 1e-5
        if case["kind"] == "stream":
            hist, phase, deficit = got["state"]
            assert hist.dtype == case["x"].dtype
            assert np.array_equal(hist, f.state.history.numpy())
            assert (phase, deficit) == (f.state.phase, f.state.deficit)
            # JAX keeps a longer history; its last T - 1 samples are these
            assert np.array_equal(hist, np.asarray(sj.history)[
                :, -hist.shape[-1]:])
            assert (phase, deficit) == (int(sj.phase), int(sj.deficit))
