"""The last operand pairs the JAX package takes, on the CPU.

- Integer taps with an integer signal where either is a 32- or 64-bit
  integer. In the rational family the port gives JAX ``windows``' value
  exactly: the exact sum wrapped modulo 2^bits of the output type
  (``ops/compute.py``: the ``i32``/``i64`` words). At an arbitrary or
  Farrow rate it gives the nearest integer to the float64 sum, wrapped
  (JAX's own value there truncates alpha, ROADMAP queue 3).
- A real signal against complex taps, read as stored by the real-sample
  entries of both kernels (``f32c``, ``f64c``, ``s16c`` ...).

References, on the same seeded numpy values:
- JAX ``windows``; a bfloat16 signal as ``test_torch_signal_types.py``
  takes it (``supercycle`` in the rational family, widened to float32 at a
  rate: JAX's ``windows`` rounds bf16 products);
- a Python-int oracle (zero-stuff, filter, decimate over the integers) for
  the integer pairs and the plain version's int64 words;
- exact Python-int arithmetic of the arbitrary method (taps scaled by
  2^32) and the float64 Farrow oracle at a rate.

Tolerances:
- integer outputs, counts, states, chunked against whole: exact;
- float64 outputs of integer pairs (uint64 with a signed type): 1e-12 of
  max|y|;
- complex64 outputs: 1e-5 of max|y|, complex128 1e-12 (as the complex
  tests of ``test_torch_dtypes.py``);
- at a rate: |y - round(reference)| <= 1 + (T + 4) * 2^-51 * sum|x * tap|,
  wrapped: the nearest integer to a float64 sum of T products (and of
  the signal's cast), against a reference that is exact or rounds as
  much.
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
from multirate_tpu_torch.ops import compute, dtypes, indexing
from multirate_tpu_torch.ops.cuda import polyphase as pp
from multirate_tpu_torch.ops.cuda import resample as rs
from multirate_tpu_torch.utils.oracle import naivefilt_farrow
from multirate_tpu_torch.utils.testing import rel_max_err

CPU = "cpu"
RATIONAL = {"standard": Fraction(1, 1), "interpolator": Fraction(4, 1),
            "decimator": Fraction(1, 4), "rational": Fraction(3, 2)}
RATES = {"arbitrary": {"rate": 0.77, "nphi": 8},
         "farrow": {"rate": 0.4709, "nphi": 8, "polyorder": 3}}
SIGNALS = ["int8", "int16", "uint8", "uint16", "int32", "int64", "uint32",
           "uint64"]
TAPS = ["int16", "int32", "int64", "uint32"]
WIDE_PAIRS = [(t, s) for t in TAPS for s in SIGNALS
              if max(np.dtype(t).itemsize, np.dtype(s).itemsize) >= 4]
N, T = 400, 72


def _full_range(rng, dtype, shape):
    """Seeded values over the whole range of an integer type."""
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


def _exact(h, x, ratio):
    """The Python-int oracle: zero-stuff by L, the causal FIR over the
    integers, every M-th sample (object arrays of Python ints)."""
    L, M = ratio.numerator, ratio.denominator
    up = np.zeros(len(x) * L, dtype=object)
    up[::L] = [int(v) for v in x]
    y = np.zeros(len(up), dtype=object)
    for k, hk in enumerate(int(v) for v in h):
        y[k:] += hk * up[:len(up) - k]
    return y[::M]


def _wrapped(values, dtype):
    """Python ints modulo 2^bits of an integer type, as that type."""
    bits = np.dtype(dtype).itemsize * 8
    signed = np.issubdtype(dtype, np.signedinteger)
    out = []
    for v in values:
        v %= 1 << bits
        out.append(v - (1 << bits) if signed and v >= 1 << (bits - 1)
                   else v)
    return np.array(out, dtype=dtype)


def _jax_windows(h, xs, **kw):
    jp = mr.make_kernel(h, **kw)
    y, c, _ = mr.filt_block(jp, mr.init_state(jp, (), xs.dtype),
                            jnp.asarray(xs), path="windows")
    return np.asarray(y)[:int(c)], int(c)


def _port(h, xs, **kw):
    tp = mt.make_kernel(torch.from_numpy(h), **kw, device=CPU)
    x = mt.ops.params.to_tensor(xs)
    return mt.filt_block(tp, mt.init_state(tp, (), x.dtype), x)


# --- the integer pairs, rational family ------------------------------------

@pytest.mark.parametrize("pair", WIDE_PAIRS, ids="-".join)
@pytest.mark.parametrize("fam", list(RATIONAL))
def test_wide_integer_pairs_match_jax_windows(fam, pair):
    tap, sig = pair
    rng = np.random.default_rng(21)
    h, xs = _full_range(rng, tap, T), _full_range(rng, sig, N)
    yj, cj = _jax_windows(h, xs, ratio=RATIONAL[fam])
    y, c, st = _port(h, xs, ratio=RATIONAL[fam])
    assert c == cj and y.numpy().dtype == yj.dtype
    assert st.history.dtype == mt.ops.params.to_tensor(xs).dtype
    if yj.dtype.kind == "f":  # uint64 with a signed type: float64
        assert rel_max_err(y, yj) <= 1e-12
        return
    assert np.array_equal(y.numpy(), yj)
    # both are the exact sum wrapped to the output type
    exact = _exact(h, xs, RATIONAL[fam])[:c]
    assert np.array_equal(y.numpy(), _wrapped(exact, yj.dtype))


@pytest.mark.parametrize("pair", [("int32", "int32", 53),
                                  ("int64", "int64", 63),
                                  ("uint32", "uint64", 63),
                                  ("int64", "int8", 63)], ids=str)
def test_sums_past_2_53_and_2_63_are_wrapped_exactly(pair):
    # the data reach past 2^53 (float64's integers) and 2^63 (int64's):
    # the port keeps the exact sum's low bits, as JAX windows does
    tap, sig, past = pair
    rng = np.random.default_rng(22)
    h, xs = _full_range(rng, tap, T), _full_range(rng, sig, N)
    exact = _exact(h, xs, RATIONAL["rational"])
    assert max(abs(v) for v in exact) > 2 ** past
    y, c, _ = _port(h, xs, ratio=RATIONAL["rational"])
    yj, _ = _jax_windows(h, xs, ratio=RATIONAL["rational"])
    assert np.array_equal(y.numpy(), _wrapped(exact[:c], y.numpy().dtype))
    assert np.array_equal(y.numpy(), yj)


@pytest.mark.parametrize("word", [torch.int32, torch.int64])
def test_plain_words_wrap_as_the_integer_oracle(word):
    # the plain version's int64 products and sums wrap past 2^63; the low
    # bits equal the Python-int oracle's
    rng = np.random.default_rng(23)
    npw = np.int32 if word == torch.int32 else np.int64
    x, hist = _full_range(rng, npw, (2, 300)), _full_range(rng, npw, (2, 23))
    bank = _full_range(rng, npw, (24, 3))
    n = mt.outputlength(300, Fraction(3, 2))
    y = pp.polyphase(*(torch.from_numpy(a) for a in (x, hist, bank)), 3, 2,
                     1, 1, n)
    assert y.dtype == word == pp.accumulator(word, word)
    xext = np.concatenate([hist, x], -1)
    for c in range(2):
        exact = [sum(int(xext[c, (k * 2) // 3 + t]) * int(bank[t, k * 2 % 3])
                     for t in range(24)) for k in range(n)]
        assert max(abs(v) for v in exact) > 2 ** 63
        assert np.array_equal(y[c].numpy(), _wrapped(exact, npw))


def test_integer_route_reads_words_without_a_float_pass():
    # every integer output of the rational family but the int8 mode runs
    # i32 or i64 (bool: whether the int32 sum is nonzero); uint32 and
    # uint64 cross as views of their bits
    for tap in dtypes.INTEGERS:
        for sig in dtypes.INTEGERS:
            final = dtypes.out_dtype(tap, sig)
            r = compute._route(tap, tap, sig, True)
            if final not in dtypes.INTEGERS:
                continue
            if tap == sig == torch.int8:  # the quantized mode
                assert r.x is None and r.out == torch.int32
                continue
            assert r.bank == r.out == dtypes.word(final)
            assert (r.x or sig) == r.out
            assert (r.x, r.bank, r.out) in pp.ENTRIES or (
                (sig, r.bank, r.out) in pp.ENTRIES)
    u = torch.tensor([3_000_000_000, 7], dtype=torch.uint32)
    assert compute._cast(u, torch.int32).data_ptr() == u.data_ptr()


# --- the integer pairs at a rate ---------------------------------------------

def _arbitrary_exact(tp, xs):
    """The arbitrary method over the integers: sum x * (pfb * 2^32 +
    frac * dpfb), exact, and sum |x * tap| (float64), by output."""
    n, _, _ = indexing.host_carry(tp, 0, 1, len(xs))
    inp, phi, frac = (v.tolist() for v in indexing.accum_indices(
        tp.nphi, tp.delta_fx, 0, 1, n))
    xext = [0] * tp.h_min + [int(v) for v in xs]
    pfb, dpfb = tp.table[0].tolist(), tp.table[1].tolist()
    exact, scale = [], []
    for i, p, a in zip(inp, phi, frac):
        f = int(a * 2.0 ** 32)  # alpha's 32-bit fraction, exactly
        taps = [pfb[t][p] * (1 << 32) + f * dpfb[t][p]
                for t in range(tp.taps_per_phi)]
        w = xext[i - 1:i - 1 + tp.taps_per_phi]
        exact.append(sum(a * b for a, b in zip(w, taps)))
        scale.append(sum(abs(a * b) for a, b in zip(w, taps)) / 2.0 ** 32)
    return exact, np.array(scale)


def _abs_sums(tp, xs, n):
    """sum |x * tap| of each of the first ``n`` outputs, float64 taps."""
    inp, phi, frac = indexing.accum_indices(tp.nphi, tp.delta_fx, 0, 1, n)
    taps = rs._taps_plain(tp.astype(torch.float64), phi, frac).abs()
    xext = torch.cat([torch.zeros(tp.h_min, dtype=torch.float64),
                      torch.from_numpy(xs.astype(np.float64)).abs()])
    ind = (inp - 1)[:, None] + torch.arange(tp.taps_per_phi)[None, :]
    return (xext[ind] * taps).sum(-1).numpy()


def _bound(tp, scale):
    return 1 + (tp.taps_per_phi + 4) * 2.0 ** -51 * scale


def _signed_diff(y, ref, dtype):
    """y - ref modulo 2^bits of ``dtype``, as the nearest signed value."""
    bits = np.dtype(dtype).itemsize * 8
    return np.array([((int(a) - int(b) + (1 << (bits - 1))) % (1 << bits))
                     - (1 << (bits - 1)) for a, b in zip(y, ref)])


@pytest.mark.parametrize("pair", [("int32", "int16"), ("int16", "int32"),
                                  ("int64", "int8"), ("int32", "int32"),
                                  ("uint32", "uint16")], ids="-".join)
@pytest.mark.parametrize("kind", list(RATES))
def test_wide_integer_pairs_at_a_rate_are_the_nearest_integer(kind, pair):
    # below 2^53: the nearest integer to the exact result, but where the
    # float64 sum's rounding reaches across a half
    tap, sig = pair
    rng = np.random.default_rng(24)
    h = rng.integers(-2 ** 15 if tap[0] == "i" else 0, 2 ** 15, 80).astype(tap)
    xs = rng.integers(-2 ** 30 if sig[0] == "i" else 0, 2 ** 30, N).astype(
        sig) if np.dtype(sig).itemsize >= 4 else _full_range(rng, sig, N)
    y, _, st = _port(h, xs, **RATES[kind])
    out = dtypes.out_dtype(getattr(torch, tap), getattr(torch, sig))
    assert y.dtype == out and st.history.dtype == getattr(torch, sig)
    tp = mt.make_kernel(torch.from_numpy(h), **RATES[kind], device=CPU)
    if kind == "arbitrary":
        exact, scale = _arbitrary_exact(tp, xs)
        ref = [round(v / 2 ** 32) for v in exact]
    else:
        kw = RATES[kind]
        ref = [round(v) for v in naivefilt_farrow(
            h.astype(np.float64), xs.astype(np.float64), kw["rate"],
            kw["nphi"], kw["polyorder"])[:y.shape[-1]]]
        scale = _abs_sums(tp, xs, y.shape[-1])
    assert max(abs(v) for v in ref) < 2 ** 53
    d = _signed_diff(y.numpy(), ref, y.numpy().dtype)
    assert np.all(np.abs(d) <= _bound(tp, scale))


def test_integer_sums_past_2_53_at_a_rate_round_in_float64():
    # an int64 signal of 2^58-scale samples against int32 taps: the sums
    # pass 2^63 and wrap; each output is the nearest integer to the
    # float64 sum, off the exact result by up to its rounding (here
    # thousands), never more than the bound; the rounding shows
    rng = np.random.default_rng(25)
    h = rng.integers(-2 ** 31, 2 ** 31, 80).astype(np.int32)
    xs = rng.integers(-2 ** 58, 2 ** 58, N).astype(np.int64)
    y, _, _ = _port(h, xs, **RATES["arbitrary"])
    assert y.dtype == torch.int64
    tp = mt.make_kernel(torch.from_numpy(h), **RATES["arbitrary"],
                        device=CPU)
    exact, scale = _arbitrary_exact(tp, xs)
    assert max(abs(v) for v in exact) > 2 ** (63 + 32)
    d = _signed_diff(y.numpy(), [round(v / 2 ** 32) for v in exact],
                     np.int64)
    assert np.all(np.abs(d) <= _bound(tp, scale))
    assert np.abs(d).max() > 1


# --- streams, converters, checkpoints ---------------------------------------

@pytest.mark.parametrize("sig", ["int32", "int64", "uint32"])
@pytest.mark.parametrize("spec", [Fraction(7, 5), 0.77],
                         ids=["rational", "arbitrary"])
def test_wide_integer_streams_chunked_equal_whole(spec, sig):
    rng = np.random.default_rng(26)
    h = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, 60).astype(
        np.int16))
    xs = torch.from_numpy(_full_range(rng, sig, (2, 3000)))
    whole = mt.filt(h, xs, spec, 8, device=CPU)
    f = mt.FIRFilter(h, spec, 8, device=CPU)
    parts, i = [], 0
    while i < xs.shape[-1]:
        n = int(rng.integers(1, 500))
        parts.append(f.filt(xs[:, i:i + n]))
        i += n
        assert f.state.history.dtype == xs.dtype
    assert torch.equal(torch.cat(parts, -1), whole)
    assert torch.equal(f.state.history, xs[:, xs.shape[-1]
                                           - f.params.h_min:])


@pytest.mark.parametrize("sig", ["int32", "int64", "uint32"])
@pytest.mark.parametrize("spec", [Fraction(147, 160), 0.77],
                         ids=["rational", "arbitrary"])
def test_converters_carry_wide_integer_histories(spec, sig):
    from multirate_tpu_torch.convert import (params_from_jax,
                                             state_from_jax, state_to_jax)

    rng = np.random.default_rng(27)
    h = rng.integers(-2 ** 15, 2 ** 15, 24 * 21).astype(np.int16)
    xs = _full_range(rng, sig, 4000)
    kw = ({"ratio": spec} if isinstance(spec, Fraction)
          else {"rate": spec, "nphi": 8})
    jp = mr.make_kernel(h, **kw)
    _, _, js = mr.filt_block(jp, mr.init_state(jp, (), xs.dtype),
                             jnp.asarray(xs[:2001]), path="windows")
    assert np.asarray(js.history).dtype == xs.dtype
    tp = params_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                          for k, v in vars(jp).items()}, device=CPU)
    assert tp.tap_type == torch.int16
    st = state_from_jax(tp, np.asarray(js.history), int(js.phase),
                        int(js.deficit))
    assert st.history.dtype == mt.ops.params.to_tensor(xs).dtype
    y, _, st2 = mt.filt_block(tp, st, torch.from_numpy(xs[2001:]))
    yj, cj, js2 = mr.filt_block(jp, js, jnp.asarray(xs[2001:]),
                                path="windows")
    yj = np.asarray(yj)[:int(cj)]
    assert y.numpy().dtype == yj.dtype
    if isinstance(spec, Fraction):  # exact; at a rate JAX truncates alpha
        assert np.array_equal(y.numpy(), yj)
    hist, phase, deficit = state_to_jax(st2, jp.history_len)
    assert hist.dtype == xs.dtype
    assert np.array_equal(hist[..., -tp.h_min:],
                          np.asarray(js2.history)[..., -tp.h_min:])
    assert (int(phase), int(deficit)) == (int(js2.phase), int(js2.deficit))


@pytest.mark.parametrize("sig", ["int32", "int64", "uint32"])
def test_checkpoint_files_carry_wide_integer_histories(sig, tmp_path):
    from multirate_tpu.utils import load_state as jax_load_state
    from multirate_tpu.utils import save_state as jax_save_state
    from multirate_tpu_torch.utils import load_state, save_state

    rng = np.random.default_rng(28)
    h = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, 24 * 7).astype(
        np.int16))
    x = torch.from_numpy(_full_range(rng, sig, 5000))
    f = mt.FIRFilter(h, Fraction(7, 5), device=CPU)
    f.filt(x[:3001])
    path = str(tmp_path / "port.npz")
    save_state(path, f.state)
    y = f.filt(x[3001:])
    g = mt.FIRFilter(h, Fraction(7, 5), device=CPU)
    g.state = load_state(path, device=CPU)
    assert g.state.history.dtype == x.dtype
    assert torch.equal(g.filt(x[3001:]), y)
    # the file in JAX, and JAX's file in the port
    jp = mr.make_kernel(h.numpy(), ratio=Fraction(7, 5))
    js = jax_load_state(path)
    assert np.asarray(js.history).dtype == x.numpy().dtype
    yj, cj, js = mr.filt_block(jp, js, jnp.asarray(x[3001:].numpy()),
                               path="windows")
    assert np.array_equal(y.numpy(), np.asarray(yj)[:int(cj)])
    jax_save_state(str(tmp_path / "jax.npz"), js)
    back = load_state(str(tmp_path / "jax.npz"), device=CPU)
    assert back.history.dtype == x.dtype
    assert torch.equal(back.history[..., -f.params.h_min:],
                       g.state.history)


# --- real signals against complex taps ----------------------------------------

REAL_SIGNALS = ["float32", "float64", "int16", "uint8", "float16",
                "bfloat16", "int8"]
ALL_FAMILIES = {**{k: {"ratio": v} for k, v in RATIONAL.items()}, **RATES}


def _real_signal(name, n, seed):
    v = np.random.default_rng(seed).standard_normal(n)
    if name == "int16":
        return (v * 1500).astype(np.int16)
    if name == "uint8":
        return np.clip(128 + 40 * v, 0, 255).astype(np.uint8)
    if name == "int8":
        return np.clip(v * 40, -127, 127).astype(np.int8)
    return np.asarray(jnp.asarray(v, getattr(jnp, name)))


@functools.cache
def _complex_taps(dtype):
    """96 Kaiser taps modulated to a complex bandpass at a quarter of the
    rate: h[n] exp(2 pi j 0.25 n)."""
    h = mr.firdes(96, 0.1, mr.kaiser, beta=7.0) * 4
    return (h * np.exp(2j * np.pi * 0.25 * np.arange(96))).astype(dtype)


@pytest.mark.parametrize("taps", ["complex64", "complex128"])
@pytest.mark.parametrize("sig", REAL_SIGNALS)
@pytest.mark.parametrize("fam", list(ALL_FAMILIES))
def test_real_signals_against_complex_taps_match_jax(fam, sig, taps):
    kw = ALL_FAMILIES[fam]
    h = _complex_taps(taps)
    xs = _real_signal(sig, 1500, 29)
    xj, path = jnp.asarray(xs), "windows"
    if sig == "bfloat16":  # JAX's windows rounds bf16 products
        if "rate" in kw:
            xj = xj.astype(jnp.float32)
        else:
            path = "supercycle"
    jp = mr.make_kernel(h, **kw)
    if fam == "arbitrary" and np.dtype(taps) != np.result_type(taps, xs):
        # JAX windows forms complex64 taps here; its TPU route casts the
        # banks to the output type first, as the port does
        jp = dataclasses.replace(jp, pfb=jp.pfb.astype(jnp.complex128),
                                 dpfb=jp.dpfb.astype(jnp.complex128))
    yj, cj, _ = mr.filt_block(jp, mr.init_state(jp, (), xj.dtype), xj,
                              path=path)
    yj = np.asarray(yj)[:int(cj)]
    y, c, st = _port(h, xs, **kw)
    assert c == int(cj) and y.numpy().dtype == yj.dtype
    assert st.history.dtype == mt.ops.params.to_tensor(xs).dtype
    assert rel_max_err(y, yj) <= (1e-5 if y.dtype == torch.complex64
                                  else 1e-12)


def test_real_signals_reach_complex_taps_as_stored():
    # float32, float64 and the narrow reads keep their type on the way to
    # the real-sample entries; other real types cast once to the real type
    for sig in dtypes.LATTICE_TYPES:
        if sig.is_complex:
            continue
        for tap in (torch.complex64, torch.complex128):
            final = dtypes.out_dtype(tap, sig)
            for quantized, entries in ((True, pp.ENTRIES),
                                       (False, rs.ENTRIES)):
                r = compute._route(tap, tap, sig, quantized)
                as_stored = sig == final.to_real() or (
                    sig in dtypes.NARROW and final == torch.complex64)
                assert (r.x is None) == as_stored, (sig, tap)
                assert ((r.x or sig), final, final) in entries


@pytest.mark.parametrize("sig", ["float32", "int16", "bfloat16"])
@pytest.mark.parametrize("kind", ["rational", "arbitrary"])
def test_real_signal_complex_taps_chunked_equal_whole(kind, sig):
    h = torch.from_numpy(_complex_taps("complex64"))
    xs = mt.ops.params.to_tensor(_real_signal(sig, 5000, 30))
    spec = Fraction(7, 5) if kind == "rational" else 0.77
    whole = mt.filt(h, xs, spec, 8, device=CPU)
    f = mt.FIRFilter(h, spec, 8, device=CPU)
    rng = np.random.default_rng(31)
    parts, i = [], 0
    while i < xs.shape[-1]:
        n = int(rng.integers(1, 700))
        parts.append(f.filt(xs[i:i + n]))
        i += n
    assert whole.dtype == torch.complex64
    assert f.state.history.dtype == xs.dtype
    assert torch.equal(torch.cat(parts, -1), whole)


def test_real_signal_complex_taps_time_major_equals_channel_major():
    kw = RATES["farrow"]
    tp = mt.make_kernel(torch.from_numpy(_complex_taps("complex64")), **kw,
                        device=CPU)
    x = torch.from_numpy(_real_signal("int16", (3, 2000), 32))
    st = mt.setphase(tp, mt.init_state(tp, (3,), x.dtype), 0.37)
    y, c, s = mt.filt_block(tp, st, x)
    yt, ct, stt = mt.filt_block_tm(tp, st, x.t().contiguous())
    assert ct == c and torch.equal(yt, y.t())
    assert torch.equal(stt.history, s.history) and s.history.dtype == x.dtype


# --- the parallel layer ----------------------------------------------------

def _shard_cases():
    rng = np.random.default_rng(33)
    h = rng.integers(-2 ** 15, 2 ** 15, 147 * 6).astype(np.int16)
    x = _full_range(rng, np.int32, (2, 3200))
    return [dict(id=f"int32-{m[0]}x{m[1]}", mesh=m, kind="resample", h=h,
                 x=x, kw={"ratio": Fraction(147, 160)})
            for m in ((1, 2), (2, 1))]


@pytest.fixture(scope="module")
def shard_results():
    from multirate_tpu_torch.parallel.multihost import spawn_world
    from multirate_tpu_torch.utils.testing import sharded_cases

    return spawn_world(sharded_cases, 2, args=(_shard_cases(),),
                       device=CPU)


@pytest.mark.parametrize("case", _shard_cases(), ids=lambda c: c["id"])
def test_sharded_int32_equals_jax(shard_results, case):
    # int32 PCM against Q15 taps on two gloo ranks: JAX windows' wrapped
    # int32 sums, exactly
    jp = mr.make_kernel(case["h"], **case["kw"])
    y, c, _ = mr.filt_block(jp, mr.init_state(jp, (2,), case["x"].dtype),
                            jnp.asarray(case["x"]), path="windows")
    want = np.asarray(y)[:, :int(c)]
    for rank in shard_results:
        got = rank[case["id"]]
        assert got["y"].dtype == np.int32
        assert np.array_equal(got["y"], want)


def test_complex_banks_of_real_signals_keep_the_table_type():
    # a real signal against a complex table sums and stores in the table's
    # type, on CPU tensors through the plain versions, no launch counted
    before = (dict(pp.launches), dict(rs.launches))
    p = mt.make_kernel(torch.from_numpy(_complex_taps("complex64")),
                       rate=0.77, nphi=8, device=CPU)
    x = torch.randn(2, 500, dtype=torch.float32)
    n = mt.outputlength(p, 500)
    y = rs.resample(x, torch.zeros(2, p.h_min), p, 0, 1, n)
    want = rs.resample(x.to(torch.complex64),
                       torch.zeros(2, p.h_min, dtype=torch.complex64), p, 0,
                       1, n)
    assert y.dtype == torch.complex64 and torch.equal(y, want)
    q = dataclasses.replace(p, table=p.table.to(torch.complex128))
    y64 = rs.resample(x.double(), torch.zeros(2, p.h_min,
                                              dtype=torch.float64), q, 0, 1,
                      n)
    assert y64.dtype == torch.complex128
    assert (pp.launches, rs.launches) == before
