"""Empty chunks and one tap a phase (T = 1) in every filter family, on the
CPU.

Streams with empty chunks at the start, in the middle and at the end, and
filters whose bank has one tap a phase (the geometries the smoke's phase
3j runs on the card: 1//1 with 1 tap, 4//1 with 4, 1//4 with 1, 3//2 with
3, arbitrary with nphi taps, Farrow with nphi taps), on 0, 1 and 2
channel dims, around ``setphase`` and ``reset``. They are held to the
float64 oracles and, in the rational family, to JAX's ``supercycle``
path. Not to JAX ``windows`` or ``auto``: those raise on exactly these
inputs (ROADMAP queue 3, "Empty chunks").

Tolerances:
- counts, phase, deficit and history: exact (host integers, copied
  samples); an empty chunk leaves the state as it was and gives an
  empty output of JAX's type;
- outputs against the float64 oracles and JAX ``supercycle``: max|dy| <=
  1e-5 * max|y| (float32 sums of at most a few dozen products);
- the same stream with and without its empty chunks: bit for bit.

The float64 oracles: ``utils.oracle.naivefilt`` (rational family),
``naivefilt_farrow`` (Farrow), and for the arbitrary rate a float64
transcription of the method below (``naivefilt`` interpolates across the
bank's last phase, where the method's dh = [diff(h); 0] does not: a
difference of the method, not of the port).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow
from multirate_tpu_torch.utils.testing import rel_max_err

CPU = "cpu"
TOL = 1e-5
NPHI = 8
# family: (make_kernel keywords, taps a phase of the "T = 1" geometry)
FAMILIES = {
    "1//1": ({"ratio": Fraction(1, 1)}, 1),
    "4//1": ({"ratio": Fraction(4, 1)}, 4),
    "1//4": ({"ratio": Fraction(1, 4)}, 1),
    "3//2": ({"ratio": Fraction(3, 2)}, 3),
    "arbitrary": ({"rate": 0.77, "nphi": NPHI}, NPHI),
    "farrow": ({"rate": 1.3, "nphi": NPHI, "polyorder": 3}, NPHI),
}
RATIONAL = ("1//1", "4//1", "1//4", "3//2")
# empty chunks at the start, in the middle and at the end
CHUNKS = (0, 0, 37, 0, 1, 0, 101, 0)
LEADS = {"0d": (), "1d": (2,), "2d": (2, 3)}


def _taps(family, one_tap):
    """Seeded taps: T = 1 (``one_tap``), else 12 taps a phase."""
    n = FAMILIES[family][1] * (1 if one_tap else 12) + (0 if one_tap else 5)
    return np.random.default_rng(len(family) + n).standard_normal(
        n).astype(np.float32)


def _arbitrary_oracle(h, x, rate, nphi):
    """The arbitrary-rate method in float64: the bank and derivative bank
    of JAX's ``taps2pfb``, and the exact accumulator walk u_n = n *
    delta_fx in Python integers (phase (u_n mod D) >> 32, alpha its low 32
    bits, input deficit 1 + u_n div D, D = nphi << 32)."""
    h = np.asarray(h, np.float64)
    dh = np.concatenate([np.diff(h), [0.0]])
    bank, dbank = mr.ops.taps2pfb(h, nphi), mr.ops.taps2pfb(dh, nphi)
    T = bank.shape[0]
    one = 1 << 32
    D, dfx = nphi * one, round(nphi / rate * one)
    xext = np.concatenate([np.zeros(T - 1), np.asarray(x, np.float64)])
    y = []
    n = 0
    while 1 + n * dfx // D <= len(x):
        u = n * dfx
        start, phi, alpha = u // D, (u % D) // one, (u % one) / one
        taps = bank[:, phi] + alpha * dbank[:, phi]
        y.append(xext[start:start + T] @ taps)
        n += 1
    return np.asarray(y)


def _oracle(family, h, x):
    """The float64 oracle of a fresh stream of one channel."""
    kw = FAMILIES[family][0]
    h64, x64 = h.astype(np.float64), np.asarray(x, np.float64)
    if family in RATIONAL:
        return naivefilt(h64, x64, kw["ratio"])
    if family == "arbitrary":
        return _arbitrary_oracle(h64, x64, kw["rate"], NPHI)
    return naivefilt_farrow(h64, x64, kw["rate"], NPHI, kw["polyorder"])


def _stream(f, xs, chunks):
    """Run ``chunks`` of xs through FIRFilter ``f``; each empty chunk must
    give an empty output of JAX's type and leave the state as it was."""
    ys, at = [], 0
    for n in chunks:
        before = f.state
        y = f.filt(xs[..., at:at + n])
        at += n
        assert y.dtype == torch.float32 and y.shape[:-1] == xs.shape[:-1]
        if n == 0:
            assert y.shape[-1] == 0
            if before is not None:
                assert (f.state.phase, f.state.deficit) == (
                    before.phase, before.deficit)
                assert torch.equal(f.state.history, before.history)
        ys.append(y)
    return torch.cat(ys, dim=-1)


@pytest.mark.parametrize("lead", list(LEADS))
@pytest.mark.parametrize("one_tap", [True, False], ids=["T1", "Tmany"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_empty_chunks_and_one_tap_match_the_oracle(family, one_tap, lead):
    kw, _ = FAMILIES[family]
    h = _taps(family, one_tap)
    shape = (*LEADS[lead], sum(CHUNKS))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    xs = torch.from_numpy(x)
    f = mt.FIRFilter(h, kw.get("ratio", kw.get("rate")), nphi=NPHI,
                     polyorder=kw.get("polyorder"), device=CPU)
    assert (f.params.taps_per_phi == 1) == one_tap
    y = _stream(f, xs, CHUNKS)
    # chunked == whole, and its state
    p = f.params
    yw, cw, sw = mt.filt_block(p, mt.init_state(p, LEADS[lead]), xs)
    assert y.shape[-1] == cw == mt.outputlength(p, sum(CHUNKS))
    assert (f.state.phase, f.state.deficit) == (sw.phase, sw.deficit)
    assert torch.equal(f.state.history, sw.history)
    assert rel_max_err(y, yw) <= TOL
    # the float64 oracle, channel by channel
    flat_y, flat_x = y.reshape(-1, cw), x.reshape(-1, x.shape[-1])
    for yc, xc in zip(flat_y, flat_x):
        ref = _oracle(family, h, xc)
        assert len(ref) >= cw
        assert rel_max_err(yc, ref[:cw]) <= TOL


@pytest.mark.parametrize("one_tap", [True, False], ids=["T1", "Tmany"])
@pytest.mark.parametrize("family", RATIONAL)
def test_empty_chunks_and_one_tap_match_jax_supercycle(family, one_tap):
    kw, _ = FAMILIES[family]
    h = _taps(family, one_tap)
    x = np.random.default_rng(2).standard_normal(
        (2, sum(CHUNKS))).astype(np.float32)
    jp = mr.make_kernel(h, **kw)
    p = mt.make_kernel(h, device=CPU, **kw)
    js = mr.setphase(jp, mr.init_state(jp, (2,), jnp.float32), 0.37) \
        if kw["ratio"].numerator > 1 else mr.init_state(jp, (2,),
                                                        jnp.float32)
    st = mt.setphase(p, mt.init_state(p, (2,)), 0.37) \
        if kw["ratio"].numerator > 1 else mt.init_state(p, (2,))
    at = 0
    for n in CHUNKS:
        xb = x[:, at:at + n]
        at += n
        yj, cj, js = mr.filt_block(jp, js, jnp.asarray(xb),
                                   path="supercycle")
        y, c, st = mt.filt_block(p, st, torch.from_numpy(xb))
        assert c == int(cj) == y.shape[-1]
        assert y.dtype == torch.float32 and np.asarray(yj).dtype == np.float32
        assert (st.phase, st.deficit) == (int(js.phase), int(js.deficit))
        # JAX carries whole zero-copy rows; its tail is the port's history
        jh = np.asarray(js.history)
        np.testing.assert_array_equal(
            st.history.numpy(), jh[..., jh.shape[-1] - p.h_min:])
        assert rel_max_err(y, np.asarray(yj)[..., :c]) <= TOL


@pytest.mark.parametrize("family", list(FAMILIES))
def test_setphase_and_reset_around_empty_chunks(family):
    kw, _ = FAMILIES[family]
    h = _taps(family, True)
    spec = kw.get("ratio", kw.get("rate"))
    xs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 150)).astype(np.float32))

    def run(chunks, empties):
        f = mt.FIRFilter(h, spec, nphi=NPHI, polyorder=kw.get("polyorder"),
                         device=CPU)
        f.state = mt.init_state(f.params, (2,))
        if empties:
            _stream(f, xs, (0,))
        if family not in ("1//1", "1//4"):  # the types with a phase
            f.setphase(0.37)
        set_state = f.state
        ys = []
        at = 0
        for n in chunks:
            if empties:
                ys.append(_stream(f, xs, (0,)))  # no data: a no-op
                if at == 0:  # the state setphase made, kept exactly
                    assert f.state.phase == set_state.phase
                    assert f.state.deficit == set_state.deficit
            ys.append(f.filt(xs[..., at:at + n]))
            at += n
        return f, torch.cat(ys, dim=-1)

    f, y = run((40, 110), True)
    _, y_plain = run((40, 110), False)
    assert torch.equal(y, y_plain)
    # reset, an empty chunk, then the stream again: a fresh stream's output
    f.reset()
    fresh = mt.init_state(f.params, (2,))
    assert (f.state.phase, f.state.deficit) == (fresh.phase, fresh.deficit)
    assert not f.state.history.any()
    y_again = _stream(f, xs, (0, 150, 0))
    y_fresh = mt.FIRFilter(h, spec, nphi=NPHI, polyorder=kw.get("polyorder"),
                           device=CPU).filt(xs)
    assert torch.equal(y_again, y_fresh)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernel_path_on_the_cpu_takes_empty_chunks_at_one_tap(family):
    # the wrappers' plain versions take (C, 0) histories and empty chunks
    kw, _ = FAMILIES[family]
    p = mt.make_kernel(_taps(family, True), device=CPU, **kw)
    assert p.h_min == 0
    st = mt.init_state(p, (3,))
    for n in (0, 9, 0):
        x = torch.ones(3, n)
        yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
        yw, cw, sw = mt.filt_block(p, st, x, path="windows")
        assert torch.equal(yk, yw) and ck == cw == yk.shape[-1]
        assert (sk.phase, sk.deficit) == (sw.phase, sw.deficit)
        assert sk.history.shape == (3, 0)
        if n == 0:
            assert ck == 0 and (sk.phase, sk.deficit) == (st.phase,
                                                          st.deficit)
        st = sk
