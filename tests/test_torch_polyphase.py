"""The polyphase kernel's plain version against the JAX package's
rational-family compute (``_standard``, ``_interpolator``, ``_decimator``,
``_rational`` behind ``filt_block``), on the CPU.

JAX runs its ``windows`` path and its ``pallas`` path, the latter with the
TPU kernels in interpret mode as ``tests/test_kernels.py`` runs them. The
port runs its ``kernel`` path, whose wrapper takes the plain version for a
CPU tensor, and its ``windows`` path. Entry states are fresh, or carried
from a JAX prefix block after ``setphase`` and brought across with
``convert.state_from_jax``.

Tolerances:
- counts, phase, deficit and history: exact (integers, copied samples);
- against JAX ``windows``: max|dy| <= 1e-5 * max|y| (both full float32;
  only the reduction order over T <= 50 taps differs);
- against the interpret-mode TPU kernels: max|dy| <= 1e-4 * max|y| and
  relative RMS <= 2e-5 (the float32 zero-copy kernel splits x and K
  bf16x3, about 2^-16 relative per product).

Two channels at xlen 80007 are held against ``windows`` only: the JAX
batched TPU path has the stream-concat gap fault there (ROADMAP queue 3).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu_torch.convert import params_from_jax, state_from_jax
from multirate_tpu_torch.ops.cuda import polyphase as pp

TOL_WINDOWS = 1e-5
TOL_ZC_MAX, TOL_ZC_RMS = 1e-4, 2e-5


def _taps(n_per_phase, L):
    return (mr.firdes(n_per_phase * L, 0.5 / L, mr.kaiser, beta=7.8562) * L
            ).astype(np.float32)


CASES = {  # name: (ratio, taps, xlen)
    "rational_147_160": (Fraction(147, 160), _taps(24, 147), 48_000),
    "rational_3_5": (Fraction(3, 5), _taps(24, 5), 20_000),
    "decimator_1_4": (Fraction(1, 4), _taps(24, 4), 20_000),
    "interpolator_4_1": (Fraction(4, 1), _taps(24, 4), 20_000),
    "standard_1_1": (Fraction(1, 1), _taps(24, 4), 20_000),
}


@pytest.fixture(scope="module")
def kernels():
    """(JAX kernel, port kernel) per case, built once per module."""
    out = {}
    for name, (ratio, h, _) in CASES.items():
        jp = mr.make_kernel(h, ratio=ratio)
        out[name] = (jp, mt.make_kernel(h, ratio=ratio, device="cpu"))
    return out


def _entry(jp, tp, lead, mid, rng, setphase=True):
    """(JAX state, port state): fresh, or after setphase(0.37) and a
    1237-sample JAX prefix block (a carried phase, deficit and history)."""
    js = mr.init_state(jp, lead, jnp.float32)
    if mid:
        if setphase and hasattr(jp, "nphi"):
            js = mr.setphase(jp, js, 0.37)
        pre = rng.standard_normal((*lead, 1237)).astype(np.float32)
        _, _, js = mr.filt_block(jp, js, jnp.asarray(pre), path="windows")
    ts = state_from_jax(tp, np.asarray(js.history), int(js.phase),
                        int(js.deficit))
    return js, ts


def _compare(jp, tp, js, ts, x, jax_path, port_path):
    yj, cj, sj = mr.filt_block(jp, js, jnp.asarray(x), path=jax_path)
    yt, ct, st = mt.filt_block(tp, ts, torch.from_numpy(x), path=port_path)
    cj = int(cj)
    assert ct == cj and yt.shape[-1] == cj
    assert (st.phase, st.deficit) == (int(sj.phase), int(sj.deficit))
    jh = np.asarray(sj.history)
    np.testing.assert_array_equal(
        st.history.numpy(), jh[..., jh.shape[-1] - tp.h_min:])
    want = np.asarray(yj)[..., :cj].astype(np.float64)
    got = yt.numpy().astype(np.float64)
    return np.abs(got - want).max() / np.abs(want).max(), \
        np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))


@pytest.mark.parametrize("mid", [False, True], ids=["fresh", "mid"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_windows(kernels, name, mid):
    jp, tp = kernels[name]
    rng = np.random.default_rng(11)
    js, ts = _entry(jp, tp, (), mid, rng)
    x = rng.standard_normal(CASES[name][2]).astype(np.float32)
    for port_path in ("kernel", "windows"):
        err, _ = _compare(jp, tp, js, ts, x, "windows", port_path)
        assert err <= TOL_WINDOWS, (port_path, err)


@pytest.mark.parametrize("mid", [False, True], ids=["fresh", "mid"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_pallas_interpret(kernels, name, mid):
    jp, tp = kernels[name]
    rng = np.random.default_rng(12)
    # the JAX zero-copy kernel honours an interpolator's setphase while its
    # count and its windows path ignore it (ROADMAP queue 3): the port
    # follows the count, so the interpolator enters without one here
    js, ts = _entry(jp, tp, (), mid, rng,
                    setphase=not isinstance(tp, mt.FIRInterpolator))
    x = rng.standard_normal(CASES[name][2]).astype(np.float32)
    err, rel_rms = _compare(jp, tp, js, ts, x, "pallas", "kernel")
    assert err <= TOL_ZC_MAX and rel_rms <= TOL_ZC_RMS, (err, rel_rms)


@pytest.mark.parametrize("mid", [False, True], ids=["fresh", "mid"])
def test_two_channels_xlen_80007(kernels, mid):
    jp, tp = kernels["rational_147_160"]
    rng = np.random.default_rng(13)
    js, ts = _entry(jp, tp, (2,), mid, rng)
    x = rng.standard_normal((2, 80_007)).astype(np.float32)
    err, _ = _compare(jp, tp, js, ts, x, "windows", "kernel")
    assert err <= TOL_WINDOWS, err
    # channels are independent: each equals its own one-channel run
    y2, _, _ = mt.filt_block(tp, ts, torch.from_numpy(x))
    for c in range(2):
        one = mt.FilterState(history=ts.history[c].clone(), phase=ts.phase,
                             deficit=ts.deficit)
        y1, _, _ = mt.filt_block(tp, one, torch.from_numpy(x[c]))
        assert torch.equal(y1, y2[c])


def test_params_from_jax_matches_make_kernel(kernels):
    for name, (jp, tp) in kernels.items():
        fields = {k: np.asarray(getattr(jp, k))
                  for k in ("pfb", "taps_rev", "interpolation", "decimation")
                  if hasattr(jp, k)}
        cp = params_from_jax(fields, device="cpu")
        assert type(cp) is type(tp), name
        assert torch.equal(cp.bank, tp.bank), name
        assert (cp.taps_per_phi, cp.h_min) == (tp.taps_per_phi, tp.h_min)


# --------------------------------------------------------------------------- #
# The wrapper itself: plain version on the CPU, raises on anything else
# --------------------------------------------------------------------------- #

def _args(C=2, xlen=50, T=5, L=3, M=2):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(C, xlen, generator=g)
    hist = torch.randn(C, T - 1, generator=g)
    bank = torch.randn(T, L, generator=g)
    n = mt.outputlength(xlen, Fraction(L, M))
    return x, hist, bank, L, M, 1, 1, n


def test_wrapper_takes_plain_version_on_cpu():
    before = dict(pp.launches)
    args = _args()
    assert torch.equal(pp.polyphase(*args), pp.polyphase_plain(*args))
    assert pp.launches == before  # the plain version is no launch
    # by hand: y[c, n] = sum_t xext[c, in_n - 1 + t] * bank[t, phi_n]
    x, hist, bank, L, M, _, _, n = args
    xext = torch.cat([hist, x], -1).double()
    want = torch.zeros(2, n, dtype=torch.float64)
    for k in range(n):
        t_k = k * M
        s, ph = t_k // L, t_k % L
        want[:, k] = xext[:, s:s + 5] @ bank[:, ph].double()
    torch.testing.assert_close(pp.polyphase(*args).double(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False), (False, False)])
def test_plain_version_restores_tf32_flags(flags):
    # TF32 is off inside the plain version's contraction and the caller's
    # own settings come back afterwards, whatever they were
    backends = torch.backends
    saved = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    seen = []
    real_einsum = torch.einsum

    def spy(*a):
        seen.append((backends.cuda.matmul.allow_tf32,
                     backends.cudnn.allow_tf32))
        return real_einsum(*a)

    try:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = flags
        torch.einsum = spy
        pp.polyphase_plain(*_args())
    finally:
        torch.einsum = real_einsum
        after = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved
    assert seen == [(False, False)]
    assert after == flags


@pytest.mark.parametrize("bad", ["dtype", "layout", "hist_shape",
                                 "bank_shape", "phase", "too_many",
                                 "device"])
def test_wrapper_raises(bad):
    x, hist, bank, L, M, phi0, d0, n = _args()
    if bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = torch.randn(x.shape[1], x.shape[0]).t()
    elif bad == "hist_shape":
        hist = hist[:, 1:].contiguous()
    elif bad == "bank_shape":
        bank = torch.randn(5, L + 1)
    elif bad == "phase":
        phi0 = L + 1
    elif bad == "too_many":
        n += 1
    elif bad == "device":
        x, hist, bank = (t.to("meta") for t in (x, hist, bank))
    with pytest.raises((TypeError, ValueError)):
        pp.polyphase(x, hist, bank, L, M, phi0, d0, n)


def test_compute_rejects_what_is_not_ported():
    tp = mt.make_kernel(np.ones(8, np.float32), ratio=Fraction(3, 5),
                        device="cpu")
    st = mt.init_state(tp)
    with pytest.raises(NotImplementedError, match="float16"):
        mt.filt_block(tp, st, torch.zeros(10, dtype=torch.float16))
    for dtype in (torch.bfloat16, torch.int8):  # widened, not refused
        x = torch.arange(-40, 40, dtype=torch.float32).to(dtype)
        y = mt.filt(np.ones(8, np.float32), x, 0.9)
        assert y.dtype == torch.float32
        assert torch.equal(y, mt.filt(np.ones(8, np.float32), x.float(), 0.9))
    with pytest.raises(ValueError, match="shape"):
        mt.filt_block(tp, st, torch.zeros(2, 10))
    with pytest.raises(ValueError, match="path"):
        mt.filt_block(tp, st, torch.zeros(10), path="pallas")
