"""The plain references against known cases, and against the port's own
plain versions on the CPU."""

from fractions import Fraction

import numpy as np
import pytest
import torch
from scipy.signal import upfirdn

from benchmark.references import farrow, rational


def _outputs(ref, x, m0, m1):
    """Outputs [m0, m1) of the stream ``x`` (zeros before it)."""
    a, b = ref.span(m0, m1)
    xs = torch.zeros(b - a, dtype=torch.float64)
    lo = max(a, 0)
    xs[lo - a:] = torch.as_tensor(x[lo:b], dtype=torch.float64)
    return ref.outputs(xs, a, m0, m1).numpy()


@pytest.mark.parametrize("L,M,K", [(147, 160, 3528), (1, 1, 7), (4, 1, 13),
                                   (1, 4, 9), (3, 2, 5)])
def test_rational_is_zero_stuff_filter_keep(L, M, K):
    rng = np.random.default_rng(1)
    h = rng.standard_normal(K)
    x = rng.standard_normal(3000)
    ref = rational.make({"ratio": [L, M]}, torch.from_numpy(h))
    n = ref.count(len(x))
    assert n == -(-len(x) * L // M)
    want = upfirdn(h, x, up=L, down=M)[:n]
    for m0, m1 in ((0, n), (0, 1), (n // 3, n // 3 + 50), (n - 7, n)):
        np.testing.assert_allclose(_outputs(ref, x, m0, m1), want[m0:m1],
                                   rtol=0, atol=1e-12)


def test_farrow_with_exact_polynomial_taps():
    """Each tap row a quadratic in the phase, so the fit is exact: at rate
    2 (step nphi / 2) the outputs alternate the phases 1 and 17, the taps
    c_j psi^2."""
    nphi, T = 32, 3
    c = np.array([1.0, -0.5, 0.25])
    h = np.array([c[j] * (p + 1) ** 2 for j in range(T)
                  for p in range(nphi)])
    cfg = {"nphi": nphi, "polyorder": 2, "rate_inverse": 0.5}
    ref = farrow.make(cfg, torch.from_numpy(h))
    x = np.random.default_rng(2).standard_normal(200)
    conv = np.convolve(x, c)[:len(x)]
    y = _outputs(ref, x, 0, 2 * len(x))
    np.testing.assert_allclose(y[0::2], conv, rtol=0, atol=1e-9)
    np.testing.assert_allclose(y[1::2], 17.0 ** 2 * conv, rtol=0, atol=1e-9)
    assert ref.count(len(x)) == 2 * len(x)


@pytest.mark.parametrize("inv", [2.123456789, 1.0, 0.4709, 0.9173])
def test_farrow_count_and_walk(inv):
    cfg = {"nphi": 32, "polyorder": 4, "rate_inverse": inv}
    ref = farrow.make(cfg, torch.ones(320, dtype=torch.float64))
    step = round(32 / (1.0 / inv) * 2 ** 32)
    D = 32 << 32
    for n in (1, 100, 65_536, 1 << 26, 10 ** 11 + 3):
        count = ref.count(n)
        # the last output's newest input has arrived, the next one's not
        assert 1 + (count - 1) * step // D <= n < 1 + count * step // D


def test_references_match_the_ports_plain_versions():
    """On the CPU the port runs its plain PyTorch versions: the references
    agree with them to float32 rounding, chunk by chunk."""
    from multirate_tpu_torch import FIRFilter

    from benchmark import cell, designs

    for name, spec, kw in (("dat_to_cd.pcm_stream", Fraction(147, 160), {}),
                           ("arb_farrow.sdr_stream", 1 / 2.123456789,
                            {"nphi": 32, "polyorder": 4})):
        c = cell.load(name)
        taps = designs.taps(c.config).astype(np.float32)
        ref = c.reference(torch.from_numpy(taps.astype(np.float64)))
        f = FIRFilter(taps, spec, device="cpu", **kw)
        x = np.random.default_rng(3).standard_normal(20_000).astype(
            np.float32)
        y = np.concatenate([f.filt(x[i:i + 3001]).numpy()
                            for i in range(0, len(x), 3001)])
        assert len(y) == ref.count(len(x))
        want = _outputs(ref, x.astype(np.float64), 0, len(y))
        err = np.abs(y - want).max() / np.sqrt(np.mean(want ** 2))
        assert err < 1e-5
