"""The port's numpy host code (designer, windows, polyphase banks, oracle)
equals the JAX package's: the same inputs give the same arrays, exactly,
because both are the same float64 numpy arithmetic."""

from fractions import Fraction

import numpy as np
import pytest

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu.utils import oracle as jax_oracle
from multirate_tpu.utils import testing as jax_testing
from multirate_tpu_torch.utils import oracle as port_oracle
from multirate_tpu_torch.utils import testing as port_testing


@pytest.mark.parametrize("name", ["kaiser", "hanning", "hamming", "blackman",
                                  "rect"])
@pytest.mark.parametrize("n", [1, 2, 31, 3528])
def test_windows_equal(name, n):
    args = (n, 7.8562) if name == "kaiser" else (n,)
    np.testing.assert_array_equal(getattr(mt, name)(*args),
                                  getattr(mr, name)(*args))


@pytest.mark.parametrize("response,cutoff", [
    (mt.LOWPASS, 0.5 / 147), (mt.HIGHPASS, 0.3),
    (mt.BANDPASS, (0.1, 0.2)), (mt.BANDSTOP, (0.1, 0.2))])
def test_firdes_equal(response, cutoff):
    jresp = mr.FIRResponse(response.value)
    for numtaps in (24 * 147, 33):
        got = mt.firdes(numtaps, cutoff, mt.kaiser, response=response,
                        beta=7.8562)
        want = mr.firdes(numtaps, cutoff, mr.kaiser, response=jresp,
                         beta=7.8562)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mt.firdes(0.25, 0.05, 60.0), mr.firdes(0.25, 0.05, 60.0))
    assert mt.kaiserlength(0.05, 60.0) == mr.kaiserlength(0.05, 60.0)


@pytest.mark.parametrize("nphi", [1, 4, 147, 160])
def test_taps2pfb_equal(nphi):
    h = np.random.default_rng(nphi).standard_normal(24 * 147 + 5)
    for dt in (np.float32, np.float64):
        got = mt.taps2pfb(h.astype(dt), nphi)
        want = mr.taps2pfb(h.astype(dt), nphi)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mt.pfb2pnfb(mt.taps2pfb(h, nphi), 3),
                                  mr.pfb2pnfb(mr.taps2pfb(h, nphi), 3))


def test_taps2pfb_reference_example():
    # Filters.jl:276-281: taps2pfb(1..9, 4) = [[9,0,0,0],[5,6,7,8],[1,2,3,4]]
    np.testing.assert_array_equal(
        mt.taps2pfb(np.arange(1, 10), 4),
        [[9, 0, 0, 0], [5, 6, 7, 8], [1, 2, 3, 4]])


@pytest.mark.parametrize("ratio", [Fraction(147, 160), Fraction(3, 5),
                                   Fraction(4, 1), Fraction(1, 4)])
def test_oracle_equal(ratio):
    rng = np.random.default_rng(7)
    h, x = rng.standard_normal(60), rng.standard_normal(500)
    np.testing.assert_array_equal(port_oracle.naivefilt(h, x, ratio),
                                  jax_oracle.naivefilt(h, x, ratio))
    a, b = rng.standard_normal(50), rng.standard_normal(50)
    assert port_testing.rms(a, b) == jax_testing.rms(a, b)
    port_testing.assert_close(a, a + 1e-12)
    with pytest.raises(AssertionError, match="first divergence at index 3"):
        port_testing.assert_close(np.arange(5.0), np.r_[0, 1, 2, 9, 4.0])
