"""The bytes and multiply-adds a call counts, against ``chip_smoke``'s
bounds of the same calls (the 147//160 block and the Farrow block)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import cell, designs, work
from multirate_tpu_torch import init_state, make_kernel, outputlength


@pytest.mark.parametrize("channels,n,dtype", [
    (64, 1 << 20, torch.float32), (1, 80_007, torch.float32),
    (4, 80_007, torch.float32)])
def test_rational_call_matches_chip_smoke(channels, n, dtype):
    cfg = cell.load("dat_to_cd.madi_block").config
    taps = designs.taps(cfg).astype(np.float32)
    p = make_kernel(taps, ratio=Fraction(147, 160), device="cpu")
    n_out = outputlength(p, n)
    x = torch.empty((channels, n), dtype=dtype)
    hist = init_state(p, (channels,), dtype).history
    want_ms, want_by = chip_smoke._polyphase_bound(
        torch, (x, hist, p.bank, 147, 160, 1, 1, n_out), dtype, "f32")
    nbytes, mult_adds = work.call_work(cfg, channels, n, n_out,
                                       str(dtype).removeprefix("torch."))
    assert mult_adds == channels * n_out * 24
    assert work.least_seconds(cfg, nbytes, mult_adds) * 1e3 == \
        pytest.approx(want_ms, rel=1e-12)
    assert want_by == "bytes"  # both calls are bound by their bytes


@pytest.mark.parametrize("n", [1 << 26, 65_536])
def test_farrow_call_matches_chip_smoke(n):
    cfg = cell.load("arb_farrow.capture_block").config
    taps = designs.taps(cfg).astype(np.float32)
    p = make_kernel(taps, rate=1 / 2.123456789, nphi=32, polyorder=4,
                    device="cpu")
    n_out = outputlength(p, n)
    hist = init_state(p, (1,)).history
    want_adds = chip_smoke._resample_mult_adds(p, 1, n_out)
    # 4e's bound of one block: x, history and table read once, the
    # outputs written once
    want_bytes = (n + hist.numel() + p.bank.numel()) * 4 + n_out * 4
    nbytes, mult_adds = work.call_work(cfg, 1, n, n_out)
    assert (nbytes, mult_adds) == (want_bytes, want_adds)
    want_ms, want_by = chip_smoke._bound(want_bytes, want_adds, "f32")
    assert work.least_seconds(cfg, nbytes, mult_adds) * 1e3 == \
        pytest.approx(want_ms, rel=1e-12)
    assert want_by == "bytes"  # both calls are bound by their bytes


def test_taps_match_the_ports_designs():
    """The benchmark's own design gives the taps the port's designer and
    the reference examples give."""
    from multirate_tpu_torch import firdes, kaiser

    dat = designs.taps(cell.load("dat_to_cd.pcm_stream").config)
    want = firdes(24 * 147, 0.5 / 147, kaiser, beta=7.8562) * 147
    np.testing.assert_allclose(dat, want, rtol=0, atol=1e-13)
    arb = designs.taps(cell.load("arb_farrow.sdr_stream").config)
    want = firdes(320, 0.45, kaiser, samplerate=32,
                  beta=0.1102 * (60 - 8.7)) * 32
    np.testing.assert_allclose(arb, want, rtol=0, atol=1e-13)
