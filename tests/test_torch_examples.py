"""The port's example flows (``multirate_tpu_torch/examples``) on the CPU.

Each runs in-process with ``device="cpu"`` and the shrink keywords of
``tests/test_examples.py``; the flows that print a result of the JAX
package's example are held against it: ``dat_to_cd`` and ``fir_arbitrary``
to the JAX ``filt`` (1e-5 * max|y|, float32 and float64 sums in another
order), and ``wav_resample --demo`` to its 1 kHz amplitude window.
"""

import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest

import multirate_tpu as mr
from multirate_tpu_torch import examples
from multirate_tpu_torch.examples import (arb_farrow_speed, dat_to_cd,
                                          fir_arbitrary, wav_resample)
from multirate_tpu_torch.utils.testing import rel_max_err


@pytest.mark.parametrize("name", [
    "dat_to_cd", "fir_arbitrary", "farrow_exact_delay",
    "interactive_farrow", "naive_vs_polyphase",
    "multichannel_time_major",
])
def test_example_runs(name, capsys):
    import importlib

    importlib.import_module(f"multirate_tpu_torch.examples.{name}").main(
        device="cpu")
    assert capsys.readouterr().out  # produced output, no exception


def test_example_arb_farrow_speed(capsys):
    reports = arb_farrow_speed.main(
        n_samples=20_000, rates=(1 / 2.123456789,), dtypes=(np.float32,),
        repeat=3, iters=2, device="cpu")
    assert len(reports) == 2 and all(r.in_samples == 20_000 for r in reports)
    assert "on cpu" in capsys.readouterr().out


def test_example_wav_resample(capsys):
    amp = wav_resample.main(["--demo"], device="cpu")
    out = capsys.readouterr().out
    assert "recovered 1 kHz amplitude" in out and 0.45 < amp < 0.55


def test_example_usage_banner(capsys):
    assert wav_resample.main([]) is None
    assert "Usage" in capsys.readouterr().out


def test_dat_to_cd_matches_jax():
    y = dat_to_cd.main(device="cpu")
    h = (mr.firdes(24 * 147, 0.5 / 147, mr.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    x = np.sin(2 * np.pi * 1000.0 * np.arange(48_000) / 48_000.0).astype(
        np.float32)
    yj = np.asarray(mr.filt(h, x, Fraction(147, 160)))
    assert rel_max_err(y, yj) <= 1e-5


def test_fir_arbitrary_tone_matches_jax(capsys):
    meas, y = fir_arbitrary.main(device="cpu")
    assert abs(meas - 440.0) < 0.5
    nphi = 32
    numtaps, beta = mr.kaiserlength(0.05, samplerate=nphi)
    numtaps = -(-numtaps // nphi) * nphi
    h = mr.firdes(numtaps, 0.45, mr.kaiser, samplerate=nphi,
                  beta=beta) * nphi
    x = np.sin(2 * np.pi * 440.0 * np.arange(20_000) / 10_000.0).astype(
        np.float32)
    yj = np.asarray(mr.filt(h, x, float(np.sqrt(2.0)), nphi))
    assert y.shape == yj.shape
    assert rel_max_err(y, yj) <= 1e-5


def test_flows_list_and_no_jax():
    """Every flow is a module of the package, and importing them all
    imports no JAX."""
    assert len(examples.FLOWS) == 8
    code = ("import sys, importlib\n"
            f"for n in {examples.FLOWS!r}:\n"
            "    importlib.import_module(\n"
            "        'multirate_tpu_torch.examples.' + n)\n"
            "assert 'jax' not in sys.modules and not any(\n"
            "    m.startswith('multirate_tpu.') for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
