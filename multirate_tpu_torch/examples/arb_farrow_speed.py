"""Arbitrary vs Farrow resampler throughput harness.

Python analogue of the reference's examples/Arb-Farrow Speed Comparison.jl
(:16-19, :32-35): 320 taps, nphi=32, polyorder 4, rates
{1.0, 1/2.123456789}, dtypes {float32, float64, complex64, complex128};
prints the per-call time and the input/output samples per second of one
state-carrying ``filt_block`` chain (``utils.metrics.measure_chained``:
CUDA events on the card, with the roofline fraction against the card's
HBM rate; the host clock on the CPU).

    python -m multirate_tpu_torch.examples.arb_farrow_speed
"""

import numpy as np

import multirate_tpu_torch as mt
from multirate_tpu_torch.utils.metrics import measure_chained


def main(n_samples: int = 1_000_000, rates=None, dtypes=None,
         repeat: int = 10, iters: int = 5, device=None):
    """``rates``/``dtypes``/``repeat``/``iters`` shrink the sweep (the test
    suite smoke-runs one config; the full matrix is the reference-parity
    default). On ``device``, by default the card."""
    nphi, polyorder = 32, 4
    numtaps, beta = mt.kaiserlength(0.1, samplerate=nphi)
    numtaps = min(-(-numtaps // nphi) * nphi, 320)
    h = mt.firdes(numtaps, 0.45, mt.kaiser, samplerate=nphi, beta=beta) * nphi
    dev = mt.ops.params.default_device() if device is None else device

    reports = []
    for rate in rates or (1.0, 1 / 2.123456789):
        for dt in dtypes or (np.float32, np.float64, np.complex64,
                             np.complex128):
            x = np.random.default_rng(0).standard_normal(n_samples)
            if np.issubdtype(dt, np.complexfloating):
                x = x + 1j * np.random.default_rng(1).standard_normal(
                    n_samples)
            x = mt.ops.params.to_tensor(x.astype(dt), dev)
            hh = h.astype(np.float32 if dt in (np.float32, np.complex64)
                          else np.float64)
            for name, polyord in (("arb", None), ("farrow", polyorder)):
                params = mt.make_kernel(hh, rate=rate, nphi=nphi,
                                        polyorder=polyord, device=dev)
                state = mt.init_state(params, (), x.dtype)
                rep = measure_chained(params, state, x, rate=rate,
                                      repeat=repeat, iters=iters)
                reports.append(rep)
                print(f"{name:7s} rate={rate:<12.6f} "
                      f"{np.dtype(dt).name:10s} on {x.device}: {rep}")
    return reports


if __name__ == "__main__":
    main()
