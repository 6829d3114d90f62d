"""Naive vs polyphase resampling speed comparison.

Python analogue of the reference's examples/Comparison.jl and the README
"Speed" section: the same 147//160, 1M-sample, 3528-tap workload, timed
naive (zero-stuff + full filter + downselect, the float64 host oracle)
vs polyphase (``filt`` on ``device``, by default the card).

    python -m multirate_tpu_torch.examples.naive_vs_polyphase
"""

import time
from fractions import Fraction

import numpy as np
import torch

import multirate_tpu_torch as mt
from multirate_tpu_torch.utils.oracle import naivefilt


def _timed(fn):
    """(result, host seconds) of ``fn``, waiting for the card if the
    result lies there."""
    t0 = time.perf_counter()
    y = fn()
    if y.is_cuda:
        torch.cuda.synchronize(y.device)
    return y, time.perf_counter() - t0


def main(device=None):
    ratio = Fraction(147, 160)
    h = (mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    x = np.random.default_rng(0).standard_normal(1_000_000).astype(
        np.float32)

    t0 = time.perf_counter()
    y_naive = naivefilt(h, x[:100_000], ratio)  # naive is ~100x slower; scale
    t_naive = (time.perf_counter() - t0) * 10   # extrapolate to 1M
    print(f"naive (extrapolated 1M): {t_naive:.2f} s")

    xt = mt.ops.params.to_tensor(
        x, mt.ops.params.default_device() if device is None else device)
    _timed(lambda: mt.filt(h, xt, ratio))        # build and warm up
    y, t_poly = _timed(lambda: mt.filt(h, xt, ratio))
    print(f"polyphase on {y.device}: {t_poly * 1e3:.1f} ms host time  "
          f"({len(x) / t_poly / 1e6:.0f} Msamples/s, "
          f"{t_naive / t_poly:.0f}x)")

    n = min(len(y_naive), 10_000)
    err = np.abs(y[:n].cpu().numpy() - y_naive[:n]).max()
    print(f"max abs diff vs naive (first {n}): {err:.2e}")
    return err


if __name__ == "__main__":
    main()
