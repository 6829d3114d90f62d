"""Arbitrary-rate resampling demo.

Python analogue of the reference's examples/FIRArbitrary.jl: design a
32-phase prototype (scaled by nphi for unity gain), resample a tone by an
irrational factor, and inspect spectrum-level correctness.

    python -m multirate_tpu_torch.examples.fir_arbitrary
"""

import numpy as np
import torch

import multirate_tpu_torch as mt


def main(device=None):
    """On ``device``, by default the card. Returns the measured tone
    frequency and the resampled signal."""
    nphi = 32
    rate = np.sqrt(2.0)              # irrational resampling factor
    numtaps, beta = mt.kaiserlength(0.05, samplerate=nphi)
    numtaps = -(-numtaps // nphi) * nphi
    h = mt.firdes(numtaps, 0.45, mt.kaiser, samplerate=nphi, beta=beta) * nphi

    fs = 10_000.0
    f0 = 440.0
    t = np.arange(20_000) / fs
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)

    y = mt.filt(h, x, float(rate), nphi, device=device)
    print(f"rate = sqrt(2) ~ {rate:.9f}")
    print(f"in : {len(x)} samples @ {fs:.0f} Hz")
    print(f"out: {len(y)} samples @ {fs * rate:.1f} Hz "
          f"(expected ~{len(x) * rate:.0f})")

    # the tone must land at the same absolute frequency
    seg = y[2000:18000].cpu().numpy()
    zc = np.where(np.diff(np.signbit(seg)))[0]
    meas = (fs * rate) / (2 * np.mean(np.diff(zc)))
    print(f"tone: {meas:.2f} Hz (expected {f0:.2f})")

    # streaming in 1000-sample chunks produces the identical stream
    f = mt.FIRFilter(h, float(rate), nphi=nphi, device=device)
    yc = torch.cat([f.filt(x[i:i + 1000]) for i in range(0, len(x), 1000)])
    print(f"chunked == whole: "
          f"{float((yc - y[:len(yc)]).abs().max()):.2e}")
    return meas, y


if __name__ == "__main__":
    main()
