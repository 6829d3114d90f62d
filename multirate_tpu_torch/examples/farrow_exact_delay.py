"""Exact fractional-sample delay with setphase.

Python analogue of the reference's examples/FIRFarrow.jl:25-33 and the
interactive Farrow notebook: resample at rate 1.0 while phase-offsetting
the polyphase bank to realize a precise sub-sample delay (float64).

    python -m multirate_tpu_torch.examples.farrow_exact_delay
"""

import numpy as np

import multirate_tpu_torch as mt


def main(device=None):
    """On ``device``, by default the card."""
    nphi = 32
    numtaps, beta = mt.kaiserlength(0.05, samplerate=nphi)
    numtaps = -(-numtaps // nphi) * nphi
    h = (mt.firdes(numtaps, 0.45, mt.kaiser, samplerate=nphi, beta=beta)
         * nphi)

    t = np.arange(2000, dtype=np.float64)
    x = np.sin(2 * np.pi * 0.01 * t)

    base_delay = len(h) / (2 * nphi) - 1 / nphi
    errs = []
    for frac in (0.0, 0.25, 0.5):
        f = mt.FIRFilter(h, 1.0, nphi=nphi, device=device)
        f.setphase(frac)
        y = f.filt(x).cpu().numpy()
        expect = np.sin(2 * np.pi * 0.01 * (t - base_delay + frac))
        errs.append(np.abs(y[200:1800] - expect[200:1800]).max())
        print(f"setphase({frac}): sub-sample delay error {errs[-1]:.2e}")

    # Farrow variant: same trick, polynomial-generated taps
    f = mt.FIRFilter(h, 1.0, nphi=nphi, polyorder=4, device=device)
    f.setphase(0.5)
    y = f.filt(x).cpu().numpy()
    expect = np.sin(2 * np.pi * 0.01 * (t - base_delay + 0.5))
    errs.append(np.abs(y[200:1800] - expect[200:1800]).max())
    print(f"farrow setphase(0.5): error {errs[-1]:.2e}")
    return errs


if __name__ == "__main__":
    main()
