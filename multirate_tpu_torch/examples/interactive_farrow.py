"""Farrow resampler exploration (console edition).

Analogue of the reference's examples/Interactive Farrow Example.jl (an
IJulia notebook with sliders): sweeps rate and phase-delay settings and
prints an accuracy table of the Farrow kernel against the derivative-bank
arbitrary kernel, which is the comparison the notebook visualizes
(float64).

    python -m multirate_tpu_torch.examples.interactive_farrow
"""

import numpy as np

import multirate_tpu_torch as mt


def main(device=None):
    """On ``device``, by default the card."""
    nphi = 32
    numtaps, beta = mt.kaiserlength(0.05, samplerate=nphi)
    numtaps = -(-numtaps // nphi) * nphi
    h = mt.firdes(numtaps, 0.45, mt.kaiser, samplerate=nphi, beta=beta) * nphi

    rng = np.random.default_rng(0)
    x = rng.standard_normal(20_000)

    print(f"{'rate':>10} {'order':>5} {'rms farrow-vs-arb':>18} "
          f"{'max abs':>10}")
    rows = []
    for rate in (0.5, 0.75, 1.0 + 1e-9, 1.333, 2.7182818):
        ya = mt.filt(h, x, float(rate), nphi, device=device).cpu().numpy()
        for order in (2, 3, 4):
            yf = mt.filt(h, x, float(rate), nphi, order,
                         device=device).cpu().numpy()
            n = min(len(ya), len(yf))
            d = yf[:n] - ya[:n]
            rows.append((rate, order, np.sqrt(np.mean(d ** 2))))
            print(f"{rate:>10.6f} {order:>5} {rows[-1][2]:>18.3e} "
                  f"{np.abs(d).max():>10.3e}")

    # exact-delay trick (examples/FIRFarrow.jl:25-33): phase-offset the bank
    print("\nsub-sample delay via setphase (rate=1):")
    t = np.arange(3000, dtype=np.float64)
    tone = np.sin(2 * np.pi * 0.01 * t)
    base_delay = len(h) / (2 * nphi) - 1 / nphi
    for phi in (0.1, 0.5, 0.9):
        f = mt.FIRFilter(h, 1.0, nphi=nphi, polyorder=4, device=device)
        f.setphase(phi)
        y = f.filt(tone).cpu().numpy()
        expect = np.sin(2 * np.pi * 0.01 * (t - base_delay + phi))
        err = np.abs(y[300:2700] - expect[300:2700]).max()
        print(f"  phase {phi:.1f}: delay error {err:.2e}")
    return rows


if __name__ == "__main__":
    main()
