"""48 kHz (DAT) -> 44.1 kHz (CD) sample-rate conversion.

Python analogue of the reference's examples/DAT to CD.jl:6-16: 147//160
rational resampling with a 24*147-tap Kaiser filter (beta 7.8562, cutoff
0.5/147, taps scaled by 147 for unity passband gain).

    python -m multirate_tpu_torch.examples.dat_to_cd
"""

from fractions import Fraction

import numpy as np
import torch

import multirate_tpu_torch as mt


def main(device=None):
    """On ``device``, by default the card."""
    fs_in = 48_000.0
    ratio = Fraction(147, 160)

    h = (mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
         ).astype(np.float32)

    t = np.arange(int(fs_in)) / fs_in
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)

    y = mt.filt(h, x, ratio, device=device)
    print(f"in : {len(x)} samples @ {fs_in:.0f} Hz")
    print(f"out: {len(y)} samples @ {fs_in * float(ratio):.0f} Hz "
          f"on {y.device}")

    # streaming variant: identical output, chunk by chunk
    f = mt.FIRFilter(h, ratio, device=device)
    yc = torch.cat([f.filt(x[i:i + 4800]) for i in range(0, len(x), 4800)])
    print(f"chunked == whole: {float((yc - y).abs().max()):.2e} "
          f"max abs diff")
    return y


if __name__ == "__main__":
    main()
