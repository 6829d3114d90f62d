"""Time-major multichannel resampling + narrow output stores.

Two production modes:

1. ``filt_block_tm``: a 64-channel Farrow resampler streamed TIME-MAJOR:
   chunks arrive as (time, channels) (the natural layout of an
   interleaved ADC/DMA capture) and outputs come back (out, channels), no
   transpose pass anywhere (the time-major entry of the resample kernel).
2. ``make_kernel(..., store_dtype=torch.bfloat16)``: an interpolator
   whose outputs store as bfloat16 straight from the float32
   accumulators: the write-dominated 4//1 byte budget halves at bf16
   rounding error (a quantized MODE, like the int8 path).

The 64-channel Farrow configuration is the BASELINE.json sharded config;
the reference itself is single-threaded and channel-blind (SURVEY.md
section 5).

    python -m multirate_tpu_torch.examples.multichannel_time_major
"""

from fractions import Fraction

import numpy as np
import torch

import multirate_tpu_torch as mt


def main(n_ch: int = 64, n_time: int = 48_000, chunk: int = 8_192,
         device=None):
    """On ``device``, by default the card."""
    rng = np.random.default_rng(0)
    dev = mt.ops.params.default_device() if device is None else device
    h = (mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32
         ).astype(np.float32)

    # ---- 1. time-major streaming Farrow, 64 channels ------------------ #
    params = mt.make_kernel(h, rate=0.9173, nphi=32, polyorder=4,
                            device=dev)
    xt = torch.from_numpy(rng.standard_normal((n_time, n_ch)).astype(
        np.float32)).to(params.device)
    state = mt.init_state(params, (n_ch,), torch.float32)
    outs = []
    for i in range(0, n_time, chunk):
        y, count, state = mt.filt_block_tm(params, state, xt[i:i + chunk])
        outs.append(y)
    y_tm = torch.cat(outs, 0)                        # (out_time, n_ch)
    print(f"time-major Farrow: {tuple(xt.shape)} -> {tuple(y_tm.shape)} "
          f"(rate 0.9173, {len(outs)} chunks, no transposes, on "
          f"{y_tm.device})")

    # equality vs the channel-major path (states interoperate)
    y_cm = mt.filt(h, xt.t().contiguous(), 0.9173, 32, 4)
    n = min(y_tm.shape[0], y_cm.shape[1])
    err = float((y_tm[:n].t() - y_cm[:, :n]).abs().max())
    print(f"  max |time-major - channel-major| = {err:.2e}")
    if not err < 1e-4:
        raise RuntimeError(f"time-major differs from channel-major: {err}")

    # ---- 2. bf16-output interpolator ---------------------------------- #
    h147 = np.asarray(mt.firdes(147, 0.2, mt.kaiser, beta=7.0), np.float32)
    p16 = mt.make_kernel(h147, ratio=Fraction(4, 1),
                         store_dtype=torch.bfloat16, device=dev)
    x = torch.from_numpy(rng.standard_normal(n_time).astype(np.float32)
                         ).to(p16.device)
    y16, count, _ = mt.filt_block(p16, mt.init_state(p16, (), torch.float32),
                                  x)
    print(f"bf16-output interp 4//1: y dtype {y16.dtype}, {count} outputs "
          f"(write bytes halved; bf16 rounding against the f32 path)")
    if y16.dtype != torch.bfloat16:
        raise RuntimeError(f"store dtype {y16.dtype}, not bfloat16")
    return err


if __name__ == "__main__":
    main()
