"""Time the resample kernel at each run (neighbouring outputs a thread
takes: 1, 2, 4, 8, 16) on one-channel rows, beside the run that
``ops/cuda/resample.plan`` picks.

The planner picks the least run whose lanes' windows lie within 1/32
sample of an odd number of samples apart, else 1 (``resample._run_of``);
this sweep measures every run the kernel takes, on the main path's
one-channel rows (``bench.py``'s bank at 1/2.123456789 and 0.4709, in
float32, float64 and the four complex entry points, and one 65,536-sample
block of ``models.Resampler(1/2.123456789)``) and on rates where the
planner picks run 1 (0.3, 0.9173 and 2.5). Each run's output
must equal the planned one bit for bit. Needs one CUDA card; imports no
JAX. From the repo root:

    python3 tools/resample_runs.py

Prints one line a row, the card's name and power limit, and as the last
line a JSON object {row: {"planned": run, "ms": {run: ms}}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUNS = (1, 2, 4, 8, 16)
N = 8_000_000


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import multirate_tpu_torch as mt
    from multirate_tpu_torch.ops import indexing as idx
    from multirate_tpu_torch.ops.cuda import resample as rs

    dev = torch.device("cuda", 0)
    ha = cs.bench_taps(mt)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(N).astype(
        np.float32)).to(dev)
    xc = torch.complex(x, x.flip(0))
    sig = {torch.float32: x, torch.float64: x.double(),
           torch.complex64: xc, torch.complex128: xc.to(torch.complex128)}
    rows = []
    for rate, po, name in ((cs.R_REF, None, "arbitrary_refrate"),
                           (0.4709, 4, "farrow_0.4709"),
                           (0.3, None, "arbitrary_0.3"),
                           (0.9173, None, "arbitrary_0.9173"),
                           (2.5, 4, "farrow_2.5")):
        rows.append((name, mt.make_kernel(ha, rate=rate, nphi=32,
                                          polyorder=po, device=dev),
                     torch.float32))
    for name, rate, po in (("arbitrary_refrate_f64", cs.R_REF, None),
                           ("farrow_0.4709_f64", 0.4709, 4)):
        rows.append((name, mt.make_kernel(ha.astype(np.float64), rate=rate,
                                          nphi=32, polyorder=po, device=dev),
                     torch.float64))
    for entry, (sig_name, taps_name, _) in cs.WIDE.items():
        if entry != "f64":
            taps = cs._wide_taps(torch, ha, getattr(torch, taps_name))
            rows.append((f"resample_{entry}", mt.make_kernel(
                taps, rate=cs.R_REF, nphi=32, device=dev),
                getattr(torch, sig_name)))
    rows.append(("resampler_block_65536",
                 mt.models.Resampler(cs.R_REF, device=dev).kernel,
                 torch.float32))

    orig = rs.plan
    out = {}
    try:
        for name, p, dt in rows:
            xs = sig[dt][: 1 << 16 if name.startswith("resampler") else N]
            xs = xs.reshape(1, -1)
            st = mt.init_state(p, (1,), dt)
            n, _, _ = idx.host_carry(p, st.phase, st.deficit, xs.shape[1])
            args = (xs, st.history.contiguous(), p, st.phase, st.deficit, n)
            planned = orig(p.taps_per_phi, p.table.shape[0], p.nphi,
                           p.delta_fx, n, 1, dt, p.table.dtype)
            want = rs.resample(*args)
            ms = {}
            for run in RUNS:
                forced = planned._replace(
                    run=run, threads=rs._threads(planned.tile, run, False))
                rs.plan = lambda *a, _f=forced, **k: _f
                got = rs.resample(*args)
                torch.cuda.synchronize()
                cs.check(torch.equal(got, want),
                         f"{name}: run {run} differs from run {planned.run}")
                ms[run] = cs._time_ms(torch, lambda: rs.resample(*args),
                                      iters=20)
                rs.plan = orig
            out[name] = {"planned": planned.run, "variant": planned.variant,
                         "tile": planned.tile, "ms": ms}
            best = min(ms, key=ms.get)
            print(f"{name} ({planned.variant}, tile {planned.tile}): planned "
                  f"run {planned.run} {ms[planned.run]:.4f} ms; best run "
                  f"{best} {ms[best]:.4f} ms; "
                  + ", ".join(f"run {r} {t:.4f}" for r, t in ms.items()))
    finally:
        rs.plan = orig
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
