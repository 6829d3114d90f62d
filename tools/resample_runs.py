"""Time the resample kernel at each run (neighbouring outputs a thread
takes: 1, 2, 4, 8, 16) on one-channel rows, beside the run that
``ops/cuda/resample.plan`` picks, and its grouped path (float32 tables)
at each number of outputs a thread a tile (8 to 32) beside the planned
one.

The planner picks the least run whose lanes' windows lie within 1/32
sample of an odd number of samples apart, else 1 (the planner library's
``run_of``, ``csrc/mr_plan.cpp``);
this sweep measures every run the kernel takes, on the main path's
one-channel rows (``bench.py``'s bank at 1/2.123456789 and 0.4709, in
float32 (arbitrary and Farrow at 1/2.123456789), float64 and the four
complex entry points, one 65,536-sample
block of ``models.Resampler(1/2.123456789)``, and one 2^26-sample call at
1/2.123456789, ``arb_farrow.capture_block``'s) and on rates where the
planner picks run 1 (0.3, 0.9173 and 2.5). A float32 table's row also
runs the grouped path (``t10p2.grouped``, ``t10p5.grouped``) at its
stride (the planner's, or 256 at a rate that keeps no phase) with 8, 12,
16, 20, 24 and 32 outputs a thread a tile, so that the tile and the rows
the planner sends down the grouped path are measured. Each run's and
each tile's output must equal the planned one bit for bit. Needs one CUDA
card; imports no JAX. From the repo root:

    python3 tools/resample_runs.py

Prints one line a row, the card's name and power limit, and as the last
line a JSON object {row: {"planned": run, "variant": ..., "tile": ...,
"ms": {run: ms}, "grouped": {outputs a thread: ms}, "planned_ms": ms}}.
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
ROWS_G = (8, 12, 16, 20, 24, 32)  # grouped: outputs a thread a tile
N = 8_000_000
N_CAPTURE = 1 << 26  # arb_farrow.capture_block's call


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
                           (cs.R_REF, 4, "farrow_refrate"),
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
    rows.append(("farrow_refrate_capture", mt.make_kernel(
        cs.bench_taps(mt), rate=cs.R_REF, nphi=32, polyorder=4, device=dev),
        torch.float32))
    capture = torch.from_numpy(np.random.default_rng(1).standard_normal(
        N_CAPTURE).astype(np.float32)).to(dev)

    orig = rs.plan
    out = {}
    try:
        for name, p, dt in rows:
            xs = (capture if name.endswith("capture")
                  else sig[dt][: 1 << 16 if name.startswith("resampler")
                               else N])
            xs = xs.reshape(1, -1)
            st = mt.init_state(p, (1,), dt)
            n, _, _ = idx.host_carry(p, st.phase, st.deficit, xs.shape[1])
            args = (xs, st.history.contiguous(), p, st.phase, st.deficit, n)
            shape = (p.taps_per_phi, p.table.shape[0], p.nphi, p.delta_fx,
                     n, 1, dt, p.table.dtype)
            base = orig(*shape).variant.removesuffix(".grouped")
            planned = orig(*shape, False, base)  # the run path's plan
            want = rs.resample(*args, variant=base)
            ms = {}
            for run in RUNS:  # the run path's plan at each run
                forced = rs._plan(*shape, False, base, run)
                rs.plan = lambda *a, _f=forced, **k: _f
                got = rs.resample(*args)
                torch.cuda.synchronize()
                cs.check(torch.equal(got, want),
                         f"{name}: run {run} differs from run {planned.run}")
                ms[run] = cs._time_ms(torch, lambda: rs.resample(*args),
                                      iters=20)
                rs.plan = orig
            grouped = {}
            if (base in rs.GROUPED and p.table.dtype == torch.float32
                    and dt == torch.float32):
                g = orig(*shape, False, rs.GROUPED[base])
                for r in ROWS_G:
                    try:  # the grouped plan at r outputs a thread a tile
                        forced = rs._plan(*shape, False, g.variant, 0, r)
                    except ValueError:  # past the tile or shared memory
                        continue
                    rs.plan = lambda *a, _f=forced, **k: _f
                    got = rs.resample(*args)
                    torch.cuda.synchronize()
                    cs.check(torch.equal(got, want),
                             f"{name}: grouped at {r} outputs a thread "
                             f"differs from the run path")
                    grouped[r] = cs._time_ms(
                        torch, lambda: rs.resample(*args), iters=20)
                    rs.plan = orig
            chosen = orig(*shape)
            planned_ms = cs._time_ms(torch, lambda: rs.resample(*args),
                                     iters=20)
            out[name] = {"planned": planned.run, "variant": chosen.variant,
                         "tile": chosen.tile, "ms": ms, "grouped": grouped,
                         "planned_ms": planned_ms}
            best = min(ms, key=ms.get)
            print(f"{name} ({chosen.variant}, tile {chosen.tile}): planned "
                  f"{planned_ms:.4f} ms; run {planned.run} "
                  f"{ms[planned.run]:.4f} ms; best run {best} "
                  f"{ms[best]:.4f} ms; "
                  + ", ".join(f"run {r} {t:.4f}" for r, t in ms.items())
                  + "".join(f"; grouped {r} a thread {t:.4f}"
                            for r, t in grouped.items()))
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
