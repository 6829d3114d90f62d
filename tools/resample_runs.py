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

    python3 tools/resample_runs.py [--tma | --host]

Prints one line a row, the card's name and power limit, and as the last
line a JSON object {row: {"planned": run, "variant": ..., "tile": ...,
"ms": {run: ms}, "grouped": {outputs a thread: ms}, "planned_ms": ms}}.

``--tma`` times the grouped path's producer-fed form (``t10p5.grouped.tma``,
``t10p2.grouped.tma``) against the grouped path and the run path, each
output bit-equal to the run path's: at capture's call and the two bench
rows at 1/2.123456789 over its ring stages (``DEPTHS_GT``), outputs a
thread a tile (``ROWS_GT``) and lane multiplier (the planner's and 8),
through ``resample._plan``; at one-channel calls of 2^20 to 2^26 samples
(``LADDER``: where it overtakes the grouped path); and a clock64 split of
both grouped kernels at capture's call (the source built again with
``-DMR_CLOCKS``: ``ClockPart``'s shares of the consumers' and the
producer's clocks). Its last line is {"tma": {row: {variant: ms,
"planned": [...], "sweep": {"depth/rows/mult": ms}}}, "ladder": {samples:
{variant: ms, ...}}, "split": {variant: {threads: {part: share}}}}.

``--host`` times ``arb_farrow.capture_block``'s ``filt`` on the host,
untraced (``host_first_calls``).
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
# grouped.tma: ring stages and outputs a thread a tile (multiples of 4);
# one-channel calls for the ladder
DEPTHS_GT = (2, 3, 4, 6)
ROWS_GT = (8, 12, 16, 20, 24)
LADDER = tuple(1 << k for k in range(20, 27))
# the clock parts (csrc/resample.cu ClockPart), and whose clocks each is
CLOCK_PARTS = ("table", "stage", "wait", "dot", "barrier", "store", "free")
GROUPED_PARTS = ("table", "stage", "wait", "dot", "barrier", "store")
CONSUMER_PARTS = ("table", "wait", "dot", "barrier", "store")
# (the producer's prologue counts in "table", with the consumers')
PRODUCER_PARTS = ("free", "stage")


def host_first_calls(torch, calls=100, reps=5, device="cuda", loops=1000):
    """``arb_farrow.capture_block``'s call as the benchmark makes it
    (``FIRFilter.filt`` on 2^26 float32 samples, one host thread, two inputs
    in turn, state carried), untraced: the host's time a ``filt`` call, the
    mean of the first ``calls`` calls after a synchronize (before the launch
    queue fills), the median of ``reps`` such means; the device's time a
    call, back to back; and a closed loop's time a call (``loops`` calls,
    the inputs in turn, closed by a synchronize: what ``block_msps``
    measures). Returns (host_us, call_us, loop_us)."""
    import json
    import statistics
    import time

    import chip_smoke as cs
    from benchmark import designs, generator
    from multirate_tpu_torch import FIRFilter

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "arb_farrow.json")) as fh:
        cfg = json.load(fh)
    torch.set_num_threads(int(cfg["host_threads"]))
    taps = designs.taps(cfg).astype(cfg["dtype"])
    spec, kw = generator.program_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    xs = [torch.randn(N_CAPTURE, generator=gen, device=device)
          for _ in range(2)]
    f = FIRFilter(taps, spec, device=device, **kw)
    for x in xs:
        f.filt(x)
    means = []
    for _ in range(reps):
        torch.cuda.synchronize()
        spent = 0.0
        for k in range(calls):
            t0 = time.perf_counter()
            f.filt(xs[k % 2])
            spent += time.perf_counter() - t0
        means.append(1e6 * spent / calls)
    torch.cuda.synchronize()
    call_us = 1e3 * cs._time_ms(torch, lambda: f.filt(xs[0]), iters=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(loops):
        y = f.filt(xs[k % 2])
    torch.cuda.synchronize()
    loop_us = 1e6 * (time.perf_counter() - t0) / loops
    del y
    return statistics.median(means), call_us, loop_us


def _call(mt, torch, dev, po, x):
    """(args, shape): ``rs.resample``'s arguments for bench.py's bank at
    1/2.123456789 (Farrow at ``po``, else arbitrary) on one channel ``x``
    from a fresh state, and ``rs.plan``'s shape arguments for it."""
    import chip_smoke as cs
    from multirate_tpu_torch.ops import indexing as idx

    p = mt.make_kernel(cs.bench_taps(mt), rate=cs.R_REF, nphi=32,
                       polyorder=po, device=dev)
    x = x.reshape(1, -1)
    st = mt.init_state(p, (1,))
    n, _, _ = idx.host_carry(p, st.phase, st.deficit, x.shape[1])
    return ((x, st.history.contiguous(), p, st.phase, st.deficit, n),
            (10, p.table.shape[0], 32, p.delta_fx, n, 1, torch.float32,
             torch.float32))


def _blocks_an_sm(smem):
    """Blocks of ``smem`` dynamic shared bytes an H100 SM holds (228 KB,
    1 KB a block reserved), at most the two the launch bounds allow."""
    return min(2, (228 * 1024) // (smem + 1024))


def sweep_tma(torch, out):
    """grouped.tma against grouped and the run path, bit for bit: its ring
    stages, outputs a thread a tile and lane multiplier at capture's call;
    the same at bench.py's two rows at 1/2.123456789; a ladder of call
    sizes; and the clock split of grouped and grouped.tma at capture's
    call (the source built again with -DMR_CLOCKS)."""
    import chip_smoke as cs
    import multirate_tpu_torch as mt
    from multirate_tpu_torch.ops.cuda import build
    from multirate_tpu_torch.ops.cuda import resample as rs

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    capture = torch.from_numpy(rng.standard_normal(N_CAPTURE).astype(
        np.float32)).to(dev)
    orig_plan, orig_load = rs.plan, build.load

    def timed(args, plan, want, label):
        rs.plan = lambda *a, **k: plan
        try:
            got = rs.resample(*args)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"{label}: differs from the "
                     f"run path")
            return cs._time_ms(torch, lambda: rs.resample(*args), iters=20)
        finally:
            rs.plan = orig_plan

    rows = (("capture", 4, capture), ("farrow_refrate", 4, capture[:N]),
            ("arbitrary_refrate", None, capture[:N]))
    out["tma"] = {}
    for name, po, x in rows:
        args, shape = _call(mt, torch, dev, po, x)
        base = "t10p2" if po is None else "t10p5"
        want = rs.resample(*args, variant=base)
        res = {v: timed(args, orig_plan(*shape, False, v), want, v)
               for v in (base, rs.GROUPED[base], rs.GROUPED_TMA[base])}
        chosen = orig_plan(*shape)
        res["planned"] = [chosen.variant, chosen.tile, chosen.depth,
                          chosen.mult]
        sweep = {}
        for depth in DEPTHS_GT:
            for r in ROWS_GT:
                try:
                    forced = rs._plan(*shape, False, rs.GROUPED_TMA[base], 0,
                                      r, depth)
                except ValueError:  # past the tile or shared memory
                    continue
                for mult in sorted({forced.mult, 8}):
                    f = forced._replace(mult=mult)
                    ms = timed(args, f, want, f"{name} {f}")
                    sweep[f"{depth}/{r}/{mult}"] = ms
                    print(f"{name} grouped.tma depth {depth}, {r} outputs a "
                          f"thread, mult {mult} (smem {f.smem}, "
                          f"{_blocks_an_sm(f.smem)} blocks an SM): "
                          f"{ms:.4f} ms")
        res["sweep"] = sweep
        best = min(sweep, key=sweep.get)
        print(f"{name}: run path {res[base]:.4f}, grouped "
              f"{res[rs.GROUPED[base]]:.4f}, grouped.tma planned "
              f"{res[rs.GROUPED_TMA[base]]:.4f} ms ({chosen}); best "
              f"depth/rows/mult {best} {sweep[best]:.4f} ms")
        out["tma"][name] = res

    out["ladder"] = {}
    for n_in in LADDER:
        args, shape = _call(mt, torch, dev, 4, capture[:n_in])
        want = rs.resample(*args, variant="t10p5")
        row = {"planned": orig_plan(*shape).variant}
        for v in ("t10p5", "t10p5.grouped", "t10p5.grouped.tma"):
            plan = orig_plan(*shape, False, v)
            row[v] = timed(args, plan, want, f"{n_in} samples {v}")
            row[f"{v} tiles"] = -(-shape[4] // plan.tile)
        out["ladder"][n_in] = row
        print(f"one channel, {n_in} samples: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))

    # the clock split: each part as a share of its threads' clocks
    defines = ("MR_CLOCKS",)
    clocks = orig_load("resample", rs.SIGNATURES, defines)
    clocks.mr_resample_clocks.argtypes = [np.ctypeslib.ndpointer(
        np.uint64, flags="C_CONTIGUOUS")]
    sums = np.zeros(len(CLOCK_PARTS), np.uint64)
    build.load = lambda name, sigs, d=(): orig_load(
        name, sigs, defines if name == "resample" else d)
    out["split"] = {}
    try:
        args, shape = _call(mt, torch, dev, 4, capture)
        for v in ("t10p5.grouped", "t10p5.grouped.tma"):
            clocks.mr_resample_clocks(sums)  # cleared
            ms = cs._time_ms(torch, lambda v=v: rs.resample(
                *args, variant=v), iters=5, reps=1)
            clocks.mr_resample_clocks(sums)
            part = dict(zip(CLOCK_PARTS, (int(c) for c in sums)))
            groups = ((("consumers", GROUPED_PARTS),) if v == "t10p5.grouped"
                      else (("consumers", CONSUMER_PARTS),
                            ("producer", PRODUCER_PARTS)))
            split = {}
            for name, keys in groups:
                total = sum(part[k] for k in keys) or 1
                split[name] = {k: part[k] / total for k in keys}
                print(f"split {v} {name} (instrumented, {ms:.4f} ms a "
                      f"call): " + ", ".join(
                          f"{k} {100 * c:.1f}%"
                          for k, c in split[name].items()))
            out["split"][v] = split
    finally:
        build.load = orig_load


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out = {}
    if "--tma" in sys.argv[1:]:
        sweep_tma(torch, out)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip())
        print(json.dumps(out))
        return 0
    if "--host" in sys.argv[1:]:
        host_us, call_us, loop_us = host_first_calls(torch)
        print(f"capture filt host {host_us:.1f} us a call (mean of the "
              f"first 100 after a synchronize, median of 5); call "
              f"{call_us:.1f} us back to back; closed loop {loop_us:.1f} "
              f"us a call")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip())
        return 0
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
            base = orig(*shape).variant.split(".")[0]
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
