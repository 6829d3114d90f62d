"""Time the polyphase kernel's ``reg`` and ``reg.tma`` variants at
``dat_to_cd.madi_block``'s call (64 x 1,048,576 float32 samples, 147//160,
the headline's 3,528 taps: T = 24), with a clock64 split of each, and sweep
``reg.tma``'s ring depth, its periods a thread a tile and the launch size
at which it overtakes ``reg``.

- The split: ``csrc/polyphase.cu`` built once more with
  ``-DMR_CLOCKS`` (``build.load``'s ``defines``), so
  that every thread adds its clock64 intervals by part (``ClockPart``: the
  prologue, staging issued, the wait for a tile, the dot, the stores, the
  release; ``reg.tma``'s producer warp apart: its wait for a free buffer
  and its staging). Each part is printed as a share of its threads' clocks.
- The sweeps: plans forced through ``polyphase.plan`` (as
  ``tools/resample_runs.py`` forces ``resample.plan``): ring depths 2-8 and
  3-16 periods a thread at madi's call (the planner library's, asked for
  them through ``polyphase._plan``); one-channel calls of 2^12 to 2^23
  samples through ``reg`` and ``reg.tma``, for ``TMA_MIN_TILES``.

Every forced plan's output must equal ``reg``'s bit for bit. Times: the
median of 7 runs of 20 back-to-back calls between CUDA events (``chip_smoke
._time_ms``). Needs one CUDA card; imports no JAX. From the repo root:

    python3 tools/polyphase_runs.py [--only-reg]

``--only-reg`` times and splits ``reg`` alone (the design before
``reg.tma``). Prints one line a measurement, the card's name and power
limit, and as the last line a JSON object {"madi": {variant: ms},
"split": {variant: {part: share}}, "depth": {depth: {periods: ms}},
"launch": {samples: {"tiles": n, "reg": ms, "reg.tma": ms}}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from fractions import Fraction

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MADI = (64, 1 << 20)
DEPTHS = (2, 3, 4, 6, 8)
PERIODS = (3, 6, 8, 12, 16)  # periods a thread a tile
LAUNCH = tuple(1 << k for k in range(12, 24))  # one-channel samples
PARTS = ("taps", "stage", "wait", "dot", "store", "release", "free")
CONSUMER = ("taps", "wait", "dot", "store", "release")  # reg: and "stage"
PRODUCER = ("free", "stage")


def _args(mt, torch, dev, rng, shape, h):
    """A polyphase call at 147//160 on ``shape`` samples, entered mid-stream
    (the state after 1,237 samples, so that the alignment of a tile's first
    sample is not 0)."""
    from multirate_tpu_torch.ops import indexing as idx

    p = mt.make_kernel(h, ratio=Fraction(147, 160), device=dev)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    st = mt.init_state(p, shape[:1])
    _, _, st = mt.filt_block(p, st, x[:, :1237], path="windows")
    n, _, _ = idx.host_carry(p, st.phase, st.deficit, shape[1])
    return (x, st.history.contiguous(), p.bank, 147, 160, st.phase,
            st.deficit, n)


def _forced(plan):
    """A stand-in for pp.plan that returns ``plan`` whatever it is
    asked."""
    return lambda *a, **k: plan


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import multirate_tpu_torch as mt
    from multirate_tpu_torch.ops.cuda import build
    from multirate_tpu_torch.ops.cuda import polyphase as pp

    only_reg = "--only-reg" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    h = cs.headline_taps(mt)
    rng = np.random.default_rng(0)
    args = _args(mt, torch, dev, rng, MADI, h)
    shape = (24, 147, 160, args[-1], torch.float32, torch.float32, MADI[0])
    variants = ("reg",) if only_reg else ("reg", "reg.tma")
    out = {"madi": {}, "split": {}, "depth": {}, "launch": {}}
    orig_plan, orig_load = pp.plan, build.load
    try:
        want = pp.polyphase(*args, variant="reg")
        for v in variants:
            got = pp.polyphase(*args, variant=v)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"madi: {v} differs from reg")
            out["madi"][v] = cs._time_ms(
                torch, lambda v=v: pp.polyphase(*args, variant=v), iters=20)
            print(f"madi {v} {orig_plan(*shape, v)}: "
                  f"{out['madi'][v]:.4f} ms a call")

        defines = ("MR_CLOCKS",)
        clocks = orig_load("polyphase", pp.SIGNATURES, defines)
        clocks.mr_polyphase_clocks.argtypes = [np.ctypeslib.ndpointer(
            np.uint64, flags="C_CONTIGUOUS")]
        sums = np.zeros(len(PARTS), np.uint64)
        # the wrapper's launches load the clock build
        build.load = lambda name, sigs, d=(): orig_load(
            name, sigs, defines if name == "polyphase" else d)
        for v in variants:
            clocks.mr_polyphase_clocks(sums)  # cleared
            ms = cs._time_ms(torch, lambda v=v: pp.polyphase(
                *args, variant=v), iters=5, reps=1)
            clocks.mr_polyphase_clocks(sums)
            part = dict(zip(PARTS, (int(s) for s in sums)))
            groups = ((("consumers", CONSUMER + ("stage",)),) if v == "reg"
                      else (("consumers", CONSUMER), ("producer",
                                                        PRODUCER)))
            split = {}
            for name, keys in groups:
                total = sum(part[k] for k in keys) or 1
                split[name] = {k: part[k] / total for k in keys}
                print(f"split {v} {name} (instrumented, {ms:.4f} ms a "
                      f"call): " + ", ".join(
                          f"{k} {100 * s:.1f}%"
                          for k, s in split[name].items()))
            out["split"][v] = split
        build.load = orig_load

        if not only_reg:
            for depth in DEPTHS:
                out["depth"][depth] = {}
                for per in PERIODS:
                    try:
                        forced = pp._plan(*shape, "reg.tma", True, 0, depth,
                                          per)
                    except ValueError:  # the ring exceeds shared memory
                        continue
                    pp.plan = _forced(forced)
                    got = pp.polyphase(*args)
                    torch.cuda.synchronize()
                    cs.check(torch.equal(got, want),
                             f"depth {depth}, {per} periods a thread: "
                             f"differs from reg")
                    ms = cs._time_ms(torch, lambda: pp.polyphase(*args),
                                     iters=20)
                    pp.plan = orig_plan
                    out["depth"][depth][per] = ms
                print(f"depth {depth}: " + ", ".join(
                    f"{per} periods a thread {ms:.4f} ms"
                    for per, ms in out["depth"][depth].items()))

            for n_in in LAUNCH:
                a = _args(mt, torch, dev, rng, (1, n_in), h)
                ref = pp.polyphase(*a, variant="reg")
                row = {"tiles": orig_plan(24, 147, 160, a[-1],
                                          torch.float32, torch.float32, 1,
                                          "reg.tma").grid}
                for v in variants:
                    got = pp.polyphase(*a, variant=v)
                    torch.cuda.synchronize()
                    cs.check(torch.equal(got, ref),
                             f"{n_in} samples: {v} differs from reg")
                    row[v] = cs._time_ms(
                        torch, lambda v=v: pp.polyphase(*a, variant=v),
                        iters=20)
                out["launch"][n_in] = row
                print(f"one channel, {n_in} samples ({row['tiles']} "
                      f"reg.tma tiles): reg {row['reg']:.4f} ms, reg.tma "
                      f"{row['reg.tma']:.4f} ms; planned "
                      f"{orig_plan(24, 147, 160, a[-1], torch.float32, torch.float32).variant}")
    finally:
        pp.plan, build.load = orig_plan, orig_load
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
