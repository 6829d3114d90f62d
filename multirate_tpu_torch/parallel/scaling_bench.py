"""Sharding overhead-structure benchmark on ranks of one host.

Counterpart of ``multirate_tpu/parallel/scaling_bench.py``:

    python -m multirate_tpu_torch.parallel.scaling_bench [--device cuda|cpu]
                                                         [--ranks N]

spawns a gloo world of N ranks (default 4) on this host, all on the CPU or
all on the card (``cuda:0``), and prints one JSON object on stdout.

With one host, multi-card speedup is NOT measurable: the ranks share the
host's cores, or one card. What IS soundly measurable is the *overhead
structure* of the sharded step: how much extra total work the halo
exchange, the per-shard closed-form entry state and the history broadcast
add over running the same kernel on the same per-shard blocks unsharded.
That overhead decides scaling efficiency where each shard has a card of
its own (the per-shard compute is identical; only the added work and
communication eat the >=80% BASELINE target).

Workload (the JAX package's): rational 147//160 with 24*147 Kaiser taps,
float32, C = 8 channels, per-shard block B = 65,600 = 410*160 (a multiple
of M = 160, so every shard enters on the fresh phase: the module docstring
of ``sharded.py``), shard counts 1, 2, 4 and 8 up to N, on meshes
(1, n) over ranks 0..n-1. Every measurement runs the one kernel path the
device takes (``kernel`` on the card, the plain ``windows`` version on the
CPU); the port has one kernel per family, so no path is pinned.

- Weak scaling: per-shard block B is FIXED; the global size grows as
  n*B. ``work_overhead_ratio[n]`` = total work of the sharded step over
  n shards / (n * the unsharded step on one B-block). 1.0 = sharding adds
  no work; the BASELINE bar is <= 1.1.
- On the CPU the work is process CPU time summed over the ranks, which
  run the step together (core contention cancels; what remains is added
  work), as the JAX package measures its virtual mesh. Rounds interleave
  the unsharded step and every shard count, so drift cancels.
- On the card the ranks share one GPU. The halo exchange and the history
  broadcast run on every rank together, after a synchronize and a
  barrier, and each rank times its own on the host clock, to a
  synchronize after it: over gloo they are host-staged copies and host
  sends, so the host clock is theirs, and no rank queues device work
  that another's copies would wait behind. With one shard there is no
  exchange, and the history's copy on the card is timed as a kernel is. Then each rank times its
  kernel alone on the card, in turn (a barrier between turns), with CUDA
  events: a device-side sleep queued ahead of the span hides the host's
  enqueue, so the events span the kernel on the stream. The unsharded
  block is timed likewise. The work is the sum over the shards of kernel
  and halo time; the weak wall is the halo's span plus the kernel's.
- ``artifact_floor_ratio[n]``: the same per-shard kernel with a fresh
  state and no halo, over n times the unsharded block: what sharding
  costs with no communication and no entry state at all.
- Strong scaling: the global size is fixed at max(n)*B. The wall time of
  the sharded step (all ranks together) against n is a sanity check only:
  the ranks share one host's cores, or one card, so it says nothing of
  multi-card scaling. ``strong_work_overhead_ratio[n]`` is the sound
  figure (total work sharded / unsharded, same size);
  ``strong_projected_efficiency`` is its inverse clamped to 1.0 (the
  unclamped figure is ``1 / strong_work_overhead_ratio``, printed beside
  it). Superlinear wall speedups (> 1.05 n) fail the run: the harness
  would be unsound.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist

C, B = 8, 65_600
SHARDS = (1, 2, 4, 8)
ROUNDS = {"cpu": 12, "cuda": 7}
SLEEP_CYCLES = 5_000_000  # ~3 ms of device-side sleep ahead of a kernel
STRONG_ROUNDS = {"cpu": 9, "cuda": 5}


def _taps():
    from .. import design

    return (design.firdes(24 * 147, 0.5 / 147, design.kaiser, beta=7.8562)
            * 147).astype(np.float32)


class _Clock:
    """Times one step on this rank: process CPU time on the CPU, CUDA
    events on the card (the span between two events recorded around the
    step on the current stream, read after a synchronize)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def __call__(self, fn):
        """(seconds of ``fn``, wall seconds). On the card a device-side
        sleep queued first keeps the card busy while the host enqueues
        ``fn``, so the events span its work on the card's stream alone,
        and the wall is that span too."""
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            secs = e0.elapsed_time(e1) / 1e3
            return secs, secs
        t0, c0 = time.perf_counter(), time.process_time()
        fn()
        return time.process_time() - c0, time.perf_counter() - t0


def host_span(fn) -> float:
    """Host seconds of ``fn`` on the card, from a synchronize before it to
    one after it, with no device work queued ahead: the span of a
    host-staged exchange, which waits on its peers."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _sum_over_ranks(v: float) -> float:
    t = torch.tensor([v], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t[0])


def _max_over_ranks(v: float) -> float:
    t = torch.tensor([v], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def _bench_rank(rank, device, ranks):
    """One rank of the benchmark's world; rank 0 returns the JSON object."""
    from .. import ops
    from . import sharded as sh

    dev = torch.device(device)
    path = "kernel" if dev.type == "cuda" else "windows"
    clock = _Clock(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = ops.make_kernel(_taps(), ratio=Fraction(147, 160), device=dev)
    counts = [n for n in SHARDS if n <= ranks]
    meshes = {n: sh.make_mesh(1, n, ranks=range(n)) for n in counts}
    rng = np.random.default_rng(0)  # the same samples on every rank
    fresh = ops.init_state(params, (C,), torch.float32, device=dev)

    def signal(n_samples):
        return torch.from_numpy(rng.standard_normal(
            (C, n_samples)).astype(np.float32)).to(dev)

    def unsharded(x):
        return lambda: ops.filt_block(params, fresh, x, path)

    def local(x, n):
        return x[:, rank * (x.shape[-1] // n):(rank + 1) * (x.shape[-1] // n)]

    def sharded_work(x, n):
        """This rank's (step seconds, halo seconds, wall seconds) of the
        sharded step on ``x`` over n shards, (0, 0, 0) off the mesh. On
        the CPU the ranks run together; on the card the halo and the
        history broadcast run together and the kernels in turn."""
        on = rank < n
        xl = local(x, n) if on else None
        mesh = meshes[n]
        if dev.type == "cpu":
            dist.barrier()
            secs, wall = clock(lambda: sh.shard_filt_block(
                params, fresh, xl, mesh, path)) if on else (0.0, 0.0)
            return secs, 0.0, wall
        halo = [None]

        def comm():
            halo[0] = sh.exchange_halo(fresh.history, xl, mesh)
            sh.broadcast_tail(xl, params.h_min, mesh)

        sync()
        dist.barrier()
        if n == 1:  # no exchange: the history's copy on the card alone
            comm_s = clock(comm)[0] if on else 0.0
        else:
            comm_s = host_span(comm) if on else 0.0
        wall, step_s = comm_s, 0.0
        for turn in range(n):
            dist.barrier()
            if rank == turn:
                step_s, w = clock(lambda: sh.shard_step(
                    params, fresh, halo[0], xl, rank, path))
                wall += w
        return step_s, comm_s, wall

    def floor_work(x, n):
        """The same per-shard kernel with a fresh state and no halo."""
        on = rank < n
        xl = local(x, n) if on else None
        secs = 0.0
        for turn in (range(n) if dev.type == "cuda" else (None,)):
            dist.barrier()
            if on and turn in (None, rank):
                secs, _ = clock(lambda: ops.filt_block(params, fresh, xl,
                                                       path))
        return secs

    def alone(fn):
        """Rank 0 runs ``fn`` alone: (seconds, wall seconds) on every
        rank."""
        dist.barrier()
        got = clock(fn) if rank == 0 else (0.0, 0.0)
        return _max_over_ranks(got[0]), _max_over_ranks(got[1])

    # ---- build, load and warm everything before any timing ------------ #
    x1 = signal(B)
    xw = {n: signal(n * B) for n in counts}
    for _ in range(2):
        alone(unsharded(x1))
        for n in counts:
            sharded_work(xw[n], n)
            floor_work(xw[n], n)
    sync()

    # ---- weak scaling: interleaved rounds ----------------------------- #
    un_c, un_w = [], []
    wc = {n: [] for n in counts}
    ww = {n: [] for n in counts}
    fc = {n: [] for n in counts}
    halo_c = {n: [] for n in counts}
    for _ in range(ROUNDS[dev.type]):
        c, w = alone(unsharded(x1))
        un_c.append(c)
        un_w.append(w)
        for n in counts:
            step_s, comm_s, wall = sharded_work(xw[n], n)
            wc[n].append(_sum_over_ranks(step_s + comm_s))
            halo_c[n].append(_sum_over_ranks(comm_s))
            ww[n].append(_max_over_ranks(wall))
            fc[n].append(_sum_over_ranks(floor_work(xw[n], n)))
    c_un = statistics.median(un_c)
    overhead = {str(n): round(statistics.median(wc[n]) / (n * c_un), 3)
                for n in counts}
    floor = {str(n): round(statistics.median(fc[n]) / (n * c_un), 3)
             for n in counts}

    # ---- strong scaling: fixed global size ---------------------------- #
    n_g = max(counts) * B
    xg = signal(n_g)
    sw = {n: [] for n in counts}
    sc = {n: [] for n in counts}
    ug_c = []
    alone(unsharded(xg))
    for _ in range(STRONG_ROUNDS[dev.type]):
        ug_c.append(alone(unsharded(xg))[0])
        for n in counts:
            on = rank < n
            xl = local(xg, n) if on else None
            dist.barrier()
            t0 = time.perf_counter()
            if on:  # every rank of the mesh together, on the wall clock
                sh.shard_filt_block(params, fresh, xl, meshes[n], path)
                sync()
            sw[n].append(_max_over_ranks(time.perf_counter() - t0))
            step_s, comm_s, _ = sharded_work(xg, n)
            sc[n].append(_sum_over_ranks(step_s + comm_s))
    strong_wall = {str(n): statistics.median(sw[n]) for n in counts}
    c_un_g = statistics.median(ug_c)
    strong_work = {str(n): round(statistics.median(sc[n]) / c_un_g, 3)
                   for n in counts}
    strong_eff = {k: round(min(1.0, 1.0 / v), 3)
                  for k, v in strong_work.items()}
    t1 = strong_wall["1"]
    speedup = {k: round(t1 / v, 3) for k, v in strong_wall.items()}
    for k, s in speedup.items():
        if s > 1.05 * int(k):
            raise RuntimeError(
                f"superlinear artifact at n_t={k}: {s}x (harness unsound)")
    if rank:
        return None
    card = (f"{torch.cuda.get_device_name(dev)} x1, shared by {ranks} "
            f"ranks" if dev.type == "cuda" else f"CPU, {ranks} ranks")
    timing = ("CUDA events, each rank's kernel alone in turn; halo and "
              "history broadcast on each rank's host clock, between "
              "synchronizes, while all take part"
              if dev.type == "cuda" else
              "process CPU time summed over the ranks, which run together")
    # the work's name: JAX's "cpu" on the CPU, "device" on the card
    work = "cpu" if dev.type == "cpu" else "device"
    return {
        "workload": (f"rational 147//160, C={C}, per-shard block B={B} "
                     f"(multiple of M=160: fresh entry phase on every shard "
                     f"- see the module docstring), float32"),
        "device": card,
        "timing": timing,
        "n_devices": ranks,
        "kernel_path": path,
        "unsharded_block_seconds": {"wall": statistics.median(un_w),
                                    work: c_un},
        "weak_wall_seconds": {str(n): statistics.median(ww[n])
                              for n in counts},
        f"weak_{work}_seconds": {str(n): statistics.median(wc[n])
                                 for n in counts},
        "weak_halo_seconds": {str(n): statistics.median(halo_c[n])
                              for n in counts},
        # total work of the sharded step over n shards / (n * unsharded
        # B-block): halo exchange + per-shard entry state + history
        # broadcast. 1.0 = no added work; BASELINE's >=80% multi-card
        # efficiency needs <= ~1.1 here plus a link-latency term.
        "work_overhead_ratio": overhead,
        "work_overhead_ratio_max": max(overhead.values()),
        # the same kernel with no halo and a fresh state
        "artifact_floor_ratio": floor,
        "strong_wall_seconds": strong_wall,
        # shared-host wall speedup: sanity/monotonicity only, NOT a
        # multi-card scaling claim
        "strong_wall_speedup_shared_cores": speedup,
        "strong_work_overhead_ratio": strong_work,
        "strong_projected_efficiency": strong_eff,
        "strong_scaling_note": (
            "Wall-clock strong scaling is unmeasurable here: the ranks "
            "share one host's cores or one card, so "
            "strong_wall_speedup_shared_cores is a sanity check only and "
            "says nothing about scaling across cards. "
            "strong_work_overhead_ratio is the sound figure: the total "
            "work of the sharded fixed-size problem over the unsharded "
            "same-size run. Where each shard has a card of its own, "
            "projected strong efficiency = 1/ratio (clamped to 1.0 in "
            "strong_projected_efficiency) minus the link latency of the "
            "h_min*4-byte halo per channel and boundary."),
    }


def run(device: str | None = None, ranks: int = 4,
        timeout_s: float = 600.0):
    """The benchmark's JSON object, from a world of ``ranks`` spawned
    ranks on ``device``: the card by default (every rank on ``cuda:0``; no
    card raises), or ``cpu`` when the caller names it."""
    from .multihost import spawn_world, world_device

    device = world_device(device)
    if device != "cpu":
        from ..ops.cuda import build

        build.build("polyphase")  # built once here, loaded by the ranks
    return spawn_world(_bench_rank, ranks, args=(ranks,), device=device,
                       timeout_s=timeout_s)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.ranks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
