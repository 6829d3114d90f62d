"""The ``sharded`` entry: one stream split by time over a (1, n_t) mesh of
ranks, through the port's ``parallel.shard_filt_block`` with the state
carried from call to call: a world of NCCL ranks with a card each on the
card, of gloo ranks on the CPU (the tests).

Traffic parameters: ``channels`` x ``samples`` a call over the whole mesh
(the configuration's ``mesh``, (1, n_t), n_t the cell's ``chips``), of the
configuration's ``dtype``. Each rank draws its own (channels, samples /
n_t) time slice of ``inputs`` calls, unit normal from the seed, on its own
device, and the calls take them in turn, so that each reads device memory
and not the L2.

Nothing in the window waits on the host. The ranks agree on the window's
number of calls before it opens: after two warm calls rank 0 takes the
pace of a call with the launch queue full (``PACE_CALLS`` calls timed
beyond a burst of ``PACE_RAMP``, each from a synchronized start, so that
the ramp and the drain cancel) and broadcasts the count that fills the
window at that pace. Each rank keeps its own outputs, and the window
closes once, with a ``synchronize`` and one barrier after the last call.
Only then does each rank hand its sampled outputs with the inputs they
read to the parent process, which compares them with the reference, as
the other cells' runs do: the two slices of each sampled call
(``check.Slices``, at seeded offsets), and the first outputs of a seeded
channel of the same call (``_Heads``), which read the left rank's halo
or, on rank 0, the history broadcast from the last rank.

Reports ``block_msps``: the world's input samples over rank 0's wall time.
Counters: ``calls``, ``least_s`` (rank 0's share of the work,
``work.least_seconds``), ``caught_up`` (on the card, each rank's calls at
which its card had caught up with its host, ``rank_skew_pct.sharded``)
and, traced, rank 0's ``spans`` (the port's tracer, ``utils.profiling``).
"""

from __future__ import annotations

import importlib
import math
import sys
import time

import numpy as np

from benchmark import check, designs, generator, trace, work

PACE_RAMP = 16   # calls from a synchronized start: the ramp and the drain
PACE_CALLS = 64  # calls timed beyond them, to set the window's count
LEAD = 8         # calls: a card fewer than this behind its host has caught up
TAIL = 64        # samples of each rank's input tails gathered for the check
TIMEOUT_S = 900  # beyond the window: set-up, a first build, the check


def _segments(a: int, b: int, period: int):
    """[a, b) cut at multiples of ``period``: (start, stop) pieces."""
    while a < b:
        stop = min(b, (a // period + 1) * period)
        yield a, stop
        a = stop


class _Heads:
    """The first outputs of a seeded channel of each sampled call, taken
    on the device as the call returns: the outputs that read the inputs
    left of the rank's block (the left rank's halo; on rank 0 the
    history), which ``check.Slices``' seeded offsets all but never
    reach."""

    def __init__(self, seed: int, channels: int, width: int, like):
        import torch

        self._rng = check.rng(seed, 5)
        self.channels = channels
        self.buf = torch.empty((check.MAX_SLICES // 2, width),
                               dtype=like.dtype, device=like.device)
        self.meta = []  # (channel, first output in the stream)

    def take(self, y, base: int) -> None:
        if len(self.meta) < len(self.buf):
            c = int(self._rng.integers(self.channels))
            self.buf[len(self.meta)].copy_(y[c, :self.buf.shape[1]])
            self.meta.append((c, base))

    def readings(self) -> list:
        host = self.buf[:len(self.meta)].cpu()
        return [(c, m0, host[i]) for i, (c, m0) in enumerate(self.meta)]


class _CaughtUp:
    """The calls at which a rank's card had caught up with its host: the
    call ``len(events)`` calls back had ended as this one returned, read
    by a query of the event recorded after it, which does not wait.
    Counted from the first call at which the host was that far ahead, so
    that the window's first calls, before the queue fills, do not count.
    ``events``: CUDA events, or fakes with ``query`` and ``record``."""

    def __init__(self, events):
        self.events, self.count, self.calls, self.ahead = events, 0, 0, False

    def tick(self) -> None:
        ev = self.events[self.calls % len(self.events)]
        if self.calls >= len(self.events):
            up = ev.query()
            self.ahead = self.ahead or not up
            self.count += self.ahead and up
        ev.record()
        self.calls += 1


def _time_shards(cell) -> int:
    n_ch, n_t = (int(v) for v in cell.config["mesh"])
    if n_ch != 1 or n_t != int(cell.workload["chips"]):
        raise ValueError(f"the sharded entry runs a (1, chips) mesh, not "
                         f"{(n_ch, n_t)} on {cell.workload['chips']} chips")
    return n_t


def run(cell, seed, seconds, device, traced, control, t_start):
    import torch

    import multirate_tpu_torch.parallel.multihost as multihost

    world = _time_shards(cell)
    C, N = int(cell.traffic["channels"]), int(cell.traffic["samples"])
    if N % world:
        raise ValueError(f"{N} samples a call do not split {world} ways")
    taps = designs.taps(cell.config).astype(cell.config["dtype"])
    ref = cell.reference(torch.from_numpy(taps.astype(np.float64)))
    cuda = torch.device(device).type == "cuda"
    # by its module's name, so that the spawned ranks can import it
    rank_main = importlib.import_module("benchmark.entries.sharded")._rank
    ranks = multihost.spawn_world(
        rank_main, world, args=(cell, seed, seconds, traced, control,
                                t_start),
        device=device, backend="nccl" if cuda else "gloo",
        timeout_s=seconds + TIMEOUT_S)
    got = ranks[0]
    # where a run's time went, on the clock of t_start (the ranks' too);
    # a rank's drain: its card's work still queued as its last call
    # returned, the depth by which its host ran ahead
    # the calls at which a rank's card had caught up with its host
    caught = [r["caught"] for r in ranks] if cuda else None
    print(f"sharded: window closed at {got['closed'] - t_start:.3f} s, "
          f"rank 0 returned at {got['returned'] - t_start:.3f}, the world "
          f"joined at {time.perf_counter() - t_start:.3f}; drain by rank "
          f"{[round(r['drain'], 4) for r in ranks]} s, caught up by rank "
          f"{caught} of {got['calls']} calls", file=sys.stderr, flush=True)

    readings, inputs = [], {}
    for c, m0, y, a, x in (s for r in ranks for s in r["readings"]):
        readings.append((c, m0, torch.from_numpy(y)))
        inputs[c, a, a + x.size] = x

    def read_input(c, a, b):
        return torch.from_numpy(inputs[c, a, b]).double()

    calls = got["calls"]
    nbytes, mult_adds = work.call_work(cell.config, C, N // world,
                                       got["produced"] / calls,
                                       got["x_dtype"])
    counters = {"calls": calls, "window_s": got["wall"],
                "warm_call_s": got["warm_call_s"],
                "least_s": calls * work.least_seconds(cell.config, nbytes,
                                                      mult_adds),
                "caught_up": caught, "spans": got["spans"]}
    return generator.Outcome(
        setup_s=got["setup_s"], build_s=got["build_s"],
        metrics={"block_msps": calls * C * N / got["wall"] / 1e6},
        counters=counters, attempted=calls, failed=0,
        count_gap=sum(r["gap"] for r in ranks), memory_peak_bytes=got["peak"],
        reference=ref,
        readings=readings, read_input=read_input, trace=got["trace"])


def _rank(rank, device, cell, seed, seconds, traced, control, t_start):
    """One rank of the world (``multihost.spawn_world``): its time slice,
    warm-up, pace, window and sampled outputs. Every rank returns its sampled
    outputs with their inputs and its counts; rank 0 also the window's
    measurements."""
    import torch
    import torch.distributed as dist

    import multirate_tpu_torch as mt
    import multirate_tpu_torch.utils.profiling as profiling
    from multirate_tpu_torch import FIRFilter

    cfg, tr = cell.config, cell.traffic
    world = dist.get_world_size()
    C, N, n_in = int(tr["channels"]), int(tr["samples"]), int(tr["inputs"])
    n = N // world
    dtype = getattr(torch, cfg["dtype"])
    taps = designs.taps(cfg).astype(cfg["dtype"])
    ref = cell.reference(torch.from_numpy(taps.astype(np.float64)))
    spec, kw = generator.program_spec(cfg)
    t0 = time.perf_counter()
    if rank == 0 and torch.device(device).type == "cuda":
        # the card's kernels built or loaded once, before the others load
        FIRFilter(taps, spec, device=device, **kw).filt(
            torch.zeros((C, 4096), dtype=dtype, device=device))
        generator.sync(device)
    build_s = time.perf_counter() - t0
    dist.barrier()

    params = mt.make_kernel(taps, spec, device=device, **kw)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(check.rng(seed, 16 + rank).integers(2 ** 63)))
    xs = [torch.randn((C, n), generator=gen, device=device, dtype=dtype)
          for _ in range(n_in)]
    # the control reads the signal in bfloat16, by the program's own
    # narrow-read path
    x_prog = [x.to(torch.bfloat16) for x in xs] if control else xs
    mesh = mt.parallel.make_mesh(1, world)
    shard = mt.parallel.shard_filt_block

    state = mt.init_state(params, (C,), x_prog[0].dtype)
    for k in range(2):
        y, _, state = shard(params, state, x_prog[k % n_in], mesh)
    generator.sync(device)
    dist.barrier()
    bursts = []
    for m in (PACE_RAMP, PACE_RAMP + PACE_CALLS):
        generator.sync(device)
        t1 = time.perf_counter()
        for k in range(m):
            y, _, state = shard(params, state, x_prog[k % n_in], mesh)
        generator.sync(device)
        bursts.append(time.perf_counter() - t1)
    # the difference of the two bursts is PACE_CALLS calls at the card's
    # pace; on a host whose clock jitters, no less than half the mean
    pace = max((bursts[1] - bursts[0]) / PACE_CALLS,
               bursts[1] / (PACE_RAMP + PACE_CALLS) / 2)
    window_s = min(seconds, generator.TRACE_WINDOW_S) if traced else seconds
    calls = torch.tensor([max(2, math.ceil(window_s / pace))],
                         device=device)
    dist.broadcast(calls, 0)
    calls = int(calls.item())
    slices = check.Slices(seed + rank, C, ref.count(n) - 1, like=y)
    heads = _Heads(seed + rank, C, slices.width, like=y)
    del y
    state = mt.init_state(params, (C,), x_prog[0].dtype)
    lag = (_CaughtUp([torch.cuda.Event() for _ in range(LEAD)])
           if torch.device(device).type == "cuda" else None)
    setup_s = time.perf_counter() - t_start

    def body(t0, deadline):
        st, gap, produced = state, 0, 0
        for k in range(calls):
            with trace.span("step", traced):
                y, _, st = shard(params, st, x_prog[k % n_in], mesh)
            start = k * N + rank * n  # this rank's first input, globally
            base = ref.count(start)
            gap += abs(y.shape[-1] - (ref.count(start + n) - base))
            produced += y.shape[-1]
            if k == slices.next:
                heads.take(y, base)
                slices.take(k, y, base)
            if lag is not None:
                lag.tick()
        last = time.perf_counter()
        generator.sync(device)
        drain = time.perf_counter() - last
        dist.barrier()
        return gap, produced, drain, time.perf_counter() - t0

    (gap, produced, drain, wall), tr_ = generator.window(
        seconds, traced, device, body)
    closed = time.perf_counter()
    peak = generator.peak(device)

    # after the window: the inputs each sampled slice read, from this
    # rank's slice and its left neighbour's tail (every rank's, gathered)
    tails = torch.stack([x[:, n - TAIL:] for x in xs])
    parts = [torch.empty_like(tails) for _ in range(world)]
    dist.all_gather(parts, tails)
    parts = [p.cpu() for p in parts]

    def inputs(c, a, b):
        out = []
        for s, e in _segments(a, b, n):
            if s < 0:
                out.append(torch.zeros(e - s, dtype=dtype))
                continue
            call, off = divmod(s, N)
            q, lo = divmod(off, n)
            if q == rank:
                out.append(xs[call % n_in][c, lo:lo + e - s].cpu())
            elif lo >= n - TAIL:
                lo -= n - TAIL
                out.append(parts[q][call % n_in, c, lo:lo + e - s])
            else:
                raise ValueError(f"inputs [{a}, {b}) reach past the "
                                 f"{TAIL} samples gathered")
        return torch.cat(out).numpy()

    readings = []
    for c, m0, y in slices.readings() + heads.readings():
        a, b = ref.span(m0, m0 + y.numel())
        readings.append((c, m0, y.numpy(), a, inputs(c, a, b)))
    mine = {"readings": readings, "gap": gap, "drain": drain,
            "caught": lag.count if lag is not None else None}
    if rank:
        return mine
    return dict(mine, setup_s=setup_s, build_s=build_s, warm_call_s=pace,
                wall=wall, calls=calls, produced=produced, peak=peak,
                trace=tr_,
                x_dtype=str(x_prog[0].dtype).removeprefix("torch."),
                spans=profiling.spans() if traced else None,
                closed=closed, returned=time.perf_counter())
