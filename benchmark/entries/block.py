"""The ``block`` entry: one ``FIRFilter`` with its state carried, called in
a closed loop on device inputs.

Traffic parameters: ``channels`` x ``samples`` a call, of the
configuration's ``dtype``, unit normal from the seed, and ``inputs`` of
them in turn, so that each call reads and writes device memory and not the
50 MB L2. Reports ``block_msps``: input samples over the window's wall
time, closed by a synchronize. Counters: ``calls``, ``least_s`` (the least
time of the window's calls, ``work.least_seconds``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import check, designs, generator, trace, work


def _segments(a: int, b: int, period: int):
    """[a, b) cut at multiples of ``period``: (start, stop) pieces."""
    while a < b:
        stop = min(b, (a // period + 1) * period)
        yield a, stop
        a = stop


def run(cell, seed, seconds, device, traced, control, t_start):
    import torch
    from multirate_tpu_torch import FIRFilter

    cfg, tr = cell.config, cell.traffic
    C, N, n_in = int(tr["channels"]), int(tr["samples"]), int(tr["inputs"])
    shape = (N,) if C == 1 else (C, N)
    taps = designs.taps(cfg).astype(cfg["dtype"])
    ref = cell.reference(torch.from_numpy(taps.astype(np.float64)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    xs = [torch.randn(shape, generator=gen, device=device,
                      dtype=getattr(torch, cfg["dtype"]))
          for _ in range(n_in)]
    # the control reads the signal in bfloat16, by the program's own
    # narrow-read path
    x_prog = [x.to(torch.bfloat16) for x in xs] if control else xs
    spec, kw = generator.program_spec(cfg)
    t0 = time.perf_counter()  # the first call builds or loads the kernels
    f = FIRFilter(taps, spec, device=device, **kw)
    f.filt(x_prog[0])
    generator.sync(device)
    t1 = time.perf_counter()
    y = f.filt(x_prog[0])
    generator.sync(device)
    warm = time.perf_counter() - t1
    f.reset()
    n_out = ref.count(N) - 1  # the fewest outputs a call gives
    slices = check.Slices(seed, C, n_out, like=y)
    del y
    setup_s = time.perf_counter() - t_start

    def body(t0, deadline):
        k, done, gap = 0, 0, 0
        while True:
            with trace.span("filt", traced):
                y = f.filt(x_prog[k % n_in])
            total = ref.count((k + 1) * N)
            gap += abs(y.shape[-1] - (total - done))
            if k == slices.next:
                slices.take(k, y, done)
            done = total
            k += 1
            if time.perf_counter() >= deadline:
                break
        generator.sync(device)
        return k, done, gap, time.perf_counter() - t0

    (calls, produced, gap, wall), tr_ = generator.window(seconds, traced,
                                                         device, body)
    peak = generator.peak(device)
    del f
    nbytes, mult_adds = work.call_work(
        cfg, C, N, produced / calls,
        str(x_prog[0].dtype).removeprefix("torch."))
    counters = {"calls": calls, "window_s": wall, "warm_call_s": warm,
                "least_s": calls * work.least_seconds(cfg, nbytes,
                                                      mult_adds)}

    def read_input(c, a, b):
        parts = []
        for s, e in _segments(a, b, N):
            if s < 0:
                parts.append(torch.zeros(e - s, dtype=torch.float64))
            else:
                x = xs[(s // N) % n_in]
                row = x if x.dim() == 1 else x[c]
                parts.append(row[s % N:(e - 1) % N + 1].cpu().double())
        return torch.cat(parts)

    return generator.Outcome(
        setup_s=setup_s, build_s=(t1 - t0) - warm,
        metrics={"block_msps": calls * C * N / wall / 1e6},
        counters=counters, attempted=calls, failed=0, count_gap=gap,
        memory_peak_bytes=peak, reference=ref, readings=slices.readings(),
        read_input=read_input, trace=tr_)
