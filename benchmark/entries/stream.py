"""The ``stream`` entry: one ``StreamingResampler`` over a ``Resampler``,
fed from host memory in a closed loop, a ``pull()`` after every ``push``.

Traffic parameters: chunks of ``chunk_min``..``chunk_max`` samples (one
uniform draw of ``SIZES`` sizes, the same for every seed, in an order from
the seed) from a seeded host pool of ``pool_samples`` (``int16`` PCM at
``pcm_rms`` of full scale, or ``float32``), blocks of ``block_size``.
Reports ``stream_msps`` (input samples whose output reached host memory,
over the window's wall time) and ``chunk_p99_ms`` (the 99th percentile of
every chunk's time from its ``push`` to the return of the ``pull`` after
it). Counters, in a traced run: ``block_seconds`` (``stats()
["block_seconds_last"]`` after each push that ran a block) and
``pull_seconds`` (each pull that returned output).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import check, designs, generator, stats, trace

SIZES = 1 << 16  # chunk sizes drawn a run, used in turn


def _pool(tr: dict, seed: int) -> np.ndarray:
    """The seeded host pool the chunks come from, its first ``chunk_max``
    samples repeated at its end so that a chunk never wraps."""
    r = check.rng(seed, 2)
    p = int(tr["pool_samples"])
    v = r.standard_normal(p)
    if tr["dtype"] == "int16":
        v = np.clip(np.rint(v * float(tr["pcm_rms"]) * 32768.0), -32768,
                    32767).astype(np.int16)
    else:
        v = v.astype(np.dtype(tr["dtype"]))
    return np.concatenate([v, v[:int(tr["chunk_max"])]])


def _as_float(pool: np.ndarray) -> np.ndarray:
    """The pool's samples as the ring holds them (16-bit PCM over 32768)."""
    if pool.dtype == np.int16:
        return pool.astype(np.float32) / np.float32(32768.0)
    return pool.astype(np.float32)


def run(cell, seed, seconds, device, traced, control, t_start):
    import torch
    from multirate_tpu_torch.io import StreamingResampler
    from multirate_tpu_torch.models import Resampler

    cfg, tr = cell.config, cell.traffic
    taps = designs.taps(cfg).astype(cfg["dtype"])
    ref = cell.reference(torch.from_numpy(taps.astype(np.float64)))
    pool = _pool(tr, seed)
    P, bs = int(tr["pool_samples"]), int(tr["block_size"])
    if control:  # the samples rounded to bfloat16 before the ring
        pool = torch.from_numpy(_as_float(pool)).bfloat16().float().numpy()
    # every seed pushes the same chunk sizes, in its own order
    sizes = check.rng(seed, 4).permutation(check.rng(0, 4).integers(
        int(tr["chunk_min"]), int(tr["chunk_max"]) + 1, SIZES))
    spec, kw = generator.program_spec(cfg)
    t0 = time.perf_counter()  # the first block builds or loads the kernels
    s = StreamingResampler(Resampler(spec, taps=taps, device=device, **kw),
                           block_size=bs)
    block_s = []
    for i in range(2):
        s.push(pool[i * bs:(i + 1) * bs])
        s.pull()
        generator.sync(device)
        block_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    s.reset()
    pulls = check.Pulls(seed)
    setup_s = time.perf_counter() - t_start

    def body(t0, deadline):
        times, dispatch, pull_s = [], [], []
        pos = produced = failed = blocks = 0
        i = 0
        while True:
            n = int(sizes[i % SIZES])
            p = pos % P
            chunk = pool[p:p + n]
            ta = time.perf_counter()
            with trace.span("push", traced):
                queued = s.push(chunk)
            if traced:
                st = s.stats()
                if st["blocks"] != blocks:
                    blocks = st["blocks"]
                    dispatch.append(st["block_seconds_last"])
                tp = time.perf_counter()
            with trace.span("pull", traced):
                out = s.pull()
            tb = time.perf_counter()
            times.append(tb - ta)
            if queued == n:
                pos += n
            else:
                failed += 1
            if out.size:
                if traced:
                    pull_s.append(tb - tp)
                pulls.offer(produced, out)
                produced += out.size
            i += 1
            if tb >= deadline:
                break
        return i, failed, produced, times, dispatch, pull_s, tb - t0

    (chunks, failed, produced, times, dispatch, pull_s, wall), tr_ = \
        generator.window(seconds, traced, device, body)
    peak = generator.peak(device)
    consumed = s.stats()["consumed_samples"]
    del s
    pool_f = _as_float(_pool(tr, seed)[:P]).astype(np.float64)

    def read_input(c, a, b):
        idx = np.arange(a, b)
        v = pool_f[idx % P]
        v[idx < 0] = 0.0
        return torch.from_numpy(v)

    return generator.Outcome(
        setup_s=setup_s, build_s=block_s[0] - block_s[1],
        metrics={"stream_msps": consumed / wall / 1e6,
                 "chunk_p99_ms": stats.percentile(times, 99) * 1e3},
        counters={"window_s": wall, "warm_call_s": block_s[1],
                  "block_seconds": dispatch, "pull_seconds": pull_s},
        attempted=chunks, failed=failed,
        count_gap=abs(produced - ref.count(consumed)),
        memory_peak_bytes=peak, reference=ref, readings=pulls.readings(),
        read_input=read_input, trace=tr_)
