"""Split the host-staged halo of the sharded step on one card into its
parts, on 4 gloo ranks that share ``cuda:0``.

The halo exchange and the history broadcast of ``parallel/sharded.py``
(``exchange_halo`` + ``broadcast_tail``) move ``h_min`` samples a channel
to and from the host and over gloo's point-to-point and broadcast. This
script times, for the headline's shard (147//160, 24*147 Kaiser taps,
float32, one channel of 2,000,000 samples a rank on a (1, 4) mesh), each
part on the host clock between synchronizes, all ranks together after a
barrier unless named "in turn":

- ``full``: ``exchange_halo`` + ``broadcast_tail``, as phase 5f times it;
- ``gloo``: the same two calls on CPU tensors (no device in them);
- ``copies``: the tail to the host and back (``.cpu()``, ``.to(dev)``),
  no communication; ``copies_in_turn``: the same, one rank at a time;
- ``barrier``: one ``dist.barrier()``;
- ``sync``: two synchronizes with nothing between them.

Needs one CUDA card; imports no JAX. From the repo root:

    python3 tools/halo_split.py

Prints one line a part (ms by rank, median of 15), the card's name and
power limit, and as the last line a JSON object {part: [ms by rank]}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WORLD, SHARD, REPS = 4, 2_000_000, 15


def _rank(rank, device):
    from fractions import Fraction

    import numpy as np
    import torch
    import torch.distributed as dist

    import multirate_tpu_torch as mt
    from multirate_tpu_torch.parallel import sharded as sh

    dev = torch.device(device)
    h = (mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    p = mt.make_kernel(h, ratio=Fraction(147, 160), device=dev)
    mesh = sh.make_mesh(1, WORLD)
    xl = torch.randn(1, SHARD, device=dev)
    hist = mt.init_state(p, (1,), device=dev).history
    xc, hc = xl[:, -1000:].cpu(), hist.cpu()
    H = p.h_min

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def span(fn, in_turn=False):
        """ms of ``fn`` on this rank's host clock: all ranks together, or
        each rank alone in its turn."""
        got = 0.0
        for t in (range(WORLD) if in_turn else [rank]):
            sync()
            dist.barrier()
            if t == rank:
                t0 = time.perf_counter()
                fn()
                sync()
                got = (time.perf_counter() - t0) * 1e3
        return got

    parts = {
        "full": lambda: (sh.exchange_halo(hist, xl, mesh),
                         sh.broadcast_tail(xl, H, mesh)),
        "gloo": lambda: (sh.exchange_halo(hc, xc, mesh),
                         sh.broadcast_tail(xc, H, mesh)),
        "copies": lambda: xl[:, -H:].cpu().to(dev),
        "barrier": dist.barrier,
        "sync": lambda: None,
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(3):
            span(fn)
        out[name] = statistics.median(span(fn) for _ in range(REPS))
    out["copies_in_turn"] = statistics.median(
        span(parts["copies"], in_turn=True) for _ in range(REPS))
    return out


def main() -> int:
    import torch

    from multirate_tpu_torch.parallel.multihost import spawn_world

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    ranks = spawn_world(_rank, WORLD, device="cuda:0", timeout_s=600)
    table = {k: [round(r[k], 4) for r in ranks] for k in ranks[0]}
    for k, v in table.items():
        print(f"{k}: ms by rank {v}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
