"""Process-group setup and the time-axis slice of each rank.

Counterpart of ``multirate_tpu/parallel/multihost.py``. Every rank runs the
same program (SPMD); ``initialize()`` starts ``torch.distributed`` so that
the (channel, time) mesh of ``make_mesh`` spans every rank. The process
count and index of the JAX package become the world size and the rank.

The backend is ``nccl`` when every rank on a host has a card of its own,
and ``gloo`` when ranks share one card or run on the CPU: NCCL refuses two
ranks on one card. Gloo's point-to-point operations take CPU tensors, so
over gloo the halo (``h_min`` samples a channel per block boundary) is
staged through the host (``sharded.py``); every kernel still runs on the
rank's own device. ``spawn_world`` starts such a world of processes on
this host, for the tests, the scaling benchmark and the smoke test.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multihost", "local_data_slice",
           "shard_quantum", "padded_global_len"]


def _backend(local_world: int) -> str:
    """``nccl`` where each of ``local_world`` ranks has a card of its own,
    else ``gloo``."""
    if torch.cuda.is_available() and dist.is_nccl_available() and (
            torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Start the default process group; nothing if one exists.

    ``coordinator_address`` is ``host:port`` (or an ``init_method`` URL
    such as ``tcp://...`` or ``file://...``), ``num_processes`` the world
    size and ``process_id`` this rank. Omitted, they come from torchrun's
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); with neither, the world is this one process, as a single
    chip is in the JAX package. ``backend`` names ``nccl`` or ``gloo``;
    by default ``nccl`` when each rank of the host has a card of its own
    (``LOCAL_WORLD_SIZE``, else the world size), else ``gloo``. Under
    ``nccl`` each rank takes the card of its local rank.
    """
    if dist.is_initialized():
        return
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = backend or _backend(local_world)
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % local_world)))
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url, world_size=world,
                                rank=rank)
    elif "MASTER_ADDR" in env:
        dist.init_process_group(backend, world_size=world, rank=rank)
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    else:
        raise ValueError(
            f"a world of {world} processes needs coordinator_address= or "
            f"torchrun's MASTER_ADDR and MASTER_PORT")


def is_multihost() -> bool:
    """True when the process group spans more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


def shard_quantum(params, n_t: int) -> int:
    """Global time-axis length quantum that keeps ``shard_filt_block``
    applicable AND per-shard output counts uniform for the rational family:
    n_t equal shards, each a multiple of the input stride M."""
    M = getattr(params, "decimation", 1)
    return n_t * M


def padded_global_len(global_len: int, quantum: int) -> int:
    """Smallest multiple of ``quantum`` >= global_len (callers zero-pad the
    stream tail; trim outputs with the closed-form true output count as
    sharded.sharded_resample does)."""
    return -(-global_len // quantum) * quantum


def local_data_slice(global_len: int, axis_size: int | None = None,
                     quantum: int = 1, process_index: int | None = None):
    """(start, length, valid) of this rank's time-axis slice.

    Every rank receives the SAME ``length`` (the quantum-padded global
    stream divided equally) so the result composes directly with
    ``shard_filt_block``'s equal-shard requirement; ``valid`` is how many
    of those samples exist in the unpadded stream (the remainder is
    zero-fill supplied by the caller). ``axis_size`` and ``process_index``
    default to the world size and the rank (1 and 0 with no process
    group). Use with ``shard_quantum`` / ``padded_global_len``:

        q = shard_quantum(params, mesh.size(1)) * world_size
        start, length, valid = local_data_slice(global_len, quantum=q)
    """
    live = dist.is_initialized()
    n = axis_size if axis_size is not None else (
        dist.get_world_size() if live else 1)
    i = process_index if process_index is not None else (
        dist.get_rank() if live else 0)
    per = padded_global_len(global_len, n * quantum) // n
    start = i * per
    valid = min(per, max(0, global_len - start))
    return start, per, valid


def world_device(device=None) -> str:
    """The device every rank of a spawned world runs on, as a string: the
    card (``cuda:0``) unless the caller names ``cpu``; with no card and no
    device named, ``params.default_device`` raises."""
    from ..ops.params import default_device

    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda":
        return f"cuda:{dev.index or 0}"
    return str(dev)


def _rank_main(rank, world, store, fn, args, results, device, timeout_s):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        out = fn(rank, device, *args)
        dist.barrier()
        results.put((rank, out, None))
    except Exception:  # the rank's boundary: report, then fail the rank
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, world: int, args=(), device=None,
                timeout_s: float = 300.0, store_dir=None):
    """Run ``fn(rank, device, *args)`` on every rank of a gloo world of
    ``world`` spawned processes and return the ranks' results, in rank
    order. ``device`` is the card by default (``world_device``), every
    rank on it; the CPU only where the caller names ``cpu``.

    The ranks meet at a ``file://`` store in ``store_dir`` (a fresh
    temporary directory by default), so concurrent worlds never collide on
    a port. ``fn`` must be importable (it is pickled by name). Every join
    has a timeout: a rank that fails, hangs or dies raises here with its
    traceback, and the ranks still running are terminated.
    """
    import torch.multiprocessing as mp

    device = world_device(device)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, os.path.join(tmp, "store"), fn, args, results,
            device, timeout_s)) for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            for _ in range(world):  # drain the queue before any join
                # after a failure, the others' errors or a short wait
                rank, out, err = results.get(
                    timeout=20 if errors else timeout_s)
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                got[rank] = out
        except queue.Empty:  # a rank hung or died
            errors.append(f"a rank gave no result in time ({len(got)} of "
                          f"{world} did)")
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        codes = [p.exitcode for p in procs]
        if errors or any(c != 0 for c in codes):
            raise RuntimeError(f"world of {world} failed (exit codes "
                               f"{codes}):\n" + "\n".join(errors))
        return [got[r] for r in range(world)]
