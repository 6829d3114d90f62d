"""Sharded streaming filtering over a (channel, time) mesh of ranks.

Counterpart of ``multirate_tpu/parallel/sharded.py``, in
``torch.distributed``'s SPMD idiom: every rank runs the same call on its
own slice, and the mesh is a ``DeviceMesh`` with dims ``("ch", "t")``.

- Channels shard as pure data parallelism: zero communication.
- The time axis shards into contiguous blocks; each block needs only the
  ``h_min`` trailing input samples of its left neighbour (the filter
  history, an overlap-save halo): one point-to-point hop over ``"t"``,
  plus the entry phase and deficit, which are *host integers in closed
  form* from the block's start sample (``ops/indexing.py``), because every
  kernel's control recurrence is affine. Blocks are therefore independent
  after one halo exchange, and every shard's output count is a host
  integer too, so counts need no collective and nothing is read back from
  the device.
- Over ``gloo`` (ranks sharing one card, or the CPU) the halo, the
  broadcast history and the gathered outputs cross as CPU tensors; over
  ``nccl`` they stay on the device. The filtering itself runs on the
  signal's device either way, through the same kernels as ``filt_block``.
- Over ``nccl`` a step waits for nothing on the host: the halo's and the
  history's ``Work.wait()`` only order the rank's stream after NCCL's,
  the counts and the entry state are host integers, and each rank keeps
  its outputs (``compact`` gathers them when a caller wants them
  whole). So a rank's host runs ahead of its card, and the cards pace
  the stream.

Traced (``utils.profiling``): the span ``mr.parallel.step`` is the whole
``shard_filt_block``; under it ``mr.parallel.halo`` (``exchange_halo``:
the tail's copy, the point-to-point operations built and enqueued) and
``mr.parallel.history`` (``broadcast_tail``).

The chunked==whole invariant across ranks is the same invariant the
reference tests for single-core chunking (runtests.jl:72-96): each rank's
block is one "chunk", with the closed-form entry state replacing the
sequentially carried one.

PERF DESIGN RULE (kept from the JAX package): for the rational family,
pick per-shard block lengths that are multiples of the input stride M.
Every shard then enters on the fresh phase and emits the same output
count, nblk*L/M, so no shard's gathered block carries padding. Results
are identical either way: ``sharded_resample`` packs every family's
shards with the one ragged scatter of ``compact_device``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..ops import indexing as idx
from ..ops.compute import filt_block_raw
from ..ops.params import FIRDecimator, FIRRational, FilterState, init_state
from ..utils.profiling import recording, span
from . import multihost

__all__ = ["make_mesh", "shard_filt_block", "shard_filt", "sharded_resample",
           "compact", "compact_device"]


def make_mesh(n_ch: int = 1, n_t: int | None = None, device_type=None,
              ranks=None) -> DeviceMesh:
    """A (channel, time) mesh over the ranks of the process group.

    Channel axis = data parallel (BASELINE.json 64-channel Farrow config);
    time axis = sequence parallel over signal blocks. ``ranks`` (JAX's
    ``devices``) are the ranks it spans, by default the whole world, and
    their count must equal ``n_ch * n_t`` (``n_t`` defaults to the count
    over ``n_ch``). Every rank of the world calls ``make_mesh``; a rank
    outside ``ranks`` has no coordinate on it. With no process group,
    ``multihost.initialize()`` starts a world of this one process.
    ``device_type`` is the mesh's (``cuda`` under ``nccl``, else ``cpu``);
    the signals stay on their own devices either way.
    """
    if not dist.is_initialized():
        multihost.initialize()
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if n_t is None:
        n_t = len(ranks) // n_ch
    if n_ch < 1 or n_t < 1 or n_ch * n_t != len(ranks):
        raise ValueError(f"a ({n_ch}, {n_t}) mesh needs {n_ch * n_t} ranks, "
                         f"not {len(ranks)}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n_ch, n_t),
                      mesh_dim_names=("ch", "t"))


def _entry_state(params, phase0: int, deficit0: int, start: int):
    """Closed-form streaming state (phase, deficit) at global input offset
    ``start`` (0-based samples consumed), given the stream's entry state.

    This is what makes time-sharding embarrassingly parallel: the reference
    would have to filter the first ``start`` samples to know the phase here
    (Filters.jl:567-571); the affine recurrence is evaluated directly, in
    exact host integers (``indexing.host_carry``)."""
    return idx.host_carry(params, phase0, deficit0, start)[1:]


def _outputs_before(params, phase0: int, deficit0: int, start: int) -> int:
    """Number of global outputs produced by the first ``start`` inputs."""
    return idx.host_carry(params, phase0, deficit0, start)[0]


def _coordinate(mesh: DeviceMesh):
    """(channel index, time index, n_t) of this rank on ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    return coord[0], coord[1], mesh.size(1)


def _over_host(group) -> bool:
    """Whether tensors cross ``group`` as CPU tensors: gloo's point-to-point
    operations take no CUDA tensors (NCCL's take only them)."""
    return dist.get_backend(group) == "gloo"


def _wire(t, group, copy: bool = False):
    """``t`` as it crosses ``group``: contiguous, and on the host
    (``.cpu()``) over gloo, else on its device; a copy of its own where
    ``copy`` (a broadcast or a receive writes into it)."""
    t = t.cpu() if _over_host(group) else t
    return (t.clone(memory_format=torch.contiguous_format) if copy
            else t.contiguous())


# types whose collectives gloo refuses ("Invalid scalar type"); they cross
# as their bytes (its point-to-point operations take any type)
_GLOO_AS_BYTES = (torch.int16, torch.uint16, torch.uint32, torch.uint64)


def _collective(t, group):
    """``t`` (contiguous) as a collective over ``group`` takes it: a uint8
    view of its bytes where gloo refuses its type, else itself. A view: a
    broadcast or gather into it writes ``t``."""
    if _over_host(group) and t.dtype in _GLOO_AS_BYTES:
        return t.view(torch.uint8)
    return t


def _peer(mesh: DeviceMesh, ci: int, k: int) -> int:
    return int(mesh.mesh[ci, k])


def exchange_halo(history, x_local, mesh: DeviceMesh, on=None):
    """The ``h_min`` samples left of this rank's block: the left
    neighbour's tail, sent over ``"t"`` with ``batch_isend_irecv``, or the
    stream's ``history`` on t-rank 0. On ``x_local``'s device. Traced as
    ``mr.parallel.halo`` (``on`` as ``utils.profiling.span``'s)."""
    with span("mr.parallel.halo", on):
        ci, k, n_t = _coordinate(mesh)
        H = history.shape[-1]
        if n_t == 1 or H == 0:
            return history
        group = mesh.get_group("t")
        ops, recv = [], None
        if k + 1 < n_t:
            tail = _wire(x_local[:, x_local.shape[-1] - H:], group)
            ops.append(dist.P2POp(dist.isend, tail, _peer(mesh, ci, k + 1),
                                  group))
        if k > 0:
            recv = torch.empty((x_local.shape[0], H), dtype=x_local.dtype,
                               device="cpu" if _over_host(group)
                               else x_local.device)
            ops.append(dist.P2POp(dist.irecv, recv, _peer(mesh, ci, k - 1),
                                  group))
        # over nccl a wait orders this rank's stream after the transfer
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return history if k == 0 else recv.to(x_local.device)


def shard_step(params, state: FilterState, halo, x_local, k: int,
               path: str = "auto"):
    """t-shard ``k``'s outputs, from its block, its halo and its
    closed-form entry state, with no communication."""
    phase, deficit = _entry_state(params, state.phase, state.deficit,
                                  k * x_local.shape[-1])
    st = FilterState(history=halo.to(x_local.dtype), phase=phase,
                     deficit=deficit)
    return filt_block_raw(params, st, x_local, path)[0]


def _check_block(params, state: FilterState, x_local):
    """Raise, on every rank alike and before any communication, on a block
    or a state the sharded step cannot take."""
    if x_local.dim() != 2:
        raise ValueError(f"x_local must be (channels, time), got shape "
                         f"{tuple(x_local.shape)}")
    want = (x_local.shape[0], params.h_min)
    if tuple(state.history.shape) != want:
        raise ValueError(f"state history has shape "
                         f"{tuple(state.history.shape)}, expected {want}")
    nblk, h_need = x_local.shape[-1], params.h_min
    if nblk < h_need:
        raise ValueError(
            f"per-shard block ({nblk}) must be >= h_min ({h_need}); "
            f"use longer blocks or fewer time shards")


def _shard_counts(params, state: FilterState, nblk: int, n_t: int):
    """Every t-shard's output count, as host ints."""
    before = [_outputs_before(params, state.phase, state.deficit, k * nblk)
              for k in range(n_t + 1)]
    return [b - a for a, b in zip(before, before[1:])]


def shard_filt_block(params, state: FilterState, x_local, mesh: DeviceMesh,
                     path: str = "auto"):
    """Filter one sharded super-block, SPMD: this rank's block.

    ``x_local`` is this rank's ``(C / n_ch, N / n_t)`` block of a (C, N)
    super-block, every rank's block of the same length; ``state`` the
    stream's state for this rank's channels, the same on every t-rank.
    Each t-shard takes its halo from its left neighbour over ``"t"``
    (``exchange_halo``); t-shard 0 takes ``state.history``. Returns
    ``(y_local, counts, new_state)``: ``y_local`` this shard's outputs
    (exactly its count), ``counts`` every t-shard's output count as host
    ints, and ``new_state`` the stream's state after the super-block, the
    same on every rank: its history is the tail of the global block, which
    the last t-rank broadcasts over ``"t"``; its phase and deficit are the
    closed-form entry state at N.

    Requires per-shard block length >= h_min (one-hop halo): a shorter
    block raises ``ValueError``, as in the JAX package. Over ``nccl``
    nothing in the call waits for the card. Traced as
    ``mr.parallel.step``.
    """
    on = recording()
    with span("mr.parallel.step", on):
        _check_block(params, state, x_local)
        _, k, n_t = _coordinate(mesh)
        nblk = x_local.shape[-1]
        halo = exchange_halo(state.history, x_local, mesh, on)
        y = shard_step(params, state, halo, x_local, k, path)
        counts = _shard_counts(params, state, nblk, n_t)
        phase, deficit = _entry_state(params, state.phase, state.deficit,
                                      n_t * nblk)
        new_state = FilterState(
            history=broadcast_tail(x_local, params.h_min, mesh, on).to(
                state.history.dtype),
            phase=phase, deficit=deficit)
        return y, counts, new_state


def broadcast_tail(x_local, H: int, mesh: DeviceMesh, on=None):
    """The last ``H`` samples of the global block, from the last t-rank
    over ``"t"``, on ``x_local``'s device (a tensor of its own). Traced
    as ``mr.parallel.history`` (``on`` as ``utils.profiling.span``'s)."""
    with span("mr.parallel.history", on):
        ci, _, n_t = _coordinate(mesh)
        tail = x_local[:, x_local.shape[-1] - H:]
        if n_t == 1:
            return tail.clone(memory_format=torch.contiguous_format)
        group = mesh.get_group("t")
        tail = _wire(tail, group, copy=True)
        dist.broadcast(_collective(tail, group), _peer(mesh, ci, n_t - 1),
                       group)
        return tail.to(x_local.device)


def _gather(t, mesh: DeviceMesh, dim_name: str):
    """Every rank's ``t`` along mesh dim ``dim_name``, in mesh order, as a
    list of tensors on ``t``'s device (all the same shape)."""
    n = mesh.size(mesh.mesh_dim_names.index(dim_name))
    if n == 1:
        return [t]
    group = mesh.get_group(dim_name)
    src = _wire(t, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather([_collective(p, group) for p in parts],
                    _collective(src, group), group)
    return [p.to(t.device) for p in parts]


def _gather_blocks(y_local, counts, mesh: DeviceMesh):
    """(C_local, n_t, max(counts)): every t-shard's outputs, zero-padded."""
    n_max = max(counts)
    pad = F.pad(y_local, (0, n_max - y_local.shape[-1]))
    return torch.stack(_gather(pad, mesh, "t"), dim=-2)


def compact(y_local, counts, mesh: DeviceMesh):
    """This rank's channels' outputs of the whole super-block: an
    ``all_gather`` over ``"t"`` of every shard's outputs, assembled into
    (C_local, sum(counts)) on ``y_local``'s device."""
    blocks = _gather_blocks(y_local, counts, mesh)
    return torch.cat([blocks[:, k, :c] for k, c in enumerate(counts)], -1)


def compact_device(y_local, counts, mesh: DeviceMesh):
    """Device-resident ragged compaction: ``(dense_padded, total)``.

    Gathers every t-shard's outputs as ``compact`` does, then packs each
    shard's first ``counts[k]`` samples back to back with one scatter;
    ``dense_padded`` is (C_local, n_t * max(counts)), zero past ``total``
    (a host int: the counts are). The scatter's indices are made on the
    device from the host counts, so nothing waits for the card.
    """
    blocks = _gather_blocks(y_local, counts, mesh)
    C, n_t, n_max = blocks.shape
    dev = blocks.device
    j = torch.arange(n_max, device=dev)
    drop = n_t * n_max  # the slot every padding sample lands in
    offs = [sum(counts[:k]) for k in range(n_t)]
    tgt = torch.stack([torch.where(j < c, j + o, drop)
                       for c, o in zip(counts, offs)]).reshape(-1)
    dense = blocks.new_zeros((C, drop + 1))
    dense.index_copy_(-1, tgt, blocks.reshape(C, -1))
    return dense[:, :drop], sum(counts)


def shard_filt(params, x_local, mesh: DeviceMesh, path: str = "auto"):
    """Stateless sharded filtering of this rank's block of a whole (C, N)
    signal: ``(y_local, counts)``; ``compact`` assembles them."""
    state = init_state(params, (x_local.shape[0],), x_local.dtype,
                       device=x_local.device)
    y, counts, _ = shard_filt_block(params, state, x_local, mesh, path=path)
    return y, counts


def local_block(params, x, mesh: DeviceMesh):
    """This rank's ``(C / n_ch, N_pad / n_t)`` block of a global (C, N)
    signal, zero-padded at the end of the stream, and ``N_pad``: N rounded
    up to ``n_t * M`` (M the input stride of the rational family, else
    1), so every shard emits the same output count where the family
    allows it."""
    if x.dim() != 2:
        raise ValueError(f"x must be (channels, time), got shape "
                         f"{tuple(x.shape)}")
    C, N = x.shape
    n_ch = mesh.size(0)
    ci, k, n_t = _coordinate(mesh)
    if C % n_ch:
        raise ValueError(f"{C} channels not divisible by {n_ch} shards")
    M = params.decimation if isinstance(params, (FIRDecimator,
                                                 FIRRational)) else 1
    N_pad = multihost.padded_global_len(N, n_t * M)
    nblk = N_pad // n_t
    cl = C // n_ch
    xl = x[ci * cl:(ci + 1) * cl, k * nblk:(k + 1) * nblk]
    return F.pad(xl, (0, nblk - xl.shape[-1])), N_pad


def sharded_resample(params, x, mesh: DeviceMesh, path: str = "auto"):
    """High-level sharded resample of a global (C, N) signal that every rank
    holds: each rank reads only its own slice (``local_block``: padded so
    every shard emits the same output count where the family allows it),
    runs the sharded filter, and every rank returns the dense
    (C, out_len) result, trimmed to the unpadded stream's closed-form
    output count and gathered over both mesh dims.

    Every family packs its shards with ``compact_device``: equal counts
    for the rational family (blocks of ``n_t * M``), ragged ones at an
    arbitrary or Farrow rate.
    """
    n_out_true = _outputs_before(params, _fresh_phase(params), 1,
                                 x.shape[-1])
    xl, _ = local_block(params, x, mesh)
    y, counts = shard_filt(params, xl, mesh, path=path)
    dense, _ = compact_device(y, counts, mesh)
    return torch.cat(_gather(dense[:, :n_out_true], mesh, "ch"), 0)


def _fresh_phase(params) -> int:
    return 1 if isinstance(params, FIRRational) else 0
