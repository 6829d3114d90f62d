"""Differential-test helpers with first-divergence diagnostics.

The reference's custom vector isapprox reports the index of the first
failing element (runtests.jl:18-35); these helpers do the same, plus dump a
side-by-side neighborhood for debugging. ``ulps_apart`` measures narrow
(bfloat16, float16) outputs in units of their own spacing, and
``rel_max_err`` real or complex outputs against the largest magnitude.
``sharded_cases`` is a rank function for ``parallel.multihost.
spawn_world``: the sharded cases of a test, run on the ranks of a gloo
world with their results gathered; ``sharded_stream`` another, one
stream split by time over the world with its state carried, each rank's
outputs kept on the rank, its steps watched for waits on the card and
traced. This module imports no JAX, so that spawned ranks stay light.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["first_divergence", "assert_close", "rms", "ulps_apart",
           "rel_max_err", "sharded_cases", "sharded_stream"]

# significant bits and the exponent of the smallest spacing (subnormal)
_SPACING = {torch.bfloat16: (8, -133), torch.float16: (11, -24)}


def ulps_apart(a: torch.Tensor, b: torch.Tensor, dtype,
               floor: float = 0.0) -> float:
    """The largest |a - b| in ulps of ``dtype`` (torch.bfloat16 or
    torch.float16), the spacing at the larger of |a| and |b|: at most 1
    where both are the same value rounded apart once. ``floor`` is the
    least spacing counted, so that outputs near zero, whose accumulators
    were summed in another order, are held to the accumulator's own
    tolerance (an absolute ``floor``) rather than to their tiny ulp."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    bits, tiny = _SPACING[dtype]
    a, b = a.double(), b.double()
    exp = torch.frexp(torch.maximum(a.abs(), b.abs())).exponent
    ulp = torch.ldexp(torch.ones_like(a), torch.clamp(exp - bits, min=tiny))
    return float(((a - b).abs() / ulp.clamp(min=floor)).max())


def rel_max_err(got, want) -> float:
    """max|got - want| / max|want| over real or complex arrays or tensors
    (on any device), in complex128: the modulus of a complex difference,
    never its real part alone. Shapes must agree; 0 for empty arrays."""
    got, want = (v.detach().cpu().to(torch.complex128).numpy()
                 if isinstance(v, torch.Tensor)
                 else np.asarray(v).astype(np.complex128)
                 for v in (got, want))
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {got.shape}, {want.shape}")
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def rms(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128).ravel()
    b = np.asarray(b, dtype=np.complex128).ravel()
    n = min(a.size, b.size)
    if n == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.abs(a[:n] - b[:n]) ** 2)))


def first_divergence(a, b, rtol: float, atol: float):
    """Index of the first element where a and b differ beyond tolerance,
    or -1 if all close."""
    a = np.asarray(a)
    b = np.asarray(b)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    if not bad.any():
        return -1
    return int(np.argwhere(bad)[0][-1])


def assert_close(actual, expected, rtol=None, atol=0.0, label: str = ""):
    """Elementwise comparison with index-of-first-divergence reporting.

    Default rtol is sqrt(eps) of the wider real dtype — the same bound as
    Julia's isapprox default used throughout the reference tests."""
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (
        f"{label}: shape mismatch {actual.shape} vs {expected.shape}")
    if rtol is None:
        rdt = np.finfo(np.promote_types(
            actual.real.dtype, expected.real.dtype)).eps
        rtol = float(np.sqrt(rdt))
    i = first_divergence(actual, expected, rtol, atol)
    if i >= 0:
        lo, hi = max(0, i - 3), i + 4
        raise AssertionError(
            f"{label}: first divergence at index {i} (rtol={rtol}, "
            f"atol={atol})\nactual  [{lo}:{hi}] = {actual[..., lo:hi]}\n"
            f"expected[{lo}:{hi}] = {expected[..., lo:hi]}\n"
            f"rms = {rms(actual, expected)}")


def _host(t):
    """A result tensor as a numpy array (bfloat16 and float16 as
    float32)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.detach().cpu().numpy()


def _sharded_case(case, mesh, device):
    """One case of ``sharded_cases`` on this rank: its global result."""
    from .. import models, ops
    from ..parallel import sharded as sh

    kind = case["kind"]
    dev = torch.device(device)
    if kind == "model":
        m = models.MultiChannelResampler(*case["args"], device=device,
                                         **case["kw"])
        return {"y": _host(m(torch.from_numpy(case["x"]).to(dev)))}
    h = torch.from_numpy(case["h"])
    x = torch.from_numpy(case["x"]).to(dev)
    if case.get("dtype") == "bfloat16":  # the bf16 mode's values
        h, x = h.to(torch.bfloat16), x.to(torch.bfloat16)
    params = ops.make_kernel(h, device=device, **case["kw"])
    if kind == "resample":
        return {"y": _host(sh.sharded_resample(params, x, mesh))}
    if kind == "short":
        xl, _ = sh.local_block(params, x, mesh)
        try:
            sh.shard_filt(params, xl, mesh)
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    # "stream": super-blocks through shard_filt_block and compact, with
    # compact_device beside compact
    state = ops.init_state(params, (x.shape[0] // mesh.size(0),), x.dtype,
                           device=dev)
    outs, equal, counts_seen = [], True, []
    nsb = case.get("blocks", 1)
    step = x.shape[-1] // nsb
    for b in range(nsb):
        xl, _ = sh.local_block(params, x[:, b * step:(b + 1) * step], mesh)
        y, counts, state = sh.shard_filt_block(params, state, xl, mesh)
        dense = sh.compact(y, counts, mesh)
        packed, total = sh.compact_device(y, counts, mesh)
        equal &= total == dense.shape[-1] and torch.equal(
            packed[:, :total], dense) and not packed[:, total:].any()
        outs.append(dense)
        counts_seen.append(list(counts))
    y = torch.cat(sh._gather(torch.cat(outs, -1), mesh, "ch"), 0)
    hist = torch.cat(sh._gather(state.history, mesh, "ch"), 0)
    return {"y": _host(y), "counts": counts_seen, "compact_device": equal,
            "state": (_host(hist), state.phase, state.deficit)}


def sharded_cases(rank, device, cases):
    """The rank function of ``spawn_world`` for the sharded tests: every
    case (a dict: ``id``, ``mesh`` (n_ch, n_t), ``kind``, taps ``h``,
    signal ``x`` and ``make_kernel`` keywords ``kw``) on its mesh, each
    mesh built once, in the cases' order on every rank. Returns, from
    every rank, ``{id: result}`` with each result global (gathered over
    both mesh dims), plus the port-only checks: ``make_mesh``'s refusal
    of a world-size mismatch and ``local_data_slice``'s defaults."""
    import torch.distributed as dist

    from ..parallel import make_mesh, multihost

    meshes, out = {}, {}
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        out[case["id"]] = _sharded_case(case, meshes[shape], device)
    try:
        make_mesh(3, 1)
        out["mesh_mismatch"] = None
    except ValueError as e:
        out["mesh_mismatch"] = str(e)
    out["slice"] = multihost.local_data_slice(10_007, quantum=160)
    out["world"] = (dist.get_world_size(), dist.get_rank(),
                    multihost.is_multihost())
    return out


def sharded_stream(rank, device, h, x, kw, calls):
    """The rank function of ``spawn_world`` for one stream split by time
    over a (1, world) mesh: ``x`` (C, calls * N) numpy holds the calls'
    super-blocks side by side, and call c runs ``shard_filt_block`` on
    this rank's (C, N / world) block of super-block c, the state carried
    from call to call (``make_kernel(h, device=device, **kw)``). On the
    card each step runs under ``torch.cuda.set_sync_debug_mode("error")``,
    so a step that waits for the card raises. Then the first two calls
    run again from a fresh state under a profiler session.

    Returns this rank's outputs of each call (numpy), every call's counts,
    the state after the calls (history as numpy, phase, deficit), the
    tracer's record after the untraced calls, and its record after the
    traced ones."""
    import torch.distributed as dist

    from ..ops.params import init_state, make_kernel
    from ..parallel import make_mesh, shard_filt_block
    from . import profiling

    world = dist.get_world_size()
    N = x.shape[-1] // calls
    n = N // world
    mesh = make_mesh(1, world)
    params = make_kernel(h, device=device, **kw)
    xd = torch.from_numpy(x).to(device)
    blocks = [xd[:, c * N + rank * n:c * N + (rank + 1) * n].contiguous()
              for c in range(calls)]

    def step(state, blk):
        if not xd.is_cuda:
            return shard_filt_block(params, state, blk, mesh)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return shard_filt_block(params, state, blk, mesh)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    profiling.clear()
    state = init_state(params, (x.shape[0],), xd.dtype)
    ys, counts = [], []
    for blk in blocks:
        y, cnt, state = step(state, blk)
        ys.append(_host(y))
        counts.append(list(cnt))
    untraced = profiling.spans()
    fresh = init_state(params, (x.shape[0],), xd.dtype)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear()
        for blk in blocks[:2]:
            fresh = step(fresh, blk)[2]
    return {"y": ys, "counts": counts,
            "state": (_host(state.history), state.phase, state.deficit),
            "untraced": untraced, "spans": profiling.spans()}
