"""The port's parallel layer on spawned gloo ranks, against the JAX package.

One world of 4 CPU ranks per file (a module-scoped fixture; the ranks
meet at a ``file://`` store in a temporary directory, so xdist workers
never collide on a port). In it the ranks build the meshes (2, 2), (1, 4)
and (4, 1) in turn and run every case of ``tests/test_sharded.py``'s
matrix, mapped onto 4 ranks; the rank function lives in the port's
``utils/testing.py``, which imports no JAX. The parent runs the JAX
``sharded_resample``, ``shard_filt_block`` and ``compact`` (its sharded
step jitted: an eager shard_map takes ~20 s a call here) on the same
seeded numpy inputs, on conftest's 8-device CPU mesh at the same mesh
shapes, and compares.

Tolerances, those of ``tests/test_sharded.py``: rational rtol/atol 1e-5;
arbitrary in float64 1e-9 / 1e-12; streaming 1e-10 / 1e-12; the
64-channel Farrow 2e-4 / 2e-5; ``MultiChannelResampler`` 1e-4 / 1e-5;
bf16 within 2^-7 * max|y|; int8 bit-exact. Counts and states exact.
"""

import functools
import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu.parallel as jpar
import multirate_tpu_torch as mt
from multirate_tpu.ops import quant as jquant
from multirate_tpu.parallel import multihost as jmh
from multirate_tpu.parallel import sharded as jsh
from multirate_tpu_torch.parallel import multihost as tmh
from multirate_tpu_torch.parallel.multihost import spawn_world
from multirate_tpu_torch.utils.testing import assert_close, sharded_cases
from test_arbitrary import design_taps

WORLD = 4
SPECS = [Fraction(1, 1), Fraction(4, 1), Fraction(1, 4), Fraction(7, 5),
         Fraction(147, 160)]
# tests/test_sharded.py's meshes on 8 devices, (2, 4), (1, 8) and (8, 1),
# become (2, 2), (1, 4) and (4, 1) on 4 ranks
MESH_CASES = ([((2, 2), s) for s in SPECS]
              + [((1, 4), s) for s in (SPECS[0], SPECS[3])]
              + [((4, 1), s) for s in (SPECS[2], SPECS[3])])
RATES = [0.8112, 1.618]
# JAX's plain XLA path (its TPU kernels would run in interpret mode here);
# the quantized modes take "supercycle", as tests/test_sharded.py's
# reference does: JAX's "windows" rounds bf16 and wraps int8
JAX_PATH = "windows"
FARROW_MESHES = [(2, 2), (4, 1)]


def _id(mesh, what):
    return f"{mesh[0]}x{mesh[1]}-{what}"


@functools.cache
def _cases():
    """Every case, seeded: the same inputs go to the ranks and to JAX."""
    cases = []
    rng = np.random.default_rng(0)
    for mesh, spec in MESH_CASES:
        cases.append(dict(
            id=_id(mesh, f"rat{spec}"), mesh=mesh, kind="resample",
            h=rng.standard_normal(48).astype(np.float32),
            x=rng.standard_normal((8, 1600)).astype(np.float32),
            kw={"ratio": spec}))
    h_arb = design_taps().astype(np.float64)
    for rate in RATES:
        cases.append(dict(
            id=_id((2, 2), f"arb{rate}"), mesh=(2, 2), kind="resample",
            h=h_arb, x=rng.standard_normal((4, 1600)), kw={"rate": rate}))
    cases.append(dict(
        id=_id((1, 4), "stream"), mesh=(1, 4), kind="stream", blocks=3,
        h=rng.standard_normal(32), x=rng.standard_normal((2, 2400)),
        kw={"ratio": Fraction(7, 5)}))
    h_far = design_taps().astype(np.float32)
    x_far = rng.standard_normal((64, 800)).astype(np.float32)
    for mesh in FARROW_MESHES:
        cases.append(dict(
            id=_id(mesh, "farrow64"), mesh=mesh, kind="resample", h=h_far,
            x=x_far, kw={"rate": 0.9173, "nphi": 32, "polyorder": 4}))
    h_q = (mr.firdes(24 * 21, 0.5 / 21, mr.kaiser, beta=7.0) * 21
           ).astype(np.float32)
    x_q = rng.standard_normal((4, 64_000)).astype(np.float32)
    hb = np.asarray(jnp.asarray(h_q, jnp.bfloat16)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x_q, jnp.bfloat16)).astype(np.float32)
    cases.append(dict(id=_id((2, 2), "bf16"), mesh=(2, 2), kind="stream",
                      h=hb, x=xb, dtype="bfloat16",
                      kw={"ratio": Fraction(147, 160)}))
    hq, _ = jquant.quantize_taps(h_q)
    xq, _ = jquant.quantize_signal(x_q)
    cases.append(dict(id=_id((2, 2), "int8"), mesh=(2, 2), kind="stream",
                      h=np.asarray(hq), x=np.asarray(xq),
                      kw={"ratio": Fraction(147, 160)}))
    cases.append(dict(id=_id((1, 4), "short"), mesh=(1, 4), kind="short",
                      h=rng.standard_normal(300),
                      x=rng.standard_normal((1, 800)),
                      kw={"ratio": Fraction(1, 1)}))
    cases.append(dict(id="model", mesh=(2, 2), kind="model",
                      args=(Fraction(3, 2),),
                      kw={"n_ch_shards": 2, "attenuation": 50.0},
                      x=rng.standard_normal((8, 1200)).astype(np.float32)))
    return {c["id"]: c for c in cases}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case's result from each of the 4 spawned ranks."""
    store = tmp_path_factory.mktemp("gloo")
    return spawn_world(sharded_cases, WORLD,
                       args=(list(_cases().values()),), device="cpu",
                       store_dir=store, timeout_s=240)


def _jax_mesh(mesh):
    return jpar.make_mesh(*mesh)


def _jax_sharded_resample(p, x, mesh, path=JAX_PATH):
    """JAX ``sharded_resample`` with its sharded step jitted: the same pad
    to n_t * M, ``shard_filt``, ``compact`` and trim to the closed-form
    count (its eager shard_map takes ~20 s a call on the CPU)."""
    N, n_t = x.shape[-1], mesh.shape["t"]
    quantum = n_t * getattr(p, "decimation", 1)
    xp = np.pad(x, ((0, 0), (0, -N % quantum)))
    n_out = int(jsh._outputs_before(p, jsh._fresh_phase(p), 1, N))
    y, counts = jax.jit(lambda v: jpar.shard_filt(p, v, mesh, path=path))(xp)
    return jpar.compact(y, counts)[:, :n_out]


def _ranks_agree(port, cid):
    """Every rank's result of a case (they must hold the same global
    result), as rank 0's."""
    first = port[0][cid]
    for r in range(1, WORLD):
        for key, v in first.items():
            got = port[r][cid][key]
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got, v)
    return first


@pytest.mark.parametrize("mesh,spec", MESH_CASES,
                         ids=[_id(m, str(s)) for m, s in MESH_CASES])
def test_sharded_matches_jax(port, mesh, spec):
    c = _cases()[_id(mesh, f"rat{spec}")]
    p = mr.make_kernel(c["h"], ratio=spec)
    if (mesh, spec) == MESH_CASES[-1]:  # JAX's own call, eager, once
        yj = np.asarray(jpar.sharded_resample(p, c["x"], _jax_mesh(mesh),
                                              path=JAX_PATH))
    else:
        yj = _jax_sharded_resample(p, c["x"], _jax_mesh(mesh))
    y = _ranks_agree(port, c["id"])["y"]
    assert y.dtype == np.float32 and y.shape == yj.shape
    assert_close(y, yj, rtol=1e-5, atol=1e-5, label=f"sharded {spec}")


@pytest.mark.parametrize("rate", RATES)
def test_sharded_arbitrary(port, rate):
    c = _cases()[_id((2, 2), f"arb{rate}")]
    p = mr.make_kernel(c["h"], rate=rate)
    yj = _jax_sharded_resample(p, c["x"], _jax_mesh((2, 2)))
    y = _ranks_agree(port, c["id"])["y"]
    assert y.dtype == np.float64 and y.shape == yj.shape
    assert_close(y, yj, rtol=1e-9, atol=1e-12, label=f"sharded arb {rate}")


def test_sharded_streaming_blocks(port):
    """Three sharded super-blocks through shard_filt_block and compact,
    state carried: outputs, counts and the carried state against JAX's."""
    c = _cases()[_id((1, 4), "stream")]
    p = mr.make_kernel(c["h"], ratio=Fraction(7, 5))
    mesh = _jax_mesh((1, 4))
    state = mr.init_state(p, (2,), jnp.float64)
    step = jax.jit(lambda s, v: jpar.shard_filt_block(p, s, v, mesh,
                                                      path=JAX_PATH))
    outs, counts = [], []
    for b in range(3):
        blk = jnp.asarray(c["x"][:, b * 800:(b + 1) * 800])
        y, cnt, state = step(state, blk)
        outs.append(jpar.compact(y, cnt))
        counts.append([int(v) for v in np.asarray(cnt)])
    got = _ranks_agree(port, c["id"])
    assert got["counts"] == counts
    assert_close(got["y"], np.concatenate(outs, -1), rtol=1e-10,
                 atol=1e-12, label="sharded streaming")
    hist, phase, deficit = got["state"]
    H = hist.shape[-1]
    np.testing.assert_array_equal(hist, np.asarray(state.history)[:, -H:])
    assert (phase, deficit) == (int(state.phase), int(state.deficit))


@pytest.mark.parametrize("mesh", FARROW_MESHES,
                         ids=[_id(m, "") for m in FARROW_MESHES])
def test_sharded_farrow_64ch(port, mesh):
    """The BASELINE.json 64-channel Farrow config, scaled to test size."""
    c = _cases()[_id(mesh, "farrow64")]
    p = mr.make_kernel(c["h"], rate=0.9173, nphi=32, polyorder=4)
    yj = _jax_sharded_resample(p, c["x"], _jax_mesh(mesh))
    y = _ranks_agree(port, c["id"])["y"]
    assert y.shape == yj.shape
    assert_close(y, yj, rtol=2e-4, atol=2e-5, label="sharded farrow 64ch")


def test_block_too_short_raises(port):
    c = _cases()[_id((1, 4), "short")]
    for r in range(WORLD):
        assert "h_min" in port[r][c["id"]]["raised"]
    p = mr.make_kernel(c["h"], ratio=Fraction(1, 1))
    with pytest.raises(ValueError):
        jpar.shard_filt(p, c["x"], _jax_mesh((1, 4)))


def test_multichannel_resampler_model(port):
    from multirate_tpu.models import MultiChannelResampler

    c = _cases()["model"]
    m = MultiChannelResampler(*c["args"], **c["kw"])
    yj = _jax_sharded_resample(m.params, c["x"], m.mesh, path="auto")
    y = _ranks_agree(port, "model")["y"]
    assert y.shape == yj.shape == (8, 1800)
    assert_close(y, yj, rtol=1e-4, atol=1e-5, label="mc model")


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_sharded_quantized_modes(port, mode):
    """bf16 within a bf16 ulp of JAX's sharded step, int8 bit-exact (the
    integer accumulation and the closed-form entry state)."""
    c = _cases()[_id((2, 2), mode)]
    h, x = c["h"], c["x"]
    if mode == "bf16":
        h, x = jnp.asarray(h, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    p = mr.make_kernel(np.asarray(h), ratio=Fraction(147, 160))
    mesh = _jax_mesh((2, 2))
    y, counts, _ = jax.jit(lambda s, v: jpar.shard_filt_block(
        p, s, v, mesh, path="supercycle"))(mr.init_state(p, (4,), x.dtype),
                                           jnp.asarray(x))
    want = jpar.compact(y, counts)
    got = _ranks_agree(port, c["id"])
    assert got["counts"] == [[int(v) for v in np.asarray(counts)]]
    assert got["y"].shape == want.shape
    if mode == "int8":
        assert got["y"].dtype == np.int32
        np.testing.assert_array_equal(got["y"], want)
    else:
        want = want.astype(np.float64)
        assert np.abs(got["y"] - want).max() <= np.abs(want).max() * 2.0 ** -7


@pytest.mark.parametrize("cid", ["stream", "bf16", "int8"])
def test_compact_device_equals_compact(port, cid):
    key = _id((1, 4), cid) if cid == "stream" else _id((2, 2), cid)
    assert all(port[r][key]["compact_device"] for r in range(WORLD))


def test_make_mesh_refuses_world_size_mismatch(port):
    for r in range(WORLD):
        assert "needs 3 ranks, not 4" in port[r]["mesh_mismatch"]
        assert port[r]["world"] == (WORLD, r, True)


def test_local_data_slice_defaults_to_world_and_rank(port):
    for r in range(WORLD):
        assert tuple(port[r]["slice"]) == jmh.local_data_slice(
            10_007, axis_size=WORLD, quantum=160, process_index=r)


@pytest.mark.parametrize("global_len", [0, 1, 159, 160, 10_007, 8_000_000])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_multihost_helpers_match_jax(global_len, n):
    for q in (1, 160, 147 * 8):
        assert tmh.padded_global_len(global_len, q) == \
            jmh.padded_global_len(global_len, q)
        for i in range(n):
            assert tmh.local_data_slice(
                global_len, axis_size=n, quantum=q, process_index=i) == \
                jmh.local_data_slice(global_len, axis_size=n, quantum=q,
                                     process_index=i)
    for tp, jp in _kernel_pairs():
        assert tmh.shard_quantum(tp, n) == jmh.shard_quantum(jp, n)


@functools.cache
def _kernel_pairs():
    h = np.ones(32, np.float32)
    return [(mt.make_kernel(h, ratio=spec, device="cpu"),
             mr.make_kernel(h, ratio=spec))
            for spec in (Fraction(147, 160), Fraction(1, 4), Fraction(4, 1))]


def test_parallel_exports_match_jax():
    assert mt.parallel.__all__ == jpar.__all__
    assert set(tmh.__all__) == set(jmh.__all__)
    for name in jpar.__all__:
        assert callable(getattr(mt.parallel, name))
    assert "MultiChannelResampler" in mt.models.__all__


JAX_BENCH_KEYS = {
    "workload", "n_devices", "kernel_path", "unsharded_block_seconds",
    "weak_wall_seconds", "weak_cpu_seconds", "work_overhead_ratio",
    "work_overhead_ratio_max", "artifact_floor_ratio", "strong_wall_seconds",
    "strong_wall_speedup_shared_cores", "strong_work_overhead_ratio",
    "strong_projected_efficiency", "strong_scaling_note"}


def test_scaling_bench_runs_on_cpu(tmp_path):
    """The benchmark's whole path on one spawned CPU rank: JAX's keys and
    meanings (process CPU time on the CPU), the clamp of the projection."""
    from multirate_tpu_torch.parallel import scaling_bench

    got = scaling_bench.run("cpu", 1, timeout_s=240)
    assert JAX_BENCH_KEYS <= set(got)
    assert got["n_devices"] == 1 and got["kernel_path"] == "windows"
    assert set(got["unsharded_block_seconds"]) == {"wall", "cpu"}
    assert list(got["work_overhead_ratio"]) == ["1"]
    assert got["work_overhead_ratio"]["1"] > 0
    eff, ratio = (got["strong_projected_efficiency"]["1"],
                  got["strong_work_overhead_ratio"]["1"])
    assert eff == round(min(1.0, 1.0 / ratio), 3)
    assert "CPU" in got["device"]


@pytest.mark.parametrize("device,want", [
    ("cpu", "cpu"), ("cuda", "cuda:0"), ("cuda:0", "cuda:0"),
    (None, None)])
def test_spawned_worlds_default_to_the_card(device, want):
    """``spawn_world`` and ``scaling_bench.run`` put their ranks on the
    card unless the caller names the CPU; with no card and no device
    named they raise before spawning anything."""
    from multirate_tpu_torch.parallel import scaling_bench

    if device is not None:
        assert tmh.world_device(device) == want
    elif torch.cuda.is_available():
        assert tmh.world_device() == "cuda:0"
    else:
        for call in (tmh.world_device, scaling_bench.run,
                     lambda: spawn_world(sharded_cases, 1, args=([],))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_initialize_starts_a_world_of_one(tmp_path):
    """With no process group, ``make_mesh`` starts a world of this one
    process (gloo without a card) and ``initialize`` then does nothing;
    ``initialize`` also takes an explicit ``file://`` address. Run in
    fresh interpreters with no card visible, so this process keeps no
    group and the world is gloo's on a host with a card too."""
    code = f"""
import torch, torch.distributed as dist
import multirate_tpu_torch as mt
from fractions import Fraction
from multirate_tpu_torch.parallel import initialize, make_mesh
from multirate_tpu_torch.parallel import sharded as sh
mesh = make_mesh()
assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
initialize()  # a group exists: nothing
assert tuple(mesh.mesh.shape) == (1, 1)
assert list(mesh.get_coordinate()) == [0, 0]
p = mt.make_kernel(torch.ones(8), ratio=Fraction(3, 2), device="cpu")
x = torch.randn(2, 400)
assert torch.equal(sh.sharded_resample(p, x, mesh), mt.filt(
    torch.ones(8), x, Fraction(3, 2)))
st = mt.init_state(p, (3,))
try:
    sh.shard_filt_block(p, st, x, mesh)
    raise SystemExit("a history of the wrong shape was taken")
except ValueError:
    pass
dist.destroy_process_group()
initialize("file://{tmp_path}/store", 1, 0, backend="gloo")
assert dist.get_world_size() == 1 and not mt.parallel.is_multihost()
dist.destroy_process_group()
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
