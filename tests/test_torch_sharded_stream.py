"""The 64-channel Farrow deployment split by time (the benchmark's
configuration ``farrow64``) on a world of 4 gloo ranks on the CPU.

One world per file (a module-scoped fixture) runs ``utils.testing.
sharded_stream``: three super-blocks of 64 x 4,096 samples through
``shard_filt_block`` on a (1, 4) mesh with the state carried, then two
more under a profiler session. Each rank's outputs equal its slice of
``FIRFilter.filt`` on the whole super-blocks exactly, counts and state
too; the spans ``mr.parallel.halo`` and ``mr.parallel.history`` nest under
``mr.parallel.step``, one each a step, recorded only while the profiler
records. Then the benchmark's ``sharded`` entry runs the cell
``farrow64.sharded_4chip`` on such a world (``benchmark.run.run_cell``,
64 x 4,096 samples a call): correct against the float64 reference with
no count gap, and not correct with the signal read in bfloat16.
"""

import numpy as np
import pytest
import torch

import multirate_tpu_torch as mt
from benchmark import cell as bcell
from benchmark import designs, run
from multirate_tpu_torch.parallel.multihost import spawn_world
from multirate_tpu_torch.utils.testing import sharded_stream

WORLD, CALLS = 4, 3
TRACED = 2  # calls run again under a profiler (utils.testing.sharded_stream)
C, N = 64, 4096  # a super-block: N samples a channel, N / WORLD a rank
CELL = "farrow64.sharded_4chip"
SMALL = {"entry": "sharded", "channels": C, "samples": N, "inputs": 2}
SEED = 2 ** 31 + 4242


def _config():
    return bcell.load(CELL).config


def _kw():
    cfg = _config()
    return {"rate": cfg["rate"], "nphi": cfg["nphi"],
            "polyorder": cfg["polyorder"]}


def _taps():
    cfg = _config()
    return designs.taps(cfg).astype(cfg["dtype"])


def _signal():
    rng = np.random.default_rng(17)
    return rng.standard_normal((C, CALLS * N)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo")
    return spawn_world(sharded_stream, WORLD,
                       args=(_taps(), _signal(), _kw(), CALLS),
                       device="cpu", store_dir=store, timeout_s=240)


@pytest.fixture(scope="module")
def whole():
    """``FIRFilter.filt`` of each whole super-block, state carried."""
    f = mt.FIRFilter(_taps(), _kw()["rate"], nphi=_kw()["nphi"],
                     polyorder=_kw()["polyorder"], device="cpu")
    x = torch.from_numpy(_signal())
    ys = [f.filt(x[:, c * N:(c + 1) * N]).numpy() for c in range(CALLS)]
    return ys, f.state


def test_the_configuration_is_the_deployment():
    cfg = _config()
    assert cfg["mesh"] == [1, WORLD] and cfg["channels"] == C
    assert 1.0 / cfg["rate_inverse"] == cfg["rate"] == 0.9173
    assert _taps().shape == (320,)


@pytest.mark.parametrize("call", range(CALLS))
def test_sharded_calls_equal_filt_exactly(ranks, whole, call):
    want = whole[0][call]
    counts = ranks[0]["counts"][call]
    assert sum(counts) == want.shape[-1]
    edges = np.cumsum([0] + counts)
    for k, r in enumerate(ranks):
        assert r["counts"][call] == counts
        np.testing.assert_array_equal(r["y"][call],
                                      want[:, edges[k]:edges[k + 1]])


def test_the_carried_state_equals_filt(ranks, whole):
    st = whole[1]
    for r in ranks:
        hist, phase, deficit = r["state"]
        assert (phase, deficit) == (st.phase, st.deficit)
        np.testing.assert_array_equal(hist, st.history.numpy())


def test_spans_record_only_while_a_profiler_records(ranks):
    for r in ranks:
        assert r["untraced"] == []


def test_spans_nest_under_the_step(ranks):
    for r in ranks:
        by_id = {s[1]: s for s in r["spans"]}
        for name, sid, parent, root, t0, t1 in r["spans"]:
            assert t0 <= t1
            if name == "mr.parallel.step":
                assert parent is None and root == sid
            elif name in ("mr.parallel.halo", "mr.parallel.history"):
                step = by_id[parent]
                assert step[0] == "mr.parallel.step" and root == step[1]
                assert step[4] <= t0 <= t1 <= step[5]


def test_span_counts_match_the_calls(ranks):
    for r in ranks:
        names = [s[0] for s in r["spans"]]
        for name in ("mr.parallel.step", "mr.parallel.halo",
                     "mr.parallel.history"):
            assert names.count(name) == TRACED, name


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_correct_on_a_cpu_world(traced):
    result = run.run_cell(CELL, SEED, 0.3, traced, device="cpu",
                          traffic=SMALL)
    assert result["correct"], result["checks"]
    assert result["checks"]["count_gap"]["value"] == 0
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert result["device"]["count"] == WORLD
    metrics = result["metrics"]
    if traced:  # the CPU has no device trace and no CUDA events: the
        # program's spans
        assert set(metrics) == {"shard_host_us.sharded",
                                "exchange_us.sharded"}
        assert 0 < metrics["exchange_us.sharded"]["value"] < \
            metrics["shard_host_us.sharded"]["value"]
    else:
        assert set(metrics) == {"block_msps", "setup_s"}
        assert metrics["block_msps"]["value"] > 0


def test_the_bfloat16_control_is_not_correct():
    result = run.run_cell(CELL, SEED + 1, 0.2, False, device="cpu",
                          control=True, traffic=SMALL)
    assert not result["correct"]
    assert result["checks"]["max_err"]["value"] > \
        result["checks"]["max_err"]["limit"]
    assert result["checks"]["count_gap"]["value"] == 0


def test_an_nccl_world_needs_a_card_a_rank():
    """Refused before anything is spawned: no card (or too few), or a
    backend other than gloo and nccl."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("a host with 64 cards")
    with pytest.raises(RuntimeError, match="needs 64 CUDA devices"):
        spawn_world(sharded_stream, 64, backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        spawn_world(sharded_stream, 2, device="cpu", backend="mpi")
