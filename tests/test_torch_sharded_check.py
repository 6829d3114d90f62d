"""``correct`` of the four-card cell ``farrow64.sharded_4chip`` sees the
exchange between the ranks.

A rank's first outputs are the only ones that read inputs left of its
block: the left rank's halo, or on rank 0 the history broadcast from the
last rank. At a size where a rank's block holds many times two slices of
outputs (4 x 65,536 samples a call, 16,384 a rank on a world of 4 gloo
ranks on the CPU), the benchmark's ``sharded`` entry is correct, and not
correct where the halo arrives as zeros, or where the history stays the
fresh filter's zeros. The faults replace what ``exchange_halo`` or
``broadcast_tail`` return inside the spawned ranks, after the exchange
has run, so that the ranks still meet in every collective.

The entry's count of the calls at which a rank's card had caught up with
its host (``rank_skew_pct.sharded``) is held on a fake card and its
events: a host that lags counts, the ramp before the queue fills does
not.
"""

import functools

import pytest
import torch

import multirate_tpu_torch.parallel.multihost as multihost
from benchmark import run
from benchmark.entries.sharded import LEAD, _CaughtUp

CELL = "farrow64.sharded_4chip"
WIDE = {"entry": "sharded", "channels": 4, "samples": 4 * 16384,
        "inputs": 2}
SEED = 2 ** 33 + 977


def _zeroed(fn, when):
    def faulty(*args, **kwargs):
        out = fn(*args, **kwargs)
        return torch.zeros_like(out) if when() else out
    return faulty


def _faulty_rank(fault, rank_fn, rank, device, *args):
    """``rank_fn`` with the parallel layer's ``fault`` planted."""
    import torch.distributed as dist

    from multirate_tpu_torch.parallel import sharded

    if fault == "halo":  # every rank but the first reads its left's tail
        sharded.exchange_halo = _zeroed(sharded.exchange_halo,
                                        lambda: dist.get_rank() > 0)
    elif fault == "history":
        sharded.broadcast_tail = _zeroed(sharded.broadcast_tail,
                                         lambda: True)
    return rank_fn(rank, device, *args)


@pytest.mark.parametrize("fault", [None, "halo", "history"])
def test_correct_reads_the_exchange(monkeypatch, fault):
    if fault is not None:
        spawn = multihost.spawn_world
        monkeypatch.setattr(
            multihost, "spawn_world",
            lambda fn, *a, **kw: spawn(
                functools.partial(_faulty_rank, fault, fn), *a, **kw))
    result = run.run_cell(CELL, SEED, 0.3, False, device="cpu",
                          traffic=WIDE)
    checks = result["checks"]
    assert checks["count_gap"]["value"] == 0
    if fault is None:
        assert result["correct"], checks
    else:
        assert not result["correct"]
        assert checks["max_err"]["value"] > checks["max_err"]["limit"]


class _Card:
    """A card that has ended ``done`` of the ``issued`` calls."""
    issued = done = 0


class _Event:
    def __init__(self, card):
        self.card, self.at = card, None

    def record(self):
        self.at = self.card.issued

    def query(self):
        return self.card.done >= self.at


@pytest.mark.parametrize("ramp", [3, 12])
def test_caught_up_counts_the_calls_a_host_lags(ramp):
    """The card keeps up for ``ramp`` calls, then the host runs 20 calls
    ahead, except calls 60 to 79, where the card catches up: those 20
    count, and the ramp does not."""
    card = _Card()
    lag = _CaughtUp([_Event(card) for _ in range(LEAD)])
    for k in range(100):
        card.issued += 1
        behind = k < ramp or 60 <= k < 80
        card.done = card.issued if behind else card.issued - 20
        lag.tick()
    assert lag.calls == 100 and lag.count == 20
