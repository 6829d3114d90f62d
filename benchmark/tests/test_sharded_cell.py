"""The four-card cell ``farrow64.sharded_4chip`` is found by its name, and
its readers read rank 0's record, or nothing where a run has none (a
program without the parallel layer's spans, or an untraced run)."""

import pytest

from benchmark import cell, run

CELL = "farrow64.sharded_4chip"
NEW = {"shard_host_us.sharded", "exchange_us.sharded",
       "comm_device_pct.sharded", "rank_skew_pct.sharded"}


def test_the_cell_loads_by_name():
    c = cell.load(CELL)
    assert c.workload["chips"] == 4 and c.traffic["entry"] == "sharded"
    assert c.config["name"] == "farrow64" and c.config["mesh"] == [1, 4]
    assert callable(c.entry())
    assert {m["name"] for m in c.end_to_end} == {"block_msps", "setup_s"}
    names = {m["name"] for m in c.per_layer}
    assert names == NEW | {"resample_roofline", "device_idle_pct.block"}
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
    assert set(c.limits) == {"max_err", "count_gap"}
    assert c.limits["count_gap"]["limit"] == 0


def _run(counters, trace=None):
    return run.Run(cell=cell.load(CELL), counters=counters, trace=trace)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_a_reader_reads_nothing_without_a_record(metric):
    read = cell.load(CELL).reader(metric)
    assert read(_run({"window_s": 1.0})) is None
    assert read(_run({"window_s": 1.0, "calls": 10, "spans": None,
                      "caught_up": None})) is None


def test_the_readers_read_rank_0s_record():
    c = cell.load(CELL)
    us = 1000  # ns
    spans = [("mr.parallel.halo", 2, 1, 1, 0, 30 * us),
             ("mr.parallel.history", 3, 1, 1, 40 * us, 50 * us),
             ("mr.parallel.step", 1, None, 1, 0, 100 * us),
             ("mr.parallel.halo", 5, 4, 4, 200 * us, 220 * us),
             ("mr.parallel.history", 6, 4, 4, 250 * us, 260 * us),
             ("mr.parallel.step", 4, None, 4, 200 * us, 300 * us)]
    r = _run({"window_s": 2.0, "calls": 400, "spans": spans,
              "caught_up": [0, 4, 1, 0]})
    assert c.reader("shard_host_us.sharded")(r) == pytest.approx(100.0)
    assert c.reader("exchange_us.sharded")(r) == pytest.approx(35.0)
    assert c.reader("rank_skew_pct.sharded")(r) == pytest.approx(1.0)
