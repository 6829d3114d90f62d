"""The readers of the program's spans (source ``program_span``): each reads
synthetic spans of a known mean, and reports nothing without a trace, with
no spans, or with a program whose tracer has no ``spans``."""

import pytest

import multirate_tpu_torch.utils.profiling as profiling
from benchmark import cell, trace
from benchmark.run import Run

US = 1000  # ns


def _sp(name, sid, parent, root, start_us, dur_us):
    return (name, sid, parent, root, start_us * US, (start_us + dur_us) * US)


# two pushes, the first dispatching two blocks; a pull; a flush's filt
# (a root: not a block's); launches under the filts
SPANS = [
    _sp("mr.stream.ring_push", 2, 1, 1, 0, 4),
    _sp("mr.stream.ring_pop", 3, 1, 1, 5, 30),
    _sp("mr.stream.stage", 5, 4, 1, 36, 50),
    _sp("mr.kernel.launch", 7, 6, 1, 90, 40),
    _sp("mr.api.filt", 6, 4, 1, 87, 300),
    _sp("mr.stream.block", 4, 1, 1, 35, 360),
    _sp("mr.stream.ring_pop", 8, 1, 1, 400, 26),
    _sp("mr.stream.stage", 10, 9, 1, 430, 70),
    _sp("mr.kernel.launch", 12, 11, 1, 510, 60),
    _sp("mr.api.filt", 11, 9, 1, 505, 500),
    _sp("mr.stream.block", 9, 1, 1, 428, 580),
    _sp("mr.stream.ring_pop", 13, 1, 1, 1010, 2),
    _sp("mr.stream.push", 1, None, 1, 0, 1020),
    _sp("mr.stream.ring_push", 15, 14, 14, 1030, 6),
    _sp("mr.stream.ring_pop", 16, 14, 14, 1040, 2),
    _sp("mr.stream.push", 14, None, 14, 1030, 15),
    _sp("mr.stream.to_host", 18, 17, 17, 1060, 150),
    _sp("mr.stream.pull", 17, None, 17, 1050, 180),
    _sp("mr.kernel.launch", 20, 19, 19, 1300, 20),
    _sp("mr.api.filt", 19, None, 19, 1290, 1000),
]
WANT = {
    # (4 + 30 + 26 + 2 + 6 + 2) / 2 blocks
    "ring_us.stream": ("dat_to_cd.pcm_stream", 35.0),
    "stage_us.stream": ("dat_to_cd.pcm_stream", 60.0),
    # the two filts under a block, not the flush's
    "filt_host_us.stream": ("arb_farrow.sdr_stream", 400.0),
    "pull_wait_us.stream": ("arb_farrow.sdr_stream", 150.0),
    "filt_host_us.block": ("dat_to_cd.madi_block", 600.0),
    "launch_us.block": ("arb_farrow.capture_block", 40.0),
}


def _run(name, traced=True):
    c = cell.load(name)
    t = trace.from_chrome({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0.0, "dur": 2000.0}]}) if traced else None
    return c, Run(cell=c, counters={}, trace=t)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader_reads_its_mean(monkeypatch, metric):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    name, want = WANT[metric]
    c, run = _run(name)
    assert metric in {m["name"] for m in c.per_layer}
    assert c.reader(metric)(run) == pytest.approx(want)
    # no trace, no spans, no tracer in the program: nothing
    assert c.reader(metric)(_run(name, traced=False)[1]) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert c.reader(metric)(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert c.reader(metric)(run) is None


def test_the_new_metrics_are_program_spans_of_their_cells():
    for metric, (name, _) in WANT.items():
        c = cell.load(name)
        m = {m["name"]: m for m in c.per_layer}[metric]
        assert m["source"] == "program_span" and m["unit"] == "us"
        kind = metric.rsplit(".", 1)[1]
        assert all(kind in w for w in m["workloads"])
