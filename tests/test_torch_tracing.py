"""The port's tracer (``utils.profiling``): spans record exactly while a
profiler records, nest by parent and root, land in the Chrome trace as
``cpu_op`` events and never as ``user_annotation`` (so the benchmark's
reading of a trace is the same with and without them), and stop at the
cap; ``annotate`` is a span of the same tracer."""

import json
import os
import threading
from fractions import Fraction

import numpy as np
import pytest
import torch

import multirate_tpu_torch as mt
from benchmark import trace as btrace
from multirate_tpu_torch.utils import profiling

# each span the CPU path reaches, and the name of its parent span
PARENT = {"mr.stream.push": None,
          "mr.stream.ring_push": "mr.stream.push",
          "mr.stream.ring_pop": "mr.stream.push",
          "mr.stream.block": "mr.stream.push",
          "mr.stream.stage": "mr.stream.block",
          "mr.api.filt": "mr.stream.block",
          "mr.stream.pull": None,
          "mr.stream.to_host": "mr.stream.pull"}


def _stream(spec=Fraction(3, 2)):
    h = np.random.default_rng(14).standard_normal(96).astype(np.float32)
    kw = {} if isinstance(spec, Fraction) else {"nphi": 32}
    f = mt.FIRFilter(h, spec, device="cpu", **kw)
    return mt.io.StreamingResampler(f, block_size=512)


def _feed(s, pcm):
    x = np.random.default_rng(15).standard_normal(3000)
    x = (x * 3000).astype(np.int16) if pcm else x.astype(np.float32)
    for a in range(0, 2400, 300):
        s.push(x[a:a + 300])
        s.pull()
    return x


def _by_id():
    return {s[1]: s for s in profiling.spans()}


def test_nothing_is_recorded_without_a_profiler():
    profiling.clear()
    s = _stream()
    x = _feed(s, pcm=False)
    s.push(x[2400:2700])
    s.flush()
    f = mt.FIRFilter(np.ones(8, np.float32), Fraction(2, 3), device="cpu")
    f.filt(torch.ones(100))
    with profiling.span("mr.user"):
        pass
    assert profiling.spans() == [] and profiling.counts() == {}
    assert profiling.dropped() == 0
    assert s.stats()["block_seconds_last"] > 0  # the counter still counts


@pytest.mark.parametrize("spec,pcm", [(Fraction(3, 2), True),
                                      (1 / 2.123456789, False)],
                         ids=["rational-pcm", "farrow-float"])
def test_stream_spans_nest_under_their_parents(tmp_path, spec, pcm):
    s = _stream(spec)
    with mt.utils.trace(str(tmp_path)):
        _feed(s, pcm)
    spans = profiling.spans()
    by_id = _by_id()
    assert set(profiling.counts()) == set(PARENT)
    counts = profiling.counts()
    assert counts["mr.stream.push"] == counts["mr.stream.ring_push"] == 8
    assert counts["mr.stream.block"] == counts["mr.stream.stage"] == \
        counts["mr.api.filt"] == s.stats()["blocks"]
    # one pop a push finds nothing, one more for each block it finds
    assert counts["mr.stream.ring_pop"] == 8 + counts["mr.stream.block"]
    assert counts["mr.stream.pull"] == counts["mr.stream.to_host"]
    for name, sid, parent, root, t0, t1 in spans:
        assert t0 <= t1
        want = PARENT[name]
        if want is None:
            assert parent is None and root == sid
            continue
        p = by_id[parent]
        assert p[0] == want and root == p[3]
        assert p[4] <= t0 <= t1 <= p[5]  # inside its parent
    # the block counter is the block span's duration, same clock reads
    last = max((sp for sp in spans if sp[0] == "mr.stream.block"),
               key=lambda sp: sp[1])
    assert s.stats()["block_seconds_last"] == (last[5] - last[4]) * 1e-9


def test_filt_alone_is_a_root_and_trace_clears_the_record(tmp_path):
    f = mt.FIRFilter(np.ones(8, np.float32), Fraction(2, 3), device="cpu")
    with mt.utils.trace(str(tmp_path / "a")):
        f.filt(torch.ones(100))
        f(torch.ones(50))  # __call__ is filt
    with mt.utils.trace(str(tmp_path / "b")):
        f.filt(torch.ones(100))
    (only,) = profiling.spans()
    assert only[0] == "mr.api.filt" and only[2] is None and only[3] == only[1]


def test_spans_are_cpu_ops_and_leave_the_benchmarks_reading(tmp_path):
    s = _stream()
    with mt.utils.trace(str(tmp_path)):
        with btrace.span(btrace.WINDOW, True):
            with btrace.span("push", True):
                s.push(np.ones(1500, np.float32))
            with btrace.span("pull", True):
                s.pull()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        doc = json.load(fh)
    ours = [e for e in doc["traceEvents"]
            if e.get("name", "").startswith("mr.")]
    assert {e["name"] for e in ours} == set(PARENT)
    assert {e.get("cat") for e in ours} == {"cpu_op"}
    assert sorted(e["name"] for e in ours) == \
        sorted(sp[0] for sp in profiling.spans())
    bare = {"traceEvents": [e for e in doc["traceEvents"] if e not in ours]}
    with_ours, without = btrace.from_chrome(doc), btrace.from_chrome(bare)
    assert [sp[0] for sp in with_ours.spans] == ["push", "pull"]
    assert with_ours.spans == without.spans
    assert with_ours.window == without.window
    assert with_ours.breakdown() == without.breakdown()


def test_the_cap_counts_what_it_drops(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "CAP", 3)
    with mt.utils.trace(str(tmp_path)):
        for i in range(5):
            with profiling.span(f"mr.test.{i}"):
                pass
    assert [sp[0] for sp in profiling.spans()] == \
        ["mr.test.0", "mr.test.1", "mr.test.2"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_annotate_is_a_span_as_context_and_decorator(tmp_path):
    f = mt.FIRFilter(np.ones(8, np.float32), Fraction(2, 3), device="cpu")

    @mt.utils.annotate("decorated")
    def twice(a):
        return 2 * a

    with mt.utils.trace(str(tmp_path)):
        with mt.utils.annotate("region") as region:
            f.filt(torch.ones(100))
        assert twice(3) == 6 and twice(4) == 8
    names = [sp[0] for sp in profiling.spans()]
    assert names == ["mr.api.filt", "region", "decorated", "decorated"]
    by_id = _by_id()
    filt = profiling.spans()[0]
    assert filt[2] == region.id and filt[3] == region.id
    assert by_id[region.id][2] is None
    d1, d2 = profiling.spans()[2:]
    assert d1[1] != d2[1]  # a fresh span for each decorated call


def test_threads_keep_their_own_nesting(tmp_path):
    # a thread the profiler did not start in records only where a site
    # hands it the answer; its spans never nest under another thread's
    seen = {}

    def other():
        with profiling.span("mr.test.other") as off:
            seen["off"] = off.id
        with profiling.span("mr.test.other", True) as sp:
            seen["parent"], seen["root"] = sp.parent_id, sp.root_id

    with mt.utils.trace(str(tmp_path)):
        with profiling.span("mr.test.main") as main:
            t = threading.Thread(target=other)
            t.start()
            t.join()
    assert seen["off"] is None
    assert seen["parent"] is None and seen["root"] != main.id
    assert sorted(sp[0] for sp in profiling.spans()) == ["mr.test.main",
                                                         "mr.test.other"]
