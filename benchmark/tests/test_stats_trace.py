"""The percentile over every sample, the spread, and the device's busy and
idle time read from a synthetic trace."""

import statistics

import pytest

from benchmark import stats, trace


def test_percentile_is_nearest_rank_over_all_samples():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 99) == 99
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile([5.0], 99) == 5.0
    # the tail of 1,000 chunks: 10 slow ones lie beyond the 99th percentile
    chunks = [1.0] * 990 + [2.0] * 9 + [50.0]
    assert stats.percentile(chunks, 99) == 1.0
    assert stats.percentile(chunks + [3.0], 99) == 2.0
    assert stats.percentile(reversed(xs), 99) == 99  # order does not matter
    with pytest.raises(ValueError):
        stats.percentile([], 99)
    with pytest.raises(ValueError):
        stats.percentile(xs, 0)


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)
    assert stats.spread([5.0] * 6) == 0.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _synthetic():
    """A 100 us window: kernels at 10-30 and 25-40 (overlapping), a copy at
    60-70, a kernel partly outside (95-120); host spans push 0-20,
    pull 40-65, push 65-100."""
    return {"traceEvents": [
        _ev("user_annotation", trace.WINDOW, 0.0, 100.0),
        _ev("kernel", "void polyphase_reg<float>(...)", 10.0, 20.0),
        _ev("kernel", "void resample_kernel<float>(...)", 25.0, 15.0),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 60.0, 10.0),
        _ev("kernel", "void polyphase_reg<float>(...)", 95.0, 25.0),
        _ev("user_annotation", "push", 0.0, 20.0),
        _ev("user_annotation", "pull", 40.0, 25.0),
        _ev("user_annotation", "push", 65.0, 35.0),
        _ev("gpu_user_annotation", "push", 0.0, 100.0),  # not device work
        _ev("cpu_op", "aten::empty", 1.0, 1.0),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 3.0},
    ]}


def test_busy_and_idle_of_a_synthetic_trace():
    t = trace.from_chrome(_synthetic())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_intervals() == [(10.0, 40.0), (60.0, 70.0), (95.0, 100.0)]
    assert t.busy_s() == pytest.approx(45e-6)
    # the idle share the readers report
    assert 100 * (1 - t.busy_s() / t.window_s) == pytest.approx(55.0)
    assert t.device_s() == pytest.approx(50e-6)  # sums, clipped to window
    assert t.device_s("polyphase") == pytest.approx(25e-6)
    assert t.device_s("resample") == pytest.approx(15e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void polyphase_reg<float>(...)",
                                  pytest.approx(25e-6)]
    # gaps 0-10 (push), 40-60 (pull), 70-95 (push)
    assert b["idle_gaps"] == [["push", pytest.approx(35e-6)],
                              ["pull", pytest.approx(20e-6)],
                              ["loop", pytest.approx(0.0, abs=1e-12)]]


def test_idle_time_is_split_by_the_host_spans_it_passes():
    """A gap from 10 to 90 us over push 20-30 and pull 50-70: 10 us in
    push, 20 in pull, the other 50 in the loop outside both."""
    t = trace.from_chrome({"traceEvents": [
        _ev("user_annotation", trace.WINDOW, 0.0, 100.0),
        _ev("kernel", "k", 0.0, 10.0), _ev("kernel", "k", 90.0, 10.0),
        _ev("user_annotation", "push", 20.0, 10.0),
        _ev("user_annotation", "pull", 50.0, 20.0)]})
    idle = dict(t.breakdown()["idle_gaps"])
    assert idle == {"loop": pytest.approx(50e-6), "pull": pytest.approx(20e-6),
                    "push": pytest.approx(10e-6)}
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s())


def test_a_trace_without_its_window_is_refused():
    doc = _synthetic()
    doc["traceEvents"] = doc["traceEvents"][1:]
    with pytest.raises(ValueError):
        trace.from_chrome(doc)


def test_readers_find_nothing_where_nothing_ran_on_the_device():
    """A reader that finds nothing to read returns nothing, never 0."""
    from benchmark import cell
    from benchmark.run import Run

    c = cell.load("dat_to_cd.madi_block")
    t = trace.from_chrome({"traceEvents": [
        _ev("user_annotation", trace.WINDOW, 0.0, 100.0)]})
    run = Run(cell=c, counters={"least_s": 1e-5, "window_s": 1e-4},
              trace=t)
    for name in ("polyphase_roofline", "resample_roofline",
                 "device_idle_pct.block", "nonkernel_device_pct.block"):
        assert c.reader(name)(run) is None
    s = cell.load("dat_to_cd.pcm_stream")
    run = Run(cell=s, counters={"block_seconds": [], "pull_seconds": []},
              trace=None)
    for name in ("device_idle_pct.stream", "block_dispatch_us.stream",
                 "pull_us.stream"):
        assert s.reader(name)(run) is None


def test_readers_of_a_synthetic_trace():
    from benchmark import cell
    from benchmark.run import Run

    c = cell.load("dat_to_cd.madi_block")
    run = Run(cell=c, counters={"least_s": 10e-6, "window_s": 100e-6},
              trace=trace.from_chrome(_synthetic()))
    assert c.reader("polyphase_roofline")(run) == pytest.approx(40.0)
    assert c.reader("resample_roofline")(run) == pytest.approx(200 / 3)
    assert c.reader("device_idle_pct.block")(run) == pytest.approx(55.0)
    assert c.reader("nonkernel_device_pct.block")(run) == \
        pytest.approx(20.0)
    run = Run(cell=c, counters={"block_seconds": [1e-3, 3e-3],
                                "pull_seconds": [1e-4, 2e-4, 3e-4]},
              trace=None)
    assert c.reader("block_dispatch_us.stream")(run) == pytest.approx(2000)
    assert c.reader("pull_us.stream")(run) == pytest.approx(200)
