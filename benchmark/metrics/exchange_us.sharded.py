"""``exchange_us.sharded``: the host's time a step spends on the exchange
between the ranks, in microseconds: the summed ``mr.parallel.halo`` (the
halo's point-to-point operations built and enqueued) and
``mr.parallel.history`` (the broadcast of the stream's history) spans of
rank 0's traced window over its count of ``mr.parallel.step`` spans."""

from benchmark import program_spans


def read(run):
    spans = run.counters.get("spans")
    if not spans:
        return None
    steps = sum(1 for s in spans if s[0] == "mr.parallel.step")
    exchange = program_spans.durations_us(spans, "mr.parallel.halo") + \
        program_spans.durations_us(spans, "mr.parallel.history")
    return sum(exchange) / steps if steps and exchange else None
