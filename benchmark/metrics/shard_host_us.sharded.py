"""``shard_host_us.sharded``: the host's time in one call of the sharded
step, ``parallel.shard_filt_block`` (the halo's and the history's
enqueueing, the closed-form counts and entry state, the kernel's launch),
in microseconds: the mean ``mr.parallel.step`` span of rank 0's traced
window."""

from benchmark import program_spans


def read(run):
    spans = run.counters.get("spans")
    d = program_spans.durations_us(spans, "mr.parallel.step") if spans else []
    return sum(d) / len(d) if d else None
