"""``pull_us.stream``: the host's time in ``StreamingResampler.pull()`` (the
concatenation, the synchronization and the copy to the host), in
microseconds, by the benchmark's own clock around each call: the mean over
the traced window's pulls that returned output."""


def read(run):
    pulls = run.counters.get("pull_seconds") or []
    return 1e6 * sum(pulls) / len(pulls) if pulls else None
