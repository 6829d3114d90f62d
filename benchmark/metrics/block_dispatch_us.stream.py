"""``block_dispatch_us.stream``: the host's time to dispatch one block of
the stream (ring pop, pinned staging, the filter's host work and the
launch), in microseconds: ``StreamingResampler.stats()["block_seconds_last"]``
read after each ``push`` that ran a block, their mean over the traced
window."""


def read(run):
    blocks = run.counters.get("block_seconds") or []
    return 1e6 * sum(blocks) / len(blocks) if blocks else None
