"""``rank_skew_pct.sharded``: how much of the window the slowest rank's
host held its card back, in %: the largest, over the ranks, of the share
of the window's calls at which the rank's card had caught up with its
host (the entry's ``caught_up``: fewer than ``LEAD`` calls queued as a
call returned, read from CUDA events the host queries without waiting).
A rank whose host falls behind its card reads high; the other three,
whose cards then wait for its halo and history while their hosts stay
ahead, do not. Nothing on the CPU, which has no such events."""


def read(run):
    caught = run.counters.get("caught_up")
    if not caught:
        return None
    return 100.0 * max(caught) / run.counters["calls"]
