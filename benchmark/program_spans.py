"""The program's own spans in a traced run, for the per-layer readers whose
source is ``program_span``.

The port's tracer (``multirate_tpu_torch.utils.profiling``) records a span
exactly while a profiler records, and a run of the benchmark profiles only
its traced window, so after the window the record holds that window's
spans: ``(name, id, parent_id, root_id, start_ns, end_ns)``. A program
without the tracer gives nothing, and a reader then reports nothing.
"""

from __future__ import annotations

__all__ = ["of", "durations_us", "mean_us"]


def of(run):
    """The spans of ``run``'s traced window, or None: no trace, or a
    program without the tracer."""
    if run.trace is None:
        return None
    try:
        import multirate_tpu_torch.utils.profiling as profiling

        return list(profiling.spans())
    except (ImportError, AttributeError):
        return None


def durations_us(spans, name: str, parent: str | None = None) -> list:
    """The durations, in microseconds, of the spans named ``name`` (whose
    parent span is named ``parent``, if given)."""
    if parent is not None:
        parents = {s[1] for s in spans if s[0] == parent}
    return [(s[5] - s[4]) * 1e-3 for s in spans
            if s[0] == name and (parent is None or s[2] in parents)]


def mean_us(run, name: str, parent: str | None = None):
    """The mean duration, in microseconds, of ``run``'s spans named
    ``name`` (under a span named ``parent``, if given), or None."""
    spans = of(run)
    if not spans:
        return None
    d = durations_us(spans, name, parent)
    return sum(d) / len(d) if d else None
