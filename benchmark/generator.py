"""What every entry shares: the outcome it hands the harness, the program's
constructor arguments, and the measured window.

A traffic mix (``traffic/<mix>.json``) is data: the name of the entry that
drives it (``entry``) and that entry's parameters. The entry is a loop of
its own, ``entries/<entry>.py``, found by that name (``cell.Cell.entry``):
``run(cell, seed, seconds, device, traced, control, t_start)`` makes its
inputs from the seed, warms up the shapes it uses, resets the program's
state, measures for the window in a closed loop and returns an
``Outcome``. Two entries are here:

- ``block``: ``FIRFilter.filt`` on device inputs, reporting ``block_msps``;
- ``stream``: ``StreamingResampler.push`` and ``pull`` from host memory,
  reporting ``stream_msps`` and ``chunk_p99_ms``.

A new mix for an entry that is here is a new data file; a mix that needs
another loop adds an entry file, and edits none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from fractions import Fraction

from . import trace

__all__ = ["TRACE_WINDOW_S", "Outcome", "program_spec", "sync", "peak",
           "window"]

TRACE_WINDOW_S = 2.0  # the traced run's window, at most


@dataclasses.dataclass
class Outcome:
    """What one run of an entry gives the harness."""
    setup_s: float
    build_s: float         # the first call's time beyond the second's
    metrics: dict          # end-to-end values by name
    counters: dict         # what the per-layer readers read
    attempted: int
    failed: int
    count_gap: int
    memory_peak_bytes: int
    reference: object      # the configuration's plain reference
    readings: list         # (channel, first output, outputs) sampled
    read_input: object     # (channel, a, b) -> float64 inputs [a, b)
    trace: object = None   # the traced window's ``trace.Trace``


def program_spec(config: dict):
    """(ratio or rate, keywords) of the port's constructors: a ``ratio``
    [L, M], or a rate 1 / ``rate_inverse`` over ``nphi`` phases (Farrow
    with a ``polyorder``)."""
    if "ratio" in config:
        return Fraction(*config["ratio"]), {}
    kw = {"nphi": int(config["nphi"])}
    if config.get("polyorder") is not None:
        kw["polyorder"] = int(config["polyorder"])
    return 1.0 / float(config["rate_inverse"]), kw


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak(device) -> int:
    """The device's peak of allocated bytes so far (0 on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def window(seconds: float, traced: bool, device, body):
    """Run ``body(t0, deadline)`` from a synchronized start, traced (for
    at most ``TRACE_WINDOW_S``) or not; returns (its result, the ``Trace``
    or None)."""
    seconds = min(seconds, TRACE_WINDOW_S) if traced else seconds
    sync(device)
    got = {}
    with (trace.profiled(device) if traced
          else contextlib.nullcontext(got)) as got:
        with trace.span(trace.WINDOW, traced):
            t0 = time.perf_counter()
            out = body(t0, t0 + seconds)
            sync(device)
    return out, got.get("trace")
