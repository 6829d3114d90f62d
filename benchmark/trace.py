"""The traced run's timeline: what ran on the device, and what the host was
doing.

``profiled(device)`` runs ``torch.profiler`` over a block of code, exports
the Chrome trace to a temporary directory and reads it back as a ``Trace``:
the device's operations (kernels, copies and fills, from CUPTI), the
benchmark's own spans on the host (``torch.profiler.record_function``
around each call it makes into the program) and the traced window (the
span named ``WINDOW``). Device and host events share the profiler's
clock. The per-layer readers (``metrics/``) take their numbers from here.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

__all__ = ["WINDOW", "DEVICE_CATEGORIES", "Trace", "from_chrome", "profiled",
           "span"]

WINDOW = "window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 100  # device op names are cut to this length in a breakdown
TOP = 10


@dataclasses.dataclass
class Trace:
    """``device``: (name, start_us, end_us) of every device operation;
    ``kernels``: the same for kernels alone; ``spans``: (name, start_us,
    end_us) of the benchmark's host spans, sorted; ``window``: (start_us,
    end_us) of the traced window."""
    device: list
    kernels: list
    spans: list
    window: tuple

    def _clipped(self, events):
        w0, w1 = self.window
        for name, s, e in events:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                yield name, s, e

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device's operations within the window, as
        sorted disjoint (start_us, end_us)."""
        merged = []
        for _, s, e in sorted(self._clipped(self.device),
                              key=lambda ev: ev[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(iv) for iv in merged]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device."""
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_s(self, match=None) -> float:
        """Summed seconds of the device's operations in the window (of
        kernels whose name contains ``match``, if given)."""
        events = self.device if match is None else [
            ev for ev in self.kernels if match in ev[0]]
        return sum(e - s for _, s, e in self._clipped(events)) * 1e-6

    def _idle_by_host(self) -> dict:
        """Seconds of the window with nothing on the device, split by the
        benchmark span the host was in meanwhile (``loop`` outside every
        span; the spans do not overlap)."""
        spans, starts = self.spans, [sp[1] for sp in self.spans]
        idle, prev = {}, self.window[0]
        for s, e in self.busy_intervals() + [(self.window[1],) * 2]:
            if s > prev:  # the gap [prev, s)
                covered = 0.0
                i = max(bisect.bisect_right(starts, prev) - 1, 0)
                while i < len(spans) and spans[i][1] < s:
                    name, s0, e0 = spans[i]
                    overlap = min(e0, s) - max(s0, prev)
                    if overlap > 0:
                        idle[name] = idle.get(name, 0.0) + overlap * 1e-6
                        covered += overlap
                    i += 1
                idle["loop"] = idle.get("loop", 0.0) + \
                    (s - prev - covered) * 1e-6
            prev = max(prev, e)
        return idle

    def breakdown(self) -> dict:
        """The device operations that took most time, and the device's
        idle time in the window by the host span it passed in."""
        ops = {}
        for name, s, e in self._clipped(self.device):
            key = name[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self._idle_by_host().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in top_ops],
                "idle_gaps": [[k, v] for k, v in gaps[:TOP]]}


def from_chrome(doc: dict) -> Trace:
    """A ``Trace`` from a Chrome trace as ``torch.profiler`` exports it."""
    device, kernels, spans, window = [], [], [], None
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if cat in DEVICE_CATEGORIES:
            device.append((name, s, e))
            if cat == "kernel":
                kernels.append((name, s, e))
        elif cat == "user_annotation":
            if name == WINDOW:
                window = (s, e)
            else:
                spans.append((name, s, e))
    if window is None:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    spans.sort(key=lambda sp: (sp[1], sp[2], sp[0]))
    return Trace(device=device, kernels=kernels, spans=spans, window=window)


def span(name: str, on: bool):
    """A host span in the trace when ``on``; else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(device):
    """Profile the block; afterwards ``got["trace"]`` holds its ``Trace``.
    The block opens the ``WINDOW`` span itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        prof = profile(activities=acts)
        with prof:
            yield got
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            got["trace"] = from_chrome(json.load(f))
