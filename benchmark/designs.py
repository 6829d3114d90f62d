"""The taps of a configuration, designed by the benchmark itself.

A numpy copy of the windowed-sinc lowpass with a Kaiser window (Multirate.jl
``src/FIRDesign.jl``: ``firdes(numtaps, cutoff, kaiser; samplerate, beta)``),
so that a change to the port's designer cannot move the yardstick. The
configuration's ``design`` holds every number: ``numtaps``, ``cutoff`` and
``samplerate`` (the cutoff is in the samplerate's units), ``beta`` and
``scale`` (the gain the reference examples multiply the taps by).
"""

from __future__ import annotations

import numpy as np

__all__ = ["taps"]


def _kaiser(n: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window: I0(beta sqrt(1 - (2k/(n-1) - 1)^2)) / I0(beta)."""
    if n == 1:
        return np.ones(1)
    t = 2.0 * np.arange(n, dtype=np.float64) / (n - 1) - 1.0
    return np.i0(beta * np.sqrt(np.maximum(1.0 - t * t, 0.0))) / np.i0(beta)


def taps(config: dict) -> np.ndarray:
    """The configuration's taps in float64 (the served type is
    ``config["dtype"]``; the caller casts)."""
    d = config["design"]
    if d["window"] != "kaiser":
        raise ValueError(f"unknown window {d['window']!r}")
    n = int(d["numtaps"])
    f = float(d["cutoff"]) / float(d.get("samplerate", 1.0))
    k = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    return 2.0 * f * np.sinc(2.0 * f * k) * _kaiser(n, float(d["beta"])) \
        * float(d.get("scale", 1.0))
