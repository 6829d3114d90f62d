"""Window functions for windowed-sinc FIR design.

The reference re-exports DSP.Windows' hanning/hamming/kaiser/blackman
(Multirate.jl src/Multirate.jl:9-13); its own src/Window.jl is dead code.
These are the standard symmetric window definitions (identical to DSP.jl's and
numpy's for the sizes used in FIR design). Everything here is host-side numpy:
filter design is a one-time setup cost, not a device hot path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kaiser", "hanning", "hamming", "blackman", "rect"]


def _sym_arg(n: int) -> np.ndarray:
    """Normalized symmetric abscissa k/(n-1) for k = 0..n-1 (n==1 -> [0])."""
    if n == 1:
        return np.zeros(1)
    return np.arange(n, dtype=np.float64) / (n - 1)


def rect(n: int) -> np.ndarray:
    """Rectangular (boxcar) window of length ``n``."""
    return np.ones(n, dtype=np.float64)


def hanning(n: int) -> np.ndarray:
    """Symmetric Hann window: 0.5*(1 - cos(2*pi*k/(n-1)))."""
    t = _sym_arg(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * t))


def hamming(n: int) -> np.ndarray:
    """Symmetric Hamming window: 0.54 - 0.46*cos(2*pi*k/(n-1))."""
    t = _sym_arg(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * t)


def blackman(n: int) -> np.ndarray:
    """Symmetric Blackman window (a0,a1,a2 = 0.42, 0.5, 0.08)."""
    t = _sym_arg(n)
    return 0.42 - 0.5 * np.cos(2.0 * np.pi * t) + 0.08 * np.cos(4.0 * np.pi * t)


def kaiser(n: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window with shape parameter ``beta``.

    w[k] = I0(beta*sqrt(1 - (2k/(n-1) - 1)^2)) / I0(beta)
    """
    t = 2.0 * _sym_arg(n) - 1.0
    return np.i0(beta * np.sqrt(np.maximum(1.0 - t * t, 0.0))) / np.i0(beta)
