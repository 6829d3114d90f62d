"""Windowed-sinc FIR design: Kaiser sizing, ideal prototypes, firdes.

Behavioral reference: Multirate.jl src/FIRDesign.jl. All constants
(Kaiser tap-count formula :21, beta piecewise :24-29, the 4 sinc prototypes
:49-65 including the HIGHPASS force-even-M type-1 rule :56) are preserved.
Host-side numpy: tap design is setup cost, not a device hot path.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Sequence, Union

import numpy as np

from . import windows as _win

__all__ = [
    "firdes_remez",
    "FIRResponse", "LOWPASS", "BANDPASS", "HIGHPASS", "BANDSTOP",
    "kaiserlength", "firprototype", "firdes",
]


class FIRResponse(enum.Enum):
    """Filter response shapes (reference: FIRDesign.jl:7 FIRResponse enum)."""

    LOWPASS = 0
    BANDPASS = 1
    HIGHPASS = 2
    BANDSTOP = 3


LOWPASS = FIRResponse.LOWPASS
BANDPASS = FIRResponse.BANDPASS
HIGHPASS = FIRResponse.HIGHPASS
BANDSTOP = FIRResponse.BANDSTOP

_Cutoff = Union[float, Sequence[float]]


def kaiserlength(
    transition: float, attenuation: float = 60.0, *, samplerate: float = 1.0
) -> tuple[int, float]:
    """Estimate (numtaps, beta) for a Kaiser-windowed FIR.

    numtaps = ceil((attenuation - 7.95) / (2*pi*2.285*transition_norm)),
    beta piecewise in the stopband attenuation.
    Reference: FIRDesign.jl:18-32.
    """
    transition = transition / samplerate
    numtaps = math.ceil((attenuation - 7.95) / (2.0 * np.pi * 2.285 * transition))

    if attenuation > 50:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation >= 21:
        beta = 0.5842 * (attenuation - 21.0) ** 0.4 + 0.07886 * (attenuation - 21.0)
    else:
        beta = 0.0

    return numtaps, beta


def firprototype(
    numtaps: int, cutoff: _Cutoff, *, response: FIRResponse = LOWPASS
) -> np.ndarray:
    """Ideal (windowless) sinc prototype taps for the four response shapes.

    ``cutoff`` is normalized (cycles/sample); scalar for LOWPASS/HIGHPASS,
    a (low, high) pair for BANDPASS/BANDSTOP. For HIGHPASS, an odd
    ``numtaps-1`` is bumped to even so the filter is linear-phase type 1.
    Reference: FIRDesign.jl:49-65.
    """
    M = numtaps - 1
    if response == LOWPASS:
        F = float(cutoff)
        n = np.arange(M + 1, dtype=np.float64)
        return 2.0 * F * np.sinc(2.0 * F * (n - M / 2.0))
    if response == BANDPASS:
        F1, F2 = (float(f) for f in cutoff)
        n = np.arange(M + 1, dtype=np.float64)
        return 2.0 * (
            F1 * np.sinc(2.0 * F1 * (n - M / 2.0))
            - F2 * np.sinc(2.0 * F2 * (n - M / 2.0))
        )
    if response == HIGHPASS:
        F = float(cutoff)
        if M % 2 == 1:  # type-1 (even order) required for a highpass
            M += 1
        n = np.arange(M + 1, dtype=np.float64)
        return np.sinc(n - M / 2.0) - 2.0 * F * np.sinc(2.0 * F * (n - M / 2.0))
    if response == BANDSTOP:
        F1, F2 = (float(f) for f in cutoff)
        n = np.arange(M + 1, dtype=np.float64)
        return 2.0 * (
            F2 * np.sinc(2.0 * F2 * (n - M / 2.0))
            - F1 * np.sinc(2.0 * F1 * (n - M / 2.0))
        )
    raise ValueError(f"not a valid FIRResponse: {response!r}")


def firdes(
    numtaps_or_cutoff,
    cutoff_or_transition=None,
    window_or_attenuation=None,
    *,
    response: FIRResponse = LOWPASS,
    samplerate: float = 1.0,
    beta: float = 6.75,
) -> np.ndarray:
    """Design a windowed-sinc FIR filter.

    Two call shapes, mirroring the reference's two overloads:

    1. ``firdes(numtaps, cutoff, window, response=..., samplerate=..., beta=...)``
       — explicit tap count and window function; ``window`` is a callable
       ``window(n)`` or the Kaiser window ``multirate_tpu_torch.kaiser`` (which
       receives ``beta``).  Reference: FIRDesign.jl:76-88.
    2. ``firdes(cutoff, transitionwidth, attenuation=60, response=...,
       samplerate=...)`` — spec-driven: chains ``kaiserlength`` into shape 1
       with a Kaiser window.  Reference: FIRDesign.jl:90-95.

    Cutoffs are given in the units of ``samplerate``.
    """
    if isinstance(numtaps_or_cutoff, (int, np.integer)) and (
        window_or_attenuation is None or callable(window_or_attenuation)
    ):
        numtaps = int(numtaps_or_cutoff)
        cutoff = cutoff_or_transition
        window: Callable = window_or_attenuation or _win.kaiser
        cutoff_n = (
            np.asarray(cutoff, dtype=np.float64) / samplerate
            if np.ndim(cutoff) > 0
            else float(cutoff) / samplerate
        )
        prototype = firprototype(numtaps, cutoff_n, response=response)
        numtaps = len(prototype)  # may have grown by 1 for HIGHPASS
        if window is _win.kaiser:
            return prototype * _win.kaiser(numtaps, beta)
        return prototype * np.asarray(window(numtaps), dtype=np.float64)

    # Spec-driven overload.
    cutoff = numtaps_or_cutoff
    transitionwidth = float(cutoff_or_transition)
    attenuation = 60.0 if window_or_attenuation is None else float(window_or_attenuation)
    numtaps, beta_k = kaiserlength(transitionwidth, attenuation, samplerate=samplerate)
    return firdes(
        numtaps, cutoff, _win.kaiser,
        response=response, samplerate=samplerate, beta=beta_k,
    )


def firdes_remez(numtaps: int, f_pass, f_stop,
                 response_type: FIRResponse = FIRResponse.LOWPASS,
                 samplerate: float = 1.0, weight=None) -> np.ndarray:
    """Equiripple (Parks-McClellan) FIR design — a designer the reference
    lacks (FIRDesign.jl is windowed-sinc only). Wraps scipy.signal.remez
    with the band conventions of ``firdes``:

    - LOWPASS/HIGHPASS: scalar ``f_pass``/``f_stop`` edges (pass ripple
      weighted equally unless ``weight`` given).
    - BANDPASS/BANDSTOP: ``f_pass`` and ``f_stop`` are (lo, hi) pairs;
      for BANDPASS, f_stop brackets f_pass from outside, and vice versa.

    Frequencies are in the same units as ``samplerate`` (default:
    normalized to fs=1.0). Returns float64 taps of length ``numtaps``.
    """
    from scipy.signal import remez as _remez

    fs = float(samplerate)
    rt = FIRResponse(response_type)
    if rt == FIRResponse.LOWPASS:
        bands = [0.0, f_pass, f_stop, fs / 2]
        desired = [1.0, 0.0]
    elif rt == FIRResponse.HIGHPASS:
        bands = [0.0, f_stop, f_pass, fs / 2]
        desired = [0.0, 1.0]
    elif rt == FIRResponse.BANDPASS:
        (p_lo, p_hi), (s_lo, s_hi) = f_pass, f_stop
        bands = [0.0, s_lo, p_lo, p_hi, s_hi, fs / 2]
        desired = [0.0, 1.0, 0.0]
    elif rt == FIRResponse.BANDSTOP:
        (p_lo, p_hi), (s_lo, s_hi) = f_pass, f_stop
        bands = [0.0, p_lo, s_lo, s_hi, p_hi, fs / 2]
        desired = [1.0, 0.0, 1.0]
    else:  # pragma: no cover
        raise ValueError(f"unsupported response type {response_type}")
    if not all(bands[i] < bands[i + 1] for i in range(len(bands) - 1)):
        raise ValueError(f"band edges must be increasing, got {bands}")
    return _remez(numtaps, bands, desired, weight=weight, fs=fs)
