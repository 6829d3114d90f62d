"""End-to-end resampler models: design + kernel.

Counterpart of ``multirate_tpu/models/resampler.py`` (reference:
examples/DAT to CD.jl, the 147//160 headline pipeline;
examples/FIRArbitrary.jl; examples/Interactive Farrow Example.jl).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from .. import design as _design
from ..ops.api import FIRFilter, _as_signal
from ..ops.params import default_device
from ..parallel.sharded import make_mesh, sharded_resample

__all__ = ["Resampler", "DATToCD", "MultiChannelResampler"]


def _design_for_ratio(L: int, M: int, attenuation: float,
                      taps_per_phase: int | None) -> np.ndarray:
    """Kaiser anti-alias/anti-image filter for an L//M resampler.

    Cutoff at min(1/(2L), 1/(2M)) of the upsampled rate; taps scaled by L to
    preserve unity passband gain after polyphase decomposition (the
    reference's convention, examples/DAT to CD.jl:10-12, runtests.jl:338-340).
    """
    cutoff = 0.5 / max(L, M)
    if taps_per_phase is None:
        numtaps, beta = _design.kaiserlength(cutoff / 8, attenuation)
    else:
        numtaps = taps_per_phase * L
        beta = _design.kaiserlength(cutoff / 8, attenuation)[1]
    numtaps = -(-numtaps // max(L, 1)) * max(L, 1)
    h = _design.firdes(numtaps, cutoff, _design.kaiser, beta=beta)
    return h * L


def _design_for_rate(nphi: int, attenuation: float,
                     transition: float = 0.05,
                     cutoff: float = 0.45) -> np.ndarray:
    """Prototype for the arbitrary/Farrow resamplers: design at
    samplerate=nphi, scale by nphi (runtests.jl:336-341)."""
    numtaps, beta = _design.kaiserlength(transition, attenuation,
                                         samplerate=nphi)
    numtaps = -(-numtaps // nphi) * nphi
    h = _design.firdes(numtaps, cutoff, _design.kaiser, samplerate=nphi,
                       beta=beta)
    return h * nphi


class Resampler:
    """A self-designing streaming resampler.

    ``Resampler(Fraction(147, 160))`` designs an appropriate Kaiser filter
    and resamples through the rational-family kernel for the ratio; a float
    rate selects the arbitrary (or, with ``polyorder``, Farrow) kernel.
    ``taps`` overrides the design. The taps are cast to ``dtype`` (float32
    by default, so the float32 kernels run, not the float64 ones). The
    stream runs on ``device``, else on its first chunk's device (a numpy
    chunk's: the card). Streaming: call the object with chunks; state
    carries over.
    """

    def __init__(self, ratio_or_rate, *, attenuation: float = 60.0,
                 nphi: int = 32, polyorder: int | None = None, taps=None,
                 taps_per_phase: int | None = None, dtype=np.float32,
                 device=None):
        if isinstance(ratio_or_rate, float) and not float(
                ratio_or_rate).is_integer():
            h = taps if taps is not None else _design_for_rate(
                nphi, attenuation)
            self.ratio_or_rate = float(ratio_or_rate)
        else:
            r = Fraction(ratio_or_rate) if not isinstance(ratio_or_rate,
                                                          tuple) \
                else Fraction(*ratio_or_rate)
            h = taps if taps is not None else _design_for_ratio(
                r.numerator, r.denominator, attenuation, taps_per_phase)
            self.ratio_or_rate = r
        self.taps = np.asarray(h, dtype=dtype)
        self._filter = FIRFilter(self.taps, self.ratio_or_rate, nphi=nphi,
                                 polyorder=polyorder, device=device)

    @property
    def kernel(self):
        return self._filter.params

    def __call__(self, x):
        return self._filter.filt(x)

    def reset(self):
        self._filter.reset()
        return self


class DATToCD(Resampler):
    """48 kHz -> 44.1 kHz (147//160) converter, the reference's headline
    example (examples/DAT to CD.jl:6-16: 24*147 taps, beta 7.8562,
    cutoff 0.5/147, scaled by 147)."""

    def __init__(self, dtype=np.float32, device=None):
        h = _design.firdes(24 * 147, 0.5 / 147, _design.kaiser,
                           beta=7.8562) * 147
        super().__init__(Fraction(147, 160), taps=h, dtype=dtype,
                         device=device)


class MultiChannelResampler:
    """Many independent channels resampled on a (channel, time) mesh of
    ranks, the BASELINE.json 64-channel sharded configuration.

    Stateless per call: ``__call__(x)`` with x of shape (channels, time),
    the same on every rank, returns the densely resampled (channels,
    out_time) tensor on every rank, computed with channel data
    parallelism and time-block sequence parallelism (a halo exchange over
    the mesh's ``"t"`` dim). The kernel and the signal live on ``device``,
    by default the card (the rank's own under ``nccl``).
    """

    def __init__(self, ratio_or_rate, *, n_ch_shards: int = 1,
                 n_time_shards: int | None = None, attenuation: float = 60.0,
                 nphi: int = 32, polyorder: int | None = None, taps=None,
                 dtype=np.float32, device=None):
        device = default_device() if device is None else device
        base = Resampler(ratio_or_rate, attenuation=attenuation, nphi=nphi,
                         polyorder=polyorder, taps=taps, dtype=dtype,
                         device=device)
        self.taps = base.taps
        self.params = base.kernel
        self.mesh = make_mesh(n_ch_shards, n_time_shards)

    def __call__(self, x):
        return sharded_resample(self.params,
                                _as_signal(x, self.params.device),
                                self.mesh)
