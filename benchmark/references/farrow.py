"""Plain float64 reference of the Farrow resampler.

Multirate.jl's ``FIRFarrow`` (``src/Filters.jl``): the taps cut into a
bank of nphi phases of T taps, each tap's row fitted over the phases
1..nphi by a polynomial of order P (least squares), and each output's taps
the polynomials evaluated at its fractional phase. The phase walks by
nphi / rate an output. As the port states it, the walk is exact: the step
is nphi / rate rounded to 32 fractional bits, and output m (from 0) of a
fresh filter has the newest input i = 1 + (m * step) // (nphi << 32)
(1-based) and the phase psi = 1 + ((m * step) mod (nphi << 32)) / 2^32.
So

    y[m] = sum_t x[i - T + t] * tap_t(psi),   tap_t(psi) = sum_k C[k, t] psi^k,

where row t of the bank is the taps h[(T-1-t)*nphi + p] over the phases p
(the time-flipped rows of Multirate.jl's ``taps2pfb``) and x is zero before
the stream's first sample. After n inputs the filter has produced every
output whose newest input has arrived.

Plain PyTorch, float64 on the CPU. Imports nothing of the port.
"""

from __future__ import annotations

import torch

__all__ = ["make", "FRAC_BITS"]

FRAC_BITS = 32


class _Farrow:
    def __init__(self, config: dict, taps: torch.Tensor):
        self.nphi = int(config["nphi"])
        self.P = int(config["polyorder"])
        rate = 1.0 / float(config["rate_inverse"])
        self.step = round(self.nphi / rate * (1 << FRAC_BITS))
        self.D = self.nphi << FRAC_BITS
        h = taps.to(torch.float64)
        self.T = -(-h.numel() // self.nphi)
        padded = torch.zeros(self.T * self.nphi, dtype=torch.float64)
        padded[:h.numel()] = h
        bank = padded.reshape(self.T, self.nphi).flip(0)  # (T, nphi)
        phases = torch.arange(1, self.nphi + 1, dtype=torch.float64)
        A = phases[:, None] ** torch.arange(self.P + 1,
                                            dtype=torch.float64)[None]
        self.C = torch.linalg.lstsq(A, bank.T).solution  # (P + 1, T)

    def count(self, n_in: int) -> int:
        """Outputs produced after the first ``n_in`` inputs."""
        return -(-int(n_in) * self.D // self.step) if n_in > 0 else 0

    def _walk(self, m0: int, m1: int):
        q0, r0 = divmod(m0 * self.step, self.D)  # exact in Python ints
        acc = r0 + torch.arange(m1 - m0, dtype=torch.int64) * self.step
        newest = 1 + q0 + torch.div(acc, self.D, rounding_mode="floor")
        rem = acc % self.D
        psi = 1.0 + rem.to(torch.float64) / float(1 << FRAC_BITS)
        return newest, psi

    def span(self, m0: int, m1: int) -> tuple[int, int]:
        """The inputs [a, b) (0-based) that outputs [m0, m1) read."""
        first = 1 + m0 * self.step // self.D
        last = 1 + (m1 - 1) * self.step // self.D
        return first - self.T, last

    def outputs(self, x: torch.Tensor, a: int, m0: int, m1: int):
        """Outputs [m0, m1) from ``x``, the inputs [a, a + len(x)) in
        float64."""
        newest, psi = self._walk(m0, m1)
        powers = psi[:, None] ** torch.arange(self.P + 1,
                                              dtype=torch.float64)[None]
        taps = powers @ self.C  # (n, T)
        idx = (newest - self.T - a)[:, None] + torch.arange(self.T)[None]
        return (x[idx] * taps).sum(dim=1)


def make(config: dict, taps: torch.Tensor) -> _Farrow:
    return _Farrow(config, taps)
