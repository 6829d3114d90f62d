"""Plain float64 reference of the rational resampler L//M.

Multirate.jl's own oracle (``src/NaiveResamplers.jl``): the input
zero-stuffed by L, filtered by the causal FIR h, every M-th sample kept
from the first. Output m of the stream is

    y[m] = sum_j h[m*M - j*L] * x[j],   0 <= m*M - j*L < K,

with x[j] = 0 before the stream's first sample (a fresh filter has a zero
history and phase 1). After n inputs a streaming filter has produced every
output whose last input has arrived: ceil(n * L / M) of them.

Plain PyTorch, float64 on the CPU. Imports nothing of the port.
"""

from __future__ import annotations

import torch

__all__ = ["make"]


class _Rational:
    def __init__(self, config: dict, taps: torch.Tensor):
        self.L, self.M = (int(v) for v in config["ratio"])
        self.K = int(taps.numel())
        self.T = -(-self.K // self.L)
        self.h = torch.zeros(self.T * self.L, dtype=torch.float64)
        self.h[:self.K] = taps.to(torch.float64)

    def count(self, n_in: int) -> int:
        """Outputs produced after the first ``n_in`` inputs."""
        return -(-int(n_in) * self.L // self.M)

    def span(self, m0: int, m1: int) -> tuple[int, int]:
        """The inputs [a, b) that outputs [m0, m1) read (a may be < 0)."""
        n0, n1 = m0 * self.M, (m1 - 1) * self.M
        return n0 // self.L - self.T + 1, n1 // self.L + 1

    def outputs(self, x: torch.Tensor, a: int, m0: int, m1: int):
        """Outputs [m0, m1) from ``x``, the inputs [a, a + len(x)) in
        float64."""
        n = torch.arange(m0, m1, dtype=torch.int64) * self.M
        j = (n // self.L)[:, None] - torch.arange(self.T)[None, :]
        k = n[:, None] - j * self.L  # in [0, T*L): padded taps are zero
        return (self.h[k] * x[j - a]).sum(dim=1)


def make(config: dict, taps: torch.Tensor) -> _Rational:
    return _Rational(config, taps)
