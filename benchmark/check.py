"""How ``correct`` is decided: outputs of the timed path, sampled from the
seed while the window runs, against the plain float64 reference once it has
closed.

- Block cells: calls 0 and 1 (the second shows whether the state was
  carried), then calls a seeded gap apart (mean ``MEAN_GAP``), and in each
  two slices of ``SLICE`` outputs, one in the first half of the channels
  and the call's outputs, one in the second half, copied on the device as
  the call returns (``Slices``).
- Stream cells: the first two pulls that return output, then pulls a
  seeded gap apart (mean ``PULL_GAP``), each kept whole (``Pulls``).

The gaps are set so that a window of the longest ``run_seconds`` (51 s)
is sampled to its end before the buffers (``MAX_SLICES``, ``MAX_PULLS``)
fill: some 4,200 calls a second and 2,000 pulls a second at most.

The numbers compared (``compare``): ``max_err``, the largest gap between a
sampled output and the reference's, over the root mean square of the
reference's sampled outputs; and ``count_gap`` (counted by the generator),
how far the outputs the program produced stray from the count the
reference gives for the inputs it consumed, which is exact. Their limits
are in ``limits/<cell>.json``, with the readings they were set from.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SLICE", "MEAN_GAP", "PULL_GAP", "Slices", "Pulls", "compare",
           "judge", "rng"]

SLICE = 1024
MEAN_GAP = 64
MAX_SLICES = 8192
PULL_GAP = 200
MAX_PULLS = 640


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seeded generator of one of the run's independent draws."""
    return np.random.default_rng([seed % 2 ** 64, stream])


class Slices:
    """Slices of block outputs, taken on the device while the window runs.

    ``next`` is the call to sample next; ``take(k, y, base)`` copies two
    slices of call ``k``'s output ``y`` ((C, n) or (n,), of the type and
    on the device of ``like``), whose first output is the stream's output
    ``base``."""

    def __init__(self, seed: int, channels: int, n_out: int, like):
        import torch

        self._rng = rng(seed, 1)
        self.channels = channels
        self.width = min(SLICE, n_out // 2)
        self.n_out = n_out
        self.buf = torch.empty((MAX_SLICES, self.width), dtype=like.dtype,
                               device=like.device)
        self.meta = []  # (channel, first output in the stream)
        self.next = 0

    def take(self, k: int, y, base: int) -> None:
        r, half_c, half_n = self._rng, self.channels // 2, self.n_out // 2
        for lo_c, hi_c, lo_n, hi_n in ((0, max(half_c, 1), 0, half_n),
                                       (half_c, self.channels, half_n,
                                        self.n_out)):
            if len(self.meta) == MAX_SLICES:
                return
            c = int(r.integers(lo_c, hi_c))
            o = int(r.integers(lo_n, hi_n - self.width + 1))
            row = y if y.dim() == 1 else y[c]
            self.buf[len(self.meta)].copy_(row[o:o + self.width])
            self.meta.append((c, base + o))
        self.next = k + (1 if k == 0 else int(r.integers(1, 2 * MEAN_GAP)))

    def readings(self) -> list:
        """(channel, first output, outputs as a CPU tensor) of each
        slice."""
        host = self.buf[:len(self.meta)].cpu()
        return [(c, m0, host[i]) for i, (c, m0) in enumerate(self.meta)]


class Pulls:
    """Whole pulls of a stream, kept while the window runs."""

    def __init__(self, seed: int):
        self._rng = rng(seed, 3)
        self.kept = []  # (channel 0, first output, outputs)
        self.seen = 0   # pulls that returned output
        self.next = 0

    def offer(self, base: int, out: np.ndarray) -> None:
        if self.seen == self.next and len(self.kept) < MAX_PULLS:
            self.kept.append((0, base, out))
            self.next += 1 if self.seen == 0 else int(
                self._rng.integers(1, 2 * PULL_GAP))
        self.seen += 1

    def readings(self) -> list:
        import torch

        return [(c, m0, torch.from_numpy(out)) for c, m0, out in self.kept]


def compare(reference, readings, read_input) -> dict:
    """``max_err`` of ``readings`` ((channel, first output, outputs))
    against ``reference``; ``read_input(channel, a, b)`` gives the
    stream's inputs [a, b) in float64, zeros before its first sample."""
    worst, sq, n = 0.0, 0.0, 0
    for c, m0, y in readings:
        m1 = m0 + y.numel()
        a, b = reference.span(m0, m1)
        ref = reference.outputs(read_input(c, a, b), a, m0, m1)
        worst = max(worst, float((y.to(ref.dtype) - ref).abs().max()))
        sq += float((ref.abs() ** 2).sum())
        n += ref.numel()
    if n == 0:
        return {"max_err": float("nan"), "outputs": 0}
    return {"max_err": worst / (sq / n) ** 0.5, "outputs": n}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number of ``limits``
    at or under its limit (a missing or NaN number fails)."""
    checks, ok = {}, True
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and value <= lim["limit"]  # NaN compares False
    return ok, checks
