"""The work of one call, counted from the problem's shapes, and the card's
published peaks.

A kernel's roofline share divides the least time the card could take for a
call by the time the call's kernels took. The least time is the larger of
the bytes over the memory bandwidth and the operations (two per
multiply-add) over the arithmetic peak of their type. Bytes count every
input read once (the signal, the carried history, the taps) and every
output written once, whatever a kernel reads again, so the count is the
same whatever implements the call (as ``chip_smoke._bound`` counts it).

- rational L//M (a configuration with a ``ratio``) with taps of
  T = ceil(K / L) a phase: T multiply-adds an output of each channel; the
  bank is the K taps padded to T * L;
- Farrow of order P over T taps a phase and nphi phases: each output's T
  taps formed once by Horner (P multiply-adds a tap) and shared by the
  channels, then T multiply-adds a channel, n_out * T * (P + C); the table
  is (P + 1) * T * nphi words; an arbitrary rate (no ``polyorder``) is the
  same with P = 1 (the bank and its derivative).
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "taps_per_phase", "call_work",
           "least_seconds"]

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense float32 (CUDA
# cores) and float64 rates, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


def taps_per_phase(config: dict) -> int:
    k = int(config["design"]["numtaps"])
    if "ratio" in config:
        return -(-k // int(config["ratio"][0]))
    return -(-k // int(config["nphi"]))


def call_work(config: dict, channels: int, n_in: int, n_out: int,
              in_dtype: str = "float32") -> tuple[int, int]:
    """(bytes, multiply-adds) of one call that reads ``n_in`` samples of
    ``in_dtype`` a channel and writes ``n_out`` outputs a channel, of the
    configuration's type."""
    t = taps_per_phase(config)
    taps_size = ITEMSIZE[config["dtype"]]
    history = channels * (t - 1) * ITEMSIZE[in_dtype]
    signal = channels * n_in * ITEMSIZE[in_dtype]
    out = channels * n_out * taps_size
    if "ratio" in config:
        bank = t * int(config["ratio"][0]) * taps_size
        return signal + history + bank + out, channels * n_out * t
    # the arbitrary rate's derivative bank is a Farrow table of order 1
    p = int(config.get("polyorder") or 1)
    table = (p + 1) * t * int(config["nphi"]) * taps_size
    return (signal + history + table + out,
            n_out * t * (p + channels))


def least_seconds(config: dict, nbytes: int, mult_adds: int) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the type's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S,
               2.0 * mult_adds / PEAK_FLOPS[config["dtype"]])
