"""The statistics of the benchmark: a percentile over every sample, and the
run-to-run spread that the bounds of ``BENCHMARK.json`` are set from.

    python3 -m benchmark.stats RESULTS...

reads result lines (the JSON line a run prints last, one a line, other
lines ignored) and prints, for each metric, the median, the spread and the
runs' values.
"""

from __future__ import annotations

import json
import math
import statistics
import sys

__all__ = ["percentile", "spread"]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) of all ``values`` by nearest
    rank: the smallest value that at least q% of the values do not
    exceed. No interpolation and no smoothing: a tail is the tail of every
    sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    return float(xs[max(math.ceil(q / 100.0 * len(xs)), 1) - 1])


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``, its default
    exclusive method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def main(paths) -> None:
    runs = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                for name, m in rec.get("metrics", {}).items():
                    runs.setdefault(name, []).append(m["value"])
    for name, vals in sorted(runs.items()):
        s = spread(vals) if len(vals) >= 2 else float("nan")
        print(f"{name}: n={len(vals)} median={statistics.median(vals)!r} "
              f"spread={s:.4%} values={vals}")


if __name__ == "__main__":
    main(sys.argv[1:])
