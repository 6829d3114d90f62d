"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

From the root of a checkout. Needs the card: without CUDA, or with fewer
cards than the cell asks for, it prints no result and exits with 2.
``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` traces
a window of at most ``generator.TRACE_WINDOW_S`` seconds with
``torch.profiler`` and reports the cell's per-layer metrics, the device's
busy time and a breakdown. ``--control 1`` runs the control of the
comparison (the signal read in bfloat16), which has to come out not
correct; the benchmark's own runs never pass it.

The last line of standard output is the result, a JSON object; the last
lines of standard error are the numbers compared, each with its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import cell as _cell  # noqa: E402
from . import check  # noqa: E402

__all__ = ["run_cell", "main"]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _card(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu"}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        info["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return info


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the cell, the program's counters,
    and the traced window (None where nothing was traced)."""
    cell: object
    counters: dict
    trace: object


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", control: bool = False, repo: Path = _cell.REPO,
             t_start: float | None = None, traffic: dict | None = None):
    """The result line (a dict) of one run of cell ``name`` on
    ``device``. ``traffic`` replaces the cell's traffic parameters (the
    tests' small sizes on the CPU). The configuration's ``host_threads``,
    where it has one, is PyTorch's CPU thread count while the entry runs;
    the reference runs on the count the process started with."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    c = _cell.load(name, repo)
    if traffic is not None:
        c.traffic = traffic
    threads = torch.get_num_threads()
    torch.set_num_threads(int(c.config.get("host_threads", threads)))
    try:
        out = c.entry()(c, seed, seconds, device, traced, control, t_start)
    finally:
        torch.set_num_threads(threads)

    metrics, device_info = {}, _card(device)
    device_info.update(count=int(c.workload["chips"]),
                       memory_peak_bytes=out.memory_peak_bytes,
                       build_s=out.build_s)
    result = {"correct": False, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": device_info}
    if traced:
        run = Run(cell=c, counters=out.counters, trace=out.trace)
        for m in c.per_layer:
            value = c.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if out.trace is not None:
            device_info.update(busy_s=out.trace.busy_s(),
                               window_s=out.trace.window_s)
            if out.trace.device:
                result["breakdown"] = out.trace.breakdown()
    else:
        values = dict(out.metrics, setup_s=out.setup_s)
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    log(f"{name} seed {seed}: setup_s {out.setup_s!r} (build_s "
        f"{out.build_s!r}), warm call "
        f"{out.counters['warm_call_s']!r} s, window "
        f"{out.counters['window_s']!r} s, attempted {out.attempted}, "
        f"failed {out.failed}, {device_info}")
    for k, v in metrics.items():
        log(f"  {k}: {v['value']!r} {v['unit']}")

    numbers = check.compare(out.reference, out.readings, out.read_input)
    numbers["count_gap"] = out.count_gap
    log(f"  compared {numbers.pop('outputs')} outputs with the reference")
    result["correct"], result["checks"] = check.judge(numbers, c.limits)
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        import torch

        import multirate_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        log(f"cannot import the program: {e}")
        return 2
    t_import = time.perf_counter()
    w = _cell.load(args.workload).workload
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        log(f"{args.workload} needs {w['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    torch.zeros(1, device="cuda")  # the CUDA context, inside set-up
    log(f"set-up: imports {t_import - T_START:.3f} s, CUDA context "
        f"{time.perf_counter() - t_import:.3f} s")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bool(args.control),
                      t_start=T_START)
    checks = result.pop("checks")
    result["checks"] = checks  # the numbers compared come last
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
