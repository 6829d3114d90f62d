"""Lookup by name: a cell of ``BENCHMARK.json`` and the files it names.

``repo`` is the directory that holds ``BENCHMARK.json`` and ``benchmark/``.
Every piece is found by the name that ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the deployment;
- ``benchmark/traffic/<traffic>.json``: the traffic mix, data;
- ``benchmark/entries/<entry>.py``: the loop that drives the program, the
  traffic mix's ``entry``;
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric;
- ``benchmark/references/<family>.py``: the plain reference of a
  configuration's ``family``;
- ``benchmark/limits/<cell>.json``: the limits that decide ``correct``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["REPO", "Cell", "load"]

REPO = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    repo: Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list   # the per-layer metrics this cell reports

    @property
    def name(self) -> str:
        return self.workload["name"]

    def entry(self):
        """The ``run(cell, seed, seconds, device, traced, control,
        t_start)`` function of the traffic mix's entry."""
        name = self.traffic["entry"]
        mod = _module(self.repo / "benchmark" / "entries" / f"{name}.py",
                      f"benchmark_entry_{name}")
        return mod.run

    def reader(self, metric: str):
        """The ``read(run)`` function of a per-layer metric."""
        mod = _module(self.repo / "benchmark" / "metrics" / f"{metric}.py",
                      f"benchmark_metric_{metric.replace('.', '_')}")
        return mod.read

    def reference(self, taps):
        """The plain reference of the configuration's family, for
        ``taps`` (a float64 tensor)."""
        family = self.config["family"]
        mod = _module(self.repo / "benchmark" / "references"
                      / f"{family}.py", f"benchmark_reference_{family}")
        return mod.make(self.config, taps)


def _reports(metric: dict, name: str, e2e_names: set | None) -> bool:
    """Whether cell ``name`` reports ``metric``: the cells it lists, else
    every cell (an end-to-end metric, ``e2e_names`` None) or every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load(name: str, repo: Path = REPO) -> Cell:
    """The cell ``name`` of ``repo``'s ``BENCHMARK.json``."""
    repo = Path(repo)
    bench = _json(repo / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(by_name)}")
    w = by_name[name]
    base = repo / "benchmark"
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(repo=repo, workload=w,
                config=_json(base / "configs" / f"{w['config']}.json"),
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=_json(base / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)
