"""Every piece of a cell is found by its name: a new configuration,
traffic mix, per-layer metric and limits, added as files in a copy of the
benchmark, make a new cell that runs without an edit to any file that was
there; so does a new entry, the loop a traffic mix names."""

import json
import shutil

from benchmark import cell, run
from benchmark.tests.conftest import SEED, SMALL


def test_each_cell_loads_by_name(cell_name):
    c = cell.load(cell_name)
    w = c.workload
    assert c.config["name"] == w["config"]
    assert callable(c.entry())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(c.reader(m["name"]))
    assert set(c.limits) == {"max_err", "count_gap"}


def _copy(tmp_path):
    shutil.copy(cell.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(cell.REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*")
              if p.is_file() and p.name != "BENCHMARK.json"}
    return before


def test_a_new_cell_is_data(tmp_path):
    before = _copy(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "dat_to_cd.json").read_text())
    cfg.update(name="decim_4", ratio=[1, 4], taps_per_phase=37,
               design=dict(cfg["design"], numtaps=147, cutoff=0.1, scale=1))
    (b / "configs" / "decim_4.json").write_text(json.dumps(cfg))
    (b / "traffic" / "tiny_block.json").write_text(json.dumps(
        {"entry": "block", "channels": 2, "samples": 4096, "inputs": 3}))
    (b / "metrics" / "calls_per_s.block.py").write_text(
        "def read(run):\n"
        "    return run.counters['calls'] / run.counters['window_s']\n")
    (b / "limits" / "decim_4.tiny_block.json").write_text(json.dumps(
        {"max_err": {"limit": 1e-4}, "count_gap": {"limit": 0}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "decim_4", "source": "test",
                             "file": "benchmark/configs/decim_4.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "decim_4.tiny_block",
                               "config": "decim_4", "traffic": "tiny_block",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("decim_4.tiny_block")
    bench["per_layer"].append({"name": "calls_per_s.block", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "Device", "moves": "block_msps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = cell.load("decim_4.tiny_block", tmp_path)
    assert c.config["ratio"] == [1, 4]
    # no workloads key: every cell that reports block_msps reports it
    assert "calls_per_s.block" in {m["name"] for m in c.per_layer}
    assert "calls_per_s.block" in {
        m["name"] for m in cell.load("dat_to_cd.madi_block",
                                     tmp_path).per_layer}
    assert "calls_per_s.block" not in {
        m["name"] for m in cell.load("dat_to_cd.pcm_stream",
                                     tmp_path).per_layer}
    result = run.run_cell("decim_4.tiny_block", SEED, 0.2, True,
                          device="cpu", repo=tmp_path)
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_per_s.block"]["value"] > 0
    result = run.run_cell("decim_4.tiny_block", SEED, 0.2, False,
                          device="cpu", repo=tmp_path)
    assert set(result["metrics"]) == {"block_msps", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed


def test_small_runs_of_every_cell_are_correct(cell_name):
    for traced in (False, True):
        result = run.run_cell(cell_name, SEED, 0.3, traced, device="cpu",
                              traffic=SMALL[cell_name])
        assert result["correct"], result["checks"]
        assert result["attempted"] > 0 and result["failed"] == 0
        assert list(result)[-1] == "checks"
        assert isinstance(result["device"]["build_s"], float)
    assert set(result["checks"]) == {"max_err", "count_gap"}


NEW_ENTRY = """
from benchmark import generator


def run(cell, seed, seconds, device, traced, control, t_start):
    # a loop of its own: the block loop on inputs in reverse order
    import dataclasses
    import torch
    from multirate_tpu_torch import FIRFilter

    orig = FIRFilter.filt
    FIRFilter.filt = lambda self, x: orig(self, torch.flip(x, [-1]))
    try:
        block = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                       entry="block"))
        out = block.entry()(block, seed, seconds, device, traced, control,
                            t_start)
    finally:
        FIRFilter.filt = orig
    out.counters["reversed"] = 1
    return out
"""


def test_a_new_entry_is_a_file(tmp_path):
    """A mix that names a new entry runs that entry's loop, found by its
    name; the loop here reverses each input, which the comparison (against
    the inputs as drawn) sees."""
    before = _copy(tmp_path)
    b = tmp_path / "benchmark"
    (b / "entries" / "reversed_block.py").write_text(NEW_ENTRY)
    (b / "traffic" / "reversed_block.json").write_text(json.dumps(
        {"entry": "reversed_block", "channels": 2, "samples": 4096,
         "inputs": 2}))
    (b / "metrics" / "reversed.block.py").write_text(
        "def read(run):\n"
        "    return run.counters.get('reversed')\n")
    (b / "limits" / "dat_to_cd.reversed_block.json").write_text(
        (b / "limits" / "dat_to_cd.madi_block.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dat_to_cd.reversed_block",
                               "config": "dat_to_cd",
                               "traffic": "reversed_block", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("dat_to_cd.reversed_block")
    bench["per_layer"].append({"name": "reversed.block", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "Device", "moves": "block_msps",
                               "workloads": ["dat_to_cd.reversed_block"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = cell.load("dat_to_cd.reversed_block", tmp_path)
    assert c.entry().__module__ == "benchmark_entry_reversed_block"
    result = run.run_cell(c.name, SEED, 0.2, True, device="cpu",
                          repo=tmp_path)
    assert result["metrics"]["reversed.block"]["value"] == 1
    assert result["attempted"] > 0
    assert result["correct"] is False  # the reversed inputs were filtered
    assert result["checks"]["count_gap"]["value"] == 0
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed


def test_the_configurations_host_threads_hold_while_the_entry_runs(
        monkeypatch):
    """The program runs on the configuration's ``host_threads``; the
    process's own count comes back for the reference."""
    import torch
    from multirate_tpu_torch import FIRFilter

    seen, orig = set(), FIRFilter.filt

    def filt(self, x):
        seen.add(torch.get_num_threads())
        return orig(self, x)

    monkeypatch.setattr(FIRFilter, "filt", filt)
    before = torch.get_num_threads()
    name = "dat_to_cd.madi_block"
    assert cell.load(name).config["host_threads"] == 1
    result = run.run_cell(name, SEED, 0.2, False, device="cpu",
                          traffic=SMALL[name])
    assert result["correct"], result["checks"]
    assert seen == {1}
    assert torch.get_num_threads() == before
