"""The port's benchmark harness (``multirate_tpu_torch.bench``) on the CPU,
against the repo's ``bench.py``: the same rows (names, order, taps, rates,
shapes, seeds and types), the same oracle RMS, the headline line's key
set, the oracle tripwire's exit after the headline, and no run without a
card unless the caller names the CPU.

Tolerances: designed taps 1e-7 of max|h| (both round the same float64
design to float32); kernel fields, signals and quantized values exactly;
the oracle RMS 1e-12 relative (the same float64 oracles on the same
output).
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multirate_tpu as mr
import multirate_tpu_torch as mt
from multirate_tpu.ops import quant as jquant
from multirate_tpu_torch import bench
from multirate_tpu_torch.parallel import scaling_bench

REPO = Path(__file__).resolve().parents[1]
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline",
                 "chunked_vs_whole_rms", "oracle_rel_rms", "roofline_pct",
                 "stream_copy_gbps", "pct_of_copy_ceiling"}
N_SMALL = 64 * 100
TOL_TAPS, TOL_RMS = 1e-7, 1e-12


def _root_bench():
    """The repo's bench.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_case(name, n):
    """bench.py's taps, ``make_kernel`` keywords, timed signal and oracle
    taps for row ``name`` at ``n`` samples (bench.py:153-160, 338-540),
    transcribed with the JAX package."""
    ratio = Fraction(147, 160)
    h = (mr.firdes(24 * 147, 0.5 / 147, mr.kaiser, beta=7.8562) * 147
         ).astype(np.float32)
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal(n).astype(np.float32)
    xi_np = rng.standard_normal(n).astype(np.float32)
    x64_np = rng.standard_normal((64, n // 64)).astype(np.float32)
    h147 = np.asarray(mr.firdes(147, 0.2, mr.kaiser, beta=7.0), np.float32)
    ha = (mr.firdes(320, 0.45, mr.kaiser, samplerate=32, beta=7.0) * 32
          ).astype(np.float32)
    r_ref = 1.0 / 2.123456789
    h64 = np.asarray(h, np.float64)
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16))
    hq = jquant.quantize_taps(h)[0]
    cases = {
        "rational_147_160": (h, {"ratio": ratio}, x_np, h),
        "rational_147_160_bf16": (
            hb, {"ratio": ratio},
            np.asarray(jnp.asarray(x_np, jnp.bfloat16)), h),
        "rational_147_160_int8": (
            hq, {"ratio": ratio},
            np.asarray(jquant.quantize_signal(x_np)[0]), h),
        "rational_147_160_c64": (
            h, {"ratio": ratio}, (x_np + 1j * xi_np).astype(np.complex64),
            h),
        "rational_147_160_f64": (h64, {"ratio": ratio},
                                 x_np.astype(np.float64), h64),
        "standard_147taps": (h147, {"ratio": Fraction(1, 1)}, x_np, h147),
        "decim_1_4": (h147, {"ratio": Fraction(1, 4)}, x_np, h147),
        "interp_4_1": (h147, {"ratio": Fraction(4, 1)}, x_np, h147),
        "interp_4_1_bf16out": (
            h147, {"ratio": Fraction(4, 1), "store_dtype": jnp.bfloat16},
            x_np, h147),
        "arbitrary_0.4709": (ha, {"rate": 0.4709, "nphi": 32}, x_np, ha),
        "arbitrary_refrate": (ha, {"rate": r_ref, "nphi": 32}, x_np, ha),
        "farrow_refrate": (ha, {"rate": r_ref, "nphi": 32, "polyorder": 4},
                           x_np, ha),
        "farrow_0.4709": (ha, {"rate": 0.4709, "nphi": 32, "polyorder": 4},
                          x_np, ha),
        "farrow_64ch_batched": (
            ha, {"rate": 0.9173, "nphi": 32, "polyorder": 4}, x64_np, ha),
        "farrow_64ch_tmajor": (
            ha, {"rate": 0.9173, "nphi": 32, "polyorder": 4},
            np.ascontiguousarray(x64_np.T), ha),
    }
    return cases[name]


def _as_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _bank(k):
    return k.taps_rev if hasattr(k, "taps_rev") else k.pfb


def _fields(k):
    """A kernel's spec: its type, ratio or rate, nphi, polyorder and
    store type."""
    ratio = Fraction(getattr(k, "interpolation", 1),
                     getattr(k, "decimation", 1))
    store = getattr(k, "store_dtype", None)
    return (type(k).__name__, getattr(k, "rate", ratio),
            getattr(k, "nphi", None), getattr(k, "polyorder", None),
            None if store is None else str(store).removeprefix("torch."))


def test_rows_are_the_sidecar_rows_in_order():
    with open(REPO / "BENCH_SIDECAR.json") as fh:
        names = [c["name"] for c in json.load(fh)["configs"]]
    assert [r.name for r in bench.ROWS] == names
    assert bench.BASELINE_MSPS == _root_bench().BASELINE_MSPS
    assert bench.RMS_BUDGET == _root_bench().RMS_BUDGET


@pytest.mark.parametrize("row", bench.ROWS, ids=lambda r: r.name)
def test_row_builds_what_bench_py_builds(row):
    taps, kw, jx, jh = _bench_py_case(row.name, N_SMALL)
    c = bench._case(row, bench._taps(), bench._signals(N_SMALL), "cpu")
    # the oracle's taps
    assert c.h_ref.dtype == jh.dtype
    np.testing.assert_allclose(c.h_ref, jh, rtol=0,
                               atol=TOL_TAPS * float(np.abs(jh).max()))
    # the kernel: bench.py's spec, and the bank of its taps
    if "store_dtype" in kw:
        kw = {**kw, "store_dtype": torch.bfloat16}
    want = mt.make_kernel(mt.ops.params.to_tensor(taps), device="cpu", **kw)
    assert _fields(c.params) == _fields(want)
    assert _bank(c.params).dtype == _bank(want).dtype
    np.testing.assert_allclose(
        _as_np(_bank(c.params)), _as_np(_bank(want)), rtol=0,
        atol=TOL_TAPS * float(_bank(want).abs().max()))
    # the timed signal: its type, shape and values exactly
    assert str(c.x.dtype).removeprefix("torch.") == jx.dtype.name
    assert tuple(c.x.shape) == jx.shape
    np.testing.assert_array_equal(_as_np(c.x), jx.astype(_as_np(c.x).dtype))
    assert c.state_dtype == c.x.dtype


@pytest.mark.parametrize("kind", ["rational", "arbitrary", "farrow", "c64"])
def test_accuracy_rms_matches_bench_py(kind):
    root = _root_bench()
    rng = np.random.default_rng(12)
    n_check = 2000
    ha = (mr.firdes(320, 0.45, mr.kaiser, samplerate=32, beta=7.0) * 32
          ).astype(np.float32)
    h = np.asarray(mr.firdes(147, 0.2, mr.kaiser, beta=7.0), np.float32)
    x = rng.standard_normal(3 * n_check).astype(np.float32)
    if kind == "c64":
        x = (x + 1j * rng.standard_normal(x.shape[0])).astype(np.complex64)
    spec, kw, taps = {
        "rational": (Fraction(3, 2), {}, h),
        "c64": (Fraction(3, 2), {}, h),
        "arbitrary": (0.4709, {"nphi": 32}, ha),
        "farrow": (1.0 / 2.123456789, {"nphi": 32, "polyorder": 4}, ha),
    }[kind]
    if isinstance(spec, Fraction):
        jp = mr.make_kernel(taps, ratio=spec)
        p = mt.make_kernel(taps, ratio=spec, device="cpu")
    else:
        jp = mr.make_kernel(taps, rate=spec, **kw)
        p = mt.make_kernel(taps, rate=spec, device="cpu", **kw)
    # one output, the port's, with a known error put in
    y = mt.filt_block(p, mt.init_state(p, (), torch.from_numpy(x).dtype),
                      torch.from_numpy(x[:n_check]))[0].numpy()
    y = y + (1e-4 * rng.standard_normal(y.shape)).astype(y.dtype)
    want = root.accuracy_rms(mr, jp, taps, spec, x, y, n_check=n_check)
    got = bench.accuracy_rms(p, taps, spec, x, y, n_check=n_check)
    assert want > 1e-5
    assert got == pytest.approx(want, rel=TOL_RMS)


def _stub_scaling(monkeypatch, sidecar, calls):
    def run(device, ranks):
        # after the sweep: every row is already in the sidecar
        with open(sidecar) as fh:
            calls.append((device, ranks, len(json.load(fh)["configs"])))
        return {"stub": True}

    monkeypatch.setattr(scaling_bench, "run", run)


ROWS_ASKED = ["rational_147_160_int8", "interp_4_1_bf16out",
              "farrow_64ch_tmajor"]


def _short_chains(monkeypatch, budget=None):
    """ROWS with chains of 4 calls, twice (the rates are the CPU's and
    only their presence is checked); the headline's budget as given."""
    rows = [dataclasses.replace(r, repeat=4, iters=2) for r in bench.ROWS]
    if budget is not None:
        rows[0] = dataclasses.replace(rows[0], budget=budget)
    monkeypatch.setattr(bench, "ROWS", tuple(rows))


def test_run_on_the_cpu_prints_the_headline_last(tmp_path, monkeypatch,
                                                 capsys):
    sidecar = tmp_path / "side.json"
    calls = []
    _stub_scaling(monkeypatch, sidecar, calls)
    _short_chains(monkeypatch)
    side = bench.run(device="cpu", n=N_SMALL, rows=ROWS_ASKED,
                     sidecar=sidecar)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("{")
    for line in lines:
        head = json.loads(line)
        assert set(head) == HEADLINE_KEYS
    assert head["metric"] == "rational_147_160_8M_f32_throughput"
    assert head["value"] > 0 and head["chunked_vs_whole_rms"] == 0.0
    # no device metric from a CPU run
    assert head["roofline_pct"] is None and head["stream_copy_gbps"] is None
    with open(sidecar) as fh:
        written = json.load(fh)
    assert written == json.loads(json.dumps(side))
    names = [c["name"] for c in written["configs"]]
    assert names == ["rational_147_160", *ROWS_ASKED]
    assert calls == [("cpu", 4, len(names))]
    assert written["scaling"] == {"stub": True}
    assert "accuracy_failures" not in written
    for c in written["configs"]:
        assert c["path"] == "kernel"
        assert c["variant"] is None and c["launches"] == 0  # no card
        assert c["msps_in"] > 0 and c["oracle_rel_rms"] < 0.05
        assert c["roofline_pct"] is None and c["pct_of_copy_ceiling"] is None
        assert c["buffers"] == 1 and c["lead_ms"] is None
    by = {c["name"]: c for c in written["configs"]}
    # bytes a call: x plus y as stored (int32 accumulators, bf16 stores)
    n_out = mt.outputlength(N_SMALL, Fraction(147, 160))
    assert by["rational_147_160_int8"]["bytes_per_call"] == N_SMALL + 4 * \
        n_out
    assert by["interp_4_1_bf16out"]["bytes_per_call"] == 4 * N_SMALL + \
        2 * 4 * N_SMALL
    assert written["configs"][0]["msps_in_median3"] > 0


def test_an_oracle_budget_exits_after_the_headline(tmp_path, monkeypatch,
                                                   capsys):
    sidecar = tmp_path / "side.json"
    _stub_scaling(monkeypatch, sidecar, [])
    _short_chains(monkeypatch, budget=1e-12)
    with pytest.raises(SystemExit) as e:
        bench.run(device="cpu", n=N_SMALL, rows=[], sidecar=sidecar)
    assert e.value.code != 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(last)) == HEADLINE_KEYS
    with open(sidecar) as fh:
        (fail,) = json.load(fh)["accuracy_failures"]
    assert fail["name"] == "rational_147_160" and fail["budget"] == 1e-12


def test_main_raises_without_a_card(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("re-exec or subprocess without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("execv", "execve", "execvp"):
        monkeypatch.setattr(os, name, refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    sidecar = tmp_path / "side.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--sidecar", str(sidecar)])
    assert not sidecar.exists()
