#!/usr/bin/env python3
"""Smoke test of the multirate_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the 48 kHz -> 44.1 kHz rational resample
``filt(h, x, Fraction(147, 160))`` with 24*147 Kaiser taps on float32, on
the card, in phases; each phase prints one line:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the polyphase kernel from ``multirate_tpu_torch/csrc``;
3. kernel vs plain version on the card, for the four rational-family
   filter types at the headline taps and at short taps, plus a bank too
   large for shared memory and a wide decimation, fresh and mid-phase
   entry states, one channel and two channels at xlen 80007: counts and
   states equal exactly, outputs within 1e-5 * max|y|;
4. the slice at full size: one 8 M-sample block through ``filt`` (relative
   RMS against the float64 ``naivefilt`` oracle on the first 200 000
   outputs <= 8e-5) and the same samples through ``FIRFilter`` in 250 000-
   sample chunks (counts and state equal, chunked-vs-whole RMS <= 1e-6),
   with the kernel's launch count read around these two runs alone;
5. times: kernel and plain version at the headline block, CUDA events,
   median of 7 runs after a warm-up; the kernel alone for one launch
   after a 256 MB write that evicts the 50 MB L2, and at 1//1, 4//1 and
   1//4 with T = 24 random taps on the same 8 M samples.

Then a JSON line of the kernels, the ``nvidia-smi`` name and power-limit
line, and as the last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without the last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from fractions import Fraction

import numpy as np

N_HEAD = 8_000_000
CHUNK = 250_000
N_ORACLE = 200_000
CASE_SHAPES = (((), 200_003), ((2,), 80_007))  # (channel dims, xlen)
TOL_KERNEL = 1e-5       # kernel vs plain, relative to max|y|: f32 sum order
TOL_ORACLE = 8e-5       # relative RMS vs the f64 oracle (bench.py tripwire)
TOL_CHUNKED = 1e-6      # chunked-vs-whole RMS (bench.py's metric)
GEOMETRIES = ((1, 1), (4, 1), (1, 4))  # (L, M) timed beside the headline


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def headline_taps(mt):
    return (mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
            ).astype(np.float32)


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def phase_build():
    from multirate_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    lib = build.build("polyphase")
    build.load_polyphase()
    secs = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    usage = [ln.split("info    : ")[-1] for ln in log.splitlines()
             if "registers" in ln]
    print(f"[2 build] {lib.relative_to(build.BUILD_DIR.parent)} in "
          f"{secs:.1f} s; ptxas: {' | '.join(usage)}")


def phase_kernel_vs_plain(mt, torch, dev):
    from multirate_tpu_torch.ops.compute import filt_block_raw

    rng = np.random.default_rng(1)
    h_head = headline_taps(mt)
    h_short = (mt.firdes(24 * 5, 0.5 / 5, mt.kaiser, beta=7.8562) * 5
               ).astype(np.float32)
    specs = [("head", h_head, Fraction(147, 160)),
             ("head", h_head, Fraction(1, 1)),
             ("head", h_head, Fraction(4, 1)),
             ("head", h_head, Fraction(1, 4)),
             ("short", h_short, Fraction(3, 5)),
             ("short", h_short, Fraction(1, 4)),
             ("short", h_short, Fraction(4, 1)),
             ("short", h_short, Fraction(1, 1)),
             # a 120 KB bank read from global memory, and a span that
             # makes the launcher shrink its tile
             ("wide bank", rng.standard_normal(30 * 1000).astype(
                 np.float32), Fraction(1000, 999)),
             ("wide decimation", rng.standard_normal(24 * 200).astype(
                 np.float32), Fraction(1, 200))]
    worst, n_cases = 0.0, 0
    for taps_name, h, ratio in specs:
        params = mt.make_kernel(h, ratio=ratio, device=dev)
        for lead, xlen in CASE_SHAPES:
            x = torch.from_numpy(rng.standard_normal(
                (*lead, xlen)).astype(np.float32)).to(dev)
            for entry in ("fresh", "mid"):
                st = mt.init_state(params, lead)
                if entry == "mid":
                    if hasattr(params, "nphi"):
                        st = mt.setphase(params, st, 0.37)
                    _, _, st = filt_block_raw(params, st, x[..., :1237],
                                              path="windows")
                yk, ck, sk = filt_block_raw(params, st, x, path="kernel")
                yp, cp, sp = filt_block_raw(params, st, x, path="windows")
                torch.cuda.synchronize()
                case = f"{taps_name} {ratio} lead={lead} {entry}"
                check(ck == cp == yk.shape[-1] == yp.shape[-1]
                      == mt.outputlength(params, xlen, state=st),
                      f"{case}: counts differ")
                check((sk.phase, sk.deficit) == (sp.phase, sp.deficit)
                      and torch.equal(sk.history, sp.history),
                      f"{case}: states differ")
                scale = float(yp.abs().max())
                err = float((yk - yp).abs().max()) / max(scale, 1e-30)
                check(bool(torch.isfinite(yk).all()), f"{case}: non-finite")
                check(err <= TOL_KERNEL, f"{case}: rel err {err:.3e}")
                worst = max(worst, err)
                n_cases += 1
    print(f"[3 kernel vs plain] {n_cases} cases, counts and states exact, "
          f"worst max|dy|/max|y| {worst:.3e} (limit {TOL_KERNEL})")


def phase_slice(mt, torch, dev, pp):
    from multirate_tpu_torch.utils.oracle import naivefilt

    ratio = Fraction(147, 160)
    h = headline_taps(mt)
    x_np = np.random.default_rng(0).standard_normal(N_HEAD).astype(
        np.float32)
    x = torch.from_numpy(x_np).to(dev)
    n_want = mt.outputlength(N_HEAD, ratio)

    pp.launches = 0
    y = mt.filt(h, x, ratio)
    f = mt.FIRFilter(h, ratio)
    parts = [f.filt(x[i:i + CHUNK]) for i in range(0, N_HEAD, CHUNK)]
    torch.cuda.synchronize()
    launches = pp.launches

    check(launches == 1 + len(parts),
          f"kernel launched {launches} times, want {1 + len(parts)}")
    check(y.device == x.device and y.dtype == torch.float32
          and tuple(y.shape) == (n_want,), f"filt gave {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite outputs")
    yc = torch.cat(parts)
    check(tuple(yc.shape) == (n_want,), f"chunked gave {tuple(yc.shape)}")
    # the stream ends in the state a single block's closed form gives
    t_end = n_want * 160
    check((f.state.phase, f.state.deficit)
          == (t_end % 147 + 1, 1 + t_end // 147 - N_HEAD),
          f"stream state ({f.state.phase}, {f.state.deficit})")
    d = (yc.double() - y.double())
    rms_chunk = float(torch.sqrt(torch.mean(d * d)))
    check(rms_chunk <= TOL_CHUNKED, f"chunked-vs-whole RMS {rms_chunk:.3e}")

    n_in = mt.inputlength(N_ORACLE, ratio)
    ref = naivefilt(h.astype(np.float64), x_np[:n_in].astype(np.float64),
                    ratio)[:N_ORACLE]
    got = y[:N_ORACLE].double().cpu().numpy()
    check(len(ref) == N_ORACLE, f"oracle gave {len(ref)}")
    rel = float(np.sqrt(np.mean((got - ref) ** 2))
                / np.sqrt(np.mean(ref ** 2)))
    check(rel <= TOL_ORACLE, f"oracle relative RMS {rel:.3e}")
    print(f"[4 slice] 147//160 on {N_HEAD} samples -> {n_want} outputs; "
          f"oracle rel RMS {rel:.3e} (limit {TOL_ORACLE}); FIRFilter "
          f"{len(parts)} chunks of {CHUNK}: chunked-vs-whole RMS "
          f"{rms_chunk:.3e} (limit {TOL_CHUNKED}); kernel launches {launches}")
    return h, x, launches


def _time_ms(torch, fn, iters, reps=7, before=None):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls between two CUDA events, with ``before`` (if given) queued ahead
    of each rep. A device-side sleep queued first keeps the card busy
    while the host enqueues, so host time is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        if before is not None:
            before()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def phase_times(mt, torch, h, x, pp, card):
    ratio = Fraction(147, 160)
    params = mt.make_kernel(h, ratio=ratio, device=x.device)
    st = mt.init_state(params)
    n = mt.outputlength(params, N_HEAD)
    x2, h2 = x.view(1, -1), st.history.view(1, -1)
    args = (x2, h2, params.bank, 147, 160, 1, 1, n)
    yk = pp.polyphase(*args)
    yp = pp.polyphase_plain(*args)
    torch.cuda.synchronize()
    max_abs = float((yk - yp).abs().max())
    check(max_abs <= TOL_KERNEL * float(yp.abs().max()),
          f"headline kernel vs plain max abs err {max_abs:.3e}")
    ms = _time_ms(torch, lambda: pp.polyphase(*args), iters=20)
    plain_ms = _time_ms(torch, lambda: pp.polyphase_plain(*args), iters=2)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=x.device)
    cold_ms = _time_ms(torch, lambda: pp.polyphase(*args), iters=1,
                       before=flush.zero_)
    del flush
    geo = []
    g = torch.Generator(device=x.device).manual_seed(0)
    for L, M in GEOMETRIES:
        bank = torch.randn(24, L, generator=g, device=x.device)
        hist = torch.zeros(1, 23, device=x.device)
        n_g = mt.outputlength(N_HEAD, Fraction(L, M))
        g_ms = _time_ms(torch, lambda: pp.polyphase(
            x2, hist, bank, L, M, 1, 1, n_g), iters=20)
        geo.append(f"{L}//{M} {g_ms:.4f} ms ({N_HEAD / g_ms / 1e3:.1f} "
                   f"Msps in)")
    print(f"[5 times] 147//160 block of {N_HEAD}: kernel {ms:.4f} ms "
          f"({N_HEAD / ms / 1e3:.1f} Msps in, {n / ms / 1e3:.1f} Msps out), "
          f"one launch after an L2 flush {cold_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms ({N_HEAD / plain_ms / 1e3:.1f} Msps in);"
          f" max abs err {max_abs:.3e}; T=24 random taps: {'; '.join(geo)};"
          f" card: {card}")
    return max_abs, ms, plain_ms


def main() -> int:
    try:
        import torch

        card = phase_device(torch)
        import multirate_tpu_torch as mt
        from multirate_tpu_torch.ops.cuda import polyphase as pp

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_build()
        phase_kernel_vs_plain(mt, torch, dev)
        h, x, launches = phase_slice(mt, torch, dev, pp)
        max_abs, ms, plain_ms = phase_times(mt, torch, h, x, pp, card)
        check("jax" not in sys.modules, "jax was imported")
    except Exception:  # the smoke's boundary: report and fail
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "polyphase_f32",
        "route": "cuda",
        "source": "multirate_tpu_torch/csrc/polyphase.cu",
        "replaces": "multirate_tpu/ops/pallas/rational2.py:836",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
