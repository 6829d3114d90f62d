#!/usr/bin/env python3
"""Smoke test of the multirate_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card: the 48 kHz -> 44.1 kHz rational
resample ``filt(h, x, Fraction(147, 160))`` with 24*147 Kaiser taps on
float32, and arbitrary-rate and Farrow resampling with ``bench.py``'s
320-tap bank (nphi 32, 10 taps per phase). It runs in phases; each prints
one line:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the polyphase and resample kernels from
   ``multirate_tpu_torch/csrc``, one nvcc each, started together, and
   prints ptxas's registers and spills;
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

Then the same three steps for the arbitrary/Farrow path:

3b. resample kernel vs plain version, arbitrary and Farrow, channel-major
   and time-major, at rates 1/2.123456789, 0.4709, 0.9173, 1.0, 1.313 and
   2.5, nphi 32 and 7, 1 and 64 channels, fresh and after setphase(0.37)
   and one block; plus nphi 1024 at rate 0.3 past 2^20 outputs, a Farrow
   table too large for shared memory, and rate 0.01, whose spans shrink
   the tile: counts and states exact, outputs within 1e-5 * max|y|;
4b. the slice at full width: ``filt`` and ``FIRFilter`` in 250 000-sample
   chunks on 8 M samples, arbitrary at 1/2.123456789 and Farrow at
   0.4709; 64-channel Farrow at 0.9173 on (64, 125 000) through ``filt``
   and through ``filt_block_tm`` on the transposed samples. Chunked-vs-
   whole RMS <= 1e-6, time-major == channel-major within 1e-6 * max|y|,
   relative RMS against the float64 oracles on the first 200 000 outputs
   (``naivefilt`` <= 1e-4 for arbitrary at 1/2.123456789, the reference's
   dh wrap floor; ``naivefilt_farrow`` <= 8e-5), and each wrapper's launch
   count around these runs equal to the number of blocks;
5b. times of kernel and plain version for ``bench.py``'s six
   arbitrary/Farrow rows, as in phase 5.

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
R_REF = 1.0 / 2.123456789  # the reference's speed-harness rate
RATES = (R_REF, 0.4709, 0.9173, 1.0, 1.313, 2.5)
N_CH, XLEN_CH = 64, 125_000  # bench.py's 64-channel rows: (64, 8 M / 64)
TOL_ORACLE_ARB_REF = 1e-4    # arbitrary at R_REF: the dh wrap floor 7.8e-5
TOL_TM = 1e-6                # time-major vs channel-major, rel. to max|y|


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


def bench_taps(mt):
    """bench.py's arbitrary/Farrow bank: 320 taps, nphi 32, T = 10."""
    return (mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32
            ).astype(np.float32)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from multirate_tpu_torch.ops.cuda import build

    names = ("polyphase", "resample")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    build.load_polyphase()
    build.load_resample()
    secs = time.perf_counter() - t0
    for lib in libs:
        log = (lib.parent / "build.log").read_text()
        usage = [ln.split("info    : ")[-1] for ln in log.splitlines()
                 if "registers" in ln]
        print(f"[2 build] {lib.relative_to(build.BUILD_DIR.parent)}; "
              f"ptxas: {' | '.join(usage)}")
    print(f"[2 build] {len(names)} kernels built in parallel in "
          f"{secs:.1f} s")


def _compare(mt, torch, params, st, x, time_major, case):
    """One kernel-vs-plain case through the block entry points; returns
    max|dy| / max|y|."""
    step = mt.filt_block_tm if time_major else mt.filt_block
    yk, ck, sk = step(params, st, x, path="kernel")
    yp, cp, sp = step(params, st, x, path="windows")
    torch.cuda.synchronize()
    xlen = x.shape[0] if time_major else x.shape[-1]
    n_axis = 0 if time_major else -1
    check(ck == cp == yk.shape[n_axis] == yp.shape[n_axis]
          == mt.outputlength(params, xlen, state=st), f"{case}: counts differ")
    check((sk.phase, sk.deficit) == (sp.phase, sp.deficit)
          and torch.equal(sk.history, sp.history), f"{case}: states differ")
    check(bool(torch.isfinite(yk).all()), f"{case}: non-finite")
    scale = float(yp.abs().max()) if yp.numel() else 0.0
    err = (float((yk - yp).abs().max()) / max(scale, 1e-30)
           if yp.numel() else 0.0)
    check(err <= TOL_KERNEL, f"{case}: rel err {err:.3e}")
    return err


def _rel_rms(got, ref):
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def phase_kernel_vs_plain(mt, torch, dev):
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
                    _, _, st = mt.filt_block(params, st, x[..., :1237],
                                             path="windows")
                case = f"{taps_name} {ratio} lead={lead} {entry}"
                worst = max(worst, _compare(mt, torch, params, st, x, False,
                                            case))
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
    check(len(ref) == N_ORACLE, f"oracle gave {len(ref)}")
    rel = _rel_rms(y[:N_ORACLE].double().cpu().numpy(), ref)
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


def phase_resample_vs_plain(mt, torch, dev):
    rng = np.random.default_rng(2)
    ha = bench_taps(mt)
    specs = []  # (name, taps, rate, nphi, polyorder, channels, xlen)
    for rate in RATES:
        for nphi in (32, 7):
            for po in (None, 4):
                for ch, xlen in ((1, 200_003), (N_CH, 20_011)):
                    specs.append(("bench taps", ha, rate, nphi, po, ch,
                                  xlen))
    for po in (None, 3):
        # delta_fx near 2^43.7: u0 + n*delta_fx passes 2^63 near n = 2^19.3
        specs.append(("nphi 1024, T 2", rng.standard_normal(2048).astype(
            np.float32), 0.3, 1024, po, 1, 3_600_000))
    # a (5, 10, 2048) Farrow table, 400 KB, read from global memory
    specs.append(("global table", rng.standard_normal(20_480).astype(
        np.float32), 0.9, 2048, 4, N_CH, 20_011))
    for po in (None, 4):
        # spans of about 100 samples per output: the launcher halves the tile
        specs.append(("low rate", ha, 0.01, 32, po, N_CH, 200_003))
    worst, n_cases, big_n = 0.0, 0, 0
    for name, h, rate, nphi, po, ch, xlen in specs:
        params = mt.make_kernel(h, rate=rate, nphi=nphi, polyorder=po,
                                device=dev)
        x = torch.from_numpy(rng.standard_normal((ch, xlen)).astype(
            np.float32)).to(dev)
        xt = x.t().contiguous()
        for entry in ("fresh", "mid"):
            st = mt.init_state(params, (ch,))
            if entry == "mid":
                st = mt.setphase(params, st, 0.37)
                _, _, st = mt.filt_block(params, st, x[:, :1237],
                                         path="windows")
            if name.startswith("nphi 1024"):
                big_n = max(big_n, mt.outputlength(params, xlen, state=st))
            kind = "arbitrary" if po is None else f"Farrow P={po}"
            for time_major in (False, True):
                case = (f"{name} {kind} rate={rate:.6g} nphi={nphi} "
                        f"C={ch} {entry} "
                        f"{'time' if time_major else 'channel'}-major")
                worst = max(worst, _compare(mt, torch, params, st,
                                            xt if time_major else x,
                                            time_major, case))
                n_cases += 1
    check(big_n > 1 << 20, f"the nphi 1024 case made only {big_n} outputs")
    print(f"[3b resample vs plain] {n_cases} cases (up to {big_n} outputs "
          f"at nphi 1024), counts and states exact, worst max|dy|/max|y| "
          f"{worst:.3e} (limit {TOL_KERNEL})")


def phase_resample_slice(mt, torch, dev, rs):
    from multirate_tpu_torch.ops import indexing as idx
    from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow

    ha = bench_taps(mt)
    ha64 = ha.astype(np.float64)
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal(N_HEAD).astype(np.float32)
    x64_np = rng.standard_normal((N_CH, XLEN_CH)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    x64 = torch.from_numpy(x64_np).to(dev)
    rows = (("arbitrary", R_REF, None), ("Farrow", 0.4709, 4))

    rs.launches = rs.launches_tm = 0
    runs = []
    for _, rate, po in rows:
        y = mt.filt(ha, x, rate, 32, po)
        f = mt.FIRFilter(ha, rate, 32, po)
        runs.append((y, [f.filt(x[i:i + CHUNK])
                         for i in range(0, N_HEAD, CHUNK)], f))
    y_cm = mt.filt(ha, x64, 0.9173, 32, 4)
    p64 = mt.make_kernel(ha, rate=0.9173, nphi=32, polyorder=4, device=dev)
    y_tm, c_tm, s_tm = mt.filt_block_tm(p64, mt.init_state(p64, (N_CH,)),
                                        x64.t().contiguous())
    torch.cuda.synchronize()
    launches = (rs.launches, rs.launches_tm)

    n_chunks = len(runs[0][1])
    want = (len(rows) * (1 + n_chunks) + 1, 1)
    check(launches == want, f"resample launches {launches}, want {want}")
    notes = []
    for (label, rate, po), (y, parts, f) in zip(rows, runs):
        n_want = mt.outputlength(f.params, N_HEAD)
        check(y.device == x.device and y.dtype == torch.float32
              and tuple(y.shape) == (n_want,),
              f"{label}: filt gave {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{label}: non-finite outputs")
        yc = torch.cat(parts)
        check(tuple(yc.shape) == (n_want,),
              f"{label}: chunked gave {tuple(yc.shape)}")
        # the stream ends in the state one block's closed form gives
        _, u_end, d_end = idx.host_carry(f.params, 0, 1, N_HEAD)
        check((f.state.phase, f.state.deficit) == (u_end, d_end),
              f"{label}: stream state ({f.state.phase}, {f.state.deficit})")
        d = yc.double() - y.double()
        rms_chunk = float(torch.sqrt(torch.mean(d * d)))
        check(rms_chunk <= TOL_CHUNKED,
              f"{label}: chunked-vs-whole RMS {rms_chunk:.3e}")
        n_in = mt.inputlength(f.params, N_ORACLE)
        x_in = x_np[:n_in].astype(np.float64)
        if po is None:
            ref = naivefilt(ha64, x_in, rate, 32)[:N_ORACLE]
            limit = TOL_ORACLE_ARB_REF
        else:
            ref = naivefilt_farrow(ha64, x_in, rate, 32, po)[:N_ORACLE]
            limit = TOL_ORACLE
        check(len(ref) == N_ORACLE, f"{label}: oracle gave {len(ref)}")
        rel = _rel_rms(y[:N_ORACLE].double().cpu().numpy(), ref)
        check(rel <= limit, f"{label}: oracle relative RMS {rel:.3e}")
        notes.append(f"{label} rate {rate:.9g} on {N_HEAD} -> {n_want}: "
                     f"oracle rel RMS {rel:.3e} (limit {limit}), "
                     f"{len(parts)} chunks: chunked-vs-whole RMS "
                     f"{rms_chunk:.3e}")

    n64 = mt.outputlength(p64, XLEN_CH)
    check(tuple(y_cm.shape) == (N_CH, n64) and c_tm == n64
          and tuple(y_tm.shape) == (n64, N_CH),
          f"64 channels: {tuple(y_cm.shape)} and {tuple(y_tm.shape)}")
    check(bool(torch.isfinite(y_cm).all() and torch.isfinite(y_tm).all()),
          "64 channels: non-finite outputs")
    scale = float(y_cm.abs().max())
    tm_err = float((y_tm.t() - y_cm).abs().max()) / scale
    check(tm_err <= TOL_TM, f"time-major vs channel-major {tm_err:.3e}")
    check(torch.equal(s_tm.history, x64[:, XLEN_CH - p64.h_min:]),
          "time-major history")
    worst64 = 0.0
    for c in (0, N_CH - 1):
        ref = naivefilt_farrow(ha64, x64_np[c].astype(np.float64), 0.9173,
                               32, 4)[:N_ORACLE]
        got = y_cm[c, :N_ORACLE].double().cpu().numpy()
        check(len(ref) == len(got), f"channel {c}: oracle gave {len(ref)}")
        worst64 = max(worst64, _rel_rms(got, ref))
    check(worst64 <= TOL_ORACLE, f"64 channels: oracle rel RMS {worst64:.3e}")
    notes.append(f"64-channel Farrow 0.9173 on {(N_CH, XLEN_CH)} -> {n64} "
                 f"per channel: oracle rel RMS {worst64:.3e} (channels 0, "
                 f"{N_CH - 1}), time-major vs channel-major {tm_err:.3e} "
                 f"(limit {TOL_TM})")
    print(f"[4b resample slice] {'; '.join(notes)}; launches "
          f"channel-major {launches[0]}, time-major {launches[1]}")
    return x, x64, launches


def phase_resample_times(mt, torch, x, x64, rs, card):
    """bench.py's six arbitrary/Farrow rows: kernel vs plain version."""
    ha = bench_taps(mt)
    x1 = x.view(1, -1)
    xt64 = x64.t().contiguous()
    rows = (("arbitrary_0.4709", 0.4709, None, x1, False),
            ("arbitrary_refrate", R_REF, None, x1, False),
            ("farrow_refrate", R_REF, 4, x1, False),
            ("farrow_0.4709", 0.4709, 4, x1, False),
            ("farrow_64ch_batched", 0.9173, 4, x64, False),
            ("farrow_64ch_tmajor", 0.9173, 4, xt64, True))
    out, notes = {}, []
    for name, rate, po, xs, tm in rows:
        p = mt.make_kernel(ha, rate=rate, nphi=32, polyorder=po,
                           device=x.device)
        C = xs.shape[1] if tm else xs.shape[0]
        st = mt.init_state(p, (C,))
        n = mt.outputlength(p, xs.shape[0] if tm else xs.shape[1])
        args = (xs, st.history, p, 0, 1, n)
        kern = rs.resample_tm if tm else rs.resample
        plain = rs.resample_tm_plain if tm else rs.resample_plain
        yk, yp = kern(*args), plain(*args)
        torch.cuda.synchronize()
        max_abs = float((yk - yp).abs().max())
        check(max_abs <= TOL_KERNEL * float(yp.abs().max()),
              f"{name}: kernel vs plain max abs err {max_abs:.3e}")
        ms = _time_ms(torch, lambda: kern(*args), iters=20)
        plain_ms = _time_ms(torch, lambda: plain(*args), iters=2)
        out[name] = (max_abs, ms, plain_ms)
        notes.append(f"{name} kernel {ms:.4f} ms ({xs.numel() / ms / 1e3:.1f}"
                     f" Msps in), plain {plain_ms:.4f} ms, max abs err "
                     f"{max_abs:.3e}")
    print(f"[5b resample times] {'; '.join(notes)}; card: {card}")
    return out


def main() -> int:
    try:
        import torch

        card = phase_device(torch)
        import multirate_tpu_torch as mt
        from multirate_tpu_torch.ops.cuda import polyphase as pp
        from multirate_tpu_torch.ops.cuda import resample as rs

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_build()
        phase_kernel_vs_plain(mt, torch, dev)
        phase_resample_vs_plain(mt, torch, dev)
        h, x, launches = phase_slice(mt, torch, dev, pp)
        xa, x64, rs_launches = phase_resample_slice(mt, torch, dev, rs)
        max_abs, ms, plain_ms = phase_times(mt, torch, h, x, pp, card)
        rows = phase_resample_times(mt, torch, xa, x64, rs, card)
        check("jax" not in sys.modules, "jax was imported")
    except Exception:  # the smoke's boundary: report and fail
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1
    cm_rows = [r for r in rows if r != "farrow_64ch_tmajor"]
    print(json.dumps({"kernels": [{
        "name": "polyphase_f32",
        "route": "cuda",
        "source": "multirate_tpu_torch/csrc/polyphase.cu",
        "replaces": "multirate_tpu/ops/pallas/rational2.py:836",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        # times at the reference's harness rate; the other rows: phase 5b
        "name": "resample_f32",
        "route": "cuda",
        "source": "multirate_tpu_torch/csrc/resample.cu",
        "replaces": ", ".join(
            f"multirate_tpu/ops/pallas/{loc}" for loc in (
                "gridsel.py:464", "gridsel.py:485", "gridsel.py:593",
                "gridsel.py:609", "select4.py:225", "select4.py:244",
                "select3.py:319", "select3.py:347", "select.py:74",
                "select.py:163")),
        "launches": rs_launches[0],
        "max_abs_err": max(rows[r][0] for r in cm_rows),
        "ms": rows["arbitrary_refrate"][1],
        "plain_ms": rows["arbitrary_refrate"][2],
    }, {
        "name": "resample_tm_f32",
        "route": "cuda",
        "source": "multirate_tpu_torch/csrc/resample.cu",
        "replaces": "multirate_tpu/ops/pallas/select4.py:394, "
                    "multirate_tpu/ops/pallas/select4.py:412",
        "launches": rs_launches[1],
        "max_abs_err": rows["farrow_64ch_tmajor"][0],
        "ms": rows["farrow_64ch_tmajor"][1],
        "plain_ms": rows["farrow_64ch_tmajor"][2],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
