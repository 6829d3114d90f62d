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

Then the same three steps for the quantized modes of the rational family
(``bench.py``'s rows ``rational_147_160_bf16``, ``rational_147_160_int8``
and ``interp_4_1_bf16out``), which run the polyphase kernel's other
instantiations:

3c. each quantized entry point (bf16 in; int8 in; float32 in with bfloat16
   or float16 stores; bf16 in with bfloat16 or float16 stores) against its
   plain version, at the four filter types with the headline and short
   taps, fresh and mid-phase, one channel and two channels at xlen 80007:
   counts and states exact; bf16 outputs within 1e-5 * max|y|, int8
   outputs equal, narrow stores within one ulp of the store type or
   1e-5 * max|y| (float32 sums in another order, then rounded);
4c. the three rows at full width: 8 M bf16 samples with bf16 headline
   taps through ``filt`` (relative RMS against float64 ``naivefilt`` over
   the same bf16 values <= 8e-5 on the first 200 000 outputs; the RMS
   against the float64 design printed, no limit) and ``FIRFilter`` in
   250 000-sample chunks; the same samples quantized to int8 through
   ``filt`` (int32 outputs equal to the integer oracle on the first
   200 000) and ``quant.QuantizedFIRFilter`` in chunks (bit-identical to
   the whole block); ``firdes(147, 0.2, kaiser, beta=7.0)`` at 4//1 with
   bfloat16 stores on the 8 M float32 samples (within one bf16 ulp of the
   float32 kernel's output, chunked == whole); each entry point's launch
   count around these runs equal to the number of blocks;
5c. times of kernel and plain version for the three rows, as in phase 5
   (the 4//1 row also with float32 stores), and of one PyTorch call
   computing the same function where there is one
   (``conv1d`` with TF32 off: the 4//1 row, and 1//1, 1//4 and 4//1 at
   T = 24 beside phase 5's kernel times).

Then the same three steps for the float64 and complex modes of every
filter type (``bench.py``'s rows ``rational_147_160_c64`` and
``rational_147_160_f64``), which run the ``f64``, ``c64``, ``c64c``,
``c128`` and ``c128c`` instantiations of both kernels:

3d. each of those entry points of both kernels against its plain version:
   the four rational-family types at the headline and short taps and a
   147//160 bank of 48 taps per phase (a complex128 bank too large for
   shared memory); arbitrary and Farrow at rates 1/2.123456789, 0.9173 and
   2.5, nphi 32 and 7, and a Farrow table in global memory; fresh and
   mid-phase, one channel and two, channel-major and time-major (which
   runs the channel-major entry point on the transpose). Counts and states
   exact; outputs within 1e-5 * max|y| (complex64) or 1e-12 * max|y|
   (float64, complex128);
4d. the two rows at full width: 8 M complex64 samples (phase 4's samples
   as real parts, seeded standard normal imaginary parts) with the float32
   headline taps, and phase 4's samples in float64 with the float64
   headline taps, through ``filt`` (relative RMS against the complex128 or
   float64 ``naivefilt`` on the first 200 000 outputs <= 8e-5 and
   <= 1e-12) and ``FIRFilter`` in 250 000-sample chunks (chunked-vs-whole
   RMS <= 1e-6 and <= 1e-14, counts and states equal); arbitrary at
   1/2.123456789 (<= 1e-4 against ``naivefilt``, the method's floor) and
   Farrow at 0.4709 (<= 1e-10 against ``naivefilt_farrow``) on the same
   float64 samples with the float64 bank, whole and chunked; each entry
   point's launch count around these runs equal to the number of blocks;
5d. times of kernel and plain version for the two rows and for arbitrary
   and Farrow in float64, as in phase 5, and for the three narrow-store
   entry points no bench row runs (``f32_f16out``, ``bf16_bf16out``,
   ``bf16_f16out``) at ``interp_4_1_bf16out``'s geometry, with the
   ``conv1d`` yardstick there.

Then a JSON line of the kernels (each with its bound: the larger of the
bytes it must move over 3.35 TB/s and its multiply-adds over the card's
peak for their type), the ``nvidia-smi`` name and power-limit line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without the last line. Imports nothing of JAX.
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
# the H100 SXM's published rates (HBM3; dense float32, bf16 and int8
# peaks), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12,
                  "f64": 34e12}  # FP64 vector rate: no tensor cores used
# the float64 and complex entry points of both kernels: (signal dtype name,
# taps dtype name, kernel-vs-plain limit relative to max|y|)
WIDE = {"f64": ("float64", "float64", 1e-12),
        "c64": ("complex64", "float32", 1e-5),
        "c64c": ("complex64", "complex64", 1e-5),
        "c128": ("complex128", "float64", 1e-12),
        "c128c": ("complex128", "complex128", 1e-12)}
TOL_ORACLE_F64 = 1e-12      # rational_147_160_f64 (bench.py:433)
TOL_CHUNKED_F64 = 1e-14     # chunked-vs-whole RMS in float64
TOL_ORACLE_FARROW_F64 = 1e-10


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


def _compare(mt, torch, params, st, x, time_major, case, tol=TOL_KERNEL):
    """One kernel-vs-plain case through the block entry points; returns
    max|dy| / max|y| (moduli for complex outputs), at most ``tol``."""
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
    check(yk.dtype == yp.dtype, f"{case}: {yk.dtype} against {yp.dtype}")
    check(bool(torch.isfinite(yk).all()), f"{case}: non-finite")
    scale = float(yp.abs().max()) if yp.numel() else 0.0
    err = (float((yk - yp).abs().max()) / max(scale, 1e-30)
           if yp.numel() else 0.0)
    check(err <= tol, f"{case}: rel err {err:.3e}")
    return err


def _rel_rms(got, ref):
    """Relative RMS of got - ref, real or complex (moduli)."""
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2)
                         / np.mean(np.abs(ref) ** 2)))


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

    for k in pp.launches:
        pp.launches[k] = 0
    y = mt.filt(h, x, ratio)
    f = mt.FIRFilter(h, ratio)
    parts = [f.filt(x[i:i + CHUNK]) for i in range(0, N_HEAD, CHUNK)]
    torch.cuda.synchronize()
    launches = pp.launches["f32"]

    check(launches == 1 + len(parts) == sum(pp.launches.values()),
          f"kernel launched {pp.launches}, want f32 {1 + len(parts)}")
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
    return h, x, launches, ref


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
    return max_abs, ms, plain_ms, _polyphase_bound(torch, args,
                                                   torch.float32, "f32")


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

    for k in rs.launches:
        rs.launches[k] = 0
    rs.launches_tm = 0
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
    launches = (rs.launches["f32"], rs.launches_tm)

    n_chunks = len(runs[0][1])
    want = (len(rows) * (1 + n_chunks) + 1, 1)
    check(launches == want and sum(rs.launches.values()) == want[0],
          f"resample launches {rs.launches}, time-major {rs.launches_tm}; "
          f"want f32 {want[0]}, time-major {want[1]}")
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
        # x, history and table read once, outputs written once; each
        # output takes T * (P + 1) multiply-adds (arbitrary: P = 1)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (xs, st.history, p.bank)) + C * n * 4
        out[name] = (max_abs, ms, plain_ms,
                     _bound(nbytes, C * n * p.bank.numel() // p.nphi,
                            "f32"))
        notes.append(f"{name} kernel {ms:.4f} ms ({xs.numel() / ms / 1e3:.1f}"
                     f" Msps in), plain {plain_ms:.4f} ms, max abs err "
                     f"{max_abs:.3e}, bound {out[name][3][0]:.4f} ms "
                     f"({out[name][3][1]})")
    print(f"[5b resample times] {'; '.join(notes)}; card: {card}")
    return out


def _bound(bytes_moved, mult_adds, kind):
    """(bound_ms, bound_by): the least time for the work on the card, the
    larger of the bytes over HBM_BYTES_PER_S and the operations (two per
    multiply-add) over the peak rate of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * mult_adds / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _polyphase_bound(torch, args, out_dtype, kind):
    """The bound of one polyphase call: x, hist and bank read once, the
    output written once, T multiply-adds per output in ``kind`` (two real
    ones per tap for complex samples against real taps, four against
    complex taps)."""
    x, hist, bank, *_, n = args
    nbytes = sum(t.numel() * t.element_size() for t in (x, hist, bank))
    out_size = torch.empty((), dtype=out_dtype).element_size()
    per_tap = (1 + x.is_complex()) * (1 + bank.is_complex())
    return _bound(nbytes + x.shape[0] * n * out_size,
                  x.shape[0] * n * bank.shape[0] * per_tap, kind)


def _as_mode(mt, torch, a, dtype):
    """Float32 samples or taps (numpy or a tensor) in a mode's storage
    type: bf16 rounded, int8 quantized (max|a| -> 127), float32 as is."""
    t = torch.as_tensor(a)
    if dtype == torch.int8:
        return mt.quant.quantize_signal(t)[0]
    return t.to(dtype)


def phase_quant_vs_plain(mt, torch, dev, pp):
    from multirate_tpu_torch.utils.testing import ulps_apart

    rng = np.random.default_rng(3)
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
             ("short", h_short, Fraction(1, 1))]
    # entry point: (storage dtype of taps and signal, store_dtype)
    modes = {"bf16": (torch.bfloat16, None),
             "s8": (torch.int8, None),
             "f32_bf16out": (torch.float32, torch.bfloat16),
             "f32_f16out": (torch.float32, torch.float16),
             "bf16_bf16out": (torch.bfloat16, torch.bfloat16),
             "bf16_f16out": (torch.bfloat16, torch.float16)}
    worst = dict.fromkeys(modes, 0.0)
    n_cases = 0
    for taps_name, h, ratio in specs:
        for mode, (dtype, store) in modes.items():
            params = mt.make_kernel(_as_mode(mt, torch, h, dtype),
                                    ratio=ratio, device=dev,
                                    store_dtype=store)
            for lead, xlen in CASE_SHAPES:
                x = _as_mode(mt, torch, rng.standard_normal(
                    (*lead, xlen)).astype(np.float32), dtype).to(dev)
                for entry in ("fresh", "mid"):
                    case = f"{mode} {taps_name} {ratio} lead={lead} {entry}"
                    st = mt.init_state(params, lead, dtype)
                    if entry == "mid":
                        if hasattr(params, "nphi"):
                            st = mt.setphase(params, st, 0.37)
                        _, _, st = mt.filt_block(params, st, x[..., :1237],
                                                 path="windows")
                    before = pp.launches[mode]
                    yk, ck, sk = mt.filt_block(params, st, x, path="kernel")
                    yp, cp, sp = mt.filt_block(params, st, x,
                                               path="windows")
                    torch.cuda.synchronize()
                    check(pp.launches[mode] == before + 1,
                          f"{case}: {mode} not launched once")
                    check(ck == cp == yk.shape[-1] == yp.shape[-1]
                          == mt.outputlength(params, xlen, state=st),
                          f"{case}: counts differ")
                    check((sk.phase, sk.deficit) == (sp.phase, sp.deficit)
                          and torch.equal(sk.history, sp.history),
                          f"{case}: states differ")
                    check(yk.dtype == yp.dtype, f"{case}: dtypes differ")
                    if dtype == torch.int8:
                        err = float((yk - yp).abs().max())
                        check(err == 0, f"{case}: int8 differs by {err}")
                    elif store is None:
                        check(bool(torch.isfinite(yk).all()),
                              f"{case}: non-finite")
                        err = (float((yk - yp).abs().max())
                               / float(yp.abs().max()))
                        check(err <= TOL_KERNEL, f"{case}: rel err {err:.3e}")
                    else:  # float32 sums in another order, rounded
                        err = ulps_apart(yk, yp, store, TOL_KERNEL
                                         * float(yp.abs().max()))
                        check(err <= 1, f"{case}: {err} ulps apart")
                    worst[mode] = max(worst[mode], err)
                    n_cases += 1
    print(f"[3c quantized vs plain] {n_cases} cases, counts and states "
          f"exact; worst: bf16 max|dy|/max|y| {worst['bf16']:.3e} (limit "
          f"{TOL_KERNEL}), int8 max|dy| {worst['s8']:g} (limit 0), narrow "
          f"stores in ulps of the store type: "
          + ", ".join(f"{m} {worst[m]:g}" for m in modes
                      if modes[m][1] is not None) + " (limit 1)")


def phase_quant_slice(mt, torch, dev, pp, x, ref):
    """bench.py's three quantized rows at full width; ``x`` is phase 4's
    float32 block and ``ref`` its float64 oracle (the true design)."""
    from multirate_tpu_torch.utils.oracle import naivefilt
    from multirate_tpu_torch.utils.testing import ulps_apart

    ratio = Fraction(147, 160)
    h = headline_taps(mt)
    hb = torch.from_numpy(h).bfloat16()
    xb = x.bfloat16()
    hq, s_h = mt.quant.quantize_taps(h)
    xq, s_x = mt.quant.quantize_signal(x)
    h147 = np.asarray(mt.firdes(147, 0.2, mt.kaiser, beta=7.0), np.float32)
    p_out = mt.make_kernel(h147, ratio=Fraction(4, 1), device=dev,
                           store_dtype=torch.bfloat16)
    chunks = range(0, N_HEAD, CHUNK)

    for k in pp.launches:
        pp.launches[k] = 0
    yb = mt.filt(hb, xb, ratio)
    fb = mt.FIRFilter(hb, ratio, device=dev)
    parts_b = [fb.filt(xb[i:i + CHUNK]) for i in chunks]
    yq = mt.filt(hq, xq, ratio)
    fq = mt.quant.QuantizedFIRFilter(h, ratio, x_scale=s_x, device=dev)
    parts_q = [fq.filt(xq[i:i + CHUNK]) for i in chunks]
    y16, _, _ = mt.filt_block(p_out, mt.init_state(p_out), x)
    st, parts_o = mt.init_state(p_out), []
    for i in chunks:
        y, _, st = mt.filt_block(p_out, st, x[i:i + CHUNK])
        parts_o.append(y)
    torch.cuda.synchronize()
    launches = dict(pp.launches)

    blocks = 1 + len(chunks)
    want = dict.fromkeys(pp.launches, 0)
    want.update(bf16=blocks, s8=blocks, f32_bf16out=blocks)
    check(launches == want, f"polyphase launches {launches}, want {want}")
    n_want = mt.outputlength(N_HEAD, ratio)
    t_end = n_want * 160
    end = (t_end % 147 + 1, 1 + t_end // 147 - N_HEAD)
    n_in = mt.inputlength(N_ORACLE, ratio)
    notes = []

    # rational_147_160_bf16
    check(yb.dtype == torch.float32 and tuple(yb.shape) == (n_want,)
          and bool(torch.isfinite(yb).all()), f"bf16 row: filt gave "
          f"{yb.dtype} {tuple(yb.shape)}")
    yc = torch.cat(parts_b)
    check(tuple(yc.shape) == (n_want,) and (fb.state.phase, fb.state.deficit)
          == end, "bf16 row: stream count or state")
    d = yc.double() - yb.double()
    rms_b = float(torch.sqrt(torch.mean(d * d)))
    check(rms_b <= TOL_CHUNKED, f"bf16 row: chunked-vs-whole RMS {rms_b:.3e}")
    ref_b = naivefilt(hb.double().numpy(), xb[:n_in].double().cpu().numpy(),
                      ratio)[:N_ORACLE]
    got_b = yb[:N_ORACLE].double().cpu().numpy()
    rel_b = _rel_rms(got_b, ref_b)
    check(rel_b <= TOL_ORACLE, f"bf16 row: oracle relative RMS {rel_b:.3e}")
    notes.append(
        f"rational_147_160_bf16 on {N_HEAD} -> {n_want}: oracle rel RMS "
        f"{rel_b:.3e} (limit {TOL_ORACLE}) against the same bf16 values, "
        f"{_rel_rms(got_b, ref):.3e} against the float64 design (the mode's "
        f"quantization, no limit); {len(parts_b)} chunks: chunked-vs-whole "
        f"RMS {rms_b:.3e}")

    # rational_147_160_int8
    check(yq.dtype == torch.int32 and tuple(yq.shape) == (n_want,),
          f"int8 row: filt gave {yq.dtype} {tuple(yq.shape)}")
    yqc = torch.cat(parts_q)
    check(tuple(yqc.shape) == (n_want,) and (fq.state.phase,
                                              fq.state.deficit) == end,
          "int8 row: stream count or state")
    check(torch.equal(yqc, yq.to(torch.float32) * fq.y_scale),
          "int8 row: chunked QuantizedFIRFilter differs from the block")
    ref_q = naivefilt(hq.astype(np.float64),
                      xq[:n_in].double().cpu().numpy(), ratio)[:N_ORACLE]
    got_q = yq[:N_ORACLE].cpu().numpy()
    check(np.array_equal(got_q.astype(np.float64), ref_q),
          "int8 row: int32 outputs differ from the integer oracle")
    notes.append(
        f"rational_147_160_int8 on {N_HEAD} -> {n_want}: int32 equal to the "
        f"integer oracle on the first {N_ORACLE}; dequantized rel RMS "
        f"{_rel_rms(got_q * (s_x * s_h), ref):.3e} against the float64 "
        f"design (no limit); {len(parts_q)} chunks bit-identical")

    # interp_4_1_bf16out
    y32 = mt.filt(h147, x, Fraction(4, 1))
    n_out = 4 * N_HEAD
    check(y16.dtype == torch.bfloat16 and tuple(y16.shape) == (n_out,)
          and bool(torch.isfinite(y16).all()),
          f"bf16out row: gave {y16.dtype} {tuple(y16.shape)}")
    ulps = ulps_apart(y16, y32, torch.bfloat16)
    check(ulps <= 1, f"bf16out row: {ulps} bf16 ulps from float32")
    n_diff = int((y16 != y32.to(torch.bfloat16)).sum())
    check(torch.equal(torch.cat(parts_o), y16),
          "bf16out row: chunked differs from the block")
    notes.append(
        f"interp_4_1_bf16out (T = {p_out.taps_per_phi}) on {N_HEAD} -> "
        f"{n_out} bf16: {ulps:g} bf16 ulps at most from the float32 kernel "
        f"(limit 1), {n_diff} outputs differ from its round to nearest; "
        f"{len(parts_o)} chunks bit-identical")
    print(f"[4c quantized slice] {'; '.join(notes)}; launches {launches}")
    return {"bf16": launches["bf16"], "s8": launches["s8"],
            "f32_bf16out": launches["f32_bf16out"]}


def _conv_interp(torch, x2, bank, n):
    """An L//1 interpolator on x2 (1, xlen) as one conv1d with L output
    channels and an interleave (zero history): the PyTorch library
    yardstick. Returns (1, n)."""
    T, L = bank.shape
    xext = torch.nn.functional.pad(x2, (T - 1, 0)).view(1, 1, -1)
    w = bank.t().contiguous().view(L, 1, T)
    y = torch.nn.functional.conv1d(xext, w)
    return y[0].t().reshape(1, -1)[:, :n]


def _conv_dec(torch, x2, bank, M, n):
    """A 1//M decimator (or M = 1, the FIR) on x2 (1, xlen) as one strided
    conv1d (zero history). Returns (1, n)."""
    T = bank.shape[0]
    xext = torch.nn.functional.pad(x2, (T - 1, 0)).view(1, 1, -1)
    return torch.nn.functional.conv1d(xext, bank.view(1, 1, T),
                                      stride=M).view(1, -1)[:, :n]


def phase_quant_times(mt, torch, x, pp, card):
    """bench.py's three quantized rows: kernel vs plain, and conv1d where
    one PyTorch call computes the same function."""
    from multirate_tpu_torch.ops.precision import fp32
    from multirate_tpu_torch.utils.testing import ulps_apart

    h = headline_taps(mt)
    x1 = x.view(1, -1)
    h147 = np.asarray(mt.firdes(147, 0.2, mt.kaiser, beta=7.0), np.float32)
    p_b = mt.make_kernel(torch.from_numpy(h).bfloat16(), ratio=(147, 160),
                         device=x.device)
    p_q = mt.make_kernel(mt.quant.quantize_taps(h)[0], ratio=(147, 160),
                         device=x.device)
    p_o = mt.make_kernel(h147, ratio=4, device=x.device,
                         store_dtype=torch.bfloat16)
    xq = mt.quant.quantize_signal(x1)[0]
    n_r = mt.outputlength(N_HEAD, Fraction(147, 160))
    rows = (("rational_147_160_bf16", "bf16", x1.bfloat16(), p_b, 147, 160,
             n_r, None),
            ("rational_147_160_int8", "s8", xq, p_q, 147, 160, n_r, None),
            ("interp_4_1_bf16out", "f32_bf16out", x1, p_o, 4, 1,
             4 * N_HEAD, torch.bfloat16))
    out, notes = {}, []
    for name, entry, xs, p, L, M, n, store in rows:
        hist = torch.zeros(1, p.h_min, dtype=xs.dtype, device=x.device)
        args = (xs, hist, p.bank, L, M, 1, 1, n)
        yk = pp.polyphase(*args, out_dtype=store)
        yp = pp.polyphase_plain(*args, out_dtype=store)
        torch.cuda.synchronize()
        max_abs = float((yk.double() - yp.double()).abs().max())
        if store is None:
            check(max_abs <= TOL_KERNEL * float(yp.abs().max()),
                  f"{name}: kernel vs plain max abs err {max_abs:.3e}")
        else:
            check(ulps_apart(yk, yp, store, TOL_KERNEL
                             * float(yp.abs().max())) <= 1,
                  f"{name}: kernel vs plain beyond one ulp")
        del yp
        ms = _time_ms(torch, lambda: pp.polyphase(*args, out_dtype=store),
                      iters=20)
        plain_ms = _time_ms(torch, lambda: pp.polyphase_plain(
            *args, out_dtype=store), iters=2)
        library_ms, wide = None, ""
        if L == 4:
            # the same row with float32 stores: what the narrow store saves
            wide_ms = _time_ms(torch, lambda: pp.polyphase(*args), iters=20)
            wide = f", with float32 stores {wide_ms:.4f} ms"

            def lib():
                with fp32():
                    return _conv_interp(torch, x1, p.bank, n).to(store)
            y_lib = lib()
            check(ulps_apart(y_lib, yk, store, TOL_KERNEL * float(
                yk.abs().max())) <= 1, f"{name}: conv1d disagrees")
            del y_lib
            library_ms = _time_ms(torch, lib, iters=5)
        del yk
        kind = {"bf16": "bf16", "s8": "int8"}.get(entry, "f32")
        bound = _polyphase_bound(torch, args,
                                 store or pp.ACCUMULATOR[xs.dtype], kind)
        out[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=library_ms)
        notes.append(
            f"{name} kernel {ms:.4f} ms ({N_HEAD / ms / 1e3:.1f} Msps in)"
            f"{wide}, plain {plain_ms:.4f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound[0]:.4f} ms ({bound[1]}), max abs err {max_abs:.3e}")

    # the library yardstick at phase 5's T = 24 geometries
    g = torch.Generator(device=x.device).manual_seed(0)
    lib_notes = []
    for L, M in GEOMETRIES:
        bank = torch.randn(24, L, generator=g, device=x.device)
        hist = torch.zeros(1, 23, device=x.device)
        n_g = mt.outputlength(N_HEAD, Fraction(L, M))
        if L > 1:
            def lib():
                with fp32():
                    return _conv_interp(torch, x1, bank, n_g)
        else:
            def lib():
                with fp32():
                    return _conv_dec(torch, x1, bank, M, n_g)
        yk = pp.polyphase(x1, hist, bank, L, M, 1, 1, n_g)
        err = float((lib() - yk).abs().max()) / float(yk.abs().max())
        check(err <= TOL_KERNEL, f"conv1d {L}//{M} vs kernel {err:.3e}")
        lib_ms = _time_ms(torch, lib, iters=5)
        bound = _polyphase_bound(torch, (x1, hist, bank, L, M, 1, 1, n_g),
                                 torch.float32, "f32")
        lib_notes.append(f"{L}//{M} {lib_ms:.4f} ms (kernel bound "
                         f"{bound[0]:.4f} ms, {bound[1]})")
    print(f"[5c quantized times] {'; '.join(notes)}; conv1d (TF32 off) at "
          f"T = 24 random taps: {'; '.join(lib_notes)}; card: {card}")
    return out


def _wide_signal(torch, rng, shape, dtype):
    """Seeded standard normal samples in ``dtype`` (re and im if complex)."""
    v = rng.standard_normal(shape)
    if dtype.is_complex:
        v = v + 1j * rng.standard_normal(shape)
    return torch.from_numpy(v).to(dtype)


def _wide_taps(torch, h, dtype):
    """Taps ``h`` in ``dtype``; complex taps take a quarter of the reversed
    taps as their imaginary part."""
    h = np.asarray(h, np.float64)
    if dtype.is_complex:
        h = h + 0.25j * h[::-1]
    return torch.from_numpy(h).to(dtype)


def _entry_state(mt, params, lead, dtype, x, entry):
    """A fresh state, or ("mid") one after setphase(0.37) where the kernel
    has phases and a 1237-sample block of the plain version."""
    st = mt.init_state(params, lead, dtype)
    if entry == "mid":
        if hasattr(params, "nphi"):
            st = mt.setphase(params, st, 0.37)
        _, _, st = mt.filt_block(params, st, x[..., :1237], path="windows")
    return st


def phase_wide_vs_plain(mt, torch, dev, pp, rs):
    """3d: every float64 and complex entry point of both kernels against
    its plain version; time-major blocks of these types run the
    channel-major entry point on the transpose."""
    rng = np.random.default_rng(4)
    h_head = headline_taps(mt)
    h_short = (mt.firdes(24 * 5, 0.5 / 5, mt.kaiser, beta=7.8562) * 5
               ).astype(np.float32)
    rational = [("head", h_head, Fraction(147, 160)),
                ("head", h_head, Fraction(1, 1)),
                ("head", h_head, Fraction(4, 1)),
                ("head", h_head, Fraction(1, 4)),
                ("short", h_short, Fraction(3, 5)),
                ("short", h_short, Fraction(1, 4)),
                ("short", h_short, Fraction(4, 1)),
                ("short", h_short, Fraction(1, 1)),
                # 48 taps per phase: a 110 KB complex128 bank, read from
                # global memory (the others fit in shared memory)
                ("T 48", rng.standard_normal(48 * 147), Fraction(147, 160))]
    ha = bench_taps(mt)
    shapes = tuple((lead[0] if lead else 1, xlen)
                   for lead, xlen in CASE_SHAPES)  # (channels, xlen)
    resample = [("bench taps", ha, rate, nphi, po, shapes)
                for rate in (R_REF, 0.9173, 2.5) for nphi in (32, 7)
                for po in (None, 4)]
    # a (5, 10, 2048) Farrow table, read from global memory in every type
    resample.append(("global table", rng.standard_normal(20_480), 0.9, 2048,
                     4, ((2, 20_011),)))
    worst = dict.fromkeys(WIDE, 0.0)
    n_pp = n_rs = 0
    for entry, (sig_name, taps_name, tol) in WIDE.items():
        sig, tdt = getattr(torch, sig_name), getattr(torch, taps_name)
        for label, h, ratio in rational:
            params = mt.make_kernel(_wide_taps(torch, h, tdt), ratio=ratio,
                                    device=dev)
            if label == "T 48" and entry == "c128c":
                check(params.bank.numel() * 16 > 96 * 1024,
                      "the T 48 complex128 bank fits in shared memory")
            for lead, xlen in CASE_SHAPES:
                x = _wide_signal(torch, rng, (*lead, xlen), sig).to(dev)
                for state in ("fresh", "mid"):
                    st = _entry_state(mt, params, lead, sig, x, state)
                    case = f"{entry} {label} {ratio} lead={lead} {state}"
                    before = pp.launches[entry]
                    err = _compare(mt, torch, params, st, x, False, case, tol)
                    check(pp.launches[entry] == before + 1,
                          f"{case}: {entry} not launched once")
                    worst[entry] = max(worst[entry], err)
                    n_pp += 1
        for label, h, rate, nphi, po, shp in resample:
            params = mt.make_kernel(_wide_taps(torch, h, tdt), rate=rate,
                                    nphi=nphi, polyorder=po, device=dev)
            for ch, xlen in shp:
                x = _wide_signal(torch, rng, (ch, xlen), sig).to(dev)
                xt = x.t().contiguous()
                for state in ("fresh", "mid"):
                    st = _entry_state(mt, params, (ch,), sig, x, state)
                    for tm in (False, True):
                        case = (f"{entry} {label} "
                                f"{'arbitrary' if po is None else 'Farrow'} "
                                f"rate={rate:.6g} nphi={nphi} C={ch} {state} "
                                f"{'time' if tm else 'channel'}-major")
                        before = (rs.launches[entry], rs.launches_tm)
                        err = _compare(mt, torch, params, st,
                                       xt if tm else x, tm, case, tol)
                        check((rs.launches[entry], rs.launches_tm)
                              == (before[0] + 1, before[1]),
                              f"{case}: {entry} not launched once")
                        worst[entry] = max(worst[entry], err)
                        n_rs += 1
    print(f"[3d wide vs plain] {n_pp} polyphase and {n_rs} resample cases "
          f"(time-major ones through the channel-major entry point), counts "
          f"and states exact; worst max|dy|/max|y|: "
          + ", ".join(f"{e} {worst[e]:.3e} (limit {WIDE[e][2]:g})"
                      for e in WIDE))


def phase_wide_slice(mt, torch, dev, pp, rs, x, ref):
    """4d: ``bench.py``'s rows ``rational_147_160_c64`` and
    ``rational_147_160_f64`` at full width, and arbitrary and Farrow on the
    same samples in float64. ``x`` is phase 4's float32 block (the real
    parts) and ``ref`` its float64 oracle for the float32 headline taps.
    The oracles run on the host in threads while the card works; the
    complex128 ``naivefilt`` of the complex64 row goes by linearity, as
    phase 4's real part plus i times the oracle of the imaginary parts."""
    from concurrent.futures import ThreadPoolExecutor

    from multirate_tpu_torch.ops import indexing as idx
    from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow

    ratio = Fraction(147, 160)
    h32 = headline_taps(mt)
    h64 = mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
    ha64 = mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32
    im = torch.from_numpy(np.random.default_rng(5).standard_normal(
        N_HEAD).astype(np.float32)).to(dev)
    xc = torch.complex(x, im)
    x64 = x.double()
    x64_np = x64.cpu().numpy()
    p_arb = mt.make_kernel(ha64, rate=R_REF, nphi=32, device=dev)
    p_far = mt.make_kernel(ha64, rate=0.4709, nphi=32, polyorder=4,
                           device=dev)
    n_in = mt.inputlength(N_ORACLE, ratio)
    n_arb = mt.inputlength(p_arb, N_ORACLE)
    n_far = mt.inputlength(p_far, N_ORACLE)
    chunks = range(0, N_HEAD, CHUNK)

    with ThreadPoolExecutor(4) as pool:
        oracles = {
            "c64": pool.submit(naivefilt, h32.astype(np.float64),
                               im[:n_in].double().cpu().numpy(), ratio),
            "f64": pool.submit(naivefilt, h64, x64_np[:n_in], ratio),
            "arbitrary": pool.submit(naivefilt, ha64, x64_np[:n_arb], R_REF,
                                     32),
            "Farrow": pool.submit(naivefilt_farrow, ha64, x64_np[:n_far],
                                  0.4709, 32, 4)}
        for k in pp.launches:
            pp.launches[k] = 0
        for k in rs.launches:
            rs.launches[k] = 0
        rs.launches_tm = 0
        runs = []  # (label, whole block, chunk outputs, stream, samples)
        for label, h, spec, xs in (("rational_147_160_c64", h32, (ratio,), xc),
                                   ("rational_147_160_f64", h64, (ratio,),
                                    x64),
                                   ("arbitrary", ha64, (R_REF, 32), x64),
                                   ("Farrow", ha64, (0.4709, 32, 4), x64)):
            y = mt.filt(h, xs, *spec)
            f = mt.FIRFilter(h, *spec)
            runs.append((label, y, [f.filt(xs[i:i + CHUNK]) for i in chunks],
                         f, xs))
        torch.cuda.synchronize()
        launches = (dict(pp.launches), dict(rs.launches), rs.launches_tm)
        refs = {k: v.result() for k, v in oracles.items()}

    blocks = 1 + len(chunks)
    want = (dict.fromkeys(pp.launches, 0), dict.fromkeys(rs.launches, 0), 0)
    want[0].update(c64=blocks, f64=blocks)
    want[1].update(f64=2 * blocks)
    check(launches == want, f"launches {launches}, want {want}")
    refs["c64"] = ref + 1j * refs["c64"][:N_ORACLE]
    refs["f64"] = refs["f64"][:N_ORACLE]
    limits = {"rational_147_160_c64": ("c64", TOL_ORACLE, TOL_CHUNKED),
              "rational_147_160_f64": ("f64", TOL_ORACLE_F64,
                                       TOL_CHUNKED_F64),
              "arbitrary": ("arbitrary", TOL_ORACLE_ARB_REF, TOL_CHUNKED_F64),
              "Farrow": ("Farrow", TOL_ORACLE_FARROW_F64, TOL_CHUNKED_F64)}
    notes = []
    for label, y, parts, f, xs in runs:
        key, tol_oracle, tol_chunked = limits[label]
        n_want = mt.outputlength(f.params, N_HEAD)
        check(y.dtype == xs.dtype and tuple(y.shape) == (n_want,)
              and bool(torch.isfinite(y).all()),
              f"{label}: filt gave {y.dtype} {tuple(y.shape)}")
        yc = torch.cat(parts)
        # the stream ends in the state one block's closed form gives
        _, ph_end, d_end = idx.host_carry(
            f.params, 1 if key in ("c64", "f64") else 0, 1, N_HEAD)
        check(tuple(yc.shape) == (n_want,)
              and (f.state.phase, f.state.deficit) == (ph_end, d_end),
              f"{label}: stream count or state")
        rms_chunk = float((yc - y).abs().pow(2).mean().sqrt())
        check(rms_chunk <= tol_chunked,
              f"{label}: chunked-vs-whole RMS {rms_chunk:.3e}")
        ref_l = refs[key][:N_ORACLE]
        check(len(ref_l) == N_ORACLE, f"{label}: oracle gave {len(ref_l)}")
        rel = _rel_rms(y[:N_ORACLE].cpu().numpy(), ref_l)
        check(rel <= tol_oracle, f"{label}: oracle relative RMS {rel:.3e}")
        notes.append(f"{label} ({y.dtype}) on {N_HEAD} -> {n_want}: oracle "
                     f"rel RMS {rel:.3e} (limit {tol_oracle:g}); {len(parts)} "
                     f"chunks: chunked-vs-whole RMS {rms_chunk:.3e} (limit "
                     f"{tol_chunked:g})")
    print(f"[4d wide slice] {'; '.join(notes)}; launches polyphase "
          f"{ {k: v for k, v in launches[0].items() if v} }, resample "
          f"{ {k: v for k, v in launches[1].items() if v} }")
    return xc, x64, {"polyphase_c64": launches[0]["c64"],
                     "polyphase_f64": launches[0]["f64"],
                     "resample_f64": launches[1]["f64"]}


def phase_wide_times(mt, torch, xc, x64, pp, rs, card):
    """5d: kernel vs plain for the two rows, for arbitrary and Farrow in
    float64, and for the three narrow-store entry points that no bench row
    runs, at ``interp_4_1_bf16out``'s geometry (with the conv1d yardstick
    there)."""
    from multirate_tpu_torch.ops.precision import fp32
    from multirate_tpu_torch.utils.testing import ulps_apart

    dev = x64.device
    h32 = headline_taps(mt)
    h64 = mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
    ha64 = mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32
    n_r = mt.outputlength(N_HEAD, Fraction(147, 160))
    out, notes = {}, []

    def timed(name, kern, plain, args, bound, tol, lib=None):
        yk, yp = kern(*args), plain(*args)
        torch.cuda.synchronize()
        max_abs = float((yk - yp).abs().max())
        check(max_abs <= tol * float(yp.abs().max()),
              f"{name}: kernel vs plain max abs err {max_abs:.3e}")
        del yk, yp
        ms = _time_ms(torch, lambda: kern(*args), iters=20)
        plain_ms = _time_ms(torch, lambda: plain(*args), iters=2)
        library_ms = None if lib is None else _time_ms(torch, lib, iters=5)
        out[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=library_ms)
        notes.append(
            f"{name} kernel {ms:.4f} ms ({N_HEAD / ms / 1e3:.1f} Msps in), "
            f"plain {plain_ms:.4f} ms, library "
            f"{'none' if lib is None else f'{library_ms:.4f} ms'}, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), max abs err {max_abs:.3e}")

    for name, h, xs, kind in (("rational_147_160_c64", h32, xc, "f32"),
                              ("rational_147_160_f64", h64, x64, "f64")):
        p = mt.make_kernel(h, ratio=(147, 160), device=dev)
        hist = torch.zeros(1, p.h_min, dtype=xs.dtype, device=dev)
        args = (xs.view(1, -1), hist, p.bank, 147, 160, 1, 1, n_r)
        timed(name, pp.polyphase, pp.polyphase_plain, args,
              _polyphase_bound(torch, args, xs.dtype, kind),
              WIDE["c64" if kind == "f32" else "f64"][2])
    for name, rate, po in (("arbitrary_refrate_f64", R_REF, None),
                           ("farrow_0.4709_f64", 0.4709, 4)):
        p = mt.make_kernel(ha64, rate=rate, nphi=32, polyorder=po,
                           device=dev)
        hist = torch.zeros(1, p.h_min, dtype=torch.float64, device=dev)
        n = mt.outputlength(p, N_HEAD)
        args = (x64.view(1, -1), hist, p, 0, 1, n)
        # x, history and table read once, outputs written once; each
        # output takes T * (P + 1) multiply-adds (arbitrary: P = 1)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x64, hist, p.bank)) + n * 8
        timed(name, rs.resample, rs.resample_plain, args,
              _bound(nbytes, n * p.bank.numel() // p.nphi, "f64"),
              WIDE["f64"][2])

    # the narrow stores no bench row runs, at interp_4_1_bf16out's shapes
    h147 = np.asarray(mt.firdes(147, 0.2, mt.kaiser, beta=7.0), np.float32)
    x1 = x64.view(1, -1).float()
    for entry, dt, store in (("f32_f16out", torch.float32, torch.float16),
                             ("bf16_bf16out", torch.bfloat16, torch.bfloat16),
                             ("bf16_f16out", torch.bfloat16, torch.float16)):
        p = mt.make_kernel(torch.from_numpy(h147).to(dt), ratio=4,
                           device=dev, store_dtype=store)
        xs = x1.to(dt)
        hist = torch.zeros(1, p.h_min, dtype=dt, device=dev)
        args = (xs, hist, p.bank, 4, 1, 1, 1, 4 * N_HEAD)
        check(pp.ENTRIES[dt, dt, store] == entry, f"{entry}: entry point")
        yk = pp.polyphase(*args, out_dtype=store)
        yp = pp.polyphase_plain(*args, out_dtype=store)

        def lib(xs=xs, p=p, store=store):
            # bf16 products are exact in float32: the same function
            with fp32():
                return _conv_interp(torch, xs.float(), p.bank.float(),
                                    4 * N_HEAD).to(store)
        y_lib = lib()
        torch.cuda.synchronize()
        floor = TOL_KERNEL * float(yp.abs().max())
        check(ulps_apart(yk, yp, store, floor) <= 1,
              f"{entry}: kernel vs plain beyond one ulp")
        check(ulps_apart(y_lib, yk, store, floor) <= 1,
              f"{entry}: conv1d disagrees")
        max_abs = float((yk.double() - yp.double()).abs().max())
        del yk, yp, y_lib
        ms = _time_ms(torch, lambda: pp.polyphase(*args, out_dtype=store),
                      iters=20)
        plain_ms = _time_ms(torch, lambda: pp.polyphase_plain(
            *args, out_dtype=store), iters=2)
        library_ms = _time_ms(torch, lib, iters=5)
        bound = _polyphase_bound(torch, args, store,
                                 "bf16" if dt == torch.bfloat16 else "f32")
        notes.append(
            f"interp_4_1 {entry} kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {library_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}), max abs err {max_abs:.3e}")
    print(f"[5d wide times] {'; '.join(notes)}; card: {card}")
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
        phase_quant_vs_plain(mt, torch, dev, pp)
        phase_wide_vs_plain(mt, torch, dev, pp, rs)
        h, x, launches, ref = phase_slice(mt, torch, dev, pp)
        xa, x64, rs_launches = phase_resample_slice(mt, torch, dev, rs)
        q_launches = phase_quant_slice(mt, torch, dev, pp, x, ref)
        xc, xd, w_launches = phase_wide_slice(mt, torch, dev, pp, rs, x, ref)
        max_abs, ms, plain_ms, bound = phase_times(mt, torch, h, x, pp,
                                                   card)
        rows = phase_resample_times(mt, torch, xa, x64, rs, card)
        q_rows = phase_quant_times(mt, torch, x, pp, card)
        w_rows = phase_wide_times(mt, torch, xc, xd, pp, rs, card)
        check("jax" not in sys.modules, "jax was imported")
    except Exception:  # the smoke's boundary: report and fail
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1
    cm_rows = [r for r in rows if r != "farrow_64ch_tmajor"]
    zc = "multirate_tpu/ops/pallas/rational2.py:836"
    kernels = [{
        "name": "polyphase_f32",
        "route": "cuda",
        "source": "multirate_tpu_torch/csrc/polyphase.cu",
        "replaces": zc,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
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
        "bound_ms": rows["arbitrary_refrate"][3][0],
        "bound_by": rows["arbitrary_refrate"][3][1],
        "library_ms": None,
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
        "bound_ms": rows["farrow_64ch_tmajor"][3][0],
        "bound_by": rows["farrow_64ch_tmajor"][3][1],
        "library_ms": None,
    }]
    for entry, row, replaces in (
            ("bf16", "rational_147_160_bf16",
             f"{zc}, multirate_tpu/ops/pallas/rational2.py:181"),
            ("s8", "rational_147_160_int8", zc),
            ("f32_bf16out", "interp_4_1_bf16out", zc)):
        kernels.append({"name": f"polyphase_{entry}", "route": "cuda",
                        "source": "multirate_tpu_torch/csrc/polyphase.cu",
                        "replaces": replaces,
                        "launches": q_launches[entry], **q_rows[row]})
    # the float64 and complex entry points the rows of phase 4d launch
    dense = "multirate_tpu/ops/pallas/rational.py:89"
    for name, row, source, replaces in (
            ("polyphase_c64", "rational_147_160_c64", "polyphase",
             f"{zc}, {dense}"),
            ("polyphase_f64", "rational_147_160_f64", "polyphase",
             f"multirate_tpu/ops/pallas/rational2.py:181, {dense}"),
            ("resample_f64", "arbitrary_refrate_f64", "resample",
             "multirate_tpu/ops/pallas/select.py:74, "
             "multirate_tpu/ops/pallas/select.py:163")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"multirate_tpu_torch/csrc/{source}.cu",
                        "replaces": replaces, "launches": w_launches[name],
                        **w_rows[row]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
