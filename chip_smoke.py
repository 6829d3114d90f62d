#!/usr/bin/env python3
"""Smoke test of the multirate_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card: the 48 kHz -> 44.1 kHz rational
resample ``filt(h, x, Fraction(147, 160))`` with 24*147 Kaiser taps on
float32, arbitrary-rate and Farrow resampling with ``bench.py``'s 320-tap
bank (nphi 32, 10 taps per phase), and the runtime that streams chunks
through them (``io``, ``models``, ``utils``). It runs in phases; each
prints one line:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the polyphase, resample and probe kernels from
   ``multirate_tpu_torch/csrc``, one nvcc each, and the host ring buffer
   with g++, all started together, and prints ptxas's registers and
   spills for each instantiation;
3. kernel vs plain version on the card, for the four rational-family
   filter types at the headline taps and at short taps, plus a bank too
   large for shared memory and a wide decimation, fresh and mid-phase
   entry states, one channel and two channels at xlen 80007: counts and
   states equal exactly, outputs within 1e-5 * max|y|; then the kernel's
   variants (``polyphase.plan``: ``reg``, ``slide``, ``bcast``, and the
   ``general`` one forced) against the plain version at VARIANT_GEOMETRIES
   (each compiled T, L = 1, T outside the set, Q over a block's threads, a
   bank over shared memory), fresh and mid-phase, one and two channels at
   xlen 80,007, with all outputs, 1, 33 and one more than a tile, each
   launch counted by entry point and variant (3c and 3d do the same for
   their entry points);
4. the slice at full size: one 8 M-sample block through ``filt`` (relative
   RMS against the float64 ``naivefilt`` oracle on the first 200 000
   outputs <= 8e-5) and the same samples through ``FIRFilter`` in 250 000-
   sample chunks (counts and state equal, chunked-vs-whole RMS <= 1e-6),
   with the kernel's launch count read around these two runs alone (all
   through the register variant);
5. times: kernel and plain version at the headline block, CUDA events,
   median of 7 runs after a warm-up; the kernel alone for one launch
   after a 256 MB write that evicts the 50 MB L2, and at 1//1, 4//1 and
   1//4 with T = 24 random taps on the same 8 M samples, and one
   65,536-sample block; every polyphase time here and in 5c-5e is taken
   for the planned variant and for the general one in turn.

Then the same three steps for the arbitrary/Farrow path:

3b. resample kernel vs plain version, arbitrary and Farrow, channel-major
   and time-major, at rates 1/2.123456789, 0.4709, 0.9173, 1.0, 1.313 and
   2.5, nphi 32 and 7, 1 and 64 channels, fresh and after setphase(0.37)
   and one block; plus nphi 1024 at rate 0.3 past 2^20 outputs, a Farrow
   table too large for shared memory, rate 0.01, whose spans shrink the
   tile, and ``models.Resampler``'s 73 taps a phase at 1/2.123456789 and
   0.9173 on 1 and 3 channels: counts and states exact, outputs within
   1e-5 * max|y|; every case also straight through the kernel's wrapper
   with the variant ``resample.plan`` picks (``t10p2``, ``t10p5``,
   ``t73p2`` or ``general``) and with the general one forced, each against
   the plain version and the two equal bit for bit, each launch counted
   by entry point and variant;
4b. the slice at full width: ``filt`` and ``FIRFilter`` in 250 000-sample
   chunks on 8 M samples, arbitrary at 1/2.123456789 and Farrow at
   0.4709; 64-channel Farrow at 0.9173 on (64, 125 000) through ``filt``
   and through ``filt_block_tm`` on the transposed samples. Chunked-vs-
   whole RMS <= 1e-6, time-major == channel-major within 1e-6 * max|y|,
   relative RMS against the float64 oracles on the first 200 000 outputs
   (``naivefilt`` <= 1e-4 for arbitrary at 1/2.123456789, the reference's
   dh wrap floor; ``naivefilt_farrow`` <= 8e-5), and each wrapper's launch
   count around these runs equal to the number of blocks, each row through
   its compiled variant (``t10p2`` arbitrary, ``t10p5`` Farrow);
5b. times of kernel (the planned variant and the general one, in turns)
   and plain version for ``bench.py``'s six arbitrary/Farrow rows, as in
   phase 5, and for arbitrary resampling at 0.9173 on the 64 channels
   (no bench row: the shape of the channel-batched TPU kernel 6).

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
   T = 24 beside phase 5's kernel times); and ``bench.py``'s
   ``standard_147taps`` and ``decim_1_4`` (``firdes(147, 0.2, kaiser,
   beta=7.0)`` at 1//1 and 1//4 on the 8 M samples) with ``conv1d``.

Then the same three steps for the float64 and complex modes of every
filter type (``bench.py``'s rows ``rational_147_160_c64`` and
``rational_147_160_f64``), which run the ``f64``, ``c64``, ``c64c``,
``c128`` and ``c128c`` instantiations of both kernels:

3d. each of those entry points of both kernels against its plain version:
   the four rational-family types at the headline and short taps and a
   147//160 bank of 48 taps per phase (a complex128 bank too large for
   shared memory); arbitrary and Farrow at rates 1/2.123456789, 0.9173 and
   2.5, nphi 32 and 7, 9 channels at 1/2.123456789 (blocks of 8 channels
   sharing taps, and one), and a Farrow table in global memory; fresh and
   mid-phase, one channel and two, channel-major and time-major (which
   runs the channel-major entry point on the transpose). Counts and states
   exact; outputs within 1e-5 * max|y| (complex64) or 1e-12 * max|y|
   (float64, complex128); the channel-major resample cases also through
   the planned and the general variant, equal bit for bit;
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
   point's launch count around these runs equal to the number of blocks
   (the resample rows through ``f64/t10p2`` and ``f64/t10p5``);
5d. times of kernel and plain version for the two rows and for arbitrary
   and Farrow in float64, as in phase 5, and for the three narrow-store
   entry points no bench row runs (``f32_f16out``, ``bf16_bf16out``,
   ``bf16_f16out``) at ``interp_4_1_bf16out``'s geometry, with the
   ``conv1d`` yardstick there.

Then the same three steps for the runtime and its probe kernels
(``csrc/probe.cu``, the copy and expand ceilings of ``utils/metrics.py``):

3e. the probe kernels against their plain versions: copies of float32,
   bfloat16, int8 and complex128 at lengths that are and are not
   multiples of 16 bytes, from sources at element offsets 0, 1 and 3;
   expands of float32 rows of 4, 12, 20 and 128 floats at ratios 1, 2, 4
   and 8 with float32, bfloat16, float16 and int8 stores. Outputs equal
   bit for bit;
4e. the runtime at full width: phase 4's 8 M samples pushed in seeded
   random chunks of 100-5000 samples through
   ``io.StreamingResampler(models.DATToCD(device="cuda"))`` (blocks of
   65,536) and flushed, the push loop under
   ``torch.cuda.set_sync_debug_mode("error")``; the same through
   ``models.Resampler(1/2.123456789)`` with its own designed taps; each
   stream's count equal to ``filt`` of the whole block and chunked-vs-whole
   RMS <= 1e-6. A kill and resume of the headline stream (a checkpoint
   every 16 blocks, the ``StreamingResampler`` deleted at 60% of the
   stream, resumed and re-fed from the consumed offset): prefix and tail
   equal to the uninterrupted stream bit for bit. Each wrapper's launch
   count around these streams equal to their blocks plus one flush each
   (the ``Resampler`` stream's through ``f32/t73p2``).
   ``utils.check_block`` on the card for the four rational-family types,
   arbitrary and Farrow (rtol 1e-4, atol 1e-5 of max|y|); a
   ``utils.trace`` of one ``DATToCD`` block inside
   ``utils.annotate("resample-block")`` whose Chrome trace holds the
   annotation and a kernel event of the register variant,
   ``polyphase_reg<entry::mr_polyphase_f32, ...>``. Prints
   ``stats()``, the stream's rate (Msps in, from the first push to the
   end of ``flush``) and one block's kernel time alone (CUDA events; the
   resample block also with the general variant), the share of the
   stream's wall time that the kernels fill;
5e. times: ``utils.metrics.stream_copy_gbps()`` (32 M float32) and
   ``stream_expand_gbps()`` (8 M inputs at 1:4) with each store type, as
   GB/s and as a share of 3.35 TB/s (over 105% fails: the probe would be
   reading the cache; these ceilings are the denominators of every "% of
   copy ceiling"), with each probe's launch count over those calls;
   each probe kernel after an L2 eviction (a 256 MB write; the expand
   probe also after a 256 MB read, which leaves the L2 no dirty lines to
   write back) against its bound, its plain version and ``Tensor.copy_``
   / ``torch.cat`` for the float32 store / one casting copy of the
   broadcast rows for bf16 and f16 (none for int8, whose scale and clamp
   take more calls); ``measure_chained`` on the 8 M
   headline block (Msps, roofline fraction against ``KNOWN_HBM_GBPS`` and
   against the measured copy ceiling); and kernel against plain version
   for the five entry points no earlier phase times (``mr_polyphase_c128``
   at 147//160; ``mr_resample_c64``, ``_c64c``, ``_c128``, ``_c128c`` at
   1/2.123456789 with ``bench.py``'s bank), on 8 M samples; every
   resample time here and in 5d for the planned and the general variant.

Then the parallel layer (``parallel``: channel x time sharding), on a
gloo world of 4 ranks all on ``cuda:0`` (NCCL refuses two ranks on one
card, so the halo and the history cross through the host; every kernel
runs on the card; the kernels are built here before the spawn and the
ranks load them):

3f. on meshes (2, 2), (1, 4) and (4, 1): ``sharded_resample`` at 1//1,
   4//1, 1//4, 7//5 and 147//160 with 48 random taps, arbitrary at 0.8112
   and 1.618 in float64, Farrow at 0.9173 (nphi 32, polyorder 4) on 64
   channels, and 7//5 streamed in three super-blocks through
   ``shard_filt_block`` + ``compact``; bf16 and int8 147//160 on (2, 2);
   each against ``filt`` of the whole signal on the card: counts and
   states exact, outputs within 1e-5 * max|y| (int8 equal, bf16 within
   2^-8 * max|y|); a block shorter than h_min raises ``ValueError`` on
   every rank; each rank's launch count per case equal to its blocks
   (the world's: shards x blocks);
4f. at full width: the 8 M headline over (1, 4) (2,000,000 samples a
   shard), the same samples in three streamed super-blocks, and
   ``MultiChannelResampler(0.9173, nphi=32, polyorder=4)`` on (64,
   125,000) over (4, 1) and (2, 2), each within 1e-6 * max|y| of the
   unsharded ``filt`` on the card, relative RMS against the float64
   oracles on the first 200,000 outputs (a channel) <= 8e-5, counts and
   states exact; then a world of one with the ``nccl`` backend: the
   headline through ``sharded_resample`` on (1, 1), equal to ``filt``,
   and 8 steady-state blocks through ``shard_filt_block`` +
   ``compact_device`` under ``torch.cuda.set_sync_debug_mode("error")``;
5f. each rank's per-shard kernel time (CUDA events, the kernels in turn)
   and halo time (halo exchange and history broadcast, all ranks
   together, on the host clock between synchronizes) for the headline on
   (1, 4); and ``parallel.scaling_bench --device cuda --ranks 4``
   (its JSON: the work overhead of the sharded step over the unsharded
   one; wall-clock fields are a sanity check only, since the ranks share
   one card).

Then bf16 and int8 signals at an arbitrary or Farrow rate (widened to
float32 with one cast each, then the float32 resample kernel):

3g. the widened route against its plain version on the card, arbitrary
   and Farrow at 1/2.123456789, 0.4709 and 0.9173, 1 and 64 channels,
   fresh and after setphase(0.37): counts and states exact, outputs
   within 1e-5 * max|y|;
4g. 8 M bf16 samples at 1/2.123456789 (arbitrary) and 0.4709 (Farrow)
   with ``bench.py``'s bank through ``filt`` and ``FIRFilter`` in
   250,000-sample chunks: relative RMS against ``naivefilt`` over the
   same bf16 values <= 1e-4 (the method's floor) and against
   ``naivefilt_farrow`` <= 8e-5, chunked-vs-whole RMS <= 1e-6, launches
   equal to the blocks; times of the route (cast and kernel), the kernel
   alone on the widened values, the float32 row on the same values and
   the plain version, for bf16 and int8 in;
4h. every example flow of ``multirate_tpu_torch.examples`` on the card
   (``main()``, with ``tests/test_examples.py``'s shrink keywords for
   ``arb_farrow_speed``), each with its kernel launches counted, and
   ``wav_resample --demo``'s 1 kHz amplitude within 0.45-0.55.

Then a JSON line of the kernels (each with its bound: the larger of the
bytes it must move over 3.35 TB/s and its multiply-adds over the card's
peak for their type; a polyphase or resample row also with the variant it
launched and the general variant's time; one expand row for each store
type; this slice's two rows: ``polyphase_f32_sharded``, the headline's
shard on (1, 4) with its launches summed over the ranks, and
``resample_f32_bf16in``, the widened route at 1/2.123456789), the
``nvidia-smi`` name and power-limit line,
and as the last line ``{"ok": true, "device": {...}}``. Any failure exits
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
# 3e: copy lengths (elements) and source offsets, expand shapes and ratios
PROBE_COPY_LENGTHS = (0, 1, 7, 15, 16, 17, 4096, 1_000_003, 4_194_304)
PROBE_OFFSETS = (0, 1, 3)
# rows of 4, 12, 20 and 128 floats: every 16-byte store aligned, or not
PROBE_EXPAND_SHAPES = ((1, 128), (777, 128), (65_536, 128), (33, 4),
                       (45, 12), (29, 20), (1001, 20))
PROBE_RATIOS = (1, 2, 4, 8)
MAX_CEILING_SHARE = 1.05  # a probe over 105% of 3.35 TB/s reads the cache
STREAM_CHUNKS = (100, 5000)  # 4e: seeded chunk sizes pushed to the ring
# 3, 3c, 3d: the polyphase kernel's variants, each against the plain
# version: (T, L, M) at each compiled T of the register variant (24 at
# 147//160, 37 at 7//6) and of the sliding one (37 and 24 at 4//1), L = 1
# (broadcast) at T = 147 and 24, and the general variant's geometries
# (T = 30 outside the set; Q = 1031, more groups than a block's threads;
# 48 taps, a complex128 bank over 96 KB)
VARIANT_GEOMETRIES = ((24, 147, 160), (37, 7, 6), (37, 4, 1), (24, 4, 1),
                      (147, 1, 1), (147, 1, 4), (24, 1, 1), (30, 1000, 999),
                      (24, 1031, 1030), (48, 147, 160))
VARIANT_XLEN = 80_007


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

    # three CUDA sources (nvcc) and the host ring buffer (g++)
    names = ("polyphase", "resample", "probe", "mr_ring")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    build.load_polyphase()
    build.load_resample()
    build.load_probe()
    secs = time.perf_counter() - t0
    for lib in libs:
        rows = _ptxas_rows((lib.parent / "build.log").read_text())
        spills = [f"{k} {sp}" for k, _, sp in rows if sp != "0/0"]
        print(f"[2 build] {lib.relative_to(build.BUILD_DIR.parent)}; "
              f"ptxas, registers (spill stores/loads, bytes) by "
              f"instantiation: "
              + (" | ".join(f"{k} {r} ({sp})" for k, r, sp in rows)
                 or "none (host code)")
              + f"; spills: {' | '.join(spills) or 'none'}")
    print(f"[2 build] {len(names)} libraries built in parallel in "
          f"{secs:.1f} s")


def _ptxas_rows(log):
    """(instantiation, registers, "spill stores/spill loads") for each
    kernel of an nvcc -Xptxas=-v log, the instantiation demangled by
    c++filt where the toolkit's host has it, template arguments kept."""
    import re
    import shutil

    rows, name, spill = [], None, "0/0"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([name, int(m.group(1)), spill])
            name, spill = None, "0/0"
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, check=False)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, full in zip(rows, names):
                # kernel<template args>, without namespaces and parameters
                full = re.sub(r"\(anonymous namespace\)::|entry::", "", full)
                r[0] = re.sub(r"^void |\((?!anonymous).*\)$", "", full)
    return [tuple(r) for r in rows]


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


def _resample_variants(mt, torch, rs, params, st, x, time_major, case,
                       tol=TOL_KERNEL):
    """The resample kernel on one block, through the variant ``plan``
    picks and through the general one, each against the plain version
    (within ``tol`` of max|y|) and the two equal bit for bit, each launch
    counted once by entry point and variant. Returns (max error, the
    planned variant)."""
    from multirate_tpu_torch.ops import indexing as idx

    xlen = x.shape[0] if time_major else x.shape[-1]
    n, _, _ = idx.host_carry(params, st.phase, st.deficit, xlen)
    args = (x, st.history.to(x.dtype).contiguous(), params, st.phase,
            st.deficit, n)
    kern = rs.resample_tm if time_major else rs.resample
    plain = rs.resample_tm_plain if time_major else rs.resample_plain
    want = plain(*args)
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    entry = "tm" if time_major else rs.ENTRIES[x.dtype, params.table.dtype]
    got, err = {}, 0.0
    planned = _resample_plan(rs, args, time_major).variant
    for variant in (None, "general"):
        key = f"{entry}/{variant or planned}"
        before = rs.launches_by_variant[key]
        got[variant] = kern(*args, variant=variant)
        torch.cuda.synchronize()
        check(rs.launches_by_variant[key] == before + 1,
              f"{case} {key}: not launched once")
        check(got[variant].dtype == want.dtype
              and got[variant].shape == want.shape,
              f"{case} {key}: {got[variant].dtype} "
              f"{tuple(got[variant].shape)}")
        if want.numel():
            e = float((got[variant] - want).abs().max()) / scale
            check(e <= tol, f"{case} {key}: rel err {e:.3e}")
            err = max(err, e)
    check(torch.equal(got[None], got["general"]),
          f"{case}: {planned} and general differ")
    return err, planned


def _resample_plan(rs, args, time_major, variant=None):
    """The plan of one resample call on ``args`` (x, hist, params, u0, d0,
    n_out)."""
    x, _, p, _, _, n = args
    C = x.shape[1] if time_major else x.shape[0]
    return rs.plan(p.taps_per_phi, p.table.shape[0], p.nphi, p.delta_fx, n,
                   C, x.dtype, p.table.dtype, time_major, variant)


def _variant_matrix(torch, dev, pp, entries):
    """Each of ``entries`` (polyphase entry points) through the variant
    ``plan`` picks and through the general variant, against the plain
    version, at VARIANT_GEOMETRIES: one channel and two at xlen 80,007,
    fresh and mid-phase entry states, all outputs, 1, 33 and one more than
    a tile. Checks that the planned variant was launched. Returns (cases,
    {entry: worst error}, {variant: launches})."""
    from multirate_tpu_torch.utils.testing import ulps_apart

    rng = np.random.default_rng(7)
    dtypes = {name: key for key, name in pp.ENTRIES.items()}
    worst, used, n_cases = dict.fromkeys(entries, 0.0), {}, 0
    for entry in entries:
        x_dt, b_dt, o_dt = dtypes[entry]
        tol = 1e-12 if x_dt in (torch.float64, torch.complex128) else \
            TOL_KERNEL
        for T, L, M in VARIANT_GEOMETRIES:
            bank = _probe_source(torch, rng, (T, L), b_dt).to(dev)
            x = _probe_source(torch, rng, (2, VARIANT_XLEN), x_dt).to(dev)
            hist = _probe_source(torch, rng, (2, T - 1), x_dt).to(dev)
            for C, state, count in ((1, "fresh", "all"), (2, "mid", "all"),
                                    (1, "mid", 1), (2, "fresh", 33),
                                    (1, "fresh", "tile+1")):
                phi0, d0 = (1, 1) if state == "fresh" else (L // 2 + 1, 3)
                n_all = ((VARIANT_XLEN - d0) * L - (phi0 - 1)) // M + 1
                if count == "tile+1":
                    count = pp.plan(T, L, M, n_all, x_dt, b_dt,
                                    C).tile_outputs + 1
                n = n_all if count == "all" else min(count, n_all)
                args = (x[:C], hist[:C], bank, L, M, phi0, d0, n)
                yp = pp.polyphase_plain(*args, out_dtype=o_dt)
                floor = tol * max(float(yp.abs().max()), 1e-30)
                for variant in (None, "general"):
                    p = pp.plan(T, L, M, n, x_dt, b_dt, C, variant)
                    key = f"{entry}/{p.variant}"
                    before = pp.launches_by_variant[key]
                    y = pp.polyphase(*args, out_dtype=o_dt, variant=variant)
                    torch.cuda.synchronize()
                    case = (f"{key} T={T} {L}//{M} C={C} {state} n={n}")
                    check(pp.launches_by_variant[key] == before + 1,
                          f"{case}: not launched once")
                    check(y.dtype == yp.dtype and y.shape == yp.shape,
                          f"{case}: {y.dtype} {tuple(y.shape)}")
                    if x_dt == torch.int8:
                        err = float((y - yp).abs().max())
                        check(err == 0, f"{case}: int8 differs by {err}")
                    elif o_dt in (torch.bfloat16, torch.float16):
                        err = ulps_apart(y, yp, o_dt, floor)
                        check(err <= 1, f"{case}: {err} ulps apart")
                    else:
                        err = float((y - yp).abs().max()) / max(
                            float(yp.abs().max()), 1e-30)
                        check(err <= tol, f"{case}: rel err {err:.3e}")
                    worst[entry] = max(worst[entry], err)
                    used[p.variant] = used.get(p.variant, 0) + 1
                    n_cases += 1
    return n_cases, worst, used


def _reset_counts(kernel):
    """Set a kernel's wrapper module's launch counts (polyphase or
    resample: by entry point, by entry point and variant, and the
    time-major count) to 0."""
    for counts in (kernel.launches, kernel.launches_by_variant):
        for k in counts:
            counts[k] = 0
    if hasattr(kernel, "launches_tm"):
        kernel.launches_tm = 0


def _by_variant(kernel):
    """The nonzero launch counts of a kernel's wrapper module (polyphase or
    resample) by entry point and variant."""
    return {k: v for k, v in kernel.launches_by_variant.items() if v}


def _rel_rms(got, ref):
    """Relative RMS of got - ref, real or complex (moduli)."""
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2)
                         / np.mean(np.abs(ref) ** 2)))


def phase_kernel_vs_plain(mt, torch, dev, pp):
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
    n_var, w_var, used = _variant_matrix(torch, dev, pp, ("f32",))
    print(f"[3 kernel vs plain] {n_cases} cases, counts and states exact, "
          f"worst max|dy|/max|y| {worst:.3e} (limit {TOL_KERNEL}); "
          f"variants: {n_var} f32 cases {used}, worst {w_var['f32']:.3e}")


def phase_slice(mt, torch, dev, pp):
    from multirate_tpu_torch.utils.oracle import naivefilt

    ratio = Fraction(147, 160)
    h = headline_taps(mt)
    x_np = np.random.default_rng(0).standard_normal(N_HEAD).astype(
        np.float32)
    x = torch.from_numpy(x_np).to(dev)
    n_want = mt.outputlength(N_HEAD, ratio)

    _reset_counts(pp)
    y = mt.filt(h, x, ratio)
    f = mt.FIRFilter(h, ratio)
    parts = [f.filt(x[i:i + CHUNK]) for i in range(0, N_HEAD, CHUNK)]
    torch.cuda.synchronize()
    launches = pp.launches["f32"]

    check(launches == 1 + len(parts) == sum(pp.launches.values()),
          f"kernel launched {pp.launches}, want f32 {1 + len(parts)}")
    check(_by_variant(pp) == {"f32/reg": launches},
          f"variants launched {_by_variant(pp)}, want f32/reg {launches}")
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
          f"{rms_chunk:.3e} (limit {TOL_CHUNKED}); kernel launches {launches}"
          f" {_by_variant(pp)}")
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
    variant = pp.plan(24, 147, 160, n, x.dtype, params.bank.dtype).variant
    ms, general_ms = _time_variants(torch, pp.polyphase, args)
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
        g_args = (x2, hist, bank, L, M, 1, 1, n_g)
        g_ms, g_general = _time_variants(torch, pp.polyphase, g_args)
        g_bound = _polyphase_bound(torch, g_args, torch.float32, "f32")[0]
        geo.append(f"{L}//{M} {_plan_of(pp, g_args).variant} {g_ms:.4f} ms "
                   f"({N_HEAD / g_ms / 1e3:.1f} Msps in), general "
                   f"{g_general:.4f} ms, bound {g_bound:.4f} ms")
    # one 65,536-sample block of the stream (phase 4e): the grid's fill
    n_b = mt.outputlength(1 << 16, Fraction(147, 160))
    b_args = (x2[:, :1 << 16], h2, params.bank, 147, 160, 1, 1, n_b)
    b_ms, b_general = _time_variants(torch, pp.polyphase, b_args)
    print(f"[5 times] 147//160 block of {N_HEAD}: kernel ({variant}) "
          f"{ms:.4f} ms ({N_HEAD / ms / 1e3:.1f} Msps in, "
          f"{n / ms / 1e3:.1f} Msps out), general variant {general_ms:.4f} "
          f"ms, one launch after an L2 flush {cold_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms ({N_HEAD / plain_ms / 1e3:.1f} Msps in);"
          f" max abs err {max_abs:.3e}; T=24 random taps: {'; '.join(geo)};"
          f" a 65,536-sample block ({_plan_of(pp, b_args)}): "
          f"{b_ms * 1e3:.2f} us, general {b_general * 1e3:.2f} us; "
          f"card: {card}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                general_ms=general_ms, variant=variant,
                **dict(zip(("bound_ms", "bound_by"), _polyphase_bound(
                    torch, args, torch.float32, "f32"))))


def _plan_of(pp, args):
    """The plan of one polyphase call on ``args``."""
    x, _, bank, L, M, _, _, n = args
    return pp.plan(bank.shape[0], L, M, n, x.dtype, bank.dtype, x.shape[0])


def _time_variants(torch, kern, args, **kw):
    """(ms of the planned variant, ms of the general variant) of one call of
    a kernel's wrapper (``pp.polyphase``, ``rs.resample`` or
    ``rs.resample_tm``), timed in turns in this run."""
    planned = _time_ms(torch, lambda: kern(*args, **kw), iters=20)
    general = _time_ms(torch, lambda: kern(*args, **kw, variant="general"),
                       iters=20)
    return planned, general


def phase_resample_vs_plain(mt, torch, dev, rs):
    rng = np.random.default_rng(2)
    ha = bench_taps(mt)
    specs = []  # (name, taps, rate, nphi, polyorder, channels, xlen)
    for rate in RATES:
        for nphi in (32, 7):
            for po in (None, 4):
                for ch, xlen in ((1, 200_003), (N_CH, 20_011)):
                    specs.append(("bench taps", ha, rate, nphi, po, ch,
                                  xlen))
    # models.Resampler's design (T = 73 at nphi 32): its compiled variant
    # (arbitrary) and the general one (Farrow, P+1 = 5); one channel in
    # runs of outputs a thread (600,000 samples) and 3 channels
    hr = mt.models.Resampler(R_REF, device="cpu").taps
    for rate in (R_REF, 0.9173):
        for po in (None, 4):
            for ch, xlen in ((1, 600_000), (3, 20_011)):
                specs.append(("Resampler taps", hr, rate, 32, po, ch, xlen))
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
    worst, n_cases, big_n, used = 0.0, 0, 0, {}
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
                xs = xt if time_major else x
                worst = max(worst, _compare(mt, torch, params, st, xs,
                                            time_major, case))
                err, planned = _resample_variants(mt, torch, rs, params, st,
                                                  xs, time_major, case)
                worst = max(worst, err)
                used[planned] = used.get(planned, 0) + 1
                n_cases += 1
    check(big_n > 1 << 20, f"the nphi 1024 case made only {big_n} outputs")
    check(set(used) == {"general", *rs.COMPILED.values()},
          f"3b planned only {used}")
    print(f"[3b resample vs plain] {n_cases} cases (up to {big_n} outputs "
          f"at nphi 1024), counts and states exact, worst max|dy|/max|y| "
          f"{worst:.3e} (limit {TOL_KERNEL}); each case also through the "
          f"planned variant {used} and the general one, equal bit for bit")


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

    _reset_counts(rs)
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
    by_variant = _by_variant(rs)

    n_chunks = len(runs[0][1])
    want = (len(rows) * (1 + n_chunks) + 1, 1)
    check(launches == want and sum(rs.launches.values()) == want[0],
          f"resample launches {rs.launches}, time-major {rs.launches_tm}; "
          f"want f32 {want[0]}, time-major {want[1]}")
    # every row through its compiled variant: T = 10, P+1 = 2 (arbitrary)
    # or 5 (Farrow)
    want_v = {"f32/t10p2": 1 + n_chunks, "f32/t10p5": 2 + n_chunks,
              "tm/t10p5": 1}
    check(by_variant == want_v,
          f"variants launched {by_variant}, want {want_v}")
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
          f"channel-major {launches[0]}, time-major {launches[1]}, by "
          f"variant {by_variant}")
    return x, x64, launches


def phase_resample_times(mt, torch, x, x64, rs, card):
    """bench.py's six arbitrary/Farrow rows, and arbitrary on the 64
    channels: kernel vs plain version."""
    ha = bench_taps(mt)
    x1 = x.view(1, -1)
    xt64 = x64.t().contiguous()
    rows = (("arbitrary_0.4709", 0.4709, None, x1, False),
            ("arbitrary_refrate", R_REF, None, x1, False),
            ("farrow_refrate", R_REF, 4, x1, False),
            ("farrow_0.4709", 0.4709, 4, x1, False),
            ("farrow_64ch_batched", 0.9173, 4, x64, False),
            ("farrow_64ch_tmajor", 0.9173, 4, xt64, True),
            # no bench row: TPU kernel 6 (select4's channel-batched
            # arbitrary resample) at the 64-channel shapes
            ("arbitrary_64ch_batched", 0.9173, None, x64, False))
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
        ms, general_ms = _time_variants(torch, kern, args)
        plain_ms = _time_ms(torch, lambda: plain(*args), iters=2)
        # x, history and table read once, outputs written once; each
        # output takes T * (P + 1) multiply-adds (arbitrary: P = 1)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (xs, st.history, p.bank)) + C * n * 4
        variant = _resample_plan(rs, args, tm).variant
        out[name] = (max_abs, ms, plain_ms,
                     _bound(nbytes, C * n * p.bank.numel() // p.nphi,
                            "f32"), general_ms, variant)
        notes.append(f"{name} kernel ({variant}) {ms:.4f} ms "
                     f"({xs.numel() / ms / 1e3:.1f} Msps in), general "
                     f"variant {general_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"max abs err {max_abs:.3e}, bound "
                     f"{out[name][3][0]:.4f} ms ({out[name][3][1]})")
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
    n_var, w_var, used = _variant_matrix(torch, dev, pp, tuple(modes))
    print(f"[3c quantized vs plain] variants: {n_var} cases {used}, worst "
          + ", ".join(f"{m} {w_var[m]:.3g}" for m in modes))
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

    _reset_counts(pp)
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
    by_variant = _by_variant(pp)
    check(by_variant == {"bf16/reg": blocks, "s8/reg": blocks,
                         "f32_bf16out/slide": blocks},
          f"variants launched {by_variant}, want the register variant "
          f"(147//160) and the sliding one (4//1)")
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
    print(f"[4c quantized slice] {'; '.join(notes)}; launches {by_variant}")
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
        ms, general_ms = _time_variants(torch, pp.polyphase, args,
                                        out_dtype=store)
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
        variant = _plan_of(pp, args).variant
        out[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=library_ms, general_ms=general_ms,
                         variant=variant)
        notes.append(
            f"{name} kernel ({variant}) {ms:.4f} ms ({N_HEAD / ms / 1e3:.1f} "
            f"Msps in){wide}, general variant {general_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
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
    # bench.py's standard_147taps and decim_1_4 (bench.py:435-445):
    # firdes(147, 0.2, kaiser, beta=7.0) on the 8 M samples
    bank = mt.make_kernel(h147, ratio=1, device=x.device).bank  # (147, 1)
    hist = torch.zeros(1, 146, device=x.device)
    for name, M in (("standard_147taps", 1), ("decim_1_4", 4)):
        n_b = mt.outputlength(N_HEAD, Fraction(1, M))
        args = (x1, hist, bank, 1, M, 1, 1, n_b)
        yk = pp.polyphase(*args)
        yp = pp.polyphase_plain(*args)

        def lib(M=M, n_b=n_b):
            with fp32():
                return _conv_dec(torch, x1, bank, M, n_b)
        torch.cuda.synchronize()
        max_abs = float((yk - yp).abs().max())
        scale = float(yp.abs().max())
        check(max_abs <= TOL_KERNEL * scale,
              f"{name}: kernel vs plain max abs err {max_abs:.3e}")
        check(float((lib() - yk).abs().max()) <= TOL_KERNEL * scale,
              f"{name}: conv1d disagrees")
        del yk, yp
        ms, general_ms = _time_variants(torch, pp.polyphase, args)
        plain_ms = _time_ms(torch, lambda: pp.polyphase_plain(*args), iters=2)
        library_ms = _time_ms(torch, lib, iters=5)
        bound = _polyphase_bound(torch, args, torch.float32, "f32")
        variant = _plan_of(pp, args).variant
        out[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=library_ms, general_ms=general_ms,
                         variant=variant)
        notes.append(
            f"{name} kernel ({variant}) {ms:.4f} ms ({N_HEAD / ms / 1e3:.1f} "
            f"Msps in), general variant {general_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, conv1d {library_ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), max abs err {max_abs:.3e}")
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
    # nine channels: blocks of 8 sharing each output's taps, and a group of
    # one, in every type
    resample += [("bench taps", ha, R_REF, 32, po, ((9, 20_011),))
                 for po in (None, 4)]
    # a (5, 10, 2048) Farrow table, read from global memory in every type
    resample.append(("global table", rng.standard_normal(20_480), 0.9, 2048,
                     4, ((2, 20_011),)))
    worst = dict.fromkeys(WIDE, 0.0)
    n_pp = n_rs = 0
    rs_used, n_group = {}, 0
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
                        # the channel-major entry point, planned and
                        # general (time-major blocks of these types run it
                        # on the transpose)
                        if not tm:
                            err, planned = _resample_variants(
                                mt, torch, rs, params, st, x, False, case,
                                tol)
                            worst[entry] = max(worst[entry], err)
                            rs_used[planned] = rs_used.get(planned, 0) + 1
                            n_out = mt.outputlength(params, xlen, state=st)
                            cb = _resample_plan(
                                rs, (x, None, params, 0, 0, n_out),
                                False).channels
                            check(cb == (8 if ch >= 8 else 1),
                                  f"{case}: {cb} channels a block")
                            n_group += cb == 8
                        n_rs += 1
    n_var, w_var, used = _variant_matrix(torch, dev, pp, tuple(WIDE))
    print(f"[3d wide vs plain] polyphase variants: {n_var} cases {used}, "
          f"worst " + ", ".join(f"{e} {w_var[e]:.3e}" for e in WIDE))
    check({"t10p2", "t10p5", "general"} <= set(rs_used),
          f"3d planned only {rs_used}")
    check(n_group == 4 * len(WIDE), f"3d: {n_group} 8-channel cases")
    print(f"[3d wide vs plain] {n_pp} polyphase and {n_rs} resample cases "
          f"(time-major ones through the channel-major entry point; the "
          f"channel-major ones also through the planned variant {rs_used} "
          f"and the general one, equal bit for bit; {n_group} of them in "
          f"blocks of 8 channels), counts "
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
        _reset_counts(pp)
        _reset_counts(rs)
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
        by_variant = _by_variant(pp)
        rs_variant = _by_variant(rs)
        refs = {k: v.result() for k, v in oracles.items()}

    blocks = 1 + len(chunks)
    want = (dict.fromkeys(pp.launches, 0), dict.fromkeys(rs.launches, 0), 0)
    want[0].update(c64=blocks, f64=blocks)
    want[1].update(f64=2 * blocks)
    check(launches == want, f"launches {launches}, want {want}")
    check(by_variant == {"c64/reg": blocks, "f64/reg": blocks},
          f"variants launched {by_variant}, want the register variant")
    check(rs_variant == {"f64/t10p2": blocks, "f64/t10p5": blocks},
          f"resample variants launched {rs_variant}, want the compiled ones")
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
          f"{by_variant}, resample {rs_variant}")
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
        ms, general_ms = _time_variants(torch, kern, args)
        variant = (_plan_of(pp, args) if kern is pp.polyphase
                   else _resample_plan(rs, args, False)).variant
        extra = dict(general_ms=general_ms, variant=variant)
        tag = f" ({variant})"
        general = f", general variant {general_ms:.4f} ms"
        plain_ms = _time_ms(torch, lambda: plain(*args), iters=2)
        library_ms = None if lib is None else _time_ms(torch, lib, iters=5)
        out[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=library_ms, **extra)
        notes.append(
            f"{name} kernel{tag} {ms:.4f} ms ({N_HEAD / ms / 1e3:.1f} "
            f"Msps in){general}, plain {plain_ms:.4f} ms, library "
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
        ms, general_ms = _time_variants(torch, pp.polyphase, args,
                                        out_dtype=store)
        plain_ms = _time_ms(torch, lambda: pp.polyphase_plain(
            *args, out_dtype=store), iters=2)
        library_ms = _time_ms(torch, lib, iters=5)
        bound = _polyphase_bound(torch, args, store,
                                 "bf16" if dt == torch.bfloat16 else "f32")
        notes.append(
            f"interp_4_1 {entry} kernel ({_plan_of(pp, args).variant}) "
            f"{ms:.4f} ms, general variant {general_ms:.4f} ms, plain "
            f"{plain_ms:.4f} "
            f"ms, library {library_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}), max abs err {max_abs:.3e}")
    print(f"[5d wide times] {'; '.join(notes)}; card: {card}")
    return out


def _expand_row(probe, odt):
    """The kernels line's name of the expand probe with ``odt`` stores:
    ``probe_expand`` (float32), ``probe_expand_bf16``, ..."""
    name = probe.EXPAND[odt]
    return "probe_expand" if name == "expand_f32" else f"probe_{name}"


def _expand_library(torch, xe, ratio, odt):
    """One PyTorch call computing ``probe.expand(xe, ratio, odt)``, or None:
    ``cat`` for float32 stores; for bf16 and f16 one casting copy of the
    rows broadcast ratio times (round to nearest even, as the kernel), whose
    (R, ratio, W) result is (R, ratio*W) without a copy. int8 stores scale
    and clamp first, which takes more calls."""
    R, W = xe.shape
    if odt == torch.float32:
        return lambda: torch.cat([xe] * ratio, 1)
    if odt in (torch.bfloat16, torch.float16):
        return lambda: (xe[:, None, :].expand(-1, ratio, -1).to(odt)
                        .view(R, ratio * W))
    return None


def _probe_source(torch, rng, n, dtype):
    """Seeded samples of shape ``n`` in ``dtype`` (int8 as 16 x a standard
    normal)."""
    if dtype == torch.int8:
        return torch.from_numpy((rng.standard_normal(n) * 16).astype(
            np.int8))
    return _wide_signal(torch, rng, n, dtype)


def phase_probe_vs_plain(torch, dev, probe):
    """3e: the copy and expand probes against their plain versions, bit
    for bit."""
    rng = np.random.default_rng(6)
    n_copy = n_expand = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8,
                  torch.complex128):
        for n in PROBE_COPY_LENGTHS:
            for off in PROBE_OFFSETS:
                x = _probe_source(torch, rng, n + off, dtype).to(dev)[off:]
                case = f"copy {dtype} n={n} offset={off}"
                before = probe.launches["copy"]
                y = probe.copy(x)
                yp = probe.copy_plain(x)
                torch.cuda.synchronize()
                check(probe.launches["copy"] == before + (n > 0),
                      f"{case}: not launched once")
                check(y.dtype == dtype and y.shape == x.shape
                      and torch.equal(y.view(torch.uint8),
                                      yp.view(torch.uint8)),
                      f"{case}: differs from the plain version")
                n_copy += 1
    for shape in PROBE_EXPAND_SHAPES:
        x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(
            np.float32)).to(dev)
        for ratio in PROBE_RATIOS:
            for odt, name in probe.EXPAND.items():
                case = f"expand {shape} 1:{ratio} {odt}"
                before = probe.launches[name]
                y = probe.expand(x, ratio, odt)
                yp = probe.expand_plain(x, ratio, odt)
                torch.cuda.synchronize()
                check(probe.launches[name] == before + 1,
                      f"{case}: not launched once")
                check(y.dtype == odt and y.shape == yp.shape
                      and torch.equal(y.view(torch.uint8),
                                      yp.view(torch.uint8)),
                      f"{case}: differs from the plain version")
                n_expand += 1
    print(f"[3e probes vs plain] {n_copy} copies (float32, bfloat16, int8, "
          f"complex128; {len(PROBE_COPY_LENGTHS)} lengths from 0 to "
          f"{max(PROBE_COPY_LENGTHS)}; source offsets {PROBE_OFFSETS}) and "
          f"{n_expand} expands (rows of "
          f"{sorted({w for _, w in PROBE_EXPAND_SHAPES})} floats; ratios "
          f"{PROBE_RATIOS}; float32, bfloat16, float16 and int8 stores) "
          f"equal to their plain versions bit for bit")


def _stream(s, x_np, rng, stop=None):
    """Push ``x_np`` (to ``stop`` samples) into ``s`` in seeded random
    chunks; returns the samples pushed."""
    stop = len(x_np) if stop is None else stop
    lo, hi = STREAM_CHUNKS
    i = 0
    while i < stop:
        n = min(int(rng.integers(lo, hi + 1)), stop - i)
        check(s.push(x_np[i:i + n]) == n, "the ring refused a chunk")
        i += n
    return i


def phase_runtime(mt, torch, dev, pp, rs, x, card):
    """4e: the runtime at full width. ``x`` is phase 4's 8 M-sample block
    on the card. Also times one block's kernel alone, so that the stream's
    wall time splits into the card's share and the host's."""
    import os
    import tempfile

    from multirate_tpu_torch.ops.params import FIRArbitrary

    x_np = x.cpu().numpy()
    ratio = Fraction(147, 160)
    bs = 1 << 16
    notes = []

    def uninterrupted(model, seed, guard):
        s = mt.io.StreamingResampler(model)
        check(s.block_size == bs, f"block size {s.block_size}")
        rng = np.random.default_rng(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            _stream(s, x_np, rng)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        y = s.flush()
        return s, y, time.perf_counter() - t0

    d = mt.models.DATToCD(device="cuda")
    r = mt.models.Resampler(R_REF, device="cuda")
    check(isinstance(r.kernel, FIRArbitrary) and d.taps.dtype == np.float32,
          "models built the wrong kernels")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "stream.ckpt.npz")
        _reset_counts(pp)
        _reset_counts(rs)
        s_d, y_d, sec_d = uninterrupted(d, 7, True)
        s_r, y_r, sec_r = uninterrupted(r, 8, False)
        # the kill: a checkpoint every 16 blocks, the stream lost at 60%
        s_k = mt.io.StreamingResampler(mt.models.DATToCD(device="cuda"),
                                       checkpoint_every=16,
                                       checkpoint_path=ckpt)
        _stream(s_k, x_np, np.random.default_rng(9), int(0.6 * N_HEAD))
        blocks_k = s_k.stats()["blocks"]
        part1 = s_k.pull()
        del s_k
        s_k2 = mt.io.StreamingResampler(mt.models.DATToCD(device="cuda"),
                                        checkpoint_every=16,
                                        checkpoint_path=ckpt)
        consumed = s_k2.resume()
        pushed = _stream(s_k2, x_np[consumed:], np.random.default_rng(10))
        tail = s_k2.flush()
        torch.cuda.synchronize()
        launches = (dict(pp.launches), dict(rs.launches), rs.launches_tm)
        by_variant = _by_variant(pp)
        rs_variant = _by_variant(rs)

    blocks = (s_d.stats()["blocks"], s_r.stats()["blocks"],
              blocks_k + s_k2.stats()["blocks"])
    check(blocks[:2] == (N_HEAD // bs,) * 2,
          f"stream blocks {blocks}, want {N_HEAD // bs}")
    want = (dict.fromkeys(pp.launches, 0), dict.fromkeys(rs.launches, 0), 0)
    want[0]["f32"] = blocks[0] + 1 + blocks[2] + 1
    want[1]["f32"] = blocks[1] + 1
    check(launches == want, f"launches {launches}, want {want}")
    check(by_variant == {"f32/reg": want[0]["f32"]},
          f"variants launched {by_variant}, want the register variant")
    check(rs_variant == {"f32/t73p2": want[1]["f32"]},
          f"resample variants launched {rs_variant}, want f32/t73p2")

    for label, model, y, s, sec, spec in (
            ("DATToCD 147//160", d, y_d, s_d, sec_d, (ratio,)),
            (f"Resampler({R_REF:.9g})", r, y_r, s_r, sec_r, (R_REF, 32))):
        # one block's kernel alone (CUDA events), against the stream
        p = model.kernel
        n_b = mt.outputlength(p, bs)
        hist = mt.init_state(p, (1,)).history
        if p is d.kernel:
            blk = (pp.polyphase, (x[:bs].view(1, -1), hist, p.bank, 147,
                                  160, 1, 1, n_b))
            blk_bound = _polyphase_bound(torch, blk[1], torch.float32, "f32")
        else:
            blk = (rs.resample, (x[:bs].view(1, -1), hist, p, 0, 1, n_b))
            # x, history and table read once, outputs written once; each
            # output takes T * (P + 1) multiply-adds
            blk_bound = _bound(
                sum(t.numel() * t.element_size()
                    for t in (blk[1][0], hist, p.bank)) + n_b * 4,
                n_b * p.bank.numel() // p.nphi, "f32")
        blk_ms = _time_ms(torch, lambda: blk[0](*blk[1]), iters=20)
        # the general variant in turn (the same call with it forced)
        gen_ms = _time_ms(torch, lambda: blk[0](*blk[1], variant="general"),
                          iters=20)
        busy = s.stats()["blocks"] * blk_ms / (sec * 1e3)
        whole = mt.filt(model.taps, x, *spec).cpu().numpy()
        check(y.dtype == np.float32 and y.shape == whole.shape
              and bool(np.isfinite(y).all()),
              f"{label}: stream gave {y.dtype} {y.shape}, whole "
              f"{whole.shape}")
        st = s.stats()
        check(st["consumed_samples"] == N_HEAD and st["ended"]
              and st["produced_samples"] == whole.size,
              f"{label}: stats {st}")
        rms_s = float(np.sqrt(np.mean((y.astype(np.float64) - whole) ** 2)))
        check(rms_s <= TOL_CHUNKED, f"{label}: stream-vs-whole RMS {rms_s}")
        notes.append(
            f"{label}: {N_HEAD} samples in chunks of {STREAM_CHUNKS[0]}-"
            f"{STREAM_CHUNKS[1]} -> {y.size} (= filt), stream-vs-whole RMS "
            f"{rms_s:.3e} (limit {TOL_CHUNKED}), bit-identical "
            f"{bool(np.array_equal(y, whole))}; stats {st}; "
            f"{N_HEAD / sec / 1e6:.1f} Msps in end to end ({sec:.4f} s "
            f"from the first push to the end of flush"
            f"{', push loop under sync debug mode error' if s is s_d else ''}"
            f"); one block's kernel {blk_ms * 1e3:.2f} us (general variant "
            f"{gen_ms * 1e3:.2f} us, bound {blk_bound[0] * 1e3:.3f} us, "
            f"{blk_bound[1]}) against "
            f"{sec * 1e3 / (st['blocks'] + 1):.3f} ms of the stream's wall "
            f"time a block: the kernels fill {busy:.2%} of it")

    at = s_k2.stats()["produced_samples"] - tail.size
    check(0 < consumed <= 0.6 * N_HEAD and consumed % (16 * bs) == 0
          and consumed + pushed == N_HEAD, f"resumed at {consumed}")
    check(np.array_equal(tail, y_d[at:])
          and np.array_equal(part1[:at], y_d[:at]),
          "kill and resume differs from the uninterrupted stream")
    notes.append(f"kill at {int(0.6 * N_HEAD)} samples, resumed from "
                 f"{consumed} (output {at}): prefix and tail equal to the "
                 f"uninterrupted stream bit for bit")
    notes.append(f"launches polyphase {by_variant}, resample {rs_variant} "
                 f"(blocks {blocks} plus a flush each)")

    # check_block on the card: the four rational-family types, arbitrary
    # and Farrow
    h = headline_taps(mt)
    ha = bench_taps(mt)
    xb = x[:1 << 16]
    for label, p in (
            ("147//160", mt.make_kernel(h, ratio=ratio, device=dev)),
            ("1//1", mt.make_kernel(h, ratio=1, device=dev)),
            ("4//1", mt.make_kernel(h, ratio=4, device=dev)),
            ("1//4", mt.make_kernel(h, ratio=(1, 4), device=dev)),
            ("arbitrary", mt.make_kernel(ha, rate=R_REF, device=dev)),
            ("Farrow", mt.make_kernel(ha, rate=0.4709, polyorder=4,
                                      device=dev))):
        st = _entry_state(mt, p, (), torch.float32, xb, "mid")
        # the smoke's kernel tolerance, 1e-5 of max|y|, as the absolute
        # one: the 3,528 headline taps as one FIR or 1//4 decimator give
        # outputs of ~12, whose float32 sums in another order differ by
        # more than check_block's default 1e-5
        scale = float(mt.filt_block(p, st, xb, path="windows")[0].abs().max())
        mt.utils.check_block(p, st, xb, path="kernel",
                             atol=TOL_KERNEL * scale)
    notes.append("check_block passes on the card for 147//160, 1//1, 4//1, "
                 "1//4, arbitrary and Farrow (mid-stream entry; atol 1e-5 "
                 "of max|y|)")

    # a trace of one DATToCD block
    d.reset()
    with tempfile.TemporaryDirectory() as tmp:
        with mt.utils.trace(tmp):
            with mt.utils.annotate("resample-block"):
                d(xb)
            torch.cuda.synchronize()
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as fh:
            events = json.load(fh)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"
            and "polyphase_reg" in e.get("name", "")
            and "mr_polyphase_f32" in e.get("name", "")]
    check(any(e.get("name") == "resample-block" for e in events)
          and len(kern) == 1,
          f"trace: annotation or kernel missing ({len(kern)} kernels)")
    notes.append(f"trace holds 'resample-block' and the kernel "
                 f"{kern[0]['name'][:90]}... ({kern[0].get('dur')} us)")
    print(f"[4e runtime] {'; '.join(notes)}; card: {card}")


def phase_runtime_times(mt, torch, x, xc, pp, rs, probe, card):
    """5e: the copy and expand ceilings, the probe kernels against their
    bounds, plain versions and library calls, ``measure_chained`` on the
    headline block, and the five entry points no earlier phase times."""
    from multirate_tpu_torch.utils import metrics

    dev = x.device
    notes, out = [], {}
    for k in probe.launches:
        probe.launches[k] = 0
    copy_gbps = metrics.stream_copy_gbps()
    expand_gbps = {odt: metrics.stream_expand_gbps(out_dtype=odt)
                   for odt in probe.EXPAND}
    torch.cuda.synchronize()
    launches = dict(probe.launches)
    check(launches == {"copy": 25, **dict.fromkeys(probe.EXPAND.values(),
                                                   31)},
          f"probe launches {launches}")
    peak = HBM_BYTES_PER_S / 1e9
    shares = {"copy f32": copy_gbps / peak, **{
        f"expand 1:4 {odt}".replace("torch.", ""): g / peak
        for odt, g in expand_gbps.items()}}
    check(all(v <= MAX_CEILING_SHARE for v in shares.values()),
          f"a probe above {MAX_CEILING_SHARE:.0%} of 3.35 TB/s: {shares}")
    notes.append(
        f"stream_copy_gbps() {copy_gbps:.1f} GB/s; stream_expand_gbps() "
        + ", ".join(f"{odt} {g:.1f}".replace("torch.", "")
                    for odt, g in expand_gbps.items())
        + " GB/s; shares of 3.35 TB/s "
        + ", ".join(f"{k} {v:.1%}" for k, v in shares.items())
        + f"; launches {launches}")

    # each probe alone after an L2 eviction: kernel, plain, library
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        32_000_000).astype(np.float32)).to(dev)
    ys = torch.empty_like(xs)

    def cold(fn):
        return _time_ms(torch, fn, iters=1, before=flush.zero_)

    def cold_clean(fn):
        # evicted by a 256 MB read: the L2 holds no dirty lines, so the
        # launch writes back none of the eviction's (a diagnostic beside
        # the ceilings, which evict by a write)
        return _time_ms(torch, fn, iters=1, before=flush.sum)

    def max_abs_err(kern, plain, *args):
        yk, yp = kern(*args), plain(*args)
        err = float((yk.double() - yp.double()).abs().max())
        check(err == 0, f"{kern.__name__}{args[1:]}: differs by {err}")
        return err

    bound = _bound(2 * xs.numel() * 4, 0, "f32")
    out["probe_copy"] = dict(
        max_abs_err=max_abs_err(probe.copy, probe.copy_plain, xs),
        ms=cold(lambda: probe.copy(xs)),
        plain_ms=cold(lambda: probe.copy_plain(xs)), bound_ms=bound[0],
        bound_by=bound[1], library_ms=cold(lambda: ys.copy_(xs)))
    del ys
    xe = xs[:8_000_000].view(-1, 128)
    ratio = 4
    exp_notes = []
    for odt in probe.EXPAND:
        nbytes = (4 + ratio * torch.empty((), dtype=odt).element_size()) \
            * xe.numel()
        bound = _bound(nbytes, 0, "f32")
        lib = _expand_library(torch, xe, ratio, odt)
        if lib is not None:
            check(torch.equal(lib(), probe.expand_plain(xe, ratio, odt)),
                  f"the library expand with {odt} stores differs from plain")
        row = dict(
            max_abs_err=max_abs_err(probe.expand, probe.expand_plain, xe,
                                    ratio, odt),
            ms=cold(lambda: probe.expand(xe, ratio, odt)),
            plain_ms=cold(lambda: probe.expand_plain(xe, ratio, odt)),
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=None if lib is None else cold(lib))
        out[_expand_row(probe, odt)] = row
        lib_ms = row["library_ms"]
        clean_ms = cold_clean(lambda: probe.expand(xe, ratio, odt))
        exp_notes.append(
            f"{odt} store {row['ms']:.4f} ms ({clean_ms:.4f} ms after a "
            f"read eviction), plain {row['plain_ms']:.4f} "
            f"ms, library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f", bound {bound[0]:.4f} ms".replace("torch.", ""))
    c = out["probe_copy"]
    notes.append(
        f"one launch after an L2 eviction: copy of 32 M float32 "
        f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, copy_ "
        f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms (bytes); "
        f"expand 1:4 of 8 M float32: {'; '.join(exp_notes)} (library: cat "
        f"for the float32 store, one casting copy of the broadcast rows for "
        f"bf16 and f16; int8's scale and clamp take more calls, so none)")
    del flush, xs

    # measure_chained on the 8 M headline block
    h = headline_taps(mt)
    p = mt.make_kernel(h, ratio=Fraction(147, 160), device=dev)
    rep = metrics.measure_chained(p, mt.init_state(p), x, repeat=20, iters=7)
    rate = rep.out_samples / rep.in_samples
    vs_copy = rep.in_samples_per_s / metrics.hbm_roofline_samples_per_s(
        rate, 4, copy_gbps)
    check(rep.roofline_fraction is not None,
          f"no KNOWN_HBM_GBPS entry for {torch.cuda.get_device_name(dev)}")
    notes.append(f"measure_chained 147//160 on {N_HEAD}: {rep}; "
                 f"{vs_copy:.1%} of the measured copy ceiling")

    # the five entry points no earlier phase times
    ha64 = mt.firdes(320, 0.45, mt.kaiser, samplerate=32, beta=7.0) * 32
    h64 = mt.firdes(24 * 147, 0.5 / 147, mt.kaiser, beta=7.8562) * 147
    xc128 = xc.to(torch.complex128).view(1, -1)
    n_r = mt.outputlength(N_HEAD, Fraction(147, 160))
    wide_notes = []

    def timed(name, kern, plain, args, bound, tol):
        yk, yp = kern(*args), plain(*args)
        torch.cuda.synchronize()
        max_abs = float((yk - yp).abs().max())
        check(max_abs <= tol * float(yp.abs().max()),
              f"{name}: kernel vs plain max abs err {max_abs:.3e}")
        del yk, yp
        ms, general_ms = _time_variants(torch, kern, args)
        variant = (_plan_of(pp, args) if kern is pp.polyphase
                   else _resample_plan(rs, args, False)).variant
        tag = f" ({variant})"
        general = f", general variant {general_ms:.4f} ms"
        plain_ms = _time_ms(torch, lambda: plain(*args), iters=2)
        out[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=None, general_ms=general_ms,
                         variant=variant)
        wide_notes.append(f"{name} kernel{tag} {ms:.4f} ms{general}, plain "
                          f"{plain_ms:.4f} ms, library none, bound "
                          f"{bound[0]:.4f} ms ({bound[1]}), max abs err "
                          f"{max_abs:.3e}")

    p = mt.make_kernel(h64, ratio=(147, 160), device=dev)
    hist = torch.zeros(1, p.h_min, dtype=torch.complex128, device=dev)
    args = (xc128, hist, p.bank, 147, 160, 1, 1, n_r)
    timed("polyphase_c128", pp.polyphase, pp.polyphase_plain, args,
          _polyphase_bound(torch, args, torch.complex128, "f64"),
          WIDE["c128"][2])
    for entry, (sig_name, taps_name, tol) in WIDE.items():
        if entry == "f64":
            continue  # phase 5d times it
        sig, tdt = getattr(torch, sig_name), getattr(torch, taps_name)
        p = mt.make_kernel(_wide_taps(torch, ha64, tdt), rate=R_REF, nphi=32,
                           device=dev)
        xs = (xc if sig == torch.complex64 else xc128).view(1, -1)
        hist = torch.zeros(1, p.h_min, dtype=sig, device=dev)
        n = mt.outputlength(p, N_HEAD)
        args = (xs, hist, p, 0, 1, n)
        # x, history and table read once, outputs written once; 2T
        # multiply-adds per output, each 2 real ones for a complex sample
        # against a real tap, 4 against a complex tap
        nbytes = sum(t.numel() * t.element_size()
                     for t in (xs, hist, p.bank)) + n * xs.element_size()
        timed(f"resample_{entry}", rs.resample, rs.resample_plain, args,
              _bound(nbytes, n * p.bank.numel() // p.nphi
                     * 2 * (1 + p.bank.is_complex()),
                     "f32" if sig == torch.complex64 else "f64"), tol)
    notes.append("147//160 and 1/2.123456789 on 8 M samples: "
                 + "; ".join(wide_notes))
    print(f"[5e runtime times] {'; '.join(notes)}; card: {card}")
    return out, launches



# --------------------------------------------------------------------------- #
# 3f-5f: the parallel layer, on WORLD gloo ranks sharing the card
# --------------------------------------------------------------------------- #

WORLD = 4
SHARD_MESHES = ((2, 2), (1, 4), (4, 1))
SHARD_SPECS = (Fraction(1, 1), Fraction(4, 1), Fraction(1, 4),
               Fraction(7, 5), Fraction(147, 160))
SHARD_N = 64_000          # 3f samples a channel (a multiple of 4 * 160)
SHARD_FARROW = (64, 32_000)
HEAD_SUPER = (2_560_000, 2_560_000, 2_880_000)  # 4f's three super-blocks
MC_SHAPE = (64, 125_000)  # bench.py's farrow_64ch_* shapes
TOL_SHARD_FULL = 1e-6     # sharded vs unsharded at full width, of max|y|
RANK_TIMEOUT_S = 420


def _launched(pp, rs):
    """Every launch of both kernels' wrappers since the last reset."""
    return (sum(pp.launches.values()) + sum(rs.launches.values())
            + rs.launches_tm)


def _shard_rank(rank, device, n_head):
    """3f and 4f on one rank of the gloo world (every rank on the same
    card): every case's sharded result against ``filt`` of the whole
    signal on the card, each rank's launch count per case, and the 5f
    per-shard kernel and halo times of the headline on (1, 4). Returns
    this rank's summary; a failed check raises (and fails the smoke)."""
    import torch

    import multirate_tpu_torch as mt
    from multirate_tpu_torch.ops import indexing as idx
    from multirate_tpu_torch.ops.cuda import polyphase as pp
    from multirate_tpu_torch.ops.cuda import resample as rs
    from multirate_tpu_torch.parallel import sharded as sh
    from multirate_tpu_torch.parallel.scaling_bench import host_span
    from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow

    dev = torch.device(device)
    meshes = {m: sh.make_mesh(*m) for m in SHARD_MESHES}
    rng = np.random.default_rng(21)  # the same draws on every rank
    rows, launches = [], {}

    def counted(fn):
        """fn's result and this rank's launches by entry and variant."""
        _reset_counts(pp)
        _reset_counts(rs)
        got = fn()
        torch.cuda.synchronize()
        return got, {**_by_variant(pp), **_by_variant(rs)}

    def rel(got, want):
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max())

    # ---- 3f: sharded_resample and streamed blocks vs whole filt ------- #
    cases = []
    for spec in SHARD_SPECS:
        cases.append((f"{spec}", dict(ratio=spec), rng.standard_normal(48)
                      .astype(np.float32), rng.standard_normal(
                          (8, SHARD_N)).astype(np.float32)))
    h_arb = (bench_taps(mt)).astype(np.float64)
    for rate in (0.8112, 1.618):
        cases.append((f"arbitrary {rate} f64", dict(rate=rate), h_arb,
                      rng.standard_normal((4, SHARD_N))))
    cases.append(("Farrow 0.9173 64ch", dict(rate=0.9173, nphi=32,
                                             polyorder=4),
                  bench_taps(mt), rng.standard_normal(SHARD_FARROW).astype(
                      np.float32)))
    for mesh_shape, mesh in meshes.items():
        for label, kw, h, x_np in cases:
            p = mt.make_kernel(h, device=dev, **kw)
            x = torch.from_numpy(x_np).to(dev)
            y, by = counted(lambda: sh.sharded_resample(p, x, mesh))
            n = sum(by.values())
            want = mt.filt(h, x, kw.get("ratio", kw.get("rate")),
                           kw.get("nphi", 32), kw.get("polyorder"))
            check(tuple(y.shape) == tuple(want.shape),
                  f"3f {label} on {mesh_shape}: {tuple(y.shape)}, whole "
                  f"{tuple(want.shape)}")
            err = rel(y, want)
            check(err <= TOL_KERNEL, f"3f {label} on {mesh_shape}: {err:.3e}")
            check(n == 1, f"3f {label} on {mesh_shape}: {n} launches")
            rows.append((f"{label} {mesh_shape}", n, err))
        # 7//5 streamed in three super-blocks: counts and state exact
        h = rng.standard_normal(32).astype(np.float32)
        p = mt.make_kernel(h, ratio=Fraction(7, 5), device=dev)
        x = torch.from_numpy(rng.standard_normal((4, 3 * 6400)).astype(
            np.float32)).to(dev)
        ci, _, _ = sh._coordinate(mesh)
        cl = 4 // mesh_shape[0]
        st = mt.init_state(p, (cl,), device=dev)

        def stream():
            nonlocal st
            outs, total = [], 0
            for b in range(3):
                xl, _ = sh.local_block(p, x[:, b * 6400:(b + 1) * 6400],
                                       mesh)
                y, counts, st = sh.shard_filt_block(p, st, xl, mesh)
                outs.append(sh.compact(y, counts, mesh))
                total += sum(counts)
            return torch.cat(outs, -1), total

        (y, total), by = counted(stream)
        n = sum(by.values())
        want, count, ws = mt.filt_block(p, mt.init_state(p, (4,)), x)
        want = want[ci * cl:(ci + 1) * cl]
        check(total == count and tuple(y.shape) == tuple(want.shape),
              f"3f stream on {mesh_shape}: {total} outputs, whole {count}")
        check((st.phase, st.deficit) == (ws.phase, ws.deficit)
              and torch.equal(st.history, ws.history[ci * cl:(ci + 1) * cl]),
              f"3f stream on {mesh_shape}: state differs")
        err = rel(y, want)
        check(err <= TOL_KERNEL, f"3f stream on {mesh_shape}: {err:.3e}")
        check(n == 3, f"3f stream on {mesh_shape}: {n} launches")
        rows.append((f"7/5 3 blocks {mesh_shape}", n, err))

    # bf16 and int8 on (2, 2): one streamed block a channel pair
    mesh = meshes[(2, 2)]
    ci, _, _ = sh._coordinate(mesh)
    h_q = (mt.firdes(24 * 21, 0.5 / 21, mt.kaiser, beta=7.0) * 21
           ).astype(np.float32)
    x_q = torch.from_numpy(rng.standard_normal((4, SHARD_N)).astype(
        np.float32)).to(dev)
    for mode in (torch.bfloat16, torch.int8):
        h = _as_mode(mt, torch, h_q, mode).to(dev)
        x = _as_mode(mt, torch, x_q, mode)
        p = mt.make_kernel(h, ratio=Fraction(147, 160), device=dev)

        def block():
            xl, _ = sh.local_block(p, x, mesh)
            y, counts, st = sh.shard_filt_block(
                p, mt.init_state(p, (2,), mode, device=dev), xl, mesh)
            return sh.compact(y, counts, mesh), st

        (y, st), by = counted(block)
        n = sum(by.values())
        want, count, ws = mt.filt_block(p, mt.init_state(p, (4,), mode), x)
        want = want[2 * ci:2 * ci + 2]
        check(tuple(y.shape) == tuple(want.shape)
              and (st.phase, st.deficit) == (ws.phase, ws.deficit),
              f"3f {mode} on (2, 2): {tuple(y.shape)} / state")
        if mode == torch.int8:
            check(torch.equal(y, want), "3f int8 differs from whole")
            err = 0.0
        else:
            err = rel(y, want)
            check(err <= 2.0 ** -8, f"3f bf16: {err:.3e} (one bf16 ulp)")
        check(n == 1, f"3f {mode}: {n} launches")
        rows.append((f"{mode} (2, 2)".replace("torch.", ""), n, err))
    # a block shorter than h_min raises ValueError, on every rank
    p = mt.make_kernel(rng.standard_normal(300), ratio=1, device=dev)
    xs = torch.zeros((1, 800), dtype=torch.float64, device=dev)
    try:
        sh.shard_filt(p, sh.local_block(p, xs, meshes[(1, 4)])[0],
                      meshes[(1, 4)])
        raised = False
    except ValueError:
        raised = True
    check(raised, "3f: a 200-sample block under h_min 299 did not raise")
    out = {"3f": rows}

    # ---- 4f: the headline, the 64-channel model, streamed headline ---- #
    h = headline_taps(mt)
    ratio = Fraction(147, 160)
    p = mt.make_kernel(h, ratio=ratio, device=dev)
    x_np = np.random.default_rng(0).standard_normal(n_head).astype(
        np.float32)
    x = torch.from_numpy(x_np).to(dev).view(1, -1)
    mesh = meshes[(1, 4)]
    y, by = counted(lambda: sh.sharded_resample(p, x, mesh))
    n = sum(by.values())
    whole = mt.filt(h, x, ratio)
    check(tuple(y.shape) == tuple(whole.shape), f"4f headline {y.shape}")
    err_head = rel(y, whole)
    check(err_head <= TOL_SHARD_FULL, f"4f headline: {err_head:.3e}")
    check(by == {"f32/reg": 1}, f"4f headline: launches {by}")
    launches["headline (1, 4)"] = n
    oracle = None
    if rank == 0:
        n_in = mt.inputlength(N_ORACLE, ratio)
        ref = naivefilt(h.astype(np.float64),
                        x_np[:n_in].astype(np.float64), ratio)[:N_ORACLE]
        oracle = _rel_rms(y[0, :N_ORACLE].double().cpu().numpy(), ref)
        check(oracle <= TOL_ORACLE, f"4f headline oracle {oracle:.3e}")

    # the headline's three streamed super-blocks
    st = mt.init_state(p, (1,), device=dev)

    def stream():
        nonlocal st
        outs, total, off = [], 0, 0
        for size in HEAD_SUPER:
            xl, _ = sh.local_block(p, x[:, off:off + size], mesh)
            yb, counts, st = sh.shard_filt_block(p, st, xl, mesh)
            outs.append(sh.compact(yb, counts, mesh))
            total += sum(counts)
            off += size
        return torch.cat(outs, -1), total

    (ys, total), by = counted(stream)
    n = sum(by.values())
    _, phase, deficit = idx.host_carry(p, 1, 1, n_head)
    check(total == whole.shape[-1] and tuple(ys.shape) == tuple(whole.shape),
          f"4f streamed headline: {total} outputs, whole {whole.shape[-1]}")
    check((st.phase, st.deficit) == (phase, deficit)
          and torch.equal(st.history, x[:, n_head - p.h_min:]),
          "4f streamed headline: state differs from the whole block's")
    err_stream = rel(ys, whole)
    check(err_stream <= TOL_SHARD_FULL,
          f"4f streamed headline: {err_stream:.3e}")
    check(n == len(HEAD_SUPER), f"4f streamed headline: {n} launches")
    launches["streamed headline (1, 4)"] = n
    del ys, whole

    # MultiChannelResampler on (64, 125,000) over (4, 1) and (2, 2)
    xm_np = np.random.default_rng(1).standard_normal(MC_SHAPE).astype(
        np.float32)
    xm = torch.from_numpy(xm_np).to(dev)
    mc = {}
    for n_ch in (4, 2):
        m = mt.models.MultiChannelResampler(0.9173, nphi=32, polyorder=4,
                                            n_ch_shards=n_ch, device=dev)
        ym, by = counted(lambda: m(xm))
        n = sum(by.values())
        want = mt.filt(m.taps, xm, 0.9173, 32, 4)
        shape = tuple(m.mesh.mesh.shape)
        check(tuple(ym.shape) == tuple(want.shape), f"4f model {ym.shape}")
        err = rel(ym, want)
        check(err <= TOL_SHARD_FULL, f"4f model on {shape}: {err:.3e}")
        check(n == 1 and all(k.startswith("f32/") for k in by),
              f"4f model on {shape}: launches {by}")
        launches[f"MultiChannelResampler {shape}"] = n
        worst = None
        if rank == 0:
            worst = 0.0
            for c in (0, MC_SHAPE[0] - 1):
                ref = naivefilt_farrow(m.taps.astype(np.float64),
                                       xm_np[c].astype(np.float64), 0.9173,
                                       32, 4)[:N_ORACLE]
                got = ym[c, :len(ref)].double().cpu().numpy()
                worst = max(worst, _rel_rms(got, ref))
            check(worst <= TOL_ORACLE, f"4f model oracle {worst:.3e}")
        mc[str(shape)] = (err, worst, m.params.taps_per_phi)
        del ym, want
    out["4f"] = dict(headline=(err_head, oracle), stream=err_stream, mc=mc,
                     launches=launches)

    # ---- 5f: the headline's per-shard kernel and halo time on (1, 4) -- #
    _, k, n_t = sh._coordinate(mesh)
    xl, _ = sh.local_block(p, x, mesh)
    st = mt.init_state(p, (1,), device=dev)
    halo = [None]

    def comm():
        halo[0] = sh.exchange_halo(st.history, xl, mesh)
        sh.broadcast_tail(xl, p.h_min, mesh)

    def events(fn):
        """ms between two events around ``fn``, a device-side sleep queued
        first to hide the host's enqueue: the span of the kernel on the
        stream. Only the rank whose turn it is queues one."""
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    # the host-staged halo and broadcast on the host clock, all ranks
    # together, with no device sleep queued ahead of any rank's copies
    halo_ms, kernel_ms = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        halo_ms.append(host_span(comm) * 1e3)
        for turn in range(n_t):
            torch.distributed.barrier()
            if turn == k:
                kernel_ms.append(events(lambda: sh.shard_step(
                    p, st, halo[0], xl, k)))
    plain_ms = max_abs = None
    if k == 0:  # the shard's plain version, on rank 0's shard
        yk = sh.shard_step(p, st, halo[0], xl, k)
        yp = sh.shard_step(p, st, halo[0], xl, k, "windows")
        max_abs = float((yk - yp).abs().max())
        check(max_abs <= TOL_KERNEL * float(yp.abs().max()),
              f"5f shard kernel vs plain {max_abs:.3e}")
        del yk, yp
        plain_ms = _time_ms(torch, lambda: sh.shard_step(
            p, st, halo[0], xl, k, "windows"), iters=1, reps=3)
    out["5f"] = dict(kernel_ms=statistics.median(kernel_ms),
                     max_abs_err=max_abs,
                     halo_ms=statistics.median(halo_ms), plain_ms=plain_ms,
                     shard=xl.shape[-1],
                     bound=_polyphase_bound(torch, (
                         xl, halo[0], p.bank, 147, 160, 1, 1,
                         idx.host_carry(p, 1, 1, xl.shape[-1])[0]),
                         torch.float32, "f32"))
    return out


def phase_sharded(mt, torch, card):
    """3f, 4f and the per-shard half of 5f: a gloo world of WORLD ranks,
    all on ``cuda:0``, with the kernels built here before the spawn."""
    from multirate_tpu_torch.parallel.multihost import spawn_world

    t0 = time.perf_counter()
    ranks = spawn_world(_shard_rank, WORLD, args=(N_HEAD,), device="cuda:0",
                        timeout_s=RANK_TIMEOUT_S)
    secs = time.perf_counter() - t0
    per_rank = [dict((label, n) for label, n, _ in r["3f"]) for r in ranks]
    worst = max(err for r in ranks for _, _, err in r["3f"])
    totals = {label: sum(pr[label] for pr in per_rank)
              for label in per_rank[0]}
    want = {label: WORLD * (3 if "3 blocks" in label else 1)
            for label in totals}
    check(totals == want, f"3f launches over the ranks {totals}")
    print(f"[3f sharded vs unsharded] {WORLD} gloo ranks on one card, halo "
          f"and history staged through the host; meshes {SHARD_MESHES}; "
          f"{len(per_rank[0])} cases a rank (rational 1/1, 4/1, 1/4, 7/5, "
          f"147/160 with 48 taps on (8, {SHARD_N}); arbitrary 0.8112 and "
          f"1.618 in float64; Farrow 0.9173 on {SHARD_FARROW}; 7/5 in three "
          f"streamed super-blocks; bf16 and int8 147/160 on (2, 2)): "
          f"counts and states exact, worst error {worst:.3e} of max|y| "
          f"(limit {TOL_KERNEL}; int8 equal; bf16 limit 2^-8); block under "
          f"h_min raised ValueError on every rank; launches a rank per "
          f"case: " + "; ".join(f"{label} {[pr[label] for pr in per_rank]}"
                                for label in per_rank[0])
          + f"; world of {WORLD} ran in {secs:.1f} s")
    f = ranks[0]["4f"]
    launch_rows = {label: [r["4f"]["launches"][label] for r in ranks]
                   for label in f["launches"]}
    for label, got in launch_rows.items():
        blocks = len(HEAD_SUPER) if label.startswith("streamed") else 1
        check(sum(got) == WORLD * blocks, f"4f {label}: launches {got}")
    print(f"[4f sharded at full width] headline 147//160 on {N_HEAD} "
          f"samples over (1, 4) ({N_HEAD // WORLD} a shard): max error "
          f"{f['headline'][0]:.3e} of max|y| against the unsharded filt on "
          f"the card (limit {TOL_SHARD_FULL}), oracle rel RMS "
          f"{f['headline'][1]:.3e} (limit {TOL_ORACLE}); the same samples "
          f"streamed in super-blocks {HEAD_SUPER} through shard_filt_block + "
          f"compact: {f['stream']:.3e}, counts and state exact; "
          + "; ".join(f"MultiChannelResampler(0.9173, nphi=32, polyorder=4)"
                      f" on {MC_SHAPE} over {shape} (T = {T}): {e:.3e}, "
                      f"oracle rel RMS {o:.3e}"
                      for shape, (e, o, T) in f["mc"].items())
          + "; launches a rank: "
          + "; ".join(f"{label} {got}" for label, got in launch_rows.items()))
    five = [r["5f"] for r in ranks]
    print(f"[5f per-shard times] headline on (1, 4), {five[0]['shard']} "
          f"samples a shard, median of 7: kernel ms by rank (CUDA events, "
          f"each rank alone) "
          + str([round(s["kernel_ms"], 4) for s in five])
          + ", halo and history broadcast ms by rank (through the host, "
          + "all ranks together, host clock between synchronizes) "
          + str([round(s["halo_ms"], 4) for s in five])
          + f"; rank 0's shard: kernel vs plain max abs err "
          f"{five[0]['max_abs_err']:.3e}, plain {five[0]['plain_ms']:.3f} "
          f"ms, bound "
          f"{five[0]['bound'][0]:.4f} ms ({five[0]['bound'][1]}); card: "
          f"{card}")
    kernel = [s["kernel_ms"] for s in five]
    return dict(
        launches=sum(launch_rows["headline (1, 4)"]),
        max_abs_err=five[0]["max_abs_err"], ms=statistics.median(kernel),
        plain_ms=five[0]["plain_ms"], bound_ms=five[0]["bound"][0],
        bound_by=five[0]["bound"][1], library_ms=None,
        halo_ms=statistics.median(s["halo_ms"] for s in five))


def phase_sharded_nccl(mt, torch, dev, pp, x):
    """4f, NCCL: a world of one with the nccl backend on the card; the
    headline through ``sharded_resample`` on (1, 1), then steady-state
    ``shard_filt_block`` + ``compact_device`` blocks with no
    device-to-host sync allowed."""
    import torch.distributed as dist

    from multirate_tpu_torch.parallel import initialize, make_mesh
    from multirate_tpu_torch.parallel import sharded as sh

    initialize(backend="nccl")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"world {dist.get_backend()} x {dist.get_world_size()}")
        mesh = make_mesh(1, 1)
        h = headline_taps(mt)
        p = mt.make_kernel(h, ratio=Fraction(147, 160), device=dev)
        x2 = x.view(1, -1)
        y = sh.sharded_resample(p, x2, mesh)
        whole = mt.filt(h, x2, Fraction(147, 160))
        check(torch.equal(y, whole), "nccl (1, 1): differs from filt")
        blk = x2[:, :65_600]
        st = mt.init_state(p, (1,), device=dev)
        yb, counts, st = sh.shard_filt_block(p, st, blk, mesh)  # warm up
        sh.compact_device(yb, counts, mesh)
        torch.cuda.synchronize()
        _reset_counts(pp)
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = []
            for b in range(1, 9):
                yb, counts, st = sh.shard_filt_block(
                    p, st, x2[:, b * 65_600:(b + 1) * 65_600], mesh)
                outs.append(sh.compact_device(yb, counts, mesh))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        n = pp.launches["f32"]
        check(n == 8, f"nccl steady state: {n} launches")
        got = torch.cat([d[:, :t] for d, t in outs], -1)
        n0 = mt.outputlength(65_600, Fraction(147, 160))
        ref = whole[:, n0:n0 + got.shape[-1]]
        err = float((got - ref).abs().max() / ref.abs().max())
        check(err <= TOL_SHARD_FULL, f"nccl steady state: {err:.3e}")
    finally:
        dist.destroy_process_group()
    print(f"[4f nccl] world of 1, backend nccl on the card: headline "
          f"through sharded_resample on (1, 1) equal to filt bit for bit; "
          f"8 steady-state blocks of 65,600 through shard_filt_block + "
          f"compact_device under set_sync_debug_mode('error'): no sync, "
          f"{n} launches, max error {err:.3e} of max|y| against filt")


def phase_scaling(card):
    """5f: ``parallel.scaling_bench`` on the card with WORLD ranks."""
    from multirate_tpu_torch.parallel import scaling_bench

    t0 = time.perf_counter()
    got = scaling_bench.run("cuda", WORLD, timeout_s=RANK_TIMEOUT_S)
    print(f"[5f scaling_bench] {json.dumps(got)}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")
    return got


# --------------------------------------------------------------------------- #
# 3g-4g: bf16 and int8 signals at an arbitrary or Farrow rate
# --------------------------------------------------------------------------- #

def phase_rate_quant_vs_plain(mt, torch, dev, rs):
    """3g: the widened route (one cast to float32, the float32 kernel)
    against its plain version on the same values."""
    ha = bench_taps(mt)
    rng = np.random.default_rng(31)
    _reset_counts(rs)
    cases, worst = 0, 0.0
    for mode in (torch.bfloat16, torch.int8):
        for rate in (R_REF, 0.4709, 0.9173):
            for po in (None, 4):
                p = mt.make_kernel(ha, rate=rate, nphi=32, polyorder=po,
                                   device=dev)
                for ch in (1, 64):
                    x = _as_mode(mt, torch, torch.from_numpy(
                        rng.standard_normal((ch, 20_011)).astype(
                            np.float32)), mode).to(dev)
                    for phase in (None, 0.37):
                        st = mt.init_state(p, (ch,), mode)
                        if phase is not None:
                            st = mt.setphase(p, st, phase)
                        yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
                        yp, cp, sp = mt.filt_block(p, st, x, path="windows")
                        torch.cuda.synchronize()
                        label = f"{mode} {rate:.6g} P{po} {ch}ch {phase}"
                        check(ck == cp and yk.dtype == torch.float32
                              and (sk.phase, sk.deficit)
                              == (sp.phase, sp.deficit)
                              and torch.equal(sk.history, sp.history),
                              f"3g {label}: counts or states differ")
                        err = float((yk - yp).abs().max()
                                    / yp.abs().max())
                        check(err <= TOL_KERNEL, f"3g {label}: {err:.3e}")
                        worst = max(worst, err)
                        cases += 1
    by_variant = _by_variant(rs)
    check(rs.launches["f32"] == cases, f"3g launches {rs.launches}")
    print(f"[3g widened rate vs plain] {cases} cases (bf16 and int8; "
          f"arbitrary and Farrow at 1/2.123456789, 0.4709, 0.9173; 1 and 64 "
          f"channels; fresh and after setphase(0.37)): counts and states "
          f"exact, worst {worst:.3e} of max|y| (limit {TOL_KERNEL}); "
          f"launches {by_variant}")
    return worst


def phase_rate_quant_slice(mt, torch, dev, rs, x, card):
    """4g: 8 M bf16 samples at 1/2.123456789 and 0.4709 (Farrow) through
    ``filt`` and ``FIRFilter``, against the float64 oracles over the same
    bf16 values; times of the widened route, its kernel alone on the
    widened values, the float32 row on the same values and the plain
    version, and the int8 route's."""
    from multirate_tpu_torch.ops import indexing as idx
    from multirate_tpu_torch.utils.oracle import naivefilt, naivefilt_farrow

    ha = bench_taps(mt)
    xb = x.to(torch.bfloat16)
    xb_np = xb.float().cpu().numpy()
    rows = (("arbitrary", R_REF, None, TOL_ORACLE_ARB_REF),
            ("Farrow", 0.4709, 4, TOL_ORACLE))
    _reset_counts(rs)
    runs = []
    for _, rate, po, _ in rows:
        y = mt.filt(ha, xb, rate, 32, po)
        f = mt.FIRFilter(ha, rate, 32, po)
        runs.append((y, [f.filt(xb[i:i + CHUNK])
                         for i in range(0, N_HEAD, CHUNK)], f))
    torch.cuda.synchronize()
    launches, by_variant = rs.launches["f32"], _by_variant(rs)
    n_chunks = len(runs[0][1])
    check(launches == 2 * (1 + n_chunks) and by_variant == {
        "f32/t10p2": 1 + n_chunks, "f32/t10p5": 1 + n_chunks},
        f"4g launches {by_variant}")
    notes = []
    for (label, rate, po, limit), (y, parts, f) in zip(rows, runs):
        n_want = mt.outputlength(f.params, N_HEAD)
        check(y.dtype == torch.float32 and tuple(y.shape) == (n_want,)
              and bool(torch.isfinite(y).all()), f"4g {label}: {y.shape}")
        yc = torch.cat(parts)
        _, u_end, d_end = idx.host_carry(f.params, 0, 1, N_HEAD)
        check(tuple(yc.shape) == (n_want,) and (f.state.phase, f.state.deficit)
              == (u_end, d_end), f"4g {label}: chunked count or state")
        d = yc.double() - y.double()
        rms_chunk = float(torch.sqrt(torch.mean(d * d)))
        check(rms_chunk <= TOL_CHUNKED, f"4g {label}: chunked {rms_chunk}")
        n_in = mt.inputlength(f.params, N_ORACLE)
        x_in = xb_np[:n_in].astype(np.float64)
        ref = (naivefilt(ha.astype(np.float64), x_in, rate, 32) if po is None
               else naivefilt_farrow(ha.astype(np.float64), x_in, rate, 32,
                                     po))[:N_ORACLE]
        rel = _rel_rms(y[:N_ORACLE].double().cpu().numpy(), ref)
        check(rel <= limit, f"4g {label}: oracle rel RMS {rel:.3e}")
        notes.append(f"{label} {rate:.9g} on {N_HEAD} bf16 -> {n_want}: "
                     f"oracle rel RMS {rel:.3e} (limit {limit}), "
                     f"{n_chunks} chunks: chunked-vs-whole RMS "
                     f"{rms_chunk:.3e}")
        del parts, yc

    # times: the widened route (cast + kernel), the kernel alone on the
    # widened values, the float32 row on the same values, plain; int8
    p = mt.make_kernel(ha, rate=R_REF, nphi=32, device=x.device)
    n = mt.outputlength(p, N_HEAD)
    x8 = _as_mode(mt, torch, x, torch.int8)
    out, t_notes = {}, []
    for name, xs in (("bf16", xb), ("int8", x8)):
        st = mt.init_state(p, (), xs.dtype)
        xw = xs.float().view(1, -1)
        hist = torch.zeros(1, p.h_min, device=x.device)
        args = (xw, hist, p, 0, 1, n)
        yk = mt.filt_block(p, st, xs)[0]
        yp = mt.filt_block(p, st, xs, path="windows")[0]
        max_abs = float((yk - yp).abs().max())
        check(max_abs <= TOL_KERNEL * float(yp.abs().max()),
              f"4g {name}: route vs plain {max_abs:.3e}")
        del yk, yp
        route_ms = _time_ms(torch, lambda: mt.filt_block(p, st, xs), 20)
        kernel_ms = _time_ms(torch, lambda: rs.resample(*args), 20)
        plain_ms = _time_ms(torch, lambda: mt.filt_block(
            p, st, xs, path="windows"), 2)
        # the narrow signal and history read once, the table once, the
        # float32 outputs written once; 2T multiply-adds an output
        nbytes = (xs.numel() + p.h_min) * xs.element_size() \
            + p.bank.numel() * 4 + n * 4
        bound = _bound(nbytes, n * p.bank.numel() // p.nphi, "f32")
        out[name] = dict(max_abs_err=max_abs, ms=route_ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=None, kernel_ms=kernel_ms)
        t_notes.append(f"{name} in: route (cast + kernel) {route_ms:.4f} ms, "
                       f"kernel alone on the widened values {kernel_ms:.4f} "
                       f"ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
                       f"({bound[1]}, narrow input bytes)")
    xf = xb.float().view(1, -1)
    f32_ms = _time_ms(torch, lambda: rs.resample(
        xf, torch.zeros(1, p.h_min, device=x.device), p, 0, 1, n), 20)
    t_notes.append(f"the float32 row on the same values {f32_ms:.4f} ms")
    out["bf16"]["launches"] = launches
    out["bf16"]["f32_ms"] = f32_ms
    print(f"[4g widened rate slice] {'; '.join(notes)}; launches "
          f"{by_variant}; times at 1/2.123456789 on {N_HEAD}, CUDA events: "
          f"{'; '.join(t_notes)}; card: {card}")
    return out


# --------------------------------------------------------------------------- #
# 4h: the example flows on the card
# --------------------------------------------------------------------------- #

def phase_examples(torch, pp, rs):
    """4h: each example module's ``main()`` on the card, with the shrink
    keywords ``tests/test_examples.py`` uses, and ``wav_resample --demo``
    with its amplitude check; each flow's kernel launches counted."""
    import contextlib
    import importlib
    import io

    from multirate_tpu_torch import examples

    shrink = {"arb_farrow_speed": dict(
        n_samples=20_000, rates=(1 / 2.123456789,), dtypes=(np.float32,),
        repeat=3, iters=2)}
    notes = []
    for name in examples.FLOWS:
        mod = importlib.import_module(f"multirate_tpu_torch.examples.{name}")
        buf = io.StringIO()
        _reset_counts(pp)
        _reset_counts(rs)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = (mod.main(["--demo"]) if name == "wav_resample"
                   else mod.main(**shrink.get(name, {})))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = _launched(pp, rs)
        check(buf.getvalue() and n > 0,
              f"4h {name}: {n} kernel launches, output "
              f"{buf.getvalue()[:200]!r}")
        if name == "wav_resample":
            check(0.45 < got < 0.55, f"4h wav_resample amplitude {got}")
            name = f"{name} --demo (amplitude {got:.3f})"
        notes.append(f"{name} {secs:.2f} s, {n} launches")
    print(f"[4h examples on the card] {'; '.join(notes)}")


def main() -> int:
    try:
        import torch

        card = phase_device(torch)
        import multirate_tpu_torch as mt
        from multirate_tpu_torch.ops.cuda import polyphase as pp
        from multirate_tpu_torch.ops.cuda import probe
        from multirate_tpu_torch.ops.cuda import resample as rs

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_build()
        phase_kernel_vs_plain(mt, torch, dev, pp)
        phase_resample_vs_plain(mt, torch, dev, rs)
        phase_quant_vs_plain(mt, torch, dev, pp)
        phase_wide_vs_plain(mt, torch, dev, pp, rs)
        phase_probe_vs_plain(torch, dev, probe)
        h, x, launches, ref = phase_slice(mt, torch, dev, pp)
        xa, x64, rs_launches = phase_resample_slice(mt, torch, dev, rs)
        q_launches = phase_quant_slice(mt, torch, dev, pp, x, ref)
        xc, xd, w_launches = phase_wide_slice(mt, torch, dev, pp, rs, x, ref)
        phase_runtime(mt, torch, dev, pp, rs, x, card)
        head = phase_times(mt, torch, h, x, pp, card)
        rows = phase_resample_times(mt, torch, xa, x64, rs, card)
        q_rows = phase_quant_times(mt, torch, x, pp, card)
        w_rows = phase_wide_times(mt, torch, xc, xd, pp, rs, card)
        e_rows, p_launches = phase_runtime_times(mt, torch, x, xc, pp, rs,
                                                 probe, card)
        f_row = phase_sharded(mt, torch, card)
        phase_sharded_nccl(mt, torch, dev, pp, x)
        phase_rate_quant_vs_plain(mt, torch, dev, rs)
        g_rows = phase_rate_quant_slice(mt, torch, dev, rs, x, card)
        phase_examples(torch, pp, rs)
        phase_scaling(card)
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
        "library_ms": None,
        **head,
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
        "general_ms": rows["arbitrary_refrate"][4],
        "variant": rows["arbitrary_refrate"][5],
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
        "general_ms": rows["farrow_64ch_tmajor"][4],
        "variant": rows["farrow_64ch_tmajor"][5],
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
    # the probes: launches by utils.metrics' ceiling calls of phase 5e,
    # times at 32 M float32 (copy) and 8 M float32 in at 1:4 (expand, one
    # row for each store type)
    for name, line, launched in (
            ("probe_copy", 294, p_launches["copy"]),
            *((_expand_row(probe, odt), 355, p_launches[entry])
              for odt, entry in probe.EXPAND.items())):
        kernels.append({"name": name, "route": "cuda",
                        "source": "multirate_tpu_torch/csrc/probe.cu",
                        "replaces": f"multirate_tpu/utils/metrics.py:{line}",
                        "launches": launched, **e_rows[name]})
    # this slice's paths: the sharded headline on (1, 4), 4 gloo ranks on
    # one card (launches summed over the ranks; times per shard), and bf16
    # at 1/2.123456789 through the widened route (times: cast + kernel)
    kernels.append({"name": "polyphase_f32_sharded", "route": "cuda",
                    "source": "multirate_tpu_torch/csrc/polyphase.cu",
                    "replaces": zc, **f_row})
    g = g_rows["bf16"]
    kernels.append({"name": "resample_f32_bf16in", "route": "cuda",
                    "source": "multirate_tpu_torch/csrc/resample.cu",
                    "replaces": "multirate_tpu/ops/pallas/select3.py:319, "
                                "multirate_tpu/ops/pallas/select3.py:347",
                    "launches": g["launches"],
                    "max_abs_err": g["max_abs_err"],
                    **{k: g[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "kernel_ms", "f32_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
