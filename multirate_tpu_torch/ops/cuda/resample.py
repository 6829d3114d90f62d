"""The arbitrary-rate and Farrow kernel: its wrappers, launch counts and
plain versions.

``resample`` (channel-major, x (C, xlen) -> y (C, n_out)) and
``resample_tm`` (time-major, x (xlen, C) -> y (n_out, C)) compute, for
every channel c and output n < n_out of an FIRArbitrary or FIRFarrow
kernel entered at accumulator u0 and deficit d0,

    u_n = u0 + n*delta_fx,  D = nphi << 32
    in_n = d0 + u_n div D,  phi_n = (u_n mod D) >> 32,
    alpha_n = (u_n mod 2^32) * 2^-32
    arbitrary: tap_n[t] = pfb[t, phi_n] + alpha_n * dpfb[t, phi_n]
    Farrow:    tap_n[t] = sum_p coeffs[p, t] * psi_n^p,
               psi_n = 1 + phi_n + alpha_n
    y[c, n] = sum_{t < T} xext[c, in_n - 1 + t] * tap_n[t]

with xext = [hist ++ x] and hist the trailing T - 1 samples, channel-major
(C, T - 1) in both layouts. This is what the TPU kernels of
``multirate_tpu/ops/pallas/`` gridsel.py, select4.py, select3.py and
select.py compute for the arbitrary/Farrow family, in float32, float64 and
complex (JAX runs complex as re/im planes and split tap banks). On a CUDA
tensor the wrappers launch the hand-written kernel in ``csrc/resample.cu``
(see its header for the design and what bounds it); on a CPU tensor they
run ``resample_plain`` / ``resample_tm_plain``, the same function in plain
PyTorch. There is no fallback from one to the other.

x and hist share the signal type; the table is its real type, or its own
type for complex taps (``ENTRIES``); y has the signal's type. Narrow reads
(int16, uint8, float16, bfloat16 and int8 samples, ``dtypes.NARROW``) take a
float32 table: the kernel stages the samples as stored and widens them to
float32 in shared memory, so each output is bit-equal to the float32
entry's on the widened values; y is float32, or float16 (the output type
of float16 taps), stored narrow by the kernel. A real signal against a
complex table (float32 or a narrow read against complex64, float64
against complex128: ``f32c``, ``f64c``, ``<short name>c``) is read as
stored and sums in the table's type, 2 real multiply-adds a tap; y has
the table's type, bit-equal to the ``c64c``/``c128c`` entry's on the
samples cast to complex (up to the sign of a zero). The time-major kernel
takes float32 and the narrow reads against float32 tables
(``TM_ENTRIES``).

The kernel has variants (``VARIANTS``), chosen by ``plan`` from the shape
alone, never after a failure: one compiled for each (T, P+1) pair in use
(``COMPILED``: bench.py's bank at T = 10 with P+1 = 2 or 5, and
``models.Resampler``'s own design at T = 73, P+1 = 2), with both loops
unrolled, and ``general``, which runs both loops to run-time bounds; the
grouped one-channel path of bench.py's pairs (``GROUPED``), where a
thread runs outputs a phase-preserving stride apart with its phase's table
words in registers; and, for float32 samples in one channel, the same path
fed by a producer warp's bulk copies into a ring and stored by bulk copies
(``GROUPED_TMA``). Every variant gives the same bits. ``plan`` also sizes
the tile, the channels a block shares its taps across and the grid, so
that the grid fills the card. ``resample(..., variant="general")`` forces
the general variant, and a compiled variant's name its run path, for
timing against them. ``walk_positions`` transcribes the kernel's
division-free index walk, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...utils.profiling import recording, span
from ..dtypes import NARROW, NARROW_COMPLEX, NARROW_OUT
from ..indexing import ACCUM_OPERAND_BITS, _muladd_divmod, accum_indices
from ..params import PHASE_FRAC_BITS, FIRArbitrary, FIRFarrow
from ..precision import fp32
from .build import ERROR_STRING, check_aligned, launch, load

__all__ = ["resample", "resample_tm", "resample_plain", "resample_tm_plain",
           "plan", "Plan", "walk_positions", "launches",
           "launches_by_variant", "ENTRIES", "TM_ENTRIES", "VARIANTS",
           "COMPILED", "GROUPED", "GROUPED_TMA"]

_F32, _F16 = torch.float32, torch.float16
# The kernel's channel-major entry point (``mr_resample_<name>``, one
# instantiation of csrc/resample.cu) for each (signal, table, output)
# dtype triple. The narrow reads (``dtypes.NARROW``, against float32
# tables) take their type's short name; a float16 output is the
# ``_f16out`` form of one.
ENTRIES = {
    (_F32, _F32, _F32): "f32",
    (torch.float64, torch.float64, torch.float64): "f64",
    (torch.complex64, _F32, torch.complex64): "c64",
    (torch.complex64, torch.complex64, torch.complex64): "c64c",
    (torch.complex128, torch.float64, torch.complex128): "c128",
    (torch.complex128, torch.complex128, torch.complex128): "c128c",
    # in name order; bfloat16 with float16 taps is float32: no bf16_f16out
    **{(x, _F32, o): n if o == _F32 else f"{n}_f16out"
       for o in NARROW_OUT for x, n in sorted(NARROW.items(),
                                              key=lambda e: e[1])
       if (x, o) != (torch.bfloat16, _F16)},
    # real samples against complex tables, read as stored
    (_F32, torch.complex64, torch.complex64): "f32c",
    (torch.float64, torch.complex128, torch.complex128): "f64c",
    **{(x, NARROW_COMPLEX, NARROW_COMPLEX): f"{n}c"
       for x, n in sorted(NARROW.items(), key=lambda e: e[1])},
}
# The time-major forms, of float32 and the narrow reads against float32
# tables: the same entry points with a layout argument, counted as
# ``"<entry>_tm"``.
TM_ENTRIES = {k: f"{n}_tm" for k, n in ENTRIES.items()
              if k[0] in (_F32, *NARROW) and k[1] == _F32}

# The kernel's variants, by the number its entry points take, and the
# (T, P+1) pair each compiled one is built for; the grouped one-channel
# path of a compiled pair whose table words a thread holds in registers;
# and that path fed by a producer warp's bulk copies, for float32 samples.
VARIANTS = ("general", "t10p2", "t10p5", "t73p2", "t10p2.grouped",
            "t10p5.grouped", "t10p2.grouped.tma", "t10p5.grouped.tma")
COMPILED = {(10, 2): "t10p2", (10, 5): "t10p5", (73, 2): "t73p2"}
GROUPED = {"t10p2": "t10p2.grouped", "t10p5": "t10p5.grouped"}
GROUPED_TMA = {"t10p2": "t10p2.grouped.tma", "t10p5": "t10p5.grouped.tma"}

# Kernel launches made by ``resample`` and ``resample_tm`` in this
# process, by entry point (time-major ``"<entry>_tm"``: ``"f32_tm"``,
# ``"s16_tm"``), and by entry point and variant (``"f32/t10p2"``,
# ``"f32_tm/t10p5"``). Each grows by one where its kernel is launched and
# nowhere else; a caller may reset them.
launches = dict.fromkeys([*ENTRIES.values(), *TM_ENTRIES.values()], 0)
launches_by_variant = {f"{e}/{v}": 0 for e in (*ENTRIES.values(),
                                               *TM_ENTRIES.values())
                       for v in VARIANTS}

_N_OUT_LIMIT = 1 << 40  # keeps u0 + n_out*delta_fx below the kernel's 2^96

# The C signatures for ``build.load``: each entry point of csrc/resample.cu
# (x, hist, table, y, C, xlen, T, nphi, P+1, delta_fx, u0, d0, n_out, the
# layout where it has a time-major form, then the plan's variant, tile,
# channels, run, grid, stride, mult and depth, and the stream), and the
# planner's chooser in csrc/mr_plan.cpp.
_P, _C_I64, _C_U64, _C_INT = (ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_uint64, ctypes.c_int)
SIGNATURES = (*((f"mr_resample_{name}", _C_INT,
                 (_P,) * 4 + (_C_I64, _C_I64) + (_C_INT,) * 3
                 + (_C_U64, _C_U64, _C_I64, _C_I64)
                 + (_C_INT,) * (1 + (key in TM_ENTRIES)) + (_C_INT,) * 3
                 + (_C_I64, _C_INT, _C_INT, _C_INT, _P))
                for key, name in ENTRIES.items()), ERROR_STRING)
PLAN_SIGNATURES = (("mr_resample_plan", _C_INT,
                    (_C_INT,) * 3 + (_C_I64,) * 3 + (_C_INT,) * 10 + (_P,)),)


def _sum_type(x_dtype, table_dtype):
    """The type a call sums in: a complex table's for a real signal, else
    the signal's (float32 for a narrow read)."""
    if table_dtype.is_complex and not x_dtype.is_complex:
        return table_dtype
    return _F32 if x_dtype in NARROW else x_dtype


class Plan(NamedTuple):
    """One launch: the variant, outputs a tile, channels a block (1 or 8
    channel-major, 32 time-major), neighbouring outputs a thread runs (one-
    channel blocks; else 1), blocks on grid.x (at most: the launcher keeps
    no more than the card holds at once), threads a block, shared bytes
    a block, a grouped path's phase-preserving stride and lane multiplier
    (else 0), and a grouped.tma plan's ring stages (else 0)."""
    variant: str
    tile: int
    channels: int
    run: int
    grid: int
    threads: int
    smem: int
    stride: int = 0
    mult: int = 0
    depth: int = 0


@functools.lru_cache(maxsize=1024)
def plan(T: int, P1: int, nphi: int, delta_fx: int, n_out: int, C: int,
         x_dtype, table_dtype, time_major: bool = False,
         variant: str | None = None) -> Plan:
    """The launch of one resample call: the variant (by default the
    compiled one for (T, P1) if its table fits in shared memory, else
    ``general``; its grouped path where that compiled pair has one, the
    table is float32, the signal float32 or a narrow read, the blocks
    channel-major with one channel, the rate has a phase-preserving stride
    and the card's share of the call gives each thread 8 outputs a tile at
    least; that path's grouped.tma form where the signal is float32 in one
    channel), the tile, the channels a block and the grid. Chosen on the
    shape by the planner library (csrc/mr_plan.cpp, built with g++ at first
    use) from the launcher's own geometry, and cached: a stream plans the
    same few shapes again. Raises ValueError if ``variant`` is named and
    cannot take the call, or if one tile's span cannot fit in shared
    memory."""
    return _plan(T, P1, nphi, delta_fx, n_out, C, x_dtype, table_dtype,
                 time_major, variant)


def _plan(T, P1, nphi, delta_fx, n_out, C, x_dtype, table_dtype, time_major,
          variant, run=0, rows=0, depth=0) -> Plan:
    """``plan``, uncached; ``run``, ``rows`` and ``depth`` set the run
    path's outputs a thread, a grouped path's outputs a thread a tile and
    grouped.tma's ring stages (0: the planner's), for the sweeps of
    tools/resample_runs.py."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    out = (ctypes.c_int64 * 10)()
    err = load("mr_plan", PLAN_SIGNATURES).mr_resample_plan(
        T, P1, nphi, delta_fx, max(int(n_out), 1), C, x_dtype.itemsize,
        table_dtype.itemsize, _sum_type(x_dtype, table_dtype).itemsize,
        x_dtype in NARROW, table_dtype == _F32 and x_dtype in (_F32, *NARROW),
        time_major, -1 if variant is None else VARIANTS.index(variant), run,
        rows, depth, out)
    if err == -1:
        t_bytes = P1 * T * nphi * table_dtype.itemsize
        raise ValueError(f"the {variant} variant cannot take T={T} "
                         f"P+1={P1} with a {t_bytes}-byte {table_dtype} "
                         f"table, {C} channel(s) of {x_dtype}"
                         f"{', time-major' if time_major else ''}")
    if err == -2:
        raise ValueError(f"no {variant} tile fits a span at "
                         f"delta_fx={delta_fx}")
    if err:
        raise ValueError("one output's window exceeds shared memory")
    return Plan(VARIANTS[out[0]], *out[1:])


def _digits(v: int, nphi: int):
    """A step v in digits: (quotient by D, phase, 32-bit fraction)."""
    D = nphi << PHASE_FRAC_BITS
    return v // D, (v % D) >> PHASE_FRAC_BITS, v & ((1 << PHASE_FRAC_BITS) - 1)


def _add(a, d, nphi: int):
    """csrc/resample.cu ``add``: (off, phi, fr) + digits, with carries."""
    one = 1 << PHASE_FRAC_BITS
    fr = a[2] + d[2]
    c1 = (fr >= one).long()
    phi = a[1] + d[1] + c1
    c2 = (phi >= nphi).long()
    return a[0] + d[0] + c2, phi - c2 * nphi, fr - c1 * one


def _tile_bases(starts, nphi: int, delta_fx: int, u0: int):
    """(q0, r0) = divmod(u0 + n0*delta_fx, D) of every tile's first output
    n0, exact (the kernel's 128-bit product and division)."""
    D = nphi << PHASE_FRAC_BITS
    bases = [divmod(u0 + n0 * delta_fx, D) for n0 in starts]
    return (torch.tensor([b[0] for b in bases], dtype=torch.int64),
            torch.tensor([b[1] for b in bases], dtype=torch.int64))


def _tiles(p: Plan, n_out: int, blocks: int):
    """(first output, outputs) of each tile: tiles of ``p.tile`` from 0, or
    for a grouped.tma plan from the start of each of ``blocks`` blocks' even
    shares of the call's 16-byte words, the last of each share short."""
    if p.variant not in GROUPED_TMA.values():
        return [(n0, min(p.tile, n_out - n0))
                for n0 in range(0, n_out, p.tile)]
    words = -(-n_out // 4)
    tiles = []
    for b in range(blocks):
        b0 = 4 * (words * b // blocks)
        b1 = min(n_out, 4 * (words * (b + 1) // blocks))
        tiles += [(n0, min(p.tile, b1 - n0)) for n0 in range(b0, b1, p.tile)]
    return tiles


def _grouped_positions(p: Plan, nphi: int, delta_fx: int, u0: int,
                       n_out: int, blocks: int):
    """``walk_positions`` of a grouped plan: thread i < stride runs the
    outputs j = (i*mult mod stride) + stride*r (r < tile / stride) of each
    tile, from its first output's digits, by adding the stride's digits."""
    tiles = _tiles(p, n_out, blocks)
    n0 = torch.tensor([t[0] for t in tiles], dtype=torch.int64)
    nt = torch.tensor([t[1] for t in tiles], dtype=torch.int64)
    q0, r0 = _tile_bases(n0.tolist(), nphi, delta_fx, u0)
    start = (torch.zeros_like(r0), r0 >> PHASE_FRAC_BITS,
             r0 & ((1 << PHASE_FRAC_BITS) - 1))
    j0 = torch.arange(p.stride) * p.mult % p.stride
    first = [torch.tensor(d) for d in zip(*(_digits(int(j) * delta_fx, nphi)
                                            for j in j0.tolist()))]
    pos = _add(tuple(a[:, None] for a in start), first, nphi)
    step = _digits(p.stride * delta_fx, nphi)
    q = torch.empty(n_out, dtype=torch.int64)
    phi, fr = torch.empty_like(q), torch.empty_like(q)
    for r in range(p.tile // p.stride):
        j = (j0 + p.stride * r)[None, :]
        ok = j < nt[:, None]  # the tile's outputs
        at = (n0[:, None] + j)[ok]
        q[at] = (q0[:, None] + pos[0])[ok]
        phi[at], fr[at] = pos[1][ok], pos[2][ok]
        pos = _add(pos, step, nphi)
    return q, phi, fr


def walk_positions(p: Plan, nphi: int, delta_fx: int, u0: int,
                   n_out: int, blocks: int | None = None):
    """The kernel's index walk, transcribed: (q, phi, frac) of every
    output n < n_out, with (q, phi) = divmod((u0 + n*delta_fx) div 2^32,
    nphi) and frac the low 32 bits, as int64 tensors. A grouped plan's
    threads walk their progressions (``_grouped_positions``); a grouped.tma
    launch's tiles start at each of its ``blocks`` blocks' share of the call
    (by default ``p.grid``; the card runs as many as it holds at once).

    A tile's base (q0, r0) = divmod(u0 + n0*delta_fx, D) is formed once, in
    128 bits. Thread t of a block runs outputs t*run + s (s < run) in each
    round of threads*run outputs. Once a launch it splits its first step,
    t*run*delta_fx, the step to its next output, delta_fx, and the step
    from its last output of a round to its first of the next,
    (threads - 1)*run*delta_fx, into digits (quotient by D, phase, 32-bit
    fraction), then walks its outputs by adding digits with carries: no
    division per output. (A time-major block's taps take run 1.)"""
    if p.variant in (*GROUPED.values(), *GROUPED_TMA.values()):
        return _grouped_positions(p, nphi, delta_fx, u0, n_out,
                                  blocks or p.grid)
    n_tiles = -(-n_out // p.tile)
    q0, r0 = _tile_bases(range(0, n_out, p.tile), nphi, delta_fx, u0)
    start = (torch.zeros_like(r0), r0 >> PHASE_FRAC_BITS,
             r0 & ((1 << PHASE_FRAC_BITS) - 1))
    q = torch.empty(n_tiles, p.tile, dtype=torch.int64)
    phi, fr = torch.empty_like(q), torch.empty_like(q)
    run = p.run
    step = _digits(delta_fx, nphi)
    next_round = _digits((p.threads - 1) * run * delta_fx, nphi)
    for t in range(p.threads):
        pos = _add(start, _digits(t * run * delta_fx, nphi), nphi)
        for j0 in range(t * run, p.tile, p.threads * run):
            for j in range(j0, j0 + run):
                if j < p.tile:
                    q[:, j] = q0 + pos[0]
                    phi[:, j], fr[:, j] = pos[1], pos[2]
                pos = _add(pos, step, nphi)
            pos = _add(pos, next_round, nphi)
    return (q.reshape(-1)[:n_out], phi.reshape(-1)[:n_out],
            fr.reshape(-1)[:n_out])


def _taps_plain(params, phi, frac):
    """(n, T) taps in the table's type, as the JAX ``windows`` path forms
    them: arbitrary from the banks and alpha in their precision, Farrow
    from the float64 (or complex128) fit evaluated at psi."""
    tdt = params.table.dtype
    if isinstance(params, FIRArbitrary):
        alpha = frac.to(tdt.to_real())[:, None]
        return params.table[0].t()[phi] + alpha * params.table[1].t()[phi]
    psi = 1.0 + phi.to(torch.float64) + frac
    powers = psi[:, None] ** torch.arange(
        params.polyorder + 1, dtype=torch.float64, device=psi.device)[None, :]
    return (powers.to(params.coeffs.dtype) @ params.coeffs).to(tdt)


def resample_plain(x, hist, params, u0: int, d0: int, n_out: int,
                   out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of ``resample``: int64 accumulator indices, a
    window gather and an einsum in the type the kernel sums in: the
    signal's (real taps cast to it; a narrow read's samples widened to
    float32), or a complex table's for a real signal (the samples widened
    to it), stored as ``out_dtype``. Runs on any device."""
    T = params.taps_per_phi
    xext = torch.cat([hist, x], dim=-1)
    inp, phi, frac = accum_indices(params.nphi, params.delta_fx, u0, d0,
                                   n_out, device=x.device)
    ind = (inp - 1)[:, None] + torch.arange(T, device=x.device)[None, :]
    ct = _sum_type(x.dtype, params.table.dtype)
    windows = xext[:, ind].to(ct)                 # (C, n_out, T)
    with fp32():
        taps = _taps_plain(params, phi, frac)     # (n_out, T)
        y = torch.einsum("cnt,nt->cn", windows, taps.to(ct))
    return y if out_dtype is None else y.to(out_dtype)


def resample_tm_plain(xt, hist, params, u0: int, d0: int, n_out: int,
                      out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of ``resample_tm``: (xlen, C) -> (n_out, C)."""
    return resample_plain(xt.t(), hist, params, u0, d0, n_out,
                          out_dtype).t().contiguous()


def _out_of(x_dtype, table_dtype, out_dtype):
    """The output type of a call: ``out_dtype``, by default the type it
    sums in."""
    return _sum_type(x_dtype, table_dtype) if out_dtype is None else out_dtype


def _check(x, hist, params, u0, d0, n_out, out_dtype, time_major):
    key = (x.dtype, params.table.dtype, out_dtype)
    if key not in (TM_ENTRIES if time_major else ENTRIES):
        raise TypeError(f"no {'time-major ' if time_major else ''}resample "
                        f"kernel for {x.dtype} samples, a "
                        f"{params.table.dtype} table and {out_dtype} "
                        f"outputs")
    for name, t in (("x", x), ("hist", hist), ("table", params.table)):
        if name == "hist" and t.dtype != x.dtype:
            raise TypeError(f"hist is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    C, xlen = (x.shape[1], x.shape[0]) if time_major else x.shape
    T, nphi = params.taps_per_phi, params.nphi
    if params.table.dim() != 3 or params.table.shape[1:] != (T, nphi):
        raise ValueError(f"table must be (P+1, {T}, {nphi}), got "
                         f"{tuple(params.table.shape)}")
    if tuple(hist.shape) != (C, T - 1):
        raise ValueError(f"hist must be {(C, T - 1)}, "
                         f"got {tuple(hist.shape)}")
    D = nphi << PHASE_FRAC_BITS
    bound = 1 << ACCUM_OPERAND_BITS
    if not (0 < D < bound and 0 < params.delta_fx < bound and T >= 1):
        raise ValueError(f"geometry out of range: nphi={nphi} "
                         f"delta_fx={params.delta_fx} T={T}")
    if not (0 <= u0 < bound and d0 >= 1 and 0 <= n_out < _N_OUT_LIMIT):
        raise ValueError(f"bad entry state u0={u0} d0={d0} n_out={n_out}")
    if n_out and d0 + _muladd_divmod(n_out - 1, params.delta_fx, u0,
                                     D)[0] > xlen:
        raise ValueError(f"{n_out} outputs need more than {xlen} input "
                         f"samples")


def _plan_for(x, params, n_out, time_major, variant):
    C = x.shape[1] if time_major else x.shape[0]
    return plan(params.taps_per_phi, params.table.shape[0], params.nphi,
                params.delta_fx, n_out, C, x.dtype, params.table.dtype,
                time_major, variant)


def _launch(x, hist, params, u0, d0, n_out, out_dtype, time_major,
            variant):
    """y, after one launch of the planned variant, counted by entry point
    and variant; nothing runs for no output."""
    C, xlen = (x.shape[1], x.shape[0]) if time_major else x.shape
    shape = (n_out, C) if time_major else (C, n_out)
    y = torch.empty(shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    p = _plan_for(x, params, n_out, time_major, variant)
    check_aligned(x=x, hist=hist, table=params.table)
    key = (x.dtype, params.table.dtype, out_dtype)
    name = ENTRIES[key]
    layout = (int(time_major),) if key in TM_ENTRIES else ()
    counted = TM_ENTRIES[key] if time_major else name
    launch("resample", SIGNATURES, f"mr_resample_{name}", x.device,
           (x.data_ptr(), hist.data_ptr(), params.table.data_ptr(),
            y.data_ptr(), C, xlen, params.taps_per_phi, params.nphi,
            params.table.shape[0], params.delta_fx, u0, d0, n_out, *layout,
            VARIANTS.index(p.variant), p.tile, p.channels, p.run, p.grid,
            p.stride, p.mult, p.depth),
           (launches, counted),
           (launches_by_variant, f"{counted}/{p.variant}"))
    return y


def _run(x, hist, params, u0, d0, n_out, out_dtype, time_major, variant):
    if not isinstance(params, (FIRArbitrary, FIRFarrow)):
        raise TypeError(f"resample takes FIRArbitrary or FIRFarrow, got "
                        f"{type(params).__name__}")
    out_dtype = _out_of(x.dtype, params.table.dtype, out_dtype)
    _check(x, hist, params, u0, d0, n_out, out_dtype, time_major)
    if x.device.type == "cpu":
        if variant is not None:  # a named variant must take the call
            _plan_for(x, params, n_out, time_major, variant)
        plain = resample_tm_plain if time_major else resample_plain
        return plain(x, hist, params, u0, d0, n_out, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {x.device}")
    if not recording():
        return _launch(x, hist, params, u0, d0, n_out, out_dtype,
                       time_major, variant)
    with span("mr.kernel.launch", True):
        return _launch(x, hist, params, u0, d0, n_out, out_dtype,
                       time_major, variant)


def resample(x, hist, params, u0: int, d0: int, n_out: int,
             variant: str | None = None, out_dtype=None) -> torch.Tensor:
    """y (C, n_out) from x (C, xlen) and hist (C, T-1), channel-major.

    ``params`` is an FIRArbitrary or FIRFarrow kernel on x's device whose
    table pairs with x's type in ``ENTRIES``; (u0, d0) the entry
    accumulator and deficit, n_out the exact output count
    (``indexing.host_carry``). ``out_dtype`` is the output type, by
    default the signal's (float32 for a narrow read, which also stores
    float16; a complex table's type for a real signal). ``variant`` names the kernel's variant (one of ``VARIANTS``)
    in place of ``plan``'s choice, for timing. Raises on anything the
    kernel does not take.
    """
    return _run(x, hist, params, u0, d0, n_out, out_dtype, False, variant)


def resample_tm(xt, hist, params, u0: int, d0: int, n_out: int,
                variant: str | None = None, out_dtype=None) -> torch.Tensor:
    """y (n_out, C) from time-major xt (xlen, C) and channel-major hist
    (C, T-1), float32 or a narrow read (``TM_ENTRIES``); otherwise as
    ``resample``."""
    return _run(xt, hist, params, u0, d0, n_out, out_dtype, True, variant)
