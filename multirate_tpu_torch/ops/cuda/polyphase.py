"""The polyphase kernel: its wrapper, its launch counts and its plain version.

``polyphase`` computes, for every channel c and output n < n_out,

    t_n = (phi0 - 1) + n*M,  in_n = d0 + t_n div L,  phi_n = t_n mod L
    y[c, n] = sum_{t < T} xext[c, in_n - 1 + t] * bank[t, phi_n]

with xext = [hist ++ x] and hist the trailing T - 1 samples. This is what
the TPU kernels compute for the rational family:
``multirate_tpu/ops/pallas/rational2.py`` ``rational_supercycle_zc`` and
``rational_supercycle_grouped``, and ``multirate_tpu/ops/pallas/rational.py``
``rational_supercycle_pallas``, in every mode they run: float32, bf16,
int8, float64, and complex as planar re/im applies.

x and hist share the signal type; the bank has the tap type. The pair sets
the mode (JAX ``compute._out_dtype``), one kernel entry point each:

- float32 or float64 with taps of the same type: products and sums in it;
- bfloat16: exact bf16 products summed in float32, float32 output (the
  TPU's single bf16 pass with f32 accumulation);
- int8: exact int32 accumulators, int32 output;
- complex64 or complex128 samples (interleaved, as torch stores them)
  against real taps of their precision (2 real multiply-adds a tap) or
  complex taps of their type (4), complex sums and output;
- narrow reads: int16, uint8, float16, bfloat16 or int8 samples against
  float32 taps, read as stored and widened to float32 in the kernel
  (exactly), then as float32: each output bit-equal to the float32
  entry's on the widened values;
- real samples against complex taps: float32 against complex64
  (``f32c``), float64 against complex128 (``f64c``) and the narrow reads
  against complex64 (``<short name>c``), read as stored (2 real
  multiply-adds a tap), each bit-equal to the ``c64c``/``c128c`` entry on
  the samples cast to complex (up to the sign of a zero);
- int32 and int64 words (``i32``, ``i64``): products and sums wrap
  modulo 2^32 or 2^64 (unsigned arithmetic in the kernel; the caller
  passes uint32 and uint64 as views of their bits).

``out_dtype`` stores the float32, bf16 and narrow-read modes' output
narrow (float16, and bfloat16 for float32 and bf16 in; round to nearest
even: JAX ``store_dtype``, and the float16 output type of float16 taps). On a CUDA tensor
the wrapper launches the hand-written kernel in ``csrc/polyphase.cu`` (see
its header for the design and what bounds it); on a CPU tensor it runs
``polyphase_plain``, the same function in plain PyTorch. There is no
fallback from one to the other.

The kernel has five variants (``VARIANTS``), chosen by ``plan`` from the
shape alone, never after a failure: ``bcast`` broadcasts the one tap vector
of an L == 1 filter (FIR, decimators) from shared memory, ``slide`` keeps
one phase's taps in registers and slides over its window (interpolators,
T in ``REG_TAPS``), ``reg`` keeps the taps of four neighbouring outputs in
registers (other L > 1, T in ``REG_TAPS``), ``reg.tma`` is ``reg`` fed by
a producer warp's bulk copies through a ring of buffers and read in
aligned 16-byte words (float32 at T = 24, where the launch keeps each
thread's alignment fixed and has tiles enough: ``TMA_MIN_TILES``), and
``general`` takes every other geometry. ``plan`` also sizes the tile and
the grid so that the grid fills the card. ``polyphase(...,
variant="general")`` forces the general variant, for timing against it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...utils.profiling import recording, span
from ..dtypes import NARROW, NARROW_COMPLEX, NARROW_OUT
from ..indexing import rational_indices
from ..precision import fp32
from .build import ERROR_STRING, check_aligned, launch, load

__all__ = ["polyphase", "polyphase_plain", "plan", "Plan", "launches",
           "launches_by_variant", "VARIANTS", "REG_TAPS", "TMA_TAPS",
           "TMA_MODES", "TMA_MIN_TILES", "ENTRIES", "ACCUMULATOR",
           "accumulator", "rows_aligned"]

# The kernel's entry point (``mr_polyphase_<name>``, one instantiation of
# csrc/polyphase.cu) for each (signal, taps, output) dtype triple, and each
# signal type's accumulator (its default output; ``accumulator``).
_F32, _F64, _C64, _C128 = (torch.float32, torch.float64, torch.complex64,
                           torch.complex128)
_F16, _BF16, _S16, _U8, _S8 = (torch.float16, torch.bfloat16, torch.int16,
                               torch.uint8, torch.int8)
_I32, _I64 = torch.int32, torch.int64
# The narrow-read entries (``dtypes.NARROW``) by signal type, against
# float32 taps; the int8 and bf16 modes hold "s8" and "bf16", so those
# narrow reads are "s8f" and "bf16f" (float taps).
_NARROW_ENTRY = {x: f"{n}f" if x in (_S8, _BF16) else n
                 for x, n in NARROW.items()}
ENTRIES = {
    (_F32, _F32, _F32): "f32",
    (torch.bfloat16, torch.bfloat16, _F32): "bf16",
    (torch.int8, torch.int8, torch.int32): "s8",
    (_F32, _F32, torch.bfloat16): "f32_bf16out",
    (_F32, _F32, torch.float16): "f32_f16out",
    (torch.bfloat16, torch.bfloat16, torch.bfloat16): "bf16_bf16out",
    (torch.bfloat16, torch.bfloat16, torch.float16): "bf16_f16out",
    (_F64, _F64, _F64): "f64",
    (_C64, _F32, _C64): "c64",
    (_C64, _C64, _C64): "c64c",
    (_C128, _F64, _C128): "c128",
    (_C128, _C128, _C128): "c128c",
    **{(x, _F32, o): name if o == _F32 else f"{name}_f16out"
       for o in NARROW_OUT for x, name in _NARROW_ENTRY.items()},
    # real samples against complex taps, read as stored
    (_F32, _C64, _C64): "f32c",
    (_F64, _C128, _C128): "f64c",
    **{(x, NARROW_COMPLEX, NARROW_COMPLEX): f"{n}c" for x, n in NARROW.items()},
    # exact integer words, wrapping
    (_I32, _I32, _I32): "i32",
    (_I64, _I64, _I64): "i64",
}
# by signal type; an int8 or bfloat16 signal against float32 taps sums in
# float32, a real signal against complex taps in their type
# (``accumulator``)
ACCUMULATOR = {_F32: _F32, _BF16: _F32, _S8: torch.int32, _F64: _F64,
               _C64: _C64, _C128: _C128, _S16: _F32, _U8: _F32, _F16: _F32,
               _I32: _I32, _I64: _I64}


def accumulator(x_dtype, bank_dtype) -> torch.dtype:
    """The accumulator (the default output) of a (signal, taps) pair:
    ``ACCUMULATOR``'s, but float32 for a narrow read and the taps' type
    for a real signal against complex taps."""
    if bank_dtype.is_complex and not x_dtype.is_complex:
        return bank_dtype
    if x_dtype in NARROW and bank_dtype == _F32:
        return _F32
    return ACCUMULATOR[x_dtype]

# The kernel's variants, by the number its entry points take.
VARIANTS = ("general", "reg", "bcast", "slide", "reg.tma")
# Taps per phase the register and sliding variants are compiled for, and
# the producer-fed one.
REG_TAPS = (24, 37)
TMA_TAPS = (24,)
# reg.tma's (signal, taps) modes, and the tiles a launch needs before the
# planner picks it over reg (a sweep on the H100, PERF.md)
TMA_MODES = ((torch.float32, torch.float32),)
TMA_MIN_TILES = 92

# Kernel launches made by ``polyphase`` in this process, by entry point, and
# by entry point and variant (``"f32/reg"``). Each grows by one where its
# kernel is launched and nowhere else; a caller may reset them.
launches = dict.fromkeys(ENTRIES.values(), 0)
launches_by_variant = {f"{e}/{v}": 0 for e in ENTRIES.values()
                       for v in VARIANTS}

_LIMIT = 1 << 20  # L and M bound: keeps in-tile offsets inside int32

# The C signatures for ``build.load``: each entry point of csrc/polyphase.cu
# (x, hist, bank, y, C, xlen, T, L, M, phi0, d0, n_out, then the plan's
# variant, tile, grid and depth, and the stream), and the planner's chooser
# in csrc/mr_plan.cpp.
_P, _C_I64, _C_INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
SIGNATURES = (*((f"mr_polyphase_{name}", _C_INT,
                 (_P,) * 4 + (_C_I64, _C_I64) + (_C_INT,) * 4
                 + (_C_I64, _C_I64, _C_INT, _C_INT, _C_I64, _C_INT, _P))
                for name in ENTRIES.values()), ERROR_STRING)
PLAN_SIGNATURES = (("mr_polyphase_plan", _C_INT,
                    (_C_INT,) * 3 + (_C_I64,) * 2 + (_C_INT,) * 6
                    + (_C_I64, _C_INT, _C_INT, _P)),)


class Plan(NamedTuple):
    """One launch: the variant, its tile as the kernel takes it (outputs;
    for ``reg``, ``reg.tma`` and ``slide``, periods of Q = L/gcd(L, M)
    outputs or more), blocks on grid.x (``reg``, ``reg.tma`` and
    ``slide``: at most; their launcher keeps no more than the card holds
    at once), shared bytes a block (at most: the output type may be
    narrower than the accumulator's), the outputs of one tile, and
    ``reg.tma``'s ring buffers (0 for the others)."""
    variant: str
    tile: int
    grid: int
    smem: int
    tile_outputs: int
    depth: int = 0


def plan(T: int, L: int, M: int, n_out: int, x_dtype, bank_dtype,
         channels: int = 1, variant: str | None = None,
         aligned: bool = True) -> Plan:
    """The launch of one polyphase call: the variant (by default the first
    of ``bcast``, ``slide``, ``reg.tma``, ``reg`` that takes the geometry,
    else ``general``), the tile and the grid. ``aligned`` says that every
    channel's row of x starts at a 16-byte boundary (x's data, and its row
    length unless one channel), which ``reg.tma`` needs; by default it
    also needs ``TMA_MIN_TILES`` tiles, which a named ``"reg.tma"`` does
    not. Chosen on the shape by the planner library (csrc/mr_plan.cpp,
    built with g++ at first use) from the launcher's own geometry, and
    cached. Raises ValueError if ``variant`` is named and cannot take the
    call."""
    return _plan(T, L, M, n_out, x_dtype, bank_dtype, channels, variant,
                 aligned, TMA_MIN_TILES)


@functools.lru_cache(maxsize=1024)
def _plan(T, L, M, n_out, x_dtype, bank_dtype, channels, variant, aligned,
          min_tiles, depth=0, periods=0) -> Plan:
    """``plan`` at reg.tma's tile threshold ``min_tiles`` (a key of the
    cache: tests and chip_smoke.py change ``TMA_MIN_TILES``); ``depth`` and
    ``periods`` set its ring buffers and periods a thread a tile (0: the
    planner's), for the sweeps of tools/polyphase_runs.py."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    out = (ctypes.c_int64 * 6)()
    if load("mr_plan", PLAN_SIGNATURES).mr_polyphase_plan(
            T, L, M, max(int(n_out), 1), channels, x_dtype.itemsize,
            bank_dtype.itemsize, accumulator(x_dtype, bank_dtype).itemsize,
            x_dtype in NARROW and bank_dtype != _S8,  # staged as float32
            aligned and (x_dtype, bank_dtype) in TMA_MODES,
            -1 if variant is None else VARIANTS.index(variant), min_tiles,
            depth, periods, out):
        raise ValueError(f"the {variant or 'bcast/slide/reg.tma/reg/general'}"
                         f" variant cannot take T={T} L={L} M={M} "
                         f"({x_dtype} samples, {bank_dtype} taps)")
    return Plan(VARIANTS[out[0]], *out[1:])


def polyphase_plain(x, hist, bank, L: int, M: int, phi0: int, d0: int,
                    n_out: int, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: int64 index vectors, a window gather and a
    contraction. The float modes contract with an einsum under ``fp32()``
    in the accumulator's type: float32 for float32, bf16 (bf16 products
    are exact in float32) and the narrow reads (the samples widened
    exactly), else the signal's own type (float64, complex64 or
    complex128, real taps cast to it) or the complex taps' (a real signal
    widened to complex). The integer modes multiply and sum in int64 (an
    int8 einsum would wrap in int8, and the card has no integer matmul):
    exact for int8, wrapping modulo 2^64 for the int32 and int64 words,
    whose low bits are kept. Runs on any device; arguments as for
    ``polyphase``."""
    T = bank.shape[0]
    xext = torch.cat([hist, x], dim=-1)
    inp, phi = rational_indices(L, M, phi0, d0, n_out, device=x.device)
    ind = (inp - 1)[:, None] + torch.arange(T, device=x.device)[None, :]
    windows = xext[:, ind]                        # (C, n_out, T)
    taps = bank.t()[phi]                          # (n_out, T)
    acc = accumulator(x.dtype, bank.dtype)
    if acc in (_I32, _I64):
        y = (windows.to(_I64) * taps.to(_I64)).sum(-1, dtype=_I64).to(acc)
    else:
        with fp32():
            y = torch.einsum("cnt,nt->cn", windows.to(acc), taps.to(acc))
    return y if out_dtype is None else y.to(out_dtype)


def _check(x, hist, bank, L, M, phi0, d0, n_out, out_dtype):
    if (x.dtype, bank.dtype, out_dtype) not in ENTRIES:
        raise TypeError(f"no polyphase kernel for {x.dtype} samples, "
                        f"{bank.dtype} taps and {out_dtype} outputs")
    for name, t in (("x", x), ("hist", hist), ("bank", bank)):
        if name == "hist" and t.dtype != x.dtype:
            raise TypeError(f"hist is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2:
        raise ValueError(f"x must be (C, xlen), got {tuple(x.shape)}")
    T = bank.shape[0]
    if bank.dim() != 2 or bank.shape[1] != L or T < 1:
        raise ValueError(f"bank must be (T, {L}), got {tuple(bank.shape)}")
    if tuple(hist.shape) != (x.shape[0], T - 1):
        raise ValueError(f"hist must be {(x.shape[0], T - 1)}, "
                         f"got {tuple(hist.shape)}")
    if not (0 < L < _LIMIT and 0 < M < _LIMIT and T * L < 2**31):
        raise ValueError(f"geometry out of range: L={L} M={M} T={T}")
    if not (1 <= phi0 <= L and d0 >= 1 and n_out >= 0):
        raise ValueError(f"bad entry state phi0={phi0} d0={d0} "
                         f"n_out={n_out}")
    if n_out and d0 + ((phi0 - 1) + (n_out - 1) * M) // L > x.shape[1]:
        raise ValueError(f"{n_out} outputs need more than {x.shape[1]} "
                         f"input samples")


def polyphase(x, hist, bank, L: int, M: int, phi0: int, d0: int,
              n_out: int, out_dtype=None, variant=None) -> torch.Tensor:
    """y (C, n_out) from x (C, xlen), hist (C, T-1) and bank (T, L).

    x and hist share the signal type and bank has the tap type, a pair of
    ``ENTRIES``, all contiguous on one device; (phi0, d0) is the 1-based
    entry phase and deficit, and n_out the exact output count
    (``indexing.host_carry``). ``out_dtype`` is the output type, by
    default the accumulator's (``accumulator``: the signal's type, float32
    for bfloat16 and the narrow reads, int32 for int8 with int8 taps, the
    taps' type for a real signal against complex taps);
    float32 and bf16 signals also store bfloat16 or float16, narrow reads
    float16. ``variant`` names the kernel's variant (one of ``VARIANTS``)
    in place of ``plan``'s choice, for timing. Raises on anything the
    kernel does not take.
    """
    if x.dtype not in ACCUMULATOR:
        raise TypeError(f"no polyphase kernel for {x.dtype} samples")
    if out_dtype is None:
        out_dtype = accumulator(x.dtype, bank.dtype)
    _check(x, hist, bank, L, M, phi0, d0, n_out, out_dtype)
    shape = (bank.shape[0], L, M, n_out, x.dtype, bank.dtype, x.shape[0])
    if x.device.type == "cpu":
        if variant is not None:  # a named variant must take the call
            plan(*shape, variant, aligned=rows_aligned(x))
        return polyphase_plain(x, hist, bank, L, M, phi0, d0, n_out,
                               out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no polyphase kernel for device {x.device}")
    if not recording():
        return _launch(x, hist, bank, L, M, phi0, d0, n_out, out_dtype,
                       variant, shape)
    with span("mr.kernel.launch", True):
        return _launch(x, hist, bank, L, M, phi0, d0, n_out, out_dtype,
                       variant, shape)


def rows_aligned(x) -> bool:
    """Whether every channel's row of x (C, xlen), contiguous, starts at a
    16-byte boundary: ``plan``'s ``aligned``."""
    return (x.data_ptr() % 16 == 0
            and (x.shape[0] == 1 or x.shape[1] * x.element_size() % 16 == 0))


def _launch(x, hist, bank, L, M, phi0, d0, n_out, out_dtype, variant,
            shape):
    """y, after one launch of the planned variant, counted by entry point
    and variant; nothing runs for no output."""
    check_aligned(x=x, hist=hist, bank=bank)
    p = plan(*shape, variant, aligned=rows_aligned(x))
    y = torch.empty((x.shape[0], n_out), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    name = ENTRIES[x.dtype, bank.dtype, out_dtype]
    launch("polyphase", SIGNATURES, f"mr_polyphase_{name}", x.device,
           (x.data_ptr(), hist.data_ptr(), bank.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], bank.shape[0], L, M, phi0, d0, n_out,
            VARIANTS.index(p.variant), p.tile, p.grid, p.depth),
           (launches, name), (launches_by_variant, f"{name}/{p.variant}"))
    return y
