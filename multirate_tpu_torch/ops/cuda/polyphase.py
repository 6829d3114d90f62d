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

import math
from typing import NamedTuple

import torch

from ...utils.profiling import recording, span
from ..dtypes import NARROW, NARROW_COMPLEX, NARROW_OUT
from ..indexing import rational_indices
from ..precision import fp32
from .build import check_aligned, load_polyphase

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

# The launch geometry of csrc/polyphase.cu, mirrored here so that the host
# plans every launch (the C launcher checks the plan and refuses a bad one).
_REG_THREADS, _REG_TARGET = 256, 128
_BCAST_THREADS = _SLIDE_THREADS = 128
_SMEM_LIMIT, _BANK_SMEM_LIMIT = 227 * 1024, 96 * 1024
_SMEM_TARGET = 48 * 1024  # per block, so that several blocks share an SM
_FILL = 2 * 132           # blocks that fill the H100's SMs twice
_SLIDE_REPEATS = 8        # slide: periods a thread computes in a tile, at most
# reg: periods a thread computes in a tile, and periods a tile, at least
# (the fastest tiles of a sweep on the H100, PERF.md)
_REG_PERIODS, _REG_MIN_TILE = 3, 6
# reg.tma: periods a thread computes in a tile, buffers in its ring (at
# most _TMA_MAX_DEPTH), shared bytes of its barriers, and samples a 16-byte
# word; a sweep on the H100 (PERF.md)
_TMA_PERIODS, _TMA_DEPTH, _TMA_MAX_DEPTH = 12, 2, 8
_TMA_BAR_BYTES, _TMA_V = 2 * 8 * _TMA_MAX_DEPTH, 4
_MAX_GRID = 65535         # grid.x, at most (the kernels loop over tiles)
_MAX_GENERAL_GRID = 1024
# bytes of a staged signal or tap element (bf16 is staged as float, and
# so is every narrow read: ``plan``)
_STAGED = {torch.float32: 4, torch.bfloat16: 4, torch.int8: 1,
           torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
           _I32: 4, _I64: 8}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _up(a: int, b: int) -> int:
    """a rounded up to a multiple of b."""
    return _ceil(a, b) * b


def _raw_bytes(n: int, size: int) -> int:
    """csrc/polyphase.cu ``raw_bytes``: a buffer of n raw samples."""
    return _up(n * size + 16, 16) + 16


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


def _shape(xs: int, ws: int):
    """csrc/polyphase.cu ``Shape`` by staged sample and tap size: (R, E) of
    ``reg`` (outputs a thread, tap padding) and R of ``bcast`` and
    ``slide``."""
    r = 4 if ws <= 4 else (2 if ws <= 8 else 1)
    return r, (0 if r == 1 else r), (9 if xs <= 4 else (5 if xs <= 8 else 3))


def _periods(L, M, R):
    """``reg``'s period (csrc/polyphase.cu reg_geom): Qp outputs, Pp
    inputs, G groups of R outputs."""
    g = math.gcd(L, M)
    Q, P = L // g, M // g
    m = 1 if Q >= R else _ceil(R, Q)
    return m * Q, m * P, _ceil(m * Q, R)


def _reg_plan(T, L, M, n_out, channels, xs, ws, xsz, osz):
    R, E, _ = _shape(xs, ws)
    Qp, Pp, G = _periods(L, M, R)
    if (T not in REG_TAPS or L < 2 or G > _REG_THREADS
            or ((R - 1) * M + L - 1) // L > E):
        return None
    base_max = (L - 1 + (G - 1) * R * M) // L

    def smem(K):  # a double buffer of raw samples
        return 2 * _raw_bytes((K - 1) * Pp + base_max + T + E, xsz)

    if smem(1) > _SMEM_LIMIT:
        return None
    kt = max(1, _REG_TARGET // G)
    k_want = max(kt * _REG_PERIODS, _REG_MIN_TILE)
    k_fit = 1
    while k_fit < k_want and smem(k_fit + 1) <= _SMEM_TARGET:
        k_fit += 1
    periods = _ceil(n_out, Qp)
    K = max(1, min(k_fit, periods * channels // _FILL))
    return Plan("reg", K, min(_ceil(periods, K) * channels, _MAX_GRID),
                smem(K), K * Qp)


def _tma_buffer(K, T, L, M, R, E, Pp, G):
    """Samples of one reg.tma ring buffer (csrc/polyphase.cu
    ``tma_buffer``): K periods' reads, each up to 3 words off a 16-byte
    word and UA = T + E + 3 words rounded up to whole 16-byte words."""
    V = _TMA_V
    base_max = (L - 1 + (G - 1) * R * M) // L
    words = (T + E + 2 * (V - 1)) // V * V
    return _up((K - 1) * Pp + base_max + V - 1 + words, V)


def _tma_plan(T, L, M, n_out, channels, xs, ws, xsz, osz, depth=_TMA_DEPTH,
              periods=_TMA_PERIODS, min_tiles=0):
    """reg.tma where ``reg`` takes the geometry with at most a block's
    consumers in a period and a period moves whole 16-byte words (the
    caller checks the mode and alignment), with ``depth`` ring buffers and
    ``periods`` periods a thread a tile; None below ``min_tiles``."""
    R, E, _ = _shape(xs, ws)
    Qp, Pp, G = _periods(L, M, R)
    if (T not in TMA_TAPS or _reg_plan(T, L, M, n_out, channels, xs, ws, xsz,
                                        osz) is None
            or G > _REG_TARGET or Pp % _TMA_V):
        return None
    K = max(1, _REG_TARGET // G) * periods
    smem = _TMA_BAR_BYTES + depth * _tma_buffer(K, T, L, M, R, E, Pp,
                                                G) * xsz
    tiles = _ceil(_ceil(n_out, Qp), K) * channels
    if tiles < min_tiles or smem > _SMEM_LIMIT:
        return None
    return Plan("reg.tma", K, min(tiles, _MAX_GRID), smem, K * Qp, depth)


def _bcast_plan(T, L, M, n_out, channels, xs, ws, xsz, osz):
    R = _shape(xs, ws)[2]
    if L != 1:
        return None
    rows, TQ = min(M, T), _up(_ceil(T, M), R)  # tap rows, zero-padded
    skew = 32 // M if 1 < M <= 32 else 1
    per = _BCAST_THREADS * R

    def smem(kb):  # bank, raw double buffer, split rows, outputs
        tile = kb * per
        sp = _up(tile + TQ + R, 32) + skew
        return (_up(rows * TQ * ws, 16)
                + 2 * _raw_bytes((tile - 1) * M + T, xsz)
                + _up(rows * sp * xs, 16) + _up(tile * osz, 16))

    if smem(1) > _SMEM_LIMIT:
        return None
    kb_fit = 1
    while smem(kb_fit + 1) <= _SMEM_TARGET:
        kb_fit += 1
    kb = max(1, min(kb_fit, n_out * channels // (_FILL * per)))
    return Plan("bcast", kb * per,
                min(_ceil(n_out, kb * per) * channels, _MAX_GRID), smem(kb),
                kb * per)


def _slide_plan(T, L, M, n_out, channels, xs, ws, xsz, osz):
    R = _shape(xs, ws)[2]
    g = math.gcd(L, M)
    Q = L // g
    if T not in REG_TAPS or M // g != 1 or L < 2 or Q > _SLIDE_THREADS:
        return None
    kg = _SLIDE_THREADS // Q

    def smem(K):  # a double buffer of raw samples, then a tile's outputs
        return 2 * _raw_bytes(K + T + R, xsz) + _up(K * Q * osz, 16)

    k_fit = R
    while (k_fit < kg * R * _SLIDE_REPEATS
           and smem(k_fit + R) <= _SMEM_TARGET):
        k_fit += R
    periods = _ceil(n_out, Q)
    K = max(R, min(k_fit, periods * channels // _FILL // R * R))
    return Plan("slide", K, min(_ceil(periods, K) * channels, _MAX_GRID),
                smem(K), K * Q)


def _general_plan(T, L, M, n_out, channels, xs, ws, xsz, osz):
    b_bytes = _up(T * L * ws, 16)
    bank = b_bytes if b_bytes <= _BANK_SMEM_LIMIT else 0

    def smem(tile):
        return bank + ((L - 1 + (tile - 1) * M) // L + T) * xs

    tile = 1024
    while tile > 32 and _ceil(n_out, tile) * channels < _FILL:
        tile //= 2
    while tile > 1 and smem(tile) > _SMEM_LIMIT:
        tile //= 2
    if smem(tile) > _SMEM_LIMIT:
        return None
    return Plan("general", tile, min(_ceil(n_out, tile), _MAX_GENERAL_GRID),
                smem(tile), tile)


_PLANNERS = {"reg": _reg_plan, "bcast": _bcast_plan, "slide": _slide_plan,
             "general": _general_plan}


def plan(T: int, L: int, M: int, n_out: int, x_dtype, bank_dtype,
         channels: int = 1, variant: str | None = None,
         aligned: bool = True) -> Plan:
    """The launch of one polyphase call: the variant (by default the first
    of ``bcast``, ``slide``, ``reg.tma``, ``reg`` that takes the geometry,
    else ``general``), the tile and the grid. ``aligned`` says that every
    channel's row of x starts at a 16-byte boundary (x's data, and its row
    length unless one channel), which ``reg.tma`` needs; by default it
    also needs ``TMA_MIN_TILES`` tiles, which a named ``"reg.tma"`` does
    not. Pure Python on the shape: the CPU tests check it. Raises
    ValueError if ``variant`` is named and cannot take the call."""
    # csrc/polyphase.cu Mode: a narrow read stages float
    narrow = x_dtype in NARROW and bank_dtype in (_F32, NARROW_COMPLEX)
    xs, ws = 4 if narrow else _STAGED[x_dtype], _STAGED[bank_dtype]
    xsz = x_dtype.itemsize
    osz = accumulator(x_dtype, bank_dtype).itemsize
    n_out = max(int(n_out), 1)
    if variant is not None:
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of "
                             f"{VARIANTS}")
        order = (variant,)
    else:
        order = ("bcast", "slide", "reg.tma", "reg", "general")
    for name in order:
        if name == "reg.tma":
            if not aligned or (x_dtype, bank_dtype) not in TMA_MODES:
                continue
            p = _tma_plan(T, L, M, n_out, channels, xs, ws, xsz, osz,
                          min_tiles=0 if variant else TMA_MIN_TILES)
        else:
            p = _PLANNERS[name](T, L, M, n_out, channels, xs, ws, xsz, osz)
        if p is not None:
            return p
    raise ValueError(f"the {'/'.join(order)} variant cannot take T={T} "
                     f"L={L} M={M} ({x_dtype} samples, {bank_dtype} taps)")


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
    entry = getattr(load_polyphase(), f"mr_polyphase_{name}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), hist.data_ptr(), bank.data_ptr(),
                    y.data_ptr(), x.shape[0], x.shape[1], bank.shape[0], L,
                    M, phi0, d0, n_out, VARIANTS.index(p.variant), p.tile,
                    p.grid, p.depth, stream)
    if err != 0:
        raise RuntimeError("polyphase kernel launch failed: "
                           + load_polyphase().mr_error_string(err).decode())
    launches[name] += 1
    launches_by_variant[f"{name}/{p.variant}"] += 1
    return y
