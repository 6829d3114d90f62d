"""Block filtering: one kernel launch per block.

Counterpart of ``multirate_tpu/ops/compute.py``. Every rational-family
kernel (standard, interpolator, decimator, rational) is one polyphase
formulation with its own (bank, L, M) and entry (phi0, d0), computed by
``ops/cuda/polyphase.py``; the arbitrary-rate and Farrow kernels are one
accumulator formulation with entry (u0, d0), computed by
``ops/cuda/resample.py``.

Compute paths:

- ``kernel``: the hand-written CUDA kernels. Given a CPU tensor, their
  wrappers run the plain version instead, because that is where the tensor
  lies.
- ``windows``: the plain PyTorch versions on any device (window gather and
  einsum, the counterpart of the JAX ``windows`` path).

``auto`` picks ``kernel`` for CUDA tensors and ``windows`` for CPU ones.
The JAX package's other selectors (``gridsel``, ``winsel``, ``ratgrid``,
``slices``) choose TPU formulations of the same function and have no
counterpart here.

Every block runs at JAX's dtype semantics: its output type is JAX's
``_out_dtype`` (``compute.py:59-71`` there), the promotion of the taps'
type and the signal's by JAX's own table (``ops/dtypes.py``), float32
where that is bfloat16. Each pair takes one of these routes (``_route``):

- the quantized modes of the rational family: bfloat16 taps with a
  bfloat16 signal (float32 outputs) and int8 with int8 (exact int32
  outputs), as stored;
- a narrow signal (int16, uint8, float16, bfloat16, int8) whose output is
  float32 or float16: read as stored by the narrow-read entries of both
  kernels, which widen each sample to float32 in the kernel, against a
  float32 bank (float16 taps, and bfloat16 or integer taps widened, hold
  their values exactly) with float32 sums; float16 outputs are stored
  narrow in the kernel. No cast pass precedes these launches;
- an integer output (integer taps with an integer signal, outside the int8
  mode), rational family: exact, as JAX's ``windows`` path gives it.
  Signal and bank cross as two's-complement words (``dtypes.word``: int32
  for an output of 32 bits or fewer, int64 for a 64-bit one; uint32 and
  uint64 as views of their bits, narrower types cast once), the
  polyphase kernel's ``i32`` or ``i64`` entry sums their products with
  unsigned wrapping multiply-adds, and the output keeps the low bits: the
  exact sum wrapped modulo 2^bits of the output type (a bool output:
  whether the sum of its int32 words is nonzero);
- an integer output at an arbitrary or Farrow rate: signal and table cast
  to float64, the float64 entry, then the nearest integer to its sum,
  wrapped to the output type (bool: whether it is nonzero). Below 2^53 that is the exact result's
  nearest integer; beyond, the nearest integer to the float64 sum (an
  int64 signal or tap beyond 2^53 also rounds when it is cast). JAX's own
  value there casts alpha to the taps' integer type (ROADMAP queue 3);
- a real signal against complex taps (a complex output): the samples read
  as stored by the real-sample entries of both kernels against the
  interleaved complex bank (2 FMAs a tap): float32 against complex64
  (``f32c``), float64 against complex128 (``f64c``), and the narrow reads
  against complex64 (``s16c``, ``u8c``, ``f16c``, ``s8c``, ``bf16c``);
  any other real type cast once to the output's real type. No cast to
  complex, as JAX's TPU route applies its real kernel to the re and im
  halves of the bank (``compute.py:465-494, 1060-1064`` there);
- any other pair: the signal and history cast once to the output type
  (JAX's own ``astype``: int32 above 2^24 rounds as it does, a signal
  whose output is float16 then runs the float16 narrow-read entry), and
  the bank to its real type when the taps are real (a real bank against
  complex samples, read interleaved), else to it.

A kernel's ``store_dtype`` is applied to that output: stored narrow in the
kernel where an entry has the store, else cast at the end, as JAX does
outside its zero-copy path (``compute.py:1049-1056``). The carried history
keeps the signal's type, as JAX's [history ++ x] does. At an arbitrary or
Farrow rate the narrow-read entries follow the JAX package's TPU route,
which widens the signal to float32 before its kernel
(``pallas/select3.py:344``, ``compute.py:714`` there); JAX's ``windows``
path, which rounds bf16 products to bf16 and float16 taps to float16
(``_row_contract``), is not followed. This replaces the TPU kernels'
float64 modes and their complex modes (planar re/im applies and split tap
banks) with kernels that read complex samples and taps interleaved, as
torch stores them.

Leading channel dims share one (phase, deficit) state, as in the JAX
package, and run as one launch with channels on a grid dimension. There is
no stream-concat of channels, so the JAX package's TPU batching fault (a
gap that is M-aligned only when xlen % M == 0, ``compute.py:364`` there)
has no counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import dtypes as _dt
from . import indexing as idx
from .cuda import polyphase as _pp
from .cuda import resample as _rs
from .params import (FIRArbitrary, FIRDecimator, FIRFarrow, FIRInterpolator,
                     FIRRational, FIRStandard, FilterState)

__all__ = ["filt_block_raw", "filt_block_inplace", "filt_block_tm_raw",
           "PATHS", "check_path"]

_POLYPHASE = {"kernel": _pp.polyphase, "windows": _pp.polyphase_plain}
_RESAMPLE = {"kernel": _rs.resample, "windows": _rs.resample_plain}
_RESAMPLE_TM = {"kernel": _rs.resample_tm, "windows": _rs.resample_tm_plain}


# Per-family geometry: (paths, arguments after (params, x, hist) and
# before the count). The standard and interpolator always enter at (1, 1)
# and the decimator at phase 1, as the JAX package's _standard/
# _interpolator/_decimator do; the accumulator family enters at (u0, d0) =
# (phase, deficit).

def _standard(params: FIRStandard, state):
    return _POLYPHASE, (1, 1, 1, 1)


def _interpolator(params: FIRInterpolator, state):
    return _POLYPHASE, (params.interpolation, 1, 1, 1)


def _decimator(params: FIRDecimator, state):
    return _POLYPHASE, (1, params.decimation, 1, state.deficit)


def _rational(params: FIRRational, state):
    return _POLYPHASE, (params.interpolation, params.decimation,
                        state.phase, state.deficit)


class _Route(NamedTuple):
    """How one block runs: the type its signal and history reach the
    kernel in (None: as stored), its bank's, the kernel's output and the
    block's output (JAX's type; an integer output is the kernel's word or
    float64 result wrapped to it)."""
    x: torch.dtype | None
    bank: torch.dtype
    out: torch.dtype
    final: torch.dtype


def _route(tap, bank, x, quantized: bool) -> _Route:
    """The route of a block of ``x`` samples against taps of type ``tap``
    held in a ``bank`` of that type or a wider one (module docstring);
    ``quantized``: the rational family, which has the bf16 and int8 modes
    and the exact integer route."""
    if quantized and x == bank == tap and x in (torch.bfloat16, torch.int8):
        return _Route(None, bank, _pp.ACCUMULATOR[x], _pp.ACCUMULATOR[x])
    final = _dt.out_dtype(tap, x)
    if final in _dt.INTEGERS:
        if quantized:
            w = _dt.word(final)
            return _Route(None if x == w else w, w, w, final)
        return _Route(torch.float64, torch.float64, torch.float64, final)
    if final.is_complex:
        real = final.to_real()
        if tap.is_complex and not x.is_complex:  # read as stored
            xt = x if x == real or (
                x in _dt.NARROW and final == _dt.NARROW_COMPLEX) else real
            return _Route(None if xt == x else xt, final, final, final)
        return _Route(None if x == final else final,
                      final if tap.is_complex else real, final, final)
    xt = x if x in _dt.NARROW and final in _dt.NARROW_OUT else final
    if xt in _dt.NARROW:
        return _Route(None if xt == x else xt, torch.float32, final, final)
    return _Route(None if xt == x else xt, final, final, final)


def _cast(t, dtype):
    """``t`` in ``dtype``: integers of one width as a view of their bits
    (uint32 as int32: torch does little arithmetic on uint32, and the
    words' bits are what the kernels sum), else a cast (integers wrap)."""
    if t.dtype == dtype:
        return t
    if (t.dtype in _dt.INTEGERS and dtype in _dt.INTEGERS
            and t.dtype.itemsize == dtype.itemsize and t.dtype != torch.bool):
        return t.view(dtype)
    return t.to(dtype)


def _wrap(y):
    """float64 integers as int64 modulo 2^64 (two's complement): exact,
    where a cast of a value beyond 2^63 would saturate."""
    r = torch.fmod(y, 2.0 ** 64)
    r = torch.where(r >= 2.0 ** 63, r - 2.0 ** 64,
                    torch.where(r < -2.0 ** 63, r + 2.0 ** 64, r))
    return r.to(torch.int64)


def _finish(y, final, rounded: bool):
    """The block's output from the kernel's: an integer type takes the
    word's low bits, or the float64 sum (at a rate ``rounded`` to the
    nearest integer) wrapped to it; bool whether the sum is nonzero; as
    JAX's integer arithmetic gives them."""
    if final not in _dt.INTEGERS:
        return y
    if final == torch.bool:
        return y != 0
    if y.dtype == torch.float64:
        y = _wrap(y.round() if rounded else y)
    return _cast(y, final)


def _polyphase(fn, params, x, hist, L, M, phi0, d0, count):
    """One polyphase block on its route, stored as the kernel's
    ``store_dtype`` if it has one."""
    r = _route(params.tap_type, params.bank.dtype, x.dtype, True)
    if r.x is not None:
        x, hist = _cast(x, r.x), _cast(hist, r.x)
    bank, store = _cast(params.bank, r.bank), params.store_dtype
    out = r.out
    if store is not None and r.out == torch.float32 and (
            x.dtype, bank.dtype, store) in _pp.ENTRIES:
        out = store  # stored narrow in the kernel
    y = _finish(fn(x, hist, bank, L, M, phi0, d0, count, out_dtype=out),
                r.final, False)
    return y if store is None else y.to(store)


def _accumulator(params, state):
    """FIRArbitrary and FIRFarrow: the kernel reads its taps' kind from
    ``params`` (JAX ``_arbitrary``/``_farrow``)."""
    return _RESAMPLE, (state.phase, state.deficit)


def _resample(fn, params, x, hist, u0, d0, count):
    """One arbitrary/Farrow block on its route."""
    r = _route(params.tap_type, params.table.dtype, x.dtype, False)
    if r.x is not None:
        x, hist = _cast(x, r.x), _cast(hist, r.x)
    y = fn(x, hist, params.astype(r.bank), u0, d0, count, out_dtype=r.out)
    return _finish(y, r.final, True)


_IMPL = {FIRStandard: _standard, FIRInterpolator: _interpolator,
         FIRDecimator: _decimator, FIRRational: _rational,
         FIRArbitrary: _accumulator, FIRFarrow: _accumulator}


def _carry_history(params, hist, x):
    """New history = trailing h_min samples of [old history ++ x]."""
    H = params.h_min
    xlen = x.shape[-1]
    if xlen >= H:
        tail = x[..., xlen - H:]
    else:
        tail = torch.cat([hist[..., xlen:], x], dim=-1)
    return tail.clone(memory_format=torch.contiguous_format)


def _carry_in_place(params, hist, x):
    """``_carry_history`` written into ``hist``: the x tail copied
    straight in, or, for a chunk shorter than h_min, [old history ++ x]'s
    tail formed before the write (it reads the old history)."""
    H = params.h_min
    xlen = x.shape[-1]
    if xlen >= H:
        hist.copy_(x[..., xlen - H:])
    elif xlen:
        hist.copy_(torch.cat([hist[..., xlen:], x], dim=-1))


# The paths a block takes (``_pick_path``).
PATHS = ("auto", "kernel", "windows")


def check_path(path: str) -> str:
    """``path`` if it is one of ``PATHS``, else ValueError. The JAX
    package's other names (``pallas``, ``supercycle``, ``gridsel``, ...)
    choose TPU formulations and have no counterpart here."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; one of {list(PATHS)}")
    return path


def _pick_path(x, path: str) -> str:
    if check_path(path) == "auto":
        return "kernel" if x.is_cuda else "windows"
    return path


def _check(params, state, x, lead=None):
    """``lead``: the history's channel dims, by default x's leading dims."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x)}")
    if x.dtype not in _dt.LATTICE_TYPES:
        raise TypeError(f"signal dtype {x.dtype} has no counterpart in "
                        f"JAX: a real or complex type of its lattice")
    for name, dev in (("kernel bank", params.device),
                      ("state history", state.history.device)):
        if dev != x.device:
            raise ValueError(f"{name} is on {dev} but x is on {x.device}")
    want = (*(x.shape[:-1] if lead is None else lead), params.h_min)
    if tuple(state.history.shape) != want:
        raise ValueError(f"state history has shape "
                         f"{tuple(state.history.shape)}, expected {want}")


def _block(params, state: FilterState, x, path: str):
    """One block's outputs: (y, count, phase, deficit, hist), with
    ``hist`` the history in x's type (``state.history`` itself where the
    types agree), read by the launch already queued."""
    if type(params) not in _IMPL:
        raise TypeError(f"unknown kernel {type(params)}")
    _check(params, state, x)
    path = _pick_path(x, path)
    lead = x.shape[:-1]
    paths, geometry = _IMPL[type(params)](params, state)
    count, phase, deficit = idx.host_carry(params, state.phase,
                                           state.deficit, x.shape[-1])
    C = math.prod(lead)
    # the history takes the signal's type, as JAX's [history ++ x] does
    hist = state.history.to(x.dtype)
    x2 = x.reshape(C, x.shape[-1]).contiguous()
    h2 = hist.reshape(C, params.h_min).contiguous()
    run = _polyphase if paths is _POLYPHASE else _resample
    y = run(paths[path], params, x2, h2, *geometry, count)
    return y.reshape(*lead, count), count, phase, deficit, hist


def filt_block_raw(params, state: FilterState, x, path: str = "auto"):
    """Filter one block. Returns (y, count, new_state).

    ``y`` has exactly ``count`` samples along its last axis (the JAX
    package's y_padded with no padding): the count is exact on the host,
    so no buffer is sized for the worst case. ``count`` is a Python int.
    """
    y, count, phase, deficit, hist = _block(params, state, x, path)
    new_state = FilterState(history=_carry_history(params, hist, x),
                            phase=phase, deficit=deficit)
    return y, count, new_state


def filt_block_inplace(params, state: FilterState, x, path: str = "auto"):
    """``filt_block_raw`` with the history carried in place: the same
    (y, count, new_state), bit for bit, where ``new_state.history`` is
    ``state.history``'s own storage, overwritten with the new history.

    The counterpart of JAX's ``filt_block_inplace``, which donates the
    state: the state passed in is consumed (its history now holds the new
    one), so thread it linearly, as ``FIRFilter`` does on the card. The
    history stays at one address across a stream's blocks. A chunk of
    another type than the history's gives a new history in the chunk's
    type, as ``filt_block_raw`` does (the history takes the signal's type);
    the blocks after it write that one in place. The write is queued after
    the launch that reads the old history, on the same stream.
    """
    y, count, phase, deficit, hist = _block(params, state, x, path)
    if hist is state.history:
        _carry_in_place(params, hist, x)
    else:
        hist = _carry_history(params, hist, x)
    return y, count, FilterState(history=hist, phase=phase, deficit=deficit)


def filt_block_tm_raw(params, state: FilterState, xt, path: str = "auto"):
    """Filter one time-major block of an arbitrary/Farrow stream.

    ``xt`` is (E, C), time first, and ``y`` comes back (count, C), so a
    pipeline that keeps samples interleaved by channel never transposes.
    The carried history stays channel-major (C, h_min), as in the JAX
    package (``compute.py:1160-1165`` there), so states move freely
    between ``filt_block`` and ``filt_block_tm``. Returns (y, count,
    new_state) as ``filt_block_raw`` does. The time-major kernel takes
    float32 blocks and the narrow-read types (``resample.TM_ENTRIES``); a
    block of any other route runs the channel-major block on ``xt.t()``
    and transposes back, as JAX does (``compute.py:1122-1131`` there).
    """
    if not isinstance(params, (FIRArbitrary, FIRFarrow)):
        raise TypeError(
            "time-major blocks support the arbitrary/Farrow kernels only; "
            "transpose to (C, E) for the rational-family kernels")
    if not isinstance(xt, torch.Tensor) or xt.dim() != 2:
        raise ValueError("time-major x must be a 2-D (E, C) tensor")
    E, C = xt.shape
    _check(params, state, xt, (C,))
    path = _pick_path(xt, path)
    r = _route(params.tap_type, params.table.dtype, xt.dtype, False)
    kx = r.x or xt.dtype
    if (kx, r.bank, r.out) not in _rs.TM_ENTRIES:
        y, count, new_state = filt_block_raw(params, state, xt.t(), path)
        return y.t().contiguous(), count, new_state
    count, phase, deficit = idx.host_carry(params, state.phase,
                                           state.deficit, E)
    hist = state.history.to(xt.dtype)
    # a signal of another type than its kernel's is cast once (JAX astype)
    y = _RESAMPLE_TM[path](xt.to(kx).contiguous(), hist.to(kx).contiguous(),
                           params.astype(r.bank), state.phase, state.deficit,
                           count, out_dtype=r.out)
    H = params.h_min
    if E >= H:
        tail = xt[E - H:].t()
    else:
        tail = torch.cat([hist[:, E:], xt.t()], dim=-1)
    new_state = FilterState(
        history=tail.clone(memory_format=torch.contiguous_format),
        phase=phase, deficit=deficit)
    return y, count, new_state
