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

Every block runs at JAX's dtype semantics (``_out_dtype``,
``compute.py:59-71`` there). bfloat16 taps with a bfloat16 signal run the
bf16 mode (float32 outputs) and int8 with int8 the int8 mode (exact int32
outputs), both rational family only. Any other pair runs in its promoted
type, ``torch.promote_types(taps, signal)`` (float32 where that is
bfloat16): float32, float64, complex64 or complex128. The signal and the
history are cast to it; the bank to its real type when the taps are real
(a real bank against complex samples, read interleaved), else to it. So
float64 taps with a float32 signal give float64, float32 taps with a
complex64 signal complex64, and float64 taps with a complex64 signal
complex128; a real signal against complex taps is cast to complex. A
kernel's ``store_dtype`` is the output type: float32 and bf16 modes store
it narrow in the kernel, the others cast at the end, as JAX does outside
its zero-copy path (``compute.py:1049-1056``). The carried history keeps
the signal's type. The arbitrary/Farrow kernels take no bfloat16 or int8
signals. This replaces the TPU kernels' float64 modes and their complex
modes (planar re/im applies and split tap banks) with kernels that read
complex samples and taps interleaved, as torch stores them.

Leading channel dims share one (phase, deficit) state, as in the JAX
package, and run as one launch with channels on a grid dimension. There is
no stream-concat of channels, so the JAX package's TPU batching fault (a
gap that is M-aligned only when xlen % M == 0, ``compute.py:364`` there)
has no counterpart here.
"""

from __future__ import annotations

import math

import torch

from . import indexing as idx
from .cuda import polyphase as _pp
from .cuda import resample as _rs
from .params import (FIRArbitrary, FIRDecimator, FIRFarrow, FIRInterpolator,
                     FIRRational, FIRStandard, FilterState)

__all__ = ["filt_block_raw", "filt_block_tm_raw"]

_POLYPHASE = {"kernel": _pp.polyphase, "windows": _pp.polyphase_plain}
_RESAMPLE = {"kernel": _rs.resample, "windows": _rs.resample_plain}
_RESAMPLE_TM = {"kernel": _rs.resample_tm, "windows": _rs.resample_tm_plain}


# Per-family geometry: (paths, arguments after (x, hist) and before the
# count). The standard and interpolator always enter at (1, 1) and the
# decimator at phase 1, as the JAX package's _standard/_interpolator/
# _decimator do; the accumulator family enters at (u0, d0) = (phase,
# deficit).

def _standard(params: FIRStandard, state):
    return _POLYPHASE, (params.bank, 1, 1, 1, 1)


def _interpolator(params: FIRInterpolator, state):
    return _POLYPHASE, (params.bank, params.interpolation, 1, 1, 1)


def _decimator(params: FIRDecimator, state):
    return _POLYPHASE, (params.bank, 1, params.decimation, 1, state.deficit)


def _rational(params: FIRRational, state):
    return _POLYPHASE, (params.bank, params.interpolation,
                        params.decimation, state.phase, state.deficit)


def _operand_types(bank_dtype, x_dtype):
    """(signal type, bank type) of a block outside the quantized modes:
    the promoted type (JAX ``_out_dtype``; float32 for bfloat16), and for
    the bank its real type unless the taps are complex."""
    dt = torch.promote_types(bank_dtype, x_dtype)
    if not (dt.is_floating_point or dt.is_complex) or dt == torch.bfloat16:
        dt = torch.float32
    return dt, (dt if bank_dtype.is_complex else dt.to_real())


def _polyphase(fn, store, x, hist, bank, L, M, phi0, d0, count):
    """One polyphase block in the mode its operands set, stored as
    ``store`` (the kernel's ``store_dtype``) if given."""
    if not (x.dtype == bank.dtype and x.dtype in (torch.bfloat16,
                                                    torch.int8)):
        xt, bt = _operand_types(bank.dtype, x.dtype)
        x, hist, bank = x.to(xt), hist.to(xt), bank.to(bt)
    if store is not None and _pp.ACCUMULATOR[x.dtype] == torch.float32:
        return fn(x, hist, bank, L, M, phi0, d0, count, out_dtype=store)
    y = fn(x, hist, bank, L, M, phi0, d0, count)
    return y if store is None else y.to(store)


def _accumulator(params, state):
    """FIRArbitrary and FIRFarrow: the kernel reads its taps' kind from
    ``params`` (JAX ``_arbitrary``/``_farrow``)."""
    return _RESAMPLE, (params, state.phase, state.deficit)


def _resample(fn, x, hist, params, u0, d0, count):
    """One arbitrary/Farrow block in its promoted type."""
    xt, bt = _operand_types(params.table.dtype, x.dtype)
    return fn(x.to(xt), hist.to(xt), params.astype(bt), u0, d0, count)


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


def _pick_path(x, path: str) -> str:
    if path == "auto":
        return "kernel" if x.is_cuda else "windows"
    if path not in _POLYPHASE:
        raise ValueError(
            f"unknown path {path!r}; one of {sorted(_POLYPHASE)}")
    return path


_SIGNAL_DTYPES = (torch.float32, torch.float64, torch.complex64,
                  torch.complex128, torch.bfloat16, torch.int8)


def _check(params, state, x, lead=None):
    """``lead``: the history's channel dims, by default x's leading dims."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x)}")
    if x.dtype not in _SIGNAL_DTYPES:
        raise NotImplementedError(
            f"signal dtype {x.dtype}: float32, float64, complex64, "
            f"complex128, bfloat16 and int8 are ported")
    if x.dtype in (torch.bfloat16, torch.int8) and isinstance(
            params, (FIRArbitrary, FIRFarrow)):
        raise NotImplementedError(
            f"{x.dtype} signals at an arbitrary rate are not ported yet "
            f"(ROADMAP queue 1, item 2: JAX's paths differ on their "
            f"semantics)")
    for name, dev in (("kernel bank", params.device),
                      ("state history", state.history.device)):
        if dev != x.device:
            raise ValueError(f"{name} is on {dev} but x is on {x.device}")
    want = (*(x.shape[:-1] if lead is None else lead), params.h_min)
    if tuple(state.history.shape) != want:
        raise ValueError(f"state history has shape "
                         f"{tuple(state.history.shape)}, expected {want}")


def filt_block_raw(params, state: FilterState, x, path: str = "auto"):
    """Filter one block. Returns (y, count, new_state).

    ``y`` has exactly ``count`` samples along its last axis (the JAX
    package's y_padded with no padding): the count is exact on the host,
    so no buffer is sized for the worst case. ``count`` is a Python int.
    """
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
    if paths is _POLYPHASE:
        y = _polyphase(paths[path], params.store_dtype, x2, h2, *geometry,
                       count)
    else:
        y = _resample(paths[path], x2, h2, *geometry, count)
    new_state = FilterState(history=_carry_history(params, hist, x),
                            phase=phase, deficit=deficit)
    return y.reshape(*lead, count), count, new_state


def filt_block_tm_raw(params, state: FilterState, xt, path: str = "auto"):
    """Filter one time-major block of an arbitrary/Farrow stream.

    ``xt`` is (E, C), time first, and ``y`` comes back (count, C), so a
    pipeline that keeps samples interleaved by channel never transposes.
    The carried history stays channel-major (C, h_min), as in the JAX
    package (``compute.py:1160-1165`` there), so states move freely
    between ``filt_block`` and ``filt_block_tm``. Returns (y, count,
    new_state) as ``filt_block_raw`` does. The time-major kernel is
    float32; a block of any other promoted type runs the channel-major
    block on ``xt.t()`` and transposes back, as JAX does
    (``compute.py:1122-1131`` there).
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
    if _operand_types(params.table.dtype, xt.dtype) != (torch.float32,
                                                        torch.float32):
        y, count, new_state = filt_block_raw(params, state, xt.t(), path)
        return y.t().contiguous(), count, new_state
    count, phase, deficit = idx.host_carry(params, state.phase,
                                           state.deficit, E)
    hist = state.history.to(xt.dtype)
    y = _RESAMPLE_TM[path](xt.contiguous(), hist.contiguous(), params,
                           state.phase, state.deficit, count)
    H = params.h_min
    if E >= H:
        tail = xt[E - H:].t()
    else:
        tail = torch.cat([hist[:, E:], xt.t()], dim=-1)
    new_state = FilterState(
        history=tail.clone(memory_format=torch.contiguous_format),
        phase=phase, deficit=deficit)
    return y, count, new_state
