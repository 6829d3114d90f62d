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

The rational family runs in the mode its operands set (JAX ``_out_dtype``,
``compute.py:59-71`` there): bfloat16 taps with a bfloat16 signal run the
bf16 mode (float32 outputs), int8 with int8 the int8 mode (exact int32
outputs), and any other pair the float32 mode on upcast operands. A
kernel's ``store_dtype`` is the output type: the float modes store it
narrow in the kernel, the int8 mode casts its accumulators at the end, as
JAX does outside its zero-copy path (``compute.py:1049-1056``). The
carried history keeps the signal's type. The arbitrary/Farrow kernels
take float32 signals only.

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


def _polyphase(fn, store, x, hist, bank, L, M, phi0, d0, count):
    """One polyphase block in the mode its operands set, stored as
    ``store`` (the kernel's ``store_dtype``) if given."""
    dt = x.dtype if x.dtype == bank.dtype else torch.float32
    x, hist, bank = x.to(dt), hist.to(dt), bank.to(dt)
    if dt == torch.int8:
        y = fn(x, hist, bank, L, M, phi0, d0, count)
        return y if store is None else y.to(store)
    return fn(x, hist, bank, L, M, phi0, d0, count, out_dtype=store)


def _accumulator(params, state):
    """FIRArbitrary and FIRFarrow: the kernel reads its taps' kind from
    ``params`` (JAX ``_arbitrary``/``_farrow``)."""
    return _RESAMPLE, (params, state.phase, state.deficit)


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


_SIGNAL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _check(params, state, x, lead=None):
    """``lead``: the history's channel dims, by default x's leading dims."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x)}")
    if x.dtype not in _SIGNAL_DTYPES:
        raise NotImplementedError(
            f"signal dtype {x.dtype}: float32, bfloat16 and int8 are ported "
            f"(float64 and complex: ROADMAP queue 1, item 3)")
    if x.dtype != torch.float32 and isinstance(params, (FIRArbitrary,
                                                        FIRFarrow)):
        raise NotImplementedError(
            f"{x.dtype} signals at an arbitrary rate are not ported yet "
            f"(ROADMAP queue 1): the arbitrary/Farrow kernels take float32")
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
        y = paths[path](x2, h2, *geometry, count)
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
    new_state) as ``filt_block_raw`` does.
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
    count, phase, deficit = idx.host_carry(params, state.phase,
                                           state.deficit, E)
    y = _RESAMPLE_TM[path](xt.contiguous(), state.history.contiguous(),
                           params, state.phase, state.deficit, count)
    H = params.h_min
    if E >= H:
        tail = xt[E - H:].t()
    else:
        tail = torch.cat([state.history[:, E:], xt.t()], dim=-1)
    new_state = FilterState(
        history=tail.clone(memory_format=torch.contiguous_format),
        phase=phase, deficit=deficit)
    return y, count, new_state
