"""Block filtering for the rational family: one kernel launch per block.

Counterpart of the rational-family part of ``multirate_tpu/ops/compute.py``.
Every rational-family kernel (standard, interpolator, decimator,
rational) is one polyphase formulation with its own (bank, L, M) and entry
(phi0, d0); ``ops/cuda/polyphase.py`` computes it.

Compute paths:

- ``kernel``: the hand-written CUDA kernel. Given a CPU tensor, its wrapper
  runs the plain version instead, because that is where the tensor lies.
- ``windows``: the plain PyTorch version on any device (window gather and
  einsum, the counterpart of the JAX ``windows`` path).

``auto`` picks ``kernel`` for CUDA tensors and ``windows`` for CPU ones.

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
from .cuda.polyphase import polyphase, polyphase_plain
from .params import (FIRDecimator, FIRInterpolator, FIRRational, FIRStandard,
                     FilterState)

__all__ = ["filt_block_raw"]

_PATHS = {"kernel": polyphase, "windows": polyphase_plain}


# Per-family polyphase geometry: (bank, L, M, phi0, d0). The standard and
# interpolator always enter at (1, 1) and the decimator at phase 1, as the
# JAX package's _standard/_interpolator/_decimator do.

def _standard(params: FIRStandard, state):
    return params.bank, 1, 1, 1, 1


def _interpolator(params: FIRInterpolator, state):
    return params.bank, params.interpolation, 1, 1, 1


def _decimator(params: FIRDecimator, state):
    return params.bank, 1, params.decimation, 1, state.deficit


def _rational(params: FIRRational, state):
    return (params.bank, params.interpolation, params.decimation,
            state.phase, state.deficit)


_IMPL = {FIRStandard: _standard, FIRInterpolator: _interpolator,
         FIRDecimator: _decimator, FIRRational: _rational}


def _carry_history(params, state, x):
    """New history = trailing h_min samples of [old history ++ x]."""
    H = params.h_min
    xlen = x.shape[-1]
    if xlen >= H:
        tail = x[..., xlen - H:]
    else:
        tail = torch.cat([state.history[..., xlen:], x], dim=-1)
    return tail.clone(memory_format=torch.contiguous_format)


def _auto_path(params, x) -> str:
    return "kernel" if x.is_cuda else "windows"


def _check(params, state, x):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x)}")
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"signal dtype {x.dtype}: only float32 is ported (float64 and "
            f"complex: ROADMAP queue 1, item 3; bf16/int8: item 2)")
    for name, dev in (("kernel bank", params.device),
                      ("state history", state.history.device)):
        if dev != x.device:
            raise ValueError(f"{name} is on {dev} but x is on {x.device}")
    want = (*x.shape[:-1], params.h_min)
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
    if path == "auto":
        path = _auto_path(params, x)
    if path not in _PATHS:
        raise ValueError(f"unknown path {path!r}; one of {sorted(_PATHS)}")
    bank, L, M, phi0, d0 = _IMPL[type(params)](params, state)
    count, phase, deficit = idx.host_carry(params, state.phase,
                                           state.deficit, x.shape[-1])
    lead = x.shape[:-1]
    C = math.prod(lead)
    x2 = x.reshape(C, x.shape[-1]).contiguous()
    h2 = state.history.reshape(C, params.h_min).contiguous()
    y = _PATHS[path](x2, h2, bank, L, M, phi0, d0, count)
    new_state = FilterState(history=_carry_history(params, state, x),
                            phase=phase, deficit=deficit)
    return y.reshape(*lead, count), count, new_state
