"""Carry kernels and streaming state across from the JAX package.

Both sides meet as numpy arrays and Python ints, so this module imports
neither JAX nor ``multirate_tpu``:

    fields = {k: np.asarray(v) for k, v in vars(jax_params).items()}
    params = params_from_jax(fields, device="cuda")
    state  = state_from_jax(params, np.asarray(s.history), int(s.phase),
                            int(s.deficit))

A JAX rational kernel may carry a longer history than the filter math
needs (its zero-copy TPU kernel keeps ZC_S whole stream rows); the port
keeps the trailing ``h_min`` samples, which are all any output depends on.
``state_to_jax`` goes back, zero-padding the history on the left to the
JAX kernel's ``history_len``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.params import (FIRDecimator, FIRInterpolator, FIRRational,
                         FIRStandard, FilterState)

__all__ = ["params_from_jax", "state_from_jax", "state_to_jax"]


def params_from_jax(fields, device=None):
    """The port's kernel from a JAX rational-family kernel's fields.

    ``fields`` maps field names to numpy arrays or ints: ``taps_rev`` (with
    ``decimation`` for a decimator) or ``pfb`` with ``interpolation`` (and
    ``decimation`` for a rational kernel). Other fields (the TPU K stacks,
    ``sc_group``) are ignored. The class follows the fields present, as
    the JAX classes' fields do.
    """
    dev = torch.device("cpu") if device is None else torch.device(device)

    def bank(name):
        return torch.as_tensor(np.array(fields[name], np.float32),
                               device=dev)

    if "taps_rev" in fields:
        taps = bank("taps_rev")
        if "decimation" in fields:
            return FIRDecimator(taps_rev=taps, hlen=taps.shape[0],
                                decimation=int(fields["decimation"]))
        return FIRStandard(taps_rev=taps, hlen=taps.shape[0])
    pfb = bank("pfb")
    L = int(fields["interpolation"])
    if "decimation" in fields:
        return FIRRational(pfb=pfb, interpolation=L,
                           decimation=int(fields["decimation"]),
                           taps_per_phi=pfb.shape[0])
    return FIRInterpolator(pfb=pfb, interpolation=L,
                           taps_per_phi=pfb.shape[0])


def state_from_jax(params, history, phase, deficit) -> FilterState:
    """The port's state from a JAX state's (history, phase, deficit): the
    trailing ``params.h_min`` history samples, on the kernel's device."""
    history = np.asarray(history, np.float32)
    if history.shape[-1] < params.h_min:
        raise ValueError(f"history holds {history.shape[-1]} samples, the "
                         f"kernel needs {params.h_min}")
    tail = np.array(history[..., history.shape[-1] - params.h_min:])
    return FilterState(history=torch.as_tensor(tail, device=params.device),
                       phase=int(phase), deficit=int(deficit))


def state_to_jax(state: FilterState, history_len: int):
    """(history, phase, deficit) as numpy arrays for a JAX FilterState
    whose kernel carries ``history_len`` samples."""
    h = state.history.detach().cpu().numpy()
    if history_len < h.shape[-1]:
        raise ValueError(f"history_len {history_len} is shorter than the "
                         f"{h.shape[-1]} samples the filter needs")
    pad = [(0, 0)] * (h.ndim - 1) + [(history_len - h.shape[-1], 0)]
    return (np.pad(h, pad), np.asarray(state.phase, np.int64),
            np.asarray(state.deficit, np.int64))
