"""FilterState checkpoint / resume.

Counterpart of ``multirate_tpu/utils/checkpoint.py``. The reference's
streaming state (history + inputDeficit + phase) fully determines
resumption, so ``save_state``/``load_state`` round-trip it through a .npz
file, and a restart from a block boundary is exact.

The file keeps the JAX package's keys, so a file written by either package
loads in the other:

- ``history``: the history samples in their type; numpy has no bfloat16,
  so a bfloat16 history is saved as float32 (exact);
- ``phase`` and ``deficit``: int64 (the arbitrary/Farrow phase is the
  32-bit-fraction accumulator u, below 2^63);
- ``history_dtype``: the port's history type by name, which restores a
  bfloat16 history; JAX's ``state_from_host`` ignores it.

A JAX history may be longer than the port's (the TPU's zero-copy path keeps
``ZC_S*g*M`` samples); ``h_min=`` keeps its trailing ``h_min`` samples, all
that any output depends on, as ``convert.state_from_jax`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.params import FilterState, default_device

__all__ = ["save_state", "load_state", "state_to_host", "state_from_host"]

# the history types a file may name (``history_dtype``)
_DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.float32, torch.float64, torch.complex64, torch.complex128,
    torch.bfloat16, torch.int8)}


def state_to_host(state: FilterState) -> dict:
    """Device -> host: a plain numpy dict, safe to serialize anywhere."""
    h = state.history.detach().cpu()
    return {
        "history": (h.float() if h.dtype == torch.bfloat16 else h).numpy(),
        "phase": np.asarray(state.phase, np.int64),
        "deficit": np.asarray(state.deficit, np.int64),
        "history_dtype": np.asarray(str(h.dtype).removeprefix("torch.")),
    }


def state_from_host(d: dict, device=None, h_min: int | None = None
                    ) -> FilterState:
    """A state from ``state_to_host``'s dict (or a JAX one), its history on
    ``device`` (by default the card), trimmed to its trailing ``h_min``
    samples if given."""
    hist = torch.from_numpy(np.ascontiguousarray(d["history"]))
    if "history_dtype" in d:
        name = str(d["history_dtype"])
        if name not in _DTYPES:
            raise ValueError(f"unknown history type {name!r}")
        hist = hist.to(_DTYPES[name])
    if h_min is not None:
        if hist.shape[-1] < h_min:
            raise ValueError(f"history holds {hist.shape[-1]} samples, the "
                             f"kernel needs {h_min}")
        hist = hist[..., hist.shape[-1] - h_min:]
    dev = default_device() if device is None else torch.device(device)
    return FilterState(history=hist.to(dev).contiguous(),
                       phase=int(d["phase"]), deficit=int(d["deficit"]))


def save_state(path: str, state: FilterState) -> None:
    np.savez(path, **state_to_host(state))


def load_state(path: str, device=None, h_min: int | None = None
               ) -> FilterState:
    with np.load(path) as z:
        return state_from_host({k: z[k] for k in z.files}, device, h_min)
