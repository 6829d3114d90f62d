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
JAX kernel's ``history_len``. For the arbitrary/Farrow kernels the phase
is the accumulator u and the histories have the same length on both
sides.

Banks and Farrow coefficients carry over in their storage type
(``params.storage_dtype``): float32, float64, complex64 and complex128,
and for the rational family also bfloat16 and every integer type (the
quantized modes and the exact integer route), read through float32 where
numpy holds bfloat16; taps of another type sit in a wider bank that holds
their values (integer banks at a rate in int64, exactly), and the kernel
keeps their type (``taps_dtype``), so its outputs take JAX's type. Histories carry over in
their own type, whatever it is (int16 PCM, uint8, float16, ...), as JAX
keeps them. ``state_to_jax`` hands histories back in their type, complex
ones as complex; numpy has no bfloat16 of its own, so a bfloat16 history
goes back as float32 (exact), which a JAX block casts to its signal's
type.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.params import (FIRArbitrary, FIRDecimator, FIRFarrow,
                         FIRInterpolator, FIRRational, FIRStandard,
                         FilterState, default_device, storage_dtype,
                         store_dtype_of, to_tensor)

__all__ = ["params_from_jax", "state_from_jax", "state_to_jax"]


def params_from_jax(fields, device=None):
    """The port's kernel from a JAX kernel's fields.

    ``fields`` maps field names to numpy arrays, ints or floats:
    ``taps_rev`` (with ``decimation`` for a decimator); ``pfb`` with
    ``interpolation`` (and ``decimation`` for a rational kernel); ``pfb``
    and ``dpfb`` with ``nphi``, ``rate`` and ``delta_fx`` for an arbitrary
    kernel; ``pfb`` and ``coeffs`` with ``nphi``, ``rate`` and
    ``delta_fx`` for a Farrow kernel. ``delta_fx`` is taken as given, so
    both packages step the same accumulator. Other fields (the TPU K
    stacks ``k_super``, ``k_zc_hi`` and ``k_zc_lo``, ``sc_group``, the
    gridsel/ratgrid plans) are ignored. The class follows the fields
    present, as the JAX classes' fields do. A bank keeps its type (a
    rational-family one also bfloat16 or an integer type) or goes to its
    storage type with the taps' own type kept as ``taps_dtype``, Farrow
    ``coeffs`` stay float64 or complex128, and ``store_dtype`` carries
    over. The kernel lives on ``device``, by default the card.
    """
    dev = default_device() if device is None else torch.device(device)

    def bank(name, quantized=True):
        """The bank in its storage type, and the taps' type where that
        differs (``taps_dtype``)."""
        t = to_tensor(fields[name], dev)
        stored = t.to(storage_dtype(t.dtype, quantized)).contiguous()
        return stored, (None if stored.dtype == t.dtype else t.dtype)

    if "dpfb" in fields or "coeffs" in fields:
        nphi, rate = int(fields["nphi"]), float(fields["rate"])
        dfx = int(fields["delta_fx"])
        if "coeffs" in fields:
            return FIRFarrow.from_fit(fields["pfb"], fields["coeffs"], nphi,
                                      rate, dfx, dev)
        (pfb, tdt), (dpfb, _) = bank("pfb", False), bank("dpfb", False)
        table = torch.stack([pfb, dpfb])
        return FIRArbitrary(table=table, nphi=nphi,
                            taps_per_phi=table.shape[1], rate=rate,
                            delta_fx=dfx, taps_dtype=tdt)

    store = fields.get("store_dtype")
    if isinstance(store, np.ndarray):  # np.asarray of None or of a dtype
        store = store.item()
    store = store_dtype_of(store)
    if "taps_rev" in fields:
        taps, tdt = bank("taps_rev")
        if "decimation" in fields:
            return FIRDecimator(taps_rev=taps, hlen=taps.shape[0],
                                decimation=int(fields["decimation"]),
                                store_dtype=store, taps_dtype=tdt)
        return FIRStandard(taps_rev=taps, hlen=taps.shape[0],
                           store_dtype=store, taps_dtype=tdt)
    pfb, tdt = bank("pfb")
    L = int(fields["interpolation"])
    if "decimation" in fields:
        return FIRRational(pfb=pfb, interpolation=L,
                           decimation=int(fields["decimation"]),
                           taps_per_phi=pfb.shape[0], store_dtype=store,
                           taps_dtype=tdt)
    return FIRInterpolator(pfb=pfb, interpolation=L,
                           taps_per_phi=pfb.shape[0], store_dtype=store,
                           taps_dtype=tdt)


def state_from_jax(params, history, phase, deficit) -> FilterState:
    """The port's state from a JAX state's (history, phase, deficit): the
    trailing ``params.h_min`` history samples in their own type (the
    signal's, as JAX keeps it), on the kernel's device."""
    history = to_tensor(history)
    if history.shape[-1] < params.h_min:
        raise ValueError(f"history holds {history.shape[-1]} samples, the "
                         f"kernel needs {params.h_min}")
    tail = history[..., history.shape[-1] - params.h_min:]
    tail = tail.to(params.device)
    return FilterState(history=tail.contiguous(),
                       phase=int(phase), deficit=int(deficit))


def state_to_jax(state: FilterState, history_len: int):
    """(history, phase, deficit) as numpy arrays for a JAX FilterState
    whose kernel carries ``history_len`` samples, the history in its own
    type (complex as complex; bfloat16 as float32)."""
    h = state.history.detach().cpu()
    h = (h.float() if h.dtype == torch.bfloat16 else h).numpy()
    if history_len < h.shape[-1]:
        raise ValueError(f"history_len {history_len} is shorter than the "
                         f"{h.shape[-1]} samples the filter needs")
    pad = [(0, 0)] * (h.ndim - 1) + [(history_len - h.shape[-1], 0)]
    return (np.pad(h, pad), np.asarray(state.phase, np.int64),
            np.asarray(state.deficit, np.int64))
