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
type for complex taps (``ENTRIES``); y has the signal's type. The
time-major kernel is float32 only.
"""

from __future__ import annotations

import torch

from ..indexing import ACCUM_OPERAND_BITS, _muladd_divmod, accum_indices
from ..params import PHASE_FRAC_BITS, FIRArbitrary, FIRFarrow
from ..precision import fp32

__all__ = ["resample", "resample_tm", "resample_plain", "resample_tm_plain",
           "launches", "launches_tm", "ENTRIES"]

# The kernel's channel-major entry point (``mr_resample_<name>``, one
# instantiation of csrc/resample.cu) for each (signal, table) dtype pair.
ENTRIES = {
    (torch.float32, torch.float32): "f32",
    (torch.float64, torch.float64): "f64",
    (torch.complex64, torch.float32): "c64",
    (torch.complex64, torch.complex64): "c64c",
    (torch.complex128, torch.float64): "c128",
    (torch.complex128, torch.complex128): "c128c",
}

# Kernel launches made by ``resample`` (by entry point) and by
# ``resample_tm`` (float32) in this process. Each grows by one where its
# kernel is launched and nowhere else; a caller may reset them.
launches = dict.fromkeys(ENTRIES.values(), 0)
launches_tm = 0

_N_OUT_LIMIT = 1 << 40  # keeps u0 + n_out*delta_fx below the kernel's 2^96


def _taps_plain(params, phi, frac):
    """(n, T) taps in the table's type, as the JAX ``windows`` path forms
    them: arbitrary from the banks and alpha in their precision, Farrow
    from the float64 (or complex128) fit evaluated at psi."""
    tdt = params.table.dtype
    if isinstance(params, FIRArbitrary):
        alpha = frac.to(tdt.to_real())[:, None]
        return params.pfb.t()[phi] + alpha * params.dpfb.t()[phi]
    psi = 1.0 + phi.to(torch.float64) + frac
    powers = psi[:, None] ** torch.arange(
        params.polyorder + 1, dtype=torch.float64, device=psi.device)[None, :]
    return (powers.to(params.coeffs.dtype) @ params.coeffs).to(tdt)


def resample_plain(x, hist, params, u0: int, d0: int,
                   n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``resample``: int64 accumulator indices, a
    window gather and an einsum in the signal's type (real taps cast to
    it). Runs on any device."""
    T = params.taps_per_phi
    xext = torch.cat([hist, x], dim=-1)
    inp, phi, frac = accum_indices(params.nphi, params.delta_fx, u0, d0,
                                   n_out, device=x.device)
    ind = (inp - 1)[:, None] + torch.arange(T, device=x.device)[None, :]
    windows = xext[:, ind]                        # (C, n_out, T)
    with fp32():
        taps = _taps_plain(params, phi, frac)     # (n_out, T)
        return torch.einsum("cnt,nt->cn", windows, taps.to(x.dtype))


def resample_tm_plain(xt, hist, params, u0: int, d0: int,
                      n_out: int) -> torch.Tensor:
    """Plain PyTorch version of ``resample_tm``: (xlen, C) -> (n_out, C)."""
    return resample_plain(xt.t(), hist, params, u0, d0, n_out).t().contiguous()


def _check(x, hist, params, u0, d0, n_out, time_major):
    if not isinstance(params, (FIRArbitrary, FIRFarrow)):
        raise TypeError(f"resample takes FIRArbitrary or FIRFarrow, got "
                        f"{type(params).__name__}")
    pair = (x.dtype, params.table.dtype)
    if pair not in ENTRIES or (time_major and ENTRIES[pair] != "f32"):
        raise TypeError(f"no {'time-major ' if time_major else ''}resample "
                        f"kernel for {x.dtype} samples and a "
                        f"{params.table.dtype} table")
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


def _launch(x, hist, params, u0, d0, n_out, time_major):
    """(y, the entry point launched or None): nothing runs for no output."""
    C, xlen = (x.shape[1], x.shape[0]) if time_major else x.shape
    shape = (n_out, C) if time_major else (C, n_out)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y, None
    from .build import check_aligned, load_resample

    check_aligned(x=x, hist=hist, table=params.table)
    name = ENTRIES[x.dtype, params.table.dtype]
    lib = load_resample()
    layout = (int(time_major),) if name == "f32" else ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"mr_resample_{name}")(
            x.data_ptr(), hist.data_ptr(), params.table.data_ptr(),
            y.data_ptr(), C, xlen, params.taps_per_phi, params.nphi,
            params.table.shape[0], params.delta_fx, u0, d0, n_out,
            *layout, stream)
    if err != 0:
        raise RuntimeError("resample kernel launch failed: "
                           + lib.mr_error_string(err).decode())
    return y, name


def resample(x, hist, params, u0: int, d0: int, n_out: int) -> torch.Tensor:
    """y (C, n_out) from x (C, xlen) and hist (C, T-1), channel-major.

    ``params`` is an FIRArbitrary or FIRFarrow kernel on x's device whose
    table pairs with x's type in ``ENTRIES``; (u0, d0) the entry
    accumulator and deficit, n_out the exact output count
    (``indexing.host_carry``). Raises on anything the kernel does not
    take.
    """
    _check(x, hist, params, u0, d0, n_out, time_major=False)
    if x.device.type == "cpu":
        return resample_plain(x, hist, params, u0, d0, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {x.device}")
    y, name = _launch(x, hist, params, u0, d0, n_out, time_major=False)
    if name is not None:
        launches[name] += 1
    return y


def resample_tm(xt, hist, params, u0: int, d0: int,
                n_out: int) -> torch.Tensor:
    """y (n_out, C) from time-major xt (xlen, C) and channel-major hist
    (C, T-1), all float32; otherwise as ``resample``."""
    global launches_tm
    _check(xt, hist, params, u0, d0, n_out, time_major=True)
    if xt.device.type == "cpu":
        return resample_tm_plain(xt, hist, params, u0, d0, n_out)
    if xt.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {xt.device}")
    y, name = _launch(xt, hist, params, u0, d0, n_out, time_major=True)
    if name is not None:
        launches_tm += 1
    return y
