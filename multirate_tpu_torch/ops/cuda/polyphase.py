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
  complex taps of their type (4), complex sums and output.

``out_dtype`` stores the float32 and bf16 modes' output narrow (bfloat16
or float16, round to nearest even: JAX ``store_dtype``). On a CUDA tensor
the wrapper launches the hand-written kernel in ``csrc/polyphase.cu`` (see
its header for the design and what bounds it); on a CPU tensor it runs
``polyphase_plain``, the same function in plain PyTorch. There is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..indexing import rational_indices
from ..precision import fp32
from .build import check_aligned, load_polyphase

__all__ = ["polyphase", "polyphase_plain", "launches"]

# The kernel's entry point (``mr_polyphase_<name>``, one instantiation of
# csrc/polyphase.cu) for each (signal, taps, output) dtype triple, and each
# signal type's accumulator (its default output).
_F32, _F64, _C64, _C128 = (torch.float32, torch.float64, torch.complex64,
                           torch.complex128)
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
}
ACCUMULATOR = {_F32: _F32, torch.bfloat16: _F32, torch.int8: torch.int32,
               _F64: _F64, _C64: _C64, _C128: _C128}

# Kernel launches made by ``polyphase`` in this process, by entry point.
# Each grows by one where its kernel is launched and nowhere else; a caller
# may reset them.
launches = dict.fromkeys(ENTRIES.values(), 0)

_LIMIT = 1 << 20  # L and M bound: keeps in-tile offsets inside int32


def polyphase_plain(x, hist, bank, L: int, M: int, phi0: int, d0: int,
                    n_out: int, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: int64 index vectors, a window gather and a
    contraction. The float modes contract with an einsum under ``fp32()``
    in the accumulator's type: float32 for float32 and bf16 (bf16 products
    are exact in float32), else the signal's own type (float64, complex64
    or complex128, real taps cast to it). int8 widens to int32 and sums
    exact products (an int8 einsum would wrap in int8, and the card has no
    integer matmul). Runs on any device; arguments as for ``polyphase``."""
    T = bank.shape[0]
    xext = torch.cat([hist, x], dim=-1)
    inp, phi = rational_indices(L, M, phi0, d0, n_out, device=x.device)
    ind = (inp - 1)[:, None] + torch.arange(T, device=x.device)[None, :]
    windows = xext[:, ind]                        # (C, n_out, T)
    taps = bank.t()[phi]                          # (n_out, T)
    if x.dtype == torch.int8:
        y = (windows.to(torch.int32) * taps.to(torch.int32)).sum(
            -1, dtype=torch.int32)
    else:
        acc = ACCUMULATOR[x.dtype]
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
              n_out: int, out_dtype=None) -> torch.Tensor:
    """y (C, n_out) from x (C, xlen), hist (C, T-1) and bank (T, L).

    x and hist share the signal type and bank has the tap type, a pair of
    ``ENTRIES``, all contiguous on one device; (phi0, d0) is the 1-based
    entry phase and deficit, and n_out the exact output count
    (``indexing.host_carry``). ``out_dtype`` is the output type, by
    default the accumulator's (``ACCUMULATOR``: the signal's type, float32
    for bfloat16, int32 for int8); float32 and bf16 signals also store
    bfloat16 or float16. Raises on anything the kernel does not take.
    """
    if x.dtype not in ACCUMULATOR:
        raise TypeError(f"no polyphase kernel for {x.dtype} samples")
    out_dtype = ACCUMULATOR[x.dtype] if out_dtype is None else out_dtype
    _check(x, hist, bank, L, M, phi0, d0, n_out, out_dtype)
    if x.device.type == "cpu":
        return polyphase_plain(x, hist, bank, L, M, phi0, d0, n_out,
                               out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no polyphase kernel for device {x.device}")
    check_aligned(x=x, hist=hist, bank=bank)
    y = torch.empty((x.shape[0], n_out), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    name = ENTRIES[x.dtype, bank.dtype, out_dtype]
    entry = getattr(load_polyphase(), f"mr_polyphase_{name}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), hist.data_ptr(), bank.data_ptr(),
                    y.data_ptr(), x.shape[0], x.shape[1], bank.shape[0], L,
                    M, phi0, d0, n_out, stream)
    if err != 0:
        raise RuntimeError("polyphase kernel launch failed: "
                           + load_polyphase().mr_error_string(err).decode())
    launches[name] += 1
    return y
