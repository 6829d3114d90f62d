"""The polyphase kernel: its wrapper, its launch count and its plain version.

``polyphase`` computes, for every channel c and output n < n_out,

    t_n = (phi0 - 1) + n*M,  in_n = d0 + t_n div L,  phi_n = t_n mod L
    y[c, n] = sum_{t < T} xext[c, in_n - 1 + t] * bank[t, phi_n]

with xext = [hist ++ x] and hist the trailing T - 1 samples. This is what
the TPU kernel ``multirate_tpu/ops/pallas/rational2.py``
``rational_supercycle_zc`` computes for the rational family, and the
float32 real case of ``rational_supercycle_grouped`` and
``multirate_tpu/ops/pallas/rational.py`` ``rational_supercycle_pallas``.
On a CUDA tensor it launches the hand-written kernel in
``csrc/polyphase.cu`` (see its header for the design and what bounds it);
on a CPU tensor it runs ``polyphase_plain``, the same function in plain
PyTorch. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..indexing import rational_indices
from ..precision import fp32

__all__ = ["polyphase", "polyphase_plain", "launches"]

# Kernel launches made by ``polyphase`` in this process. It grows by one
# where the kernel is launched and nowhere else; a caller may reset it.
launches = 0

_LIMIT = 1 << 20  # L and M bound: keeps in-tile offsets inside int32


def polyphase_plain(x, hist, bank, L: int, M: int, phi0: int, d0: int,
                    n_out: int) -> torch.Tensor:
    """Plain PyTorch version: int64 index vectors, a window gather and a
    float32 einsum. Runs on any device; arguments as for ``polyphase``."""
    T = bank.shape[0]
    xext = torch.cat([hist, x], dim=-1)
    inp, phi = rational_indices(L, M, phi0, d0, n_out, device=x.device)
    ind = (inp - 1)[:, None] + torch.arange(T, device=x.device)[None, :]
    windows = xext[:, ind]                        # (C, n_out, T)
    taps = bank.t()[phi]                          # (n_out, T)
    with fp32():
        return torch.einsum("cnt,nt->cn", windows, taps)


def _check(x, hist, bank, L, M, phi0, d0, n_out):
    for name, t in (("x", x), ("hist", hist), ("bank", bank)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
              n_out: int) -> torch.Tensor:
    """y (C, n_out) from x (C, xlen), hist (C, T-1) and bank (T, L).

    All float32 and contiguous on one device; (phi0, d0) is the 1-based
    entry phase and deficit, and n_out the exact output count
    (``indexing.host_carry``). Raises on anything the kernel does not take.
    """
    global launches
    _check(x, hist, bank, L, M, phi0, d0, n_out)
    if x.device.type == "cpu":
        return polyphase_plain(x, hist, bank, L, M, phi0, d0, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"no polyphase kernel for device {x.device}")
    y = torch.empty((x.shape[0], n_out), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    from .build import load_polyphase

    lib = load_polyphase()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mr_polyphase_f32(
            x.data_ptr(), hist.data_ptr(), bank.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], bank.shape[0], L, M, phi0, d0, n_out,
            stream)
    if err != 0:
        raise RuntimeError("polyphase kernel launch failed: "
                           + lib.mr_error_string(err).decode())
    launches += 1
    return y
