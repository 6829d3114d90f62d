"""The bandwidth probe kernels: their wrappers, launch counts and plain
versions.

``copy`` computes a flat copy of a tensor of any type, and ``expand`` the
1:ratio expand of float32 rows,

    y[r, k*W + w] = cast(x[r, w])  for k < ratio, w < W,

with a float32, bfloat16, float16 or int8 store; the int8 cast is
``clip(32*x, -127, 127)`` truncated toward zero. These are what the TPU
kernels of ``multirate_tpu/utils/metrics.py`` ``stream_copy_gbps`` and
``stream_expand_gbps`` compute, without their tile relabelling and 128-lane
stores (TPU layout workarounds). ``utils/metrics.py`` times them as the
card's achievable device-memory ceilings. On a CUDA tensor the wrappers
launch the hand-written kernels in ``csrc/probe.cu`` (see its header for
the design and the bound); on a CPU tensor they run ``copy_plain`` and
``expand_plain``, the same functions in plain PyTorch. There is no fallback
from one to the other.
"""

from __future__ import annotations

import torch

from .build import load_probe

__all__ = ["copy", "expand", "copy_plain", "expand_plain", "launches",
           "ENTRIES", "EXPAND"]

# The expand kernel's entry point (``mr_probe_<name>``) for each store type;
# ``ENTRIES`` lists every entry point of csrc/probe.cu.
EXPAND = {torch.float32: "expand_f32", torch.bfloat16: "expand_bf16",
          torch.float16: "expand_f16", torch.int8: "expand_s8"}
ENTRIES = ("copy", *EXPAND.values())

# Kernel launches made by ``copy`` and ``expand`` in this process, by entry
# point. Each grows by one where its kernel is launched and nowhere else; a
# caller may reset them.
launches = dict.fromkeys(ENTRIES, 0)


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``copy``."""
    return x.clone(memory_format=torch.contiguous_format)


def expand_plain(x: torch.Tensor, ratio: int,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``expand``: the row repeated, then the
    int8 clip, then the cast."""
    wide = x.repeat(1, ratio)
    if out_dtype == torch.int8:
        wide = torch.clamp(wide * 32.0, -127.0, 127.0)
    return wide.to(out_dtype)


def _raise_on(err: int, lib) -> None:
    if err != 0:
        raise RuntimeError("probe kernel launch failed: "
                           + lib.mr_error_string(err).decode())


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return x.device.type


def copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of contiguous ``x``, of any type. On the card the
    source may sit at any byte offset (a view); the output is allocated
    here, aligned."""
    if _device_of(x) == "cpu":
        return copy_plain(x)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return y
    lib = load_probe()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(lib.mr_probe_copy(x.data_ptr(), y.data_ptr(), nbytes,
                                    stream), lib)
    launches["copy"] += 1
    return y


def expand(x: torch.Tensor, ratio: int,
           out_dtype=torch.float32) -> torch.Tensor:
    """y (R, ratio*W) of ``out_dtype`` from float32 x (R, W): each row
    repeated ``ratio`` times, cast. The kernel takes W % 4 == 0 and a
    16-byte aligned x, and raises on anything else."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"expand takes a 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if out_dtype not in EXPAND:
        raise TypeError(f"no expand kernel for {out_dtype} stores")
    if int(ratio) < 1:
        raise ValueError(f"ratio must be at least 1, got {ratio}")
    if _device_of(x) == "cpu":
        return expand_plain(x, ratio, out_dtype)
    R, W = x.shape
    if W % 4 or x.data_ptr() % 16:
        raise ValueError(f"the expand kernel takes rows of a multiple of 4 "
                         f"floats, 16-byte aligned; got W={W}")
    y = torch.empty((R, ratio * W), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = load_probe()
    name = EXPAND[out_dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(getattr(lib, f"mr_probe_{name}")(
            x.data_ptr(), y.data_ptr(), R, W, int(ratio), stream), lib)
    launches[name] += 1
    return y
