"""Float32 precision policy on the GPU.

The JAX package's concern was the TPU matrix unit, whose DEFAULT precision
truncates float32 operands to bfloat16 (``multirate_tpu/ops/precision.py``).
On an NVIDIA card the same trap is TF32: with it on, cuBLAS float32 matrix
products and cuDNN float32 convolutions keep about three decimal digits,
far outside the 8e-5 relative-RMS oracle budget of the float32 headline.

Policy:

- the hand-written polyphase kernel (``ops/cuda/polyphase.py``) is plain
  float32 FMA and never touches a tensor core, so no flag can change it;
- the plain PyTorch version beside it contracts with ``torch.einsum``,
  which may lower to a cuBLAS batched product on the card. Every entry
  point that can reach cuBLAS or cuDNN runs it inside ``fp32()``, which
  turns TF32 off for both and restores the caller's flags on exit, so a
  filtering call never changes the precision of the user's own work.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["fp32"]


@contextlib.contextmanager
def fp32():
    """TF32 off for cuBLAS matrix products and cuDNN convolutions inside
    the block; the caller's flags are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
