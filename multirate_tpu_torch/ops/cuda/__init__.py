"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

- ``polyphase``: the rational-family polyphase kernel (``csrc/polyphase.cu``),
  its launch count and its plain PyTorch version.
- ``build``: nvcc build at first use into ``build/`` and ctypes loading.

Nothing here builds or loads a kernel at import time.
"""
