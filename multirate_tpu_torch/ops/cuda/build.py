"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under ``multirate_tpu_torch/csrc/`` compiles by hand into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/<name>-<hash>/lib<name>.so \\
         csrc/<name>.cu

The output goes to ``build/`` at the repository root, at first use, in a
directory keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once. ``-Xptxas=-v`` writes each
kernel's registers, shared memory and spills to ``build.log`` beside the
library. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load_polyphase"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` if needed; return the library's path."""
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_DIR / f"{name}-{key.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load_polyphase() -> ctypes.CDLL:
    """The polyphase kernel library (built at first use), argtypes set."""
    lib = ctypes.CDLL(str(build("polyphase")))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.mr_polyphase_f32.argtypes = [p, p, p, p, i64, i64, i32, i32, i32,
                                     i32, i64, i64, p]
    lib.mr_polyphase_f32.restype = i32
    lib.mr_error_string.argtypes = [i32]
    lib.mr_error_string.restype = ctypes.c_char_p
    return lib
