"""Build the package's native sources and load them with ctypes.

Each CUDA source under ``multirate_tpu_torch/csrc/`` compiles by hand into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v --split-compile=0 \\
         -o build/<name>-<hash>/lib<name>.so csrc/<name>.cu

``--split-compile=0`` optimises and assembles the many kernel
instantiations of one source on every host core at once.

The host-only ring buffer ``csrc/mr_ring.cpp`` compiles the same way with
g++ (``-O3 -std=c++17 -shared -fPIC``), so it builds where there is no
nvcc.

The output goes to ``build/`` at the repository root, at first use, in a
directory keyed by a hash of the source, the headers beside it
(``csrc/*.cuh``, for CUDA sources) and the flags, so an edited source or
header rebuilds and an unchanged one loads at once. ``-Xptxas=-v`` writes
each kernel's registers, shared memory and spills to ``build.log`` beside
the library. Nothing is built when a module is imported.
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

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "GXX_FLAGS", "build",
           "check_aligned", "load_polyphase", "load_resample", "load_probe"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str, force: bool = False, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc, or the host source
    ``csrc/<name>.cpp`` with g++, if needed (always with ``force``); return
    the library's path. ``defines`` are macro names passed as ``-D``
    (``tools/polyphase_runs.py``'s clock split): another library."""
    src = CSRC_DIR / f"{name}.cu"
    if src.is_file():
        cmd, flags = [_nvcc()], NVCC_FLAGS
        headers = sorted(CSRC_DIR.glob("*.cuh"))
    else:
        src = CSRC_DIR / f"{name}.cpp"
        cmd, flags, headers = ["g++"], GXX_FLAGS, []
    flags = (*flags, *(f"-D{d}" for d in defines))
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in headers:
        key.update(header.read_bytes())
    out_dir = BUILD_DIR / f"{name}-{key.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.is_file() and not force:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed on {src.name}:"
                               f"\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load_polyphase(defines: tuple = ()) -> ctypes.CDLL:
    """The polyphase kernel library (built at first use, with ``defines``
    if any: see ``build``), argtypes set for each entry point
    ``mr_polyphase_<name>`` of ``polyphase.ENTRIES``."""
    from .polyphase import ENTRIES

    lib = ctypes.CDLL(str(build("polyphase", defines=defines)))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ENTRIES.values():
        fn = getattr(lib, f"mr_polyphase_{name}")
        # ..., variant, tile, grid, depth, stream
        fn.argtypes = [p, p, p, p, i64, i64, i32, i32, i32, i32, i64, i64,
                       i32, i32, i64, i32, p]
        fn.restype = i32
    lib.mr_error_string.argtypes = [i32]
    lib.mr_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_resample() -> ctypes.CDLL:
    """The arbitrary/Farrow kernel library (built at first use), argtypes
    set for each entry point ``mr_resample_<name>`` of
    ``resample.ENTRIES``; those with a time-major form
    (``resample.TM_ENTRIES``) also take the layout, and each takes its
    launch's ``resample.plan``."""
    from .resample import ENTRIES, TM_ENTRIES

    lib = ctypes.CDLL(str(build("resample")))
    p, i64, u64, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                        ctypes.c_int)
    args = [p, p, p, p, i64, i64, i32, i32, i32, u64, u64, i64, i64]
    # variant, tile, channels, run, grid, stride, mult
    plan = [i32, i32, i32, i32, i64, i32, i32]
    for key, name in ENTRIES.items():
        fn = getattr(lib, f"mr_resample_{name}")
        layout = [i32] if key in TM_ENTRIES else []
        fn.argtypes = args + layout + plan + [p]
        fn.restype = i32
    lib.mr_error_string.argtypes = [i32]
    lib.mr_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_probe() -> ctypes.CDLL:
    """The copy and expand probe library (built at first use), argtypes set
    for ``mr_probe_copy`` and each ``mr_probe_<name>`` of
    ``probe.EXPAND``."""
    from .probe import EXPAND

    lib = ctypes.CDLL(str(build("probe")))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.mr_probe_copy.argtypes = [p, p, i64, p]
    lib.mr_probe_copy.restype = i32
    for name in EXPAND.values():
        fn = getattr(lib, f"mr_probe_{name}")
        fn.argtypes = [p, p, i64, i32, i32, p]
        fn.restype = i32
    lib.mr_error_string.argtypes = [i32]
    lib.mr_error_string.restype = ctypes.c_char_p
    return lib


def check_aligned(**tensors):
    """Raise unless each tensor's data lies at a multiple of its element
    size: the kernels load a complex128 sample as one 16-byte word."""
    for name, t in tensors.items():
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} is not aligned to its element size")
