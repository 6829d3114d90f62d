"""Build the package's native sources and load them with ctypes.

Each CUDA source under ``multirate_tpu_torch/csrc/`` compiles by hand into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v --split-compile=0 \\
         -o build/<name>-<hash>/lib<name>.so csrc/<name>.cu

``--split-compile=0`` optimises and assembles the many kernel
instantiations of one source on every host core at once.

The host-only sources, the ring buffer ``csrc/mr_ring.cpp`` and the
launch planner ``csrc/mr_plan.cpp``, compile the same way with g++
(``-O3 -std=c++17 -shared -fPIC``), so they build where there is no nvcc.

The output goes to ``build/`` at the repository root, at first use, in a
directory keyed by a hash of the source, the headers beside it
(``csrc/*.cuh``: ``geometry.cuh`` is shared by the kernels and the
planner) and the flags, so an edited source or header rebuilds and an
unchanged one loads at once. ``-Xptxas=-v`` writes
each kernel's registers, shared memory and spills to ``build.log`` beside
the library. Nothing is built when a module is imported. ``load`` types a
library's functions from its wrapper's signature table; ``launch`` is
every kernel wrapper's call into one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "GXX_FLAGS", "build",
           "check_aligned", "load", "launch", "ERROR_STRING"]

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


def _recipe(name: str, defines: tuple):
    """(source, compiler, flags, output directory) of library ``name``: the
    directory, ``build/<name>-<hash>``, is keyed by all but the compiler."""
    src, cmd, flags = CSRC_DIR / f"{name}.cu", "nvcc", NVCC_FLAGS
    if not src.is_file():
        src, cmd, flags = CSRC_DIR / f"{name}.cpp", "g++", GXX_FLAGS
    flags = (*flags, *(f"-D{d}" for d in defines))
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        key.update(header.read_bytes())
    return src, cmd, flags, BUILD_DIR / f"{name}-{key.hexdigest()[:16]}"


def build(name: str, force: bool = False, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc, or the host source
    ``csrc/<name>.cpp`` with g++, if needed (always with ``force``); return
    the library's path. ``defines`` are macro names passed as ``-D``
    (``tools/polyphase_runs.py``'s clock split): another library."""
    src, cmd, flags, out_dir = _recipe(name, defines)
    lib = out_dir / f"lib{name}.so"
    if lib.is_file() and not force:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        compiler = _nvcc() if cmd == "nvcc" else cmd
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd} failed on {src.name}:"
                               f"\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


# Every CUDA library's error message for a launch's return code.
ERROR_STRING = ("mr_error_string", ctypes.c_char_p, (ctypes.c_int,))


# Loaded libraries by (name, signature table's id, defines); each entry
# keeps its table alive, so an id is never reused while it is a key.
_loaded: dict = {}


def load(name: str, signatures: tuple, defines: tuple = ()) -> ctypes.CDLL:
    """The library built from ``csrc/<name>`` (at first use, with
    ``defines`` if any: see ``build``), each function of ``signatures``, a
    tuple of (name, restype, argtypes) kept beside its wrapper's entries,
    typed. Cached by the table's identity, not its value: every launch asks,
    and hashing a table of 30 entry points costs microseconds. Two threads
    that load at once share the library (a build is renamed into place
    whole)."""
    hit = _loaded.get((name, id(signatures), defines))
    if hit is not None:
        return hit[1]
    lib = ctypes.CDLL(str(build(name, defines=defines)))
    for fn, restype, argtypes in signatures:
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _loaded[name, id(signatures), defines] = (signatures, lib)
    return lib


def launch(name: str, signatures: tuple, entry: str, device, args: tuple,
           *counted) -> None:
    """Call ``entry`` of library ``name`` with ``args`` and ``device``'s
    current stream, on that device; raise RuntimeError with the library's
    message for a nonzero code, else add one to each ``counts[key]`` of
    ``counted`` ((counts, key) pairs: the launch counts)."""
    lib = load(name, signatures)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.mr_error_string(err).decode())
    for counts, key in counted:
        counts[key] += 1


def check_aligned(**tensors):
    """Raise unless each tensor's data lies at a multiple of its element
    size: the kernels load a complex128 sample as one 16-byte word."""
    for name, t in tensors.items():
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} is not aligned to its element size")
