"""Build the package's kernels from its own sources, at first use.

CUDA C++ sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``
into shared libraries with a plain C interface and loaded with ``ctypes``.
Each library is keyed by a hash of its source and the compiler flags, so an
edit rebuilds it and an unchanged source is reused. Everything is written
under ``_build/`` inside the package (listed in ``.gitignore``), including
Triton's cache, so a checkout builds in place and writes nothing outside it.
Nothing here runs at import time.
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

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_cuda_library(source_name: str) -> tuple[Path, str]:
    """Compile ``csrc/<source_name>`` if its hashed library is missing.

    Returns the library path and the compiler's log (``-Xptxas -v``: the
    registers, shared memory and spills of each kernel); the log is empty
    when the library was already built.
    """
    src = CSRC_DIR / source_name
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load_cuda_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``."""
    lib, _ = build_cuda_library(source_name)
    return ctypes.CDLL(str(lib))


def import_triton():
    """Import triton with its kernel cache under ``_build/triton``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    return triton
