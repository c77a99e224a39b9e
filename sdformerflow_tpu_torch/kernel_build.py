"""Build the package's kernels from its own sources, at first use.

CUDA C++ sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``,
and host C++ sources (the event packer) by ``g++``, into shared libraries
with a plain C interface, loaded with ``ctypes``.
Each library is keyed by a hash of its source, every header under ``csrc/``
(``*.cuh``, which the sources include) and the compiler flags, so an edit
rebuilds it and an unchanged source is reused. Everything is written
under ``_build/`` inside the package (listed in ``.gitignore``), so a
checkout builds in place and writes nothing outside it.
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
# --split-compile=0 optimizes a source's kernels in parallel on every core:
# psn.cu's 64 instantiations build in 31.5 s instead of 96.2 s
# (chip_smoke.py phase 1, an 8-core host with an H100)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


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


def source_digest(src: Path, flags, csrc_dir: Path = CSRC_DIR) -> str:
    """The build key of ``src``: a hash of its bytes, of every ``*.cuh``
    header in ``csrc_dir`` (name and bytes, in name order) and of the
    compiler flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc_dir.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _build(source_name: str, compiler: str, flags) -> tuple[Path, str]:
    src = CSRC_DIR / source_name
    lib = BUILD_DIR / f"{src.stem}-{source_digest(src, flags)}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                               f"{src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


def build_cuda_library(source_name: str) -> tuple[Path, str]:
    """Compile ``csrc/<source_name>`` with nvcc if its hashed library is
    missing.

    Returns the library path and the compiler's log (``-Xptxas -v``: the
    registers, shared memory and spills of each kernel); the log is empty
    when the library was already built.
    """
    return _build(source_name, _nvcc(), NVCC_FLAGS)


@functools.cache
def load_cuda_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``."""
    lib, _ = build_cuda_library(source_name)
    return ctypes.CDLL(str(lib))


def build_host_library(source_name: str) -> tuple[Path, str]:
    """Compile the host C++ source ``csrc/<source_name>`` with g++ if its
    hashed library is missing; returns the library path and the compiler's
    log (empty when the library was already built)."""
    return _build(source_name, "g++", GXX_FLAGS)


@functools.cache
def load_host_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load the host library of ``csrc/<source_name>``."""
    lib, _ = build_host_library(source_name)
    return ctypes.CDLL(str(lib))
