"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``.cu`` file in the repository with a plain C interface.
``load(source)`` compiles it with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` at the repository root, named by a hash of the
source, the shared headers under ``include/`` and the flags, so an edited
source or header builds anew and an unchanged one is reused.  Nothing here
runs at import time: importing this module needs neither ``nvcc`` nor CUDA.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built; return the
    library's path.  The compiler's register and shared-memory report is
    kept beside it as ``<library>.log``."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR),
                               "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    lib.with_suffix(".log").write_text(
        f"built in {time.perf_counter() - t0:.2f} s\n{proc.stdout}{proc.stderr}")
    return lib


@functools.cache
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first call."""
    return ctypes.CDLL(str(build(source)))
