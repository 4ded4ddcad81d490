"""Build and bind the port's hand-written CUDA kernels.

Each ``<name>.cu`` in this directory has a plain C interface. At first use
it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of its source so that an edited kernel is
rebuilt, and loaded with ``ctypes``. Nothing is built or loaded when this
module is imported. A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "ptxas": the compiler's register/spill report}
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def build(name: str) -> Path:
    """Compile ``<name>.cu`` unless a library of the same source exists."""
    src = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        BUILD_INFO[name] = {"seconds": 0.0, "ptxas": log.read_text() if log.exists() else ""}
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``<name>.cu``, built on first call."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
