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
from typing import Dict, Iterable, List

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


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile each ``<name>.cu`` whose library is missing, one ``nvcc``
    process per source, all started together; name -> library path."""
    libs: Dict[str, Path] = {}
    running = {}
    try:
        for name in names:
            src = SOURCE_DIR / f"{name}.cu"
            digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
            lib = libs[name] = BUILD_DIR / f"lib{name}_{digest}.so"
            log = lib.with_suffix(".ptxas.txt")
            if lib.exists():
                BUILD_INFO[name] = {"seconds": 0.0, "ptxas": log.read_text() if log.exists() else ""}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running[name] = (proc, src, tmp, lib, log, time.perf_counter())
        for name, (proc, src, tmp, lib, log, t0) in running.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}\n{err}")
            log.write_text(err)
            os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": err}
    finally:
        for proc, *_ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``<name>.cu``, built on first call."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LIBS[name]


class Kernel:
    """One C entry point of ``<lib>.cu``'s library: built, loaded and typed
    (``argtypes``, an int error code returned) at its first call, then
    called directly. A call raises on a non-zero code from the launch."""

    def __init__(self, lib: str, fn: str, argtypes: List[type], restype: type = ctypes.c_int):
        self.lib_name, self.fn_name, self.argtypes, self.restype = lib, fn, argtypes, restype
        self._fn = None

    def bind(self):
        """The typed C function (built and loaded at the first call)."""
        if self._fn is None:
            lib = load(self.lib_name)
            fn = getattr(lib, self.fn_name)
            fn.argtypes, fn.restype = self.argtypes, self.restype
            lib.xr_cuda_error_string.argtypes = [ctypes.c_int]
            lib.xr_cuda_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, *args) -> None:
        code = (self._fn or self.bind())(*args)
        if code != 0:
            check(self._lib, code, self.fn_name)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero error code from a launch."""
    if code != 0:
        raise RuntimeError(f"{what} failed: {lib.xr_cuda_error_string(code).decode()} (cudaError {code})")


def stream(t) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_cpu(t, what: str) -> bool:
    """True for a CPU tensor (the caller takes the plain twin), False for a
    CUDA tensor (the caller launches the kernel); raises for any other."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {t.device}")
    return False
