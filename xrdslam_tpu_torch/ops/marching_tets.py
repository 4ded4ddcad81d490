"""Isosurface extraction by marching tetrahedra (host).

Counterpart of ``xrdslam_tpu/ops/marching_tets.py``: each cell of the grid
splits into 6 tetrahedra sharing the main diagonal, whose 16-case table is
derived below; vertices are linear zero crossings along cell edges, shared
between triangles after quantization. Only cells with mixed corner signs
(and, with a mask, all corners masked in) make triangles.

Two paths compute the same surface. ``native/marching_tets.cpp`` (one
sweep, no large temporaries) is compiled with ``g++`` at first use into
``build/torch_native/`` at the repository root (listed in ``.gitignore``),
under its own library name, and loaded with ``ctypes``; where no compiler
can build it, the NumPy path runs. This is host code, not a device kernel.
``backend()`` says which path runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "marching_tets.cpp"
BUILD_DIR = _REPO / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]  # no -march=native: the library may be loaded on another host

_native = {}  # "lib": the loaded library, or None when it cannot be built


def _load_native() -> Optional[ctypes.CDLL]:
    """Build (once per source) and load the C++ library; None when there is
    no compiler or the build fails."""
    if "lib" in _native:
        return _native["lib"]
    lib = None
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx and SOURCE.exists():
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"libxr_marching_tets_{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
            if r.returncode == 0:
                os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
        if so.exists():
            lib = ctypes.CDLL(str(so))
            lib.marching_tets.restype = ctypes.c_int64
            lib.marching_tets.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_float, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ]
    _native["lib"] = lib
    return lib


def backend() -> str:
    """"native" when the C++ library is built and loaded, else "numpy"."""
    return "native" if _load_native() is not None else "numpy"


# Cube corners in (x, y, z) bit order.
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64
)

# Split of the unit cube into 6 tetrahedra sharing the main diagonal 0-6.
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int64
)


def _build_tet_cases():
    """For each 4-bit inside-mask: list of triangles as 3 edges (ci, cj)."""
    cases = []
    for case in range(16):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        tris = []
        if len(inside) == 1:
            a, o = inside[0], outside
            tris = [[(a, o[0]), (a, o[1]), (a, o[2])]]
        elif len(inside) == 3:
            a, i = outside[0], inside
            tris = [[(i[0], a), (i[2], a), (i[1], a)]]
        elif len(inside) == 2:
            (a, b), (c, d) = inside, outside
            tris = [[(a, c), (a, d), (b, d)], [(a, c), (b, d), (b, c)]]
        cases.append(tris)
    return cases


_TET_CASES = _build_tet_cases()


def marching_tetrahedra(
    volume: np.ndarray,
    level: float = 0.0,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` isosurface of ``volume`` [nx, ny, nz].

    Args:
        mask: optional [nx, ny, nz] bool; cells with any unmasked corner are
              skipped (the keyframe-frustum mesh mask).
    Returns:
        (vertices [V, 3] float32 world coords, faces [F, 3] int64).
    """
    lib = _load_native()
    if lib is not None:
        return _marching_tets_native(lib, volume, level, origin, spacing, mask)
    return _marching_tets_numpy(volume, level, origin, spacing, mask)


def _marching_tets_native(lib, volume, level, origin, spacing, mask):
    vol = np.ascontiguousarray(volume, np.float32)
    nx, ny, nz = vol.shape
    org = np.asarray(origin, np.float64)
    spc = np.asarray(spacing, np.float64)
    m = None if mask is None else np.ascontiguousarray(mask.astype(np.uint8))
    # the C++ side stops at max_tris, so retry with a larger buffer whenever
    # it fills
    max_tris = max(int(nx * ny * nz * 0.25), 1 << 16)
    while True:
        out = np.empty((max_tris, 9), np.float32)
        n = lib.marching_tets(
            vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
            ctypes.c_float(level),
            org.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            spc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            m.ctypes.data if m is not None else None,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_tris,
        )
        if n < max_tris:
            break
        max_tris *= 4
    if n == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    verts, faces = _dedup_triangles(out[:n].reshape(-1, 3, 3).reshape(-1, 3).astype(np.float64))
    return verts.astype(np.float32), faces


def _dedup_triangles(verts_flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Share vertices quantized to 1e-5 (exact sharing of edge points) and
    drop degenerate faces: [3T, 3] -> (vertices [V, 3], faces [F, 3])."""
    keys = np.round(verts_flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    first_idx = np.full(uniq.shape[0], np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_idx, inv, np.arange(inv.shape[0]))
    faces = inv.reshape(-1, 3)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts_flat[first_idx], faces[good].astype(np.int64)


def _marching_tets_numpy(volume, level, origin, spacing, mask):
    nx, ny, nz = volume.shape
    v = volume - level
    # corner values per cell, [8, cx, cy, cz]
    cell = np.stack([v[cx:cx + nx - 1, cy:cy + ny - 1, cz:cz + nz - 1] for cx, cy, cz in _CUBE_CORNERS])
    neg = cell < 0
    active = neg.any(0) & (~neg).any(0)
    if mask is not None:
        mcorner = np.stack([mask[cx:cx + nx - 1, cy:cy + ny - 1, cz:cz + nz - 1] for cx, cy, cz in _CUBE_CORNERS])
        active &= mcorner.all(0)
    idx = np.argwhere(active)  # [A, 3] cell coords
    if idx.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    corner_vals = cell[:, active].T  # [A, 8]
    corner_pos = idx[:, None, :] + _CUBE_CORNERS[None, :, :]  # [A, 8, 3] grid coords
    all_tris = []
    for tet in _TETS:
        tv = corner_vals[:, tet]  # [A, 4]
        tp = corner_pos[:, tet, :]  # [A, 4, 3]
        case = ((tv < 0) << np.arange(4)).sum(-1)  # [A]
        for c in range(1, 15):
            sel = case == c
            if not _TET_CASES[c] or not sel.any():
                continue
            sv = tv[sel]
            sp = tp[sel].astype(np.float64)
            for tri in _TET_CASES[c]:
                pts = []
                for (i, j) in tri:
                    vi, vj = sv[:, i], sv[:, j]
                    t = np.clip(vi / np.where(np.abs(vi - vj) < 1e-12, 1e-12, vi - vj), 0.0, 1.0)
                    pts.append(sp[:, i, :] + t[:, None] * (sp[:, j, :] - sp[:, i, :]))
                all_tris.append(np.stack(pts, 1))  # [n, 3, 3]
    # vertices are shared in grid coordinates, then placed in the world
    verts, faces = _dedup_triangles(np.concatenate(all_tris, 0).reshape(-1, 3))
    verts = verts * np.asarray(spacing)[None, :] + np.asarray(origin)[None, :]
    return verts.astype(np.float32), faces
