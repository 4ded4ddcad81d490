"""Mesh and image IO without open3d or trimesh.

Counterpart of ``xrdslam_tpu/utils/io.py``: a ``Mesh`` container, a
minimal binary-PLY writer and reader, and the debug images' writer and
depth colour ramp.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int
    vertex_colors: Optional[np.ndarray] = None  # [V, 3] float in [0,1]

    def export(self, path: str) -> None:
        write_ply(path, self.vertices, self.faces, self.vertex_colors)


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    has_color = colors is not None
    with open(path, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\n")
        fh.write(f"element vertex {len(v)}\n".encode())
        fh.write(b"property float x\nproperty float y\nproperty float z\n")
        if has_color:
            fh.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write(f"element face {len(f)}\n".encode())
        fh.write(b"property list uchar int vertex_indices\nend_header\n")
        if has_color:
            rec = np.zeros(len(v), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = v
            rec["rgb"] = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
            fh.write(rec.tobytes())
        else:
            fh.write(v.tobytes())
        frec = np.zeros(len(f), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        frec["n"] = 3
        frec["idx"] = f
        fh.write(frec.tobytes())


def read_ply(path: str) -> Mesh:
    """Binary PLY reader for meshes written by ``write_ply``."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vert = n_face = 0
        for h in header:
            if h.startswith("element vertex"):
                n_vert = int(h.split()[-1])
            elif h.startswith("element face"):
                n_face = int(h.split()[-1])
        if not any("binary_little_endian" in h for h in header):
            raise NotImplementedError("ascii ply not supported")
        if any("red" in h for h in header):
            rec = np.frombuffer(fh.read(n_vert * 15), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            verts = rec["xyz"].copy()
            colors = rec["rgb"].astype(np.float32) / 255.0
        else:
            verts = np.frombuffer(fh.read(n_vert * 12), dtype=np.float32).reshape(-1, 3).copy()
            colors = None
        frec = np.frombuffer(fh.read(n_face * 13), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        faces = frec["idx"].astype(np.int64).copy()
    return Mesh(verts, faces, colors)



def save_image(path: str, img: np.ndarray) -> None:
    """Save a float [0, 1] image, (H, W, 3) or (H, W), as png or jpg.
    PIL is imported here, not with the module: a machine without it runs
    everything else."""
    from PIL import Image

    Image.fromarray(np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)).save(path)


def colorize_depth(depth: np.ndarray, max_depth: Optional[float] = None) -> np.ndarray:
    """A depth image on a turbo-like colour ramp in [0, 1]; no depth is black."""
    d = np.asarray(depth, np.float64)
    md = max_depth or max(float(d.max()), 1e-6)
    t = np.clip(d / md, 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t - 0.5), 0, 1)
    out = np.stack([r, g, b], -1)
    out[d <= 0] = 0
    return out
