"""Mesher: field evaluation on a grid + marching-tetrahedra extraction.

Counterpart of ``xrdslam_tpu/common/mesher.py``: a uniform grid over
``marching_cubes_bound`` (``resolution`` cells along its longest side) is
evaluated through the model's ``query_fn`` in chunks of
``points_batch_size``, the zero level set is extracted on the host, and
vertex colors are queried through ``color_fn``; ``point_mask_fn`` masks
the grid (the keyframe-frustum mask).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Type

import numpy as np

from ..configs.base import InstantiateConfig
from ..ops.marching_tets import marching_tetrahedra
from ..utils.io import Mesh


@dataclass
class MesherConfig(InstantiateConfig):
    _target: Type = field(default_factory=lambda: Mesher)
    resolution: int = 256
    points_batch_size: int = 30000


class Mesher:
    def __init__(self, config: MesherConfig, camera, bounding_box, marching_cubes_bound, **kwargs) -> None:
        self.config = config
        self.camera = camera
        self.bound = np.asarray(marching_cubes_bound, np.float64)

    def grid_points(self):
        """Uniform grid; the longest dimension gets ``resolution`` cells."""
        b = self.bound
        extent = b[:, 1] - b[:, 0]
        vox = float(extent.max()) / self.config.resolution
        dims = np.maximum((extent / vox).astype(np.int64) + 1, 2)
        xs = [b[i, 0] + np.arange(dims[i]) * vox for i in range(3)]
        return xs, vox, dims

    def _batched(self, fn: Callable[[np.ndarray], np.ndarray], pts: np.ndarray, width: int) -> np.ndarray:
        bs = self.config.points_batch_size
        out = np.empty((pts.shape[0], width), np.float32)
        for i in range(0, pts.shape[0], bs):
            out[i:i + bs] = np.asarray(fn(pts[i:i + bs])).reshape(-1, width)
        return out

    def get_mesh(
        self,
        query_fn: Callable[[np.ndarray], np.ndarray],
        color_fn: Callable[[np.ndarray], np.ndarray],
        point_mask_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ) -> Optional[Mesh]:
        """query_fn maps [N,3] world points -> [N] sdf values, color_fn
        -> [N,3] colors; None when the grid holds no surface."""
        xs, vox, dims = self.grid_points()
        gx, gy, gz = np.meshgrid(xs[0], xs[1], xs[2], indexing="ij")
        pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
        volume = self._batched(query_fn, pts, 1).reshape(*dims)
        mask = None if point_mask_fn is None else np.asarray(point_mask_fn(pts)).reshape(*dims)
        verts, faces = marching_tetrahedra(volume, level=0.0, origin=(xs[0][0], xs[1][0], xs[2][0]),
                                           spacing=(vox, vox, vox), mask=mask)
        if verts.shape[0] == 0:
            return None
        return Mesh(verts, faces, self._batched(color_fn, verts, 3))
