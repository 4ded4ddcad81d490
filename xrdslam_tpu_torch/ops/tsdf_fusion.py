"""TSDF volume fusion: integration on the device, marching tetrahedra on the host.

Counterpart of ``xrdslam_tpu/ops/tsdf_fusion.py`` (Point-SLAM's mesh). A
dense TSDF and colour grid over a bounding box; each RGB-D frame projects
every voxel centre into the camera, reads the depth and colour of the
pixel it lands in, and folds the truncated SDF and the colour into running
means weighted by the number of frames that saw the voxel. The zero level
is extracted with ``ops.marching_tets`` over the voxels some frame saw,
each vertex coloured by its nearest voxel.

The voxel centres are the reference's, ``bound_lo + i * voxel_size`` in
float64 rounded to float32, but never held as one [N, 3] array: each axis
keeps its coordinates, and ``integrate`` builds and transforms the centres
``chunk`` voxels at a time (a volume of 256 x 171 x 213 voxels would
otherwise hold ~110 MB of centres and a second copy per frame in camera
coordinates). The camera-frame coordinates are each a sum of three
products and the translation, element by element.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common.camera import Camera
from ..utils.io import Mesh
from .marching_tets import marching_tetrahedra


class TSDFVolume:
    def __init__(self, bound: np.ndarray, voxel_size: float = 0.02, trunc: Optional[float] = None,
                 depth_max: float = 10.0, device="cpu", chunk: int = 1 << 21) -> None:
        self.bound = np.asarray(bound, np.float64)
        self.voxel_size = voxel_size
        self.trunc = trunc or 4.0 * voxel_size
        self.depth_max = depth_max
        self.device = torch.device(device)
        self.chunk = chunk
        extent = self.bound[:, 1] - self.bound[:, 0]
        self.dims = np.maximum((extent / voxel_size).astype(np.int64) + 1, 2)
        self._axes = [torch.as_tensor((self.bound[i, 0] + np.arange(self.dims[i]) * voxel_size).astype(np.float32),
                                      device=self.device) for i in range(3)]
        n = int(np.prod(self.dims))
        self.tsdf = torch.ones((n,), device=self.device)
        self.weight = torch.zeros((n,), device=self.device)
        self.color = torch.zeros((n, 3), device=self.device)

    @torch.no_grad()
    def integrate(self, rgb, depth, c2w: np.ndarray, camera: Camera) -> None:
        """One frame into the volume: ``rgb`` [H, W, 3], ``depth`` [H, W]
        (arrays or tensors) seen from ``c2w``."""
        w2c = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
        R = [[float(w2c[i, j]) for j in range(3)] for i in range(3)]
        t = [float(w2c[i, 3]) for i in range(3)]
        img_rgb = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        img_d = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        H, W = img_d.shape
        _, ny, nz = (int(d) for d in self.dims)
        n = self.tsdf.shape[0]
        for a in range(0, n, self.chunk):
            b = min(a + self.chunk, n)
            idx = torch.arange(a, b, device=self.device)
            p = (self._axes[0][idx // (ny * nz)], self._axes[1][(idx // nz) % ny], self._axes[2][idx % nz])
            x, y, z = (p[0] * R[i][0] + p[1] * R[i][1] + p[2] * R[i][2] + t[i] for i in range(3))
            z = -z
            zc = torch.clamp(z, min=1e-6)
            u = camera.cx + camera.fx * x / zc
            v = camera.cy - camera.fy * y / zc
            ui = torch.clamp(u.to(torch.int32), 0, W - 1).long()
            vi = torch.clamp(v.to(torch.int32), 0, H - 1).long()
            d = img_d[vi, ui]
            valid = (z > 0.01) & (u >= 0) & (u < W) & (v >= 0) & (v < H) & (d > 0) & (d < self.depth_max)
            sdf = (d - z) / self.trunc
            valid &= sdf > -1.0
            sdf = torch.clamp(sdf, -1.0, 1.0)
            w_new = valid.to(torch.float32)
            w_old = self.weight[a:b]
            w_tot = w_old + w_new
            den = torch.clamp(w_tot, min=1e-6)
            self.tsdf[a:b] = (self.tsdf[a:b] * w_old + sdf * w_new) / den
            self.color[a:b] = (self.color[a:b] * w_old[:, None] + img_rgb[vi, ui] * w_new[:, None]) / den[:, None]
            self.weight[a:b] = w_tot

    def extract_mesh(self) -> Optional[Mesh]:
        """The zero level over the voxels some frame saw, vertex colours
        from the nearest voxel; None when it is empty."""
        vol = self.tsdf.cpu().numpy().reshape(*self.dims)
        seen = self.weight.cpu().numpy().reshape(*self.dims) > 0
        verts, faces = marching_tetrahedra(vol, 0.0, origin=tuple(self.bound[:, 0]),
                                           spacing=(self.voxel_size,) * 3, mask=seen)
        if len(verts) == 0:
            return None
        idx = np.clip(((verts - self.bound[:, 0]) / self.voxel_size).astype(np.int64), 0, self.dims - 1)
        flat = (idx[:, 0] * self.dims[1] + idx[:, 1]) * self.dims[2] + idx[:, 2]
        return Mesh(verts, faces, self.color.cpu().numpy()[flat])
