"""Camera-frustum point tests (host NumPy).

Counterpart of ``xrdslam_tpu/ops/frustum.py``: a world point is observed
if it projects inside the image of at least one camera, within (near, far)
along the OpenGL -z axis.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..common.camera import Camera


def points_in_frustum(
    points: np.ndarray,
    c2w_list: Sequence[np.ndarray],
    camera: Camera,
    near: float = 0.0,
    far: float = 10.0,
    edge_margin: int = 0,
) -> np.ndarray:
    """[N,3] world points, K camera poses -> bool [N] (visible in any)."""
    pts = np.asarray(points, np.float64)
    out = np.zeros(len(pts), bool)
    for c2w in c2w_list:
        c2w = np.asarray(c2w, np.float64)
        pc = (pts - c2w[:3, 3]) @ c2w[:3, :3]  # world -> camera (R orthonormal)
        z = -pc[:, 2]  # OpenGL: the camera looks down -z
        valid = (z > near) & (z < far)
        with np.errstate(divide="ignore", invalid="ignore"):
            u = camera.fx * (pc[:, 0] / z) + camera.cx
            v = camera.fy * (-pc[:, 1] / z) + camera.cy
        valid &= (u >= edge_margin) & (u < camera.width - edge_margin)
        valid &= (v >= edge_margin) & (v < camera.height - edge_margin)
        out |= valid
        if out.all():
            break
    return out
