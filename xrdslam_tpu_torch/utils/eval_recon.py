"""3D reconstruction metrics: accuracy, completion and completion ratio.

Counterpart of the protocol's part of ``xrdslam_tpu/utils/eval_recon.py``
(NumPy + SciPy): area-weighted surface samples of both meshes, a
point-to-point ICP alignment, and nearest-neighbour distances both ways
through ``cKDTree``. The unseen-view depth-L1 (``calc_2d_metric``) needs
the mesh rasterizer and is not ported yet.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree

from .io import Mesh


def sample_mesh_points(mesh: Mesh, n: int, seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface sampling."""
    rng = np.random.RandomState(seed)
    v, f = mesh.vertices, mesh.faces
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0 or len(f) == 0:
        return v[rng.randint(0, max(len(v), 1), n)]
    tri = rng.choice(len(f), n, p=areas / total)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri]


def icp_align(src: np.ndarray, dst: np.ndarray, iters: int = 20, subsample: int = 20000, seed: int = 0) -> np.ndarray:
    """Point-to-point ICP: the 4x4 transform aligning src to dst."""
    rng = np.random.RandomState(seed)
    T = np.eye(4)
    tree = cKDTree(dst)
    cur = src.copy()
    for _ in range(iters):
        s = cur[rng.randint(0, len(cur), min(subsample, len(cur)))]
        d = dst[tree.query(s, k=1)[1]]
        sc, dc = s.mean(0), d.mean(0)
        U, _, Vt = np.linalg.svd((d - dc).T @ (s - sc))
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        t = dc - R @ sc
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        cur = cur @ R.T + t
        T = step @ T
    return T


def calc_3d_metric(
    rec_mesh: Mesh,
    gt_mesh: Mesh,
    n_points: int = 200000,
    comp_thresh: float = 0.05,
    f1_thresh: float = 0.01,
    align: bool = True,
) -> Dict[str, float]:
    """Accuracy / completion / completion ratio (+ P/R/F1 at ``f1_thresh``)
    of ``n_points`` samples of each mesh. Distances in meters; accuracy and
    completion in cm, ratios in %."""
    rec_pts = sample_mesh_points(rec_mesh, n_points, seed=0)
    gt_pts = sample_mesh_points(gt_mesh, n_points, seed=1)
    if align:
        T = icp_align(rec_pts, gt_pts)
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]
    d_rec_to_gt = cKDTree(gt_pts).query(rec_pts, k=1)[0]  # accuracy
    d_gt_to_rec = cKDTree(rec_pts).query(gt_pts, k=1)[0]  # completion
    precision = float((d_rec_to_gt < f1_thresh).mean() * 100)
    recall = float((d_gt_to_rec < f1_thresh).mean() * 100)
    return {
        "accuracy_cm": float(d_rec_to_gt.mean() * 100),
        "completion_cm": float(d_gt_to_rec.mean() * 100),
        "completion_ratio_pct": float((d_gt_to_rec < comp_thresh).mean() * 100),
        "precision_pct": precision,
        "recall_pct": recall,
        "f1_pct": float(2 * precision * recall / max(precision + recall, 1e-9)),
    }
