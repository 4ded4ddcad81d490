"""Reconstruction metrics: accuracy / completion / completion ratio, the
Tanks and Temples precision / recall / F-score, and the unseen-view depth-L1.

Counterpart of ``xrdslam_tpu/utils/eval_recon.py`` (NumPy + SciPy):
area-weighted surface samples of both meshes, a point-to-point ICP
alignment, and nearest-neighbour distances both ways through ``cKDTree``.
``calc_2d_metric`` renders both meshes from random views with the tile
mesh rasterizer (``ops/mesh_raster.py``) on the device it is given.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

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


def _viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The reference's view matrix: columns [x, y, z, pos], z the forward
    direction."""
    vec2 = z / np.linalg.norm(z)
    vec0 = np.cross(up, vec2)
    vec0 /= np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    vec1 /= np.linalg.norm(vec1)
    m = np.eye(4)
    m[:3, :3] = np.stack([vec0, vec1, vec2], 1)
    m[:3, 3] = pos
    return m


def _pca_oriented_bounds(points: np.ndarray):
    """PCA-axis oriented bounding box: (to_origin 4x4, extents [3]); for
    room-shaped scenes near the minimal-volume box of trimesh's
    ``oriented_bounds``."""
    c = points.mean(0)
    _, vecs = np.linalg.eigh(np.cov((points - c).T))
    R = vecs[:, ::-1].T  # rows = axes, major first
    if np.linalg.det(R) < 0:
        R[2] *= -1
    local = (points - c) @ R.T
    lo, hi = local.min(0), local.max(0)
    to_origin = np.eye(4)
    to_origin[:3, :3] = R
    to_origin[:3, 3] = -(R @ c + (lo + hi) / 2)
    return to_origin, hi - lo


def calc_2d_metric(
    rec_mesh: Mesh,
    gt_mesh: Mesh,
    n_imgs: int = 1000,
    align: bool = True,
    pc_unseen: Optional[np.ndarray] = None,
    seed: int = 0,
    height: int = 500,
    width: int = 500,
    focal: float = 300.0,
    device="cuda",
) -> Dict[str, float]:
    """Unseen-view depth-L1 in cm, the reference's protocol: ``n_imgs``
    random cameras inside the ground-truth mesh's oriented bounding box
    (extents scaled [0.3, 0.7, 0.7], origin lifted 0.4 m, up = -z, a random
    look-at), a view rejected while it sees any ``pc_unseen`` point (100
    tries), 500x500 depth at f = 300 of both meshes rendered on ``device``,
    and the mean |gt - rec| where the reconstruction has surface.

    Besides ``depth_l1_cm``: ``views`` (the views rendered) and
    ``render_s_per_view`` (the host's wall time of a view's two renders,
    the device's work included)."""
    from ..ops.mesh_raster import mesh_tensors, render_depth

    rng = np.random.RandomState(seed)
    if align:
        T = icp_align(sample_mesh_points(rec_mesh, 50000, seed=0), sample_mesh_points(gt_mesh, 50000, seed=1))
        rec_mesh = Mesh(rec_mesh.vertices @ T[:3, :3].T + T[:3, 3], rec_mesh.faces, rec_mesh.vertex_colors)

    to_origin, extents = _pca_oriented_bounds(gt_mesh.vertices)
    extents = extents * np.array([0.3, 0.7, 0.7])
    transform = np.linalg.inv(to_origin).copy()
    transform[2, 3] += 0.4

    import torch

    dev = torch.device(device)
    gt_t, rec_t = mesh_tensors(gt_mesh, dev), mesh_tensors(rec_mesh, dev)
    cx, cy = width / 2.0 - 0.5, height / 2.0 - 0.5
    n_contaminated = 0
    errors = []
    t_render, n_views = 0.0, 0
    for _ in range(n_imgs):
        ok_view = False
        for _try in range(100):
            local = (rng.rand(3) - 0.5) * extents
            origin = transform[:3, :3] @ local + transform[:3, 3]
            target = rng.uniform(-10000, 10000, 3) - origin
            c2w = _viewmatrix(target, np.array([0.0, 0.0, -1.0]), origin)
            # the z-forward view matrix in this package's z-backward
            # convention (the reference flips columns 1 and 2 the same way)
            c2w_pkg = c2w.copy()
            c2w_pkg[:3, 1] *= -1.0
            c2w_pkg[:3, 2] *= -1.0
            if pc_unseen is None or len(pc_unseen) == 0:
                ok_view = True
                break
            w2c = np.linalg.inv(c2w_pkg)
            pc = pc_unseen @ w2c[:3, :3].T + w2c[:3, 3]
            z = -pc[:, 2]
            u = cx + focal * pc[:, 0] / np.maximum(z, 1e-6)
            v = cy - focal * pc[:, 1] / np.maximum(z, 1e-6)
            if not ((z > 0) & (u > 0) & (u < width) & (v > 0) & (v < height)).any():
                ok_view = True
                break
        if not ok_view:
            # the protocol rejects views that see unseen points: keeping one
            # would count legitimately unobserved regions against the run
            n_contaminated += 1
            continue
        t0 = time.perf_counter()
        gt_depth = render_depth(*gt_t, c2w_pkg, focal, focal, cx, cy, height, width)
        rec_depth = render_depth(*rec_t, c2w_pkg, focal, focal, cx, cy, height, width)
        t_render += time.perf_counter() - t0
        n_views += 1
        valid = rec_depth > 0
        if valid.sum() > 0:
            errors.append(np.abs(gt_depth[valid] - rec_depth[valid]).mean())
    if n_contaminated:
        print(f"[calc_2d_metric] skipped {n_contaminated}/{n_imgs} views (unseen-point rejection exhausted)")
    timing = {"views": n_views, "render_s_per_view": t_render / max(n_views, 1)}
    if not errors:
        return {"depth_l1_cm": float("nan"), **timing}
    return {"depth_l1_cm": float(np.mean(errors) * 100.0), **timing}


def evaluate_3d_reconstruction(
    rec_mesh: Mesh,
    gt_mesh: Mesh,
    distance_thresh: float = 0.01,
    align: bool = True,
    plot_stretch: int = 5,
    out_dir: Optional[str] = None,
    scene_name: str = "scene",
) -> Dict[str, object]:
    """The Tanks and Temples evaluation: ICP alignment, equal-density point
    sets (the denser mesh gives its vertices, the sparser one is sampled by
    area to the same count), nearest distances both ways, precision / recall
    / F at tau, cumulative histograms of bin width tau / 100 up to
    tau * plot_stretch, and distance statistics.

    With ``out_dir``, writes the reference's files:
    ``<scene>.precision.txt`` / ``<scene>.recall.txt`` (cumulative curves),
    ``<scene>.prf_tau_plotstr.txt``, the distance statistics' txt, and the
    error-coloured ``<scene>.precision.ply`` / ``<scene>.recall.ply``.
    """
    rec_v, gt_v = rec_mesh.vertices, gt_mesh.vertices
    if len(gt_v) < len(rec_v):
        rec_pts = rec_v
        gt_pts = sample_mesh_points(gt_mesh, len(rec_v), seed=1)
    else:
        gt_pts = gt_v
        rec_pts = sample_mesh_points(rec_mesh, len(gt_v), seed=0)
    T = np.eye(4)
    if align:
        T = icp_align(rec_pts, gt_pts)
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]
    d1 = cKDTree(gt_pts).query(rec_pts, k=1)[0]  # rec -> gt (precision)
    d2 = cKDTree(rec_pts).query(gt_pts, k=1)[0]  # gt -> rec (recall)

    tau = distance_thresh
    precision = float((d1 < tau).mean())
    recall = float((d2 < tau).mean())
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)
    bins = np.arange(0, tau * plot_stretch, tau / 100)
    h1, edges1 = np.histogram(d1, bins)
    cum1 = np.cumsum(h1).astype(float) / len(d1)
    h2, edges2 = np.histogram(d2, bins)
    cum2 = np.cumsum(h2).astype(float) / len(d2)
    stats = {"min1": float(d1.min()), "min2": float(d2.min()), "max1": float(d1.max()), "max2": float(d2.max()),
             "mean1": float(d1.mean()), "mean2": float(d2.mean()),
             "median1": float(np.median(d1)), "median2": float(np.median(d2)),
             "std1": float(d1.std()), "std2": float(d2.std())}
    out: Dict[str, object] = {"precision": precision, "recall": recall, "fscore": fscore,
                              "edges_source": edges1, "cum_source": cum1, "edges_target": edges2, "cum_target": cum2,
                              "dist_stats": stats, "transform": T}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)

        def path(suffix):
            return os.path.join(out_dir, f"{scene_name}.{suffix}")

        np.savetxt(path("precision.txt"), cum1)
        np.savetxt(path("recall.txt"), cum2)
        np.savetxt(path("prf_tau_plotstr.txt"), np.array([precision, recall, fscore, tau, plot_stretch]))
        np.savetxt(path("min12_max12_mean12_median12_std12.txt"),
                   np.array([stats[k] for k in ("min1", "min2", "max1", "max2", "mean1", "mean2", "median1",
                                                "median2", "std1", "std2")]))
        # error-coloured meshes (the toolbox's hsv ramp)
        rv = rec_mesh.vertices @ T[:3, :3].T + T[:3, 3]
        dv1 = cKDTree(gt_pts).query(rv, k=1)[0]
        Mesh(rv, rec_mesh.faces, _error_colors(dv1, 3 * tau)).export(path("precision.ply"))
        dv2 = cKDTree(rec_pts).query(gt_mesh.vertices, k=1)[0]
        Mesh(gt_mesh.vertices, gt_mesh.faces, _error_colors(dv2, 3 * tau)).export(path("recall.ply"))
    return out


def _error_colors(distances: np.ndarray, max_distance: float) -> np.ndarray:
    """The Tanks and Temples toolbox's HSV error ramp."""
    c = np.minimum(distances / max(max_distance, 1e-12), 0.85) + 0.33
    c = np.where(c > 1.0, c - 1.0, c)
    # matplotlib's 'hsv' colormap is the pure hue wheel at s = v = 1
    h = (c * 6.0) % 6.0
    x = 1.0 - np.abs(h % 2.0 - 1.0)
    z, o = np.zeros_like(h), np.ones_like(h)
    sector = np.stack([np.stack([o, x, z], -1), np.stack([x, o, z], -1), np.stack([z, o, x], -1),
                       np.stack([z, x, o], -1), np.stack([x, z, o], -1), np.stack([o, z, x], -1)])
    idx = np.clip(h.astype(np.int64), 0, 5)
    return sector[idx, np.arange(len(h))].astype(np.float32)
