"""Absolute trajectory error (ATE) evaluation — Horn alignment.

NumPy rebuild of the reference's evaluation path (reference:
scripts/utils/eval_ate.py:64-117 ``align``, :150-305 ``evaluate_ate``,
:308-339 ``convert_poses``): umeyama/Horn SVD alignment of estimated vs
ground-truth translations (optional similarity scale), then per-frame
translational RMSE. Poses with NaN/Inf entries are masked out exactly like
the reference (eval_ate.py:330-334).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, correct_scale: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """Align ``model`` (3,N) to ``data`` (3,N): find s, R, t minimizing
    ||s R model + t - data||.

    Returns (R [3,3], t [3,1], s).
    """
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    model_c = model - model_mean
    data_c = data - data_mean
    W = data_c @ model_c.T
    U, d, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if correct_scale:
        var_model = (model_c**2).sum()
        s = float((d * np.diag(S)).sum() / max(var_model, 1e-12))
    else:
        s = 1.0
    t = data_mean - s * (R @ model_mean)
    return R, t, s


def ate_rmse(gt_xyz: np.ndarray, est_xyz: np.ndarray, correct_scale: bool = False) -> Dict[str, float]:
    """ATE statistics between aligned trajectories. Inputs [N, 3]."""
    model = est_xyz.T
    data = gt_xyz.T
    R, t, s = horn_align(model, data, correct_scale)
    aligned = s * (R @ model) + t
    err = np.linalg.norm(aligned - data, axis=0)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "scale": s,
        # est->gt alignment, reused to pre-align the reconstructed mesh for
        # 3D metrics (reference: scripts/eval.py:59-66)
        "rot": R.tolist(),
        "trans": t.reshape(-1).tolist(),
    }


def convert_poses(c2w_list: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack pose translations, masking NaN/Inf poses. Returns (xyz [M,3], mask [N])."""
    mask = np.array([np.isfinite(p).all() for p in c2w_list])
    xyz = np.stack([p[:3, 3] for i, p in enumerate(c2w_list) if mask[i]]) if mask.any() else np.zeros((0, 3))
    return xyz, mask


def evaluate_ate(
    gt_c2w_list: List[np.ndarray], est_c2w_list: List[np.ndarray], correct_scale: bool = False
) -> Dict[str, float]:
    """End-to-end ATE between two c2w pose lists (meters)."""
    gt_xyz, gt_mask = convert_poses(gt_c2w_list)
    est_xyz, est_mask = convert_poses(est_c2w_list)
    mask = gt_mask & est_mask
    gt_xyz = np.stack([p[:3, 3] for i, p in enumerate(gt_c2w_list) if mask[i]])
    est_xyz = np.stack([p[:3, 3] for i, p in enumerate(est_c2w_list) if mask[i]])
    return ate_rmse(gt_xyz, est_xyz, correct_scale)
