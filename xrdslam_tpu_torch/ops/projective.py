"""Projective patch operations of DPVO: inverse and forward projection of
patches between frames with SE(3) poses in (t, quat) form.

Counterpart of ``xrdslam_tpu/ops/projective.py``. Poses are
world-to-camera, ``t [3]`` and ``q [4]`` (w, x, y, z); the camera is a
pinhole with +z forward; a patch pixel is (u, v, inverse depth). Where the
reference maps a per-edge function over the edges, these functions
broadcast each edge's pose over its patch's pixels. They are plain torch
and differentiable, so that the bundle adjuster takes their Jacobians with
``torch.func.jacfwd``.
"""
from __future__ import annotations

import torch

from . import lie

_CONJ = (1.0, -1.0, -1.0, -1.0)


def iproj(patch_uvd: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(u, v, inv_depth) [..., 3] -> homogeneous (x, y, 1, inv_depth) [..., 4]."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    x = (patch_uvd[..., 0] - cx) / fx
    y = (patch_uvd[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x), patch_uvd[..., 2]], -1)


def proj(pts: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Homogeneous points [..., 4] -> pixels [..., 2]."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    z = torch.clamp(pts[..., 2], min=1e-4)
    return torch.stack([fx * (pts[..., 0] / z) + cx, fy * (pts[..., 1] / z) + cy], -1)


def se3_act(t: torch.Tensor, q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """X' = R X + W t on homogeneous points [..., 4]; ``t`` and ``q``
    broadcast against the points' leading dimensions."""
    w = pts[..., 3:4]
    return torch.cat([lie.quaternion_rotate(q, pts[..., :3]) + w * t, w], -1)


def se3_inv_act(t: torch.Tensor, q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The inverse of ``se3_act``: X' = R^T (X - W t)."""
    w = pts[..., 3:4]
    qc = q * q.new_tensor(_CONJ)
    return torch.cat([lie.quaternion_rotate(qc, pts[..., :3] - w * t), w], -1)


def _per_edge(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """An edge's [E, k] row broadcast over a patch of ``ndim`` dimensions
    (E first): [E, 1, ..., 1, k]."""
    return x.reshape(x.shape[0], *([1] * (ndim - 2)), x.shape[-1])


def reproject(poses_t: torch.Tensor, poses_q: torch.Tensor, patch_uvd: torch.Tensor, intrinsics: torch.Tensor,
              ii: torch.Tensor, jj: torch.Tensor, tonly: bool = False) -> torch.Tensor:
    """Patches [E, ..., 3] of frames ``ii`` reprojected into frames ``jj``:
    pixels [E, ..., 2]. X_j = T_j T_i^-1 X_i. ``tonly`` drops the relative
    rotation (flow_mag's translation-only flow)."""
    X = iproj(patch_uvd, intrinsics)
    nd = X.dim()
    ti, qi = _per_edge(poses_t[ii], nd), _per_edge(poses_q[ii], nd)
    tj, qj = _per_edge(poses_t[jj], nd), _per_edge(poses_q[jj], nd)
    if tonly:
        q_rel = lie.quaternion_multiply(qj, qi * qi.new_tensor(_CONJ))
        t_rel = tj - lie.quaternion_rotate(q_rel, ti)
        w = X[..., 3:4]
        return proj(torch.cat([X[..., :3] + w * t_rel, w], -1), intrinsics)
    return proj(se3_act(tj, qj, se3_inv_act(ti, qi, X)), intrinsics)


def point_cloud(poses_t: torch.Tensor, poses_q: torch.Tensor, patch_uvd: torch.Tensor, intrinsics: torch.Tensor,
                ii: torch.Tensor) -> torch.Tensor:
    """World-frame points [E, ..., 3] of patch pixels [E, ..., 3] of frames ``ii``."""
    X = iproj(patch_uvd, intrinsics)
    nd = X.dim()
    Xw = se3_inv_act(_per_edge(poses_t[ii], nd), _per_edge(poses_q[ii], nd), X)
    return Xw[..., :3] / torch.clamp(Xw[..., 3:4], min=1e-8)


def flow_mag(poses_t: torch.Tensor, poses_q: torch.Tensor, patch_uvd: torch.Tensor, intrinsics: torch.Tensor,
             ii: torch.Tensor, jj: torch.Tensor, beta: float = 0.5) -> torch.Tensor:
    """Per-edge flow magnitude [E]: ``beta`` of the full reprojection flow
    plus ``1 - beta`` of the translation-only flow, each from the patch's
    own pixels, averaged over the patch (DPVO's keyframe test)."""
    coords0 = patch_uvd[..., :2]
    flow1 = torch.linalg.norm(reproject(poses_t, poses_q, patch_uvd, intrinsics, ii, jj) - coords0, dim=-1)
    flow2 = torch.linalg.norm(reproject(poses_t, poses_q, patch_uvd, intrinsics, ii, jj, tonly=True) - coords0,
                              dim=-1)
    mag = beta * flow1 + (1.0 - beta) * flow2
    return mag.mean(dim=tuple(range(1, mag.dim())))
