"""SO(3) and pose conversions on tensors, differentiable.

Counterpart of the parts of ``xrdslam_tpu/ops/lie.py`` that the ported
algorithms use: axis-angle and quaternion rotations, pose vectors to 4x4
matrices and rigid inverses, the device constant-velocity prediction
of Co-SLAM's and Vox-Fusion's fused steps, and the quaternion product,
rotation and SE(3) exponential of DPVO's projective ops and bundle
adjuster.
Small-angle neighbourhoods use Taylor expansions selected with
``torch.where``; the unselected branch is evaluated too, so every branch
keeps its argument away from 0 (``maximum(theta2, _EPS)``) and no NaN
reaches the gradient. Quaternions are ``(w, x, y, z)``, scalar first.
"""
from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8


def _sinc(theta2: torch.Tensor) -> torch.Tensor:
    """sin(t)/t as a function of t^2, Taylor-guarded near 0."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    return torch.where(theta2 < 1e-8, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)


def _cosc(theta2: torch.Tensor) -> torch.Tensor:
    """(1 - cos(t))/t^2 as a function of t^2, Taylor-guarded near 0."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    return torch.where(theta2 < 1e-8, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def _skew_squared(r: torch.Tensor) -> torch.Tensor:
    """K(r)^2 = r r^T - |r|^2 I, elementwise."""
    theta2 = torch.sum(r * r, dim=-1)
    outer = r[..., :, None] * r[..., None, :]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(outer.shape)
    return outer - theta2[..., None, None] * eye


def axis_angle_to_matrix(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(r * r, dim=-1)
    K = skew(r)
    KK = _skew_squared(r)
    a = _sinc(theta2)[..., None, None]
    b = _cosc(theta2)[..., None, None]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    return eye + a * K + b * KK


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w,x,y,z), w >= 0.

    Branch-free Shepperd's method: all four candidate quaternions, the one
    with the largest pivot selected per element.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    pw = 1.0 + tr
    px = 1.0 + m00 - m11 - m22
    py = 1.0 - m00 + m11 - m22
    pz = 1.0 - m00 - m11 + m22
    best = torch.argmax(torch.stack([pw, px, py, pz], -1), dim=-1)

    sw = torch.sqrt(torch.clamp(pw, min=_EPS)) * 2.0  # = 4w
    sx = torch.sqrt(torch.clamp(px, min=_EPS)) * 2.0  # = 4x
    sy = torch.sqrt(torch.clamp(py, min=_EPS)) * 2.0  # = 4y
    sz = torch.sqrt(torch.clamp(pz, min=_EPS)) * 2.0  # = 4z
    qs = torch.stack([
        torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
        torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1),
        torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1),
        torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1),
    ], -2)  # [..., 4 candidates, 4]
    q = torch.gather(qs, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    half = torch.atan2(sin_half, w)
    # theta/sin(theta/2), guarded near zero: -> 2 + theta^2/12 ...
    scale = torch.where(sin_half < 1e-6, 2.0 + (2.0 / 3.0) * sin_half * sin_half,
                        2.0 * half / torch.clamp(sin_half, min=_EPS))
    return xyz * scale[..., None]


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log map. [..., 3, 3] -> [..., 3]."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3]. Normalizes the input quaternion."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w,x,y,z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quaternion_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate points v [..., 3] by quaternion q [..., 4]."""
    xyz = q[..., 1:]
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + q[..., :1] * t + torch.linalg.cross(xyz, t, dim=-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent [..., 6] (v, w) -> [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, -1)
    K = skew(w)
    KK = _skew_squared(w)
    a = _sinc(theta2)[..., None, None]
    b = _cosc(theta2)[..., None, None]
    # c = (1 - sinc(t)) / t^2, Taylor: 1/6 - t^2/120
    c = torch.where(theta2 < 1e-8, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - _sinc(theta2)) / torch.clamp(theta2, min=_EPS))[..., None, None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + a * K + b * KK
    t = (eye + b * K + c * KK) @ v[..., :, None]
    return torch.cat([torch.cat([R, t], -1), _bottom_row(R)], -2)


def predict_constant_velocity(t1: torch.Tensor, r1: torch.Tensor, t2: torch.Tensor, r2: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The constant-velocity model on the device, from the last pose (t1,
    r1 axis-angle) and the one before it: delta = P1 inv(P2), pred = delta
    P1. Unlike the pipeline's host prediction it takes no SVD and no finite
    check, as the reference package's device programs."""
    R1 = axis_angle_to_matrix(r1)
    R2 = axis_angle_to_matrix(r2)
    dR = R1 @ R2.T
    dt = t1 - dR @ t2
    return dR @ t1 + dt, matrix_to_axis_angle(dR @ R1)


def pose_vec_to_matrix(t: torch.Tensor, r: torch.Tensor, rot_rep: str = "axis_angle") -> torch.Tensor:
    """(translation [..., 3], rotation [..., 3 | 4]) -> [..., 4, 4] c2w matrix."""
    if rot_rep == "axis_angle":
        R = axis_angle_to_matrix(r)
    elif rot_rep == "quat":
        R = quaternion_to_matrix(r)
    else:
        raise ValueError(f"unknown rot_rep {rot_rep}")
    return torch.cat([torch.cat([R, t[..., :, None]], -1), _bottom_row(R)], -2)


def pose_inverse(M: torch.Tensor) -> torch.Tensor:
    """Invert [..., 4, 4] rigid transforms."""
    Rt = M[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ M[..., :3, 3:4])
    return torch.cat([torch.cat([Rt, ti], -1), _bottom_row(Rt)], -2)


def _bottom_row(R: torch.Tensor) -> torch.Tensor:
    """[..., 1, 4] rows (0, 0, 0, 1) for a batch of [..., 3, 3] rotations."""
    row = torch.zeros((*R.shape[:-2], 1, 4), dtype=R.dtype, device=R.device)
    row[..., 0, 3].fill_(1.0)  # a fill on the device: no host copy, so a CUDA graph can capture it
    return row
