"""NumPy Lie conversions for host-side bookkeeping.

Frame construction and pose prediction run on the host every frame. These
mirror ops.lie (same conventions, f64 internally for stability); this file
is a copy of the reference package's ``ops/lie_np.py``, carried because
importing that package loads its accelerator framework.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-12


def axis_angle_to_matrix(r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, np.float64)
    theta2 = float(r @ r)
    theta = np.sqrt(max(theta2, _EPS))
    K = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    KK = np.outer(r, r) - theta2 * np.eye(3)
    if theta2 < 1e-10:
        a, b = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0
    else:
        a, b = np.sin(theta) / theta, (1.0 - np.cos(theta)) / theta2
    return np.eye(3) + a * K + b * KK


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    choices = [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22]
    best = int(np.argmax(choices))
    s = 2.0 * np.sqrt(max(choices[best], _EPS))
    if best == 0:
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])
    elif best == 1:
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])
    elif best == 2:
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])
    else:
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / max(np.linalg.norm(q), _EPS)


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    q = q / max(np.linalg.norm(q), _EPS)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quaternion_to_axis_angle(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    if q[0] < 0:
        q = -q
    q = q / max(np.linalg.norm(q), _EPS)
    sin_half = np.linalg.norm(q[1:])
    half = np.arctan2(sin_half, q[0])
    if sin_half < 1e-9:
        scale = 2.0 + (2.0 / 3.0) * sin_half * sin_half
    else:
        scale = 2.0 * half / sin_half
    return q[1:] * scale


def matrix_to_pose_vec(M: np.ndarray, rot_rep: str = "axis_angle"):
    M = np.asarray(M, np.float64)
    t = M[:3, 3].copy()
    q = matrix_to_quaternion(M[:3, :3])
    if rot_rep == "quat":
        return t.astype(np.float32), q.astype(np.float32)
    if rot_rep == "axis_angle":
        return t.astype(np.float32), quaternion_to_axis_angle(q).astype(np.float32)
    raise ValueError(rot_rep)


def pose_vec_to_matrix(t: np.ndarray, r: np.ndarray, rot_rep: str = "axis_angle") -> np.ndarray:
    M = np.eye(4)
    if rot_rep == "axis_angle":
        M[:3, :3] = axis_angle_to_matrix(r)
    elif rot_rep == "quat":
        M[:3, :3] = quaternion_to_matrix(r)
    else:
        raise ValueError(rot_rep)
    M[:3, 3] = np.asarray(t, np.float64)
    return M.astype(np.float32)

def pose_matrix(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(t, quat w-first) -> 4x4 matrix."""
    M = np.eye(4)
    M[:3, :3] = quaternion_to_matrix(np.asarray(q, np.float64))
    M[:3, 3] = np.asarray(t, np.float64)
    return M


def pose_tq(M: np.ndarray):
    """4x4 matrix -> (t [3], quat [4] w-first), both float32."""
    M = np.asarray(M, np.float64)
    return (M[:3, 3].astype(np.float32),
            matrix_to_quaternion(M[:3, :3]).astype(np.float32))


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """se(3) tangent (v, w) [6] -> 4x4 matrix (Rodrigues + V-matrix)."""
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th**2
        C = (1 - A) / th**2
        R = np.eye(3) + A * K + B * (K @ K)
        V = np.eye(3) + B * K + C * (K @ K)
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = V @ v
    return M


def se3_log(M: np.ndarray) -> np.ndarray:
    """4x4 matrix -> se(3) tangent (v, w) [6]."""
    M = np.asarray(M, np.float64)
    R, t = M[:3, :3], M[:3, 3]
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-10:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        Vinv = np.eye(3)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        Vinv -= 0.5 * K
    else:
        w = th / (2 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        Vinv = (np.eye(3) - 0.5 * K +
                (1 - th * np.cos(th / 2) / (2 * np.sin(th / 2))) / th**2 *
                (K @ K))
    return np.concatenate([Vinv @ t, w])
