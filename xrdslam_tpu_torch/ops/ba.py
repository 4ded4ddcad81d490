"""Gauss-Newton bundle adjustment of DPVO's poses and patch depths.

Counterpart of ``xrdslam_tpu/ops/ba.py``. Each edge's residual Jacobians
come from forward-mode autodiff of its reprojection
(``torch.func.jacfwd`` under ``torch.func.vmap``); the blocks sum per pose
pair, pose and patch through ``scatter_add`` (K4 on the card, so that the
system, and with it the trajectory, is the same in every run of the same
inputs); each patch's inverse depth, a scalar block, is eliminated by a
Schur complement; and the reduced pose system is solved by a damped
Cholesky factorisation.

State: poses (t [N, 3], q [N, 4], world-to-camera), patch centres (u, v,
inv_depth) [M, 3], and edges (ii the patch's frame, jj the target frame,
kk the patch) with 2D targets and confidence weights.

A system whose factorisation fails gives no pose step: the reference's
solve returns NaN there and zeroes the non-finite step, and
``torch.linalg.cholesky_ex`` returns a partial factor with a nonzero
``info`` instead, so the step is zeroed where ``info`` is nonzero as well
as where it is not finite.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from . import lie, scatter
from .projective import iproj, proj, se3_act, se3_inv_act


def _edge_residual(xi_i: torch.Tensor, xi_j: torch.Tensor, invd: torch.Tensor, pose_i: torch.Tensor,
                   pose_j: torch.Tensor, patch: torch.Tensor, target: torch.Tensor,
                   intrinsics: torch.Tensor) -> torch.Tensor:
    """Edge residuals [B, 2] at the patch centres, with the poses perturbed
    on the left, T <- Exp(xi) T, and the centres' inverse depths ``invd``
    [B]; pose rows [B, 7] (t, q), patches [B, 3], targets [B, 2]."""
    dTi, dTj = lie.se3_exp(xi_i), lie.se3_exp(xi_j)
    Ri, Rj = lie.quaternion_to_matrix(pose_i[:, 3:]), lie.quaternion_to_matrix(pose_j[:, 3:])
    ti_new = (dTi[:, :3, :3] @ pose_i[:, :3, None])[..., 0] + dTi[:, :3, 3]
    tj_new = (dTj[:, :3, :3] @ pose_j[:, :3, None])[..., 0] + dTj[:, :3, 3]
    qi_new = lie.matrix_to_quaternion(dTi[:, :3, :3] @ Ri)
    qj_new = lie.matrix_to_quaternion(dTj[:, :3, :3] @ Rj)
    X = iproj(torch.stack([patch[:, 0], patch[:, 1], invd], -1), intrinsics)
    Xj = se3_act(tj_new, qj_new, se3_inv_act(ti_new, qi_new, X))
    return target - proj(Xj, intrinsics)


def linearize(pose_vec: torch.Tensor, patches: torch.Tensor, targets: torch.Tensor, ii: torch.Tensor,
              jj: torch.Tensor, kk: torch.Tensor, intrinsics: torch.Tensor):
    """Every edge's residual and Jacobians at the current state:
    (r [E, 2], Ji [E, 2, 6], Jj [E, 2, 6], Jd [E, 2]).

    ``vmap`` maps the edges, each a batch of one: on a 0-dim tensor,
    torch's forward mode gives a Python scalar's tangent the type float64,
    which the float32 products after it refuse."""
    E = ii.shape[0]
    pose_i, pose_j, patch = pose_vec[ii][:, None], pose_vec[jj][:, None], patches[kk][:, None]
    zeros = torch.zeros((E, 1, 6), dtype=patches.dtype, device=patches.device)
    args = (zeros, zeros, patch[..., 2], pose_i, pose_j, patch, targets[:, None])

    def one(xi_i, xi_j, invd, pi, pj, pt, tgt):
        return _edge_residual(xi_i, xi_j, invd, pi, pj, pt, tgt, intrinsics)[0]

    r = vmap(one)(*args)
    Ji, Jj, Jd = vmap(jacfwd(one, argnums=(0, 1, 2)))(*args)
    return r, Ji.reshape(E, 2, 6), Jj.reshape(E, 2, 6), Jd.reshape(E, 2)


def _solve(Hd: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """-Hd^-1 g by Cholesky; zero where the factorisation fails or the step
    is not finite."""
    L, info = torch.linalg.cholesky_ex(Hd)
    dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
    ok = (info == 0) & torch.isfinite(dx)
    return torch.where(ok, dx, torch.zeros_like(dx))


def bundle_adjust(poses_t: torch.Tensor, poses_q: torch.Tensor, patches: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor, kk: torch.Tensor,
                  intrinsics: torch.Tensor, t0: int, iterations: int = 2, lm: float = 1e-4, ep: float = 0.1,
                  edge_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint pose and inverse-depth Gauss-Newton.

    poses_t/q [N]: world-to-camera poses; patches [M, 3]; targets and
    weights [E, 2]; ii/jj/kk [E] int; poses before ``t0`` stay fixed.
    Returns the updated (poses_t, poses_q, patches). Each iteration sums
    its blocks in four ``scatter_add`` calls.
    """
    n, m, E = poses_t.shape[0], patches.shape[0], targets.shape[0]
    dev = patches.device
    w = weights if edge_mask is None else weights * edge_mask[:, None]
    ii32, jj32, kk32 = ii.to(torch.int32), jj.to(torch.int32), kk.to(torch.int32)
    # the flattened ids of the four sums: H's (i, i), (i, j), (j, i), (j, j)
    # blocks into n * n rows; g's i and j into n; C and gd into m; E's
    # (patch, i) and (patch, j) blocks into m * n
    h_ids = torch.cat([ii32 * n + ii32, ii32 * n + jj32, jj32 * n + ii32, jj32 * n + jj32])
    g_ids = torch.cat([ii32, jj32])
    ep_ids = torch.cat([kk32 * n + ii32, kk32 * n + jj32])
    free_i = (ii >= t0).to(patches.dtype)[:, None, None]
    free_j = (jj >= t0).to(patches.dtype)[:, None, None]
    pose_free = (torch.arange(n, device=dev) >= t0).to(patches.dtype)[:, None]
    damp = ep * torch.eye(6 * n, dtype=patches.dtype, device=dev)
    for _ in range(iterations):
        r, Ji, Jj, Jd = linearize(torch.cat([poses_t, poses_q], -1), patches, targets, ii, jj, kk, intrinsics)
        Ji, Jj = Ji * free_i, Jj * free_j
        wJi, wJj = Ji * w[:, :, None], Jj * w[:, :, None]
        Hii = wJi.transpose(1, 2) @ Ji
        Hij = wJi.transpose(1, 2) @ Jj
        Hjj = wJj.transpose(1, 2) @ Jj
        blocks = torch.cat([Hii, Hij, Hij.transpose(1, 2), Hjj]).reshape(4 * E, 36)
        H = scatter.scatter_add(h_ids, blocks, n * n).reshape(n, n, 6, 6)
        wr, wJd = w * r, w * Jd
        gi = (Ji * wr[:, :, None]).sum(1)
        gj = (Jj * wr[:, :, None]).sum(1)
        g = scatter.scatter_add(g_ids, torch.cat([gi, gj]), n)
        cg = scatter.scatter_add(kk32, torch.stack([(wJd * Jd).sum(1), (wJd * r).sum(1)], -1), m)
        C, gd = cg[:, 0] + lm + ep, cg[:, 1]
        Eid = (Ji * wJd[:, :, None]).sum(1)
        Ejd = (Jj * wJd[:, :, None]).sum(1)
        Ep = scatter.scatter_add(ep_ids, torch.cat([Eid, Ejd]), m * n).reshape(m, n * 6)
        EC = Ep / torch.clamp(C, min=1e-12)[:, None]
        # the Schur complement of the depth blocks: H -= E C^-1 E^T, g -= E C^-1 gd
        Hd = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n) - EC.t() @ Ep
        gr = g.reshape(-1) - EC.t() @ gd
        Hd = Hd + lm * torch.diag(torch.diagonal(Hd)) + damp
        dx = _solve(Hd, gr).reshape(n, 6) * pose_free

        # the poses: T <- Exp(dx) T
        dT = lie.se3_exp(dx)
        R_new = dT[:, :3, :3] @ lie.quaternion_to_matrix(poses_q)
        poses_t = (dT[:, :3, :3] @ poses_t[:, :, None])[:, :, 0] + dT[:, :3, 3]
        poses_q = lie.matrix_to_quaternion(R_new)
        # the depths, by back-substitution
        dd = -(gd + Ep @ dx.reshape(-1)) / torch.clamp(C, min=1e-12)
        dd = torch.where(torch.isfinite(dd), dd, torch.zeros_like(dd))
        patches = torch.cat([patches[:, :2], torch.clamp(patches[:, 2:] + dd[:, None], 1e-4, 10.0)], -1)
    return poses_t, poses_q, patches
