"""Volume rendering: Co-SLAM's truncated SDF and NICE-SLAM's occupancy.

Counterpart of ``sdf2weights`` / ``raw2outputs_sdf`` /
``raw2outputs_occupancy`` in ``xrdslam_tpu/ops/rendering.py``. Inputs are
[N_rays, N_samples(, C)].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def sdf2weights(sdf: torch.Tensor, z_vals: torch.Tensor, truncation: float, sc_factor: float = 1.0) -> torch.Tensor:
    """w_i = sigmoid(sdf/tr) * sigmoid(-sdf/tr), masked to samples in front
    of the first zero crossing (+ truncation band), renormalized.

    ``torch.sigmoid``, never 1/(1+exp(-x)): the naive form's backward is
    inf/inf^2 = NaN for |x| > ~88. ``torch.argmax`` returns the first
    maximum, so it picks the first sign change like the reference (0 when
    there is none).
    """
    weights = torch.sigmoid(sdf / truncation) * torch.sigmoid(-sdf / truncation)
    signs = sdf[:, 1:] * sdf[:, :-1]
    mask_cross = (signs < 0.0).to(z_vals.dtype)  # [N, S-1]
    inds = torch.argmax(mask_cross, dim=1)
    z_min = torch.gather(z_vals, 1, inds[:, None])  # [N, 1]
    mask = (z_vals < z_min + sc_factor * truncation).to(z_vals.dtype)
    weights = weights * mask
    return weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-8)


def raw2outputs_sdf(raw: torch.Tensor, z_vals: torch.Tensor, truncation: float, sc_factor: float = 1.0,
                    white_bkgd: bool = False) -> Tuple[torch.Tensor, ...]:
    """Volume render from raw [N, S, 4] = (rgb logits, sdf).

    Returns (rgb_map [N,3], disp_map [N], acc_map [N], weights [N,S],
    depth_map [N], depth_var [N]).
    """
    rgb = torch.sigmoid(raw[..., :3])
    weights = sdf2weights(raw[..., 3], z_vals, truncation, sc_factor)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    depth_var = torch.sum(weights * torch.square(z_vals - depth_map[..., None]), dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map, depth_var


def raw2outputs_occupancy(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: Optional[torch.Tensor] = None,
                          occupancy: bool = True, coef: float = 10.0) -> Tuple[torch.Tensor, ...]:
    """Occupancy alpha compositing from raw [N, S, 4] = (rgb in [0, 1], occ).

    alpha = sigmoid(coef * occ) in occupancy mode, else 1 - exp(-relu(occ)
    * delta) with the sample spacing delta scaled by |rays_d|. The
    transmittance is formed in log space, exp(cumsum(log(1 - alpha))):
    cumprod's backward divides by the product, which underflows to 0 on
    saturated rays. In occupancy mode log(1 - alpha) is -softplus(coef *
    occ) exactly, whose backward stays bounded where alpha rounds to 1 in
    fp32 (the generic log(1 - alpha + 1e-10) backward reaches 1e10 there).

    Returns (depth [N], depth_var [N], rgb [N, 3], weights [N, S]).
    """
    if occupancy:
        u = coef * raw[..., 3]
        alpha = torch.sigmoid(u)
        log_t = -F.softplus(u)
    else:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
        if rays_d is not None:
            dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-torch.maximum(raw[..., 3], torch.zeros_like(raw[..., 3])) * dists)
        log_t = torch.log(1.0 - alpha + 1e-10)
    zeros = torch.zeros_like(log_t[..., :1])
    transmittance = torch.exp(torch.cat([zeros, torch.cumsum(log_t, -1)[..., :-1]], -1))
    weights = alpha * transmittance
    rgb_map = torch.sum(weights[..., None] * raw[..., :3], dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    depth_var = torch.sum(weights * torch.square(z_vals - depth_map[..., None]), dim=-1)
    return depth_map, depth_var, rgb_map, weights
