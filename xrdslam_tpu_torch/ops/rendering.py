"""Co-SLAM's truncated-SDF volume rendering.

Counterpart of ``sdf2weights`` / ``raw2outputs_sdf`` in
``xrdslam_tpu/ops/rendering.py``. Inputs are [N_rays, N_samples(, C)].
"""
from __future__ import annotations

from typing import Tuple

import torch


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
