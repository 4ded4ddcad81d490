"""SDF / free-space / render losses with per-ray validity masks.

Counterpart of ``xrdslam_tpu/ops/losses.py``: the reference's loss math
with an optional per-ray mask (batches carry masked-out rays so that their
shapes stay fixed). With a full-ones mask the values equal the unmasked
means.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of x over elements where mask=1."""
    if mask is None:
        return torch.mean(x)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def sdf_masks(z_vals: torch.Tensor, target_d: torch.Tensor, truncation: float,
              ray_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """(front_mask [N,S], sdf_mask [N,S], fs_weight, sdf_weight) for z_vals
    [N, S], target_d [N, 1] and an optional 0/1 ray_mask [N]."""
    front_mask = (z_vals < (target_d - truncation)).to(z_vals.dtype)
    back_mask = (z_vals > (target_d + truncation)).to(z_vals.dtype)
    depth_mask = (target_d > 0.0).to(z_vals.dtype)
    sdf_mask = (1.0 - front_mask) * (1.0 - back_mask) * depth_mask
    if ray_mask is not None:
        front_mask = front_mask * ray_mask[:, None]
        sdf_mask = sdf_mask * ray_mask[:, None]
    num_fs = torch.sum(front_mask)
    num_sdf = torch.sum(sdf_mask)
    num = torch.clamp(num_fs + num_sdf, min=1.0)
    return front_mask, sdf_mask, 1.0 - num_fs / num, 1.0 - num_sdf / num


def sdf_losses(z_vals: torch.Tensor, target_d: torch.Tensor, predicted_sdf: torch.Tensor, truncation: float,
               ray_mask: Optional[torch.Tensor] = None, sample_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fs_loss, sdf_loss), l2, divided by (#valid rays * S). ``sample_mask``
    [N, S] also drops padded samples (Vox-Fusion's samples outside every
    voxel); the weights are formed before it, as the reference's."""
    front_mask, sdf_mask, fs_weight, sdf_weight = sdf_masks(z_vals, target_d, truncation, ray_mask)
    if sample_mask is not None:
        front_mask = front_mask * sample_mask
        sdf_mask = sdf_mask * sample_mask
    n, s = z_vals.shape
    if ray_mask is None:
        denom = z_vals.new_full((), float(n * s))
    else:
        denom = torch.clamp(torch.sum(ray_mask) * s, min=1.0)
    fs_loss = torch.sum(front_mask * (predicted_sdf - 1.0) ** 2) / denom * fs_weight
    sdf_loss = torch.sum(sdf_mask * (z_vals + predicted_sdf * truncation - target_d) ** 2) / denom * sdf_weight
    return fs_loss, sdf_loss


def rgb_depth_losses(rgb: torch.Tensor, depth: torch.Tensor, target_rgb: torch.Tensor, target_d: torch.Tensor,
                     depth_trunc: float = 100.0, rgb_missing: float = 0.05,
                     ray_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb_loss, depth_loss): rgb pixels without valid depth are weighted by
    ``rgb_missing``; the depth loss runs over valid-depth pixels only."""
    td = target_d[:, 0]
    valid_depth = ((td > 0.0) & (td < depth_trunc)).to(rgb.dtype)
    rgb_w = torch.where(valid_depth[:, None] > 0, 1.0, rgb_missing)
    rm = torch.ones_like(td) if ray_mask is None else ray_mask
    n_valid_rays = torch.clamp(torch.sum(rm), min=1.0)
    rgb_loss = torch.sum(((rgb - target_rgb) * rgb_w) ** 2 * rm[:, None]) / (n_valid_rays * 3.0)
    dmask = valid_depth * rm
    depth_loss = torch.sum((depth - td) ** 2 * dmask) / torch.clamp(torch.sum(dmask), min=1.0)
    return rgb_loss, depth_loss


def smoothness_tv(sdf_grid: torch.Tensor, sample_points: int) -> torch.Tensor:
    """Total-variation smoothness over a [G,G,G,C] feature sample grid."""
    tv_x = torch.sum(torch.square(sdf_grid[1:, ...] - sdf_grid[:-1, ...]))
    tv_y = torch.sum(torch.square(sdf_grid[:, 1:, ...] - sdf_grid[:, :-1, ...]))
    tv_z = torch.sum(torch.square(sdf_grid[:, :, 1:, ...] - sdf_grid[:, :, :-1, ...]))
    return (tv_x + tv_y + tv_z) / (sample_points**3)
