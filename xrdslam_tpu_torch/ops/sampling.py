"""Ray generation and depth-sample utilities.

Counterpart of the parts of ``xrdslam_tpu/ops/sampling.py`` that Co-SLAM
uses. Every random draw takes a ``torch.Generator``; the draws that decide
a result can also be passed in pre-drawn, so that a test can feed the same
noise to both packages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..common.camera import Camera


def camera_ray_dirs(camera: Camera, device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-pixel camera-frame ray directions [H, W, 3], OpenGL convention
    (x right, y up, -z forward)."""
    i = torch.arange(camera.width, dtype=torch.float32, device=device)[None, :]  # x / columns
    j = torch.arange(camera.height, dtype=torch.float32, device=device)[:, None]  # y / rows
    x = ((i - camera.cx) / camera.fx).expand(camera.height, camera.width)
    y = (-(j - camera.cy) / camera.fy).expand(camera.height, camera.width)
    return torch.stack([x, y, -torch.ones_like(x)], -1)


def sample_pixels(n: int, height: int, width: int, h_edge: int = 0, w_edge: int = 0,
                  generator: Optional[torch.Generator] = None, device: Optional[torch.device] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n pixel coords (u=col, v=row) drawn uniformly, with replacement, from
    the interior region. Returns int64 tensors."""
    u = torch.randint(w_edge, width - w_edge, (n,), generator=generator, device=device)
    v = torch.randint(h_edge, height - h_edge, (n,), generator=generator, device=device)
    return u, v


def stratified_perturb(z_vals: torch.Tensor, generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Jitter z samples uniformly within their stratified bins; ``t`` is the
    U(0,1) draw of z_vals' shape (drawn from ``generator`` when omitted)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    if t is None:
        t = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype, device=z_vals.device)
    return lower + (upper - lower) * t


def coslam_z_vals(target_d: torch.Tensor, n_rays: int, near: float, far: float, n_samples_d: int,
                  range_d: float, n_range_d: int, perturb: bool,
                  generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Depth-guided z sampling: ``n_range_d`` samples in [d - range_d,
    d + range_d] around the measured depth (uniform [near, far] where the
    depth is invalid) plus ``n_samples_d`` uniform samples over [near, far],
    merged and sorted, then optionally jittered (``noise`` is the jitter's
    U(0,1) draw).

    Args:
        target_d: [N, 1] measured depths (<=0 marks invalid).
    Returns:
        [N, n_samples_d + n_range_d] z values.
    """
    dev = target_d.device
    lin_range = torch.linspace(-range_d, range_d, n_range_d, dtype=torch.float32, device=dev)
    z_samples = lin_range[None, :] + target_d  # [N, n_range_d]
    fallback = torch.linspace(near, far, n_range_d, dtype=torch.float32, device=dev).expand(n_rays, n_range_d)
    valid = (target_d[:, 0] > 0.0)[:, None]
    z_samples = torch.where(valid, z_samples, fallback)
    if n_samples_d > 0:
        z_uniform = torch.linspace(near, far, n_samples_d, dtype=torch.float32, device=dev).expand(n_rays, n_samples_d)
        z_vals = torch.sort(torch.cat([z_uniform, z_samples], -1), dim=-1).values
    else:
        z_vals = z_samples
    if perturb:
        z_vals = stratified_perturb(z_vals, generator, noise)
    return z_vals
