"""GaussianSplatting (SplaTAM) scene model on the tile rasterizer.

Counterpart of ``xrdslam_tpu/models/gaussian_splatting.py``. The gaussian
cloud is a fixed-capacity table ``[max_gaussians, ...]`` of plain tensors
(``init_params``) with a count and a ``dead`` mask: growth and
densification append rows, pruning flips ``dead`` instead of compacting.
The count may be a host int or a device tensor (the group step keeps it on
the device), and every table operation here takes either. Both reference
rasterizer passes (rgb, then depth + silhouette + depth^2) are one
8-channel pass of ``ops.gaussian_raster.rasterize``. The losses are
sil-masked L1 sums for tracking, and 0.8 L1 + 0.2 (1 - SSIM) + mean depth
L1 for mapping.

Clone/split densification: ``render(..., duv=)`` adds a zero screen offset
whose gradient is the per-gaussian screen-space signal, and
``append_rows`` appends copies of chosen rows (a clone, or a split's
jittered, shrunk copies) at the count without a host sync.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import lie
from ..ops.gaussian_raster import N_CH, Binning, rasterize_binned
from .base import Model, ModelConfig

# the table's parameter groups, each with its own Adam in mapping
GAUSS_GROUPS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


@dataclass
class GaussianSplattingConfig(ModelConfig):
    _target: Type = field(default_factory=lambda: GaussianSplatting)
    max_gaussians: int = 131072
    k_per_tile: int = 256
    # tracking
    tracking_use_sil_for_loss: bool = True
    tracking_sil_thres: float = 0.99
    tracking_rgb_weight: float = 0.5
    tracking_depth_weight: float = 1.0
    # mapping
    mapping_rgb_weight: float = 0.5
    mapping_depth_weight: float = 1.0
    # pruning
    prune_big_fraction: float = 0.1  # of scene_radius
    # in-loop prune schedule, applied inside the mapping loop at these
    # iteration numbers
    mapping_pruning_dict: Dict[str, Any] = field(default_factory=lambda: dict(
        start_after=0,
        remove_big_after=0,
        stop_after=20,
        prune_every=20,
        removal_opacity_threshold=0.005,
        final_removal_opacity_threshold=0.005,
        reset_opacities=False,
        reset_opacities_every=500,
    ))
    # the clone/split densification schedule, in mapping iterations (the
    # reference's; it never fires within a 60-iteration mapping call)
    mapping_densify_dict: Dict[str, Any] = field(default_factory=lambda: dict(
        start_after=500,
        remove_big_after=3000,
        stop_after=5000,
        densify_every=100,
        grad_thresh=0.0002,
        num_to_split_into=2,
        removal_opacity_threshold=0.005,
        final_removal_opacity_threshold=0.005,
        reset_opacities_every=3000,
    ))


def ssim_window() -> torch.Tensor:
    """The 11x11 gaussian window (sigma 1.5) as a [1, 1, 11, 11] f32 tensor."""
    x = np.arange(11) - 5
    g = np.exp(-(x**2) / (2 * 1.5**2))
    return torch.from_numpy((np.outer(g, g) / g.sum() ** 2).astype(np.float32))[None, None]


def ssim(a: torch.Tensor, b: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [H, W, 3] images, 11x11 gaussian window, zero padding."""

    def filt(img):
        return F.conv2d(img.permute(2, 0, 1)[:, None], window, padding=5)[:, 0].permute(1, 2, 0)

    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a**2
    var_b = filt(b * b) - mu_b**2
    cov = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


class GaussianSplatting(Model):
    config: GaussianSplattingConfig

    def __init__(self, config: GaussianSplattingConfig, camera, bounding_box=None, **kwargs) -> None:
        super().__init__(config, camera, np.zeros((3, 2), np.float32) if bounding_box is None else bounding_box,
                         **kwargs)
        self.n_gauss = 0
        self.scene_radius = 1.0
        self._f = 0.5 * (camera.fx + camera.fy)
        self.register_buffer("ssim_window", ssim_window(), persistent=False)

    def init_params(self) -> Dict[str, torch.Tensor]:
        g = self.config.max_gaussians
        dev = self.ssim_window.device
        return {
            "means3D": torch.zeros((g, 3), device=dev),
            "rgb_colors": torch.zeros((g, 3), device=dev),
            "unnorm_rotations": torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(g, 1),
            "logit_opacities": torch.zeros((g, 1), device=dev),
            "log_scales": torch.full((g, 1), -10.0, device=dev),
        }

    def project(self, params: Dict[str, torch.Tensor], w2c: torch.Tensor):
        """Means -> (u, v, depth, sigma). OpenGL camera (-z forward)."""
        cam = self.camera
        pts = params["means3D"] @ w2c[:3, :3].T + w2c[:3, 3]
        depth = -pts[:, 2]
        inv = 1.0 / torch.clamp(depth, min=1e-6)
        u = cam.cx + cam.fx * pts[:, 0] * inv
        v = cam.cy - cam.fy * pts[:, 1] * inv
        sigma = torch.exp(params["log_scales"][:, 0]) * self._f * inv
        return u, v, depth, sigma

    def render(self, params: Dict[str, torch.Tensor], alive: torch.Tensor, w2c: torch.Tensor,
               binning, ntx: int, nty: int, duv: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Single-pass 8-channel rasterization -> rgb/depth/sil/depth_sq.
        ``binning``: a ``Binning`` (kept over several renders) or a (tile
        ids, tile mask) pair. ``duv`` [G, 2]: a zero screen offset whose
        gradient is each gaussian's screen-space gradient (densification's
        signal)."""
        cam = self.camera
        u, v, depth, sigma = self.project(params, w2c)
        if duv is not None:
            u = u + duv[:, 0]
            v = v + duv[:, 1]
        opacity = torch.sigmoid(params["logit_opacities"][:, 0]) * alive
        ch = torch.cat([
            params["rgb_colors"],
            depth[:, None],
            torch.ones_like(depth[:, None]),
            (depth * depth)[:, None],
            torch.zeros((depth.shape[0], N_CH - 6), dtype=depth.dtype, device=depth.device),
        ], -1)
        if not isinstance(binning, Binning):
            binning = Binning(*binning)
        img = rasterize_binned(u, v, sigma, opacity, ch, binning, ntx, nty)[: cam.height, : cam.width]
        return {"rgb": img[..., :3], "depth": img[..., 3], "sil": img[..., 4], "depth_sq": img[..., 5]}

    def get_loss(self, out: Dict[str, torch.Tensor], target_rgb: torch.Tensor, target_d: torch.Tensor,
                 is_mapping: bool) -> torch.Tensor:
        c = self.config
        depth = out["depth"]
        mask = (target_d > 0).float()
        if not is_mapping and c.tracking_use_sil_for_loss:
            mask = mask * (out["sil"] > c.tracking_sil_thres).float()
        mask = mask.detach()
        if not is_mapping:
            depth_loss = torch.sum(torch.abs(target_d - depth) * mask)
            rgb_loss = torch.sum(torch.abs(target_rgb - out["rgb"]) * mask[..., None])
            return c.tracking_depth_weight * depth_loss + c.tracking_rgb_weight * rgb_loss
        depth_loss = torch.sum(torch.abs(target_d - depth) * mask) / torch.clamp(torch.sum(mask), min=1.0)
        rgb_l1 = torch.mean(torch.abs(target_rgb - out["rgb"]))
        rgb_loss = 0.8 * rgb_l1 + 0.2 * (1.0 - ssim(out["rgb"], target_rgb, self.ssim_window))
        return c.mapping_depth_weight * depth_loss + c.mapping_rgb_weight * rgb_loss

    # ------------------------------------------------------------------
    # the table: liveness, pruning, appended rows
    # ------------------------------------------------------------------
    def alive_mask(self, dead: torch.Tensor, count) -> torch.Tensor:
        """Row liveness as float: allocated and not pruned."""
        idx = torch.arange(self.config.max_gaussians, device=dead.device)
        return ((idx < count) & ~dead).float()

    @torch.no_grad()
    def prune_step(self, params: Dict[str, torch.Tensor], dead: torch.Tensor, count, it: int):
        """Apply the prune schedule at mapping iteration ``it`` (a host int:
        the mapping loop is unrolled). Returns (dead, did_prune)."""
        d = self.config.mapping_pruning_dict
        if not (d["start_after"] <= it <= d["stop_after"] and it % max(d["prune_every"], 1) == 0):
            return dead, False
        thresh = d["final_removal_opacity_threshold"] if it == d["stop_after"] else d["removal_opacity_threshold"]
        low = torch.sigmoid(params["logit_opacities"][:, 0]) < thresh
        big = torch.exp(params["log_scales"][:, 0]) > self.config.prune_big_fraction * self.scene_radius
        remove = low | (big & (it >= d["remove_big_after"]))
        remove &= torch.arange(self.config.max_gaussians, device=dead.device) < count
        return dead | remove, True

    @staticmethod
    def reset_opacities_value() -> float:
        """inverse_sigmoid(0.01)."""
        return float(np.log(0.01 / 0.99))

    @torch.no_grad()
    def append_rows(self, params: Dict[str, torch.Tensor], dead: torch.Tensor, count: torch.Tensor,
                    mask: torch.Tensor, repeat: int = 1, scale_div: Optional[float] = None,
                    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """Append ``repeat`` copies of each row of ``mask`` [G] at rows
        [count, ...), in row order, as many as fit; gathers only, so the
        count stays on the device. A clone is ``repeat=1``; a split
        (``scale_div`` given) jitters each copy's position by its parent's
        scale times standard normal ``noise`` [G, 3] (drawn from
        ``generator`` when not given), rotated by the parent's quaternion,
        and divides its scale by ``scale_div``. Returns new (params, dead,
        count)."""
        G = self.config.max_gaussians
        idx = torch.arange(G, device=dead.device)
        n_new = torch.clamp(mask.sum() * repeat, max=G - count)
        # the source rows in order: the masked rows first
        srcs = torch.argsort(torch.where(mask, idx, G), stable=True)
        rel = idx - count
        src = srcs[torch.clamp(torch.div(rel, repeat, rounding_mode="floor"), 0, G - 1)]
        use = ((rel >= 0) & (rel < n_new))[:, None]
        new = {k: torch.where(use, params[k][src], params[k]) for k in GAUSS_GROUPS}
        if scale_div is not None:
            if noise is None:
                noise = torch.randn((G, 3), generator=generator, device=dead.device)
            scales = torch.exp(params["log_scales"][src, 0])
            quats = params["unnorm_rotations"][src]
            # normalized here and again inside, as the reference does
            quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True).clamp(min=1e-8)
            rot = lie.quaternion_to_matrix(quats)
            offset = torch.einsum("nij,nj->ni", rot, noise * scales[:, None])
            new["means3D"] = torch.where(use, new["means3D"] + offset, new["means3D"])
            new["log_scales"] = torch.where(use, new["log_scales"] - float(np.log(scale_div)), new["log_scales"])
        return new, torch.where(use[:, 0], False, dead), count + n_new
