"""SparseVoxel (Vox-Fusion) scene model: an SDF field on a voxel hash.

Counterpart of ``xrdslam_tpu/models/sparse_voxel.py``. Each allocated
voxel of ``ops/voxel_hash.py``'s map carries the ids of its 8 vertex
embeddings (rows of ``embeddings [num_embeddings, embed_dim]``, shared
between neighbouring voxels); a point's feature is their trilinear blend,
decoded by a ReLU MLP into an SDF and a colour.

Rendering is the reference's: ``coarse_steps`` membership probes at half
a voxel along each ray, the first ``max_voxel_hit`` distinct voxels hit,
an exact slab test on each, ``samples_per_voxel`` stratified samples at
fixed fractions of each hit segment (the model draws no random numbers),
sigmoid-product SDF weights with first-surface masking. Rays that hit no
voxel render 0 and leave the loss; their segments point at voxel 0.

``render_rays`` gathers each segment's 8 corner rows once, through one
``table_lookup`` of all ``N x K x 8`` ids, so the embeddings' gradient of
a render is one K4 launch (``ops/scatter.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch
from torch import nn

from ..common.camera import Camera
from ..ops import losses as losses_ops
from ..ops.scatter import table_lookup
from ..ops.voxel_hash import CORNERS, Maps, lookup_voxels
from .base import Model, ModelConfig


@dataclass
class SparseVoxelConfig(ModelConfig):
    """The reference's SparseVoxelConfig, less what nothing in the port
    reads (``voxels_each_dim``, ``max_distance``, ``step_size`` and the
    TPU's ``fast_scatter``)."""

    _target: Type = field(default_factory=lambda: SparseVoxel)
    voxel_size: float = 0.2
    num_embeddings: int = 20000
    embed_dim: int = 16
    max_voxels: int = 16384
    max_depth: float = 10.0
    # training weights (the reference's spelling)
    training_trunc: float = 0.05
    trainging_rgb_weight: float = 0.5
    trainging_depth_weight: float = 1.0
    trainging_sdf_weight: float = 5000.0
    trainging_fs_weight: float = 10.0
    # decoder
    depth: int = 2
    width: int = 128
    sdf_dim: int = 128
    # sampling
    max_voxel_hit: int = 20
    samples_per_voxel: int = 10
    coarse_steps: int = 96  # membership probes along each ray
    data_sc_factor: float = 1.0


def _linear(i: int, o: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """nn.Linear(i, o), weight and bias uniform in +-1/sqrt(i) (the
    reference's init) from ``generator``."""
    layer = nn.Linear(i, o)
    b = 1.0 / np.sqrt(i)
    with torch.no_grad():
        layer.weight.uniform_(-b, b, generator=generator)
        layer.bias.uniform_(-b, b, generator=generator)
    return layer


class SparseVoxel(Model):
    config: SparseVoxelConfig

    def __init__(self, config: SparseVoxelConfig, camera: Camera, bounding_box=None,
                 generator: Optional[torch.Generator] = None, **kwargs) -> None:
        super().__init__(config, camera, np.zeros((3, 2), np.float32) if bounding_box is None else bounding_box)
        c = config
        self.embeddings = nn.Parameter(torch.randn((c.num_embeddings, c.embed_dim), generator=generator) * 0.01)
        self.pts = nn.ModuleList([_linear(c.embed_dim, c.width, generator)]
                                 + [_linear(c.width, c.width, generator) for _ in range(c.depth - 1)])
        self.sdf_out = _linear(c.width, 1 + c.sdf_dim, generator)
        self.color0 = _linear(c.sdf_dim + c.embed_dim, c.width, generator)
        self.color1 = _linear(c.width, 3, generator)
        self.register_buffer("corners", torch.as_tensor(CORNERS, dtype=torch.float32), persistent=False)

    def decoder_params(self) -> List[torch.Tensor]:
        """The decoder's tensors in the reference's order: each layer's
        weight and bias (pts..., sdf_out, color0, color1)."""
        return [p for layer in (*self.pts, self.sdf_out, self.color0, self.color1) for p in (layer.weight, layer.bias)]

    def param_groups(self) -> Dict[str, List[torch.Tensor]]:
        return {"decoder": self.decoder_params(), "embeddings": [self.embeddings]}

    # ------------------------------------------------------------------
    def decode(self, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """emb [N, F] -> (rgb [N, 3], sdf [N])."""
        h = emb
        for layer in self.pts:
            h = torch.relu(layer(h))
        so = self.sdf_out(h)
        sdf, feat = so[:, 0], so[:, 1:]
        hc = torch.relu(self.color0(torch.cat([feat, emb], -1)))
        return torch.sigmoid(self.color1(hc)), sdf

    def _corner_weights(self, p: torch.Tensor) -> torch.Tensor:
        """Trilinear weights [..., 8] of positions ``p`` [..., 3] in the
        unit voxel (clamped to it), in ``CORNERS`` order."""
        p = torch.clamp(p, 0.0, 1.0)[..., None, :]
        q = self.corners
        f = p * q + (1.0 - p) * (1.0 - q)
        # the product written out: torch.prod's backward reads on the host
        # whether a factor is 0 (they are, at a clamped face), which a CUDA
        # graph cannot capture
        return f[..., 0] * f[..., 1] * f[..., 2]

    def interp_embeddings(self, maps: Maps, vox_idx: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """The trilinear blend [N, F] of voxel ``vox_idx`` [N]'s 8 vertex
        embeddings at world points ``pts`` [N, 3]."""
        vert_idx = maps["vox_vertex_idx"][vox_idx.long()]  # [N, 8]
        feats = table_lookup(self.embeddings, vert_idx)  # [N, 8, F]
        coords = maps["vox_coords"][vox_idx.long()].to(torch.float32)
        w = self._corner_weights(pts / self.config.voxel_size - coords)
        return torch.sum(feats * w[..., None], 1)

    # ------------------------------------------------------------------
    def intersect_and_sample(self, maps: Maps, rays_o: torch.Tensor, rays_d: torch.Tensor):
        """Voxel intersection and stratified per-segment sampling. Returns
        (z_vals [N, S], dt [N, S], vox_idx [N, S], sample_mask [N, S] f32,
        ray_mask [N] bool, seg_vox [N, K]: each segment's voxel, 0 where the
        segment is not valid)."""
        c = self.config
        n = rays_o.shape[0]
        dev = rays_o.device
        K, spv = c.max_voxel_hit, c.samples_per_voxel
        # 1. coarse membership probes along each ray
        t_coarse = (torch.arange(c.coarse_steps, dtype=torch.float32, device=dev) + 0.5) * (c.voxel_size * 0.5)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * t_coarse[None, :, None]
        cc = torch.floor(pts / c.voxel_size).to(torch.int32)
        vid = lookup_voxels(maps["hash_keys"], maps["hash_vals"], cc)  # [N, C]
        # 2. consecutive dedup; the first K fresh voxels in ray order
        prev = torch.cat([torch.full((n, 1), -2, dtype=vid.dtype, device=dev), vid[:, :-1]], 1)
        fresh = (vid >= 0) & (vid != prev)
        steps = torch.arange(c.coarse_steps, device=dev)[None, :]
        order = torch.where(fresh, steps, c.coarse_steps + 1)
        sel = torch.sort(order, dim=1, stable=True).indices[:, :K]
        hit_valid = torch.gather(fresh, 1, sel)
        hit_vox = torch.where(hit_valid, torch.gather(vid, 1, sel), 0)  # [N, K]
        # 3. exact slab test on the selected voxels
        centers = maps["vox_centers"][hit_vox.long()]  # [N, K, 3]
        half = 0.5 * c.voxel_size
        inv_d = 1.0 / torch.where(torch.abs(rays_d) < 1e-9, 1e-9, rays_d)
        t1 = (centers - half - rays_o[:, None, :]) * inv_d[:, None, :]
        t2 = (centers + half - rays_o[:, None, :]) * inv_d[:, None, :]
        t_near = torch.amax(torch.minimum(t1, t2), -1)
        t_far = torch.amin(torch.maximum(t1, t2), -1)
        seg_valid = hit_valid & (t_far > torch.clamp(t_near, min=0.0))
        t_near = torch.clamp(t_near, min=0.0)
        # 4. stratified samples at fixed fractions of each segment
        frac = (torch.arange(spv, dtype=torch.float32, device=dev) + 0.5) / spv
        seg_len = torch.clamp(t_far - t_near, min=0.0)
        z = t_near[..., None] + seg_len[..., None] * frac[None, None, :]  # [N, K, spv]
        dt = (seg_len / spv)[..., None].expand(z.shape)
        mask = seg_valid[..., None].expand(z.shape)
        vox = hit_vox[..., None].expand(n, K, spv)
        z, dt, mask, vox = (x.reshape(n, -1) for x in (z, dt, mask, vox))
        return (z, dt, torch.where(mask, vox, 0), mask.to(torch.float32), seg_valid.any(-1),
                torch.where(seg_valid, hit_vox, 0))

    # ------------------------------------------------------------------
    def render_rays(self, maps: Maps, rays_o: torch.Tensor, rays_d: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.config
        z, _, _, smask, ray_mask, seg_vox = self.intersect_and_sample(maps, rays_o, rays_d)
        n, s = z.shape
        K, spv = c.max_voxel_hit, c.samples_per_voxel
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        # the spv samples of a segment lie in one voxel: its 8 corner rows
        # are gathered once per segment, then blended per sample
        vert_idx = maps["vox_vertex_idx"][seg_vox.long()]  # [N, K, 8]
        feats = table_lookup(self.embeddings, vert_idx.reshape(-1)).reshape(n, K, 8, -1)
        coords = maps["vox_coords"][seg_vox.long()].to(torch.float32)
        w = self._corner_weights(pts.reshape(n, K, spv, 3) / c.voxel_size - coords[:, :, None, :])  # [N,K,spv,8]
        emb = torch.matmul(w, feats).reshape(n * s, -1)
        rgb, sdf = self.decode(emb)
        rgb = rgb.reshape(n, s, 3)
        sdf = sdf.reshape(n, s)
        weights = self.sdf2weights(sdf, z, smask)
        return {"rgb": torch.sum(weights[..., None] * rgb, -2), "depth": torch.sum(weights * z, -1), "sdf": sdf,
                "z_vals": z, "ray_mask": ray_mask, "sample_mask": smask, "weights": weights}

    def sdf2weights(self, sdf: torch.Tensor, z_vals: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
        """Sigmoid-product weights, cut behind the first sign change of the
        valid samples (``torch.argmax`` takes the first maximum, as JAX's)."""
        c = self.config
        w = torch.sigmoid(sdf / c.training_trunc) * torch.sigmoid(-sdf / c.training_trunc)
        signs = sdf[:, 1:] * sdf[:, :-1] * valid_mask[:, 1:] * valid_mask[:, :-1]
        mask_cross = (signs < 0.0).to(z_vals.dtype)
        inds = torch.argmax(mask_cross, 1)
        z_min = torch.gather(z_vals, 1, inds[:, None])
        mask = (z_vals < z_min + c.data_sc_factor * c.training_trunc).to(z_vals.dtype)
        w = w * mask * valid_mask
        return w / (torch.sum(w, -1, keepdim=True) + 1e-8)

    # ------------------------------------------------------------------
    def get_loss(self, maps: Maps, rays_o: torch.Tensor, rays_d: torch.Tensor, target_s: torch.Tensor,
                 target_d: torch.Tensor, extra_ray_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """L1 rgb and depth, l2 free-space and SDF losses over the rays that
        hit a voxel (and ``extra_ray_mask``)."""
        c = self.config
        out = self.render_rays(maps, rays_o, rays_d)
        rm = out["ray_mask"].to(torch.float32)
        if extra_ray_mask is not None:
            rm = rm * extra_ray_mask
        td = target_d[:, 0]
        vdm = ((td > 0.01) & (td < c.max_depth)).to(torch.float32) * rm
        n_valid = torch.clamp(torch.sum(rm), min=1.0)
        rgb_loss = torch.sum(torch.abs(out["rgb"] - target_s) * vdm[:, None]) / (n_valid * 3.0)
        depth_loss = torch.sum(torch.abs(out["depth"] - td) * vdm) / torch.clamp(torch.sum(vdm), min=1.0)
        fs_l, sdf_l = losses_ops.sdf_losses(out["z_vals"], target_d, out["sdf"], c.training_trunc * c.data_sc_factor,
                                            ray_mask=rm, sample_mask=out["sample_mask"])
        loss = (rgb_loss * c.trainging_rgb_weight + depth_loss * c.trainging_depth_weight
                + sdf_l * c.trainging_sdf_weight + fs_l * c.trainging_fs_weight)
        return loss, {"rgb": rgb_loss, "depth": depth_loss, "sdf": sdf_l, "fs": fs_l}
