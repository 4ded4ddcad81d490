"""ConvONet (NICE-SLAM) scene model: hierarchical dense feature grids and MLPs.

Counterpart of ``xrdslam_tpu/models/conv_onet.py``: the 5-block skip MLP
decoders (``MLPDecoder``: with a Fourier embedding of the point, or the
coarse level's ``no_xyz`` form that sees only the feature), and
``ConvOnet``: 3-4 dense feature grids (coarse 2 m, middle 0.32, fine 0.16,
colour 0.16, C = 32) sampled trilinearly (``ops.trilinear.grid_sample_3d``,
K4 as their gradient on the card), decoded per stage and rendered with
occupancy alpha compositing (sigmoid(10 occ)).

  * Grids are ``[X, Y, Z, C]`` parameters over the mapping bound enlarged
    to a multiple of ``grid_bound_divisible``; the coarse grid covers that
    bound times ``model_coarse_bound_enlarge`` about the origin.
  * The pretrained decoders that the registry names are not in the
    repository, so the decoders train from scratch, as the reference
    package does without them: the middle and fine decoders (and the
    coarse one) join the colour decoder in the ``decoder`` group, and
    mapping adds near-surface occupancy supervision
    (``fallback_geo_supervision``). Loading such a checkpoint is not
    ported: a path that exists raises.
  * The reference's frustum feature selection is gradient masking: the
    algorithm multiplies each grid's gradient by ``frustum_grid_masks``
    (host, float64) or ``frustum_grid_masks_dev`` (device, float32).

``masked_median`` serves both this model and Point-SLAM's.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import lie
from ..ops.rendering import raw2outputs_occupancy
from ..ops.trilinear import grid_corners, grid_sample_3d, normalize_3d_coordinate
from .base import Model, ModelConfig


def _uniform_(w: torch.Tensor, a: float, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)


class MLPDecoder(nn.Module):
    """p [N, 3], c [N, c_dim] -> [N, 1] (occupancy) or [N, 4] (``color``).

    ``h = sin(p @ B)`` then ``n_blocks`` ReLU layers, each followed by
    ``+ fc_i(c)``, with the embedding concatenated back after each block in
    ``skips``. With ``no_xyz`` (NICE-SLAM's coarse decoder) the input and
    the embedding are ``c`` itself, and there is no ``B`` and no ``fc_i``.
    Weights are drawn as the reference draws them (Xavier with ReLU gain,
    zero biases, ``B ~ 25 N(0, 1)``, the output layer at 0.1x Xavier) from
    ``generator``; they are not the reference's numbers.
    """

    def __init__(self, c_dim: int, hidden: int = 32, n_blocks: int = 5, skips: Sequence[int] = (2,),
                 color: bool = False, emb: int = 93, generator: Optional[torch.Generator] = None,
                 no_xyz: bool = False) -> None:
        super().__init__()
        self.skips = tuple(skips)
        self.no_xyz = no_xyz
        if no_xyz:
            self.B = None
            emb = c_dim
        else:
            self.B = nn.Parameter(torch.randn((3, emb), generator=generator) * 25.0)
        dims = [emb if i == 0 else (hidden + emb if (i - 1) in self.skips else hidden) for i in range(n_blocks)]
        self.pts = nn.ModuleList(nn.Linear(d, hidden) for d in dims)
        self.fc = (nn.ModuleList(nn.Linear(c_dim, hidden) for _ in range(n_blocks))
                   if c_dim > 0 and not no_xyz else None)
        out_dim = 4 if color else 1
        self.out = nn.Linear(hidden, out_dim)
        gain = float(np.sqrt(2.0))
        for layer in [*self.pts, *(self.fc or [])]:
            _uniform_(layer.weight, gain * np.sqrt(6.0 / sum(layer.weight.shape)), generator)
            nn.init.zeros_(layer.bias)
        # 0.1x Xavier on the output layer: a full-scale head on random
        # decoders saturates the occupancy sigmoid at once
        _uniform_(self.out.weight, 0.1 * np.sqrt(6.0 / (hidden + out_dim)), generator)
        nn.init.zeros_(self.out.bias)

    def forward(self, p: Optional[torch.Tensor], c: torch.Tensor) -> torch.Tensor:
        emb = c if self.no_xyz else torch.sin(p @ self.B)
        h = emb
        for i, layer in enumerate(self.pts):
            h = F.relu(layer(h))
            if self.fc is not None:
                h = h + self.fc[i](c)
            if i in self.skips:
                h = torch.cat([emb, h], -1)
        return self.out(h)


@dataclass
class ConvOnetConfig(ModelConfig):
    """The reference's ConvOnetConfig, less what nothing in the port reads
    (``data_dim``, the decoders' width ``model_hidden_size`` and
    ``model_pos_embedding_method``, which the reference's decoders take at
    their defaults, ``points_batch_size``, and the sampling options the
    reference leaves off: ``rendering_n_importance``,
    ``rendering_lindisp``, ``rendering_perturb``). ``coarse`` is set by the
    algorithm from its own."""

    _target: Type = field(default_factory=lambda: ConvOnet)
    coarse: bool = False
    occupancy: bool = True
    pretrained_decoders_coarse: Optional[Path] = None
    pretrained_decoders_middle_fine: Optional[Path] = None
    model_c_dim: int = 32
    model_coarse_bound_enlarge: int = 2
    grid_len_coarse: float = 2.0
    grid_len_middle: float = 0.32
    grid_len_fine: float = 0.16
    grid_len_color: float = 0.16
    grid_bound_divisible: float = 0.32
    rendering_n_samples: int = 32
    rendering_n_surface: int = 16
    tracking_w_color_loss: float = 0.5
    mapping_w_color_loss: float = 0.2
    tracking_handle_dynamic: bool = True
    tracking_use_color_in_tracking: bool = True
    mapping_fix_fine: bool = True
    mapping_fix_color: bool = False
    mapping_frustum_feature_selection: bool = True
    # Without the pretrained decoders, mapping's render-only depth L1 has a
    # degenerate minimum (all occupancy carved, rays ending on the occ = 100
    # wall behind the bound); logits-BCE free-space and occupied targets
    # within +-geo_trunc of the measured depth hold a wall at the surface.
    # "auto": on when the pretrained decoders are not loaded.
    fallback_geo_supervision: str = "auto"  # "auto" | "on" | "off"
    geo_trunc: float = 0.10
    geo_w: float = 1.0


GRID_STDS = {"grid_middle": 0.01, "grid_fine": 0.0001, "grid_color": 0.01, "grid_coarse": 0.01}


class ConvOnet(Model):
    """The grids (``grids[name]``, [X, Y, Z, C]) and decoders
    (``decoders[name]`` for middle, fine, colour and coarse) as parameters;
    ``param_groups`` names them by optimizer group."""

    config: ConvOnetConfig

    def __init__(self, config: ConvOnetConfig, camera, bounding_box: np.ndarray,
                 generator: Optional[torch.Generator] = None, **kwargs) -> None:
        super().__init__(config, camera, bounding_box)
        c = config
        # the bound's upper ends moved out to a multiple of grid_bound_divisible
        bb = np.asarray(bounding_box, np.float64).copy()
        div = c.grid_bound_divisible
        bb[:, 1] = (((bb[:, 1] - bb[:, 0]) / div).astype(int) + 1) * div + bb[:, 0]
        self.bounding_box = bb.astype(np.float32)
        self.register_buffer("bound", torch.from_numpy(self.bounding_box.copy()), persistent=False)
        self.register_buffer("bound_coarse", torch.from_numpy(self.bounding_box * c.model_coarse_bound_enlarge),
                             persistent=False)
        xyz_len = self.bounding_box[:, 1] - self.bounding_box[:, 0]
        self.grid_shapes: Dict[str, Tuple[int, int, int]] = {
            "grid_middle": tuple(int(v) for v in xyz_len / c.grid_len_middle),
            "grid_fine": tuple(int(v) for v in xyz_len / c.grid_len_fine),
            "grid_color": tuple(int(v) for v in xyz_len / c.grid_len_color),
        }
        if c.coarse:
            self.grid_shapes["grid_coarse"] = tuple(
                int(v) for v in xyz_len * c.model_coarse_bound_enlarge / c.grid_len_coarse)
        # the grids' cell centres, as the frustum masks test them: float64 on
        # the host, rounded once to float32 for the device
        self._grid_pts_np = {name: self._cell_points(shape) for name, shape in self.grid_shapes.items()
                             if name != "grid_coarse"}
        for name, pts in self._grid_pts_np.items():
            self.register_buffer(f"_pts_{name}", torch.from_numpy(pts.astype(np.float32)), persistent=False)

        cd = c.model_c_dim
        decoders = {"middle": MLPDecoder(cd, generator=generator),
                    "fine": MLPDecoder(cd * 2, generator=generator),
                    "color": MLPDecoder(cd, color=True, generator=generator)}
        if c.coarse:
            decoders["coarse"] = MLPDecoder(cd, no_xyz=True, generator=generator)
        self.decoders = nn.ModuleDict(decoders)
        for path in (c.pretrained_decoders_middle_fine, c.pretrained_decoders_coarse if c.coarse else None):
            if path is not None and os.path.exists(path):
                raise NotImplementedError(f"loading the pretrained decoders ({path}) is not ported yet (ROADMAP "
                                          "Queue 1); without the file the decoders train from scratch")
        self.pretrained_available = False
        # without pretrained weights the middle and fine decoders must train
        trainable = [] if c.mapping_fix_color else ["color"]
        if not c.mapping_fix_fine or not self.pretrained_available:
            trainable += ["middle", "fine"] + (["coarse"] if c.coarse else [])
        self.trainable_decoders: List[str] = list(dict.fromkeys(trainable))
        for name, dec in self.decoders.items():
            dec.requires_grad_(name in self.trainable_decoders)
        self.geo_supervision = (c.fallback_geo_supervision == "on"
                                or (c.fallback_geo_supervision == "auto" and not self.pretrained_available))
        self.grids = nn.ParameterDict({
            name: nn.Parameter(torch.randn((*shape, cd), generator=generator) * GRID_STDS[name])
            for name, shape in self.grid_shapes.items()})

    def _cell_points(self, shape: Tuple[int, int, int]) -> np.ndarray:
        xs = [np.linspace(self.bounding_box[i, 0], self.bounding_box[i, 1], shape[i]) for i in range(3)]
        gx, gy, gz = np.meshgrid(*xs, indexing="ij")
        return np.stack([gx, gy, gz], -1).reshape(-1, 3)

    def param_groups(self) -> Dict[str, List[torch.Tensor]]:
        groups = {name: [self.grids[name]] for name in self.grid_shapes}  # ParameterDict sorts its keys
        groups["decoder"] = [p for name in sorted(self.trainable_decoders) for p in self.decoders[name].parameters()]
        return groups

    # ------------------------------------------------------------------
    def query_raw(self, pts: torch.Tensor, stage: str) -> torch.Tensor:
        """[..., 3] world points -> [..., 4] raw (rgb, occ) at ``stage``:
        coarse, middle, fine (middle + fine occupancy) or color. Points not
        strictly inside the bound take occupancy 100."""
        shape = pts.shape[:-1]
        p = pts.reshape(-1, 3)
        p_norm = normalize_3d_coordinate(p, self.bound)
        rgb = torch.zeros((p.shape[0], 3), dtype=pts.dtype, device=pts.device)
        corners: Dict[Tuple[int, int, int], tuple] = {}  # grids of one shape share their cells

        def feat(name: str) -> torch.Tensor:
            grid_shape = self.grid_shapes[name]
            if grid_shape not in corners:
                corners[grid_shape] = grid_corners(grid_shape, p_norm)
            return grid_sample_3d(self.grids[name], p_norm, corners[grid_shape])

        if stage == "coarse":
            pc = normalize_3d_coordinate(p, self.bound_coarse)
            occ = self.decoders["coarse"](None, grid_sample_3d(self.grids["grid_coarse"], pc))[..., 0]
        else:
            c_middle = feat("grid_middle")
            occ = self.decoders["middle"](p_norm, c_middle)[..., 0]
            if stage != "middle":
                # the middle feature enters the fine decoder as a constant
                cf = torch.cat([feat("grid_fine"), c_middle.detach()], -1)
                occ = self.decoders["fine"](p_norm, cf)[..., 0] + occ
                if stage == "color":
                    rgb = self.decoders["color"](p_norm, feat("grid_color"))[..., :3]
        inb = torch.all((p > self.bound[:, 0]) & (p < self.bound[:, 1]), -1)
        occ = torch.where(inb, occ, torch.full_like(occ, 100.0))
        return torch.cat([rgb, occ[:, None]], -1).reshape(*shape, 4)

    def _z_vals(self, rays_o: torch.Tensor, rays_d: torch.Tensor, gt_depth: Optional[torch.Tensor],
                use_surface: bool) -> torch.Tensor:
        """Uniform samples from near to the bound's exit (capped at 1.2x the
        batch's largest depth where the depth is used), plus
        ``rendering_n_surface`` samples in [0.95 d, 1.05 d] (for a ray
        without depth, up to the batch's largest), merged and sorted."""
        c = self.config
        n, dev = rays_o.shape[0], rays_o.device
        t_vals = torch.linspace(0.0, 1.0, c.rendering_n_samples, device=dev)
        t = (self.bound[None, :, :] - rays_o[:, :, None]) / rays_d[:, :, None]  # [N, 3, 2]
        far_bb = torch.amin(torch.amax(t, dim=2), dim=1)[:, None] + 0.01
        if gt_depth is None or not use_surface:
            return 0.01 * (1.0 - t_vals)[None, :] + far_bb * t_vals[None, :]
        gt = gt_depth.reshape(-1, 1)
        near = gt * 0.01
        far = torch.minimum(torch.clamp(far_bb, min=0.0), torch.clamp(torch.amax(gt * 1.2), min=0.01))
        z_vals = near * (1.0 - t_vals)[None, :] + far * t_vals[None, :]
        n_surf = c.rendering_n_surface
        if n_surf > 0:
            ts = torch.linspace(0.0, 1.0, n_surf, device=dev)
            z_surf_pos = 0.95 * gt * (1.0 - ts)[None, :] + 1.05 * gt * ts[None, :]
            far_surface = torch.clamp(torch.amax(gt), min=0.01)
            z_surf_zero = 0.001 * (1.0 - ts)[None, :] + far_surface * ts[None, :]
            z_surf = torch.where(gt > 0, z_surf_pos, z_surf_zero.expand(n, n_surf))
            z_vals = torch.sort(torch.cat([z_vals, z_surf], -1), dim=-1).values
        return z_vals

    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor, target_d: Optional[torch.Tensor],
                    stage: str = "color") -> Dict[str, torch.Tensor]:
        use_surface = stage != "coarse" and target_d is not None
        z_vals = self._z_vals(rays_o, rays_d, target_d, use_surface)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        raw = self.query_raw(pts, stage)
        depth, depth_var, rgb, weights = raw2outputs_occupancy(raw, z_vals, rays_d, occupancy=self.config.occupancy)
        return {"rgb": rgb, "depth": depth, "uncertainty": depth_var, "z_vals": z_vals, "weights": weights,
                "occ_raw": raw[..., 3]}

    def get_loss(self, rays_o: torch.Tensor, rays_d: torch.Tensor, target_s: torch.Tensor, target_d: torch.Tensor,
                 ray_mask: Optional[torch.Tensor], is_mapping: bool, stage: str
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Summed L1 losses. Tracking: the depth error over its rendered
        standard deviation and the colour error, on rays with depth whose
        weighted error is under 10x the median (``tracking_handle_dynamic``).
        Mapping: the depth L1 on rays with depth, the colour L1 in the colour
        stage, and with ``geo_supervision`` the near-surface occupancy BCE."""
        c = self.config
        out = self.render_rays(rays_o, rays_d, target_d if stage != "coarse" else None, stage)
        td = target_d[:, 0]
        depth, rgb = out["depth"], out["rgb"]
        unc = out["uncertainty"].detach()
        rm = ray_mask if ray_mask is not None else torch.ones_like(td)
        losses: Dict[str, torch.Tensor] = {}
        if not is_mapping:
            tmp = torch.abs(td - depth) / torch.sqrt(unc + 1e-10)
            if c.tracking_handle_dynamic:
                med = masked_median(tmp, rm * (td > 0))
                dmask = (tmp < 10 * med) & (td > 0)
            else:
                dmask = td > 0
            dmask = dmask.to(depth.dtype) * rm
            losses["depth_loss"] = torch.sum(torch.abs(td - depth) / torch.sqrt(unc + 1e-10) * dmask)
            if c.tracking_use_color_in_tracking:
                losses["rgb_loss"] = c.tracking_w_color_loss * torch.sum(torch.abs(target_s - rgb) * dmask[:, None])
        else:
            dmask = (td > 0).to(depth.dtype) * rm
            losses["depth_loss"] = torch.sum(torch.abs(td - depth) * dmask)
            if stage == "color":
                losses["rgb_loss"] = c.mapping_w_color_loss * torch.sum(torch.abs(target_s - rgb) * rm[:, None])
            if self.geo_supervision:
                # free-space and occupied logits-BCE in a +-geo_trunc band around
                # the measured depth, averaged over the supervised samples and
                # scaled to the ray count, commensurate with the depth L1 sum;
                # the clip keeps inf out of an inf * 0 (the BCE's gradient is a
                # constant +-1 at |logit| 1e4 anyway)
                x = torch.clamp(10.0 * out["occ_raw"], -1e4, 1e4)
                z, tdz = out["z_vals"], td[:, None]
                free = (z < tdz - c.geo_trunc) & (tdz > 0)
                band = torch.abs(z - tdz) <= c.geo_trunc
                sup = (free | (band & (tdz > 0))).to(depth.dtype) * dmask[:, None]
                target = (z > tdz).to(depth.dtype)
                bce = torch.clamp(x, min=0.0) - x * target + torch.log1p(torch.exp(-torch.abs(x)))
                mean_bce = torch.sum(bce * sup) / torch.clamp(torch.sum(sup), min=1.0)
                losses["geo_loss"] = c.geo_w * mean_bce * torch.sum(dmask)
        return sum(losses.values()), losses

    # ------------------------------------------------------------------
    def frustum_grid_masks(self, c2w: np.ndarray, depth_np: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-grid optimization masks [X, Y, Z, 1] (float32) on the host,
        in float64: a cell is kept if it projects into the image in front of
        the camera no further than the depth there + 0.5 m (bilinear depth;
        where it is 0, the frame's largest), or lies within 0.5 m of the
        camera. The coarse grid is kept whole."""
        cam = self.camera
        masks = {}
        for name, shape in self.grid_shapes.items():
            if name == "grid_coarse":
                masks[name] = np.ones((*shape, 1), np.float32)
                continue
            pts = self._grid_pts_np[name]
            w2c = np.linalg.inv(np.asarray(c2w, np.float64))
            pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
            pc[:, 0] *= -1  # the reference flips x before the intrinsics
            z = pc[:, 2:3] + 1e-5
            u = cam.fx * pc[:, 0:1] / z + cam.cx
            v = cam.fy * pc[:, 1:2] / z + cam.cy
            uu = np.clip(u[:, 0], 0, cam.width - 1)
            vv = np.clip(v[:, 0], 0, cam.height - 1)
            x0 = np.clip(uu.astype(np.int64), 0, cam.width - 1)
            y0 = np.clip(vv.astype(np.int64), 0, cam.height - 1)
            x1 = np.minimum(x0 + 1, cam.width - 1)
            y1 = np.minimum(y0 + 1, cam.height - 1)
            fx_, fy_ = uu - x0, vv - y0
            d = (depth_np[y0, x0] * (1 - fx_) * (1 - fy_) + depth_np[y0, x1] * fx_ * (1 - fy_)
                 + depth_np[y1, x0] * (1 - fx_) * fy_ + depth_np[y1, x1] * fx_ * fy_)
            d = np.where(d == 0, d.max() if d.max() > 0 else 1e3, d)
            mask = (u[:, 0] > 0) & (u[:, 0] < cam.width) & (v[:, 0] > 0) & (v[:, 0] < cam.height)
            depth_along = -z[:, 0]
            mask &= (depth_along >= 0) & (depth_along <= d + 0.5)
            mask |= np.sum((pts - np.asarray(c2w)[:3, 3]) ** 2, -1) < 0.25
            masks[name] = mask.reshape(*shape, 1).astype(np.float32)
        return masks

    def frustum_grid_masks_dev(self, c2w: torch.Tensor, depth: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``frustum_grid_masks`` on the device, in float32, from a device
        pose and depth: no host sync, so the group step can capture it. The
        fallback depth where the bilinear depth is 0 is the frame's largest
        depth, not the largest of the sampled ones as on the host."""
        cam = self.camera
        masks: Dict[str, torch.Tensor] = {}
        w2c = lie.pose_inverse(c2w)
        dmax = torch.clamp(torch.amax(depth), min=0.0)
        fallback = torch.where(dmax > 0, dmax, torch.full_like(dmax, 1e3))
        for name, shape in self.grid_shapes.items():
            if name == "grid_coarse":
                masks[name] = torch.ones((*shape, 1), device=depth.device)
                continue
            pts = getattr(self, f"_pts_{name}")
            pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
            pc = torch.cat([-pc[:, :1], pc[:, 1:]], -1)
            z = pc[:, 2:3] + 1e-5
            u = (cam.fx * pc[:, 0:1] / z + cam.cx)[:, 0]
            v = (cam.fy * pc[:, 1:2] / z + cam.cy)[:, 0]
            uu = torch.clamp(u, 0, cam.width - 1)
            vv = torch.clamp(v, 0, cam.height - 1)
            x0 = torch.clamp(uu.to(torch.int64), 0, cam.width - 1)
            y0 = torch.clamp(vv.to(torch.int64), 0, cam.height - 1)
            x1 = torch.clamp(x0 + 1, max=cam.width - 1)
            y1 = torch.clamp(y0 + 1, max=cam.height - 1)
            fx_, fy_ = uu - x0, vv - y0
            d = (depth[y0, x0] * (1 - fx_) * (1 - fy_) + depth[y0, x1] * fx_ * (1 - fy_)
                 + depth[y1, x0] * (1 - fx_) * fy_ + depth[y1, x1] * fx_ * fy_)
            d = torch.where(d == 0, fallback, d)
            mask = (u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
            depth_along = -z[:, 0]
            mask = mask & (depth_along >= 0) & (depth_along <= d + 0.5)
            mask = mask | (torch.sum((pts - c2w[:3, 3]) ** 2, -1) < 0.25)
            masks[name] = mask.reshape(*shape, 1).to(torch.float32)
        return masks


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The median of ``x`` over ``mask > 0``: ``sort(x)[count // 2]``, the
    upper one for an even count (``torch.median`` returns the lower); 0
    when the mask is empty."""
    big = torch.where(mask > 0, x, torch.full_like(x, float("inf")))
    order = torch.sort(big).values
    count = torch.sum(mask > 0)
    # a gather, not indexing by a 0-d tensor: no host sync under capture
    med = torch.gather(order, 0, torch.clamp(count // 2, max=x.shape[0] - 1).reshape(1))[0]
    return torch.where(count > 0, med, torch.zeros_like(med))
