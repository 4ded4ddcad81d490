"""ConvOnet2 (Point-SLAM) scene model: a neural point cloud and its renderer.

Counterpart of ``xrdslam_tpu/models/conv_onet_pointslam.py``:

  * the map is the ``ops.point_table.PointMap`` of the algorithm; every
    query point takes its k nearest map points from ``knn_query`` (one
    union-row gather each, K7 on the card), once per ``query_raw`` and
    shared by the geometry and colour features;
  * per-point geometry and colour features are fixed-capacity tables whose
    gradients come from ``ops.scatter.table_lookup`` (K4 on the card);
    tracking detaches them, so it takes no table gradient;
  * neighbours are weighted 1/D^2, zero beyond the per-ray dynamic query
    radius, and normalised; colour neighbours first pass through the
    relative-position MLP (a Gaussian-Fourier
    embedding of the offset, concatenated with the feature, through
    Linear-Softplus(beta 100)-Linear);
  * 5 surface samples per ray in [0.98 d, 1.02 d]; alpha =
    sigmoid(0.1 occ) composited with weight-sum normalisation; a point
    with fewer than ``pointcloud_min_nn_num`` neighbours has occ = -100;
  * losses: mapping sums depth L1 (and colour L1 in the colour stage)
    over rays with depth and any neighbours; tracking sums the
    uncertainty-weighted depth L1 (clipped at 1e3) and colour L1 over
    pixels under 10x the median of the weighted error.

The geometry decoder starts from NICE-SLAM's pretrained middle decoder
when ``pretrained_decoders_middle_fine`` names the file (frozen, outside
the ``decoder`` group, with ``mapping_fix_geo_decoder``, the default);
the registry names it, but the file is not in the repository, so there
both decoders train from scratch, as the reference does without it.
Exposure compensation (``model_encode_exposure``) is not ported: it is
off in the registry and raises here. The reference's options that the
registry leaves at one value are that value here: dynamic radii on, 1/D^2
weighting, the relative-position MLP on, colour in the tracking loss, a
trainable colour decoder.
"""
from __future__ import annotations

import copy
import os
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.point_table import knn_query
from ..ops.scatter import table_lookup
from ..utils.torch_convert import load_nice_decoders, load_tree_into_decoder
from .base import Model, ModelConfig
from .conv_onet import MLPDecoder, masked_median


@dataclass
class ConvOnet2Config(ModelConfig):
    """The reference's ConvOnet2Config, less what nothing in the port reads
    (``points_batch_size``, ``tracking_handle_dynamic``, the TPU's
    ``fast_scatter`` and the exposure MLP's width) and the options built in
    at the registry's value (``use_dynamic_radius``, the fixed radii it
    replaces, ``pointcloud_nn_weighting``, ``model_encode_rel_pos_in_col``,
    ``tracking_use_color_in_tracking``, ``mapping_fix_color_decoder``).
    ``pretrained_decoders_middle_fine`` names NICE-SLAM's
    ``middle_fine.pt``, whose middle decoder is the geometry decoder's
    start; with ``mapping_fix_geo_decoder`` a loaded one is frozen."""

    _target: Type = field(default_factory=lambda: ConvOnet2)
    c_dim: int = 32
    max_points: int = 262144
    pointcloud_nn_num: int = 8
    pointcloud_min_nn_num: int = 2
    # dynamic radii from the colour gradient
    pointcloud_radius_add_max: float = 0.08
    pointcloud_radius_add_min: float = 0.02
    pointcloud_radius_query_ratio: int = 2
    pointcloud_color_grad_threshold: float = 0.15
    model_encode_exposure: bool = False  # not ported: raises
    rendering_n_surface: int = 5
    rendering_near_end_surface: float = 0.98
    rendering_far_end_surface: float = 1.02
    rendering_sigmoid_coef_mapper: float = 0.1
    tracking_w_color_loss: float = 0.5
    mapping_w_color_loss: float = 0.1
    mapping_fix_geo_decoder: bool = True
    pretrained_decoders_middle_fine: Optional[Path] = None


class ConvOnet2(Model):
    config: ConvOnet2Config

    def __init__(self, config: ConvOnet2Config, camera, bounding_box=None,
                 generator: Optional[torch.Generator] = None, **kwargs) -> None:
        super().__init__(config, camera, np.zeros((3, 2), np.float32) if bounding_box is None else bounding_box,
                         **kwargs)
        c = config
        if c.model_encode_exposure:
            raise NotImplementedError("Point-SLAM's exposure compensation is not ported yet (ROADMAP Queue 1)")
        self.geo_feats = nn.Parameter(torch.randn((c.max_points, c.c_dim), generator=generator) * 0.01)
        self.col_feats = nn.Parameter(torch.randn((c.max_points, c.c_dim), generator=generator) * 0.01)
        hid = 128
        self.relpos_B = nn.Parameter(torch.randn((3, 10), generator=generator) * 32.0)
        self.nb1 = nn.Linear(c.c_dim + 20, hid)
        self.nb2 = nn.Linear(hid, c.c_dim)
        with torch.no_grad():
            for layer in (self.nb1, self.nb2):
                a = float(np.sqrt(6.0 / sum(layer.weight.shape)))
                layer.weight.uniform_(-a, a, generator=generator)
                layer.bias.zero_()
        self.geo_decoder = MLPDecoder(c.c_dim, hidden=32, generator=generator)
        self.col_decoder = MLPDecoder(c.c_dim, hidden=32, color=True, generator=generator)
        self.pretrained_available = self._load_pretrained_geo()
        self.fixed_geo = self.pretrained_available and c.mapping_fix_geo_decoder
        self.geo_decoder.requires_grad_(not self.fixed_geo)

    def _load_pretrained_geo(self) -> bool:
        """The middle decoder of ``pretrained_decoders_middle_fine`` over
        the initial geometry decoder, where the file exists; a file that
        does not convert is reported and the decoder trains from scratch,
        as in the reference package. Returns whether it loaded."""
        mf = self.config.pretrained_decoders_middle_fine
        if mf is None or not os.path.exists(mf):
            return False
        try:
            tree = load_nice_decoders(str(mf))["middle"]
            loaded = copy.deepcopy(self.geo_decoder)
            load_tree_into_decoder(loaded, tree, "decoder.geo")
        except (OSError, RuntimeError, KeyError, ValueError, EOFError, pickle.UnpicklingError) as e:
            print(f"[conv_onet2] pretrained geo decoder load failed ({e}); training from scratch", flush=True)
            return False
        self.geo_decoder = loaded
        return True

    def param_groups(self) -> Dict[str, List[torch.Tensor]]:
        """{optimizer group: [tensors]}: the decoders (the colour decoder
        alone when the loaded geometry decoder is fixed), the geometry
        table, the colour table with the relative-position MLP."""
        geo = [] if self.fixed_geo else list(self.geo_decoder.parameters())
        dec = geo + list(self.col_decoder.parameters())
        color = [self.col_feats, self.relpos_B, self.nb1.weight, self.nb1.bias, self.nb2.weight, self.nb2.bias]
        return {"decoder": dec, "geometry": [self.geo_feats], "color": color}

    def max_query_radius(self) -> float:
        c = self.config
        return c.pointcloud_radius_query_ratio * c.pointcloud_radius_add_max

    # ------------------------------------------------------------------
    def interp_features(self, table: torch.Tensor, pts: torch.Tensor, nn_out, is_tracker: bool,
                        r_query: torch.Tensor, color: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """kNN-weighted interpolation of ``table`` rows at ``pts`` [N, 3] from
        ``nn_out`` = (D2, I, n_valid, cpos) of ``knn_query``, within the query
        radius ``r_query`` [N]; ``color`` sends the neighbour features through
        the relative-position MLP first. Returns (feature [N, C], has enough
        neighbours [N])."""
        c = self.config
        D2, I, n_valid, cpos = nn_out
        if is_tracker:
            # re-derive distances so that pose gradients flow
            D2 = torch.sum(torch.square(cpos - pts[:, None, :]), -1)
        w = 1.0 / (D2 + 1e-10)
        w = torch.where(D2 > torch.square(r_query)[:, None], torch.zeros_like(w), w)
        w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-10)
        nf = table_lookup(table, I)  # [N, k, C]
        if color:
            rel = cpos - pts[:, None, :]
            ang = (2.0 * np.pi * rel) @ self.relpos_B
            emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)  # [N, k, 20]
            # Softplus(beta=100). Below -20 the clamp changes its value by
            # less than exp(-20) = 2e-9 (and its gradient, sigmoid, by as
            # little); it spares the CPU's log1p its slow path for arguments
            # under 2e-9, which took a third of a CPU mapping iteration
            h = F.softplus(torch.clamp(100.0 * self.nb1(torch.cat([emb, nf], -1)), min=-20.0)) / 100.0
            nf = self.nb2(h)
        feat = torch.sum(nf * w[..., None], 1)
        return feat, n_valid >= c.pointcloud_min_nn_num

    def query_raw(self, maps, pts: torch.Tensor, stage: str, is_tracker: bool, r_query: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, 3] -> (raw [N, 4] (rgb, occ), point has neighbours [N]). One
        kNN serves both features."""
        c = self.config
        nn_out = knn_query(maps, pts.detach(), k=c.pointcloud_nn_num, with_pos=True)
        geo, col = self.geo_feats, self.col_feats
        if is_tracker:
            geo, col = geo.detach(), col.detach()
        geo_feat, has_nn = self.interp_features(geo, pts, nn_out, is_tracker, r_query)
        occ = self.geo_decoder(pts, geo_feat)[:, 0]
        occ = torch.where(has_nn, occ, torch.full_like(occ, -100.0))
        if stage == "color":
            col_feat, _ = self.interp_features(col, pts, nn_out, is_tracker, r_query, color=True)
            rgb = self.col_decoder(pts, col_feat)[:, :3]
        else:
            rgb = torch.zeros((pts.shape[0], 3), dtype=pts.dtype, device=pts.device)
        return torch.cat([rgb, occ[:, None]], -1), has_nn

    def render_rays(self, maps, rays_o: torch.Tensor, rays_d: torch.Tensor, target_d: torch.Tensor,
                    stage: str, r_query: torch.Tensor, is_tracker: bool = False) -> Dict[str, torch.Tensor]:
        """Surface samples around the measured depth; ``r_query`` [N] is the
        per-ray dynamic query radius. Rays without depth sample [0.1, 1] x
        far, far a statistic of the batch's depths."""
        c = self.config
        n = rays_o.shape[0]
        ns = c.rendering_n_surface
        dev = rays_o.device
        gt = target_d.reshape(-1, 1)
        t = torch.linspace(0.0, 1.0, ns, device=dev)
        z_pos = c.rendering_near_end_surface * gt * (1 - t)[None] + c.rendering_far_end_surface * gt * t[None]
        far = torch.minimum(5.0 * torch.mean(gt), torch.max(gt * 1.2))
        z_zero = (torch.linspace(0.1, 1.0, ns, device=dev)[None] * far).expand(n, ns)
        z_vals = torch.where(gt > 0, z_pos, z_zero)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        rq = r_query[:, None].expand(n, ns).reshape(-1)
        raw, point_mask = self.query_raw(maps, pts.reshape(-1, 3), stage, is_tracker, rq)
        raw = raw.reshape(n, ns, 4)
        point_mask = point_mask.reshape(n, ns)
        alpha = torch.sigmoid(c.rendering_sigmoid_coef_mapper * raw[..., 3])
        log_t = torch.log(1.0 - alpha + 1e-10)
        T = torch.exp(torch.cat([torch.zeros((n, 1), device=dev), torch.cumsum(log_t, -1)[:, :-1]], -1))
        weights = alpha * T
        wsum = torch.sum(weights, -1, keepdim=True) + 1e-10
        rgb_map = torch.sum(weights[..., None] * raw[..., :3], -2) / wsum
        depth = torch.sum(weights * z_vals, -1) / wsum[:, 0]
        unc = torch.sum(weights * torch.square(z_vals - depth[:, None]), -1) / wsum[:, 0]
        depth = torch.where(gt[:, 0] > 0, depth, torch.zeros_like(depth))
        return {"rgb": rgb_map, "depth": depth, "uncertainty": unc, "valid_ray_mask": point_mask.any(-1)}

    def get_loss(self, maps, rays_o: torch.Tensor, rays_d: torch.Tensor, target_s: torch.Tensor,
                 target_d: torch.Tensor, is_mapping: bool, stage: str, r_query: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """L1 sums: (loss, render outputs)."""
        c = self.config
        out = self.render_rays(maps, rays_o, rays_d, target_d, stage, r_query, is_tracker=not is_mapping)
        td = target_d[:, 0]
        depth = out["depth"]
        if not is_mapping:
            unc = out["uncertainty"].detach()
            tmp = torch.abs(td - depth) / torch.sqrt(unc + 1e-10)
            med = masked_median(tmp, td > 0)
            mask = ((tmp < 10 * med) & (td > 0)).to(depth.dtype)
            loss = torch.sum(torch.clamp(tmp, 0.0, 1e3) * mask)
            loss = loss + c.tracking_w_color_loss * torch.sum(torch.abs(target_s - out["rgb"]) * mask[:, None])
            return loss, out
        mask = ((td > 0) & out["valid_ray_mask"]).to(depth.dtype)
        loss = torch.sum(torch.abs(td - depth) * mask)
        if stage == "color":
            loss = loss + c.mapping_w_color_loss * torch.sum(torch.abs(target_s - out["rgb"]) * mask[:, None])
        return loss, out
