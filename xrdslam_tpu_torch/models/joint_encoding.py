"""JointEncoding (Co-SLAM) scene model: a scene encoding + OneBlob -> SDF/color MLPs.

Counterpart of ``xrdslam_tpu/models/joint_encoding.py``: a scene encoding
and a OneBlob coordinate encoding feed a 2-layer SDF net (1 sdf + 15
geometry features) and a 2-layer color net; rays are rendered with
depth-guided z sampling (or uniform samples when there is no depth) and
the truncated-SDF weights. Points are processed as flat ``[N*S, ...]``
batches.

The scene encoding is one of the reference's three, held in ``embed_fn``
under the reference's names:

* ``encoding="hash", hash_packed=True`` (the registry's default): the
  packed patch-row hash (``ops.hashgrid_packed``), an ``nn.ParameterDict``
  of ``v{l}`` / ``h{l}`` tables;
* ``encoding="hash", hash_packed=False``: the exact per-vertex hash
  (tcnn's layout), one ``[L, T, F]`` table encoded by the hand-written
  CUDA kernels of ``ops.hashgrid_fast`` on the card;
* ``encoding="triplane"`` (the accuracy protocol's): the tri-planes of
  ``ops.triplane``, an ``nn.ParameterDict`` of ``s{i}`` planes.

``pack_tables`` gives the detached gather-layout copy that tracking passes
as ``packed=``: with it the encode treats the tables as constants, so a
tracking backward computes no table gradient.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Type

import torch
from torch import nn

from ..ops import hashgrid_fast, losses, rendering
from ..ops.encodings import hashgrid_init, hashgrid_spec, oneblob_encode
from ..ops.hashgrid_packed import pack_gather_tables, packed_hash_encode, packed_init
from ..ops.mlp import MLP
from ..ops.sampling import coslam_z_vals
from ..ops.triplane import triplane_encode, triplane_init, triplane_pack, triplane_spec
from .base import Model, ModelConfig


@dataclass
class JointEncodingConfig(ModelConfig):
    """Mirrors the reference package's JointEncodingConfig (the fields this
    port honours, with the same defaults)."""

    _target: Type = field(default_factory=lambda: JointEncoding)
    # grid
    voxel_sdf: float = 0.02
    n_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    pos_nbins: int = 16
    hashsize: int = 16
    oneGrid: bool = True
    # hash layout: packed patch rows (ops/hashgrid_packed) or the exact
    # per-vertex layout (ops/hashgrid_fast)
    hash_packed: bool = True
    # scene encoding: 'hash' or 'triplane' (ops/triplane)
    encoding: str = "hash"
    triplane_resolutions: Tuple[int, ...] = (128, 512)
    triplane_features: Tuple[int, ...] = (8, 8)
    # decoder
    geo_feat_dim: int = 15
    hidden_dim: int = 32
    num_layers: int = 2
    num_layers_color: int = 2
    hidden_dim_color: int = 32
    # train
    trainging_rgb_weight: float = 5.0
    trainging_depth_weight: float = 0.1
    trainging_sdf_weight: float = 1000.0
    trainging_fs_weight: float = 10.0
    trainging_smooth_weight: float = 1e-6
    trainging_smooth_pts: int = 32
    trainging_smooth_vox: float = 0.1
    trainging_smooth_margin: float = 0.05
    training_n_samples: int = 256
    training_n_sample_d: int = 32
    training_range_d: float = 0.1
    training_n_range_d: int = 11
    training_perturb: int = 1
    training_white_bkgd: bool = False
    training_trunc: float = 0.1
    training_rgb_missing: float = 0.05
    # data
    data_sc_factor: float = 1.0
    # cam
    cam_near: float = 0.0
    cam_far: float = 5.0
    cam_depth_trunc: float = 100.0


class JointEncoding(Model):
    config: JointEncodingConfig

    def __init__(self, config: JointEncodingConfig, camera, bounding_box,
                 generator: Optional[torch.Generator] = None, **kwargs) -> None:
        super().__init__(config, camera, bounding_box, **kwargs)
        c = config
        if c.encoding not in ("hash", "triplane"):
            raise ValueError(f"unknown encoding {c.encoding!r}")
        if not c.oneGrid:
            raise NotImplementedError("oneGrid=False (a separate color grid) is not ported (ROADMAP Queue 1)")
        dim_max = float((self.bounding_box[:, 1] - self.bounding_box[:, 0]).max())
        self.resolution_sdf = int(c.voxel_sdf) if c.voxel_sdf > 10 else int(dim_max / c.voxel_sdf)
        self.spec = hashgrid_spec(
            n_levels=c.n_levels,
            n_features=c.level_dim,
            log2_table_size=c.hashsize,
            base_resolution=c.base_resolution,
            finest_resolution=self.resolution_sdf,
        )
        self.tp_spec = triplane_spec(c.triplane_resolutions, c.triplane_features) if c.encoding == "triplane" else None
        self.packed_hash = c.encoding == "hash" and c.hash_packed
        self.input_ch = self.tp_spec.out_dim if self.tp_spec is not None else self.spec.out_dim
        self.input_ch_pos = 3 * c.pos_nbins
        self.register_buffer("bound", torch.as_tensor(self.bounding_box))
        # same draw order as the reference's init: tables, sdf net, color net
        if self.tp_spec is not None:
            self.embed_fn = nn.ParameterDict(triplane_init(self.tp_spec, generator))
        elif self.packed_hash:
            self.embed_fn = nn.ParameterDict(packed_init(self.spec, generator))
        else:
            self.embed_fn = nn.Parameter(hashgrid_init(self.spec, generator))
        sdf_dims = [self.input_ch + self.input_ch_pos] + [c.hidden_dim] * (c.num_layers - 1) + [1 + c.geo_feat_dim]
        color_dims = [self.input_ch_pos + c.geo_feat_dim] + [c.hidden_dim_color] * (c.num_layers_color - 1) + [3]
        self.sdf_net = MLP(sdf_dims, generator)
        self.color_net = MLP(color_dims, generator)

    def tables(self) -> Any:
        """The scene encoding's parameters as the encoders take them: the
        exact table, or a dict of tables under the reference's names."""
        return self.embed_fn if isinstance(self.embed_fn, nn.Parameter) else dict(self.embed_fn.items())

    def param_groups(self) -> Dict[str, List[torch.Tensor]]:
        embed = [self.embed_fn] if isinstance(self.embed_fn, nn.Parameter) else list(self.embed_fn.values())
        return {"embed_fn": embed, "decoder": [*self.sdf_net.parameters(), *self.color_net.parameters()]}

    def pack_tables(self) -> Any:
        """A detached gather-layout copy of the scene encoding, for a phase
        in which the tables are constant (tracking): the packed patch rows,
        the packed tri-planes, or the exact table itself."""
        with torch.no_grad():
            if self.tp_spec is not None:
                return triplane_pack(self.tables(), self.tp_spec)
            if self.packed_hash:
                return pack_gather_tables(self.tables(), self.spec)
            return self.embed_fn.detach()

    # ------------------------------------------------------------------
    # queries (pts are world coordinates, normalized to the bounding box)
    # ------------------------------------------------------------------
    def _normalize(self, pts: torch.Tensor) -> torch.Tensor:
        b = self.bound
        return (pts - b[:, 0]) / (b[:, 1] - b[:, 0])

    def _encode(self, x: torch.Tensor, packed: Any = None) -> torch.Tensor:
        """Scene encoding of normalized x [..., 3]; with ``packed`` (see
        ``pack_tables``) the tables are constants."""
        tables = self.tables()
        if self.tp_spec is not None:
            if packed is not None:
                tables = {k: v.detach() for k, v in tables.items()}
            out = triplane_encode(tables, x.reshape(-1, 3), self.tp_spec, packed=packed)
            return out.reshape(*x.shape[:-1], self.tp_spec.out_dim)
        if self.packed_hash:
            return packed_hash_encode(tables, x, self.spec, packed=packed)
        return hashgrid_fast.encode(tables if packed is None else packed, x, self.spec)

    def query_raw(self, pts: torch.Tensor, packed: Any = None) -> torch.Tensor:
        """[..., 3] world pts -> [..., 4] (rgb logits, sdf)."""
        x = self._normalize(pts)
        emb = self._encode(x, packed)
        pos = oneblob_encode(x, self.config.pos_nbins)
        h = self.sdf_net(torch.cat([emb, pos], -1))
        sdf, geo = h[..., :1], h[..., 1:]
        rgb = self.color_net(torch.cat([pos, geo], -1))
        return torch.cat([rgb, sdf], -1)

    def query_sdf(self, pts: torch.Tensor) -> torch.Tensor:
        """[..., 3] -> [...] sdf (for the mesher)."""
        x = self._normalize(pts)
        h = self.sdf_net(torch.cat([self._encode(x), oneblob_encode(x, self.config.pos_nbins)], -1))
        return h[..., 0]

    def query_color(self, pts: torch.Tensor) -> torch.Tensor:
        """[..., 3] -> [..., 3] colors in [0, 1] (the mesh's vertex colors)."""
        return torch.sigmoid(self.query_raw(pts)[..., :3])

    # ------------------------------------------------------------------
    # rendering and loss
    # ------------------------------------------------------------------
    def render_rays(self, rays_o, rays_d, target_d, generator: Optional[torch.Generator] = None,
                    packed: Any = None) -> Dict[str, torch.Tensor]:
        """Depth-guided samples along each ray (jittered with draws from
        ``generator`` when training_perturb), rendered with SDF weights."""
        c = self.config
        z_vals = coslam_z_vals(
            target_d, rays_o.shape[0], c.cam_near, c.cam_far, c.training_n_sample_d,
            c.training_range_d, c.training_n_range_d, bool(c.training_perturb), generator,
        )
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        raw = self.query_raw(pts, packed)
        rgb_map, disp, acc, _, depth_map, depth_var = rendering.raw2outputs_sdf(
            raw, z_vals, c.training_trunc, c.data_sc_factor, c.training_white_bkgd)
        return {"rgb": rgb_map, "depth": depth_map, "disp_map": disp, "acc_map": acc,
                "depth_var": depth_var, "z_vals": z_vals, "raw": raw}

    def render_rays_no_depth(self, rays_o, rays_d) -> Dict[str, torch.Tensor]:
        """Uniform z sampling (``training_n_samples`` over [near, far]) when
        no depth guides the samples."""
        c = self.config
        z_vals = torch.linspace(c.cam_near, c.cam_far, c.training_n_samples, dtype=torch.float32,
                                device=rays_o.device).expand(rays_o.shape[0], c.training_n_samples)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        raw = self.query_raw(pts)
        rgb_map, _, acc, _, depth_map, depth_var = rendering.raw2outputs_sdf(
            raw, z_vals, c.training_trunc, c.data_sc_factor, c.training_white_bkgd)
        return {"rgb": rgb_map, "depth": depth_map, "acc_map": acc, "depth_var": depth_var}

    def get_loss(self, rays_o, rays_d, target_s, target_d, ray_mask, is_mapping: bool, first: bool,
                 generator: Optional[torch.Generator] = None, packed: Any = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Weighted sum of rgb/depth/sdf/fs (+ smoothness when mapping after
        the first frame) losses."""
        c = self.config
        out = self.render_rays(rays_o, rays_d, target_d, generator, packed)
        rgb_l, depth_l = losses.rgb_depth_losses(
            out["rgb"], out["depth"], target_s, target_d,
            depth_trunc=c.cam_depth_trunc, rgb_missing=c.training_rgb_missing, ray_mask=ray_mask)
        fs_l, sdf_l = losses.sdf_losses(
            out["z_vals"], target_d, out["raw"][..., 3], c.training_trunc * c.data_sc_factor, ray_mask=ray_mask)
        loss_dict = {
            "rgb_loss": rgb_l * c.trainging_rgb_weight,
            "depth_loss": depth_l * c.trainging_depth_weight,
            "sdf_loss": sdf_l * c.trainging_sdf_weight,
            "fs_loss": fs_l * c.trainging_fs_weight,
        }
        if is_mapping and not first:
            loss_dict["smooth_loss"] = self.smoothness(generator) * c.trainging_smooth_weight
        return sum(loss_dict.values()), loss_dict

    def smoothness(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """TV regularizer. Hash encodings: TV of the features over a randomly
        placed, jittered (smooth_pts-1)^3 sub-grid of the bounding box.
        Tri-planes: TV of the planes themselves, divided by R per scale."""
        c = self.config
        if self.tp_spec is not None:
            tv = 0.0
            for s in range(len(self.tp_spec.resolutions)):
                P = self.embed_fn[f"s{s}"]
                tv = tv + (torch.sum(torch.square(P[:, 1:] - P[:, :-1]))
                           + torch.sum(torch.square(P[:, :, 1:] - P[:, :, :-1]))) / P.shape[1]
            return tv
        g = c.trainging_smooth_pts - 1
        vox = c.trainging_smooth_vox
        b = self.bound
        dev = b.device
        offset_max = (b[:, 1] - b[:, 0]) - g * vox - 2 * c.trainging_smooth_margin
        offset = torch.rand(3, generator=generator, device=dev) * offset_max + c.trainging_smooth_margin
        ax = torch.arange(g, dtype=torch.float32, device=dev)
        coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)  # [g, g, g, 3]
        jitter = torch.rand((1, 1, 1, 3), generator=generator, device=dev)
        pts = (coords + jitter) * vox + b[:, 0] + offset
        emb = self._encode(self._normalize(pts))
        return losses.smoothness_tv(emb, c.trainging_smooth_pts)
