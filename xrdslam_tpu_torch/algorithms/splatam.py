"""SplaTAM: 3D gaussian splatting SLAM, per frame on the device.

Counterpart of ``xrdslam_tpu/algorithms/splatam.py`` (its per-frame path:
``dispatch_tracking`` / ``finish_tracking``, ``do_mapping``,
``add_keyframe``). The fused per-frame super-step and clone/split
densification are not ported. The structure is the reference package's:

  * tracking optimizes the current camera pose (quaternion and translation
    of c2w; the rasterizer sees w2c) against full-image sil-masked L1
    losses, ``tracking_n_iters`` full renders, and keeps the pose of lowest
    loss;
  * before each mapping call, gaussians grow from the pixels the map does
    not yet explain (``grow_step``); mapping then picks a random window
    frame per iteration and optimizes the five gaussian groups with a
    fresh Adam per call, freezing dead and unallocated rows;
  * pruning runs inside the mapping loop at the reference schedule by
    flipping the persistent ``dead`` mask;
  * tile binning (``binning``) is rebuilt per call on the device and held
    fixed through the call's iterations.

The optimization loops are Python loops of eager device work. The window
frame pick draws from a CPU ``torch.Generator`` (a host integer, no device
sync); the window ranking from a numpy ``Generator``; both are seeded from
``config.seed`` and give other numbers than the reference's ``jax.random``.
The gaussian table is updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame
from ..engine.optimizers import GroupOptimizers
from ..models.gaussian_splatting import GAUSS_GROUPS, GaussianSplatting, GaussianSplattingConfig
from ..ops import lie, lie_np
from ..ops.gaussian_raster import TILE, Binning, bin_gaussians_device
from .base import Algorithm, AlgorithmConfig

Params = Dict[str, torch.Tensor]


@dataclass
class SplaTAMConfig(AlgorithmConfig):
    _target: Type = field(default_factory=lambda: SplaTAM)
    model: GaussianSplattingConfig = field(default_factory=GaussianSplattingConfig)
    mapping_sil_thres: float = 0.5
    max_keyframes: int = 512
    # clone/split densification during mapping: not ported (see ROADMAP)
    mapping_use_gaussian_splatting_densification: bool = False
    seed: int = 0


class SplaTAM(Algorithm):
    config: SplaTAMConfig

    def __init__(self, config: SplaTAMConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        if config.mapping_use_gaussian_splatting_densification:
            raise NotImplementedError("SplaTAM densification is not ported yet (ROADMAP Queue 1)")
        self.model: GaussianSplatting = config.model.setup(camera=camera).to(self.device)
        self.params = self.model.init_params()
        self.dead = torch.zeros((config.model.max_gaussians,), dtype=torch.bool, device=self.device)
        self._opt_cfgs = {name: g["optimizer"] for name, g in config.optimizers.items()}
        self.kf_frames: List[Frame] = []
        self.generator = torch.Generator().manual_seed(config.seed)
        self.rng = np.random.default_rng(config.seed)
        self.ntx = (camera.width + TILE - 1) // TILE
        self.nty = (camera.height + TILE - 1) // TILE
        H, W = camera.height, camera.width
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                                indexing="ij")
        # camera-frame ray directions of every pixel (OpenGL: -z forward)
        self._dirs = torch.stack([(xs - camera.cx) / camera.fx, -(ys - camera.cy) / camera.fy,
                                  -torch.ones_like(xs)], -1).to(self.device)

    @property
    def n_gauss(self) -> int:
        return self.model.n_gauss

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    @torch.no_grad()
    def binning(self, params: Params, dead: torch.Tensor, count: int, w2c: torch.Tensor,
                max_span: int = 4) -> Binning:
        """Tile binning from the current params and pose. max_span 4 in the
        optimization loops (the cap only truncates transient gaussians wider
        than 64 px), 6 for the growth mask and full renders."""
        cam = self.camera
        u, v, depth, sigma = self.model.project(params, w2c)
        return Binning(*bin_gaussians_device(u, v, depth, 3.0 * sigma, self.model.alive_mask(dead, count),
                                             cam.height, cam.width, k_per_tile=self.config.model.k_per_tile,
                                             max_span=max_span))

    def track_step(self, params: Params, dead: torch.Tensor, count: int, rgb: torch.Tensor, depth: torch.Tensor,
                   t0: torch.Tensor, q0: torch.Tensor, tiles: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``tracking_n_iters`` Adam steps on the pose against the frozen map.
        Returns the pose of lowest loss seen (t, q) and that loss."""
        names = ("tracking_pose_r", "tracking_pose_t")
        scheds = {n: self._tracking_lr_schedule(self._opt_cfgs[n].lr) for n in names}
        opt = GroupOptimizers({n: self._opt_cfgs[n] for n in names},
                              schedules={n: s for n, s in scheds.items() if s is not None})
        q = q0.clone().requires_grad_(True)
        t = t0.clone().requires_grad_(True)
        pose = {"tracking_pose_r": [q], "tracking_pose_t": [t]}
        state = opt.init(pose)
        frozen = {g: params[g].detach() for g in GAUSS_GROUPS}
        alive = self.model.alive_mask(dead, count)
        best_loss = torch.full((), 1e10, device=self.device)
        best_t, best_q = t0.clone(), q0.clone()
        binning = Binning(tiles, mask)  # one binning for every iteration
        for _ in range(self.config.tracking_n_iters):
            w2c = lie.pose_inverse(lie.pose_vec_to_matrix(t, q, rot_rep="quat"))
            out = self.model.render(frozen, alive, w2c, binning, self.ntx, self.nty)
            loss = self.model.get_loss(out, rgb, depth, is_mapping=False)
            g_q, g_t = torch.autograd.grad(loss, [q, t])
            with torch.no_grad():
                loss = loss.detach()
                better = loss < best_loss
                best_loss = torch.where(better, loss, best_loss)
                best_t = torch.where(better, t, best_t)
                best_q = torch.where(better, q, best_q)
            g_q, g_t = self._finite_guard(loss, [g_q, g_t])
            opt.update({"tracking_pose_r": [g_q], "tracking_pose_t": [g_t]}, state, pose)
        return best_t, best_q, best_loss

    def map_step(self, params: Params, dead: torch.Tensor, count: int, images: torch.Tensor, w2cs: torch.Tensor,
                 tiles: torch.Tensor, masks: torch.Tensor, n_valid: int, n_iters: int
                 ) -> Tuple[Params, torch.Tensor, int, torch.Tensor]:
        """``n_iters`` Adam steps on the gaussian groups (fresh Adam state),
        each on a random frame of the first ``n_valid`` of the window
        (``images`` [n, H, W, 4] rgb + depth, ``w2cs`` [n, 4, 4], binning
        ``tiles`` / ``masks`` [n, T, K]). Dead and unallocated rows stay
        frozen; pruning flips ``dead`` at the schedule. Returns (the five
        groups, dead, count, the losses)."""
        opt = GroupOptimizers({g: self._opt_cfgs[g] for g in GAUSS_GROUPS})
        gp = {g: params[g].detach().clone().requires_grad_(True) for g in GAUSS_GROUPS}
        groups = {g: [gp[g]] for g in GAUSS_GROUPS}
        state = opt.init(groups)
        losses = []
        bins = [Binning(tiles[i], masks[i]) for i in range(n_valid)]  # each kept for every pick of its frame
        for it in range(n_iters):
            fi = int(torch.randint(0, n_valid, (), generator=self.generator))
            alive = self.model.alive_mask(dead, count)
            out = self.model.render(gp, alive, w2cs[fi], bins[fi], self.ntx, self.nty)
            loss = self.model.get_loss(out, images[fi, ..., :3], images[fi, ..., 3], is_mapping=True)
            grads = torch.autograd.grad(loss, [gp[g] for g in GAUSS_GROUPS], allow_unused=True)
            grads = [torch.zeros_like(gp[g]) if d is None else d for g, d in zip(GAUSS_GROUPS, grads)]
            loss = loss.detach()
            grads = self._finite_guard(loss, grads)
            with torch.no_grad():
                before = {g: gp[g].clone() for g in GAUSS_GROUPS}
            opt.update({g: [d] for g, d in zip(GAUSS_GROUPS, grads)}, state, groups)
            with torch.no_grad():
                # dead and unallocated rows keep their values (the reference
                # deletes them; a frozen row in a fixed table is equivalent)
                keep = alive[:, None] > 0
                for g in GAUSS_GROUPS:
                    gp[g].copy_(torch.where(keep, gp[g], before[g]))
            dead, _ = self.model.prune_step(gp, dead, count, it)
            losses.append(loss)
        return {g: gp[g].detach() for g in GAUSS_GROUPS}, dead, count, torch.stack(losses)

    @torch.no_grad()
    def grow_step(self, params: Params, dead: torch.Tensor, count: int, rgb: torch.Tensor, depth: torch.Tensor,
                  c2w: torch.Tensor, first: bool) -> Tuple[Params, torch.Tensor, int]:
        """Add a gaussian at every pixel the map does not explain: all valid
        pixels on the first frame, else those of low silhouette or with the
        rendered surface behind the measured one by more than 50 median depth
        errors. New rows are appended at ``count`` in pixel order, as many as
        fit. Updates ``params`` and ``dead`` in place; returns them with the
        new count."""
        G = self.config.model.max_gaussians
        valid = depth > 0
        if first:
            mask = valid
        else:
            w2c = lie.pose_inverse(c2w)
            tiles, msk = self.binning(params, dead, count, w2c, max_span=6)
            out = self.model.render(params, self.model.alive_mask(dead, count), w2c, (tiles, msk), self.ntx,
                                    self.nty)
            sil, rdepth = out["sil"], out["depth"]
            derr = torch.abs(depth - rdepth) * valid
            # the median of the positive errors; with an even count, the mean
            # of the two middle values (as jnp.nanmedian; torch.nanmedian
            # would return the lower one)
            med = torch.nanquantile(torch.where(derr > 0, derr, torch.full_like(derr, float("nan"))).reshape(-1),
                                    0.5)
            med = torch.where(torch.isfinite(med), med, torch.zeros_like(med))
            mask = ((sil < self.config.mapping_sil_thres) | ((rdepth > depth) & (derr > 50.0 * med))) & valid
        sel = torch.nonzero(mask.reshape(-1)).squeeze(1)[: G - count]
        n = int(sel.numel())
        rows = slice(count, count + n)
        d = depth.reshape(-1)[sel]
        pts = c2w[:3, 3] + (self._dirs.reshape(-1, 3)[sel] @ c2w[:3, :3].T) * d[:, None]
        params["means3D"][rows] = pts
        params["rgb_colors"][rows] = rgb.reshape(-1, 3)[sel]
        params["logit_opacities"][rows] = 0.0
        params["log_scales"][rows, 0] = torch.log(torch.clamp(d / self.model._f, min=1e-6))
        dead[rows] = False
        return params, dead, count + n

    @torch.no_grad()
    def render_full(self, params: Params, dead: torch.Tensor, count: int, w2c: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """Render all channels at ``w2c`` with a fresh span-6 binning."""
        tiles, mask = self.binning(params, dead, count, w2c, max_span=6)
        return self.model.render(params, self.model.alive_mask(dead, count), w2c, (tiles, mask), self.ntx,
                                 self.nty)

    # ------------------------------------------------------------------
    # host API (called by the pipeline)
    # ------------------------------------------------------------------
    def dispatch_tracking(self, cur_frame: Frame) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.is_initialized():
            return None
        w2c = self._tensor(np.linalg.inv(cur_frame.get_pose()))
        tiles, mask = self.binning(self.params, self.dead, self.n_gauss, w2c)
        bt, bq, _ = self.track_step(self.params, self.dead, self.n_gauss, cur_frame.rgb_dev(self.device),
                                    cur_frame.depth_dev(self.device), self._tensor(cur_frame.t),
                                    self._tensor(cur_frame.r), tiles, mask)
        return bt, bq

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        if handle is None:
            return None
        bt, bq = (h.cpu().numpy() for h in handle)
        return lie_np.pose_vec_to_matrix(bt, bq, rot_rep="quat")

    def do_mapping(self, cur_frame: Frame) -> None:
        cfg = self.config
        first = not self.is_initialized()
        if first:
            self.model.scene_radius = float(cur_frame.depth.max() / 3.0)
        self.params, self.dead, count = self.grow_step(
            self.params, self.dead, self.n_gauss, cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device),
            self._tensor(cur_frame.get_pose()), first)
        self.model.n_gauss = count
        frames = self._select_window(cur_frame)
        images = torch.stack([torch.cat([f.rgb_dev(self.device), f.depth_dev(self.device)[..., None]], -1)
                              for f in frames])
        w2cs = self._tensor(np.stack([np.linalg.inv(f.get_pose()) for f in frames]))
        bins = [self.binning(self.params, self.dead, count, w) for w in w2cs]
        tiles, masks = torch.stack([b.tile_ids for b in bins]), torch.stack([b.tile_mask for b in bins])
        gparams, self.dead, _, _ = self.map_step(
            self.params, self.dead, count, images, w2cs, tiles, masks, len(frames),
            cfg.mapping_first_n_iters if first else cfg.mapping_n_iters)
        self.params.update(gparams)
        if first:
            self.set_initialized()

    def _select_window_slots(self, cur_depth: np.ndarray, cur_c2w: np.ndarray) -> List[int]:
        """Overlap keyframe ranking -> keyframe indices: all keyframes while
        they fit the window, else the ``w - 2`` that see most of 1600 random
        current-frame points, plus the newest."""
        w = self.config.mapping_window_size
        n_kf = len(self.kf_frames)
        if n_kf <= w - 2:
            return list(range(n_kf))
        cam = self.camera
        vs, us = np.nonzero(cur_depth > 0)
        pick = self.rng.integers(0, len(vs), 1600)
        u, v, z = us[pick], vs[pick], cur_depth[vs[pick], us[pick]]
        dirs = np.stack([(u - cam.cx) / cam.fx, -(v - cam.cy) / cam.fy, -np.ones_like(u, np.float64)], -1)
        pts = cur_c2w[:3, 3] + (dirs @ cur_c2w[:3, :3].T) * z[:, None]
        scores = []
        for f in self.kf_frames[:-1]:
            w2c = np.linalg.inv(f.get_pose())
            pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
            zc = -pc[:, 2]
            uu = cam.cx + cam.fx * pc[:, 0] / np.maximum(zc, 1e-6)
            vv = cam.cy - cam.fy * pc[:, 1] / np.maximum(zc, 1e-6)
            ok = (zc > 0) & (uu >= 20) & (uu < cam.width - 20) & (vv >= 20) & (vv < cam.height - 20)
            scores.append(ok.mean())
        top = np.argsort(scores)[::-1][: w - 2]
        return sorted(int(t) for t in top) + [n_kf - 1]

    def _select_window(self, cur_frame: Frame) -> List[Frame]:
        slots = self._select_window_slots(cur_frame.depth, cur_frame.get_pose())
        return [self.kf_frames[i] for i in slots] + [cur_frame]

    def add_keyframe(self, keyframe: Frame) -> None:
        if len(self.kf_frames) >= self.config.max_keyframes:
            raise RuntimeError("keyframe capacity exceeded; raise max_keyframes")
        self.kf_frames.append(keyframe)
        self.keyframe_fids.append(keyframe.fid)

    def render_img(self, c2w: np.ndarray, gt_depth: Optional[np.ndarray] = None):
        """(rgb [H, W, 3] in [0, 1], depth [H, W]) rendered at ``c2w``, zeroed
        where ``gt_depth`` has no measurement."""
        out = self.render_full(self.params, self.dead, self.n_gauss,
                               self._tensor(np.linalg.inv(np.asarray(c2w, np.float64))))
        rgb = np.clip(out["rgb"].cpu().numpy(), 0, 1)
        depth = out["depth"].cpu().numpy()
        if gt_depth is not None:
            valid = gt_depth > 0
            rgb, depth = rgb * valid[..., None], depth * valid
        return rgb, depth

    def get_cloud(self, c2w_np: np.ndarray, gt_depth_np: Optional[np.ndarray]):
        """Gaussian centres and colours (the reference's 'centers' mode)."""
        n = self.n_gauss
        return self.params["means3D"][:n].cpu().numpy(), self.params["rgb_colors"][:n].cpu().numpy()
