"""SplaTAM: 3D gaussian splatting SLAM on the device.

Counterpart of ``xrdslam_tpu/algorithms/splatam.py``: the per-frame path
(``dispatch_tracking`` / ``finish_tracking``, ``do_mapping``,
``add_keyframe``), the fused per-frame step (``fused_step``,
``dispatch_superstep`` / ``finish_superstep``) and clone/split
densification. The structure is the reference package's:

  * tracking optimizes the current camera pose (quaternion and translation
    of c2w; the rasterizer sees w2c) against full-image sil-masked L1
    losses, ``tracking_n_iters`` full renders, and keeps the pose of lowest
    loss;
  * before each mapping call, gaussians grow from the pixels the map does
    not yet explain (``grow_step``): appended at the count in pixel order,
    rows past the table's end dropped, the count a device tensor;
  * mapping optimizes the five gaussian groups with a fresh Adam per call
    on a window padded to ``mapping_window_size`` frames (keyframes from
    the device store, the current frame in the other rows), each iteration
    on a frame picked among the first ``n_valid``, freezing dead and
    unallocated rows; pruning flips the persistent ``dead`` mask at the
    reference schedule; with densification on, small high-gradient
    gaussians are cloned and large ones split at ``mapping_densify_dict``'s
    schedule, and every window frame is binned again;
  * each window frame's tile binning and its K4 ordering are built once per
    mapping call (``WindowBinning``) and selected by the pick on the device;
  * keyframes are kept twice: host ``Frame``s for the window ranking, and a
    device store (rgb as its uint16 values less 32,768 in int16, the same
    round trip as ``Frame.rgb_dev``; depth; w2c) that the window reads.

The fused step runs predict -> bin -> track -> grow -> bin the window ->
map -> write the keyframe as one program, with no host sync: on the CPU
eagerly, on the card as a CUDA graph per ``(do_kf, densify)`` key, replayed
(``engine/graphs.py``). The per-frame path calls the same pieces. The
count reaches the host with the pose, one frame late.

Random numbers: the window picks of a mapping call are drawn at once on
the host from a CPU ``torch.Generator`` (both paths draw them alike), the
window ranking from a numpy ``Generator``, the split noise from a
generator on the run's device; all are seeded from ``config.seed`` and
give other numbers than the reference's ``jax.random``. The gaussian
table, ``dead``, the count and the keyframe store are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame, upload
from ..engine.graphs import GraphReplay, PendingFetch
from ..engine.optimizers import GroupOptimizers
from ..models.gaussian_splatting import GAUSS_GROUPS, GaussianSplatting, GaussianSplattingConfig
from ..ops import lie, lie_np
from ..ops.gaussian_raster import TILE, Binning, WindowBinning, bin_gaussians_device
from ..ops.scatter import scatter_rows
from .base import Algorithm, AlgorithmConfig

Params = Dict[str, torch.Tensor]


@dataclass
class SplaTAMConfig(AlgorithmConfig):
    _target: Type = field(default_factory=lambda: SplaTAM)
    model: GaussianSplattingConfig = field(default_factory=GaussianSplattingConfig)
    mapping_sil_thres: float = 0.5
    max_keyframes: int = 512
    # clone/split densification during mapping, at model.mapping_densify_dict's schedule
    mapping_use_gaussian_splatting_densification: bool = False
    seed: int = 0


def median_of_positive(x: torch.Tensor) -> torch.Tensor:
    """The median of the positive entries of ``x``, 0 when there is none;
    with an even count the mean of the two middle values, as
    ``jnp.nanmedian``. A sort and two gathers: no host sync."""
    v = x.reshape(-1)
    pos = v > 0
    n = pos.sum()
    s = torch.sort(torch.where(pos, v, torch.full_like(v, float("inf")))).values
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0).reshape(1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0).reshape(1)
    med = 0.5 * torch.index_select(s, 0, lo)[0] + 0.5 * torch.index_select(s, 0, hi)[0]
    return torch.where(n > 0, med, torch.zeros_like(med))


class SplaTAM(Algorithm):
    config: SplaTAMConfig

    def __init__(self, config: SplaTAMConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        self.model: GaussianSplatting = config.model.setup(camera=camera).to(self.device)
        self.params = self.model.init_params()
        G = config.model.max_gaussians
        self.dead = torch.zeros((G,), dtype=torch.bool, device=self.device)
        # the count as the device steps see it; the host's is model.n_gauss
        self.count_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self._opt_cfgs = {name: g["optimizer"] for name, g in config.optimizers.items()}
        H, W = camera.height, camera.width
        self.kf_frames: List[Frame] = []
        self.kf_rgb = torch.zeros((config.max_keyframes, H, W, 3), dtype=torch.int16, device=self.device)
        self.kf_depth = torch.zeros((config.max_keyframes, H, W), device=self.device)
        self.kf_w2c = torch.zeros((config.max_keyframes, 4, 4), device=self.device)
        self.generator = torch.Generator().manual_seed(config.seed)
        self.rng = np.random.default_rng(config.seed)
        self.noise_generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.graphs = GraphReplay(self.noise_generator)
        self._programs: Dict[Tuple[bool, bool], Callable] = {}
        self._pending: List[Optional[Frame]] = []  # dispatched groups' keyframes (or None), in order
        self.ntx = (W + TILE - 1) // TILE
        self.nty = (H + TILE - 1) // TILE
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

    def _index(self, values: Sequence[int]) -> torch.Tensor:
        """int64 indices on the device, uploaded without a wait."""
        return upload(np.asarray(values, np.int64), self.device)

    def _draw_picks(self, n_valid: int, n_iters: int) -> torch.Tensor:
        """A mapping call's window picks, uniform in [0, n_valid)."""
        return self._index(torch.randint(0, n_valid, (n_iters,), generator=self.generator).numpy())

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    @torch.no_grad()
    def binning(self, params: Params, dead: torch.Tensor, count, w2c: torch.Tensor,
                max_span: int = 4) -> Binning:
        """Tile binning from the current params and pose. max_span 4 in the
        optimization loops (the cap only truncates transient gaussians wider
        than 64 px), 6 for the growth mask and full renders."""
        cam = self.camera
        u, v, depth, sigma = self.model.project(params, w2c)
        return Binning(*bin_gaussians_device(u, v, depth, 3.0 * sigma, self.model.alive_mask(dead, count),
                                             cam.height, cam.width, k_per_tile=self.config.model.k_per_tile,
                                             max_span=max_span))

    @torch.no_grad()
    def bin_window(self, params: Params, dead: torch.Tensor, count, w2cs: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The binning of each window frame: (tile ids, tile masks) [W, T, K]."""
        bins = [self.binning(params, dead, count, w) for w in w2cs]
        return torch.stack([b.tile_ids for b in bins]), torch.stack([b.tile_mask for b in bins])

    def track_step(self, params: Params, dead: torch.Tensor, count, rgb: torch.Tensor, depth: torch.Tensor,
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

    def track(self, params: Params, dead: torch.Tensor, count, rgb: torch.Tensor, depth: torch.Tensor,
              t0: torch.Tensor, q0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``track_step`` from (t0, q0), on the binning at that pose."""
        w2c = lie.pose_inverse(lie.pose_vec_to_matrix(t0, q0, rot_rep="quat"))
        return self.track_step(params, dead, count, rgb, depth, t0, q0, *self.binning(params, dead, count, w2c))

    def map_step(self, params: Params, dead: torch.Tensor, count, images: torch.Tensor, w2cs: torch.Tensor,
                 tiles: torch.Tensor, masks: torch.Tensor, n_valid: int, n_iters: int,
                 picks: Optional[torch.Tensor] = None, densify: bool = False,
                 noise: Optional[torch.Tensor] = None) -> Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``n_iters`` Adam steps on the gaussian groups (fresh Adam state),
        iteration ``i`` on window frame ``picks[i]`` (device indices, drawn
        from the first ``n_valid`` frames when not given) of ``images`` [W,
        H, W, 4] rgb + depth, ``w2cs`` [W, 4, 4] and their binning ``tiles``
        / ``masks`` [W, T, K]. Dead and unallocated rows stay frozen; pruning
        flips ``dead`` at the schedule; with ``densify``, clone and split at
        the densify schedule (split noise: ``noise`` [G, 3] at every split,
        else drawn from ``noise_generator``). Returns (the five groups, dead,
        count, the losses)."""
        cfg = self.config
        G = cfg.model.max_gaussians
        if picks is None:
            picks = self._draw_picks(n_valid, n_iters)
        opt = GroupOptimizers({g: self._opt_cfgs[g] for g in GAUSS_GROUPS})
        gp = {g: params[g].detach().clone().requires_grad_(True) for g in GAUSS_GROUPS}
        groups = {g: [gp[g]] for g in GAUSS_GROUPS}
        state = opt.init(groups)
        window = WindowBinning(tiles, masks, G)
        if densify:
            accum = torch.zeros((G,), device=self.device)
            denom = torch.zeros((G,), device=self.device)
        losses = []
        for it in range(n_iters):
            fi = picks[it:it + 1]
            alive = self.model.alive_mask(dead, count)
            img = torch.index_select(images, 0, fi)[0]
            duv = torch.zeros((G, 2), device=self.device, requires_grad=True) if densify else None
            out = self.model.render(gp, alive, torch.index_select(w2cs, 0, fi)[0], window.pick(fi), self.ntx,
                                    self.nty, duv=duv)
            loss = self.model.get_loss(out, img[..., :3], img[..., 3], is_mapping=True)
            wrt = [gp[g] for g in GAUSS_GROUPS] + ([duv] if densify else [])
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            grads = [torch.zeros_like(x) if d is None else d for x, d in zip(wrt, grads)]
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
            if densify:
                with torch.no_grad():
                    # duv is in pixels; the reference's grad_thresh is for
                    # NDC-scale gradients: d(px)/d(ndc) is W/2 for u, H/2 for v
                    d = grads[-1]
                    gnorm = torch.sqrt((d[:, 0] * (0.5 * self.camera.width)) ** 2
                                       + (d[:, 1] * (0.5 * self.camera.height)) ** 2)
                    accum = accum + gnorm
                    denom = denom + (gnorm > 0).float()
                    if self._densify_now(it):
                        dead, count = self._densify(gp, dead, count, accum / torch.clamp(denom, min=1.0), it, noise)
                        accum, denom = torch.zeros_like(accum), torch.zeros_like(denom)
                        # every window frame binned again, so new gaussians render
                        window = WindowBinning(*self.bin_window(gp, dead, count, w2cs), G)
            losses.append(loss)
        return {g: gp[g].detach() for g in GAUSS_GROUPS}, dead, count, torch.stack(losses)

    def _densify_now(self, it: int) -> bool:
        d = self.config.model.mapping_densify_dict
        return d["start_after"] <= it <= d["stop_after"] and it % max(d["densify_every"], 1) == 0 and it > 0

    @torch.no_grad()
    def _densify(self, gp: Params, dead: torch.Tensor, count, grads: torch.Tensor, it: int,
                 noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Clone the small gaussians whose mean screen gradient ``grads``
        reaches the threshold, split the large ones (their parents die),
        then remove transparent (and, after ``remove_big_after``, big) rows.
        Writes ``gp`` in place; returns (dead, count)."""
        d = self.config.model.mapping_densify_dict
        model = self.model
        G = self.config.model.max_gaussians
        idx = torch.arange(G, device=self.device)
        scale = torch.exp(gp["log_scales"][:, 0])
        hi = (grads >= d["grad_thresh"]) & (idx < count) & ~dead
        small = scale <= 0.01 * model.scene_radius
        new, dead, count = model.append_rows(gp, dead, count, hi & small)
        n = int(d["num_to_split_into"])
        new, dead, count = model.append_rows(new, dead, count, hi & ~small, repeat=n, scale_div=0.8 * n,
                                             noise=noise, generator=self.noise_generator)
        dead = dead | (hi & ~small)
        for g in GAUSS_GROUPS:
            gp[g].copy_(new[g])
        thresh = d["final_removal_opacity_threshold"] if it == d["stop_after"] else d["removal_opacity_threshold"]
        low = torch.sigmoid(gp["logit_opacities"][:, 0]) < thresh
        big = scale > self.config.model.prune_big_fraction * model.scene_radius
        dead = dead | ((low | (big & (it >= d["remove_big_after"]))) & (idx < count))
        return dead, count

    @torch.no_grad()
    def grow_step(self, params: Params, dead: torch.Tensor, count, rgb: torch.Tensor, depth: torch.Tensor,
                  c2w: torch.Tensor, first: bool) -> Tuple[Params, torch.Tensor, torch.Tensor]:
        """Add a gaussian at every pixel the map does not explain: all valid
        pixels on the first frame, else those of low silhouette or with the
        rendered surface behind the measured one by more than 50 median depth
        errors. New rows go to ``count + (the pixel's rank among them)``;
        rows past the table's end are dropped. Updates ``params`` and
        ``dead`` in place; returns them with the new count (a tensor)."""
        G = self.config.model.max_gaussians
        valid = depth > 0
        if first:
            mask = valid
        else:
            out = self.render_full(params, dead, count, lie.pose_inverse(c2w))
            sil, rdepth = out["sil"], out["depth"]
            derr = torch.abs(depth - rdepth) * valid
            med = median_of_positive(derr)
            mask = ((sil < self.config.mapping_sil_thres) | ((rdepth > depth) & (derr > 50.0 * med))) & valid
        m = mask.reshape(-1)
        dest = count + torch.cumsum(m, 0) - 1
        ok = m & (dest < G)
        dest = torch.where(ok, dest, G)
        d = depth.reshape(-1)
        pts = c2w[:3, 3] + (self._dirs.reshape(-1, 3) @ c2w[:3, :3].T) * d[:, None]
        rows = {"means3D": pts, "rgb_colors": rgb.reshape(-1, 3), "logit_opacities": torch.zeros_like(d)[:, None],
                "log_scales": torch.log(torch.clamp(d / self.model._f, min=1e-6))[:, None]}
        for g, r in rows.items():
            scatter_rows(params[g], dest, r)
        scatter_rows(dead, dest, torch.zeros_like(m))
        return params, dead, torch.clamp(count + ok.sum(), max=G)

    @torch.no_grad()
    def render_full(self, params: Params, dead: torch.Tensor, count, w2c: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Render all channels at ``w2c`` with a fresh span-6 binning."""
        tiles, mask = self.binning(params, dead, count, w2c, max_span=6)
        return self.model.render(params, self.model.alive_mask(dead, count), w2c, (tiles, mask), self.ntx,
                                 self.nty)

    def window(self, rgb: torch.Tensor, depth: torch.Tensor, w2c: torch.Tensor, win_slots: torch.Tensor,
               n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mapping window, padded to ``mapping_window_size`` rows: the
        keyframes at ``win_slots`` [W - 1] of the device store, then the
        current frame (rgb, depth, w2c) in row ``n_valid - 1`` and after.
        Returns (images [W, H, W, 4], w2cs [W, 4, 4])."""
        cur = torch.cat([rgb, depth[..., None]], -1)
        kf_rgb = (torch.index_select(self.kf_rgb, 0, win_slots).float() + 32768.0) / 65535.0
        images = torch.cat([torch.cat([kf_rgb, torch.index_select(self.kf_depth, 0, win_slots)[..., None]], -1),
                            cur[None]], 0)
        w2cs = torch.cat([torch.index_select(self.kf_w2c, 0, win_slots), w2c[None]], 0)
        is_cur = torch.arange(images.shape[0], device=self.device) >= n_valid - 1
        images = torch.where(is_cur[:, None, None, None], cur[None], images)
        w2cs = torch.where(is_cur[:, None, None], w2c[None], w2cs)
        return images, w2cs

    def map_frame(self, rgb: torch.Tensor, depth: torch.Tensor, c2w: torch.Tensor, win_slots: torch.Tensor,
                  n_valid, picks: torch.Tensor, first: bool, count, densify: bool) -> torch.Tensor:
        """Grow at ``c2w``, bin the window, map it: the state (the gaussian
        table, ``dead``, ``count_dev``) updated in place. Returns the count."""
        params, dead, count = self.grow_step(self.params, self.dead, count, rgb, depth, c2w, first)
        images, w2cs = self.window(rgb, depth, lie.pose_inverse(c2w), win_slots, n_valid)
        tiles, masks = self.bin_window(params, dead, count, w2cs)
        gp, dead, count, _ = self.map_step(params, dead, count, images, w2cs, tiles, masks, n_valid, picks.shape[0],
                                           picks, densify)
        with torch.no_grad():
            for g in GAUSS_GROUPS:
                self.params[g].copy_(gp[g])
            self.dead.copy_(dead)
            self.count_dev.copy_(count)
        return count

    @torch.no_grad()
    def write_keyframe(self, slot: torch.Tensor, rgb: torch.Tensor, depth: torch.Tensor, w2c: torch.Tensor) -> None:
        """Keyframe row ``slot`` (an index tensor of one entry) of the device
        store: rgb as its uint16 values less 32,768, depth, w2c."""
        q = (rgb * 65535.0 + 0.5).to(torch.int32) - 32768
        self.kf_rgb.index_copy_(0, slot, q.to(torch.int16)[None])
        self.kf_depth.index_copy_(0, slot, depth[None])
        self.kf_w2c.index_copy_(0, slot, w2c[None])

    # ------------------------------------------------------------------
    # the fused per-frame step
    # ------------------------------------------------------------------
    @staticmethod
    def predict_quat(t1: torch.Tensor, q1: torch.Tensor, t2: torch.Tensor, q2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The constant-velocity model on the device, from the last pose (t1,
        q1) and the one before it: delta = P1 inv(P2), pred = delta P1."""
        R1 = lie.quaternion_to_matrix(q1)
        R2 = lie.quaternion_to_matrix(q2)
        dR = R1 @ R2.T
        dt = t1 - dR @ t2
        return dR @ t1 + dt, lie.matrix_to_quaternion(dR @ R1)

    def fused_step(self, rgb: torch.Tensor, depth: torch.Tensor, win_slots: torch.Tensor, n_valid: torch.Tensor,
                   picks: torch.Tensor, kf_slot: torch.Tensor, t1: torch.Tensor, q1: torch.Tensor, t2: torch.Tensor,
                   q2: torch.Tensor, do_kf: bool, densify: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One frame, all on the device: predict the pose from (t1, q1) and
        (t2, q2), bin and track there, grow, map the window (``win_slots``
        [W - 1], ``n_valid`` and ``picks`` [mapping_n_iters] as
        ``window`` and ``map_step`` take them; with ``densify``, clone and
        split) and, when ``do_kf``, write the frame to keyframe row
        ``kf_slot``. Returns (t [1, 3], q [1, 4], the count)."""
        tp, qp = self.predict_quat(t1, q1, t2, q2)
        bt, bq, _ = self.track(self.params, self.dead, self.count_dev, rgb, depth, tp, qp)
        c2w = lie.pose_vec_to_matrix(bt, bq, rot_rep="quat")
        count = self.map_frame(rgb, depth, c2w, win_slots, n_valid, picks, False, self.count_dev, densify)
        if do_kf:
            self.write_keyframe(kf_slot, rgb, depth, lie.pose_inverse(c2w))
        return bt[None], bq[None], count

    def group_call(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                   prev2_c2w: Optional[np.ndarray] = None,
                   prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[Tuple[bool, bool], Callable, List[torch.Tensor]]:
        """The program of a group (one frame), its key ``(do_kf, densify)``
        and its inputs: the frame's images, the window's keyframe slots
        ranked on the host against the newest host pose estimate (which lags
        the device by the frames in flight, as in the reference), n_valid,
        the mapping call's picks, the keyframe slot and the two predecessor
        poses (host matrices, or the device (t, q) of the group before).
        Draws the picks and the ranking's samples."""
        if len(frames) != 1:
            raise ValueError(f"SplaTAM maps every frame: a group is one frame, got {len(frames)}")
        cfg = self.config
        cur = frames[0]
        if prev_tr is None:
            prev_tr, prev2_tr = (tuple(upload(np.asarray(v, np.float32), self.device) for v in
                                       lie_np.matrix_to_pose_vec(np.asarray(c2w, np.float32), rot_rep="quat"))
                                 for c2w in (prev_c2w, prev2_c2w))
        est = self.estimate_c2w_list
        guess = np.asarray(est[-1]) if est else (
            self.kf_frames[-1].get_pose() if self.kf_frames else np.eye(4, dtype=np.float32))
        slots = self._select_window_slots(cur.depth, guess)
        n_valid = len(slots) + 1
        key = (do_kf, bool(cfg.mapping_use_gaussian_splatting_densification))
        if key not in self._programs:
            self._programs[key] = lambda *x: self.fused_step(*x, do_kf=key[0], densify=key[1])
        inputs = [cur.rgb_dev(self.device), cur.depth_dev(self.device),
                  self._index(slots + [0] * (cfg.mapping_window_size - n_valid)), self._index(n_valid),
                  self._draw_picks(n_valid, cfg.mapping_n_iters), self._index([len(self.kf_frames)]),
                  *prev_tr, *prev2_tr]
        return key, self._programs[key], inputs

    def dispatch_superstep(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                           prev2_c2w: Optional[np.ndarray] = None,
                           prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Launch the fused step on ``frames`` (one frame); requires
        ``is_initialized()``. Returns the handle for ``finish_superstep``:
        the device pose (t [1, 3], q [1, 4]) and its copy to the host, with
        the count, under way."""
        if do_kf and len(self.kf_frames) >= self.config.max_keyframes:
            raise RuntimeError("keyframe capacity exceeded; raise max_keyframes")
        if not self._pending:  # nothing in flight: the host count is current
            self.count_dev.fill_(self.model.n_gauss)
        key, program, inputs = self.group_call(frames, do_kf, prev_c2w, prev2_c2w, prev_tr, prev2_tr)
        pt, pq, count = self.graphs(key, program, inputs)
        if do_kf:
            self.kf_frames.append(frames[0])
            self.keyframe_fids.append(frames[0].fid)
        # finish order is dispatch order: the finish of this frame gives a
        # keyframe its host pose (the device store has it already)
        self._pending.append(frames[0] if do_kf else None)
        return pt, pq, PendingFetch(pt, pq, count)

    def finish_superstep(self, handle) -> List[np.ndarray]:
        """The frame's pose fetch -> [its c2w]; the host count catches up."""
        pt, pq, count = handle[2].wait()
        keyframe = self._pending.pop(0)
        self.model.n_gauss = int(count)
        c2w = lie_np.pose_vec_to_matrix(pt[0], pq[0], rot_rep="quat")
        if keyframe is not None:
            keyframe.set_pose(c2w)
        return [c2w]

    _torch_generators = ("generator", "noise_generator")
    _numpy_generators = ("rng",)

    def _named_state(self) -> Dict[str, List[torch.Tensor]]:
        """The state tensors; the keyframe store and the count last."""
        return {"params": [self.params[g] for g in GAUSS_GROUPS], "dead": [self.dead], "kf_rgb": [self.kf_rgb],
                "kf_depth": [self.kf_depth], "kf_w2c": [self.kf_w2c], "count_dev": [self.count_dev]}

    def host_state(self) -> Dict[str, Any]:
        """The base's, the model's host count and scene radius, and each
        keyframe's id and pose (what the window's ranking reads of it)."""
        d = super().host_state()
        d["model_attrs"] = {"n_gauss": self.model.n_gauss, "scene_radius": self.model.scene_radius}
        d["kf_frames"] = [(f.fid, f.rot_rep, f.t.copy(), f.r.copy()) for f in self.kf_frames]
        return d

    def restore_host_state(self, d: Dict[str, Any]) -> None:
        super().restore_host_state(d)
        for k, v in d.pop("model_attrs").items():
            setattr(self.model, k, v)
        self.kf_frames = []
        for fid, rot_rep, t, r in d.pop("kf_frames"):
            f = Frame(fid=fid, rgb=None, depth=None, rot_rep=rot_rep)
            f.t, f.r = t, r
            self.kf_frames.append(f)

    # ------------------------------------------------------------------
    # host API (called by the pipeline)
    # ------------------------------------------------------------------
    def _frame_pose(self, frame: Frame) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._tensor(frame.t), self._tensor(frame.r)

    def dispatch_tracking(self, cur_frame: Frame) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.is_initialized():
            return None
        bt, bq, _ = self.track(self.params, self.dead, self.n_gauss, cur_frame.rgb_dev(self.device),
                               cur_frame.depth_dev(self.device), *self._frame_pose(cur_frame))
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
        slots = self._select_window_slots(cur_frame.depth, cur_frame.get_pose())
        n_valid = len(slots) + 1
        c2w = lie.pose_vec_to_matrix(*self._frame_pose(cur_frame), rot_rep="quat")
        count = self.map_frame(cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device), c2w,
                               self._index(slots + [0] * (cfg.mapping_window_size - n_valid)), n_valid,
                               self._draw_picks(n_valid, cfg.mapping_first_n_iters if first else cfg.mapping_n_iters),
                               first, self.n_gauss, cfg.mapping_use_gaussian_splatting_densification)
        self.model.n_gauss = int(count)
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

    def add_keyframe(self, keyframe: Frame) -> None:
        slot = len(self.kf_frames)
        if slot >= self.config.max_keyframes:
            raise RuntimeError("keyframe capacity exceeded; raise max_keyframes")
        self.kf_frames.append(keyframe)
        self.keyframe_fids.append(keyframe.fid)
        w2c = lie.pose_inverse(lie.pose_vec_to_matrix(*self._frame_pose(keyframe), rot_rep="quat"))
        self.write_keyframe(self._index([slot]), keyframe.rgb_dev(self.device), keyframe.depth_dev(self.device), w2c)

    def render_img(self, c2w: np.ndarray, gt_depth: Optional[np.ndarray] = None, idx: Optional[int] = None):
        """(rgb [H, W, 3] in [0, 1], depth [H, W]) rendered at ``c2w``, zeroed
        where ``gt_depth`` has no measurement. ``idx`` (the frame's index) is
        unused, as in the reference."""
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
