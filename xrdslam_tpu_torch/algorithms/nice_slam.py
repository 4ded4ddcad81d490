"""NICE-SLAM: hierarchical feature-grid SLAM with staged coarse-to-fine mapping.

Counterpart of ``xrdslam_tpu/algorithms/nice_slam.py``: the per-frame path
(``dispatch_tracking`` / ``finish_tracking``, ``do_mapping``,
``add_keyframe``, ``render_img``, ``get_mesh``) and the fused group step
(``fused_step``, ``dispatch_superstep`` / ``finish_superstep``). The
structure is the reference package's:

  * keyframe images live in a fixed-capacity device table ``kf_images
    [max_kf, H, W, 4]`` (rgb + depth), their poses in ``kf_pose [max_kf,
    7]`` (t, quaternion) with a host mirror ``kf_pose_host`` for the
    overlap ranking (in the group path it may lag the device);
  * a mapping call runs the middle, fine and colour phases (or the coarse
    one) with the stage learning rates of ``NiceSLAMSchedulerConfig``
    times ``lr_factor`` and one Adam state across its phases, restarted at
    each call. A group whose stage lr is 0 still advances its moments,
    as optax does;
  * each iteration renders ``max(mapping_sample // S, min_sample_pixels)``
    random pixels of each of the S slots of a static window, spread over
    its ``n_valid`` real frames by ``window_slot_frame``; the oldest
    window pose is held fixed;
  * the frustum masks multiply the grid gradients before the finite guard;
  * tracking optimises the pose vector against the frozen map (it
    differentiates the pose alone, so it takes no grid gradient) and keeps
    the pose of lowest loss, the quaternion renormalised after each step.

The optimization loops are Python loops of eager device work with no host
sync, and every tensor that outlives a step is written in place, so a step
can be captured into a CUDA graph. The group step runs one
``map_every``-frame group (predict and track the head, its frustum masks,
the fine window's mapping, the coarse window's, the keyframe, the tail's
tracking) as one program: on the CPU eagerly, on the card as a CUDA graph
captured once per ``(group, optimize_pose, do_kf)`` and replayed
(``engine/graphs.py``). Its poses reach the host once per group.

Random numbers come from a device ``torch.Generator`` (pixel samples) and
a numpy ``Generator`` (window and overlap picks), both seeded from
``config.seed``; they are not the reference's ``jax.random`` draws.
``track_step`` and ``map_step`` take pre-drawn samples, so that a test can
feed both packages the same pixels.
"""
from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame
from ..common.mesher import Mesher, MesherConfig
from ..engine.graphs import GraphReplay, PendingFetch
from ..engine.optimizers import AdamOptimizerConfig, GroupOptimizers, OptimizerConfig
from ..engine.schedulers import NiceSLAMSchedulerConfig
from ..models.conv_onet import ConvOnet, ConvOnetConfig
from ..ops import lie, lie_np
from ..ops.frustum import points_in_frustum
from ..ops.sampling import camera_ray_dirs, sample_pixels
from ..utils.io import Mesh
from .base import Algorithm, AlgorithmConfig

Samples = Sequence[Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class NiceSLAMConfig(AlgorithmConfig):
    """The reference's NiceSLAMConfig."""

    _target: Type = field(default_factory=lambda: NiceSLAM)
    model: ConvOnetConfig = field(default_factory=ConvOnetConfig)
    mesher: MesherConfig = field(default_factory=MesherConfig)
    coarse: bool = False
    keyframe_selection_method: str = "overlap"  # or "random"
    mapping_sample: int = 2048
    min_sample_pixels: int = 100
    tracking_sample: int = 1024
    ray_batch_size: int = 3000  # rays per chunk of render_img
    marching_cubes_bound: List[List[float]] = field(default_factory=lambda: [[-3.5, 3], [-3, 3], [-3, 3]])
    mapping_bound: List[List[float]] = field(default_factory=lambda: [[-3.5, 3], [-3, 3], [-3, 3]])
    tracking_Wedge: int = 100
    tracking_Hedge: int = 100
    mapping_middle_iter_ratio: float = 0.4
    mapping_fine_iter_ratio: float = 0.6
    mapping_lr_factor: float = 1.0
    mapping_lr_first_factor: float = 5.0
    mapping_color_refine: bool = True
    max_keyframes: int = 64
    seed: int = 0


class NiceSLAM(Algorithm):
    config: NiceSLAMConfig

    def __init__(self, config: NiceSLAMConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        config.model.coarse = config.coarse
        self.bounding_box = np.asarray(config.mapping_bound, np.float32)
        # weights are drawn on the CPU so that a seed gives the same initial
        # model on every device
        init_gen = torch.Generator().manual_seed(config.seed)
        self.model = ConvOnet(config.model, camera, self.bounding_box, generator=init_gen).to(self.device)
        self.mesher: Mesher = config.mesher.setup(camera=camera, bounding_box=self.model.bounding_box,
                                                  marching_cubes_bound=np.asarray(config.marching_cubes_bound,
                                                                                  np.float32))
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.rng = np.random.default_rng(config.seed)
        self._opt_cfgs = {name: g["optimizer"] for name, g in config.optimizers.items()}
        self.max_kf = config.max_keyframes
        H, W = camera.height, camera.width
        self.kf_images = torch.zeros((self.max_kf, H, W, 4), device=self.device)
        self.kf_pose = torch.zeros((self.max_kf, 7), device=self.device)  # t + quaternion
        self.kf_pose_host = np.zeros((self.max_kf, 7), np.float32)
        self.kf_count = 0
        self._dirs = camera_ray_dirs(camera, self.device)
        self._clamped_poses = 0
        self._kf_slot_fifo: List[Optional[int]] = []  # finish order is dispatch order
        self._programs: Dict[Tuple[int, bool, bool], Callable] = {}
        self.graphs = GraphReplay(self.generator)

    # ------------------------------------------------------------------
    # per-group stage learning rates
    # ------------------------------------------------------------------
    def _stage_lr(self, group: str, stage: str, lr_factor: float) -> float:
        g = self.config.optimizers.get(group)
        if g is None:
            return 0.0
        sched = g.get("scheduler")
        if isinstance(sched, NiceSLAMSchedulerConfig):
            return lr_factor * sched.lr_for_stage(stage)
        return g["optimizer"].lr

    def _phase_groups(self, stage: str, lr_factor: float, optimize_pose: bool, coarse: bool
                      ) -> Dict[str, OptimizerConfig]:
        groups: Dict[str, OptimizerConfig] = {}
        for g in self._grid_names(coarse):
            base = self.config.optimizers.get(g, {"optimizer": AdamOptimizerConfig()})["optimizer"]
            groups[g] = dataclasses.replace(base, lr=self._stage_lr(g, stage, lr_factor))
        if not coarse and self.model.trainable_decoders:
            cfg = dataclasses.replace(self._opt_cfgs["decoder"], lr=self._stage_lr("decoder", stage, lr_factor))
            if not self.model.pretrained_available:
                # decoders trained from scratch train in every stage, at the
                # colour stage's MLP-safe lr where their own is 0 (the grids'
                # first-frame lr blows a 5-block MLP up within a few steps),
                # clipped in every stage so that the clip is the same
                # transformation in all of a call's phases
                if cfg.lr == 0.0:
                    cfg.lr = self._stage_lr("decoder", "color", 1.0)
                cfg.max_norm = cfg.max_norm or 10.0
            groups["decoder"] = cfg
        if optimize_pose and not coarse:
            groups["pose"] = dataclasses.replace(self._opt_cfgs["mapping_pose"],
                                                 lr=self._stage_lr("mapping_pose", stage, lr_factor))
        return groups

    def _grid_names(self, coarse: bool) -> List[str]:
        return [g for g in self.model.grid_shapes if (g == "grid_coarse") == coarse]

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    def ray_prefilter_mask(self, rays_o: torch.Tensor, rays_d: torch.Tensor, td: torch.Tensor) -> torch.Tensor:
        """1 for rays that leave the (enlarged) bound no earlier than their
        depth, else 0."""
        t = (self.model.bound[None] - rays_o[:, :, None]) / rays_d[:, :, None]
        t_exit = torch.amin(torch.amax(t, dim=2), dim=1)
        return (t_exit >= td[:, 0]).to(torch.float32)

    def track_step(self, rgb: torch.Tensor, depth: torch.Tensor, pose0: torch.Tensor,
                   samples: Optional[Samples] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tracking_n_iters`` Adam steps on the pose vector [7] (t, q)
        against the frozen map, on ``tracking_sample`` interior pixels each
        (``samples[i]`` = (u, v) when given), the quaternion renormalised
        after each step. Returns the pose of lowest loss seen and that loss."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        opt_cfg = self._opt_cfgs["tracking_pose"]
        sched = self._tracking_lr_schedule(opt_cfg.lr)
        opt = GroupOptimizers({"tracking_pose": opt_cfg}, schedules={"tracking_pose": sched} if sched else None)
        pose = pose0.clone().requires_grad_(True)
        params = {"tracking_pose": [pose]}
        state = opt.init(params)
        best_loss = torch.full((), 1e10, device=pose0.device)
        best_pose = pose0.clone()
        for it in range(cfg.tracking_n_iters):
            if samples is None:
                u, v = sample_pixels(cfg.tracking_sample, H, W, cfg.tracking_Hedge, cfg.tracking_Wedge,
                                     self.generator, self.device)
            else:
                u, v = samples[it]
            td = depth[v, u][:, None]
            rays_d = self._dirs[v, u] @ lie.quaternion_to_matrix(pose[3:]).T
            rays_o = pose[:3].expand(rays_d.shape)
            rm = self.ray_prefilter_mask(rays_o, rays_d, td)
            loss, _ = self.model.get_loss(rays_o, rays_d, rgb[v, u], td, rm, False, "color")
            (g,) = torch.autograd.grad(loss, [pose])
            with torch.no_grad():
                loss = loss.detach()
                better = loss < best_loss
                best_loss = torch.where(better, loss, best_loss)
                best_pose = torch.where(better, pose, best_pose)
            opt.update({"tracking_pose": self._finite_guard(loss, [g])}, state, params)
            with torch.no_grad():
                pose[3:] /= torch.clamp(torch.linalg.norm(pose[3:]), min=1e-8)
        return best_pose, best_loss

    def _phases(self, n_iters: int, coarse: bool) -> List[Tuple[str, int]]:
        if coarse:
            return [("coarse", n_iters)]
        cfg = self.config
        m_end = int(cfg.mapping_middle_iter_ratio * n_iters)
        f_end = int(cfg.mapping_fine_iter_ratio * n_iters)
        return [("middle", m_end), ("fine", f_end - m_end), ("color", n_iters - f_end)]

    def map_step(self, images: torch.Tensor, poses: torch.Tensor, masks: Dict[str, torch.Tensor], n_valid,
                 n_iters: int, lr_factor: float, optimize_pose: bool, coarse: bool,
                 samples: Optional[Samples] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One mapping call on the window ``images`` [S, H, W, 4], ``poses``
        [S, 7], the first ``n_valid`` (an int or a device tensor) real: the
        middle, fine and colour phases (or, with ``coarse``, the coarse one)
        of ``n_iters`` Adam steps in all, one Adam state across them, on the
        map in place and, with ``optimize_pose``, on the window's poses
        (the oldest fixed). ``masks`` multiply the grid gradients.
        ``samples[i]`` = (u, v) [S, pixels] when given. Returns the poses,
        any non-finite entry put back to its input, and the count of rows
        that had one."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        n_slots = images.shape[0]
        pixs = max(cfg.mapping_sample // n_slots, cfg.min_sample_pixels)
        dev = images.device
        slots = torch.arange(n_slots, device=dev)
        fi = ((slots + 1) * n_valid - 1) // n_slots  # window_slot_frame, for a device n_valid too
        frame_of_ray = fi.repeat_interleave(pixs)
        # slot poses as a one-hot product: a gather whose backward sums in a
        # fixed order on the card
        sel = (fi[:, None] == slots[None, :]).to(poses.dtype)
        params = {g: [self.model.grids[g]] for g in self._grid_names(coarse)}
        if not coarse and self.model.trainable_decoders:
            params["decoder"] = self.model.param_groups()["decoder"]
        pose = None
        if optimize_pose and not coarse:
            pose = poses.clone().requires_grad_(True)
            params["pose"] = [pose]
        flat = [p for ps in params.values() for p in ps]
        group_of = [name for name, ps in params.items() for _ in ps]
        if not cfg.model.mapping_frustum_feature_selection or coarse:
            masks = {}
        state = None
        it = 0
        for stage, steps in self._phases(n_iters, coarse):
            if steps <= 0:
                continue
            opt = GroupOptimizers(self._phase_groups(stage, lr_factor, optimize_pose, coarse))
            if state is None:
                state = opt.init(params)
            for _ in range(steps):
                if samples is None:
                    u, v = sample_pixels(n_slots * pixs, H, W, generator=self.generator, device=dev)
                else:
                    u, v = (s.reshape(-1) for s in samples[it])
                it += 1
                px = images[frame_of_ray, v, u]
                pz = poses if pose is None else torch.cat([pose[:1].detach(), pose[1:]], 0)
                ps = sel @ pz  # [S, 7]
                rays_d = (self._dirs[v, u].reshape(n_slots, pixs, 3)
                          @ lie.quaternion_to_matrix(ps[:, 3:]).transpose(-1, -2)).reshape(-1, 3)
                rays_o = ps[:, None, :3].expand(n_slots, pixs, 3).reshape(-1, 3)
                td = px[:, 3:4]
                rm = self.ray_prefilter_mask(rays_o, rays_d, td)
                loss, _ = self.model.get_loss(rays_o, rays_d, px[:, :3], td, rm, True, stage)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else (g * masks[name] if name in masks else g)
                         for p, g, name in zip(flat, grads, group_of)]
                grads = self._finite_guard(loss.detach(), grads)
                grouped: Dict[str, List[torch.Tensor]] = {}
                for name, ps_ in params.items():
                    grouped[name], grads = grads[:len(ps_)], grads[len(ps_):]
                opt.update(grouped, state, params)
                if pose is not None:
                    with torch.no_grad():
                        pose[:, 3:] /= torch.clamp(torch.linalg.norm(pose[:, 3:], dim=-1, keepdim=True), min=1e-8)
        new_poses = poses if pose is None else pose.detach()
        # a non-finite optimized pose must not reach the keyframe table
        bad = torch.any(~torch.isfinite(new_poses), dim=-1)
        new_poses = torch.where(torch.isfinite(new_poses), new_poses, poses)
        return new_poses, bad.sum()

    # ------------------------------------------------------------------
    # the fused group step
    # ------------------------------------------------------------------
    def fused_step(self, rgbs: Sequence[torch.Tensor], depths: Sequence[torch.Tensor], fine_slots: torch.Tensor,
                   coarse_slots: torch.Tensor, n_valid_f: torch.Tensor, n_valid_c: torch.Tensor,
                   prev_pose: torch.Tensor, prev2_pose: torch.Tensor, kf_slot: torch.Tensor, optimize_pose: bool,
                   do_kf: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One group of ``len(rgbs)`` frames, all on the device: predict the
        head from (prev, prev2) and track it; its frustum masks; map the fine
        window (``fine_slots`` [window - 1], ``n_valid_f``) and write its
        optimised keyframe poses back (padded slots dropped); map the coarse
        window (``coarse_slots`` [window - 1], ``n_valid_c``); when
        ``do_kf``, insert the head at keyframe row ``kf_slot`` [1]; track
        each tail frame from the prediction of the two poses before it.
        Returns (t [G, 3], q [G, 4]; the head's as mapped) and the count of
        clamped non-finite poses."""
        cfg = self.config
        n_iters, lr_factor = cfg.mapping_n_iters, cfg.mapping_lr_factor
        best, _ = self.track_step(rgbs[0], depths[0], self.predict_q(prev_pose, prev2_pose))
        cur_img = torch.cat([rgbs[0], depths[0][..., None]], -1)
        masks = {}
        if cfg.model.mapping_frustum_feature_selection:
            c2w = lie.pose_vec_to_matrix(best[:3], best[3:], rot_rep="quat")
            masks = self.model.frustum_grid_masks_dev(c2w, depths[0])
        images, poses = self.window_arrays(fine_slots, n_valid_f, cur_img, best)
        new_poses, n_clamped = self.map_step(images, poses, masks, n_valid_f, n_iters, lr_factor, optimize_pose,
                                             False)
        with torch.no_grad():
            if optimize_pose:
                # each real slot's row takes its optimised pose; padded slots
                # (which may repeat a real slot's index) write nothing
                wn1 = fine_slots.shape[0]
                real = torch.arange(wn1, device=fine_slots.device) < n_valid_f - 1
                hit = (fine_slots[:, None] == torch.arange(self.max_kf, device=fine_slots.device)[None]) & real[:, None]
                rows = torch.index_select(new_poses[:wn1], 0, torch.argmax(hit.to(torch.int32), 0))
                self.kf_pose.copy_(torch.where(hit.any(0)[:, None], rows, self.kf_pose))
            cur_pose = torch.index_select(new_poses, 0, (n_valid_f - 1).reshape(1))[0]
        if cfg.coarse:
            images_c, poses_c = self.window_arrays(coarse_slots, n_valid_c, cur_img, cur_pose)
            _, ncl_c = self.map_step(images_c, poses_c, {}, n_valid_c, n_iters, lr_factor, False, True)
            n_clamped = n_clamped + ncl_c
        if do_kf:
            with torch.no_grad():
                self.kf_images.index_copy_(0, kf_slot, cur_img[None])
                self.kf_pose.index_copy_(0, kf_slot, cur_pose[None])
        poses_out = [cur_pose]
        p1, p2 = cur_pose, prev_pose
        for rgb, depth in zip(rgbs[1:], depths[1:]):
            bj, _ = self.track_step(rgb, depth, self.predict_q(p1, p2))
            poses_out.append(bj)
            p1, p2 = bj, p1
        out = torch.stack(poses_out)
        return out[:, :3], out[:, 3:], n_clamped

    def _coarse_slots(self) -> List[int]:
        """The coarse window's keyframes: ``window - 2`` random ones and the newest."""
        k = self.config.mapping_window_size - 2
        slots = sorted(int(s) for s in self.rng.permutation(max(self.kf_count - 1, 0))[:k])
        return slots + ([self.kf_count - 1] if self.kf_count else [])

    def group_call(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                   prev2_c2w: Optional[np.ndarray] = None,
                   prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[Tuple[int, bool, bool], Callable, List[torch.Tensor]]:
        """The group program on ``frames``, its key ``(group,
        optimize_pose, do_kf)`` and its inputs: the G images, the G depths,
        the fine window's slots (ranked on the host against the newest host
        pose estimate, which lags the device by the groups in flight) and the
        coarse window's, each padded, their ``n_valid``, the predecessor
        poses (host matrices, or the device (t, q) of the group before) and
        the keyframe slot. Draws the windows' picks."""
        cfg = self.config
        group = len(frames)
        if prev_tr is None:
            prev_tr, prev2_tr = (tuple(self._tensor(v) for v in lie_np.matrix_to_pose_vec(
                np.asarray(c2w, np.float32), rot_rep="quat")) for c2w in (prev_c2w, prev2_c2w))
        est = self.estimate_c2w_list
        guess = np.asarray(est[-1]) if est else np.eye(4, dtype=np.float32)
        w1 = cfg.mapping_window_size
        fine = self._select_window(frames[0].depth, guess)[-w1:]
        coarse = self._coarse_slots()
        optimize_pose = self.kf_count > 4
        key = (group, optimize_pose, do_kf)
        if key not in self._programs:
            def program(*x: torch.Tensor):
                p1, p2 = torch.cat(x[2 * group + 4:2 * group + 6]), torch.cat(x[2 * group + 6:2 * group + 8])
                return self.fused_step(x[:group], x[group:2 * group], *x[2 * group:2 * group + 4], p1, p2,
                                       x[2 * group + 8], optimize_pose=optimize_pose, do_kf=do_kf)

            self._programs[key] = program
        inputs = ([f.rgb_dev(self.device) for f in frames] + [f.depth_dev(self.device) for f in frames]
                  + [self._index(fine + [0] * (w1 - len(fine))), self._index(coarse + [0] * (w1 - 1 - len(coarse))),
                     self._index(len(fine) + 1), self._index(len(coarse) + 1), *prev_tr, *prev2_tr,
                     self._index([self.kf_count])])
        return key, self._programs[key], inputs

    def dispatch_superstep(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                           prev2_c2w: Optional[np.ndarray] = None,
                           prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Launch the group program on ``frames`` (``frames[0]`` is the head,
        which is mapped); requires ``is_initialized()``. The predecessor
        poses come as host matrices or, so that a dispatch waits for
        nothing, as the device (t, q) of the previous group's output.
        Returns the handle for ``finish_superstep``: the group's device
        poses (t [G, 3], q [G, 4]) and their copy to the host, with the
        clamp count, under way."""
        if do_kf and self.kf_count >= self.max_kf:
            raise RuntimeError(f"keyframe capacity {self.max_kf} exceeded; raise max_keyframes")
        key, program, inputs = self.group_call(frames, do_kf, prev_c2w, prev2_c2w, prev_tr, prev2_tr)
        kf_slot = self.kf_count
        pt, pq, n_clamped = self.graphs(key, program, inputs)
        if do_kf:
            self.kf_count += 1
            self.keyframe_fids.append(frames[0].fid)
        self._kf_slot_fifo.append(kf_slot if do_kf else None)
        return pt, pq, PendingFetch(pt, pq, n_clamped)

    def finish_superstep(self, handle) -> List[np.ndarray]:
        """One pose fetch for the whole group -> its c2w matrices; a new
        keyframe's host pose row catches up."""
        pt, pq, n_clamped = handle[2].wait()
        self._warn_clamped(int(n_clamped))
        slot = self._kf_slot_fifo.pop(0)
        if slot is not None:
            self.kf_pose_host[slot] = np.concatenate([pt[0], pq[0]])
        return [lie_np.pose_vec_to_matrix(pt[j], pq[j], rot_rep="quat") for j in range(pt.shape[0])]

    def _warn_clamped(self, n: int) -> None:
        """Report non-finite mapped poses clamped back to their inputs: a
        silent clamp would hide an optimization fault."""
        if n:
            self._clamped_poses += n
            total = self._clamped_poses
            if total <= 50 or total % 50 == 0:
                print(f"[nice-slam] WARNING: clamped {n} non-finite mapped pose(s) back to inputs (total {total})",
                      file=sys.stderr, flush=True)

    _host_state = ("kf_count", "kf_pose_host", "_kf_slot_fifo", "_clamped_poses")
    _torch_generators = ("generator",)
    _numpy_generators = ("rng",)

    def _named_state(self) -> Dict[str, List[torch.Tensor]]:
        """The state tensors; the keyframe table and poses last."""
        return {"model_params": [p for ps in self.model.param_groups().values() for p in ps],
                "kf_images": [self.kf_images], "kf_pose": [self.kf_pose]}

    # ------------------------------------------------------------------
    # host API (called by the pipeline)
    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _index(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64), device=self.device)

    def _pose_vec(self, frame: Frame) -> torch.Tensor:
        return self._tensor(np.concatenate([frame.t, frame.r]))

    def dispatch_tracking(self, cur_frame: Frame) -> Optional[torch.Tensor]:
        if not self.is_initialized():
            return None
        best, _ = self.track_step(cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device),
                                  self._pose_vec(cur_frame))
        return best

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        if handle is None:
            return None
        bp = handle.cpu().numpy()
        return lie_np.pose_vec_to_matrix(bp[:3], bp[3:], rot_rep="quat")

    def _select_window(self, cur_depth: np.ndarray, cur_c2w: np.ndarray) -> List[int]:
        """The fine window's keyframe slots, oldest first: all while they fit
        the window, else ``window - 2`` picked by overlap (or at random) and
        the newest."""
        cfg = self.config
        k = cfg.mapping_window_size - 2
        if self.kf_count <= cfg.mapping_window_size:
            sel = list(range(self.kf_count))
        elif cfg.keyframe_selection_method == "random":
            sel = list(self.rng.permutation(self.kf_count - 1)[:k]) + [self.kf_count - 1]
        else:
            sel = self._overlap_selection(cur_depth, cur_c2w, k) + [self.kf_count - 1]
        return sorted(set(int(s) for s in sel))

    def _overlap_selection(self, depth: np.ndarray, cur_c2w: np.ndarray, k: int, pixs: int = 100,
                           n_samples: int = 16) -> List[int]:
        """Up to ``k`` keyframes (not the newest) picked at random among those
        into whose image (less a 20 px edge) some of ``pixs`` random pixels'
        ray samples from 0.8 d to d + 0.5 project."""
        cam = self.camera
        vs, us = np.where(depth > 0)
        if len(vs) == 0:
            return list(self.rng.permutation(max(self.kf_count - 1, 0))[:k])
        pick = self.rng.integers(0, len(vs), pixs)
        u, v = us[pick].astype(np.float64), vs[pick].astype(np.float64)
        d = depth[vs[pick], us[pick]].astype(np.float64)
        c2w = np.asarray(cur_c2w, np.float64)
        dirs = np.stack([(u - cam.cx) / cam.fx, -(v - cam.cy) / cam.fy, -np.ones_like(u)], -1)
        t_vals = np.linspace(0.0, 1.0, n_samples)
        z = (0.8 * d)[:, None] * (1 - t_vals)[None] + (d + 0.5)[:, None] * t_vals[None]
        pts = (c2w[:3, 3] + (dirs @ c2w[:3, :3].T)[:, None, :] * z[..., None]).reshape(-1, 3)
        visible = []
        for i in range(self.kf_count - 1):
            p = self.kf_pose_host[i]
            w2c = np.linalg.inv(np.asarray(lie_np.pose_vec_to_matrix(p[:3], p[3:], rot_rep="quat"), np.float64))
            pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
            pc[:, 0] *= -1
            zc = pc[:, 2] + 1e-5
            uu = cam.fx * pc[:, 0] / zc + cam.cx
            vv = cam.fy * pc[:, 1] / zc + cam.cy
            edge = 20
            mask = (uu < cam.width - edge) & (uu > edge) & (vv < cam.height - edge) & (vv > edge) & (zc < 0)
            if mask.mean() > 0:
                visible.append(i)
        return list(self.rng.permutation(visible)[:k])

    def _gather_window(self, slots: List[int], cur_img: torch.Tensor, cur_pose: torch.Tensor, pad_to: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = self._index(slots)
        images = torch.cat([self.kf_images[idx], cur_img[None]], 0)
        poses = torch.cat([self.kf_pose[idx], cur_pose[None]], 0)
        return self.pad_window(images, poses, cur_img[None], cur_pose, pad_to)

    def do_mapping(self, cur_frame: Frame) -> None:
        """The fine mapping call (on the last frame, with
        ``mapping_color_refine``, 5 of them on a window twice as large,
        without masks or pose optimisation), then the coarse one."""
        cfg = self.config
        first = not self.is_initialized()
        n_iters = cfg.mapping_first_n_iters if first else cfg.mapping_n_iters
        lr_factor = cfg.mapping_lr_first_factor if first else cfg.mapping_lr_factor
        refine = cur_frame.is_final_frame and cfg.mapping_color_refine and not first
        window_size = cfg.mapping_window_size * 2 if refine else cfg.mapping_window_size
        cur_img = torch.cat([cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device)[..., None]], -1)
        cur_pose = self._pose_vec(cur_frame)
        for _ in range(5 if refine else 1):
            slots = self._select_window(cur_frame.depth, cur_frame.get_pose())[-window_size:]
            n_valid = len(slots) + 1
            images, poses = self._gather_window(slots, cur_img, cur_pose, window_size + 1)
            masks = {}
            if cfg.model.mapping_frustum_feature_selection and not refine:
                masks = {k: self._tensor(v) for k, v in
                         self.model.frustum_grid_masks(cur_frame.get_pose(), cur_frame.depth).items()}
            optimize_pose = self.kf_count > 4 and not refine
            new_poses, n_clamped = self.map_step(images, poses, masks, n_valid, n_iters, lr_factor, optimize_pose,
                                                 False)
            self._warn_clamped(int(n_clamped))
            if optimize_pose:
                idx = self._index(slots)
                self.kf_pose[idx] = new_poses[:len(slots)]
                new_np = new_poses.cpu().numpy()
                self.kf_pose_host[slots] = new_np[:len(slots)]
                cur_pose = new_poses[n_valid - 1].clone()
                cur_frame.t, cur_frame.r = new_np[n_valid - 1, :3].copy(), new_np[n_valid - 1, 3:].copy()
        if cfg.coarse:
            slots = self._coarse_slots()
            images, poses = self._gather_window(slots, cur_img, cur_pose, cfg.mapping_window_size)
            self.map_step(images, poses, {}, len(slots) + 1, n_iters, lr_factor, False, True)
        if first:
            self.set_initialized()

    def add_keyframe(self, keyframe: Frame) -> None:
        if self.kf_count >= self.max_kf:
            raise RuntimeError(f"keyframe capacity {self.max_kf} exceeded; raise max_keyframes")
        slot = self.kf_count
        self.kf_images[slot] = torch.cat([keyframe.rgb_dev(self.device), keyframe.depth_dev(self.device)[..., None]],
                                         -1)
        pose = np.concatenate([keyframe.t, keyframe.r]).astype(np.float32)
        self.kf_pose[slot] = self._tensor(pose)
        self.kf_pose_host[slot] = pose
        self.kf_count += 1
        self.keyframe_fids.append(keyframe.fid)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_img(self, c2w: np.ndarray, gt_depth: Optional[np.ndarray] = None, idx: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb [H, W, 3] in [0, 1], depth [H, W]) rendered at ``c2w`` in the
        colour stage, in chunks of ``ray_batch_size`` rays, with the surface
        samples around ``gt_depth`` where it is given."""
        cam = self.camera
        c2w_t = self._tensor(c2w)
        rays_d = self._dirs.reshape(-1, 3) @ c2w_t[:3, :3].T
        rays_o = c2w_t[:3, 3].expand(rays_d.shape)
        gt = None if gt_depth is None else self._tensor(gt_depth).reshape(-1, 1)
        bs = self.config.ray_batch_size
        depth, color = [], []
        for i in range(0, rays_d.shape[0], bs):
            out = self.model.render_rays(rays_o[i:i + bs], rays_d[i:i + bs], None if gt is None else gt[i:i + bs],
                                         "color")
            depth.append(out["depth"])
            color.append(out["rgb"])
        rgb = torch.clamp(torch.cat(color), 0, 1).reshape(cam.height, cam.width, 3)
        return rgb.cpu().numpy(), torch.cat(depth).reshape(cam.height, cam.width).cpu().numpy()

    @torch.no_grad()
    def get_mesh(self) -> Optional[Mesh]:
        """The mesh of the raw fine occupancy's zero level (occupancy 0.5)
        over ``marching_cubes_bound``, vertex colours from the colour stage,
        grid cells outside every keyframe's frustum (up to 12 m) masked out."""
        kf_mask_fn = None
        if self.kf_count > 0:
            kf_pose = self.kf_pose[:self.kf_count].cpu().numpy()
            kf_c2w = [lie_np.pose_vec_to_matrix(p[:3], p[3:], rot_rep="quat") for p in kf_pose]

            def kf_mask_fn(pts):
                return points_in_frustum(pts, kf_c2w, self.camera, near=0.0, far=12.0)

        def query(fn):
            return lambda pts: fn(torch.as_tensor(pts, device=self.device)).cpu().numpy()

        return self.mesher.get_mesh(
            query_fn=query(lambda p: self.model.query_raw(p, "fine")[..., 3]),
            color_fn=query(lambda p: torch.clamp(self.model.query_raw(p, "color")[..., :3], 0.0, 1.0)),
            point_mask_fn=kf_mask_fn)
