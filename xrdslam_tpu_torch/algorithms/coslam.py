"""Co-SLAM: joint coordinate + parametric encoding SLAM on the device.

Counterpart of ``xrdslam_tpu/algorithms/coslam.py``: the per-frame path,
the fused group step (``super_step``, ``dispatch_superstep`` /
``finish_superstep``), the full-image render and the mesh. The structure
is the reference package's:

  * the global keyframe ray store is a fixed-capacity device table
    ``kf_rays [max_kf, R, 7]`` (dirs, rgb, depth); its count is kept twice,
    on the device (``kf_count_dev``, which the steps read: the keyframe-ray
    draw, the current-frame pixel count, the insertion slot) and on the
    host (``kf_count``: ``_cur_cap``, the capacity check, the mesh);
  * keyframe poses are rows of ``[max_kf, 3]`` axis-angle/translation
    tensors, gathered per ray, so mapping pose gradients arrive as
    scatter-adds;
  * the oldest keyframe's pose is fixed by detaching row 0;
  * the current-frame pixel batch of a mapping call has a power-of-two
    capacity and a mask over the live count (``_cur_cap``);
  * tracking packs the scene encoding's gather layout once per call
    (``pack_tables``), as constants: its backward computes no table
    gradient.

The optimization loops are Python loops of eager device work: no host
sync inside them, and every tensor that outlives a step is written in
place, so a step can be captured into a CUDA graph. The group step runs
one ``map_every``-frame group (track the head, map it, insert the
keyframe, track the tail, each tail frame seeded on the device by the
constant-velocity model ``_predict``) as one program: on the CPU eagerly,
on the card as a CUDA graph captured once per ``(group, do_kf, cur_cap)``
and replayed (``engine/graphs.py``). Its poses reach the host once per
group.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame
from ..common.mesher import Mesher, MesherConfig
from ..engine.graphs import GraphReplay, PendingFetch
from ..engine.optimizers import GroupOptimizers
from ..models.joint_encoding import JointEncoding, JointEncodingConfig
from ..ops import lie, lie_np
from ..ops.frustum import points_in_frustum
from ..utils.io import Mesh
from ..ops.sampling import camera_ray_dirs, sample_pixels
from .base import Algorithm, AlgorithmConfig

MODEL_GROUPS = ("embed_fn", "decoder")


@dataclass
class CoSLAMConfig(AlgorithmConfig):
    _target: Type = field(default_factory=lambda: CoSLAM)
    model: JointEncodingConfig = field(default_factory=JointEncodingConfig)
    mesher: MesherConfig = field(default_factory=MesherConfig)
    rays_to_save_ratio: float = 0.05
    tracking_Wedge: int = 20
    tracking_Hedge: int = 20
    mapping_sample: int = 2048
    min_sample_pixels: int = 100
    tracking_sample: int = 1024
    ray_batch_size: int = 3000  # rays per chunk of render_img
    marching_cubes_bound: List[List[float]] = field(default_factory=lambda: [[-3.5, 3], [-3, 3], [-3, 3]])
    mapping_bound: List[List[float]] = field(default_factory=lambda: [[-3.5, 3], [-3, 3], [-3, 3]])
    max_keyframes: int = 512  # capacity of the keyframe ray table
    seed: int = 0


class CoSLAM(Algorithm):
    def __init__(self, config: CoSLAMConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        self.config: CoSLAMConfig = config
        self.bounding_box = np.asarray(config.mapping_bound, np.float32)
        # weights are drawn on the CPU so that a seed gives the same initial
        # model on every device; the run's draws come from a device generator
        init_gen = torch.Generator().manual_seed(config.seed)
        self.model = JointEncoding(config.model, camera, self.bounding_box, generator=init_gen).to(self.device)
        self.mesher: Mesher = config.mesher.setup(camera=camera, bounding_box=self.bounding_box,
                                                  marching_cubes_bound=np.asarray(config.marching_cubes_bound,
                                                                                  np.float32))
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)

        self._opt_cfgs = {name: g["optimizer"] for name, g in config.optimizers.items()}
        # the map's Adam state persists across mapping calls: its step count
        # lives on the device, so that a replayed step advances it
        self.model_opt = GroupOptimizers({g: self._opt_cfgs[g] for g in MODEL_GROUPS}, device_count=MODEL_GROUPS)
        self.model_opt_state = self.model_opt.init(self.model.param_groups())

        self.num_rays_to_save = int(camera.width * camera.height * config.rays_to_save_ratio)
        self.max_kf = config.max_keyframes
        self.kf_rays = torch.zeros((self.max_kf, self.num_rays_to_save, 7), device=self.device)
        self.kf_pose_t = torch.zeros((self.max_kf, 3), device=self.device)
        self.kf_pose_r = torch.zeros((self.max_kf, 3), device=self.device)
        self.kf_count = 0
        self.kf_count_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self._dirs = camera_ray_dirs(camera, self.device)  # [H, W, 3] camera-frame dirs
        self._super_steps: Dict[Tuple[int, bool, int], Callable] = {}
        self.graphs = GraphReplay(self.generator)

    def _pose(self, v: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------
    def track_step(self, rgb: torch.Tensor, depth: torch.Tensor, t0: torch.Tensor, r0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``tracking_n_iters`` Adam steps on the pose against the frozen map.
        Returns the pose of lowest loss seen (t, r) and that loss."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        names = ("tracking_pose_r", "tracking_pose_t")
        scheds = {n: self._tracking_lr_schedule(self._opt_cfgs[n].lr) for n in names}
        opt = GroupOptimizers({n: self._opt_cfgs[n] for n in names},
                              schedules={n: s for n, s in scheds.items() if s is not None})
        r = r0.clone().requires_grad_(True)
        t = t0.clone().requires_grad_(True)
        params = {"tracking_pose_r": [r], "tracking_pose_t": [t]}
        state = opt.init(params)
        best_loss = torch.full((), 1e10, device=self.device)
        best_t, best_r = t0.clone(), r0.clone()
        # the tables are constant here: pack them once per call
        packed = self.model.pack_tables()
        for _ in range(cfg.tracking_n_iters):
            u, v = sample_pixels(cfg.tracking_sample, H, W, cfg.tracking_Hedge, cfg.tracking_Wedge,
                                 self.generator, self.device)
            rays_d = self._dirs[v, u] @ lie.axis_angle_to_matrix(r).T
            rays_o = t.expand(rays_d.shape)
            loss, _ = self.model.get_loss(rays_o, rays_d, rgb[v, u], depth[v, u][:, None], None, False, False,
                                          generator=self.generator, packed=packed)
            g_r, g_t = torch.autograd.grad(loss, [r, t])
            with torch.no_grad():
                loss = loss.detach()
                better = loss < best_loss
                best_loss = torch.where(better, loss, best_loss)
                best_t = torch.where(better, t, best_t)
                best_r = torch.where(better, r, best_r)
            g_r, g_t = self._finite_guard(loss, [g_r, g_t])
            opt.update({"tracking_pose_r": [g_r], "tracking_pose_t": [g_t]}, state, params)
        return best_t, best_r, best_loss

    # ------------------------------------------------------------------
    # mapping
    # ------------------------------------------------------------------
    def _cur_cap(self) -> int:
        """Power-of-two capacity for the live current-frame pixel count."""
        cfg = self.config
        need = max(cfg.mapping_sample // max(self.kf_count, 1), cfg.min_sample_pixels)
        cap = 128
        while cap < need:
            cap *= 2
        return min(cap, cfg.mapping_sample)

    def map_step(self, rgb: torch.Tensor, depth: torch.Tensor, cur_t: torch.Tensor, cur_r: torch.Tensor,
                 n_iters: int, first: bool, cur_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n_iters`` joint steps on the map and (after the first frame) on
        all keyframe poses and the current pose. The model groups' Adam state
        persists across calls; the pose groups' starts fresh. Returns the
        current pose (t, r)."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        R = self.num_rays_to_save
        groups = {g: self._opt_cfgs[g] for g in MODEL_GROUPS}
        params = self.model.param_groups()
        opt_state = dict(self.model_opt_state)
        if not first:
            kf_r = self.kf_pose_r.clone().requires_grad_(True)
            kf_t = self.kf_pose_t.clone().requires_grad_(True)
            cur_r = cur_r.clone().requires_grad_(True)
            cur_t = cur_t.clone().requires_grad_(True)
            params["mapping_pose_r"] = [kf_r, cur_r]
            params["mapping_pose_t"] = [kf_t, cur_t]
            for g in ("mapping_pose_r", "mapping_pose_t"):
                groups[g] = self._opt_cfgs[g]
        opt = GroupOptimizers(groups)
        for g in params:
            if g not in opt_state:
                opt_state[g] = opt.init_group(g, params[g])
        flat = [p for g in params for p in params[g]]

        kf_rays_flat = self.kf_rays.reshape(-1, 7)
        kf_count = self.kf_count_dev
        n_kf_rays = torch.clamp(kf_count * R, min=1)
        # the reference samples max(mapping_sample // kf_count, min_sample_pixels)
        # current-frame pixels; the batch holds cur_cap of them, the rest masked
        if first:
            cur_n = cur_cap
        else:
            cur_n = torch.clamp(cfg.mapping_sample // torch.clamp(kf_count, min=1), min=cfg.min_sample_pixels,
                                max=cur_cap)
        cur_mask = (torch.arange(cur_cap, device=self.device) < cur_n).float()
        kf_mask = (kf_count > 0).float().expand(cfg.mapping_sample)
        for _ in range(n_iters):
            u, v = sample_pixels(cur_cap, H, W, generator=self.generator, device=self.device)
            cur_td = depth[v, u][:, None]
            cur_ts = rgb[v, u]
            rays_d = self._dirs[v, u] @ lie.axis_angle_to_matrix(cur_r).T
            rays_o = cur_t.expand(rays_d.shape)
            if first:
                loss, _ = self.model.get_loss(rays_o, rays_d, cur_ts, cur_td, cur_mask, True, True,
                                              generator=self.generator)
            else:
                # uniform in [0, n_kf_rays) for a count on the device: a 62-bit
                # draw modulo the count (bias below 2^-40 at any table size)
                idx = torch.randint(0, 2**62, (cfg.mapping_sample,), generator=self.generator,
                                    device=self.device) % n_kf_rays
                rays = kf_rays_flat[idx]
                fi = idx // R
                # the oldest keyframe's pose is fixed
                kr = torch.cat([kf_r[:1].detach(), kf_r[1:]], 0)
                kt = torch.cat([kf_t[:1].detach(), kf_t[1:]], 0)
                rays_d_kf = torch.einsum("nij,nj->ni", lie.axis_angle_to_matrix(kr[fi]), rays[:, :3])
                loss, _ = self.model.get_loss(
                    torch.cat([kt[fi], rays_o], 0), torch.cat([rays_d_kf, rays_d], 0),
                    torch.cat([rays[:, 3:6], cur_ts], 0), torch.cat([rays[:, 6:7], cur_td], 0),
                    torch.cat([kf_mask, cur_mask], 0), True, False, generator=self.generator)
            grads = self._finite_guard(loss.detach(), list(torch.autograd.grad(loss, flat)))
            grouped: Dict[str, List[torch.Tensor]] = {}
            for g in params:
                grouped[g], grads = grads[:len(params[g])], grads[len(params[g]):]
            opt.update(grouped, opt_state, params)

        self.model_opt_state = {g: opt_state[g] for g in MODEL_GROUPS}
        if not first:
            # in place: a captured step writes the tensors that it read
            self.kf_pose_r.copy_(kf_r.detach())
            self.kf_pose_t.copy_(kf_t.detach())
        return cur_t.detach(), cur_r.detach()

    def add_kf(self, rgb: torch.Tensor, depth: torch.Tensor, t: torch.Tensor, r: torch.Tensor) -> None:
        """The keyframe insertion on the device: R random rays of a frame
        and its pose (t, r) into keyframe row ``kf_count_dev``, which then
        advances. The host count is the caller's."""
        H, W = self.camera.height, self.camera.width
        slot = self.kf_count_dev.reshape(1)
        idx = torch.randint(0, H * W, (self.num_rays_to_save,), generator=self.generator, device=self.device)
        rays = torch.cat([self._dirs.reshape(-1, 3)[idx], rgb.reshape(-1, 3)[idx], depth.reshape(-1)[idx][:, None]], -1)
        self.kf_rays.index_copy_(0, slot, rays[None])
        self.kf_pose_t.index_copy_(0, slot, t.reshape(1, 3))
        self.kf_pose_r.index_copy_(0, slot, r.reshape(1, 3))
        self.kf_count_dev.add_(1)

    # ------------------------------------------------------------------
    # the fused group step
    # ------------------------------------------------------------------
    _predict = staticmethod(lie.predict_constant_velocity)

    def super_step(self, rgbs: Sequence[torch.Tensor], depths: Sequence[torch.Tensor], prev_t: torch.Tensor,
                   prev_r: torch.Tensor, prev2_t: torch.Tensor, prev2_r: torch.Tensor, do_kf: bool, cur_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One group of ``len(rgbs)`` frames, all on the device: track the
        head from the prediction of (prev, prev2), map it, insert it as a
        keyframe when ``do_kf``, then track each tail frame from the
        prediction of the two poses before it. Returns the group's poses
        (t [G, 3], r [G, 3]; the head's as mapped) and its best tracking
        losses [G]. The host's keyframe count is the caller's."""
        cfg = self.config
        bt, br, loss = self.track_step(rgbs[0], depths[0], *self._predict(prev_t, prev_r, prev2_t, prev2_r))
        cur_t, cur_r = self.map_step(rgbs[0], depths[0], bt, br, cfg.mapping_n_iters, False, cur_cap)
        if do_kf:
            self.add_kf(rgbs[0], depths[0], cur_t, cur_r)
        ts, rs, losses = [cur_t], [cur_r], [loss]
        last, before = (cur_t, cur_r), (prev_t, prev_r)
        for rgb, depth in zip(rgbs[1:], depths[1:]):
            bt, br, loss = self.track_step(rgb, depth, *self._predict(*last, *before))
            ts.append(bt)
            rs.append(br)
            losses.append(loss)
            last, before = (bt, br), last
        return torch.stack(ts), torch.stack(rs), torch.stack(losses)

    def _get_super_step(self, group: int, do_kf: bool) -> Tuple[Tuple[int, bool, int], Callable]:
        """The group program for the current ``_cur_cap`` and its key
        ``(group, do_kf, cur_cap)``, as the reference package keys its
        compiled programs; it takes the flat inputs (the G images, the G
        depths, prev t, r, prev2 t, r)."""
        key = (group, do_kf, self._cur_cap())
        if key not in self._super_steps:
            cur_cap = key[2]

            def program(*x: torch.Tensor):
                return self.super_step(x[:group], x[group:2 * group], *x[2 * group:], do_kf=do_kf, cur_cap=cur_cap)

            self._super_steps[key] = program
        return key, self._super_steps[key]

    def group_call(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                   prev2_c2w: Optional[np.ndarray] = None,
                   prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[Tuple[int, bool, int], Callable, List[torch.Tensor]]:
        """The group program on ``frames``, its key and its inputs (the G
        images, the G depths, the predecessor poses as device (t, r))."""
        if prev_tr is None:
            prev_tr, prev2_tr = (tuple(self._pose(v) for v in lie_np.matrix_to_pose_vec(
                np.asarray(c2w, np.float32), rot_rep="axis_angle")) for c2w in (prev_c2w, prev2_c2w))
        key, program = self._get_super_step(len(frames), do_kf)
        inputs = ([f.rgb_dev(self.device) for f in frames] + [f.depth_dev(self.device) for f in frames]
                  + [*prev_tr, *prev2_tr])
        return key, program, inputs

    def dispatch_superstep(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                           prev2_c2w: Optional[np.ndarray] = None,
                           prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Launch the group program on ``frames`` (``frames[0]`` is the head,
        which is mapped); requires ``is_initialized()``. The predecessor
        poses come as host matrices (``prev_c2w``, ``prev2_c2w``) or, so
        that a dispatch waits for nothing, as the device (t, r) pairs of
        the previous group's output (``prev_tr``, ``prev2_tr``). Returns
        the handle for ``finish_superstep``: the group's device poses (t
        [G, 3], r [G, 3]) and their copy to the host, under way."""
        if do_kf and self.kf_count >= self.max_kf:
            raise RuntimeError(f"keyframe capacity {self.max_kf} exceeded; raise max_keyframes")
        key, program, inputs = self.group_call(frames, do_kf, prev_c2w, prev2_c2w, prev_tr, prev2_tr)
        poses_t, poses_r, _ = self.graphs(key, program, inputs)
        if do_kf:
            self.kf_count += 1
            self.keyframe_fids.append(frames[0].fid)
        return poses_t, poses_r, PendingFetch(poses_t, poses_r)

    def finish_superstep(self, handle) -> List[np.ndarray]:
        """One pose fetch for the whole group -> its c2w matrices."""
        pt, pr = handle[2].wait()
        return [lie_np.pose_vec_to_matrix(pt[j], pr[j], rot_rep="axis_angle") for j in range(pt.shape[0])]

    _host_state = ("kf_count",)
    _torch_generators = ("generator",)

    def _named_state(self) -> Dict[str, List[torch.Tensor]]:
        opt = []
        for st in self.model_opt_state.values():
            for k in sorted(st):
                v = st[k]
                opt.extend(v if isinstance(v, list) else [v])
        return {"model_params": [p for ps in self.model.param_groups().values() for p in ps],
                "model_opt_state": opt, "kf_rays": [self.kf_rays], "kf_pose_t": [self.kf_pose_t],
                "kf_pose_r": [self.kf_pose_r], "kf_count_dev": [self.kf_count_dev]}

    # ------------------------------------------------------------------
    # host API (called by the pipeline)
    # ------------------------------------------------------------------
    def dispatch_tracking(self, cur_frame: Frame) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.is_initialized():
            return None
        best_t, best_r, _ = self.track_step(cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device),
                                            self._pose(cur_frame.t), self._pose(cur_frame.r))
        return best_t, best_r

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        if handle is None:
            return None
        bt, br = (h.cpu().numpy() for h in handle)
        return lie_np.pose_vec_to_matrix(bt, br, rot_rep="axis_angle")

    def do_mapping(self, cur_frame: Frame) -> None:
        first = not self.is_initialized()
        cfg = self.config
        cur_t, cur_r = self.map_step(
            cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device),
            self._pose(cur_frame.t), self._pose(cur_frame.r),
            cfg.mapping_first_n_iters if first else cfg.mapping_n_iters, first,
            cfg.mapping_sample if first else self._cur_cap())
        cur_frame.t, cur_frame.r = cur_t.cpu().numpy(), cur_r.cpu().numpy()
        if first:
            self.set_initialized()

    def add_keyframe(self, keyframe: Frame) -> None:
        if self.kf_count >= self.max_kf:
            raise RuntimeError(f"keyframe capacity {self.max_kf} exceeded; raise max_keyframes")
        self.add_kf(keyframe.rgb_dev(self.device), keyframe.depth_dev(self.device), self._pose(keyframe.t),
                    self._pose(keyframe.r))
        self.kf_count += 1
        self.keyframe_fids.append(keyframe.fid)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_img(self, c2w: np.ndarray, gt_depth: Optional[np.ndarray] = None, idx: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Full-image render at pose ``c2w`` in chunks of ``ray_batch_size``
        rays: (color [H, W, 3], depth [H, W]). With ``gt_depth`` the samples
        are placed around it (jittered from the run's generator when
        training_perturb), else uniformly over [near, far]."""
        cam = self.camera
        c2w_t = torch.as_tensor(np.asarray(c2w, np.float32), device=self.device)
        rays_d = self._dirs.reshape(-1, 3) @ c2w_t[:3, :3].T
        rays_o = c2w_t[:3, 3].expand(rays_d.shape)
        gt = None if gt_depth is None else torch.as_tensor(np.asarray(gt_depth, np.float32),
                                                           device=self.device).reshape(-1, 1)
        bs = self.config.ray_batch_size
        depth, color = [], []
        for i in range(0, rays_d.shape[0], bs):
            if gt is None:
                out = self.model.render_rays_no_depth(rays_o[i:i + bs], rays_d[i:i + bs])
            else:
                out = self.model.render_rays(rays_o[i:i + bs], rays_d[i:i + bs], gt[i:i + bs], self.generator)
            depth.append(out["depth"])
            color.append(out["rgb"])
        return (torch.cat(color).reshape(cam.height, cam.width, 3).cpu().numpy(),
                torch.cat(depth).reshape(cam.height, cam.width).cpu().numpy())

    @torch.no_grad()
    def get_mesh(self) -> Optional[Mesh]:
        """The mesh of the SDF's zero level over ``marching_cubes_bound``,
        vertex colors from the color net, grid cells outside every
        keyframe's frustum (up to cam_far) masked out."""
        kf_mask_fn = None
        if self.kf_count > 0:
            kf_t, kf_r = self.kf_pose_t.cpu().numpy(), self.kf_pose_r.cpu().numpy()
            kf_c2w = [lie_np.pose_vec_to_matrix(kf_t[i], kf_r[i], rot_rep="axis_angle") for i in range(self.kf_count)]
            far = self.config.model.cam_far

            def kf_mask_fn(pts):
                return points_in_frustum(pts, kf_c2w, self.camera, near=0.0, far=far)

        def query(fn):
            return lambda pts: fn(torch.as_tensor(pts, device=self.device)).cpu().numpy()

        return self.mesher.get_mesh(
            query_fn=query(self.model.query_sdf),
            color_fn=query(self.model.query_color),
            point_mask_fn=kf_mask_fn)
