"""Vox-Fusion: sparse-voxel SDF SLAM on a fixed-capacity voxel hash.

Counterpart of ``xrdslam_tpu/algorithms/voxfusion.py``: the per-frame path
(``dispatch_tracking`` / ``finish_tracking``, ``do_mapping``,
``add_keyframe``), the fused per-frame step (``fused_step``,
``dispatch_superstep`` / ``finish_superstep``), ``render_img`` and
``get_mesh``. The structure is the reference package's:

  * before each mapping call the depth image is back-projected and the
    voxels it reaches are inserted on the device (``ops/voxel_hash.py``:
    ``new_voxel_mask``, then ``insert_marked``), at the frame's pose, or
    on the fused path at the constant-velocity prediction (at 0.2 m voxels
    the tracked pose's millimetres change no cell);
  * tracking optimises the pose (translation, axis-angle) against the
    frozen map and keeps the pose of lowest loss; it differentiates the
    pose alone, so it takes no embedding gradient (no K4 launch);
  * mapping optimises the decoder and the embeddings (their Adam state
    persists across calls, its step count on the device) and, when the
    window holds a keyframe, the window's poses with a fresh Adam (the
    oldest held fixed), on ``mapping_sample`` random pixels of each slot
    of a window padded to ``mapping_window_size``, spread over its
    ``n_valid`` real frames by ``window_slot_frame``; each iteration's
    embedding gradient is one K4 launch;
  * keyframes are full images in a device store ``kf_images [max_kf, H,
    W, 4]`` with poses ``kf_pose [max_kf, 6]``; the window is the newest
    keyframe and ``window - 2`` others at random.

The optimization loops are Python loops of eager device work with no host
sync, and the map, the voxel tables and the keyframe store are written in
place, so the fused step (mark and insert, predict, track, map, keyframe)
is captured as a CUDA graph per ``(optimize_pose, do_kf)`` key and
replayed (``engine/graphs.py``); on the CPU it runs eagerly.

Random numbers come from a device ``torch.Generator`` (pixel samples) and
a numpy ``Generator`` (the window's keyframes), both seeded from
``config.seed``; they are not the reference's ``jax.random`` draws.
``track_step`` and ``map_step`` take pre-drawn samples, so that a test can
feed both packages the same pixels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame, upload
from ..common.mesher import MesherConfig
from ..engine.graphs import GraphReplay, PendingFetch
from ..engine.optimizers import GroupOptimizers
from ..models.sparse_voxel import SparseVoxel, SparseVoxelConfig
from ..ops import lie, lie_np
from ..ops.sampling import camera_ray_dirs, sample_pixels
from ..ops.scatter import scatter_rows
from ..ops.voxel_hash import empty_device_maps, insert_marked, lookup_voxels, new_voxel_mask
from ..utils.io import Mesh
from .base import Algorithm, AlgorithmConfig

MODEL_GROUPS = ("decoder", "embeddings")
MAX_NEW_VOXELS = 1024  # voxels inserted per call at most, as the reference's; the rest wait a frame
Samples = Sequence[Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class VoxFusionConfig(AlgorithmConfig):
    """The reference's VoxFusionConfig."""

    _target: Type = field(default_factory=lambda: VoxFusion)
    model: SparseVoxelConfig = field(default_factory=SparseVoxelConfig)
    mapping_sample: int = 1024  # pixels of each window slot per mapping iteration
    tracking_sample: int = 1024
    ray_batch_size: int = 3000  # rays per chunk of render_img
    max_keyframes: int = 64
    mesh_resolution: int = 256
    seed: int = 0


class VoxFusion(Algorithm):
    config: VoxFusionConfig

    def __init__(self, config: VoxFusionConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        m = config.model
        # weights are drawn on the CPU so that a seed gives the same initial
        # model on every device
        init_gen = torch.Generator().manual_seed(config.seed)
        self.model = SparseVoxel(m, camera, generator=init_gen).to(self.device)
        self.maps = empty_device_maps(m.max_voxels, m.num_embeddings, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.rng = np.random.default_rng(config.seed)
        self._opt_cfgs = {name: g["optimizer"] for name, g in config.optimizers.items()}
        self.model_opt = GroupOptimizers({g: self._opt_cfgs[g] for g in MODEL_GROUPS}, device_count=MODEL_GROUPS)
        self.model_opt_state = self.model_opt.init(self.model.param_groups())
        self.max_kf = config.max_keyframes
        H, W = camera.height, camera.width
        self.kf_images = torch.zeros((self.max_kf, H, W, 4), device=self.device)
        self.kf_pose = torch.zeros((self.max_kf, 6), device=self.device)  # t + axis-angle
        self.kf_count = 0
        self._dirs = camera_ray_dirs(camera, self.device)
        self._programs: Dict[Tuple[bool, bool], Callable] = {}
        self.graphs = GraphReplay(self.generator)

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    @torch.no_grad()
    def insert_voxels(self, depth: torch.Tensor, t: torch.Tensor, r: torch.Tensor) -> None:
        """Back-project ``depth`` at pose (t, r) and insert the voxels it
        reaches, in place on ``maps``."""
        m = self.config.model
        pts = (self._dirs * depth[..., None]).reshape(-1, 3) @ lie.axis_angle_to_matrix(r).T + t
        cc, new = new_voxel_mask(self.maps, pts, (depth > 0).reshape(-1), voxel_size=m.voxel_size)
        insert_marked(self.maps, cc, new, voxel_size=m.voxel_size, max_voxels=m.max_voxels,
                      max_vertices=m.num_embeddings, max_new=MAX_NEW_VOXELS)

    def track_step(self, rgb: torch.Tensor, depth: torch.Tensor, t0: torch.Tensor, r0: torch.Tensor,
                   samples: Optional[Samples] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``tracking_n_iters`` Adam steps on the pose against the frozen map,
        on ``tracking_sample`` pixels each (``samples[i]`` = (u, v) when
        given). Returns the pose of lowest loss seen (t, r) and that loss."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        names = ("tracking_pose_r", "tracking_pose_t")
        opt_cfg = self._opt_cfgs["tracking_pose"]
        sched = self._tracking_lr_schedule(opt_cfg.lr)
        opt = GroupOptimizers({n: opt_cfg for n in names}, schedules={n: sched for n in names} if sched else None)
        r = r0.clone().requires_grad_(True)
        t = t0.clone().requires_grad_(True)
        params = {"tracking_pose_r": [r], "tracking_pose_t": [t]}
        state = opt.init(params)
        best_loss = torch.full((), 1e10, device=t0.device)
        best_t, best_r = t0.clone(), r0.clone()
        for it in range(cfg.tracking_n_iters):
            if samples is None:
                u, v = sample_pixels(cfg.tracking_sample, H, W, generator=self.generator, device=self.device)
            else:
                u, v = samples[it]
            rays_d = self._dirs[v, u] @ lie.axis_angle_to_matrix(r).T
            rays_o = t.expand(rays_d.shape)
            loss, _ = self.model.get_loss(self.maps, rays_o, rays_d, rgb[v, u], depth[v, u][:, None])
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

    def map_step(self, images: torch.Tensor, poses: torch.Tensor, n_valid, n_iters: int, optimize_pose: bool,
                 samples: Optional[Samples] = None) -> torch.Tensor:
        """``n_iters`` Adam steps on the map, in place, and, with
        ``optimize_pose``, on the window's poses (the oldest fixed), on the
        window ``images`` [S, H, W, 4] (rgb + depth) at ``poses`` [S, 6],
        the first ``n_valid`` (an int or a device tensor) real.
        ``samples[i]`` = (u, v) [S, pixels] when given. Returns the poses."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        n_slots, pixs = images.shape[0], cfg.mapping_sample
        dev = images.device
        slots = torch.arange(n_slots, device=dev)
        fi = ((slots + 1) * n_valid - 1) // n_slots  # window_slot_frame, for a device n_valid too
        frame_of_ray = fi[:, None].expand(n_slots, pixs).reshape(-1)
        # slot poses as a one-hot product: a gather whose backward sums in a
        # fixed order on the card
        sel = (fi[:, None] == slots[None, :]).to(poses.dtype)
        groups = {g: self._opt_cfgs[g] for g in MODEL_GROUPS}
        params = self.model.param_groups()
        state = dict(self.model_opt_state)
        pose = None
        if optimize_pose:
            groups["pose"] = self._opt_cfgs["mapping_pose"]
            pose = poses.clone().requires_grad_(True)
            params["pose"] = [pose]
        opt = GroupOptimizers(groups)
        if optimize_pose:
            state["pose"] = opt.init_group("pose", params["pose"])
        flat = [p for ps in params.values() for p in ps]
        for it in range(n_iters):
            if samples is None:
                u, v = sample_pixels(n_slots * pixs, H, W, generator=self.generator, device=dev)
            else:
                u, v = (s.reshape(-1) for s in samples[it])
            px = images[frame_of_ray, v, u]
            pz = poses if pose is None else torch.cat([pose[:1].detach(), pose[1:]], 0)
            ps = sel @ pz  # [S, 6]
            rays_d = (self._dirs[v, u].reshape(n_slots, pixs, 3)
                      @ lie.axis_angle_to_matrix(ps[:, 3:]).transpose(-1, -2)).reshape(-1, 3)
            rays_o = ps[:, None, :3].expand(n_slots, pixs, 3).reshape(-1, 3)
            loss, _ = self.model.get_loss(self.maps, rays_o, rays_d, px[:, :3], px[:, 3:4])
            grads = self._finite_guard(loss.detach(), list(torch.autograd.grad(loss, flat)))
            grouped: Dict[str, List[torch.Tensor]] = {}
            for g, ps_ in params.items():
                grouped[g], grads = grads[:len(ps_)], grads[len(ps_):]
            opt.update(grouped, state, params)
        self.model_opt_state = {g: state[g] for g in MODEL_GROUPS}
        return poses if pose is None else pose.detach()

    # ------------------------------------------------------------------
    # the fused per-frame step
    # ------------------------------------------------------------------
    predict = staticmethod(lie.predict_constant_velocity)

    def window_arrays(self, slots: torch.Tensor, n_valid: torch.Tensor, cur_img: torch.Tensor,
                      cur_pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The keyframes at ``slots`` [S - 1], then the current frame, which
        also fills every row from ``n_valid - 1`` on: (images [S, H, W, 4],
        poses [S, 6])."""
        images = torch.cat([torch.index_select(self.kf_images, 0, slots), cur_img[None]], 0)
        poses = torch.cat([torch.index_select(self.kf_pose, 0, slots), cur_pose[None]], 0)
        is_cur = torch.arange(images.shape[0], device=images.device) >= n_valid - 1
        images = torch.where(is_cur[:, None, None, None], cur_img[None], images)
        poses = torch.where(is_cur[:, None], cur_pose[None], poses)
        return images, poses

    def fused_step(self, rgb: torch.Tensor, depth: torch.Tensor, win_slots: torch.Tensor, n_valid: torch.Tensor,
                   t1: torch.Tensor, r1: torch.Tensor, t2: torch.Tensor, r2: torch.Tensor, kf_slot: torch.Tensor,
                   optimize_pose: bool, do_kf: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """One frame, all on the device: predict its pose from (t1, r1) and
        (t2, r2), insert the voxels its depth reaches there, track, map the
        window (``win_slots`` [window - 1], ``n_valid``) and write the
        window's optimised keyframe poses back (padded slots dropped); when
        ``do_kf``, write the frame to keyframe row ``kf_slot`` [1]. Returns
        the mapped pose (t [1, 3], r [1, 3])."""
        tp, rp = self.predict(t1, r1, t2, r2)
        self.insert_voxels(depth, tp, rp)
        bt, br, _ = self.track_step(rgb, depth, tp, rp)
        cur_img = torch.cat([rgb, depth[..., None]], -1)
        images, poses = self.window_arrays(win_slots, n_valid, cur_img, torch.cat([bt, br]))
        new_poses = self.map_step(images, poses, n_valid, self.config.mapping_n_iters, optimize_pose)
        with torch.no_grad():
            if optimize_pose:
                wn1 = win_slots.shape[0]
                real = torch.arange(wn1, device=win_slots.device) < n_valid - 1
                scatter_rows(self.kf_pose, torch.where(real, win_slots, self.max_kf), new_poses[:wn1])
            cur = torch.index_select(new_poses, 0, (n_valid - 1).reshape(1))
            if do_kf:
                self.kf_images.index_copy_(0, kf_slot, cur_img[None])
                self.kf_pose.index_copy_(0, kf_slot, cur)
        return cur[:, :3], cur[:, 3:]

    def _window_slots(self) -> List[int]:
        """The window's keyframe slots, oldest first: all while they fit,
        else ``window - 2`` at random and the newest."""
        k = self.config.mapping_window_size - 1
        if self.kf_count <= k:
            return list(range(self.kf_count))
        pick = self.rng.permutation(self.kf_count - 1)[:k - 1]
        return sorted(int(s) for s in pick) + [self.kf_count - 1]

    def group_call(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                   prev2_c2w: Optional[np.ndarray] = None,
                   prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[Tuple[bool, bool], Callable, List[torch.Tensor]]:
        """The program of a group (one frame), its key ``(optimize_pose,
        do_kf)`` and its inputs: the frame's images, the window's keyframe
        slots (padded with 0), ``n_valid``, the two predecessor poses (host
        matrices, or the device (t, r) of the group before) and the
        keyframe slot. Draws the window's keyframes."""
        if len(frames) != 1:
            raise ValueError(f"Vox-Fusion maps every frame: a group is one frame, got {len(frames)}")
        cur = frames[0]
        if prev_tr is None:
            prev_tr, prev2_tr = (tuple(upload(np.asarray(v, np.float32), self.device) for v in lie_np.matrix_to_pose_vec(
                np.asarray(c2w, np.float32), rot_rep="axis_angle")) for c2w in (prev_c2w, prev2_c2w))
        slots = self._window_slots()
        n_valid = len(slots) + 1
        key = (n_valid > 1, do_kf)
        if key not in self._programs:
            self._programs[key] = lambda *x: self.fused_step(*x, optimize_pose=key[0], do_kf=key[1])
        inputs = [cur.rgb_dev(self.device), cur.depth_dev(self.device),
                  self._index(slots + [0] * (self.config.mapping_window_size - n_valid)), self._index(n_valid),
                  *prev_tr, *prev2_tr, self._index([self.kf_count])]
        return key, self._programs[key], inputs

    def dispatch_superstep(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                           prev2_c2w: Optional[np.ndarray] = None,
                           prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Launch the fused step on ``frames`` (one frame); requires
        ``is_initialized()``. Returns the handle for ``finish_superstep``:
        the device pose (t [1, 3], r [1, 3]) and its copy to the host, under
        way."""
        if do_kf and self.kf_count >= self.max_kf:
            raise RuntimeError(f"keyframe capacity {self.max_kf} exceeded; raise max_keyframes")
        key, program, inputs = self.group_call(frames, do_kf, prev_c2w, prev2_c2w, prev_tr, prev2_tr)
        pt, pr = self.graphs(key, program, inputs)
        if do_kf:
            self.kf_count += 1
            self.keyframe_fids.append(frames[0].fid)
        return pt, pr, PendingFetch(pt, pr)

    def finish_superstep(self, handle) -> List[np.ndarray]:
        """The frame's pose fetch -> [its c2w]."""
        pt, pr = handle[2].wait()
        return [lie_np.pose_vec_to_matrix(pt[0], pr[0], rot_rep="axis_angle")]

    _host_state = ("kf_count",)
    _torch_generators = ("generator",)
    _numpy_generators = ("rng",)

    def _named_state(self) -> Dict[str, List[torch.Tensor]]:
        """The state tensors; the keyframe store last."""
        opt = []
        for st in self.model_opt_state.values():
            for k in sorted(st):
                v = st[k]
                opt.extend(v if isinstance(v, list) else [v])
        return {"model_params": [p for ps in self.model.param_groups().values() for p in ps],
                "model_opt_state": opt, "maps": [self.maps[k] for k in sorted(self.maps)],
                "kf_images": [self.kf_images], "kf_pose": [self.kf_pose]}

    # ------------------------------------------------------------------
    # host API (called by the pipeline)
    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return upload(np.asarray(a, np.float32), self.device)

    def _index(self, values) -> torch.Tensor:
        """int64 indices on the device, uploaded without a wait."""
        return upload(np.asarray(values, np.int64), self.device)

    def create_voxels(self, frame: Frame) -> None:
        """Insert the voxels of ``frame``'s depth at its pose."""
        self.insert_voxels(frame.depth_dev(self.device), self._tensor(frame.t), self._tensor(frame.r))

    def dispatch_tracking(self, cur_frame: Frame) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.is_initialized():
            return None
        bt, br, _ = self.track_step(cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device),
                                    self._tensor(cur_frame.t), self._tensor(cur_frame.r))
        return bt, br

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        if handle is None:
            return None
        bt, br = (h.cpu().numpy() for h in handle)
        return lie_np.pose_vec_to_matrix(bt, br, rot_rep="axis_angle")

    def do_mapping(self, cur_frame: Frame) -> None:
        """Insert the frame's voxels, then one mapping call on the window of
        the keyframes and the frame (the first: ``mapping_first_n_iters``)."""
        cfg = self.config
        first = not self.is_initialized()
        self.create_voxels(cur_frame)
        slots = self._window_slots()
        n_valid = len(slots) + 1
        cur_img = torch.cat([cur_frame.rgb_dev(self.device), cur_frame.depth_dev(self.device)[..., None]], -1)
        cur_pose = self._tensor(np.concatenate([cur_frame.t, cur_frame.r]))
        idx = self._index(slots)
        images, poses = self.pad_window(torch.cat([self.kf_images[idx], cur_img[None]], 0),
                                        torch.cat([self.kf_pose[idx], cur_pose[None]], 0), cur_img[None], cur_pose,
                                        cfg.mapping_window_size)
        optimize_pose = n_valid > 1
        new_poses = self.map_step(images, poses, n_valid, cfg.mapping_first_n_iters if first else cfg.mapping_n_iters,
                                  optimize_pose)
        if optimize_pose:
            with torch.no_grad():
                self.kf_pose[idx] = new_poses[:len(slots)]
        cur = new_poses[n_valid - 1].cpu().numpy()
        cur_frame.t, cur_frame.r = cur[:3].copy(), cur[3:].copy()
        if first:
            self.set_initialized()

    def add_keyframe(self, keyframe: Frame) -> None:
        if self.kf_count >= self.max_kf:
            raise RuntimeError(f"keyframe capacity {self.max_kf} exceeded; raise max_keyframes")
        slot = self.kf_count
        self.kf_images[slot] = torch.cat([keyframe.rgb_dev(self.device), keyframe.depth_dev(self.device)[..., None]],
                                         -1)
        self.kf_pose[slot] = self._tensor(np.concatenate([keyframe.t, keyframe.r]))
        self.kf_count += 1
        self.keyframe_fids.append(keyframe.fid)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_img(self, c2w: np.ndarray, gt_depth: Optional[np.ndarray] = None, idx: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb [H, W, 3], depth [H, W]) rendered at ``c2w`` in chunks of
        ``ray_batch_size`` rays; ``gt_depth`` and ``idx`` are unused, as in
        the reference."""
        cam = self.camera
        c2w_t = self._tensor(c2w)
        rays_d = self._dirs.reshape(-1, 3) @ c2w_t[:3, :3].T
        rays_o = c2w_t[:3, 3].expand(rays_d.shape)
        bs = self.config.ray_batch_size
        depth, color = [], []
        for i in range(0, rays_d.shape[0], bs):
            out = self.model.render_rays(self.maps, rays_o[i:i + bs], rays_d[i:i + bs])
            depth.append(out["depth"])
            color.append(out["rgb"])
        return (torch.cat(color).reshape(cam.height, cam.width, 3).cpu().numpy(),
                torch.cat(depth).reshape(cam.height, cam.width).cpu().numpy())

    @torch.no_grad()
    def query_sdf_grid(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sdf [N], rgb [N, 3]) at world points ``pts`` [N, 3]; the SDF is
        twice the truncation outside the allocated voxels."""
        m = self.config.model
        vidx = lookup_voxels(self.maps["hash_keys"], self.maps["hash_vals"],
                             torch.floor(pts / m.voxel_size).to(torch.int32))
        rgb, sdf = self.model.decode(self.model.interp_embeddings(self.maps, torch.clamp(vidx, min=0), pts))
        return torch.where(vidx >= 0, sdf, m.training_trunc * 2.0), rgb

    @torch.no_grad()
    def get_mesh(self) -> Optional[Mesh]:
        """Marching tetrahedra of the SDF on a grid of ``mesh_resolution``
        cells over the allocated voxels' bounding box, one voxel of margin;
        None before any voxel."""
        n_vox = int(self.maps["n_voxels"])
        if n_vox == 0:
            return None
        coords = self.maps["vox_coords"][:n_vox].cpu().numpy()
        vs = self.config.model.voxel_size
        bound = np.stack([coords.min(0) * vs - vs, (coords.max(0) + 2) * vs], -1)
        mesher = MesherConfig(resolution=self.config.mesh_resolution, points_batch_size=30000).setup(
            camera=self.camera, bounding_box=bound, marching_cubes_bound=bound)

        def query(i: int):
            return lambda pts: self.query_sdf_grid(torch.as_tensor(pts, device=self.device))[i].cpu().numpy()

        return mesher.get_mesh(query(0), query(1))
