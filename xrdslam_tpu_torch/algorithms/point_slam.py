"""Point-SLAM: neural point cloud SLAM with density-driven growth.

Counterpart of ``xrdslam_tpu/algorithms/point_slam.py``: the per-frame
path (``dispatch_tracking`` / ``finish_tracking``, ``do_mapping``,
``add_keyframe``), the group step (``group_step``,
``dispatch_superstep`` / ``finish_superstep``), ``render_img`` and
``get_mesh``. The structure is the reference package's:

  * before each mapping call, points grow from the current frame
    (``add_points_from_frame``): pixels are picked at random, and three
    points (at depth - r, d, d + r along the ray) are added for each whose
    surface point has fewer than ``pointcloud_min_nn_num`` stored points
    within its radius r; the rows that changed are then written into the
    device map in place (``PointMap.upload``);
  * radii are dynamic: a Sobel colour-gradient magnitude per pixel maps to
    the add radius and the query radius (``cal_dynamic_radius``); the query
    radius rides along as a fifth image channel (``_frame_rgbdr``);
  * mapping fills a static window of ``mapping_window_size`` slots with
    random keyframes plus the current frame (``window_slot_frame``,
    ``pad_window``) and runs one loop of ``n_iters``: a geometry phase
    (``mapping_geo_iter_ratio`` of them), then a colour phase, with the
    phase learning rates of ``PointSLAMSchedulerConfig`` and one Adam state
    carried across; the poses stay fixed (no bundle adjustment, as the
    reference's default);
  * tracking optimises the pose vector (translation and quaternion) for
    ``tracking_n_iters`` iterations on random interior pixels and keeps
    the pose of lowest loss;
  * the mesh is TSDF fusion (``ops/tsdf_fusion.py``) of the keyframes
    rendered at their poses, over the stored points' box.

The optimization loops are Python loops of eager device work with no host
sync, and every tensor that outlives a step is written in place, so that
a step can be captured into a CUDA graph. A ``map_every``-frame group is
two device programs with the group's one host sync between them, as in
the reference: the head (predict the head frame's pose and track it);
then, on the host, its pose read back, the point insertion at that pose
and the window's pick; then the tail (map the window, write the head's
keyframe row, track the other frames, each from the prediction of the two
poses before it). On the CPU both run eagerly; on the card each is a CUDA
graph (``engine/graphs.py``), captured once per key (the head; the tail
per ``(group, mapping_n_iters, n_grad, do_kf)``) and replayed.

Pixel samples come from a device ``torch.Generator``, point picks and
window slots from a numpy ``Generator``; both are seeded from
``config.seed`` and give other numbers than the reference's ``jax.random``
(whose mapping keys also depend on Python's per-process ``hash(str)``).
``track_step``, ``map_step`` and ``group_step`` take pre-drawn samples,
and ``add_points_from_frame`` a pre-drawn pick, so that a test can feed
both packages the same draws.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame
from ..engine.graphs import GraphReplay, PendingFetch
from ..engine.optimizers import GroupOptimizers
from ..engine.schedulers import PointSLAMSchedulerConfig
from ..models.conv_onet_pointslam import ConvOnet2, ConvOnet2Config
from ..ops import lie, lie_np
from ..ops.point_table import PointMap
from ..ops.sampling import camera_ray_dirs, sample_pixels
from ..ops.tsdf_fusion import TSDFVolume
from ..utils.io import Mesh
from .base import Algorithm, AlgorithmConfig

Samples = Sequence[Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class PointSLAMConfig(AlgorithmConfig):
    """The reference's PointSLAMConfig, less what nothing in the port reads
    (``mapping_BA``, which the reference leaves off and does not implement;
    ``map_chunk_iters``, which kept each TPU program under its watchdog)."""

    _target: Type = field(default_factory=lambda: PointSLAM)
    model: ConvOnet2Config = field(default_factory=ConvOnet2Config)
    mapping_sample: int = 5000
    min_sample_pixels: int = 40
    tracking_sample: int = 1500
    ray_batch_size: int = 3000  # rays per chunk in render_img
    tracking_Wedge: int = 100
    tracking_Hedge: int = 100
    mapping_geo_iter_ratio: float = 0.4
    pixels_adding: int = 6000
    # extra mapping rays and insertion pixels at the current frame's top
    # colour-gradient pixels
    mapping_pixels_based_on_color_grad: int = 0
    max_keyframes: int = 64
    mesh_resolution: int = 256  # TSDF voxels along the longest side of the points' box
    seed: int = 0


class PointSLAM(Algorithm):
    config: PointSLAMConfig

    def __init__(self, config: PointSLAMConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        # weights are drawn on the CPU so that a seed gives the same initial
        # model on every device
        init_gen = torch.Generator().manual_seed(config.seed)
        self.model = ConvOnet2(config.model, camera, generator=init_gen).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.rng = np.random.default_rng(config.seed)
        self.point_map = PointMap(max_points=config.model.max_points, cell_size=2.0 * self.model.max_query_radius())
        self.maps = self.point_map.device_state(self.device)
        self._opt_cfgs = {name: g["optimizer"] for name, g in config.optimizers.items()}
        self._scheds = {name: g.get("scheduler") for name, g in config.optimizers.items()}
        H, W = camera.height, camera.width
        # channels: rgb, depth, dynamic query radius
        self.kf_images = torch.zeros((config.max_keyframes, H, W, 5), device=self.device)
        self.kf_pose = torch.zeros((config.max_keyframes, 7), device=self.device)  # t + quaternion
        self.kf_count = 0
        self._dirs = camera_ray_dirs(camera, self.device)
        self._dirs_np = camera_ray_dirs(camera).numpy()
        self.graphs = GraphReplay(self.generator)

    # ------------------------------------------------------------------
    # host-side helpers
    # ------------------------------------------------------------------
    def cal_dynamic_radius(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-pixel add and query radii from the Sobel colour-gradient
        magnitude: piecewise linear, [0, 0.01, threshold] -> [r_max, r_max,
        r_min]. (r_add [H, W], r_query [H, W])."""
        c = self.config.model
        gray = rgb @ np.array([0.2125, 0.7154, 0.0721], np.float32)
        kx = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32) / 4.0
        pad = np.pad(gray, 1, mode="edge")
        gx = sum(kx[i, j] * pad[i:i + gray.shape[0], j:j + gray.shape[1]] for i in range(3) for j in range(3))
        gy = sum(kx.T[i, j] * pad[i:i + gray.shape[0], j:j + gray.shape[1]] for i in range(3) for j in range(3))
        mag = np.clip(np.sqrt(gx**2 + gy**2), 0.0, c.pointcloud_color_grad_threshold)
        xs = [0.0, 0.01, c.pointcloud_color_grad_threshold]
        r_add = np.interp(mag, xs, [c.pointcloud_radius_add_max, c.pointcloud_radius_add_max,
                                    c.pointcloud_radius_add_min])
        ratio = c.pointcloud_radius_query_ratio
        r_query = np.interp(mag, xs, [ratio * c.pointcloud_radius_add_max, ratio * c.pointcloud_radius_add_max,
                                      ratio * c.pointcloud_radius_add_min])
        return r_add.astype(np.float32), r_query.astype(np.float32)

    def _frame_rgbdr(self, frame: Frame) -> torch.Tensor:
        """[H, W, 5] rgb + depth + dynamic query radius of a frame, on the device."""
        _, r_query = self.cal_dynamic_radius(frame.rgb)
        img = np.concatenate([np.asarray(frame.rgb, np.float32), np.asarray(frame.depth, np.float32)[..., None],
                              r_query[..., None]], -1)
        return torch.from_numpy(img).to(self.device)

    def _phase_lr(self, group: str, stage: str) -> float:
        sched = self._scheds.get(group)
        if isinstance(sched, PointSLAMSchedulerConfig):
            return sched.lr_for_stage("geometry" if stage == "geometry" else "color")
        return self._opt_cfgs[group].lr

    @staticmethod
    def _top_grad_pixels(rgb: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(u, v) of the n pixels of largest colour gradient."""
        gray = rgb @ np.array([0.2125, 0.7154, 0.0721], np.float32)
        gx = np.abs(np.diff(gray, axis=1, append=gray[:, -1:]))
        gy = np.abs(np.diff(gray, axis=0, append=gray[-1:]))
        mag = (gx + gy).ravel()
        idx = np.argpartition(mag, -n)[-n:]
        v, u = np.unravel_index(idx, gray.shape)
        return u.astype(np.int64), v.astype(np.int64)

    def add_points_from_frame(self, frame: Frame, n_pixels: int, pick: Optional[np.ndarray] = None) -> None:
        """Density-driven point addition, the add radius per pixel; ``pick``
        indexes the frame's valid pixels (drawn from ``self.rng`` when
        omitted). Writes the changed rows into the device map when points
        were added."""
        d = frame.depth
        vs, us = np.nonzero(d > 0)
        if len(vs) == 0:
            return
        if pick is None:
            pick = self.rng.integers(0, len(vs), min(n_pixels, len(vs)))
        u, v = us[pick], vs[pick]
        z = d[v, u]
        r_add_map, _ = self.cal_dynamic_radius(frame.rgb)
        r_add = r_add_map[v, u]
        n_grad = self.config.mapping_pixels_based_on_color_grad
        if n_grad > 0:
            gu, gv = self._top_grad_pixels(frame.rgb, n_grad)
            gz = d[gv, gu]
            keep = gz > 0
            u = np.concatenate([u, gu[keep]])
            v = np.concatenate([v, gv[keep]])
            z = np.concatenate([z, gz[keep]])
            r_add = np.concatenate([r_add, r_add_map[gv, gu][keep]])
        c2w = frame.get_pose()
        dirs_w = self._dirs_np[v, u] @ c2w[:3, :3].T
        surf = c2w[:3, 3] + dirs_w * z[:, None]
        counts = self.point_map.neighbor_counts(surf, r_add)
        need = counts < self.config.model.pointcloud_min_nn_num
        if not need.any():
            return
        spread = r_add[need][:, None]
        zs = z[need][:, None] + spread * np.array([-1.0, 0.0, 1.0])[None, :]
        pts = (c2w[:3, 3][None, None] + dirs_w[need][:, None, :] * zs[..., None]).reshape(-1, 3)
        if self.point_map.add_points(pts):
            self.point_map.upload(self.maps)

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    def track_step(self, rgbdr: torch.Tensor, pose0: torch.Tensor, samples: Optional[Samples] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tracking_n_iters`` Adam steps on the pose vector [7] (t, q)
        against the frozen map, on ``tracking_sample`` interior pixels each
        (``samples[i]`` = (u, v) when given). Returns the pose of lowest loss
        seen and that loss."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        opt_cfg = self._opt_cfgs["tracking_pose"]
        sched = self._tracking_lr_schedule(opt_cfg.lr)
        opt = GroupOptimizers({"tracking_pose": opt_cfg}, schedules={"tracking_pose": sched} if sched else None)
        pose = pose0.clone().requires_grad_(True)
        params = {"tracking_pose": [pose]}
        state = opt.init(params)
        best_loss = torch.full((), 1e10, device=self.device)
        best_pose = pose0.clone()
        for it in range(cfg.tracking_n_iters):
            if samples is None:
                u, v = sample_pixels(cfg.tracking_sample, H, W, cfg.tracking_Hedge, cfg.tracking_Wedge,
                                     self.generator, self.device)
            else:
                u, v = samples[it]
            px = rgbdr[v, u]
            rays_d = self._dirs[v, u] @ lie.quaternion_to_matrix(pose[3:]).T
            rays_o = pose[:3].expand(rays_d.shape)
            loss, _ = self.model.get_loss(self.maps, rays_o, rays_d, px[:, :3], px[:, 3:4], False, "color",
                                          r_query=px[:, 4])
            (g,) = torch.autograd.grad(loss, [pose])
            with torch.no_grad():
                loss = loss.detach()
                better = loss < best_loss
                best_loss = torch.where(better, loss, best_loss)
                best_pose = torch.where(better, pose, best_pose)
            opt.update({"tracking_pose": self._finite_guard(loss, [g])}, state, params)
        return best_pose, best_loss

    def map_step(self, images: torch.Tensor, poses: torch.Tensor, n_valid, n_iters: int,
                 grad_uv: Optional[torch.Tensor] = None, samples: Optional[Samples] = None) -> torch.Tensor:
        """``n_iters`` Adam steps on the map: the geometry phase, then the
        colour phase, one Adam state across both. Each iteration renders
        ``max(mapping_sample // S, min_sample_pixels)`` random pixels of each
        of the S window slots (``images`` [S, H, W, 5], ``poses`` [S, 7], the
        first ``n_valid`` real: an int or a device tensor), plus ``grad_uv``
        [n, 2] (u, v) on the last; ``samples[i]`` = (u, v) [S, pixels] when
        given. Returns the losses."""
        cfg = self.config
        H, W = self.camera.height, self.camera.width
        n_slots = images.shape[0]
        pixs = max(cfg.mapping_sample // n_slots, cfg.min_sample_pixels)
        # window_slot_frame, for a device n_valid too
        fi = ((torch.arange(n_slots, device=images.device) + 1) * n_valid - 1) // n_slots
        slot = torch.arange(n_slots, device=self.device).repeat_interleave(pixs)
        if grad_uv is not None and grad_uv.shape[0] > 0:
            slot = torch.cat([slot, torch.full((grad_uv.shape[0],), n_slots - 1, device=self.device)])
        frame = fi[slot]
        rots = lie.quaternion_to_matrix(poses[fi, 3:])[slot]  # [M, 3, 3]
        rays_o = poses[fi, :3][slot]
        groups = self.model.param_groups()
        flat = [p for ps in groups.values() for p in ps]
        geo_steps = int(cfg.mapping_geo_iter_ratio * n_iters)
        state = None
        losses = []
        it = 0
        for stage, steps in (("geometry", geo_steps), ("color", n_iters - geo_steps)):
            if steps <= 0:
                continue
            opt = GroupOptimizers({g: dataclasses.replace(self._opt_cfgs[g], lr=self._phase_lr(g, stage))
                                   for g in groups})
            if state is None:
                state = opt.init(groups)
            for _ in range(steps):
                if samples is None:
                    u, v = sample_pixels(n_slots * pixs, H, W, generator=self.generator, device=self.device)
                else:
                    u, v = (s.reshape(-1) for s in samples[it])
                it += 1
                if grad_uv is not None and grad_uv.shape[0] > 0:
                    u, v = torch.cat([u, grad_uv[:, 0]]), torch.cat([v, grad_uv[:, 1]])
                px = images[frame, v, u]
                rays_d = (rots @ self._dirs[v, u][..., None])[..., 0]
                loss, _ = self.model.get_loss(self.maps, rays_o, rays_d, px[:, :3], px[:, 3:4], True, stage,
                                              r_query=px[:, 4])
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
                loss = loss.detach()
                grads = self._finite_guard(loss, grads)
                grouped = {}
                for g, ps in groups.items():
                    grouped[g], grads = grads[:len(ps)], grads[len(ps):]
                opt.update(grouped, state, groups)
                losses.append(loss)
        return torch.stack(losses) if losses else images.new_zeros((0,))

    # ------------------------------------------------------------------
    # the group step
    # ------------------------------------------------------------------
    def head_step(self, rgbdr: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                  samples: Optional[Samples] = None) -> torch.Tensor:
        """The group's first program: track the head frame (``rgbdr`` [H, W,
        5]) from the constant-velocity prediction of the two poses before
        it; returns its best pose [7]."""
        best, _ = self.track_step(rgbdr, self.predict_q(p1, p2), samples)
        return best

    def tail_step(self, rgbdrs: Sequence[torch.Tensor], cur_pose: torch.Tensor, prev_pose: torch.Tensor,
                  win_slots: torch.Tensor, n_valid: torch.Tensor, kf_slot: torch.Tensor,
                  grad_uv: Optional[torch.Tensor], do_kf: bool, samples: Optional[Tuple[Any, List[Any]]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The group's second program: ``mapping_n_iters`` mapping steps on
        the window (the keyframes at ``win_slots`` [window - 1], the head
        from row ``n_valid - 1`` on), with ``do_kf`` the head's image and
        pose ``cur_pose`` written at keyframe row ``kf_slot`` [1], then each
        other frame of ``rgbdrs`` tracked from the prediction of the two
        poses before it (the first from ``cur_pose`` and ``prev_pose``).
        ``samples`` = (the mapping's, [each tail frame's tracking]) when
        given. Returns (t [G, 3], q [G, 4]); the head's is ``cur_pose``."""
        map_samples, track_samples = samples if samples is not None else (None, [None] * (len(rgbdrs) - 1))
        cur_img = rgbdrs[0]
        images, poses = self.window_arrays(win_slots, n_valid, cur_img, cur_pose)
        self.map_step(images, poses, n_valid, self.config.mapping_n_iters, grad_uv, map_samples)
        if do_kf:
            with torch.no_grad():
                self.kf_images.index_copy_(0, kf_slot, cur_img[None])
                self.kf_pose.index_copy_(0, kf_slot, cur_pose[None])
        out = [cur_pose]
        p1, p2 = cur_pose, prev_pose
        for rgbdr, s in zip(rgbdrs[1:], track_samples):
            bj = self.head_step(rgbdr, p1, p2, s)
            out.append(bj)
            p1, p2 = bj, p1
        out = torch.stack(out)
        return out[:, :3], out[:, 3:]

    def _window_slots(self) -> List[int]:
        """The mapping window's keyframe slots: all while they fit
        ``window - 1``, else ``window - 2`` picked at random and the newest."""
        k = self.config.mapping_window_size - 1
        if self.kf_count <= k:
            return list(range(self.kf_count))
        return sorted(int(s) for s in self.rng.permutation(self.kf_count - 1)[: k - 1]) + [self.kf_count - 1]

    def group_step(self, frames: List[Frame], do_kf: bool, p1: torch.Tensor, p2: torch.Tensor,
                   run: Optional[Callable] = None, draws: Optional[Dict[str, Any]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One group of ``len(frames)`` frames (``frames[0]``, the head, is
        mapped) from the device pose vectors ``p1``, ``p2`` of the two frames
        before it: the head program; its pose fetched (the group's one host
        sync) and set on the head frame; the point insertion at that pose;
        the window's slots; the tail program. ``run(key, program, inputs)``
        runs a program (by default ``self.graphs``: a CUDA graph replay on
        the card, eager on the CPU). ``draws`` may hold pre-drawn ``head``
        samples, the insertion's ``pick``, the window's ``slots`` and the
        tail's ``tail`` samples (``tail_step``'s). Returns the group's (t [G,
        3], q [G, 4]) on the device."""
        cfg = self.config
        if do_kf and self.kf_count >= cfg.max_keyframes:
            raise RuntimeError("keyframe capacity exceeded; raise max_keyframes")
        run = self.graphs if run is None else run
        draws = draws or {}
        group, cur = len(frames), frames[0]
        rgbdrs = [self._frame_rgbdr(f) for f in frames]
        (best,) = run(("head",), lambda *x: (self.head_step(*x, samples=draws.get("head")),), [rgbdrs[0], p1, p2])
        bp = PendingFetch(best).wait()[0]
        cur.t, cur.r = bp[:3].copy(), bp[3:].copy()
        self.add_points_from_frame(cur, cfg.pixels_adding, pick=draws.get("pick"))
        slots = draws["slots"] if "slots" in draws else self._window_slots()
        n_grad = cfg.mapping_pixels_based_on_color_grad
        key = (group, cfg.mapping_n_iters, n_grad, do_kf)

        def tail(*x: torch.Tensor):
            grad_uv = x[group + 5] if n_grad > 0 else None
            return self.tail_step(x[:group], *x[group:group + 5], grad_uv, do_kf, samples=draws.get("tail"))

        wn = cfg.mapping_window_size
        inputs = rgbdrs + [best, p1, self._index(slots + [0] * (wn - 1 - len(slots))), self._index(len(slots) + 1),
                           self._index([self.kf_count])]
        if n_grad > 0:
            gu, gv = self._top_grad_pixels(cur.rgb, n_grad)
            inputs.append(self._index(np.stack([gu, gv], -1)))
        pt, pq = run(key, tail, inputs)
        if do_kf:
            self.kf_count += 1
            self.keyframe_fids.append(cur.fid)
        return pt, pq

    def dispatch_superstep(self, frames: List[Frame], do_kf: bool, prev_c2w: Optional[np.ndarray] = None,
                           prev2_c2w: Optional[np.ndarray] = None,
                           prev_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           prev2_tr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """``group_step`` on ``frames`` through the graphs; requires
        ``is_initialized()``. The predecessor poses come as host matrices or
        as the device (t, q) of the previous group's output. Returns the
        handle for ``finish_superstep``: the group's device poses (t [G, 3],
        q [G, 4]) and their copy to the host, under way."""
        if prev_tr is None:
            prev_tr, prev2_tr = (tuple(self._tensor(v) for v in lie_np.matrix_to_pose_vec(
                np.asarray(c2w, np.float32), rot_rep="quat")) for c2w in (prev_c2w, prev2_c2w))
        pt, pq = self.group_step(frames, do_kf, torch.cat(prev_tr), torch.cat(prev2_tr))
        return pt, pq, PendingFetch(pt, pq)

    def finish_superstep(self, handle) -> List[np.ndarray]:
        """One pose fetch for the whole group -> its c2w matrices."""
        pt, pq = handle[2].wait()
        return [lie_np.pose_vec_to_matrix(pt[j], pq[j], rot_rep="quat") for j in range(pt.shape[0])]

    _host_state = ("kf_count",)
    _torch_generators = ("generator",)
    _numpy_generators = ("rng",)

    def _named_state(self) -> Dict[str, List[torch.Tensor]]:
        """The state tensors: the model's parameters, the device map's keys
        and rows, then the keyframe table and poses."""
        return {"model_params": list(self.model.parameters()), "cell_keys": [self.maps["cell_keys"]],
                "cell_data": [self.maps["cell_data"]], "kf_images": [self.kf_images], "kf_pose": [self.kf_pose]}

    def host_state(self) -> Dict[str, Any]:
        """The base's and the host point map (its arrays and counts)."""
        d = super().host_state()
        d["point_map"] = copy.deepcopy(vars(self.point_map))
        return d

    def restore_host_state(self, d: Dict[str, Any]) -> None:
        super().restore_host_state(d)
        self.point_map = PointMap.__new__(PointMap)
        vars(self.point_map).update(d.pop("point_map"))
        self.maps["n_points"] = self.point_map.n_points

    def checkpoint_state(self) -> Dict[str, Any]:
        """The base's without the device map, which holds the host point
        map's rows bit for bit."""
        d = super().checkpoint_state()
        del d["cell_keys"], d["cell_data"]
        return d

    def restore_state(self, d: Dict[str, Any]) -> None:
        """The device map's keys and rows refilled, in place, from the host
        point map."""
        d["cell_keys"], d["cell_data"] = [d["point_map"]["cell_keys"]], [d["point_map"]["cell_data"]]
        super().restore_state(d)

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
        best, _ = self.track_step(self._frame_rgbdr(cur_frame), self._pose_vec(cur_frame))
        return best

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        if handle is None:
            return None
        bp = handle.cpu().numpy()
        return lie_np.pose_vec_to_matrix(bp[:3], bp[3:], rot_rep="quat")

    def do_mapping(self, cur_frame: Frame) -> None:
        cfg = self.config
        first = not self.is_initialized()
        self.add_points_from_frame(cur_frame, cfg.pixels_adding)
        slots = self._window_slots()
        cur_img = self._frame_rgbdr(cur_frame)[None]
        cur_pose = self._pose_vec(cur_frame)
        idx = self._index(slots)
        images = torch.cat([self.kf_images[idx], cur_img], 0)
        poses = torch.cat([self.kf_pose[idx], cur_pose[None]], 0)
        images, poses = self.pad_window(images, poses, cur_img, cur_pose, cfg.mapping_window_size)
        n_grad = cfg.mapping_pixels_based_on_color_grad
        grad_uv = None
        if n_grad > 0:
            gu, gv = self._top_grad_pixels(cur_frame.rgb, n_grad)
            grad_uv = torch.as_tensor(np.stack([gu, gv], -1), device=self.device)
        self.map_step(images, poses, len(slots) + 1, cfg.mapping_first_n_iters if first else cfg.mapping_n_iters,
                      grad_uv)
        if first:
            self.set_initialized()

    def add_keyframe(self, keyframe: Frame) -> None:
        if self.kf_count >= self.config.max_keyframes:
            raise RuntimeError("keyframe capacity exceeded; raise max_keyframes")
        slot = self.kf_count
        self.kf_images[slot] = self._frame_rgbdr(keyframe)
        self.kf_pose[slot] = self._pose_vec(keyframe)
        self.kf_count += 1
        self.keyframe_fids.append(keyframe.fid)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_img(self, c2w: np.ndarray, gt_depth: Optional[np.ndarray] = None, idx: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb [H, W, 3] in [0, 1], depth [H, W]) rendered at ``c2w`` in
        chunks of ``ray_batch_size`` rays at the largest query radius; the
        last chunk is padded as the reference pads it, since rays without
        depth sample by a statistic of their chunk. ``idx`` (the frame's
        index) is the reference's signature and unused."""
        cam = self.camera
        c2w = self._tensor(c2w)
        rays_d = self._dirs.reshape(-1, 3) @ c2w[:3, :3].T
        rays_o = c2w[:3, 3].expand(rays_d.shape)
        n = rays_d.shape[0]
        gt = torch.zeros((n, 1), device=self.device) if gt_depth is None else self._tensor(gt_depth).reshape(-1, 1)
        bs = self.config.ray_batch_size
        rq = torch.full((bs,), self.model.max_query_radius(), device=self.device)
        dep, col = [], []
        for i in range(0, n, bs):
            ro, rd, td = rays_o[i:i + bs], rays_d[i:i + bs], gt[i:i + bs]
            pad = bs - ro.shape[0]
            if pad > 0:
                ro = torch.cat([ro, torch.zeros((pad, 3), device=self.device)])
                rd = torch.cat([rd, torch.ones((pad, 3), device=self.device)])
                td = torch.cat([td, torch.zeros((pad, 1), device=self.device)])
            out = self.model.render_rays(self.maps, ro, rd, td, "color", r_query=rq)
            dep.append(out["depth"][:bs - pad])
            col.append(out["rgb"][:bs - pad])
        rgb = torch.clamp(torch.cat(col), 0, 1).reshape(cam.height, cam.width, 3)
        return rgb.cpu().numpy(), torch.cat(dep).reshape(cam.height, cam.width).cpu().numpy()

    @torch.no_grad()
    def get_mesh(self) -> Optional[Mesh]:
        """TSDF fusion of the keyframes, each rendered at its pose with its
        own depth as the samples' guide (the rendered depth kept where the
        keyframe has depth), over the stored points' box grown by 0.2 m at
        ``mesh_resolution`` voxels along its longest side; None without
        keyframes or points."""
        n = self.point_map.n_points
        if self.kf_count == 0 or n == 0:
            return None
        pts = self.point_map.pos[:n]
        lo, hi = pts.min(0) - 0.2, pts.max(0) + 0.2
        vol = TSDFVolume(np.stack([lo, hi], -1), voxel_size=float((hi - lo).max()) / self.config.mesh_resolution,
                         device=self.device)
        kf_pose = self.kf_pose[:self.kf_count].cpu().numpy()
        for i in range(self.kf_count):
            c2w = lie_np.pose_vec_to_matrix(kf_pose[i, :3], kf_pose[i, 3:], rot_rep="quat")
            kf_depth = self.kf_images[i, ..., 3]
            color, depth = self.render_img(c2w, gt_depth=kf_depth.cpu().numpy())
            depth = torch.where(kf_depth > 0, self._tensor(depth), torch.zeros_like(kf_depth))
            vol.integrate(self._tensor(color), depth, c2w, self.camera)
        return vol.extract_mesh()
