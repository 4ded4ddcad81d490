"""Single-process SLAM pipeline: tracking and mapping alternate on one device.

Counterpart of ``xrdslam_tpu/pipeline/slam.py``: constant-velocity pose
prediction, relative-pose mode with its initial offset, map_every /
keyframe_every / lazy-start gating, final-frame forcing, the next frames'
images prefetched to the device, and the ``eval.tar`` trajectory archive.
Mesh and render outputs (debug images, re-render metrics), checkpoints, the
visualizer and trace frames come later.

The group path is the reference package's: where the algorithm has a
group step (Co-SLAM's ``dispatch_superstep``), each ``map_every``-frame
group after the warm-up frames is one device program (a CUDA graph replay
on the card, eager on the CPU), seeded from the previous group's device
poses, and the previous group's poses are fetched while the next one runs.
``XRDSLAM_DISABLE_SUPER=1`` runs every frame through the per-frame path
(the A/B hatch).

The run's device is ``SLAMPipelineConfig.device``; asking for CUDA on a
machine without it raises, and nothing falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple, Type

import numpy as np
import torch

from ..algorithms.base import Algorithm
from ..common.frame import Frame
from ..configs.base import InstantiateConfig


def resolve_device(name: str) -> torch.device:
    """The run's device; raises if CUDA is asked for and absent.

    On CUDA, float32 matrix products and convolutions are pinned to full
    fp32 (no TF32), so that the port computes what the reference computes.
    """
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device


@dataclass
class TrackerConfig(InstantiateConfig):
    _target: Type = field(default_factory=lambda: object)
    map_every: int = 1
    lazy_start: int = -1  # frames up to this index are all mapped
    use_relative_pose: bool = False  # poses relative to the first frame's
    save_debug_result: bool = False  # debug images: not ported yet, raises
    init_pose_offset: float = 0.0  # added to the first pose's translation in relative-pose mode


@dataclass
class MapperConfig(InstantiateConfig):
    _target: Type = field(default_factory=lambda: object)
    keyframe_every: int = 50


@dataclass
class SLAMPipelineConfig(InstantiateConfig):
    _target: Type = field(default_factory=lambda: SLAMPipeline)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    algorithm: InstantiateConfig = field(default_factory=InstantiateConfig)
    device: str = "cuda"


class SLAMPipeline:
    def __init__(self, config: SLAMPipelineConfig, dataset, out_dir: str = "outputs", verbose: bool = True) -> None:
        self.config = config
        self.dataset = dataset
        self.out_dir = out_dir
        self.verbose = verbose
        if config.tracker.save_debug_result:
            raise NotImplementedError("debug image output is not ported yet (ROADMAP Queue 1)")
        self.device = resolve_device(config.device)
        self.camera = dataset.get_camera()
        self.algorithm: Algorithm = config.algorithm.setup(camera=self.camera, device=self.device)
        os.makedirs(out_dir, exist_ok=True)
        self.frame_times: List[float] = []
        self.phase_times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Host wall time of a phase. Each phase ends with its pose on the
        host, so the time includes the phase's device work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_times[name].append(time.perf_counter() - t0)

    def predict_current_pose(self, frame_id: int, gt_c2w: np.ndarray) -> np.ndarray:
        """Constant-velocity motion model."""
        est = self.algorithm.get_estimate_c2w_list()
        if frame_id < 1:
            return gt_c2w
        if frame_id == 1:
            return est[0]
        delta = est[frame_id - 1] @ np.linalg.inv(est[frame_id - 2])
        pred = delta @ est[frame_id - 1]
        if not np.isfinite(pred).all():
            return est[frame_id - 1]
        # re-orthonormalize the rotation (f32 products drift ~1e-3/frame)
        u, _, vt = np.linalg.svd(pred[:3, :3])
        pred[:3, :3] = u @ vt
        return pred

    def _gt_transform(self, i: int, gt_c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ground truth in the run's frame, original ground truth). In
        relative-pose mode the first pose becomes the identity, shifted by
        ``init_pose_offset``, and later poses follow it."""
        cfg_t = self.config.tracker
        gt_c2w_ori = gt_c2w.copy()
        if cfg_t.use_relative_pose:
            if i == 0:
                self._first_pose_old = gt_c2w.copy()
                gt_c2w = np.eye(4, dtype=np.float32)
                gt_c2w[:3, 3] += cfg_t.init_pose_offset
                self._first_pose_new = gt_c2w.copy()
            else:
                delta = np.linalg.inv(self._first_pose_old) @ gt_c2w
                gt_c2w = (self._first_pose_new @ delta).astype(np.float32)
        return gt_c2w, gt_c2w_ori

    def _load_frame(self, i: int):
        """(rgb, depth, gt, rgb_dev | None, depth_dev | None), taking the
        prefetched images where there are some."""
        hit = self._pending.pop(i, None)
        if hit is not None:
            return hit
        _, rgb, depth, gt_c2w = self.dataset[i]
        return rgb, depth, gt_c2w, None, None

    def _prefetch_frame(self, i: int) -> None:
        """Read frame ``i`` and start its upload (``Frame``'s own path, so
        that the images are those of a frame read when needed)."""
        if i in self._pending or i >= len(self.dataset):
            return
        _, rgb, depth, gt = self.dataset[i]
        tmp = Frame(fid=i, rgb=rgb, depth=depth)
        self._pending[i] = (rgb, depth, gt, tmp.rgb_dev(self.device), tmp.depth_dev(self.device))

    def run(self) -> None:
        cfg_t = self.config.tracker
        algo = self.algorithm
        n = len(self.dataset)
        self._first_pose_old = self._first_pose_new = None
        self._pending: Dict[int, tuple] = {}
        self._pending_super = None
        self._last_group_done = None
        # the group path: one device program per map_every frames (track the
        # head, map it, keyframe, track the rest), one pose fetch per group.
        # The warm-up frames, the lazy-start region, the last group (the
        # final frame is always mapped) and off-cycle frames go per frame.
        group = cfg_t.map_every
        use_super = (
            group >= 1
            and hasattr(algo, "dispatch_superstep")
            and self.config.mapper.keyframe_every % group == 0
            and os.environ.get("XRDSLAM_DISABLE_SUPER", "0") != "1"  # A/B hatch
        )
        self._dev_pose_hist: List[tuple] = []  # the last two (t, r) device pose vectors
        self.groups: List[int] = []  # the head of each group dispatched
        i = 0
        while i < n:
            if (
                use_super
                and i % group == 0
                # >= 2 * group (not just >= 2): the per-frame frames before it
                # run every op of the group once, eagerly
                and i >= max(2 * group, 2)
                and i > cfg_t.lazy_start + group
                and i + group < n
                and algo.is_initialized()
            ):
                self.groups.append(i)
                i = self._super_group(i, n, group)
            else:
                self._flush_super()  # per-frame work needs the host poses current
                self._dev_pose_hist = []  # re-seed the prediction from host poses
                self._frame_step(i, n)
                i += 1
        self._flush_super()
        self._finish_run()

    def _super_group(self, i: int, n: int, group: int) -> int:
        """Dispatch frames [i, i + group) as one device program, then fetch
        the previous group's poses while this one runs. The prediction for
        this group starts from the previous group's poses on the device, so
        the dispatch waits for nothing: the card runs group after group
        while the host fetches the lagging poses and reads and uploads the
        next group's frames."""
        algo = self.algorithm
        t0 = time.time()
        gts, frames = [], []
        for j in range(i, i + group):
            rgb, depth, gt, rgb_dev, depth_dev = self._load_frame(j)
            gts.append(self._gt_transform(j, gt))
            fr = Frame(fid=j, rgb=rgb, depth=depth, rot_rep=algo.config.rot_rep)
            if rgb_dev is not None:
                fr._rgb_dev, fr._depth_dev = rgb_dev, depth_dev
            frames.append(fr)
        do_kf = i % self.config.mapper.keyframe_every == 0
        if not self._dev_pose_hist:
            est = algo.estimate_c2w_list
            handle = algo.dispatch_superstep(frames, do_kf, est[i - 1], est[i - 2])
        else:
            # with group = 1 the second group has one device pose in the
            # history; repeating it predicts a constant position for that
            # one frame (tracking recovers it)
            hist = self._dev_pose_hist
            handle = algo.dispatch_superstep(frames, do_kf, prev_tr=hist[-1], prev2_tr=hist[-2 if len(hist) >= 2 else -1])
        pt, pr = handle[0], handle[1]
        self._dev_pose_hist = (self._dev_pose_hist + [(pt[j], pr[j]) for j in range(pt.shape[0])])[-2:]
        # the next group's reads and uploads overlap the programs under way
        for j in range(i + group, min(i + 2 * group, n)):
            self._prefetch_frame(j)
        prev_pending = self._pending_super
        self._pending_super = (gts, handle, t0)
        if prev_pending is not None:
            self._finish_group(prev_pending)
        if self.verbose and (i // group) % 4 == 0 and self.frame_times:
            fps = 1.0 / max(np.mean(self.frame_times[-20:]), 1e-9)
            print(f"[slam] frame {i}/{n}  {fps:.2f} fps", flush=True)
        return i + group

    def _finish_group(self, pending) -> None:
        """Fetch one dispatched group's poses and record them. A group's
        frames each take the time since the previous group's finish (the
        first group: since its dispatch) over the group size: the steady
        throughput of the pipelined groups."""
        gts, handle, t0 = pending
        algo = self.algorithm
        with self.phase("super_group"):
            poses = algo.finish_superstep(handle)
        for c2w, (gt, gt_ori) in zip(poses, gts):
            algo.add_framepose(c2w, gt, gt_ori)
        now = time.time()
        t_ref = self._last_group_done if self._last_group_done is not None else t0
        self._last_group_done = now
        self.frame_times.extend([max(now - t_ref, 1e-9) / len(poses)] * len(poses))

    def _flush_super(self) -> None:
        """Finish the group under way, if any (the host catches up with the
        device)."""
        if self._pending_super is not None:
            pending, self._pending_super = self._pending_super, None
            self._finish_group(pending)

    def _frame_step(self, i: int, n: int) -> None:
        cfg_t = self.config.tracker
        cfg_m = self.config.mapper
        algo = self.algorithm
        rgb, depth, gt_c2w, rgb_dev, depth_dev = self._load_frame(i)
        gt_c2w, gt_c2w_ori = self._gt_transform(i, gt_c2w)

        t0 = time.time()
        init_pose = self.predict_current_pose(i, gt_c2w)
        frame = Frame(fid=i, rgb=rgb, depth=depth, init_pose=init_pose, gt_pose=gt_c2w, rot_rep=algo.config.rot_rep)
        frame.is_final_frame = i == n - 1
        if rgb_dev is not None:
            frame._rgb_dev, frame._depth_dev = rgb_dev, depth_dev

        with self.phase("tracking"):
            handle = algo.dispatch_tracking(frame)
            # the next frame's read and upload overlap the tracking under way
            self._prefetch_frame(i + 1)
            candidate = algo.finish_tracking(handle)
        if candidate is not None and algo.is_initialized():
            frame.set_pose(candidate)
        algo.add_framepose(frame.get_pose(), gt_c2w, gt_c2w_ori)

        map_every = 1 if i <= cfg_t.lazy_start else cfg_t.map_every
        if map_every != -1 and (i % map_every == 0 or frame.is_final_frame):
            with self.phase("mapping"):
                algo.do_mapping(frame)
            algo.update_framepose(i, frame.get_pose())
            if i % cfg_m.keyframe_every == 0:
                algo.add_keyframe(frame)
        self.frame_times.append(time.time() - t0)

        if self.verbose and (i % 20 == 0 or frame.is_final_frame):
            fps = 1.0 / max(np.mean(self.frame_times[-20:]), 1e-9)
            print(f"[slam] frame {i}/{n}  {fps:.2f} fps", flush=True)

    def _finish_run(self) -> None:
        self.save_eval_tar()
        summary = {k: {"total_s": sum(v), "count": len(v), "mean_ms": 1e3 * sum(v) / len(v)}
                   for k, v in sorted(self.phase_times.items())}
        with open(os.path.join(self.out_dir, "timings.json"), "w") as f:
            json.dump(summary, f, indent=2)

    def save_eval_tar(self) -> None:
        """Trajectory archive for evaluation (the reference package's keys)."""
        algo = self.algorithm
        data = {
            "gt_c2w_list": [np.asarray(p) for p in algo.gt_c2w_list],
            "gt_c2w_list_ori": [np.asarray(p) for p in algo.gt_c2w_list_ori],
            "estimate_c2w_list": [np.asarray(p) for p in algo.estimate_c2w_list],
            "idx": len(algo.estimate_c2w_list) - 1,
        }
        with open(os.path.join(self.out_dir, "eval.tar"), "wb") as f:
            pickle.dump(data, f)
