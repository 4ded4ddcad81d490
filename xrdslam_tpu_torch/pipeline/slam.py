"""Single-process SLAM pipeline: tracking and mapping alternate per frame.

Counterpart of the per-frame path of ``xrdslam_tpu/pipeline/slam.py``:
constant-velocity pose prediction, relative-pose mode with its initial
offset, map_every / keyframe_every / lazy-start gating, final-frame
forcing and the ``eval.tar`` trajectory archive. Mesh and render outputs
(debug images, re-render metrics) come later.

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

    def run(self) -> None:
        n = len(self.dataset)
        self._first_pose_old = self._first_pose_new = None
        for i in range(n):
            self._frame_step(i, n)
        self._finish_run()

    def _frame_step(self, i: int, n: int) -> None:
        cfg_t = self.config.tracker
        cfg_m = self.config.mapper
        algo = self.algorithm
        _, rgb, depth, gt_c2w = self.dataset[i]
        gt_c2w, gt_c2w_ori = self._gt_transform(i, gt_c2w)

        t0 = time.time()
        init_pose = self.predict_current_pose(i, gt_c2w)
        frame = Frame(fid=i, rgb=rgb, depth=depth, init_pose=init_pose, rot_rep=algo.config.rot_rep)
        frame.is_final_frame = i == n - 1

        with self.phase("tracking"):
            candidate = algo.finish_tracking(algo.dispatch_tracking(frame))
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
