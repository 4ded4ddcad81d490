"""Per-frame container: images + pose vector.

Counterpart of ``xrdslam_tpu/common/frame.py``. The pose is a host (t, r)
numpy pair; the trainable copy lives inside the tracking/mapping steps.
``gt_pose`` is the frame's ground-truth c2w, where the pipeline knows it
(NeuralRecon's tracking returns it).
``rgb_dev`` / ``depth_dev`` give the images as device tensors, cached; to
a card they go up through pinned host memory without a wait
(``non_blocking``), so that the pipeline can upload the next frames while
the card works.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import lie_np as lie


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to a card from pinned memory, enqueued on
    the current stream (the caching host allocator keeps the pinned buffer
    until the copy is done)."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Frame:
    def __init__(
        self,
        fid: int,
        rgb: Optional[np.ndarray],
        depth: Optional[np.ndarray],
        init_pose: Optional[np.ndarray] = None,
        gt_pose: Optional[np.ndarray] = None,
        rot_rep: str = "axis_angle",
    ) -> None:
        self.fid = fid
        self.rgb = rgb
        self.depth = depth
        self.gt_pose = gt_pose
        self.rot_rep = rot_rep
        self.is_final_frame = False
        self.t: Optional[np.ndarray] = None
        self.r: Optional[np.ndarray] = None
        self._rgb_dev: Optional[torch.Tensor] = None
        self._depth_dev: Optional[torch.Tensor] = None
        if init_pose is not None:
            self.set_pose(np.asarray(init_pose, np.float32), check=True)

    def rgb_dev(self, device: torch.device) -> torch.Tensor:
        """rgb [H, W, 3] f32 on ``device``, after the reference's uint16 round
        trip (lossless for 8-bit sources, 1/65535 steps for float-rendered
        ones) so that both packages see the same pixel values."""
        if self._rgb_dev is None:
            q = (np.clip(self.rgb, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
            self._rgb_dev = upload(q.astype(np.float32) / np.float32(65535.0), device)
        return self._rgb_dev

    def depth_dev(self, device: torch.device) -> torch.Tensor:
        if self._depth_dev is None:
            self._depth_dev = upload(np.ascontiguousarray(self.depth, np.float32), device)
        return self._depth_dev

    def set_pose(self, c2w: np.ndarray, check: bool = False) -> None:
        self.t, self.r = lie.matrix_to_pose_vec(np.asarray(c2w, np.float32), rot_rep=self.rot_rep)
        if check:
            back = lie.pose_vec_to_matrix(self.t, self.r, rot_rep=self.rot_rep)
            # 5e-3, as the reference: composed f32 pose predictions drift from
            # orthonormality by ~1e-3 and the vector round trip
            # re-orthonormalizes
            if not np.allclose(np.asarray(c2w), back, atol=5e-3):
                raise ValueError("Transformation inconsistency detected!", c2w, back)

    def get_pose(self) -> np.ndarray:
        return lie.pose_vec_to_matrix(self.t, self.r, rot_rep=self.rot_rep)
