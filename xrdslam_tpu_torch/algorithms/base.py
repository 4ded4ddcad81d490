"""Algorithm base: host-side state around the tracking/mapping steps.

Counterpart of ``xrdslam_tpu/algorithms/base.py`` without the multi-device
helpers: the finite-gradient guard, the tracking lr schedule, the static
mapping window (``window_slot_frame``, ``pad_window``, and on the device
``window_arrays``), the group steps' constant-velocity prediction
(``predict_q``), the host bookkeeping (pose lists, keyframe ids), the
outputs' defaults for an algorithm without them (``render_img``,
``get_mesh``, ``get_cloud``) and the state's two pairs, the checkpoint's
(``checkpoint_state`` / ``restore_state``, host copies) and the
in-process copy's (``save_state`` / ``load_state``, device clones), both
over one declaration: an algorithm's named device tensors
(``_named_state``) and its host state (``host_state``: host attributes
and generators).
"""
from __future__ import annotations

import copy
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame
from ..configs.base import InstantiateConfig
from ..engine.optimizers import OptimizerConfig, pieces, unpieces
from ..models.base import ModelConfig
from ..ops import lie


def default_optimizers() -> Dict[str, Any]:
    return {
        "model": {"optimizer": OptimizerConfig(lr=1e-2), "scheduler": None},
        "tracking_pose": {"optimizer": OptimizerConfig(lr=1e-2), "scheduler": None},
        "mapping_pose": {"optimizer": OptimizerConfig(lr=1e-3), "scheduler": None},
    }


@dataclass
class AlgorithmConfig(InstantiateConfig):
    """The reference package's AlgorithmConfig, less its multi-device field."""

    _target: Type = field(default_factory=lambda: Algorithm)
    model: ModelConfig = field(default_factory=ModelConfig)
    tracking_n_iters: int = 10
    # <1.0: decay the tracking-pose lr over the second half of each frame's
    # iterations down to lr*decay at the last one (see _tracking_lr_schedule)
    tracking_lr_decay: float = 1.0
    mapping_n_iters: int = 60
    mapping_first_n_iters: int = 200
    mapping_window_size: int = 5
    rot_rep: str = "axis_angle"
    optimizers: Dict[str, Any] = field(default_factory=default_optimizers)


class Algorithm:
    def __init__(self, config: AlgorithmConfig, camera: Camera, device: torch.device) -> None:
        self.config = config
        self.camera = camera
        self.device = torch.device(device)
        self.initialized = False
        self.gt_c2w_list: List[np.ndarray] = []
        self.gt_c2w_list_ori: List[np.ndarray] = []
        self.estimate_c2w_list: List[np.ndarray] = []
        self.keyframe_fids: List[int] = []
        self._nonfinite_poses = 0

    @staticmethod
    def _finite_guard(loss: torch.Tensor, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Zero every gradient when the loss or any gradient entry is not finite.

        As in the reference, this weakens a bad step rather than skipping
        it: Adam still steps on its momentum. Evaluated on the device; no
        host sync.
        """
        parts = pieces(grads)  # a few kernels whatever the number of small tensors
        ok = torch.isfinite(loss)
        for p in parts:
            ok = ok & torch.isfinite(p).all()
        zero = torch.zeros((), dtype=parts[0].dtype, device=parts[0].device)
        return unpieces([torch.where(ok, p, zero) for p in parts], grads)

    def _tracking_lr_schedule(self, lr0: float) -> Optional[Callable[[int], float]]:
        """Per-frame tracking lr schedule, or None when decay is disabled:
        full lr for the first half of the iterations, then exponential decay
        to ``lr0 * tracking_lr_decay`` at the last one."""
        decay = self.config.tracking_lr_decay
        if decay >= 1.0:
            return None
        n = max(self.config.tracking_n_iters - 1, 1)

        def sched(step: int) -> float:
            frac = min(max(2.0 * step / n - 1.0, 0.0), 1.0)
            return lr0 * decay ** frac

        return sched

    @staticmethod
    def window_slot_frame(f: int, n_valid: int, n_slots: int) -> int:
        """Static-window slot -> frame index, ``((f + 1) n_valid - 1) // n_slots``:
        spreads ``n_slots`` ray slots over the ``n_valid`` real frames as
        evenly as possible (the surplus to the newest), monotone, and always
        maps the last slot to the current frame."""
        return ((f + 1) * n_valid - 1) // n_slots

    @staticmethod
    def pad_window(images: torch.Tensor, poses: torch.Tensor, cur_img: torch.Tensor, cur_pose: torch.Tensor,
                   pad_to: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad window tensors to the static window size by repeating the
        current frame (``cur_img`` [1, ...], ``cur_pose`` [P]); padded slots
        are never read, since ``window_slot_frame`` stays below n_valid."""
        pad = pad_to - images.shape[0]
        if pad > 0:
            images = torch.cat([images, cur_img.expand(pad, *cur_img.shape[1:])], 0)
            poses = torch.cat([poses, cur_pose[None].expand(pad, -1)], 0)
        return images, poses

    def window_arrays(self, slots: torch.Tensor, n_valid: torch.Tensor, cur_img: torch.Tensor,
                      cur_pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rows of the keyframe tables ``kf_images`` / ``kf_pose`` (of an
        algorithm that keeps them) at ``slots`` [S - 1], then the current
        frame, which also fills every row from ``n_valid - 1`` on, all on the
        device: (images [S, H, W, C], poses [S, 7]). The same frames as
        ``pad_window`` on the gathered keyframes."""
        images = torch.cat([torch.index_select(self.kf_images, 0, slots), cur_img[None]], 0)
        poses = torch.cat([torch.index_select(self.kf_pose, 0, slots), cur_pose[None]], 0)
        is_cur = torch.arange(images.shape[0], device=images.device) >= n_valid - 1
        images = torch.where(is_cur[:, None, None, None], cur_img[None], images)
        poses = torch.where(is_cur[:, None], cur_pose[None], poses)
        return images, poses

    @staticmethod
    def predict_q(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        """The constant-velocity model on the device, from the last pose
        vector (t, q) and the one before it: delta = P1 inv(P2), pred =
        delta P1."""
        R1 = lie.quaternion_to_matrix(p1[3:])
        R2 = lie.quaternion_to_matrix(p2[3:])
        dR = R1 @ R2.T
        dt = p1[:3] - dR @ p2[:3]
        return torch.cat([dR @ p1[:3] + dt, lie.matrix_to_quaternion(dR @ R1)])

    # -- host bookkeeping --------------------------------------------------
    def add_framepose(self, c2w: np.ndarray, gt_c2w: np.ndarray, gt_c2w_ori: np.ndarray) -> None:
        """Record a frame's estimate, its ground truth in the run's frame
        (relative to the first pose in relative-pose mode) and the original
        ground truth."""
        c2w = np.asarray(c2w)
        if not np.isfinite(c2w).all():
            self._on_nonfinite_pose(len(self.estimate_c2w_list))
            # survivable: keep the previous pose so the downstream SVD and
            # eval math stay defined while the warning flags the run
            if self.estimate_c2w_list:
                c2w = self.estimate_c2w_list[-1]
        self.estimate_c2w_list.append(c2w)
        self.gt_c2w_list.append(np.asarray(gt_c2w))
        self.gt_c2w_list_ori.append(np.asarray(gt_c2w_ori))

    def _on_nonfinite_pose(self, idx: int) -> None:
        self._nonfinite_poses += 1
        if self._nonfinite_poses <= 5:
            print(f"[slam] WARNING: non-finite pose at frame {idx}", file=sys.stderr, flush=True)

    def update_framepose(self, idx: int, c2w: np.ndarray) -> None:
        c2w = np.asarray(c2w)
        if not np.isfinite(c2w).all():
            # a non-finite refinement must not overwrite the finite entry
            # that the constant-velocity predictor reads next frame
            self._on_nonfinite_pose(idx)
            return
        self.estimate_c2w_list[idx] = c2w

    # -- state: checkpoints (engine/checkpoint.py) and in-process copies ----
    # host attributes saved as they are, torch generators by their state and
    # numpy generators by their bit generator's state
    _host_state: Tuple[str, ...] = ()
    _torch_generators: Tuple[str, ...] = ()
    _numpy_generators: Tuple[str, ...] = ()
    _BASE_HOST_STATE = ("initialized", "estimate_c2w_list", "gt_c2w_list", "gt_c2w_list_ori", "keyframe_fids",
                        "_nonfinite_poses")

    def _named_state(self) -> Dict[str, List[torch.Tensor]]:
        """The device state tensors by name (the JAX package's attribute
        names where the state is the same), in ``_state_tensors``' order."""
        return {}

    def _state_tensors(self) -> List[torch.Tensor]:
        return [t for ts in self._named_state().values() for t in ts]

    def host_state(self) -> Dict[str, Any]:
        """Host copies of the state outside ``_named_state``: generators,
        ``_host_state`` and the base's bookkeeping. Subclasses add what
        their attribute names cannot say."""
        d: Dict[str, Any] = {}
        for name in self._torch_generators:
            d[name] = getattr(self, name).get_state().numpy().copy()
        for name in self._numpy_generators:
            d[name] = copy.deepcopy(getattr(self, name).bit_generator.state)
        for name in self._host_state + self._BASE_HOST_STATE:
            d[name] = copy.deepcopy(getattr(self, name))
        return d

    def restore_host_state(self, d: Dict[str, Any]) -> None:
        """Take back a ``host_state``, taking its entries out of ``d``."""
        for name in self._torch_generators:
            getattr(self, name).set_state(torch.from_numpy(d.pop(name)))
        for name in self._numpy_generators:
            getattr(self, name).bit_generator.state = d.pop(name)
        for name in self._host_state + self._BASE_HOST_STATE:
            setattr(self, name, d.pop(name))

    def checkpoint_state(self) -> Dict[str, Any]:
        """Host copies of everything the next frame reads: numpy arrays and
        plain Python values, no tensor."""
        d: Dict[str, Any] = {k: [t.detach().to("cpu", copy=True).numpy() for t in ts]
                             for k, ts in self._named_state().items()}
        d.update(self.host_state())
        return d

    def restore_state(self, d: Dict[str, Any]) -> None:
        """Take back a ``checkpoint_state``, taking its entries out of ``d``.
        The device tensors are written in place; a tensor of another shape
        or type raises ``ValueError``."""
        with torch.no_grad():
            for k, ts in self._named_state().items():
                arrays = d.pop(k)
                if len(arrays) != len(ts):
                    raise ValueError(f"checkpoint entry {k!r} holds {len(arrays)} tensors, the algorithm {len(ts)}")
                for t, a in zip(ts, arrays):
                    src = torch.from_numpy(np.asarray(a))
                    if src.shape != t.shape or src.dtype != t.dtype:
                        raise ValueError(f"checkpoint entry {k!r}: {src.dtype} {tuple(src.shape)} does not fit "
                                         f"{t.dtype} {tuple(t.shape)} (another configuration?)")
                    t.copy_(src)
        self.restore_host_state(d)

    def save_state(self):
        """An in-process copy of the state: device clones of the state
        tensors and ``host_state()``."""
        return [t.detach().clone() for t in self._state_tensors()], self.host_state()

    def load_state(self, saved) -> None:
        """Put back a ``save_state`` copy, the device tensors in place."""
        tensors, host = saved
        with torch.no_grad():
            for dst, src in zip(self._state_tensors(), tensors):
                dst.copy_(src)
        self.restore_host_state(copy.deepcopy(host))

    def get_estimate_c2w_list(self) -> List[np.ndarray]:
        return self.estimate_c2w_list

    def is_initialized(self) -> bool:
        return self.initialized

    def set_initialized(self) -> None:
        self.initialized = True

    # -- to implement ------------------------------------------------------
    def dispatch_tracking(self, cur_frame: Frame):
        """Launch tracking; return a handle for finish_tracking (None before
        the map exists)."""
        raise NotImplementedError

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        raise NotImplementedError

    def do_mapping(self, cur_frame: Frame) -> None:
        raise NotImplementedError

    def add_keyframe(self, cur_frame: Frame) -> None:
        raise NotImplementedError

    # -- outputs (an algorithm without them keeps these) ------------------
    def render_img(self, c2w: np.ndarray, gt_depth: Optional[np.ndarray] = None, idx: Optional[int] = None):
        """(color [H, W, 3], depth [H, W]) at ``c2w``; (None, None) for an
        algorithm that renders no image, which ends the post-run sweep."""
        return None, None

    def get_mesh(self):
        """The reconstruction as a ``utils.io.Mesh``, or None."""
        return None

    def get_cloud(self, c2w_np: np.ndarray, gt_depth_np: Optional[np.ndarray]):
        """(points, colours) of the map, or None."""
        return None
