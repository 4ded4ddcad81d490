"""NeuralRecon: incremental TSDF reconstruction from posed RGB.

Counterpart of ``xrdslam_tpu/algorithms/neural_recon.py``. Poses are not
optimised: tracking returns the frame's ground-truth pose, flipped to the
reference's camera convention and offset by ``c2w_offset``. The work is
the fragment update of ``models/neucon.py``, one call over fixed-size
dense volumes each time ``mapping_window_size`` + 1 keyframes have
gathered.

On the host, as in the reference package: keyframe gating by relative
angle and distance, the fragment's inputs (images cropped and resized, the
per-scale projection matrices, the volume origin from the views'
frustums) and the global hidden, TSDF and occupancy volumes, growable
dense numpy arrays cropped for each fragment. A fragment uploads its
images and hidden crops and reads back the new crops and its TSDF and
occupancy. The reference package's multi-device view-parallel fragment
step is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Type

import numpy as np
import torch

from ..common.camera import Camera
from ..common.frame import Frame, upload
from ..models.neucon import OUT_CHANNELS, NeuCon, NeuConModelConfig
from ..ops.marching_tets import marching_tetrahedra
from ..utils.io import Mesh
from .base import Algorithm, AlgorithmConfig


@dataclass
class NeuralReconConfig(AlgorithmConfig):
    """The reference's NeuralReconConfig (slam/algorithms/neural_recon.py:20-36)."""

    _target: Type = field(default_factory=lambda: NeuralRecon)
    model: NeuConModelConfig = field(default_factory=NeuConModelConfig)
    min_angle: float = 15.0
    min_distance: float = 0.1
    max_depth: float = 3.0
    img_size_w: int = 640
    img_size_h: int = 480
    stride: int = 4
    c2w_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    mesh_use_double: bool = False
    rot_rep: str = "quat"


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.INTER_LINEAR stand-in (numpy, align-corners=False)."""
    H, W = img.shape[:2]
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx).astype(img.dtype)


def _rotate_view_to_align_xyplane(c2w: np.ndarray) -> np.ndarray:
    """The rotation that maps the world z-axis to the camera's [0, -1, 0]
    (the reference's utils.py:480-490)."""
    z_c = (np.linalg.inv(c2w) @ np.array([0, 0, 1, 0.0]))[:3]
    axis = np.cross(z_c, np.array([0, -1, 0.0]))
    n = np.linalg.norm(axis)
    if n < 1e-8:
        return np.eye(3)
    axis = axis / n
    theta = np.arccos(np.clip(-z_c[1] / np.linalg.norm(z_c), -1, 1))
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class _GlobalVolume:
    """A growable dense world volume (the reference's sparse global map,
    gru_fusion.py:54-160, as a host array). Units: the level's voxels."""

    def __init__(self, channels: int, fill: float = 0.0):
        self.channels = channels
        self.fill = fill
        self.data: Optional[np.ndarray] = None
        self.origin = np.zeros(3, np.int64)  # the voxel index of data[0, 0, 0]

    def _ensure(self, lo: np.ndarray, hi: np.ndarray) -> None:
        if self.data is None:
            shape = tuple(hi - lo) + ((self.channels,) if self.channels else ())
            self.data = np.full(shape, self.fill, np.float32)
            self.origin = lo.copy()
            return
        cur_hi = self.origin + np.asarray(self.data.shape[:3])
        pad_lo = np.maximum(self.origin - lo, 0)
        pad_hi = np.maximum(hi - cur_hi, 0)
        if pad_lo.any() or pad_hi.any():
            pads = [(int(pad_lo[k]), int(pad_hi[k])) for k in range(3)]
            if self.channels:
                pads.append((0, 0))
            self.data = np.pad(self.data, pads, constant_values=self.fill)
            self.origin = self.origin - pad_lo

    def crop(self, lo: np.ndarray, dim: int) -> np.ndarray:
        lo = np.asarray(lo, np.int64)
        self._ensure(lo, lo + dim)
        s = lo - self.origin
        return self.data[s[0]:s[0] + dim, s[1]:s[1] + dim, s[2]:s[2] + dim]

    def write(self, lo: np.ndarray, block: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
        lo = np.asarray(lo, np.int64)
        dim = block.shape[0]
        self._ensure(lo, lo + dim)
        s = lo - self.origin
        view = self.data[s[0]:s[0] + dim, s[1]:s[1] + dim, s[2]:s[2] + dim]
        if mask is None:
            view[...] = block
        else:
            view[mask] = block[mask]


def keyframe_passes(last: np.ndarray, cur: np.ndarray, min_angle: float, min_distance: float) -> bool:
    """The reference's gating (:263-276): the views' angle or distance apart
    exceeds its limit."""
    t = ((np.linalg.inv(cur[:3, :3]) @ last[:3, :3] @ np.array([0, 0, 1.0])) * np.array([0, 0, 1.0])).sum()
    angle = np.arccos(np.clip(t, -1, 1))
    dis = np.linalg.norm(cur[:3, 3] - last[:3, 3])
    return bool(angle > min_angle / 180 * np.pi or dis > min_distance)


class NeuralRecon(Algorithm):
    config: NeuralReconConfig

    def __init__(self, config: NeuralReconConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        self.model: NeuCon = config.model.setup(device=self.device)
        self.params = self.model.params
        mc = self.model.config
        self.frag_frames: List[Frame] = []
        self.last_mesh: Optional[Mesh] = None
        self.fragment_id = 0

        # intrinsics after the crop and resize (the reference's :53-70)
        img_h = max(int(camera.height / config.img_size_h), 1) * config.img_size_h
        img_w = max(int(camera.width / config.img_size_w), 1) * config.img_size_w
        img_h = min(img_h, camera.height)
        img_w = min(img_w, camera.width)
        self.h_crop = (camera.height - img_h) // 2
        self.w_crop = (camera.width - img_w) // 2
        dsh = img_h / config.img_size_h
        dsw = img_w / config.img_size_w
        self.cam_intr = np.array([[camera.fx / dsw, 0, (camera.cx - self.w_crop) / dsw],
                                  [0, camera.fy / dsh, (camera.cy - self.h_crop) / dsh],
                                  [0, 0, 1.0]], np.float32)
        # the global state of each level: hidden volumes, and the fused TSDF
        self.hidden_vols = [_GlobalVolume(OUT_CHANNELS[i]) for i in range(mc.n_layer)]
        self.tsdf_vol = _GlobalVolume(0, fill=1.0)
        self.occ_vol = _GlobalVolume(0, fill=0.0)

    # ------------------------------------------------------------- poses
    def dispatch_tracking(self, cur_frame: Frame):
        """The reference's ``do_tracking`` (:182-192): the ground-truth
        pose with its y and z axes flipped, offset by ``c2w_offset``. There
        is no bootstrap phase, so the algorithm is initialised from the
        first frame on."""
        if not self.is_initialized():
            self.set_initialized()
        c2w = np.asarray(cur_frame.gt_pose, np.float32).copy()
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        c2w[:3, 3] += np.asarray(self.config.c2w_offset, np.float32)
        return (c2w,)

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        return handle[0]

    def check_keyframe(self, cur_frame: Frame) -> None:
        if not self.frag_frames or keyframe_passes(self.frag_frames[-1].get_pose(), cur_frame.get_pose(),
                                                   self.config.min_angle, self.config.min_distance):
            self.frag_frames.append(cur_frame)

    # ------------------------------------------------------------ mapping
    def _fragment_inputs(self, frames: List[Frame]):
        """The reference's get_model_input (:155-236): (imgs [V, H, W, 3]
        0..255, projections [3, V, 4, 4], the volume's origin in metres and
        in finest voxels, the world-to-aligned-camera transform)."""
        cfg = self.config
        mc = self.model.config
        mid_pose = frames[len(frames) // 2].get_pose()
        aligned_T = np.eye(4, dtype=np.float32)
        aligned_T[:3, :3] = _rotate_view_to_align_xyplane(mid_pose)
        aligned_T = aligned_T @ np.linalg.inv(mid_pose).astype(np.float32)

        imgs, projs = [], []
        bnds = np.stack([np.full(3, np.inf), np.full(3, -np.inf)], -1)
        for f in frames:
            rgb = f.rgb
            if self.h_crop > 0:
                rgb = rgb[self.h_crop:-self.h_crop]
            if self.w_crop > 0:
                rgb = rgb[:, self.w_crop:-self.w_crop]
            imgs.append(_resize_bilinear(rgb.astype(np.float32), cfg.img_size_h, cfg.img_size_w) * 255.0)
            c2w = f.get_pose()
            # the frustum's corners (utils.py:398-415)
            zs = np.array([0, 1, 1, 1, 1.0]) * cfg.max_depth
            xs = (np.array([0, 0, 0, cfg.img_size_w, cfg.img_size_w]) - self.cam_intr[0, 2]) * zs / self.cam_intr[0, 0]
            ys = (np.array([0, 0, cfg.img_size_h, 0, cfg.img_size_h]) - self.cam_intr[1, 2]) * zs / self.cam_intr[1, 1]
            pts = c2w[:3, :3] @ np.stack([xs, ys, zs]) + c2w[:3, 3:4]
            bnds[:, 0] = np.minimum(bnds[:, 0], pts.min(1))
            bnds[:, 1] = np.maximum(bnds[:, 1], pts.max(1))
            w2c = np.linalg.inv(c2w)
            view_projs = []
            for s in range(3):
                k = self.cam_intr / cfg.stride / 2 ** s
                k[2, 2] = 1.0
                p = w2c.copy()
                p[:3, :4] = k @ w2c[:3, :4]
                view_projs.append(p)
            projs.append(np.stack(view_projs))

        # the volume's origin, snapped to the coarsest stride (:205-222)
        num_layers = 3
        center = (bnds[:, 0] + bnds[:, 1]) / 2 / mc.voxel_size
        center = np.round(center / 2 ** num_layers) * 2 ** num_layers
        origin_vox = center - mc.n_vox // 2
        vol_origin_partial = origin_vox * mc.voxel_size
        return (np.stack(imgs).astype(np.float32), np.stack(projs, 1).astype(np.float32),
                vol_origin_partial.astype(np.float32), origin_vox.astype(np.int64), aligned_T)

    def level_los(self, origin_vox: np.ndarray) -> List[Tuple[np.ndarray, int]]:
        """(the crop's corner in the level's voxels, its size) of each level."""
        mc = self.model.config
        return [(origin_vox // 2 ** (mc.n_layer - 1 - i), mc.n_vox // 2 ** (mc.n_layer - 1 - i))
                for i in range(mc.n_layer)]

    def upload_fragment(self, imgs, projs, vol_origin, origin_vox):
        """The fragment step's inputs on the device: images, projections,
        origin and the hidden crops of the global volumes."""
        hiddens = [upload(np.ascontiguousarray(self.hidden_vols[i].crop(lo, dim)), self.device)
                   for i, (lo, dim) in enumerate(self.level_los(origin_vox))]
        return (upload(imgs, self.device), upload(projs, self.device), upload(vol_origin, self.device), hiddens)

    def write_fragment(self, origin_vox: np.ndarray, tsdf: torch.Tensor, occ: torch.Tensor,
                       new_hiddens: List[torch.Tensor]) -> None:
        """Read a fragment's outputs back and write them into the global
        volumes: the hidden crops whole, TSDF and occupancy where occupied."""
        for i, (lo, _) in enumerate(self.level_los(origin_vox)):
            self.hidden_vols[i].write(lo, new_hiddens[i].cpu().numpy())
        occ_np = occ.cpu().numpy()
        self.tsdf_vol.write(origin_vox, tsdf.cpu().numpy(), mask=occ_np)
        self.occ_vol.write(origin_vox, occ_np.astype(np.float32), mask=occ_np)

    def do_mapping(self, cur_frame: Frame) -> None:
        if not self.is_initialized():
            self.set_initialized()
        self.check_keyframe(cur_frame)
        if len(self.frag_frames) <= self.config.mapping_window_size:
            return
        imgs, projs, vol_origin, origin_vox, aligned_T = self._fragment_inputs(self.frag_frames)
        imgs_d, projs_d, origin_d, hiddens = self.upload_fragment(imgs, projs, vol_origin, origin_vox)
        tsdf, occ, new_hiddens = self.model.fragment_step(self.params, imgs_d, projs_d, origin_d, hiddens)
        self.write_fragment(origin_vox, tsdf, occ, new_hiddens)
        self.fragment_id += 1
        self.frag_frames.clear()

    # -------------------------------------------------------------- mesh
    def get_mesh(self) -> Optional[Mesh]:
        """tsdf2mesh (utils.py:493-500): marching tetrahedra of the fused
        TSDF at 0 over its occupied cells."""
        vol = self.tsdf_vol.data
        if vol is None or (vol >= 1.0).all():
            return None
        mc = self.model.config
        mask = self.occ_vol.data > 0 if self.occ_vol.data is not None else None
        verts, faces = marching_tetrahedra(vol, 0.0, origin=tuple(self.tsdf_vol.origin * mc.voxel_size),
                                           spacing=(mc.voxel_size,) * 3, mask=mask)
        if len(verts) == 0:
            return None
        self.last_mesh = Mesh(vertices=verts.astype(np.float32), faces=faces.astype(np.int32))
        return self.last_mesh

    def get_cloud(self, c2w_np=None, gt_depth_np=None):
        occ = self.occ_vol.data
        if self.tsdf_vol.data is None or occ is None or not occ.any():
            return None
        pts = (np.argwhere(occ > 0) + self.tsdf_vol.origin) * self.model.config.voxel_size
        return pts.astype(np.float32), np.full_like(pts, 0.5, np.float32)

    def add_keyframe(self, cur_frame: Frame) -> None:
        pass
