"""Synthetic RGB-D sequences: analytic SDF scenes, sphere-traced with torch.

Counterpart of ``xrdslam_tpu/common/synthetic.py`` (the "simple" box room
and the furnished 6 x 4 x 5 m "office", with their trajectories). Depth is
sphere-traced on the run's device with the reference's settings (96 steps,
step factor 0.9, far 8 m, hit below 5e-3); colors are the same procedural
palettes, in numpy. Camera convention: OpenGL (-z forward); c2w poses carry
no axis flips. ``gt_mesh`` gives the scene's exact mesh (marching
tetrahedra of the analytic SDF) for the 3D reconstruction metrics.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.marching_tets import marching_tetrahedra
from ..utils.io import Mesh
from .camera import Camera

ROOM_HALF = np.array([2.0, 2.0, 2.0])
SPHERE_C = np.array([0.7, -0.3, -1.0])
SPHERE_R = 0.45
BOX_C = np.array([-0.9, -0.6, 0.8])
BOX_HALF = np.array([0.45, 0.5, 0.35])
OFFICE_HALF = np.array([3.0, 2.0, 2.5])


def _box(p: torch.Tensor, c, h) -> torch.Tensor:
    q = torch.abs(p - p.new_tensor(c)) - p.new_tensor(h)
    return torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(torch.amax(q, dim=-1), max=0.0)


def _sphere(p: torch.Tensor, c, r: float) -> torch.Tensor:
    return torch.linalg.norm(p - p.new_tensor(c), dim=-1) - r


def simple_sdf(p: torch.Tensor) -> torch.Tensor:
    """Room interior + a sphere + a box. [..., 3] -> [...]."""
    room = -_box(p, [0.0, 0.0, 0.0], ROOM_HALF)
    return torch.minimum(room, torch.minimum(_sphere(p, SPHERE_C, SPHERE_R), _box(p, BOX_C, BOX_HALF)))


def office_sdf(p: torch.Tensor) -> torch.Tensor:
    """The furnished office (reference ``_office_prims``). [..., 3] -> [...]."""
    column = torch.sqrt((p[..., 0] - 2.3) ** 2 + (p[..., 2] - 1.7) ** 2) - 0.3
    objs = -_box(p, [0.0, 0.0, 0.0], OFFICE_HALF)
    for o in (
        _box(p, [0.9, -1.35, -0.7], [0.75, 0.05, 0.5]),  # table top
        _box(p, [0.9, -1.7, -0.7], [0.1, 0.35, 0.1]),  # table leg
        _box(p, [0.2, -1.6, 0.5], [0.25, 0.4, 0.25]),  # chair
        _box(p, [-1.8, -1.55, 1.4], [0.9, 0.45, 0.5]) - 0.06,  # sofa
        _sphere(p, [-1.6, 0.3, -1.6], 0.35),  # lamp
        column,
        _box(p, [2.82, -0.4, -0.9], [0.18, 1.0, 0.6]),  # shelf
        _sphere(p, [1.3, -1.1, 0.9], 0.25),  # ball
    ):
        objs = torch.minimum(objs, o)
    return objs


SCENE_SDF: dict = {"simple": simple_sdf, "office": office_sdf}


def sphere_trace(origins: torch.Tensor, dirs: torch.Tensor, n_steps: int = 96, far: float = 8.0,
                 scene: str = "simple") -> torch.Tensor:
    """Sphere-trace unit-direction rays [..., 3] -> hit distance [...], 0 on a miss."""
    sdf: Callable[[torch.Tensor], torch.Tensor] = SCENE_SDF[scene]
    t = torch.zeros(origins.shape[:-1], dtype=torch.float32, device=origins.device)
    for _ in range(n_steps):
        sd = sdf(origins + dirs * t[..., None])
        t = torch.clamp(t + torch.clamp(sd, min=1e-4) * 0.9, max=far)
    hit = sdf(origins + dirs * t[..., None]) < 5e-3
    return torch.where(hit, t, 0.0)


def _sdf_mesh(scene: str, half: np.ndarray, voxel: float, device: str) -> Mesh:
    """Marching tetrahedra of a scene's SDF on a ``voxel`` grid over
    [-half, half] (evaluated on ``device`` in chunks of 2^20 points)."""
    xs = [np.arange(-h, h + voxel, voxel, dtype=np.float32) for h in half]
    gx, gy, gz = np.meshgrid(xs[0], xs[1], xs[2], indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    vals = np.empty(pts.shape[0], np.float32)
    bs = 1 << 20
    for i in range(0, pts.shape[0], bs):
        vals[i:i + bs] = SCENE_SDF[scene](torch.as_tensor(pts[i:i + bs], device=device)).cpu().numpy()
    verts, faces = marching_tetrahedra(vals.reshape(gx.shape), level=0.0, origin=(xs[0][0], xs[1][0], xs[2][0]),
                                       spacing=(voxel, voxel, voxel))
    return Mesh(verts, faces, None)


def simple_gt_mesh(voxel: float = 0.05, device: str = "cpu") -> Mesh:
    """Exact mesh of the simple scene (room + two objects)."""
    return _sdf_mesh("simple", ROOM_HALF + 0.02, voxel, device)


def office_gt_mesh(voxel: float = 0.02, device: str = "cpu") -> Mesh:
    """Exact mesh of the office."""
    return _sdf_mesh("office", OFFICE_HALF + 0.02, voxel, device)


def scene_color(p: np.ndarray) -> np.ndarray:
    """Smooth position-based palette in [0,1] (simple scene)."""
    c = 0.5 + 0.45 * np.sin(p * np.array([1.7, 2.3, 1.1]) + np.array([0.0, 2.0, 4.0]))
    return np.clip(c, 0.0, 1.0)


def office_color(p: np.ndarray) -> np.ndarray:
    """Textured procedural color: low-frequency hue + mid/high-frequency
    detail (wavelengths ~80 cm / ~15 cm)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    base = 0.5 + 0.35 * np.sin(p * np.asarray([1.1, 1.7, 1.3]) + np.asarray([0.0, 2.1, 4.2]))
    mid = 0.5 + 0.5 * np.sin(7.9 * x + 1.5 * np.sin(3.1 * y)) * np.sin(8.3 * z + 1.5 * np.sin(2.7 * x))
    fine = 0.5 + 0.5 * np.sin(41.0 * x) * np.sin(37.0 * y) * np.sin(43.0 * z)
    c = base * (0.62 + 0.28 * mid[..., None] + 0.10 * fine[..., None])
    return np.clip(c, 0.0, 1.0)


def tour_poses(n_frames: int, cm_per_frame: float = 0.6, seed: int = 0) -> np.ndarray:
    """Smooth room-tour c2w trajectory: lissajous translation + slowly
    rotating view direction, scaled so per-frame motion matches Replica
    sequences (~0.5-1 cm translation, ~0.1 degree rotation per frame)."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    total = n_frames * cm_per_frame * 0.01
    w = total / max(n_frames, 1) / 1.6  # lissajous arc-length heuristic
    for i in range(n_frames):
        a = w * i
        eye = np.array([1.5 * np.sin(a), 0.35 * np.sin(0.7 * a + 0.5), 1.6 * np.sin(1.31 * a + 1.2)])
        yaw = 0.5 * a + 0.4 * np.sin(0.53 * a)
        pitch = 0.15 * np.sin(0.41 * a)
        fwd = np.array([np.cos(pitch) * np.sin(yaw), np.sin(pitch), -np.cos(pitch) * np.cos(yaw)])
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        poses[i, :3, :3] = np.stack([right, true_up, -fwd], axis=1)
        poses[i, :3, 3] = eye
        poses[i, 3, 3] = 1.0
    return poses


def orbit_poses(n_frames: int, radius: float = 0.6, height_amp: float = 0.2, deg_per_frame: float = 0.35) -> np.ndarray:
    """Smooth orbit inside the simple room, camera looking outward. [N, 4, 4] c2w."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        a = np.deg2rad(deg_per_frame) * i
        eye = np.array([radius * np.cos(a), height_amp * np.sin(2 * a), radius * np.sin(a)])
        fwd = eye / np.linalg.norm(eye)
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        poses[i, :3, :3] = np.stack([right, true_up, -fwd], axis=1)
        poses[i, :3, 3] = eye
        poses[i, 3, 3] = 1.0
    return poses


class SyntheticDataset:
    """In-memory synthetic RGB-D dataset with exact poses.

    Items are numpy tuples (idx, color [H,W,3] f32, depth [H,W] f32, c2w
    [4,4]); depth is traced on ``device``.
    """

    data_format = "RGBD"

    def __init__(self, data_path: str = "", n_frames: int = 40, height: int = 120, width: int = 160,
                 fov_deg: float = 70.0, scene: str = "simple", device: str = "cpu"):
        # data_path may carry generator params as "k=v,k=v"
        # (e.g. --data "n_frames=60,height=340,width=600,scene=office")
        for kv in (data_path or "").split(","):
            if "=" not in kv:
                continue
            k, v = (s.strip() for s in kv.split("=", 1))
            if k == "n_frames":
                n_frames = int(v)
            elif k == "height":
                height = int(v)
            elif k == "width":
                width = int(v)
            elif k == "fov_deg":
                fov_deg = float(v)
            elif k == "scene":
                scene = v
        if scene not in SCENE_SDF:
            raise ValueError(f"unknown synthetic scene {scene!r}")
        self.scene = scene
        self.n_img = n_frames
        self.device = torch.device(device)
        f = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
        self.camera = Camera(fx=f, fy=f, cx=width / 2 - 0.5, cy=height / 2 - 0.5, height=height, width=width)
        self.poses = orbit_poses(n_frames) if scene == "simple" else tour_poses(n_frames)
        self._cache = {}

    def __len__(self) -> int:
        return self.n_img

    def _dirs(self) -> np.ndarray:
        cam = self.camera
        i, j = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        return np.stack([(i - cam.cx) / cam.fx, -(j - cam.cy) / cam.fy, -np.ones_like(i, np.float64)], -1)

    def _render(self, idxs) -> None:
        """Trace the frames ``idxs`` in one batch and cache them."""
        poses = self.poses[idxs].astype(np.float64)  # [B, 4, 4]
        dirs_w = np.einsum("hwj,bij->bhwi", self._dirs(), poses[:, :3, :3])
        origins = np.broadcast_to(poses[:, None, None, :3, 3], dirs_w.shape)
        # depth is distance along the (unnormalized) pixel ray, like a
        # z-buffer dataset: trace with normalized dirs, divide by the norm
        norms = np.linalg.norm(dirs_w, axis=-1)
        to_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=self.device)  # noqa: E731
        t = sphere_trace(to_dev(origins), to_dev(dirs_w / norms[..., None]), scene=self.scene).cpu().numpy()
        depth = np.where(t > 0, t / norms, 0.0).astype(np.float32)
        p_hit = origins + dirs_w * depth[..., None]
        color_fn = scene_color if self.scene == "simple" else office_color
        color = np.where(depth[..., None] > 0, color_fn(p_hit), 0.0).astype(np.float32)
        for j, i in enumerate(idxs):
            self._cache[i] = (color[j], depth[j])

    def prerender(self, batch: int = 8) -> None:
        """Fill the frame cache, ``batch`` frames per trace."""
        todo = [i for i in range(self.n_img) if i not in self._cache]
        for s in range(0, len(todo), batch):
            self._render(todo[s:s + batch])

    def __getitem__(self, index: int) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        if index not in self._cache:
            self._render([index])
        color, depth = self._cache[index]
        return index, color, depth, self.poses[index]

    def get_camera(self) -> Camera:
        return self.camera

    @property
    def bounds(self) -> np.ndarray:
        m = 0.2
        half = ROOM_HALF if self.scene == "simple" else OFFICE_HALF
        return np.array([[-half[0] - m, half[0] + m],
                         [-half[1] - m, half[1] + m],
                         [-half[2] - m, half[2] + m]], np.float32)

    def gt_mesh(self, voxel: float = 0.02) -> Mesh:
        """The scene's exact mesh for the 3D reconstruction metrics (the
        synthetic stand-in for Replica's culled ground truth), its SDF
        evaluated on the dataset's device."""
        if self.scene == "office":
            return office_gt_mesh(voxel, str(self.device))
        return simple_gt_mesh(max(voxel, 0.05), str(self.device))
