"""RGB-D dataset loaders (Replica / ScanNet / TUM / Azure / CoFusion / 7-Scenes
/ EuRoC / synthetic).

Counterpart of ``xrdslam_tpu/common/datasets.py``, in numpy: PIL decodes
the images, the plumb-bob undistortion and the resizes are numpy, and every
item is a plain numpy tuple ``(idx, color f32 [H, W, 3] in [0, 1], depth
f32 [H, W] in metres, c2w [4, 4])``. The pose loaders apply the
reference's Y/Z axis flip, so that trajectories and meshes are comparable
across datasets. Each dataset's ``devices.yaml`` (intrinsics,
``png_depth_scale``, ``crop_edge``, ``downsample_factor``, distortion) is
read with its ``inherit_from`` chain. PyYAML and PIL are imported where a
file is read, so that the module imports without them; the synthetic data
type needs neither, and its depth is traced on ``get_dataset``'s device.
"""
from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from ..ops import lie_np
from .camera import Camera
from .synthetic import SyntheticDataset


def _open_image(path: str):
    from PIL import Image

    return Image.open(path)


def load_device_config(path: str) -> dict:
    """``devices.yaml`` with its ``inherit_from`` chain merged, the file's
    own keys over the inherited ones (one level of dicts deep)."""
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    inherit = cfg.pop("inherit_from", None)
    if inherit:
        base = load_device_config(inherit if os.path.isabs(inherit) else os.path.join(os.path.dirname(path), inherit))
        merged = dict(base)
        for k, v in cfg.items():
            if isinstance(v, dict) and isinstance(merged.get(k), dict):
                merged[k] = {**merged[k], **v}
            else:
                merged[k] = v
        return merged
    return cfg


def _bilinear_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize by PIL, a channel at a time for float arrays."""
    from PIL import Image

    if img.ndim == 2:
        return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    chans = [np.asarray(Image.fromarray(img[..., c]).resize((w, h), Image.BILINEAR)) for c in range(img.shape[-1])]
    return np.stack(chans, -1)


def _nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64).clip(0, img.shape[1] - 1)
    return img[ys[:, None], xs[None, :]]


def _undistort_map(h: int, w: int, fx: float, fy: float, cx: float, cy: float,
                   dist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plumb-bob (k1, k2, p1, p2, k3) undistortion grid, cv2.undistort's:
    the source pixel (xs, ys) of each destination pixel."""
    k1, k2, p1, p2, k3 = [float(d) for d in dist[:5]]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (u - cx) / fx
    y = (v - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return (x_d * fx + cx).astype(np.float32), (y_d * fy + cy).astype(np.float32)


def _bilinear_remap(img: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(xs - x0, 0, 1)[..., None] if img.ndim == 3 else np.clip(xs - x0, 0, 1)
    fy = np.clip(ys - y0, 0, 1)[..., None] if img.ndim == 3 else np.clip(ys - y0, 0, 1)
    a = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    b = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return a * (1 - fy) + b * fy


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    """The camera frame turned 180 degrees about its x axis."""
    out = c2w.copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    return out


def _read_rgb(path: str) -> np.ndarray:
    return np.asarray(_open_image(path).convert("RGB")).astype(np.float32) / 255.0


class BaseDataset:
    """An RGB-D dataset described by its ``devices.yaml``."""

    data_format = "RGBD"

    def __init__(self, data_path: str):
        self.input_folder = data_path
        cfg = load_device_config(os.path.join(data_path, "devices.yaml"))
        self.cfg = cfg
        cam = cfg["cam"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy, self.cx, self.cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
        self.distortion = np.array(cam["distortion"]) if "distortion" in cam else None
        self.crop_edge = cam.get("crop_edge", 0)
        self.downsample_factor = cam.get("downsample_factor", 1)
        self.camera = Camera(
            fx=self.fx / self.downsample_factor,
            fy=self.fy / self.downsample_factor,
            cx=(self.cx - self.crop_edge) / self.downsample_factor,
            cy=(self.cy - self.crop_edge) / self.downsample_factor,
            height=int((self.H - 2 * self.crop_edge) / self.downsample_factor),
            width=int((self.W - 2 * self.crop_edge) / self.downsample_factor),
        )
        self._undistort = None
        if self.distortion is not None:
            self._undistort = _undistort_map(self.H, self.W, self.fx, self.fy, self.cx, self.cy, self.distortion)
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        self.n_img = 0

    def __len__(self) -> int:
        return self.n_img

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith(".png"):
            d = np.asarray(_open_image(path)).astype(np.float32)
        elif path.endswith(".exr"):
            from ..utils.exr import read_exr_depth

            d = read_exr_depth(path)
        else:
            raise NotImplementedError(f"unsupported depth format: {path}")
        return d / self.png_depth_scale

    def __getitem__(self, index: int):
        color = _read_rgb(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        if self._undistort is not None:
            xs, ys = self._undistort
            color = _bilinear_remap(color, xs, ys)  # the colour only, as the reference
        h, w = depth.shape
        if color.shape[:2] != (h, w):
            color = _bilinear_resize(color, h, w)
        edge = self.crop_edge
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        if self.downsample_factor > 1:
            nh = (h - 2 * edge) // self.downsample_factor
            nw = (w - 2 * edge) // self.downsample_factor
            color = _bilinear_resize(color, nh, nw)
            depth = _nearest_resize(depth, nh, nw)
        return index, color.astype(np.float32), depth.astype(np.float32), self.poses[index].astype(np.float32)

    def get_camera(self) -> Camera:
        return self.camera


class Replica(BaseDataset):
    """``results/frame*.jpg``, ``results/depth*.png`` and ``traj.txt``, a
    row-major c2w a line."""

    def __init__(self, data_path: str):
        super().__init__(data_path)
        self.color_paths = sorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [_flip_yz(np.array(list(map(float, lines[i].split()))).reshape(4, 4)) for i in range(self.n_img)]


class ScanNet(BaseDataset):
    """``frames/{color,depth,pose}/<n>.{jpg,png,txt}``, in numeric order."""

    def __init__(self, data_path: str):
        super().__init__(data_path)
        self.input_folder = os.path.join(self.input_folder, "frames")
        key = lambda x: int(os.path.basename(x)[:-4])  # noqa: E731
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")), key=key)
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")), key=key)
        self.n_img = len(self.color_paths)
        self.poses = [_flip_yz(np.loadtxt(p).reshape(4, 4))
                      for p in sorted(glob.glob(os.path.join(self.input_folder, "pose", "*.txt")), key=key)]


class Azure(BaseDataset):
    """``color/*.jpg``, ``depth/*.png`` and ``scene/trajectory.log`` (a header
    line and four matrix rows a frame); identity poses without the log."""

    def __init__(self, data_path: str):
        super().__init__(data_path)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        self.n_img = len(self.color_paths)
        traj = os.path.join(self.input_folder, "scene", "trajectory.log")
        self.poses = []
        if os.path.exists(traj):
            with open(traj) as f:
                content = f.readlines()
            for i in range(0, len(content), 5):
                c2w = np.array(list(map(float, ("".join(content[i + 1: i + 5])).strip().split()))).reshape(4, 4)
                self.poses.append(_flip_yz(c2w))
        else:
            self.poses = [np.eye(4) for _ in range(self.n_img)]


class Scenes7(BaseDataset):
    """``frame-<n>.{color.png,depth.png,pose.txt}``, in numeric order."""

    def __init__(self, data_path: str):
        super().__init__(data_path)
        key = lambda x: int(os.path.basename(x).split(".")[0].split("-")[-1])  # noqa: E731
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "*.color.png")), key=key)
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "*.depth.png")), key=key)
        self.n_img = len(self.color_paths)
        self.poses = [_flip_yz(np.loadtxt(p).reshape(4, 4))
                      for p in sorted(glob.glob(os.path.join(self.input_folder, "*.pose.txt")), key=key)]


class CoFusion(BaseDataset):
    """``colour/*.png`` and EXR depth in ``depth_noise/*.exr``; identity
    poses, as in the reference."""

    def __init__(self, data_path: str):
        super().__init__(data_path)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "colour", "*.png")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth_noise", "*.exr")))
        self.n_img = len(self.color_paths)
        self.poses = [np.eye(4) for _ in range(self.n_img)]


class TUM_RGBD(BaseDataset):
    """``rgb.txt``, ``depth.txt`` and ``groundtruth.txt`` (or ``pose.txt``),
    associated by timestamp within 0.08 s, then thinned to ``frame_rate``."""

    def __init__(self, data_path: str, frame_rate: int = 32):
        super().__init__(data_path)
        self.color_paths, self.depth_paths, self.poses = self._load(self.input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath: str, skiprows: int = 0) -> np.ndarray:
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    def _load(self, datapath: str, frame_rate: int):
        from scipy.spatial.transform import Rotation

        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)
        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)
        images, depths, poses = [], [], []
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(pose_vecs[k][3:]).as_matrix()  # TUM's (qx, qy, qz, qw)
            c2w[:3, 3] = pose_vecs[k][:3]
            poses.append(_flip_yz(c2w))
        return images, depths, poses


class Euroc:
    """EuRoC MAV, monocular plus IMU: ``mav0/cam0/{sensor.yaml,data.csv,
    data/}``, ``mav0/imu0/{sensor.yaml,data.csv}`` and
    ``mav0/state_groundtruth_estimate0/data.csv``. Items are (idx, rgb,
    zero depth, c2w), so that the pipeline's interface stays the same
    (monocular algorithms such as DPVO ignore the depth); the IMU samples
    between two timestamps come from ``get_imu_window``.

    The ground truth's orientation columns are (qw, qx, qy, qz) and are read
    with w-first quaternion maths, as in the JAX package (the reference
    passes them to scipy's x, y, z, w ``from_quat`` as they are).
    """

    data_format = "MonoImu"

    def __init__(self, data_path: str):
        self.input_folder = data_path
        cam_cfg = self._read_yaml(os.path.join(data_path, "mav0/cam0/sensor.yaml"))
        imu_cfg = self._read_yaml(os.path.join(data_path, "mav0/imu0/sensor.yaml"))

        self.W, self.H = cam_cfg["resolution"]
        fx, fy, cx, cy = cam_cfg["intrinsics"]
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.distortion = (np.array(cam_cfg["distortion_coefficients"])
                           if "distortion_coefficients" in cam_cfg else None)
        self.T_ic0 = np.array(cam_cfg["T_BS"]["data"]).reshape(4, 4)
        self.gyro_n = imu_cfg["gyroscope_noise_density"]
        self.gyro_rw = imu_cfg["gyroscope_random_walk"]
        self.acc_n = imu_cfg["accelerometer_noise_density"]
        self.acc_rw = imu_cfg["accelerometer_random_walk"]
        self.imu_hz = imu_cfg["rate_hz"]

        self.camera = Camera(fx=fx, fy=fy, cx=cx, cy=cy, height=self.H, width=self.W)
        self._undistort = None
        if self.distortion is not None:
            # EuRoC's cam0 is radial-tangential (k1, k2, p1, p2)
            dist = np.zeros(5)
            dist[:len(self.distortion)] = self.distortion
            self._undistort = _undistort_map(self.H, self.W, fx, fy, cx, cy, dist)

        self.img_timestamps: List[int] = []
        self.color_paths: List[str] = []
        csv_path = os.path.join(data_path, "mav0/cam0/data.csv")
        with open(csv_path) as f:
            next(f)
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 2:
                    continue
                self.img_timestamps.append(int(parts[0]))
                self.color_paths.append(os.path.join(os.path.dirname(csv_path), "data", parts[1]))
        self.n_img = len(self.color_paths)

        # the ground-truth states (IMU to world)
        self.gt_timestamps: List[int] = []
        gt_poses = []
        with open(os.path.join(data_path, "mav0/state_groundtruth_estimate0/data.csv")) as f:
            next(f)
            for line in f:
                row = line.strip().split(",")
                if len(row) < 8:
                    continue
                self.gt_timestamps.append(int(row[0]))
                t = np.array([float(row[i]) for i in range(1, 4)])
                q = np.array([float(row[i]) for i in range(4, 8)])  # w, x, y, z
                gt_poses.append(lie_np.pose_matrix(t, q))
        self._gt_ts = np.asarray(self.gt_timestamps)
        self._gt_poses = gt_poses

        # the IMU samples (t, gyro xyz, acc xyz)
        self.imu_timestamps: List[int] = []
        self.imu_datas: List[List[float]] = []
        with open(os.path.join(data_path, "mav0/imu0/data.csv")) as f:
            next(f)
            for line in f:
                row = line.strip().split(",")
                if len(row) < 7:
                    continue
                self.imu_timestamps.append(int(row[0]))
                self.imu_datas.append([float(row[i]) for i in range(1, 7)])
        self._imu_ts = np.asarray(self.imu_timestamps)

    def __len__(self) -> int:
        return self.n_img

    @staticmethod
    def _read_yaml(path: str):
        """A sensor file, less its ``%YAML`` directive line where it has one."""
        import yaml

        with open(path) as f:
            first = f.readline()
            content = f.read() if first.startswith("%") else first + f.read()
        return yaml.safe_load(content)

    def _img_pose(self, t0: int) -> np.ndarray:
        i = int(np.argmin(np.abs(self._gt_ts - t0)))
        return _flip_yz(self._gt_poses[i] @ self.T_ic0)

    def get_imu_window(self, t0: int, t1: int) -> np.ndarray:
        """The IMU samples (gyro, acc) with t0 <= t <= t1, [K, 6]."""
        m = (self._imu_ts >= t0) & (self._imu_ts <= t1)
        return np.asarray(self.imu_datas, np.float64)[m]

    def __getitem__(self, index: int):
        img = _read_rgb(self.color_paths[index])
        if self._undistort is not None:
            xs, ys = self._undistort
            img = _bilinear_remap(img, xs, ys)
        depth = np.zeros(img.shape[:2], np.float32)  # monocular
        return index, img, depth, self._img_pose(self.img_timestamps[index]).astype(np.float32)

    def get_camera(self) -> Camera:
        return self.camera


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "cofusion": CoFusion,
    "azure": Azure,
    "tumrgbd": TUM_RGBD,
    "7scenes": Scenes7,
    "synthetic": SyntheticDataset,
    "euroc": Euroc,
}


def get_dataset(data_path: str, data_type: str, device: str = "cpu"):
    """The dataset of ``data_type`` at ``data_path``; the synthetic type
    traces its depth on ``device``, the file types read on the host."""
    if data_type not in dataset_dict:
        raise ValueError(f"unknown data type {data_type!r} (have: {sorted(dataset_dict)})")
    if data_type == "synthetic":
        return SyntheticDataset(data_path, device=device)
    return dataset_dict[data_type](data_path)
