"""The port's dataset file loaders and EXR reader against the JAX package's.

Each test writes a tiny sequence in one dataset's layout (3 frames of
24x32 or so, seeded images) and reads it with both packages: the same
length, camera, and every item's index, colour, depth and pose, bit for
bit (PIL decodes in both, so there is no tolerance). The cases cover
``devices.yaml`` with ``inherit_from``, ``crop_edge``, ``downsample_factor``
and plumb-bob distortion, a colour image larger than its depth, ScanNet's
and 7-Scenes' numeric order, TUM's timestamp association and frame-rate
thinning, Azure's trajectory log, CoFusion's EXR depth, and EuRoC's
w-first quaternions, body-to-camera transform, distortion and IMU window.
The EXR reader reads uncompressed, ZIPS and ZIP files (FLOAT and HALF
channels) as the JAX reader does, and gives back what was written.
"""
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from xrdslam_tpu_torch.common import datasets as D  # noqa: E402
from xrdslam_tpu_torch.utils import exr  # noqa: E402

H, W = 24, 32
CAM = {"H": H, "W": W, "fx": 30.0, "fy": 31.0, "cx": 15.5, "cy": 11.25, "png_depth_scale": 1000.0}


@pytest.fixture(scope="module")
def jax_datasets():
    pytest.importorskip("jax")
    from xrdslam_tpu.common import datasets as J

    return J


def _yaml(path, cam, **top):
    """A devices.yaml: ``cam`` as a block mapping (lists in flow style)."""
    lines = [f"{k}: {v}" for k, v in top.items()] + ["cam:"]
    lines += [f"  {k}: {list(v) if isinstance(v, (list, tuple)) else v}" for k, v in cam.items()]
    path.write_text("# written by the test\n" + "\n".join(lines) + "\n")


def _frames(n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    depth = rng.integers(500, 4000, (n, h, w), dtype=np.uint16)
    depth[:, :2] = 0  # rows without a measurement
    return rgb, depth


def _pose(i):
    c, s = np.cos(0.2 * i + 0.1), np.sin(0.2 * i + 0.1)
    return np.array([[c, -s, 0, 0.1 * i], [s, c, 0, 0.5], [0, 0, 1, -0.2 * i], [0, 0, 0, 1]])


def _mat_text(m):
    return "\n".join(" ".join(f"{x:.9f}" for x in row) for row in m) + "\n"


def _replica(root):
    """``inherit_from`` a base file; crop 2 px and downsample by 2."""
    (root / "results").mkdir(parents=True)
    _yaml(root / "base.yaml", CAM)
    _yaml(root / "devices.yaml", {"crop_edge": 2, "downsample_factor": 2}, inherit_from="base.yaml")
    rgb, depth = _frames(3)
    for i in range(3):
        Image.fromarray(rgb[i]).save(root / "results" / f"frame{i:06d}.jpg", quality=90)
        Image.fromarray(depth[i]).save(root / "results" / f"depth{i:06d}.png")
    (root / "traj.txt").write_text("".join(" ".join(f"{x:.9f}" for x in _pose(i).ravel()) + "\n" for i in range(3)))


def _scannet(root):
    """Frames 0, 2 and 10 (numeric order differs from the names'), colour
    at twice the depth's size, with distortion."""
    for sub in ("color", "depth", "pose"):
        (root / "frames" / sub).mkdir(parents=True)
    _yaml(root / "devices.yaml", {**CAM, "distortion": [0.05, -0.02, 0.001, -0.002, 0.003]})
    rgb, _ = _frames(3, 2 * H, 2 * W, seed=1)
    _, depth = _frames(3, seed=2)
    for j, i in enumerate((0, 2, 10)):
        Image.fromarray(rgb[j]).save(root / "frames" / "color" / f"{i}.jpg")
        Image.fromarray(depth[j]).save(root / "frames" / "depth" / f"{i}.png")
        (root / "frames" / "pose" / f"{i}.txt").write_text(_mat_text(_pose(i)))


def _azure(root):
    for sub in ("color", "depth", "scene"):
        (root / sub).mkdir(parents=True)
    _yaml(root / "devices.yaml", {**CAM, "crop_edge": 1})
    rgb, depth = _frames(3, seed=3)
    log = ""
    for i in range(3):
        Image.fromarray(rgb[i]).save(root / "color" / f"{i:05d}.jpg")
        Image.fromarray(depth[i]).save(root / "depth" / f"{i:05d}.png")
        log += f"{i} {i} {i + 1}\n" + _mat_text(_pose(i))
    (root / "scene" / "trajectory.log").write_text(log)


def _scenes7(root):
    root.mkdir(parents=True)
    _yaml(root / "devices.yaml", CAM)
    rgb, depth = _frames(3, seed=4)
    for j, i in enumerate((0, 1, 12)):
        Image.fromarray(rgb[j]).save(root / f"frame-{i:06d}.color.png")
        Image.fromarray(depth[j]).save(root / f"frame-{i:06d}.depth.png")
        (root / f"frame-{i:06d}.pose.txt").write_text(_mat_text(_pose(i)))


def _cofusion(root):
    """EXR depth in metres at scale 1, written by the port's writer."""
    (root / "colour").mkdir(parents=True)
    (root / "depth_noise").mkdir(parents=True)
    _yaml(root / "devices.yaml", {**CAM, "png_depth_scale": 1.0})
    rgb, _ = _frames(3, seed=5)
    rng = np.random.default_rng(6)
    for i in range(3):
        Image.fromarray(rgb[i]).save(root / "colour" / f"Color{i:04d}.png")
        exr.write_exr(str(root / "depth_noise" / f"Depth{i:04d}.exr"),
                      {"Z": rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)})


def _tumrgbd(root):
    """Images every 0.02 s (one more at 100.5 s), depth 0.005 s after each
    of the first six but the fourth, poses every 0.01 s: the association
    takes the fourth image with its neighbour's depth and drops the last,
    the 32 fps thinning every other frame; quaternions in TUM's (qx, qy, qz,
    qw) order."""
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir(parents=True)
    _yaml(root / "devices.yaml", CAM)
    rgb, depth = _frames(7, seed=7)
    head = "# color images\n# file: 'test'\n# timestamp filename\n"
    rgb_rows, depth_rows = [], []
    for i in range(7):
        t = 100.0 + 0.02 * i if i < 6 else 100.5
        Image.fromarray(rgb[i]).save(root / "rgb" / f"{t:.6f}.png")
        rgb_rows.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i not in (3, 6):
            td = t + 0.005
            Image.fromarray(depth[i]).save(root / "depth" / f"{td:.6f}.png")
            depth_rows.append(f"{td:.6f} depth/{td:.6f}.png")
    (root / "rgb.txt").write_text(head + "\n".join(rgb_rows) + "\n")
    (root / "depth.txt").write_text(head + "\n".join(depth_rows) + "\n")
    rng = np.random.default_rng(8)
    poses = []
    for k in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        poses.append(f"{99.99 + 0.01 * k:.4f} " + " ".join(f"{x:.6f}" for x in (*rng.normal(size=3), *q)))
    (root / "groundtruth.txt").write_text("# ground truth\n# file: 'test'\n# timestamp tx ty tz qx qy qz qw\n"
                                          + "\n".join(poses) + "\n")


def _euroc(root):
    """tests/test_data_eval.py::test_euroc_loader's layout with a turning
    ground truth, a body-to-camera rotation and distortion."""
    cam_dir, imu_dir = root / "mav0" / "cam0", root / "mav0" / "imu0"
    gt_dir = root / "mav0" / "state_groundtruth_estimate0"
    (cam_dir / "data").mkdir(parents=True)
    imu_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    (cam_dir / "sensor.yaml").write_text(
        "%YAML:1.0\n"
        f"resolution: [{W}, {H}]\n"
        "intrinsics: [30.0, 31.0, 15.5, 11.25]\n"
        "distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]\n"
        "T_BS:\n  cols: 4\n  rows: 4\n"
        "  data: [0.0, -1.0, 0.0, -0.02, 1.0, 0.0, 0.0, 0.06, 0.0, 0.0, 1.0, 0.01, 0.0, 0.0, 0.0, 1.0]\n"
        "rate_hz: 20\n")
    (imu_dir / "sensor.yaml").write_text(
        "gyroscope_noise_density: 1.6968e-04\ngyroscope_random_walk: 1.9393e-05\n"
        "accelerometer_noise_density: 2.0e-3\naccelerometer_random_walk: 3.0e-3\nrate_hz: 200\n")
    rgb, _ = _frames(3, seed=9)
    rows = ["#timestamp [ns],filename"]
    for i in range(3):
        ts = 1000000 + i * 50000
        Image.fromarray(rgb[i]).save(cam_dir / "data" / f"{ts}.png")
        rows.append(f"{ts},{ts}.png")
    (cam_dir / "data.csv").write_text("\n".join(rows) + "\n")
    gt_rows = ["#ts,px,py,pz,qw,qx,qy,qz,vx,vy,vz"]
    for i in range(6):
        a = 0.1 * i
        gt_rows.append(f"{1000000 + i * 25000},{0.1 * i},{0.02 * i},0,{np.cos(a):.8f},0,{np.sin(a):.8f},0,0,0,0")
    (gt_dir / "data.csv").write_text("\n".join(gt_rows) + "\n")
    imu_rows = ["#ts,wx,wy,wz,ax,ay,az"] + [f"{1000000 + i * 5000},{0.01 * i},0,0,0,0,9.81" for i in range(30)]
    (imu_dir / "data.csv").write_text("\n".join(imu_rows) + "\n")


LAYOUTS = {"replica": _replica, "scannet": _scannet, "azure": _azure, "7scenes": _scenes7, "cofusion": _cofusion,
           "tumrgbd": _tumrgbd, "euroc": _euroc}
LENGTHS = {"tumrgbd": 3}


@pytest.mark.parametrize("data_type", list(LAYOUTS))
def test_loader_matches_jax(data_type, tmp_path, jax_datasets):
    root = tmp_path / data_type
    LAYOUTS[data_type](root)
    got = D.get_dataset(str(root), data_type)
    want = jax_datasets.get_dataset(str(root), data_type)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == LENGTHS.get(data_type, 3)
    assert vars(got.get_camera()) == vars(want.get_camera())
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g[0] == w[0] == i
        for a, b, what in zip(g[1:], w[1:], ("color", "depth", "c2w")):
            assert a.dtype == b.dtype and a.shape == b.shape, what
            np.testing.assert_array_equal(a, b, err_msg=f"{data_type}[{i}] {what}")
        assert g[1].shape == (got.get_camera().height, got.get_camera().width, 3)
        assert 0.0 <= g[1].min() and g[1].max() <= 1.0 and np.isfinite(g[2]).all()
    if data_type == "euroc":
        np.testing.assert_array_equal(got.get_imu_window(1010000, 1050000), want.get_imu_window(1010000, 1050000))
        assert got.get_imu_window(1010000, 1050000).shape == (9, 6)
        # the nearest ground truth (frame 1 at 1,050,000 ns: state 2) through the body-to-camera transform
        assert not np.allclose(got[1][3][:3, :3], np.eye(3))
    if data_type == "replica":
        assert got.get_camera().height == (H - 4) // 2 and got.get_camera().fx == CAM["fx"] / 2


def test_get_dataset_types_as_jax(jax_datasets, tmp_path):
    assert set(D.dataset_dict) == set(jax_datasets.dataset_dict)
    ds = D.get_dataset("n_frames=2,height=12,width=16", "synthetic", device="cpu")
    assert len(ds) == 2 and ds[1][1].shape == (12, 16, 3)
    with pytest.raises(ValueError, match="unknown data type"):
        D.get_dataset(str(tmp_path), "kitti")


# ---------------------------------------------------------------------------
# the EXR reader
# ---------------------------------------------------------------------------

def _predict(raw: bytes) -> bytes:
    """The EXR zip predictor: interleave the bytes' halves, then delta-encode."""
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    half = (len(arr) + 1) // 2
    inter = np.empty_like(arr)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    out = np.empty_like(inter)
    out[0] = inter[0]
    out[1:] = (np.diff(inter) + 128) % 256
    return out.astype(np.uint8).tobytes()


def _write_zip_exr(path, channels, lines_per_block):
    """A ZIPS (1 line a block) or ZIP (16) EXR of FLOAT (float32) and HALF
    (float16) channels."""
    names = sorted(channels)
    h, w = channels[names[0]].shape

    def attr(n, t, data):
        return n.encode() + b"\0" + t.encode() + b"\0" + struct.pack("<i", len(data)) + data

    ptype = {np.dtype(np.float32): 2, np.dtype(np.float16): 1}
    chl = b"".join(n.encode() + b"\0" + struct.pack("<i", ptype[channels[n].dtype]) + b"\0\0\0\0"
                   + struct.pack("<ii", 1, 1) for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    comp = b"\x02" if lines_per_block == 1 else b"\x03"
    hdr = (attr("channels", "chlist", chl) + attr("compression", "compression", comp)
           + attr("dataWindow", "box2i", box) + attr("displayWindow", "box2i", box)
           + attr("lineOrder", "lineOrder", b"\0") + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
           + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
           + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    head = struct.pack("<iI", 0x01312F76, 2) + hdr
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    chunks, offs, off = [], [], len(head) + 8 * n_blocks
    for b in range(n_blocks):
        y = b * lines_per_block
        raw = b"".join(channels[n][yy].tobytes() for yy in range(y, min(y + lines_per_block, h)) for n in names)
        data = zlib.compress(_predict(raw))
        assert len(data) < len(raw)
        chunks.append(struct.pack("<ii", y, len(data)) + data)
        offs.append(off)
        off += 8 + len(data)
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{n_blocks}Q", *offs) + b"".join(chunks))


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_read_exr_matches_jax(compression, tmp_path):
    pytest.importorskip("jax")
    from xrdslam_tpu.utils import exr as jexr

    ramp = np.tile(np.floor(np.linspace(0.0, 3.0, 40, dtype=np.float32) * 2) / 2, (37, 1))  # steps compress
    chans = {"Z": ramp + np.float32(0.5), "A": (ramp / 4).astype(np.float16 if compression == "zip" else np.float32)}
    path = str(tmp_path / f"{compression}.exr")
    if compression == "none":
        exr.write_exr(path, chans)
    else:
        _write_zip_exr(path, chans, 1 if compression == "zips" else 16)
    got, want = exr.read_exr(path), jexr.read_exr(path)
    assert sorted(got) == sorted(want) == ["A", "Z"]
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], chans[k].astype(np.float32))
    np.testing.assert_array_equal(exr.read_exr_depth(path), chans["Z"])
