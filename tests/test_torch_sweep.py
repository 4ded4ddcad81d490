"""The port pipeline's run outputs against the JAX pipeline's.

* One test-local stub algorithm (its poses 1 cm a frame off the ground
  truth, a render that depends on the pose and the frame, a plane for a
  mesh) runs through both pipelines on the same 6 frames of 24x32 with
  ``render_freq`` 2: ``eval_2d.json`` with the same keys and values (LPIPS
  unavailable in both), the same ``final_mesh.ply`` and culled
  ``final_mesh_rec.ply``, and the same debug panels for the same frames.
  Without PIL the port renders no panel, says so once and records it in
  ``eval_2d.json``.
* A stub whose ``render_img`` gives None: neither package writes an
  ``eval_2d.json``, both still write the meshes.
* A tiny Co-SLAM run on the CPU through ``scripts/run.py`` with
  ``render_freq`` 2 and ``profile_trace_frames`` "1-2": ``eval_2d.json``,
  both meshes, ``timings.json`` with the run's phases and a Chrome trace in
  ``torch_trace``.
* Every registry entry renders, sweeps and writes debug images as the JAX
  registry's does.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu.common.camera import Camera as JCamera  # noqa: E402
from xrdslam_tpu.pipeline import slam as jslam  # noqa: E402
from xrdslam_tpu.utils.io import Mesh as JMesh  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.pipeline import slam  # noqa: E402
from xrdslam_tpu_torch.utils.io import Mesh  # noqa: E402

N, H, W = 6, 24, 32
CAM = dict(fx=20.0, fy=20.0, cx=15.5, cy=11.5, height=H, width=W)
MESH_FILES = ("final_mesh.ply", "final_mesh_rec.ply")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pose(i, off=0.0):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.05 * i + off, 0.0, 0.0]
    return c2w


class _Frames:
    """N frames of a wall 2 m away, with seeded colours and depth noise."""

    def __init__(self, camera):
        self.camera = camera
        rng = np.random.default_rng(0)
        self.rgb = rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32)
        self.depth = (2.0 + rng.uniform(-0.05, 0.05, (N, H, W))).astype(np.float32)
        self.depth[:, :2] = 0.0  # rows without a measurement

    def __len__(self):
        return N

    def __getitem__(self, i):
        return i, self.rgb[i], self.depth[i], _pose(i)

    def get_camera(self):
        return self.camera


class _Stub:
    """Tracks to 1 cm a frame off the ground truth, renders a function of
    the pose and the frame, and meshes a plane at the wall."""

    def __init__(self, mesh_cls, renders):
        self.mesh_cls, self.renders = mesh_cls, renders
        self.config = SimpleNamespace(rot_rep="axis_angle")
        self.initialized = False
        self.estimate_c2w_list, self.gt_c2w_list, self.gt_c2w_list_ori, self.keyframe_fids = [], [], [], []

    def is_initialized(self):
        return self.initialized

    def get_estimate_c2w_list(self):
        return self.estimate_c2w_list

    def dispatch_tracking(self, frame):
        return frame.fid

    def finish_tracking(self, fid):
        return _pose(fid, 0.01 * fid)

    def do_mapping(self, frame):
        self.initialized = True

    def add_keyframe(self, frame):
        self.keyframe_fids.append(frame.fid)

    def add_framepose(self, c2w, gt, gt_ori):
        self.estimate_c2w_list.append(np.asarray(c2w))
        self.gt_c2w_list.append(np.asarray(gt))
        self.gt_c2w_list_ori.append(np.asarray(gt_ori))

    def update_framepose(self, idx, c2w):
        self.estimate_c2w_list[idx] = np.asarray(c2w)

    def render_img(self, c2w, gt_depth=None, idx=None):
        if not self.renders:
            return None, None
        rng = np.random.default_rng(idx)
        color = np.clip(0.5 + 2.0 * c2w[0, 3] + rng.normal(0, 0.1, (H, W, 3)), 0, 1)
        return color, gt_depth * (1.0 + 0.01 * rng.normal(size=gt_depth.shape))

    def get_mesh(self):
        g = np.linspace(-2.0, 2.0, 9, dtype=np.float32)
        x, y = np.meshgrid(g, g, indexing="ij")
        v = np.stack([x.ravel(), y.ravel(), np.full(x.size, -2.0, np.float32)], -1)
        q = (np.arange(8)[:, None] * 9 + np.arange(8)[None, :]).ravel()
        f = np.concatenate([np.stack([q, q + 9, q + 10], -1), np.stack([q, q + 10, q + 1], -1)]).astype(np.int32)
        return self.mesh_cls(v, f)

    def get_cloud(self, c2w, depth):
        return None


def _run(mod, camera, mesh_cls, renders, out_dir, monkeypatch):
    """One run of the stub through package ``mod``'s pipeline; the debug
    panels it saves, in order."""
    panels = []
    monkeypatch.setattr(mod, "save_image", lambda path, img: panels.append((os.path.basename(path), img)))
    cfg = mod.SLAMPipelineConfig(tracker=mod.TrackerConfig(render_freq=2), mapper=mod.MapperConfig(keyframe_every=2),
                                 algorithm=SimpleNamespace(setup=lambda **kw: _Stub(mesh_cls, renders)))
    if mod is slam:
        cfg.device = "cpu"
    pipe = mod.SLAMPipeline(cfg, _Frames(camera), out_dir=str(out_dir), verbose=False)
    pipe.run()
    return pipe, panels


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("renders", [True, False])
def test_sweep_matches_jax(tmp_path, monkeypatch, capsys, renders):
    port, panels = _run(slam, Camera(**CAM), Mesh, renders, tmp_path / "port", monkeypatch)
    _, jpanels = _run(jslam, JCamera(**CAM), JMesh, renders, tmp_path / "jax", monkeypatch)
    for name in ("eval.tar", "timings.json"):
        assert os.path.exists(tmp_path / "port" / name)
    for name in MESH_FILES:
        got = _read(tmp_path / "port" / "mesh" / name)
        assert got == _read(tmp_path / "jax" / "mesh" / name), name
    e2d = tmp_path / "port" / "eval_2d.json"
    if not renders:
        assert not e2d.exists() and not (tmp_path / "jax" / "eval_2d.json").exists()
        assert panels == jpanels == []
        return
    with open(e2d) as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "eval_2d.json") as f:
        want = json.load(f)
    assert set(got) == set(want) and got["frames"] == want["frames"] == 3
    assert got["lpips"] is None and want["lpips"] is None
    assert "XRDSLAM_LPIPS_WEIGHTS" in got["lpips_unavailable_reason"]
    for k in ("psnr", "ssim", "ms_ssim", "depth_l1"):
        assert got[k] == want[k], k
    assert [n for n, _ in panels] == [n for n, _ in jpanels] == ["frame_00000.jpg", "frame_00002.jpg",
                                                                 "frame_00004.jpg"]
    for (name, a), (_, b) in zip(panels, jpanels):
        assert a.shape == (2 * H, 3 * W, 3)
        np.testing.assert_array_equal(a, b, err_msg=name)
    # culled: the plane's faces outside every frame's view are gone
    from xrdslam_tpu_torch.utils.io import read_ply

    full, culled = (read_ply(str(tmp_path / "port" / "mesh" / n)) for n in MESH_FILES)
    assert 0 < len(culled.faces) < len(full.faces)
    # without PIL: no panel, one line, and the reason in eval_2d.json
    capsys.readouterr()
    port.has_pil = False
    panels.clear()
    port.save_re_render_frames()
    assert panels == []
    assert capsys.readouterr().out.count("debug images skipped: PIL is not installed") == 1
    with open(e2d) as f:
        assert json.load(f)["debug_images"] == slam.NO_PIL


def test_tiny_coslam_run_writes_the_outputs(tmp_path):
    from xrdslam_tpu_torch.scripts.run import main

    main([
        "co-slam", "--data-type", "synthetic", "--data", "n_frames=5,height=40,width=60,scene=simple",
        "--out-dir", str(tmp_path), "--xrdslam.device", "cpu", "--xrdslam.tracker.render-freq", "2",
        "--xrdslam.profile-trace-frames", "1-2",
        "--xrdslam.algorithm.mapping-bound", "[[-2.2,2.2],[-2.2,2.2],[-2.2,2.2]]",
        "--xrdslam.algorithm.marching-cubes-bound", "[[-2.2,2.2],[-2.2,2.2],[-2.2,2.2]]",
        "--xrdslam.algorithm.mesher.resolution", "32",
        "--xrdslam.algorithm.mapping-first-n-iters", "10",
        "--xrdslam.algorithm.tracking-sample", "128", "--xrdslam.algorithm.mapping-sample", "256",
        "--xrdslam.algorithm.tracking-Hedge", "4", "--xrdslam.algorithm.tracking-Wedge", "4",
        "--xrdslam.algorithm.model.hashsize", "12", "--xrdslam.algorithm.model.n-levels", "8",
        "--xrdslam.algorithm.model.trainging-smooth-pts", "16",
        "--xrdslam.algorithm.model.training-n-sample-d", "16",
    ])
    with open(tmp_path / "eval_2d.json") as f:
        e2d = json.load(f)
    assert e2d["frames"] == 3 and np.isfinite(e2d["psnr"]) and np.isfinite(e2d["depth_l1"])
    for name in MESH_FILES:
        assert os.path.getsize(tmp_path / "mesh" / name) > 0
    with open(tmp_path / "timings.json") as f:
        timings = json.load(f)
    assert timings["tracking"]["count"] == 5 and set(timings["tracking"]) == {"total_s", "count", "mean_ms"}
    with open(tmp_path / "torch_trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert sorted(os.listdir(tmp_path / "imgs")) == ["frame_00000.jpg", "frame_00002.jpg", "frame_00004.jpg"]


def test_registry_render_freq_as_jax():
    from xrdslam_tpu.configs.registry import algorithm_configs as jconfigs
    from xrdslam_tpu_torch.configs.registry import algorithm_configs

    assert set(algorithm_configs) == set(jconfigs)
    for name, cfg in algorithm_configs.items():
        got, want = cfg.xrdslam.tracker, jconfigs[name].xrdslam.tracker
        for k in ("render_freq", "save_re_render_result", "save_debug_result"):
            assert getattr(got, k) == getattr(want, k), (name, k)
