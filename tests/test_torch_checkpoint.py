"""Checkpoints and resume in the port, held to the JAX package.

* The guards of ``tests/test_checkpoint.py::test_checkpoint_guards`` on the
  port, with the same dummy: an atomic write that
  loads back, a newer version and another algorithm refused with a
  ``ValueError``, an unknown entry skipped. A checkpoint of a port
  algorithm loads in a process where torch cannot be imported.
* The pipeline's resume semantics on a stub algorithm, through both
  pipelines: the frames each segment runs, the frame index of every
  checkpoint written under ``checkpoint_every`` (on the group path and per
  frame) and under ``stop_at``, the frame times across the segments and the
  relative-pose anchors. The one difference is deliberate: the port's
  first group after a resume is seeded from the device poses that the
  checkpoint carries, where the JAX pipeline re-seeds from host poses.
* Each of the seven algorithms at a tiny size on the CPU: a run stopped,
  written, resumed in a freshly built pipeline gives the uninterrupted
  run's bits, poses and whole state. The boundary falls between two groups
  for Co-SLAM, NICE-SLAM, Point-SLAM, SplaTAM and Vox-Fusion; after DPVO's
  initialisation, with frames already dropped; between NeuralRecon's
  fragments and inside one.
"""
import copy
import pickle
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.configs.cli import _set_dotted  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.engine import checkpoint as ckpt  # noqa: E402
from xrdslam_tpu_torch.ops.point_table import PointMap  # noqa: E402
from xrdslam_tpu_torch.pipeline import slam as tslam  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the guards
# ---------------------------------------------------------------------------

class Dummy:
    """JAX's dummy, with the port's pair of state methods."""

    initialized = False

    def checkpoint_state(self):
        return {"initialized": self.initialized}

    def restore_state(self, d):
        self.initialized = d.pop("initialized")


def _rewrite(path, **changes):
    with open(path, "rb") as f:
        state = pickle.load(f)
    for k, v in changes.items():
        if k == "attrs":
            state["attrs"].update(v)
        else:
            state[k] = v
    with open(path, "wb") as f:
        pickle.dump(state, f)


@pytest.mark.parametrize("case", ["atomic", "version", "algorithm", "unknown", "no_torch"])
def test_checkpoint_guards(tmp_path, capsys, case):
    path = str(tmp_path / "ck.pkl")
    if case == "no_torch":
        # a port algorithm's checkpoint holds numpy arrays and Python values:
        # a process that cannot import torch reads it
        algo = _pipeline("co-slam", tmp_path).algorithm
        ckpt.save_checkpoint(path, algo, 0, extra={"frame_times": [0.5]})
        code = ("import pickle, sys; sys.modules['torch'] = None; "
                f"s = pickle.load(open({path!r}, 'rb')); "
                "print(s['algorithm'], len(s['attrs']['model_params']))")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["CoSLAM", str(len(algo._named_state()["model_params"]))]
        return
    ckpt.save_checkpoint(path, Dummy(), 3)
    if case == "atomic":
        assert not (tmp_path / "ck.pkl.tmp").exists()  # written aside, then renamed
        assert ckpt.load_checkpoint(path, Dummy()) == 3
    elif case == "version":
        _rewrite(path, version=ckpt.CKPT_VERSION + 1)
        with pytest.raises(ValueError, match="version"):
            ckpt.load_checkpoint(path, Dummy())
    elif case == "algorithm":
        _rewrite(path, algorithm="SomethingElse")
        with pytest.raises(ValueError, match="SomethingElse"):
            ckpt.load_checkpoint(path, Dummy())
    else:
        _rewrite(path, attrs={"not_an_attr": 42})
        capsys.readouterr()
        assert ckpt.load_checkpoint(path, Dummy()) == 3  # skips, does not crash
        assert "skipping unknown attr 'not_an_attr'" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the pipeline's resume semantics, against the JAX pipeline
# ---------------------------------------------------------------------------

class _Clock:
    """time.time: advanced only by the stub, so that both pipelines read
    the same times."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class _Stub:
    """An algorithm that logs what the pipeline asks of it; its state is
    the host bookkeeping, as JAX's attributes and as the port's pair."""

    def __init__(self, clock, log):
        self.clock, self.log = clock, log
        self.config = SimpleNamespace(rot_rep="axis_angle")
        self.initialized = False
        self.estimate_c2w_list, self.gt_c2w_list, self.gt_c2w_list_ori, self.keyframe_fids = [], [], [], []
        self.kf_count = 0

    def checkpoint_state(self):
        return copy.deepcopy({k: getattr(self, k) for k in ("initialized", "estimate_c2w_list", "gt_c2w_list",
                                                           "gt_c2w_list_ori", "keyframe_fids", "kf_count")})

    def restore_state(self, d):
        for k in ("initialized", "estimate_c2w_list", "gt_c2w_list", "gt_c2w_list_ori", "keyframe_fids",
                  "kf_count"):
            setattr(self, k, d.pop(k))

    def is_initialized(self):
        return self.initialized

    def get_estimate_c2w_list(self):
        return self.estimate_c2w_list

    def _pose(self, fid):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.01 * fid, 0.0, 0.0]
        return c2w

    def dispatch_tracking(self, frame):
        self.log.append(("track", frame.fid))
        self.clock.now += 1.0
        return frame.fid if self.initialized else None

    def finish_tracking(self, handle):
        return None if handle is None else self._pose(handle)

    def do_mapping(self, frame):
        self.log.append(("map", frame.fid))
        self.clock.now += 3.0
        self.initialized = True

    def add_keyframe(self, frame):
        self.log.append(("keyframe", frame.fid))
        self.keyframe_fids.append(frame.fid)
        self.kf_count += 1

    def add_framepose(self, c2w, gt, gt_ori):
        self.estimate_c2w_list.append(np.asarray(c2w))
        self.gt_c2w_list.append(np.asarray(gt))
        self.gt_c2w_list_ori.append(np.asarray(gt_ori))

    def update_framepose(self, idx, c2w):
        self.estimate_c2w_list[idx] = np.asarray(c2w)

    def dispatch_superstep(self, frames, do_kf, prev_c2w=None, prev2_c2w=None, prev_tr=None, prev2_tr=None):
        self.log.append(("group", tuple(f.fid for f in frames), do_kf, prev_tr is not None))
        self.clock.now += 2.0
        if do_kf:
            self.keyframe_fids.append(frames[0].fid)
            self.kf_count += 1
        t = torch.tensor([[0.01 * f.fid, 0.0, 0.0] for f in frames])
        return t, torch.zeros_like(t), [f.fid for f in frames]

    def finish_superstep(self, handle):
        self.log.append(("fetch",))
        self.clock.now += 7.0
        return [self._pose(fid) for fid in handle[2]]


class _Frames:
    """Ground-truth poses that move and turn, so that the relative-pose
    anchors matter."""

    def __init__(self, n, camera):
        self.n, self.camera = n, camera

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        c, s = np.cos(0.05 * i + 0.3), np.sin(0.05 * i + 0.3)
        c2w = np.array([[c, 0, s, 1.0 + 0.02 * i], [0, 1, 0, -0.5], [-s, 0, c, 0.3 * i], [0, 0, 0, 1]], np.float32)
        return i, np.zeros((4, 4, 3), np.float32), np.ones((4, 4), np.float32), c2w

    def get_camera(self):
        return self.camera


def _segments(mod, ckpt_mod, camera, n, tracker, keyframe_every, stop_at, out_dir, clock, monkeypatch, **cfg):
    """Two segments through package ``mod``'s pipeline: frames up to
    ``stop_at``, then a fresh pipeline resumed from the checkpoint. Returns
    each segment's log, the (segment, frame index) of each checkpoint
    written, the final pipeline and the segments that wrote the run's
    outputs."""
    saved = []
    real_save = ckpt_mod.save_checkpoint

    def save(path, algorithm, frame_idx, extra=None):
        saved.append((seg, frame_idx))
        real_save(path, algorithm, frame_idx, extra=extra)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", save)
    if mod is tslam:
        monkeypatch.setattr(tslam, "save_checkpoint", save)
    logs, finished = [], []
    for seg in range(2):
        log = []
        config = mod.SLAMPipelineConfig(tracker=mod.TrackerConfig(**tracker),
                                        mapper=mod.MapperConfig(keyframe_every=keyframe_every),
                                        algorithm=SimpleNamespace(setup=lambda **kw: _Stub(clock, log)), **cfg)
        pipe = mod.SLAMPipeline(config, _Frames(n, camera), out_dir=str(out_dir), verbose=False)
        pipe._finish_run = lambda: finished.append(seg)
        if seg == 0:
            pipe.run(stop_at=stop_at)
        else:
            pipe.run(resume=True)
        logs.append(log)
    return logs, saved, pipe, finished


@pytest.mark.parametrize("n,map_every,keyframe_every,lazy_start,stop_at,every,relative", [
    (23, 5, 5, -1, 15, 7, False),  # between two groups; checkpoints inside groups
    (13, 1, 1, -1, 6, 4, True),  # groups of one frame
    (16, 2, 2, 7, 9, 3, True),  # in the lazy start, per frame
    (20, 3, 5, -1, 12, -1, False),  # no groups (keyframes inside them): per frame, no checkpoint_every
])
def test_resume_semantics_as_jax(n, map_every, keyframe_every, lazy_start, stop_at, every, relative, tmp_path,
                                 monkeypatch):
    pytest.importorskip("jax")
    from xrdslam_tpu.common.camera import Camera as JCamera
    from xrdslam_tpu.engine import checkpoint as jckpt
    from xrdslam_tpu.pipeline import slam as jslam
    from xrdslam_tpu_torch.common.camera import Camera

    cam = dict(fx=4.0, fy=4.0, cx=2.0, cy=2.0, height=4, width=4)
    tracker = dict(map_every=map_every, lazy_start=lazy_start, checkpoint_every=every, use_relative_pose=relative,
                   init_pose_offset=0.25)
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    args = (n, tracker, keyframe_every, stop_at)
    want_logs, want_saved, want, want_fin = _segments(jslam, jckpt, JCamera(**cam), *args, tmp_path / "jax", clock,
                                                      monkeypatch)
    got_logs, got_saved, got, got_fin = _segments(tslam, ckpt, Camera(**cam), *args, tmp_path / "port", clock,
                                                  monkeypatch, device="cpu")
    # a resumed segment that starts with a group: seeded from the device
    # poses in the port, from the host poses in JAX; the rest is the same
    if got_logs[1][0][0] == "group":
        assert got_logs[1][0][3] and not want_logs[1][0][3]
        want_logs[1][0] = want_logs[1][0][:3] + (True,)
    assert got_logs == want_logs
    assert got_saved == want_saved
    # the first segment's last checkpoint is its last frame: stop_at - 1, or
    # the end of the group that holds it
    n_first = len(want_logs[0]) and max(f for e in want_logs[0] if e[0] in ("track", "group")
                                        for f in (e[1] if e[0] == "group" else (e[1],)))
    assert [f for s, f in got_saved if s == 0][-1] == n_first and stop_at - 1 <= n_first < stop_at - 1 + map_every
    assert got_fin == want_fin == [1]  # the first segment writes no outputs
    assert got.frame_times == want.frame_times and len(got.frame_times) == n
    ga, wa = got.algorithm, want.algorithm
    assert len(ga.estimate_c2w_list) == n and ga.keyframe_fids == wa.keyframe_fids
    for a, b in [(ga.gt_c2w_list, wa.gt_c2w_list), (ga.gt_c2w_list_ori, wa.gt_c2w_list_ori),
                 (ga.estimate_c2w_list, wa.estimate_c2w_list)]:
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    if relative:
        np.testing.assert_array_equal(got._first_pose_old, want._first_pose_old)
        np.testing.assert_array_equal(got._first_pose_new, want._first_pose_new)
        assert got._first_pose_new[0, 3] == 0.25


# ---------------------------------------------------------------------------
# each algorithm: a resumed run gives the uninterrupted run's bits
# ---------------------------------------------------------------------------

A = "algorithm."
BOUND = [[-2.2, 2.2]] * 3
# name -> (data, overrides of the registry's entry, stop_at, the group heads
# of the first segment and of the whole run)
CASES = {
    "co-slam": ("n_frames=10,height=30,width=40,scene=simple", {
        A + "mapping_bound": BOUND, A + "marching_cubes_bound": BOUND, A + "tracking_n_iters": 2,
        A + "mapping_n_iters": 2, A + "mapping_first_n_iters": 3, A + "tracking_sample": 64,
        A + "mapping_sample": 128, A + "min_sample_pixels": 16, A + "tracking_Hedge": 4, A + "tracking_Wedge": 4,
        A + "max_keyframes": 8, A + "model.n_levels": 4, A + "model.hashsize": 10, A + "model.base_resolution": 8,
        A + "model.trainging_smooth_pts": 8, "tracker.map_every": 2, "mapper.keyframe_every": 2}, [6], [4], [4, 6]),
    "nice-slam": ("n_frames=9,height=48,width=64", {
        A + "mapping_bound": BOUND, A + "marching_cubes_bound": BOUND, A + "tracking_n_iters": 2,
        A + "mapping_n_iters": 2, A + "mapping_first_n_iters": 3, A + "mapping_window_size": 3,
        A + "tracking_sample": 48, A + "mapping_sample": 96, A + "min_sample_pixels": 16, A + "tracking_Hedge": 4,
        A + "tracking_Wedge": 4, A + "max_keyframes": 10, A + "model.rendering_n_samples": 12,
        A + "model.rendering_n_surface": 6, "tracker.map_every": 2, "mapper.keyframe_every": 2}, [6], [4], [4, 6]),
    "splaTAM": ("n_frames=6,height=48,width=64,scene=simple", {
        A + "model.max_gaussians": 8192, A + "model.k_per_tile": 48, A + "tracking_n_iters": 3,
        A + "mapping_n_iters": 3, A + "mapping_first_n_iters": 5, A + "mapping_window_size": 3,
        "mapper.keyframe_every": 2}, [4], [2, 3], [2, 3, 4]),
    "point-slam": ("n_frames=9,height=48,width=64", {
        A + "tracking_n_iters": 3, A + "mapping_n_iters": 5, A + "mapping_first_n_iters": 5,
        A + "mapping_window_size": 3, A + "tracking_sample": 64, A + "mapping_sample": 96,
        A + "min_sample_pixels": 8, A + "tracking_Wedge": 4, A + "tracking_Hedge": 4, A + "pixels_adding": 300,
        A + "max_keyframes": 8, A + "model.max_points": 8192, "tracker.map_every": 2, "tracker.lazy_start": -1,
        "mapper.keyframe_every": 2}, [6], [4], [4, 6]),
    "vox-fusion": ("n_frames=5,height=48,width=64", {
        A + "tracking_n_iters": 3, A + "mapping_n_iters": 3, A + "mapping_first_n_iters": 5,
        A + "mapping_window_size": 3, A + "mapping_sample": 96, A + "tracking_sample": 96, A + "max_keyframes": 8,
        A + "model.max_voxels": 4096, A + "model.num_embeddings": 8192, A + "model.coarse_steps": 48,
        A + "model.max_voxel_hit": 6, A + "model.samples_per_voxel": 4, "mapper.keyframe_every": 2},
        [3], [2], [2, 3]),
    # tests/test_torch_dpvo.py's smoke settings on random weights; every
    # keyframe test drops a frame, so the delta chain and the rings' shifts
    # are part of the state at the boundary
    "dpvo": ("n_frames=10,height=64,width=80", {
        A + "patch_per_frame": 8, A + "patch_lifetime": 4, A + "init_frame_num": 4, A + "optimization_window": 5,
        A + "removal_window": 6, A + "keyframe_index": 2, A + "keyframe_thresh": 1e9, A + "buffer_size": 64,
        A + "mem": 12, A + "edge_chunk": 256, A + "motion_init_thresh": 0.0, A + "model.pretrained_path": ""},
        [6], [], []),
    # tests/test_torch_neural_recon.py's smoke settings on random weights: a
    # fragment every 4 frames; the boundaries after the first fragment and
    # inside the second
    "neuralRecon": ("n_frames=8,height=48,width=64", {
        A + "mapping_window_size": 3, A + "min_angle": 0.0, A + "min_distance": 0.0, A + "max_depth": 3.0,
        A + "img_size_w": 64, A + "img_size_h": 48, A + "model.n_vox": 32, A + "model.voxel_size": 0.15},
        [4, 6], [], []),
}


def _pipeline(name, out_dir):
    """The registry's ``name`` at its case's tiny size, on the CPU, without
    the post-run sweep. Point-SLAM gets a hash of 4,096 rows in place of
    65,536 (256 MiB of rows)."""
    data, overrides = CASES[name][:2]
    cfg = copy.deepcopy(algorithm_configs[name])
    cfg.data, cfg.data_type, cfg.out_dir = data, "synthetic", str(out_dir)
    cfg.xrdslam.device = "cpu"
    cfg.xrdslam.tracker.save_re_render_result = False
    for path, value in overrides.items():
        _set_dotted(cfg.xrdslam, path, value)
    pipe = cfg.setup().setup()
    pipe.verbose = False
    if name == "point-slam":
        algo = pipe.algorithm
        pm = algo.point_map
        algo.point_map = PointMap(max_points=pm.max_points, cell_size=pm.cell_size, hash_cap=1 << 12)
        algo.maps = algo.point_map.device_state(algo.device)
    return pipe


class _PlainUnpickler(pickle.Unpickler):
    """Refuses every class outside numpy and the standard library's
    containers: a checkpoint holds no tensor and no port object."""

    def find_class(self, module, name):
        if module.split(".")[0] not in ("numpy", "builtins", "collections", "copyreg", "_codecs"):
            raise pickle.UnpicklingError(f"{module}.{name} in a checkpoint")
        return super().find_class(module, name)


def _same(a, b, where="state"):
    """Equal trees of arrays and Python values, arrays bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


@pytest.mark.parametrize("name", list(CASES))
def test_resumed_run_gives_the_uninterrupted_bits(name, tmp_path):
    stops, heads_first, heads_all = CASES[name][2:]
    whole = _pipeline(name, tmp_path / "whole")
    whole.run()
    assert whole.groups == heads_all
    want = whole.algorithm.checkpoint_state()
    assert len(want["estimate_c2w_list"]) == len(whole.dataset)
    for stop in stops:
        out = tmp_path / f"stop{stop}"
        first = _pipeline(name, out)
        first.run(stop_at=stop)
        assert len(first.algorithm.estimate_c2w_list) == stop and first.groups == heads_first
        saved, at_stop = first.algorithm.save_state(), first.algorithm.checkpoint_state()
        assert not (out / "eval.tar").exists()  # a segment writes the checkpoint, not the outputs
        with open(out / "checkpoint.pkl", "rb") as f:
            state = _PlainUnpickler(f).load()
        assert state["frame_idx"] == stop - 1 and state["algorithm"] == type(whole.algorithm).__name__
        # the boundary follows a group: the next one is seeded from its device poses
        assert bool(state["extra"]["dev_pose_hist"]) == bool(heads_first)
        second = _pipeline(name, out)
        second.run(resume=True)
        assert second.groups == heads_all
        assert len(second.frame_times) == len(whole.dataset)
        assert (out / "eval.tar").exists()
        _same(second.algorithm.checkpoint_state(), want)
        # the in-process copy covers the checkpoint's state: put back into
        # the resumed run's algorithm, it gives the boundary's state
        second.algorithm.load_state(saved)
        _same(second.algorithm.checkpoint_state(), at_stop)
    if name == "dpvo":
        assert whole.algorithm.delta and whole.algorithm.n_updates > 0
    if name == "neuralRecon":
        assert whole.algorithm.fragment_id == 2 and whole.algorithm.tsdf_vol.data is not None
