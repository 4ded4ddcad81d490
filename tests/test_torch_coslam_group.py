"""Co-SLAM's fused group step and the pipeline's group path in the port.

On the CPU the group program runs eagerly:

* ``dispatch_superstep`` / ``finish_superstep`` give the bits of the
  per-frame sequence that the group fuses (``track_step``, ``map_step``,
  the keyframe insertion, ``track_step`` on each tail frame, every seed
  from ``_predict``), from the same state and generator seed, for the
  packed hash, the exact hash and the tri-plane;
* with no optimization iterations (so that no random draw decides the
  result) the port's group returns the JAX package's chained
  constant-velocity poses and keyframe pose rows, within 1e-5;
* on a stub algorithm the port's pipeline splits a run into the JAX
  pipeline's group heads and per-frame frames, and spreads a group's time
  over its frames as the JAX pipeline does.

On the card (``cuda`` marker; skipped without one) a replay of the
captured group is held against the eager group from the same state and
generator state: the same bits for the packed hash and the tri-plane,
within ``EXACT_TOL`` for the exact hash's poses, losses and keyframe rows
(its table gradient adds with atomics, K3), with the same kernel launches.
"""
import copy
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.algorithms.coslam import CoSLAMConfig  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.models.joint_encoding import JointEncodingConfig  # noqa: E402
from xrdslam_tpu_torch.ops import hashgrid_fast, lie_np, scatter  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


G = 3  # frames a group
SIZE = dict(height=30, width=40, scene="simple")
ENCODINGS = {"packed": dict(n_levels=4, hashsize=10, base_resolution=8),
             "exact": dict(n_levels=4, hashsize=10, base_resolution=8, hash_packed=False),
             "triplane": dict(encoding="triplane", triplane_resolutions=(16, 32), triplane_features=(4, 4))}
# pose (m, rad) and map tolerance of a replay against an eager group on the
# exact hash: K3 adds the table gradient with fp32 atomics, in another order
# in every run
EXACT_TOL = 1e-4


def _algo(encoding: str, device: str = "cpu", n_iters: int = 2):
    """A small Co-SLAM after its first mapping and keyframe (frame 0), and
    the frames 0..G of its sequence."""
    ds = SyntheticDataset(n_frames=G + 1, **SIZE)
    cfg = copy.deepcopy(algorithm_configs["co-slam"].xrdslam.algorithm)
    cfg.model = JointEncodingConfig(**ENCODINGS[encoding], trainging_smooth_pts=8)
    cfg.mapping_bound = cfg.marching_cubes_bound = ds.bounds.tolist()
    cfg.tracking_n_iters = cfg.mapping_n_iters = n_iters
    cfg.mapping_first_n_iters = 3
    cfg.tracking_sample, cfg.mapping_sample, cfg.min_sample_pixels = 64, 128, 16
    cfg.tracking_Hedge = cfg.tracking_Wedge = 4
    cfg.max_keyframes = 8
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    frames = [Frame(fid=i, rgb=ds[i][1], depth=ds[i][2], init_pose=ds[i][3]) for i in range(G + 1)]
    algo.do_mapping(frames[0])
    algo.add_keyframe(frames[0])
    return algo, frames, [ds[i][3] for i in range(G + 1)]


def _prev(algo, c2w):
    return tuple(algo._pose(v) for v in lie_np.matrix_to_pose_vec(np.asarray(c2w, np.float32), rot_rep="axis_angle"))


@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_group_step_gives_the_per_frame_sequence_bits(encoding):
    algo, frames, gts = _algo(encoding)
    group = frames[1:]
    prev, prev2 = gts[0], gts[0] @ np.linalg.inv(gts[1]) @ gts[0]  # a pose "before" frame 0
    cur_cap = algo._cur_cap()
    saved = algo.save_state()
    # the group program, through the host API
    got = algo.finish_superstep(algo.dispatch_superstep(group, True, prev, prev2))
    got_state = [t.detach().clone() for t in algo._state_tensors()]
    assert algo.kf_count == 2 and algo.keyframe_fids == [0, 1]
    # the per-frame steps it fuses, from the same state
    algo.load_state(saved)
    last, before = _prev(algo, prev), _prev(algo, prev2)
    want = []
    rgbs = [f.rgb_dev(algo.device) for f in group]
    depths = [f.depth_dev(algo.device) for f in group]
    bt, br, _ = algo.track_step(rgbs[0], depths[0], *algo._predict(*last, *before))
    ct, cr = algo.map_step(rgbs[0], depths[0], bt, br, algo.config.mapping_n_iters, False, cur_cap)
    algo.add_kf(rgbs[0], depths[0], ct, cr)
    want.append((ct, cr))
    last, before = (ct, cr), last
    for rgb, depth in zip(rgbs[1:], depths[1:]):
        bt, br, _ = algo.track_step(rgb, depth, *algo._predict(*last, *before))
        want.append((bt, br))
        last, before = (bt, br), last
    for j, (t, r) in enumerate(want):
        np.testing.assert_array_equal(got[j], lie_np.pose_vec_to_matrix(t.numpy(), r.numpy(), rot_rep="axis_angle"),
                                      err_msg=f"{encoding}: pose of group frame {j}")
    for a, b in zip(got_state, algo._state_tensors()):
        assert torch.equal(a, b), f"{encoding}: the state after the group differs from the per-frame sequence's"
    assert int(algo.kf_count_dev) == 2


@pytest.mark.parametrize("encoding", ["triplane", "packed"])
def test_group_step_matches_jax_at_zero_iterations(encoding):
    """No iterations: each pose is the prediction chained from the one
    before; the keyframe row is the head's pose."""
    pytest.importorskip("jax")
    import jax

    from xrdslam_tpu.algorithms.coslam import CoSLAMConfig as JCoSLAMConfig
    from xrdslam_tpu.common.frame import Frame as JFrame
    from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset
    from xrdslam_tpu.configs.registry import algorithm_configs as jreg
    from xrdslam_tpu.models.joint_encoding import JointEncodingConfig as JJointEncodingConfig
    from xrdslam_tpu_torch.utils.from_jax import params_from_jax

    ds = JSyntheticDataset(n_frames=G + 2, **SIZE)
    common = dict(tracking_n_iters=0, mapping_n_iters=0, mapping_first_n_iters=0, mapping_sample=128,
                  tracking_sample=64, min_sample_pixels=16, tracking_Wedge=4, tracking_Hedge=4,
                  mapping_bound=ds.bounds.tolist(), marching_cubes_bound=ds.bounds.tolist(), max_keyframes=4)
    jalgo = JCoSLAMConfig(model=JJointEncodingConfig(**ENCODINGS[encoding]), **common,
                          optimizers=jreg["co-slam"].xrdslam.algorithm.optimizers).setup(camera=ds.get_camera())
    talgo = CoSLAMConfig(model=JointEncodingConfig(**ENCODINGS[encoding]), **common,
                         optimizers=algorithm_configs["co-slam"].xrdslam.algorithm.optimizers).setup(
        camera=SyntheticDataset(n_frames=G + 2, **SIZE).get_camera(), device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), talgo.model)
    jalgo.set_initialized()
    talgo.set_initialized()
    items = [ds[i] for i in range(G + 2)]
    prev2, prev = items[0][3], items[1][3]
    jh = jalgo.dispatch_superstep([JFrame(fid=i, rgb=rgb, depth=d) for i, rgb, d, _ in items[2:]], True, prev, prev2)
    th = talgo.dispatch_superstep([Frame(fid=i, rgb=rgb, depth=d) for i, rgb, d, _ in items[2:]], True, prev, prev2)
    want, got = np.stack(jalgo.finish_superstep(jh)), np.stack(talgo.finish_superstep(th))
    assert got.shape == (G, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the poses move: the chain is not the identity
    assert np.abs(got[-1, :3, 3] - prev[:3, 3]).max() > 1e-3
    for name in ("kf_pose_t", "kf_pose_r"):
        np.testing.assert_allclose(getattr(talgo, name).numpy()[:2], np.asarray(getattr(jalgo, name))[:2],
                                   atol=1e-5, rtol=0, err_msg=name)
    assert talgo.kf_count == jalgo.kf_count == 1


class _Clock:
    """A clock that moves only when the stub algorithm works, so that both
    pipelines read the same times however often they read it."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class _Stub:
    """An algorithm that logs what the pipeline asks of it."""

    def __init__(self, clock, log):
        self.clock, self.log = clock, log
        self.config = SimpleNamespace(rot_rep="axis_angle")
        self.initialized = False
        self.estimate_c2w_list, self.gt_c2w_list, self.gt_c2w_list_ori = [], [], []

    def is_initialized(self):
        return self.initialized

    def get_estimate_c2w_list(self):
        return self.estimate_c2w_list

    def dispatch_tracking(self, frame):
        self.log.append(("track", frame.fid))
        self.clock.now += 1.0
        return "handle" if self.initialized else None

    def finish_tracking(self, handle):
        return None if handle is None else np.eye(4, dtype=np.float32)

    def do_mapping(self, frame):
        self.log.append(("map", frame.fid))
        self.clock.now += 3.0
        self.initialized = True

    def add_keyframe(self, frame):
        self.log.append(("keyframe", frame.fid))

    def add_framepose(self, c2w, gt, gt_ori):
        self.log.append(("pose", len(self.estimate_c2w_list)))
        self.estimate_c2w_list.append(np.asarray(c2w))

    def update_framepose(self, idx, c2w):
        self.estimate_c2w_list[idx] = np.asarray(c2w)

    def dispatch_superstep(self, frames, do_kf, prev_c2w=None, prev2_c2w=None, prev_tr=None, prev2_tr=None):
        self.log.append(("group", tuple(f.fid for f in frames), do_kf, prev_tr is not None))
        self.clock.now += 2.0
        poses = np.zeros((len(frames), 3), np.float32)
        return poses, poses.copy(), len(frames)

    def finish_superstep(self, handle):
        self.log.append(("fetch",))
        self.clock.now += 7.0
        return [np.eye(4, dtype=np.float32)] * handle[2]


class _StubDataset:
    def __init__(self, n, camera):
        self.n, self.camera = n, camera

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i, np.zeros((4, 4, 3), np.float32), np.ones((4, 4), np.float32), np.eye(4, dtype=np.float32)

    def get_camera(self):
        return self.camera


def _run_stub(pipeline_mod, camera, n, map_every, keyframe_every, lazy_start, tmp_path, clock, **cfg):
    log = []
    algo_cfg = SimpleNamespace(setup=lambda **kw: _Stub(clock, log))
    config = pipeline_mod.SLAMPipelineConfig(
        tracker=pipeline_mod.TrackerConfig(map_every=map_every, lazy_start=lazy_start),
        mapper=pipeline_mod.MapperConfig(keyframe_every=keyframe_every), algorithm=algo_cfg, **cfg)
    pipe = pipeline_mod.SLAMPipeline(config, _StubDataset(n, camera), out_dir=str(tmp_path), verbose=False)
    pipe._finish_run = lambda: None
    pipe.run()
    return log, pipe.frame_times


@pytest.mark.parametrize("n,map_every,keyframe_every,lazy_start", [
    (23, 5, 5, -1), (24, 4, 8, 6), (13, 1, 1, -1), (20, 3, 5, -1), (16, 2, 2, 7)])
def test_pipeline_groups_as_jax(n, map_every, keyframe_every, lazy_start, tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from xrdslam_tpu.common.camera import Camera as JCamera
    from xrdslam_tpu.pipeline import slam as jslam
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.pipeline import slam as tslam

    cam = dict(fx=4.0, fy=4.0, cx=2.0, cy=2.0, height=4, width=4)
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    args = (n, map_every, keyframe_every, lazy_start)
    want, want_times = _run_stub(jslam, JCamera(**cam), *args, tmp_path / "jax", clock)
    got, got_times = _run_stub(tslam, Camera(**cam), *args, tmp_path / "port", clock, device="cpu")
    assert got == want
    assert got_times == want_times and len(got_times) == n
    # every case but the one whose keyframes fall inside groups has groups
    assert any(e[0] == "group" for e in got) == (keyframe_every % map_every == 0)


def test_pipeline_disable_super_runs_every_frame_alone(tmp_path, monkeypatch):
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.pipeline import slam as tslam

    cam = Camera(fx=4.0, fy=4.0, cx=2.0, cy=2.0, height=4, width=4)
    monkeypatch.setenv("XRDSLAM_DISABLE_SUPER", "1")
    log, times = _run_stub(tslam, cam, 23, 5, 5, -1, tmp_path, _Clock(), device="cpu")
    assert not any(e[0] == "group" for e in log) and len(times) == 23
    assert [e[1] for e in log if e[0] == "map"] == [0, 5, 10, 15, 20, 22]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _launches():
    by_n = {f"hashgrid_fwd@{n}": c for n, c in hashgrid_fast.FWD_LAUNCHES_BY_N.items()}
    return {**hashgrid_fast.LAUNCHES, **by_n, **scatter.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_cuda_group_replay_equals_eager_group(encoding):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    algo, frames, gts = _algo(encoding, "cuda")
    group = frames[1:]
    key, program = algo._get_super_step(G, True)
    inputs = ([f.rgb_dev(algo.device) for f in group] + [f.depth_dev(algo.device) for f in group]
              + [*_prev(algo, gts[0]), *_prev(algo, gts[0])])
    algo.graphs(key, program, inputs)  # the warm-up and the capture
    assert key in algo.graphs.captures
    saved = algo.save_state()
    hashgrid_fast.reset_launches()
    scatter.reset_launches()
    eager = program(*inputs)
    torch.cuda.synchronize()
    eager_launches, eager_state = _launches(), [t.detach().clone() for t in algo._state_tensors()]
    algo.load_state(saved)
    hashgrid_fast.reset_launches()
    scatter.reset_launches()
    replay = algo.graphs(key, program, inputs)
    torch.cuda.synchronize()
    assert algo.graphs.replays[key] == 1
    assert _launches() == eager_launches
    used = ("hashgrid_fwd", "hashgrid_bwd_dx", "hashgrid_bwd_dtable") if encoding == "exact" else ("scatter_add",)
    assert all(eager_launches[k] > 0 for k in used), eager_launches
    if encoding != "exact":
        for a, b in list(zip(eager, replay)) + list(zip(eager_state, algo._state_tensors())):
            assert torch.equal(a, b)
        return
    # the exact hash: the poses, the best losses (relative), the keyframe
    # rows and count. Its map is not compared entrywise: where a table
    # entry's gradient is a sum that cancels, another order of the atomic
    # adds can flip its sign, and Adam then steps that entry the other way.
    for a, b in zip(eager, replay):
        scale = max(float(a.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= EXACT_TOL * scale
    for a, b in zip(eager_state[-4:], algo._state_tensors()[-4:]):
        assert float((a.double() - b.double()).abs().max()) <= EXACT_TOL
