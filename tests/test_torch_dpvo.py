"""DPVO in the port against the JAX package, at the JAX smoke's settings.

The JAX package's ``test_dpvo_pipeline_smoke`` configuration (10 synthetic
frames at 64x80, 8 patches a frame, ``edge_chunk`` 256, random weights
from the JAX network's seed) runs once through the JAX pipeline; its
weights go to the port with ``dpvo_params_from_jax`` and its frames, as
numpy, to the port's pipeline (on the CPU), so that both packages see the
same images, weights and patch draws.

* ``_neighbors``: the port's sorted search gives the JAX dict loop's
  arrays, on the run's graph and on graphs with gaps and repeated pairs.
* One update from one state: the JAX DPVO's state after its 10 frames
  (graph, poses, patches, rings, hidden states, the patch generator) is
  carried into a port DPVO with ``dpvo_state_from_jax``, and each package
  runs one update: the hidden states to 1e-4 of the largest, poses to
  1e-4, patch depths to 1e-4 of the largest, points to 1e-3 of the
  largest (a point divides by a depth near its clamp).
* The 10-frame run: the graph bookkeeping (``counter``, ``n``, ``m``,
  ``ii``/``jj``/``kk``) equal to JAX's, and the two trajectories within
  1e-3 m (the updates take the same steps from images, weights and draws
  that agree; float32 sums in another order move them by much less).
* The registry's ``dpvo`` entry equals the JAX one, and the CLI asks for
  CUDA by default.

On the card (``cuda`` marker; skipped without one): one update on the
card against the CPU from one state (hidden states and depths to 1e-3 of
the largest, poses to 1e-4: cuDNN's and cuBLAS' float32 sums in their own
order), and a second update from the same state with the same bits, K4's
deterministic sums.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.algorithms.dpvo import DPVOConfig, neighbors  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.ops import scatter  # noqa: E402
from xrdslam_tpu_torch.pipeline.slam import MapperConfig, SLAMPipelineConfig, TrackerConfig  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import dpvo_params_from_jax, dpvo_state_from_jax  # noqa: E402

N_FRAMES, H, W = 10, 64, 80
# the JAX package's test_dpvo_pipeline_smoke settings
SMOKE = dict(patch_per_frame=8, patch_lifetime=4, init_frame_num=4, optimization_window=5, removal_window=6,
             keyframe_index=2, keyframe_thresh=0.01, buffer_size=64, mem=12, edge_chunk=256,
             motion_init_thresh=0.0)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, what, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


class FramesOf:
    """A dataset of another package's frames, as numpy."""

    def __init__(self, ds):
        self.ds = ds
        c = ds.get_camera()
        self.camera = Camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, height=c.height, width=c.width)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        idx, rgb, depth, c2w = self.ds[i]
        return idx, np.asarray(rgb), np.asarray(depth), np.asarray(c2w)

    def get_camera(self):
        return self.camera


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _snapshot(src):
    """A shallow copy of a JAX DPVO whose host state is copies of ``src``'s."""
    dst = copy.copy(src)
    for k in ("tstamps", "poses_t", "poses_q", "patches", "colors", "points", "ii", "jj", "kk", "net"):
        setattr(dst, k, np.array(getattr(src, k)))
    dst.tlist, dst.delta, dst._rng = list(src.tlist), dict(src.delta), copy.deepcopy(src._rng)
    return dst


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX smoke's run: (its pipeline, its dataset, its weights as numpy,
    a copy of its state after the 10 frames)."""
    pytest.importorskip("jax")
    from xrdslam_tpu.algorithms.dpvo import DPVOConfig as JDPVOConfig
    from xrdslam_tpu.common.synthetic import SyntheticDataset
    from xrdslam_tpu.pipeline import slam as jslam

    ds = SyntheticDataset(n_frames=N_FRAMES, height=H, width=W)
    cfg = jslam.SLAMPipelineConfig(
        tracker=jslam.TrackerConfig(map_every=-1, render_freq=-1, save_re_render_result=False),
        mapper=jslam.MapperConfig(keyframe_every=100), algorithm=JDPVOConfig(**SMOKE))
    pipe = cfg.setup(dataset=ds, out_dir=str(tmp_path_factory.mktemp("jax_dpvo")), verbose=False)
    pipe.run()
    return pipe, ds, _numpy_tree(pipe.algorithm.params), _snapshot(pipe.algorithm)


def _port_algo(ds, params):
    algo = DPVOConfig(**SMOKE).setup(camera=FramesOf(ds).get_camera(), device=torch.device("cpu"))
    dpvo_params_from_jax(params, algo.model)
    return algo


def test_neighbors_equal_the_reference(jax_run):
    pipe, *_ = jax_run
    algo = pipe.algorithm
    for k, j in ((algo.kk, algo.jj),
                 (np.array([5, 5, 5, 5, 2, 2, 7, 5, 2]), np.array([0, 1, 3, 1, 4, 3, 0, 2, 5])),
                 (np.zeros(0, np.int64), np.zeros(0, np.int64))):
        saved = algo.kk, algo.jj
        algo.kk, algo.jj = np.asarray(k, np.int64), np.asarray(j, np.int64)
        try:
            want = algo._neighbors()
        finally:
            algo.kk, algo.jj = saved
        got = neighbors(np.asarray(k, np.int64), np.asarray(j, np.int64))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_one_update_from_the_reference_state(jax_run):
    pipe, ds, params, state = jax_run
    port = dpvo_state_from_jax(_port_algo(ds, params), state)
    ref = _snapshot(state)
    port.update()
    ref.update()
    E = len(ref.ii)
    assert len(port.ii) == E and port.n_updates == 1
    _close(port.net.numpy(), np.asarray(ref.net), "net", 1e-4)
    n = ref.n
    _close(port.poses_t[:n], ref.poses_t[:n], "poses_t", 1e-4)
    _close(port.poses_q[:n], ref.poses_q[:n], "poses_q", 1e-4)
    _close(port.patches[:n, ..., 2], ref.patches[:n, ..., 2], "depths", 1e-4)
    _close(port.points[: ref.m], ref.points[: ref.m], "points", 1e-3)


def test_the_ten_frame_run(jax_run, tmp_path):
    pipe, ds, params, _ = jax_run
    cfg = SLAMPipelineConfig(tracker=TrackerConfig(map_every=-1), mapper=MapperConfig(keyframe_every=100),
                             algorithm=DPVOConfig(**SMOKE), device="cpu")
    port = cfg.setup(dataset=FramesOf(ds), out_dir=str(tmp_path), verbose=False)
    dpvo_params_from_jax(params, port.algorithm.model)
    port.run()
    got, want = port.algorithm, pipe.algorithm
    assert (got.counter, got.n, got.m) == (want.counter, want.n, want.m) == (N_FRAMES, got.n, got.m)
    for k in ("ii", "jj", "kk"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.is_initialized() and got.n_updates >= 12
    est, ref = np.stack(got.estimate_c2w_list), np.stack(want.estimate_c2w_list)
    assert np.isfinite(est).all() and est.shape == ref.shape
    err = float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max())
    assert err <= 1e-3, f"trajectories {err:.2e} m apart"
    _close(est[:, :3, :3], ref[:, :3, :3], "rotations", 1e-3)
    pos, _ = got.get_cloud()
    assert np.isfinite(pos).all() and len(pos)


def test_registry_entry_equals_the_reference():
    pytest.importorskip("jax")
    from xrdslam_tpu.configs.registry import algorithm_configs as jconfigs

    got, want = algorithm_configs["dpvo"].xrdslam, jconfigs["dpvo"].xrdslam
    for f in dataclasses.fields(got.algorithm):
        if f.name in ("_target", "model", "optimizers"):
            continue
        assert getattr(got.algorithm, f.name) == getattr(want.algorithm, f.name), f.name
    assert got.algorithm.model.pretrained_path == want.algorithm.model.pretrained_path
    assert got.tracker.map_every == want.tracker.map_every == -1


def test_cli_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from xrdslam_tpu_torch.scripts.run import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["dpvo", "--data-type", "synthetic", "--data", "n_frames=2,height=64,width=80",
              "--out-dir", str(tmp_path)])


def _port_state(n_frames=6):
    """A port DPVO on the CPU after ``n_frames`` of the port's synthetic
    scene at the smoke's settings, and the frames."""
    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset

    ds = SyntheticDataset(f"n_frames={n_frames},height={H},width={W}")
    algo = DPVOConfig(**SMOKE).setup(camera=ds.get_camera(), device=torch.device("cpu"))
    for i in range(n_frames):
        _, rgb, depth, gt = ds[i]
        c2w = algo.do_tracking(Frame(fid=i, rgb=rgb, depth=depth))
        algo.add_framepose(gt if c2w is None else c2w, gt, gt)
    return algo, ds


@pytest.mark.cuda
def test_cuda_update_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    src, ds = _port_state()
    cpu = dpvo_state_from_jax(DPVOConfig(**SMOKE).setup(camera=ds.get_camera(), device=torch.device("cpu")), src)
    cpu.model.load_state_dict(src.model.state_dict())
    runs = []
    for _ in range(2):
        card = DPVOConfig(**SMOKE).setup(camera=ds.get_camera(), device=torch.device("cuda"))
        card.model.load_state_dict(src.model.state_dict())
        dpvo_state_from_jax(card, src)
        scatter.reset_launches()
        card.update()
        assert scatter.LAUNCHES["scatter_add"] == 12
        runs.append(card)
    cpu.update()
    a, b = runs
    assert torch.equal(a.net, b.net)
    for k in ("poses_t", "poses_q", "patches", "points"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    n = cpu.n
    _close(a.net.cpu().numpy(), cpu.net.numpy(), "net", 1e-3)
    _close(a.poses_t[:n], cpu.poses_t[:n], "poses_t", 1e-4)
    _close(a.poses_q[:n], cpu.poses_q[:n], "poses_q", 1e-4)
    _close(a.patches[:n, ..., 2], cpu.patches[:n, ..., 2], "depths", 1e-3)
