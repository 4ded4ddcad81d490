"""NICE-SLAM's fused group step and the pipeline's group path in the port.

On the CPU the group program runs eagerly:

* ``dispatch_superstep`` / ``finish_superstep`` give the bits of the
  per-frame steps that the group fuses (``track_step`` from
  ``predict_q``, the device frustum masks, the fine window's
  ``map_step`` with its pose write-back, the coarse window's, the
  keyframe insertion, ``track_step`` on the tail frame), from the same
  state, generator and window picks, with and without pose optimisation
  and a keyframe;
* with no optimization iterations (so that no random draw decides the
  result) the port's group returns the JAX package's chained
  constant-velocity poses and keyframe pose rows, within 1e-5;
* on a stub algorithm the port's pipeline splits NICE-SLAM's runs (the
  registry's ``map_every`` 5 and ``keyframe_every`` 50, and the accuracy
  protocol's 2 and 10) into the JAX pipeline's group heads and per-frame
  frames.

On the card (``cuda`` marker; skipped without one) a replay of the
captured group is held against the eager group from the same state and
generator state: the same bits, with the same kernel launches (K4 for the
grid gradients).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.ops import lie, lie_np, scatter  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


G = 2  # frames a group, as the protocol's map_every
SIZE = dict(height=48, width=64)  # wider than the overlap ranking's 2 x 20 px edge


def _config(n_iters: int = 2, **over):
    """The registry's NICE-SLAM at a tiny size (the JAX package's tiny
    grids and samples)."""
    cfg = copy.deepcopy(algorithm_configs["nice-slam"].xrdslam.algorithm)
    bound = [[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]]
    cfg.mapping_bound = cfg.marching_cubes_bound = bound
    cfg.tracking_n_iters = cfg.mapping_n_iters = n_iters
    cfg.mapping_first_n_iters = 3
    cfg.mapping_window_size = 3
    cfg.tracking_sample, cfg.mapping_sample, cfg.min_sample_pixels = 48, 96, 16
    cfg.tracking_Hedge = cfg.tracking_Wedge = 4
    cfg.max_keyframes = 10
    cfg.model.rendering_n_samples, cfg.model.rendering_n_surface = 12, 6
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _algo(n_kf: int, device: str = "cpu"):
    """A small NICE-SLAM after its first mapping (frame 0) with ``n_kf``
    keyframes (frames 0.. at their true poses), and the frames of its
    sequence."""
    n = max(n_kf, 1) + G + 2
    ds = SyntheticDataset(n_frames=n, **SIZE)
    algo = _config().setup(camera=ds.get_camera(), device=device)
    frames = [Frame(fid=i, rgb=ds[i][1], depth=ds[i][2], init_pose=ds[i][3], rot_rep="quat") for i in range(n)]
    algo.do_mapping(frames[0])
    for f in frames[:n_kf]:
        algo.add_keyframe(f)
    return algo, frames, [ds[i][3] for i in range(n)]


@pytest.mark.parametrize("n_kf,do_kf", [(2, True), (6, False), (6, True)])
def test_group_step_gives_the_per_frame_sequence_bits(n_kf, do_kf):
    """kf_count 2: no pose optimisation; 6: the window's poses optimised
    and written back."""
    algo, frames, gts = _algo(n_kf)
    h = n_kf
    group = frames[h:h + G]
    prev, prev2 = gts[h - 1], gts[h - 2]
    algo.estimate_c2w_list = [np.asarray(g) for g in gts[:h]]
    saved = algo.save_state()
    got = algo.finish_superstep(algo.dispatch_superstep(group, do_kf, prev, prev2))
    got_state = [t.detach().clone() for t in algo._state_tensors()]
    assert algo.kf_count == n_kf + do_kf
    # the steps it fuses, from the same state and picks
    algo.load_state(saved)
    key, _, inputs = algo.group_call(group, do_kf, prev, prev2)
    assert key == (G, n_kf > 4, do_kf)
    rgbs, depths = inputs[:G], inputs[G:2 * G]
    fine_slots, coarse_slots, n_valid_f, n_valid_c = inputs[2 * G:2 * G + 4]
    p1, p2 = torch.cat(inputs[2 * G + 4:2 * G + 6]), torch.cat(inputs[2 * G + 6:2 * G + 8])
    cfg = algo.config
    best, _ = algo.track_step(rgbs[0], depths[0], algo.predict_q(p1, p2))
    cur_img = torch.cat([rgbs[0], depths[0][..., None]], -1)
    masks = algo.model.frustum_grid_masks_dev(lie.pose_vec_to_matrix(best[:3], best[3:], rot_rep="quat"), depths[0])
    images, poses = algo.window_arrays(fine_slots, n_valid_f, cur_img, best)
    new_poses, _ = algo.map_step(images, poses, masks, n_valid_f, cfg.mapping_n_iters, cfg.mapping_lr_factor,
                                 n_kf > 4, False)
    n_real = int(n_valid_f) - 1
    if n_kf > 4:
        algo.kf_pose[fine_slots[:n_real]] = new_poses[:n_real]
        assert not torch.equal(new_poses[1:n_real], poses[1:n_real])  # the window's poses moved
    cur = new_poses[n_real]
    images, poses = algo.window_arrays(coarse_slots, n_valid_c, cur_img, cur)
    algo.map_step(images, poses, {}, n_valid_c, cfg.mapping_n_iters, cfg.mapping_lr_factor, False, True)
    if do_kf:
        algo.kf_images[n_kf] = cur_img
        algo.kf_pose[n_kf] = cur
    tail, _ = algo.track_step(rgbs[1], depths[1], algo.predict_q(cur, p1))
    for j, pose in enumerate((cur, tail)):
        want = lie_np.pose_vec_to_matrix(pose[:3].numpy(), pose[3:].numpy(), rot_rep="quat")
        np.testing.assert_array_equal(got[j], want, err_msg=f"pose of group frame {j}")
    for a, b in zip(got_state, algo._state_tensors()):
        assert torch.equal(a, b), "the state after the group differs from the per-frame steps'"


def test_group_step_matches_jax_at_zero_iterations():
    """No iterations: each pose is the prediction chained from the one
    before; the keyframe row is the head's pose."""
    pytest.importorskip("jax")
    import jax

    from xrdslam_tpu.common.frame import Frame as JFrame
    from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset
    from xrdslam_tpu.configs.registry import algorithm_configs as jreg
    from xrdslam_tpu_torch.utils.from_jax import niceslam_params_from_jax

    ds = JSyntheticDataset(n_frames=G + 3, **SIZE)
    jcfg = copy.deepcopy(jreg["nice-slam"].xrdslam.algorithm)
    tcfg = _config(n_iters=0, mapping_first_n_iters=0, tracking_n_iters=0)
    for f in ("mapping_bound", "marching_cubes_bound", "tracking_n_iters", "mapping_n_iters",
              "mapping_first_n_iters", "mapping_window_size", "tracking_sample", "mapping_sample",
              "min_sample_pixels", "tracking_Hedge", "tracking_Wedge", "max_keyframes"):
        setattr(jcfg, f, copy.deepcopy(getattr(tcfg, f)))
    jcfg.model.rendering_n_samples, jcfg.model.rendering_n_surface = 12, 6
    jalgo = jcfg.setup(camera=ds.get_camera())
    talgo = tcfg.setup(camera=SyntheticDataset(n_frames=G + 3, **SIZE).get_camera(), device="cpu")
    niceslam_params_from_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), talgo.model)
    items = [ds[i] for i in range(G + 3)]
    for a, frame_cls in ((jalgo, JFrame), (talgo, Frame)):
        a.add_keyframe(frame_cls(fid=0, rgb=items[0][1], depth=items[0][2], init_pose=items[0][3], rot_rep="quat"))
        a.set_initialized()
    prev2, prev = items[1][3], items[2][3]
    jh = jalgo.dispatch_superstep([JFrame(fid=i, rgb=rgb, depth=d) for i, rgb, d, _ in items[3:]], True, prev, prev2)
    th = talgo.dispatch_superstep([Frame(fid=i, rgb=rgb, depth=d) for i, rgb, d, _ in items[3:]], True, prev, prev2)
    want, got = np.stack(jalgo.finish_superstep(jh)), np.stack(talgo.finish_superstep(th))
    assert got.shape == (G, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got[-1, :3, 3] - prev[:3, 3]).max() > 1e-3  # the chain is not the identity
    np.testing.assert_allclose(talgo.kf_pose.numpy()[:2], np.asarray(jalgo.kf_pose)[:2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(talgo.kf_pose_host[:2], jalgo.kf_pose_host[:2], atol=1e-5, rtol=0)
    assert talgo.kf_count == jalgo.kf_count == 2


@pytest.mark.parametrize("n,map_every,keyframe_every", [(60, 5, 50), (60, 2, 10), (23, 2, 10)])
def test_pipeline_groups_as_jax(n, map_every, keyframe_every, tmp_path, monkeypatch):
    """NICE-SLAM's splits on the stub of tests/test_torch_coslam_group.py:
    the registry's (groups at 10, 15, ..., 50; keyframes at 0 and 50) and
    the protocol's (groups at 4, 6, ..., 56 on 60 frames; keyframes every
    10th frame, inside groups)."""
    pytest.importorskip("jax")
    import time

    from test_torch_coslam_group import _Clock, _run_stub

    from xrdslam_tpu.common.camera import Camera as JCamera
    from xrdslam_tpu.pipeline import slam as jslam
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.pipeline import slam as tslam

    cam = dict(fx=4.0, fy=4.0, cx=2.0, cy=2.0, height=4, width=4)
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    args = (n, map_every, keyframe_every, -1)
    want, want_times = _run_stub(jslam, JCamera(**cam), *args, tmp_path / "jax", clock)
    got, got_times = _run_stub(tslam, Camera(**cam), *args, tmp_path / "port", clock, device="cpu")
    assert got == want and got_times == want_times
    heads = [e[1][0] for e in got if e[0] == "group"]
    assert heads == list(range(max(2 * map_every, 2), n - map_every, map_every))
    if (n, map_every) == (60, 2):
        assert len(heads) == 27 and [e[1][0] for e in got if e[0] == "group" and e[2]] == [10, 20, 30, 40, 50]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_group_replay_equals_eager_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    algo, frames, gts = _algo(6, "cuda")
    algo.estimate_c2w_list = [np.asarray(g) for g in gts[:6]]
    group = frames[6:6 + G]
    key, program, inputs = algo.group_call(group, True, gts[5], gts[4])
    algo.graphs(key, program, inputs)  # the warm-up and the capture
    assert key in algo.graphs.captures
    saved = algo.save_state()
    scatter.reset_launches()
    eager = program(*inputs)
    torch.cuda.synchronize()
    eager_launches, eager_state = dict(scatter.LAUNCHES), [t.detach().clone() for t in algo._state_tensors()]
    algo.load_state(saved)
    scatter.reset_launches()
    replay = algo.graphs(key, program, inputs)
    torch.cuda.synchronize()
    assert algo.graphs.replays[key] == 1
    assert dict(scatter.LAUNCHES) == eager_launches and eager_launches["scatter_add"] > 0
    for a, b in list(zip(eager, replay)) + list(zip(eager_state, algo._state_tensors())):
        assert torch.equal(a, b)
