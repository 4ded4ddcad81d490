"""Vox-Fusion's fused per-frame step and its runs through the pipeline in the port.

On the CPU the fused program runs eagerly:

* ``dispatch_superstep`` / ``finish_superstep`` give the bits of the
  per-frame steps that the program fuses (``predict``, the voxel insertion
  at the prediction, ``track_step`` there, ``map_step`` on the window of
  the device keyframe store and the frame, the window's poses written
  back, the keyframe), from the same state and generator states, with and
  without a keyframe, with a window of all keyframes and with a random
  one;
* with no optimization iterations (so that no random draw decides the
  result) the port's step returns the JAX package's constant-velocity
  pose, inserts the same voxels at it (every table and count equal) and
  writes the same keyframe rows;
* on a stub algorithm the port's pipeline sends the JAX pipeline's frames
  through groups at the registry's settings (``map_every`` 1,
  ``keyframe_every`` 50): frames 2-58 of 60;
* the JAX package's tiny Vox-Fusion run (its ``test_voxfusion_pipeline``
  settings) through the port's CLI on the CPU: frames 2-3 through the fused
  step, ATE under that test's 6 cm, finite outputs. Without
  ``--xrdslam.device`` the run asks for CUDA, and raises where there is none.

On the card (``cuda`` marker; skipped without one) a replay of the captured
step is held against the eager step from the same state: the same bits and
the same K4 launches.
"""
import copy
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.ops import lie_np, scatter  # noqa: E402
from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate  # noqa: E402

SIZE = dict(height=32, width=48)
SMALL = dict(max_voxels=1024, num_embeddings=4096, coarse_steps=48, max_voxel_hit=5, samples_per_voxel=4)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _config(n_iters: int = 2, **over):
    cfg = copy.deepcopy(algorithm_configs["vox-fusion"].xrdslam.algorithm)
    cfg.tracking_n_iters = cfg.mapping_n_iters = n_iters
    cfg.mapping_first_n_iters = 3
    cfg.tracking_sample, cfg.mapping_sample, cfg.max_keyframes = 64, 32, 10
    for k, v in SMALL.items():
        setattr(cfg.model, k, v)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _algo(n_kf: int, device: str = "cpu"):
    """A small Vox-Fusion after its first mapping (frame 0) with ``n_kf``
    keyframes (frames 0.. at their true poses), and its sequence's frames
    and poses."""
    n = n_kf + 3
    ds = SyntheticDataset(n_frames=n, **SIZE)
    algo = _config().setup(camera=ds.get_camera(), device=device)
    frames = [Frame(fid=i, rgb=ds[i][1], depth=ds[i][2], init_pose=ds[i][3]) for i in range(n)]
    algo.do_mapping(frames[0])
    algo.set_initialized()
    for f in frames[:n_kf]:
        algo.add_keyframe(f)
    return algo, frames, [ds[i][3] for i in range(n)]


@pytest.mark.parametrize("n_kf,do_kf", [(1, True), (2, False), (6, True)])
def test_fused_step_gives_the_per_frame_bits(n_kf, do_kf):
    """1 and 2 keyframes: the window holds them all; 6: the newest and 2
    picked at random (window 5)."""
    algo, frames, gts = _algo(n_kf)
    cur = frames[n_kf]
    prev, prev2 = gts[n_kf - 1], gts[max(n_kf - 2, 0)]
    saved = algo.save_state()
    got = algo.finish_superstep(algo.dispatch_superstep([cur], do_kf, prev, prev2))
    got_state = [t.detach().clone() for t in algo._state_tensors()]
    assert algo.kf_count == n_kf + do_kf
    # the steps it fuses, from the same state and picks
    algo.load_state(saved)
    key, _, inputs = algo.group_call([cur], do_kf, prev, prev2)
    assert key == (True, do_kf)
    rgb, depth, win_slots, n_valid, t1, r1, t2, r2, kf_slot = inputs
    slots = win_slots[:int(n_valid) - 1]
    assert len(slots) == min(n_kf, 4) and int(slots[-1]) == n_kf - 1
    tp, rp = algo.predict(t1, r1, t2, r2)
    algo.insert_voxels(depth, tp, rp)
    bt, br, _ = algo.track_step(rgb, depth, tp, rp)
    cur_img = torch.cat([rgb, depth[..., None]], -1)
    cur_pose = torch.cat([bt, br])
    images, poses = algo.pad_window(torch.cat([algo.kf_images[slots], cur_img[None]]),
                                    torch.cat([algo.kf_pose[slots], cur_pose[None]]), cur_img[None], cur_pose,
                                    algo.config.mapping_window_size)
    new_poses = algo.map_step(images, poses, int(n_valid), algo.config.mapping_n_iters, True)
    algo.kf_pose[slots] = new_poses[:len(slots)]
    assert not torch.equal(new_poses[1:len(slots)], poses[1:len(slots)]) or len(slots) == 1
    mapped = new_poses[int(n_valid) - 1]
    if do_kf:
        algo.kf_images[n_kf] = cur_img
        algo.kf_pose[n_kf] = mapped
    want = lie_np.pose_vec_to_matrix(mapped[:3].numpy(), mapped[3:].numpy(), rot_rep="axis_angle")
    np.testing.assert_array_equal(got[0], want)
    for a, b in zip(got_state, algo._state_tensors()):
        assert torch.equal(a, b), "the state after the fused step differs from the per-frame steps'"
    assert int(algo.maps["n_voxels"]) > 0


def test_fused_step_matches_jax_at_zero_iterations():
    """No iterations: the pose is the prediction; the voxels inserted at it
    and the keyframe rows are the JAX package's."""
    jax = pytest.importorskip("jax")

    from xrdslam_tpu.common.frame import Frame as JFrame
    from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset
    from xrdslam_tpu.configs.registry import algorithm_configs as jreg
    from xrdslam_tpu_torch.utils.from_jax import voxfusion_params_from_jax

    n = 5
    ds = JSyntheticDataset(n_frames=n, **SIZE)
    tcfg = _config(n_iters=0, mapping_first_n_iters=0)
    jcfg = copy.deepcopy(jreg["vox-fusion"].xrdslam.algorithm)
    for f in ("tracking_n_iters", "mapping_n_iters", "mapping_first_n_iters", "tracking_sample", "mapping_sample",
              "max_keyframes"):
        setattr(jcfg, f, getattr(tcfg, f))
    for k, v in SMALL.items():
        setattr(jcfg.model, k, v)
    jalgo = jcfg.setup(camera=ds.get_camera())
    talgo = tcfg.setup(camera=SyntheticDataset(n_frames=n, **SIZE).get_camera(), device="cpu")
    voxfusion_params_from_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), talgo.model)
    items = [ds[i] for i in range(n)]
    for a, frame_cls in ((jalgo, JFrame), (talgo, Frame)):
        a.do_mapping(frame_cls(fid=0, rgb=items[0][1], depth=items[0][2], init_pose=items[0][3]))
        a.set_initialized()
        a.add_keyframe(frame_cls(fid=0, rgb=items[0][1], depth=items[0][2], init_pose=items[0][3]))
    for k, v in jalgo.maps.items():  # frame 0's voxels, inserted by each package
        np.testing.assert_array_equal(talgo.maps[k].numpy(), np.asarray(v), err_msg=k)
    prev2, prev = items[1][3], items[2][3]
    n_vox0 = int(talgo.maps["n_voxels"])
    jh = jalgo.dispatch_superstep([JFrame(fid=3, rgb=items[3][1], depth=items[3][2])], True, prev, prev2)
    th = talgo.dispatch_superstep([Frame(fid=3, rgb=items[3][1], depth=items[3][2])], True, prev, prev2)
    want, got = jalgo.finish_superstep(jh)[0], talgo.finish_superstep(th)[0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got[:3, 3] - prev[:3, 3]).max() > 1e-3  # the prediction is not the last pose
    for k, v in jalgo.maps.items():
        np.testing.assert_array_equal(talgo.maps[k].numpy(), np.asarray(v), err_msg=k)
    assert int(talgo.maps["n_voxels"]) > n_vox0 > 0  # frame 3 reaches voxels frame 0 did not
    np.testing.assert_allclose(talgo.kf_pose.numpy()[:2], np.asarray(jalgo.kf_pose)[:2], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(talgo.kf_images.numpy()[:2], np.asarray(jalgo.kf_images)[:2])
    assert talgo.kf_count == jalgo.kf_count == 2


def test_pipeline_groups_as_jax(tmp_path, monkeypatch):
    """The registry's split on the stub of tests/test_torch_coslam_group.py:
    frames 2-58 of 60 through groups, keyframe 50 inside one."""
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
    reg = algorithm_configs["vox-fusion"].xrdslam
    args = (60, reg.tracker.map_every, reg.mapper.keyframe_every, reg.tracker.lazy_start)
    want, want_times = _run_stub(jslam, JCamera(**cam), *args, tmp_path / "jax", clock)
    got, got_times = _run_stub(tslam, Camera(**cam), *args, tmp_path / "port", clock, device="cpu")
    assert got == want and got_times == want_times
    assert [e[1][0] for e in got if e[0] == "group"] == list(range(2, 59))
    assert [e[1][0] for e in got if e[0] == "group" and e[2]] == [50]


def _cli_args(tmp_path, n):
    """The JAX package's ``test_voxfusion_pipeline`` settings as CLI flags."""
    a = "--xrdslam.algorithm."
    return ["vox-fusion", "--data-type", "synthetic", "--data", f"n_frames={n},height=48,width=64",
            "--out-dir", str(tmp_path), "--xrdslam.mapper.keyframe-every", "2",
            a + "tracking-n-iters", "8", a + "mapping-n-iters", "8", a + "mapping-first-n-iters", "20",
            a + "mapping-window-size", "3", a + "mapping-sample", "192", a + "tracking-sample", "192",
            a + "ray-batch-size", "512", a + "max-keyframes", "8", a + "mesh-resolution", "32",
            a + "model.max-voxels", "4096", a + "model.num-embeddings", "8192", a + "model.coarse-steps", "48",
            a + "model.max-voxel-hit", "6", a + "model.samples-per-voxel", "4"]


def test_tiny_run_through_the_cli(tmp_path):
    """5 frames of 48x64 on the CPU: frames 2-3 through the fused step
    (eager here), finite poses, ATE under 6 cm, voxels allocated, a render
    and a mesh."""
    from xrdslam_tpu_torch.scripts.run import main

    n = 5
    runner = main(_cli_args(tmp_path, n) + ["--xrdslam.device", "cpu"])
    with open(tmp_path / "eval.tar", "rb") as f:
        data = pickle.load(f)
    est = data["estimate_c2w_list"]
    assert len(est) == n and all(np.isfinite(p).all() for p in est)
    pipe = runner.pipeline
    algo = pipe.algorithm
    assert pipe.groups == [2, 3] and sorted(algo._programs) == [(True, False), (True, True)]
    ate = evaluate_ate(data["gt_c2w_list"], est)
    assert ate["rmse"] * 100 < 6.0, f"ATE {ate['rmse'] * 100:.2f} cm"
    assert int(algo.maps["n_voxels"]) > 10
    rgb, depth = algo.render_img(est[-1])
    assert rgb.shape == (48, 64, 3) and np.isfinite(rgb).all() and np.isfinite(depth).all()
    mesh = algo.get_mesh()
    assert mesh is not None and len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all()


def test_cli_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from xrdslam_tpu_torch.scripts.run import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(_cli_args(tmp_path, 2))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_fused_replay_equals_eager_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    algo, frames, gts = _algo(2, "cuda")
    cur = frames[2]
    key, program, inputs = algo.group_call([cur], True, gts[1], gts[0])
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
    assert dict(scatter.LAUNCHES) == eager_launches and eager_launches["scatter_add"] == algo.config.mapping_n_iters
    for a, b in list(zip(eager, replay)) + list(zip(eager_state, algo._state_tensors())):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_steps_match_the_cpu():
    """From one state, the voxel insertion, a tracking call and a mapping
    call with the same pixels on the card and on the CPU: the same voxel
    tables, and poses and map within float32 rounding (1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, frames, gts = _algo(2, "cuda")
    cpu = _config().setup(camera=card.camera, device="cpu")
    with torch.no_grad():
        for dst, src in zip(cpu._state_tensors(), card._state_tensors()):
            dst.copy_(src.cpu())
    cpu.kf_count = card.kf_count
    H, W = card.camera.height, card.camera.width
    rng = np.random.default_rng(0)
    track_uv = [(rng.integers(0, W, 64), rng.integers(0, H, 64)) for _ in range(card.config.tracking_n_iters)]
    map_uv = [(rng.integers(0, W, (5, 32)), rng.integers(0, H, (5, 32))) for _ in range(card.config.mapping_n_iters)]
    t, r = lie_np.matrix_to_pose_vec(np.asarray(gts[2], np.float32), rot_rep="axis_angle")
    t0, r0 = t + np.float32(0.01), r - np.float32(0.005)
    out = []
    for algo in (card, cpu):
        dev = algo.device
        f = Frame(fid=2, rgb=frames[2].rgb, depth=frames[2].depth)
        rgb, depth = f.rgb_dev(dev), f.depth_dev(dev)
        algo.insert_voxels(depth, torch.as_tensor(t, device=dev), torch.as_tensor(r, device=dev))
        bt, br, _ = algo.track_step(rgb, depth, torch.as_tensor(t0, device=dev), torch.as_tensor(r0, device=dev),
                                    [(torch.as_tensor(u, device=dev), torch.as_tensor(v, device=dev)) for u, v in track_uv])
        img = torch.cat([rgb, depth[..., None]], -1)
        images = torch.cat([algo.kf_images[:2], img[None].expand(3, -1, -1, -1)])
        poses = torch.cat([algo.kf_pose[:2], torch.cat([bt, br])[None].expand(3, -1)])
        new_poses = algo.map_step(images, poses, 3, algo.config.mapping_n_iters, True,
                                  [(torch.as_tensor(u, device=dev), torch.as_tensor(v, device=dev)) for u, v in map_uv])
        out.append([x.detach().cpu() for x in [bt, br, new_poses] + algo._state_tensors()])
    names = ["tracked t", "tracked r", "mapped poses"] + [f"state[{i}]" for i in range(len(out[0]) - 3)]
    for name, a, b in zip(names, *out):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0, err_msg=name)
        else:
            assert torch.equal(a, b), name
