"""SplaTAM in the port against the JAX package, and its run through the CLI.

The same numpy inputs go to both packages: frames of the JAX synthetic
scene (rgb after the uint16 round trip both upload paths apply), and a map
grown by the JAX ``grow_step`` and then perturbed, carried across with
``gaussian_params_from_jax``. The JAX rasterizer runs its Pallas kernels in
interpret mode on the CPU. The table has more than 32,768 rows, so that the
JAX gradient goes through the exact fp32 scatter, as on SplaTAM's path.

Random numbers differ by design (``jax.random`` against ``torch`` and numpy
generators), so the step tests use a window of one frame (the pick is
always 0) and hand both packages the same binning.

Tolerances: losses and gradients to 1e-4 relative (sums in another order);
poses to 1e-5. A mapping step is Adam's: its first update is lr * g / |g|
per entry, so an entry whose gradient is ~0 (cancelling sums) may step
either way in the two packages. The step test holds the loss sequence and
the pruning exactly, and the parameters to 1e-5 except for such entries,
which it counts.
"""
import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.algorithms.splatam import SplaTAMConfig as JSplaTAMConfig  # noqa: E402
from xrdslam_tpu.common.frame import Frame as JFrame  # noqa: E402
from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset  # noqa: E402
from xrdslam_tpu.engine.optimizers import AdamOptimizerConfig as JAdam  # noqa: E402
from xrdslam_tpu.models import gaussian_splatting as jgs  # noqa: E402
from xrdslam_tpu.models.gaussian_splatting import GaussianSplattingConfig as JGSConfig  # noqa: E402
from xrdslam_tpu.ops import lie as jlie, lie_np as jlie_np  # noqa: E402
from xrdslam_tpu.pipeline.slam import SLAMPipeline as JSLAMPipeline  # noqa: E402
from xrdslam_tpu_torch.algorithms.splatam import SplaTAMConfig  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.engine.optimizers import AdamOptimizerConfig  # noqa: E402
from xrdslam_tpu_torch.models.gaussian_splatting import GAUSS_GROUPS, GaussianSplattingConfig, ssim  # noqa: E402
from xrdslam_tpu_torch.ops import lie  # noqa: E402
from xrdslam_tpu_torch.pipeline.slam import SLAMPipeline, TrackerConfig  # noqa: E402
from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import gaussian_params_from_jax  # noqa: E402

H, W = 32, 48
NTX, NTY = W // 16, H // 16
G = 40_000  # > 32,768 rows: the JAX scatter takes its exact fp32 branch
RH, RW = 16, 32  # the registry runs' frames: two tiles keep their ~100 iterations a frame cheap
REL = 1e-4
LRS = {"means3D": 0.0001, "rgb_colors": 0.0025, "unnorm_rotations": 0.001, "logit_opacities": 0.05,
       "log_scales": 0.001, "tracking_pose_r": 0.0004, "tracking_pose_t": 0.002}


def _optimizers(adam):
    return {k: {"optimizer": adam(lr=lr, eps=1e-15) if k in GAUSS_GROUPS else adam(lr=lr), "scheduler": None}
            for k, lr in LRS.items()}


def _config(cls, model_cls, adam):
    return cls(rot_rep="quat", tracking_n_iters=8, mapping_n_iters=3, mapping_first_n_iters=3,
               mapping_window_size=3, model=model_cls(max_gaussians=G, k_per_tile=48),
               optimizers=_optimizers(adam))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


@pytest.fixture(scope="module")
def case():
    """Both algorithms, two frames, and a perturbed map grown on frame 0."""
    ds = JSyntheticDataset(n_frames=3, height=H, width=W)
    jcam = ds.get_camera()
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    jalgo = _config(JSplaTAMConfig, JGSConfig, JAdam).setup(camera=jcam)
    algo = _config(SplaTAMConfig, GaussianSplattingConfig, AdamOptimizerConfig).setup(camera=cam, device="cpu")
    frames = []
    for i in (0, 1):
        _, rgb, depth, pose = ds[i]
        rgb = np.array(JFrame(fid=i, rgb=rgb, depth=depth).rgb_jax())  # the uint16 round trip
        frames.append(SimpleNamespace(rgb=rgb, depth=np.asarray(depth, np.float32), c2w=np.asarray(pose, np.float32)))
    f0 = frames[0]
    params, dead, count = jalgo._grow_fn_raw(jalgo.params, jalgo.dead, jnp.asarray(0, jnp.int32),
                                             jnp.asarray(f0.rgb), jnp.asarray(f0.depth), jnp.asarray(f0.c2w),
                                             first=True, ntx=NTX, nty=NTY)
    params, dead, count = _np(params), np.array(dead), int(count)
    rng = np.random.default_rng(0)
    params["logit_opacities"] = rng.normal(3.0, 1.0, params["logit_opacities"].shape).astype(np.float32)
    params["logit_opacities"][:count:97] = -8.0  # under the prune threshold
    params["log_scales"][:count:131] = 0.0  # bigger than 0.1 scene radius
    params["rgb_colors"] = np.clip(params["rgb_colors"] + rng.normal(0, 0.05, (G, 3)), 0, 1).astype(np.float32)
    for m in (jalgo.model, algo.model):
        m.scene_radius = float(f0.depth.max() / 3.0)
        m.n_gauss = count
    return SimpleNamespace(jalgo=jalgo, algo=algo, frames=frames, params=params, dead=dead, count=count)


def _torch_state(case):
    params, dead, count = gaussian_params_from_jax(case.params, "cpu", case.dead, case.count)
    return params, dead, count


def _jax_bin(case, w2c):
    tiles, mask = case.jalgo._bin_jit(case.params, case.dead, jnp.asarray(case.count, jnp.int32), jnp.asarray(w2c))
    return np.array(tiles), np.array(mask)


def test_lie_quat_and_pose_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    t = rng.standard_normal((5, 3)).astype(np.float32)
    r = (0.5 * rng.standard_normal((5, 3))).astype(np.float32)
    _close(lie.quaternion_to_matrix(torch.from_numpy(q)).numpy(), jlie.quaternion_to_matrix(q), "R(q)", 1e-6)
    for rot, rep in ((q, "quat"), (r, "axis_angle")):
        want = jlie.pose_vec_to_matrix(jnp.asarray(t), jnp.asarray(rot), rot_rep=rep)
        got = lie.pose_vec_to_matrix(torch.from_numpy(t), torch.from_numpy(rot), rot_rep=rep)
        _close(got.numpy(), want, f"pose ({rep})", 1e-6)
        _close(lie.pose_inverse(got).numpy(), jlie.pose_inverse(want), f"inverse ({rep})", 1e-6)
    # the quaternion round trip of a Frame's pose, as the reference's
    c2w = np.asarray(jlie_np.pose_vec_to_matrix(t[0], q[0] / np.linalg.norm(q[0]), rot_rep="quat"))
    f, jf = Frame(0, None, None, init_pose=c2w, rot_rep="quat"), JFrame(0, None, None, init_pose=c2w, rot_rep="quat")
    np.testing.assert_array_equal(f.r, jf.r)
    np.testing.assert_array_equal(f.get_pose(), jf.get_pose())


def test_relative_pose_transform_matches_jax():
    rng = np.random.default_rng(1)
    poses = [np.asarray(jlie_np.se3_exp(0.3 * rng.standard_normal(6)), np.float32) for _ in range(3)]
    tracker = dict(use_relative_pose=True, init_pose_offset=0.5)
    mine = SimpleNamespace(config=SimpleNamespace(tracker=TrackerConfig(**tracker)))
    ref = SimpleNamespace(config=SimpleNamespace(tracker=SimpleNamespace(**tracker)))
    for i, p in enumerate(poses):
        got, want = SLAMPipeline._gt_transform(mine, i, p), JSLAMPipeline._gt_transform(ref, i, p)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_project_render_and_losses_match_jax(case):
    f = case.frames[1]
    w2c = np.linalg.inv(f.c2w).astype(np.float32)
    tiles, mask = _jax_bin(case, w2c)
    jm, m = case.jalgo.model, case.algo.model
    jp = jax.tree_util.tree_map(jnp.asarray, case.params)
    params, dead, count = _torch_state(case)
    jalive = jm.alive_mask(jnp.asarray(case.dead), case.count)
    alive = m.alive_mask(dead, count)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    for a, b, name in zip(m.project(params, torch.from_numpy(w2c)), jm.project(jp, jnp.asarray(w2c)),
                          ("u", "v", "depth", "sigma")):
        _close(a.numpy(), b, name, 1e-6)
    rgb, depth = torch.from_numpy(f.rgb), torch.from_numpy(f.depth)
    for is_mapping in (False, True):
        def jloss(p):
            out = jm.render(p, jalive, jnp.asarray(w2c), (jnp.asarray(tiles), jnp.asarray(mask)), NTX, NTY)
            return jm.get_loss(out, jnp.asarray(f.rgb), jnp.asarray(f.depth), is_mapping), out

        (want, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
        tp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = m.render(tp, alive, torch.from_numpy(w2c), (torch.from_numpy(tiles), torch.from_numpy(mask)), NTX, NTY)
        loss = m.get_loss(out, rgb, depth, is_mapping)
        for k in out:
            _close(out[k].detach().numpy(), jout[k], k)
        _close(loss.item(), float(want), f"loss (mapping={is_mapping})")
        grads = torch.autograd.grad(loss, [tp[k] for k in ("means3D", "rgb_colors", "logit_opacities", "log_scales")])
        for g, k in zip(grads, ("means3D", "rgb_colors", "logit_opacities", "log_scales")):
            _close(g.numpy(), jgrads[k], f"d loss / d {k} (mapping={is_mapping})")
    a, b = np.random.default_rng(2).uniform(size=(2, H, W, 3)).astype(np.float32)
    _close(ssim(torch.from_numpy(a), torch.from_numpy(b), m.ssim_window).item(), float(jgs.ssim(a, b)), "ssim", 1e-6)


def test_track_step_matches_jax(case):
    f = case.frames[0]  # the frame the map was grown from, seen from a shifted pose
    t_gt, q_gt = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="quat")
    t0 = (t_gt + np.array([0.02, -0.015, 0.01])).astype(np.float32)
    q0 = q_gt.astype(np.float32)
    w2c0 = np.linalg.inv(jlie_np.pose_vec_to_matrix(t0, q0, rot_rep="quat")).astype(np.float32)
    tiles, mask = _jax_bin(case, w2c0)
    jfn = jax.jit(functools.partial(case.jalgo._track_step_raw, ntx=NTX, nty=NTY))
    bt_j, bq_j, loss_j = jfn(case.params, case.dead, jnp.asarray(case.count, jnp.int32), jnp.asarray(f.rgb),
                             jnp.asarray(f.depth), jnp.asarray(t0), jnp.asarray(q0), tiles, mask,
                             jax.random.PRNGKey(0))
    params, dead, count = _torch_state(case)
    bt, bq, loss = case.algo.track_step(params, dead, count, torch.from_numpy(f.rgb), torch.from_numpy(f.depth),
                                        torch.from_numpy(t0), torch.from_numpy(q0), torch.from_numpy(tiles),
                                        torch.from_numpy(mask))
    _close(loss.item(), float(loss_j), "best loss")
    assert np.abs(np.asarray(bt_j) - t_gt).sum() < np.abs(t0 - t_gt).sum()  # tracking moved toward the truth
    np.testing.assert_allclose(bt.numpy(), np.asarray(bt_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bq.numpy(), np.asarray(bq_j), atol=1e-5, rtol=0)


def test_map_step_matches_jax(case):
    f = case.frames[1]
    w2c = np.linalg.inv(f.c2w).astype(np.float32)
    tiles, mask = _jax_bin(case, w2c)
    image = np.concatenate([f.rgb, f.depth[..., None]], -1)[None]
    n_iters = case.jalgo.config.mapping_n_iters
    jfn = jax.jit(functools.partial(case.jalgo._map_step_raw, n_iters=n_iters, ntx=NTX, nty=NTY, densify=False))
    jp, jdead, jcount, jlosses = jfn(case.params, case.dead, jnp.asarray(case.count, jnp.int32), jnp.asarray(image),
                                     jnp.asarray(w2c)[None], tiles[None], mask[None], jnp.asarray(1, jnp.int32),
                                     jax.random.PRNGKey(0))
    params, dead, count = _torch_state(case)
    gp, dead, count, losses = case.algo.map_step(params, dead, count, torch.from_numpy(image),
                                                 torch.from_numpy(w2c)[None], torch.from_numpy(tiles)[None],
                                                 torch.from_numpy(mask)[None], 1, n_iters)
    _close(losses.numpy(), jlosses, "losses")
    assert count == int(jcount)
    jdead = np.asarray(jdead)
    assert jdead[: case.count].sum() > case.dead[: case.count].sum()  # the prune at it = 0 removed rows
    np.testing.assert_array_equal(dead.numpy(), jdead)
    frozen = (np.arange(G) >= case.count) | case.dead  # dead or unallocated before the call
    for k in GAUSS_GROUPS:
        got, want = gp[k].numpy(), np.asarray(jp[k])
        off = np.abs(got - want) > 1e-5
        # an entry off by more is one whose ~0 gradient Adam stepped the other way
        assert off.mean() < 1e-3 and np.abs(got - want).max() <= 2 * n_iters * LRS[k] + 1e-5, k
        np.testing.assert_array_equal(got[frozen], case.params[k][frozen], err_msg=k)


@pytest.mark.parametrize("first", [True, False])
def test_grow_step_matches_jax(case, first):
    f = case.frames[1]
    if first:
        jstate = (case.jalgo.params, case.jalgo.dead, 0)
        params, dead = case.algo.model.init_params(), torch.zeros(G, dtype=torch.bool)
        count = 0
    else:
        jstate = (case.params, case.dead, case.count)
        params, dead, count = _torch_state(case)
    jp, jdead, jcount = case.jalgo._grow_fn_raw(*jax.tree_util.tree_map(jnp.asarray, jstate[:2]),
                                                jnp.asarray(jstate[2], jnp.int32),
                                                jnp.asarray(f.rgb), jnp.asarray(f.depth), jnp.asarray(f.c2w),
                                                first=first, ntx=NTX, nty=NTY)
    params, dead, new = case.algo.grow_step(params, dead, count, torch.from_numpy(f.rgb), torch.from_numpy(f.depth),
                                            torch.from_numpy(f.c2w), first)
    assert new == int(jcount) and new > count
    np.testing.assert_array_equal(dead.numpy(), np.asarray(jdead))
    for k in GAUSS_GROUPS:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), atol=1e-5, rtol=1e-6, err_msg=k)


def test_registry_slots_leave_a_fresh_map_mostly_uncovered_as_in_jax():
    """The cause of the registry run's drift, in both packages: a tile keeps
    the ``k_per_tile`` nearest of the gaussians whose binning box (3 sigma
    plus 8 px) overlaps it - up to 38 x 38 of them for one ~1 px gaussian per
    pixel. At the registry's 256, the map grown from a frame renders that
    frame with most silhouettes below growth's 0.5, and none above
    tracking's 0.99; with every candidate kept it covers the frame."""
    ds = JSyntheticDataset(n_frames=1, height=H, width=W, scene="office")
    jcam = ds.get_camera()
    _, rgb, depth, pose = ds[0]
    rgb = np.array(JFrame(fid=0, rgb=rgb, depth=depth).rgb_jax())
    valid = depth > 0
    mean_sil = {}
    for k in (256, 2048):
        jalgo = _config(JSplaTAMConfig, JGSConfig, JAdam).setup(camera=jcam)
        jalgo.config.model.k_per_tile = k
        jalgo._build_jits()
        params, dead, count = jalgo._grow_fn_raw(jalgo.params, jalgo.dead, jnp.asarray(0, jnp.int32), jnp.asarray(rgb),
                                                 jnp.asarray(depth), jnp.asarray(pose), first=True, ntx=NTX, nty=NTY)
        w2c = jnp.asarray(np.linalg.inv(pose), jnp.float32)
        tiles, mask = jalgo._bin_jit(params, dead, count, w2c)
        jsil = np.asarray(jalgo.model.render(params, jalgo.model.alive_mask(dead, count), w2c, (tiles, mask), NTX,
                                             NTY)["sil"])
        tp, tdead, tcount = gaussian_params_from_jax(_np(params), "cpu", np.array(dead), int(count))
        cam = Camera(**{a: getattr(jcam, a) for a in ("fx", "fy", "cx", "cy", "height", "width")})
        cfg = _config(SplaTAMConfig, GaussianSplattingConfig, AdamOptimizerConfig)
        cfg.model.k_per_tile = k
        algo = cfg.setup(camera=cam, device="cpu")
        tw2c = torch.from_numpy(np.array(w2c))
        alive = algo.model.alive_mask(tdead, tcount)
        sil = algo.model.render(tp, alive, tw2c, (torch.from_numpy(np.array(tiles)), torch.from_numpy(np.array(mask))),
                                NTX, NTY)["sil"]
        np.testing.assert_allclose(sil.numpy(), jsil, atol=1e-5, rtol=0)
        # the port's own binning: the nearest slots may differ where depths
        # differ in the last bit, the coverage does not
        sil = algo.model.render(tp, alive, tw2c, algo.binning(tp, tdead, tcount, tw2c), NTX, NTY)["sil"].numpy()
        mean_sil[k] = (float(jsil[valid].mean()), float(sil[valid].mean()))
        for s in (jsil, sil):
            if k == 256:
                assert np.mean(s[valid] < 0.5) > 0.5 and not (s[valid] > 0.99).any(), mean_sil
            else:
                assert bool(np.asarray(mask).sum(1).max() < k), "a tile dropped candidates"
    for s in range(2):
        assert mean_sil[256][s] < 0.5 < 0.9 < mean_sil[2048][s], mean_sil


@pytest.fixture(scope="module")
def jax_registry_run(tmp_path_factory):
    """The registry's SplaTAM on five 16x32 frames of the office in the JAX
    package's per-frame path (the fused super-step off), with the map and
    the predicted pose recorded at each tracked frame.

    The settings are the registry's but for a table of 8192 rows (the run
    grows fewer) and a window of 3 (it holds every keyframe of the run), so
    the run computes what the registry's would. The last frame's mapping,
    which no tracked frame sees, is skipped."""
    from xrdslam_tpu.configs.registry import algorithm_configs as jconfigs

    n = 5
    ds = JSyntheticDataset(n_frames=n, height=RH, width=RW, scene="office")
    jcfg = copy.deepcopy(jconfigs["splaTAM"].xrdslam)
    jcfg.algorithm.model.max_gaussians = 8192
    jcfg.algorithm.mapping_window_size = 3
    jcfg.tracker.save_re_render_result = False
    jpipe = jcfg.setup(dataset=ds, out_dir=str(tmp_path_factory.mktemp("jax_registry")), verbose=False)
    jalgo = jpipe.algorithm
    tracked = {}  # fid -> (frame, prediction, map state, tracked pose)
    dispatch, finish, do_mapping = jalgo.dispatch_tracking, jalgo.finish_tracking, jalgo.do_mapping

    def record_dispatch(frame):
        state = (_np(jalgo.params), np.array(jalgo.dead), jalgo.model.n_gauss, jalgo.model.scene_radius)
        tracked[frame.fid] = (frame, frame.get_pose(), state)
        return dispatch(frame)

    def record_finish(handle):
        c2w = finish(handle)
        if c2w is not None:
            fid = max(tracked)
            tracked[fid] = (*tracked[fid], c2w)
        return c2w

    def map_unless_last(frame):
        if frame.fid < n - 1:
            do_mapping(frame)

    jalgo.dispatch_tracking, jalgo.finish_tracking, jalgo.do_mapping = record_dispatch, record_finish, map_unless_last
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XRDSLAM_DISABLE_SUPER", "1")
        jpipe.run()
    gt, est = np.stack(jalgo.gt_c2w_list), np.stack(jalgo.estimate_c2w_list)
    return SimpleNamespace(
        dataset=ds, camera=ds.get_camera(), cut={"max_gaussians": 8192, "mapping_window_size": 3},
        n_gauss=jalgo.model.n_gauss, est=est,
        tracked={fid: rec for fid, rec in tracked.items() if len(rec) == 4},
        err=np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1),
        travelled=np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=-1))


def _first_frames(dataset, n, camera):
    """The first ``n`` frames of ``dataset``, seen through ``camera``."""
    return type("Frames", (), {"__len__": lambda self: n, "__getitem__": lambda self, i: dataset[i],
                               "get_camera": lambda self: camera})()


def test_registry_settings_drift_in_jax(jax_registry_run):
    """The JAX package's per-frame path drifts at the registry's settings:
    every tracked pose ends farther from the truth than the first pose is,
    so tracking does worse than not moving at all."""
    run = jax_registry_run
    assert sorted(run.tracked) == [1, 2, 3, 4] and run.n_gauss < 8192
    assert (run.err[1:] > run.travelled[1:]).all(), (run.err, run.travelled)


def test_jax_superstep_drifts_as_its_per_frame_path_does(jax_registry_run, tmp_path):
    """The JAX package's default path, the fused super-step, on the first
    four frames of that run (the fewest that hold a super-step group: frame
    2): it computes frame 2's pose as the per-frame path does, so it drifts
    alike."""
    from xrdslam_tpu.configs.registry import algorithm_configs as jconfigs

    run = jax_registry_run
    n = 4
    jcfg = copy.deepcopy(jconfigs["splaTAM"].xrdslam)
    jcfg.algorithm.model.max_gaussians = run.cut["max_gaussians"]
    jcfg.algorithm.mapping_window_size = run.cut["mapping_window_size"]
    jcfg.tracker.save_re_render_result = False
    jpipe = jcfg.setup(dataset=_first_frames(run.dataset, n, run.camera), out_dir=str(tmp_path), verbose=False)
    jalgo = jpipe.algorithm
    groups = []
    superstep = jalgo.dispatch_superstep

    def record_superstep(group, *args, **kwargs):
        groups.append([f.fid for f in group])
        return superstep(group, *args, **kwargs)

    jalgo.dispatch_superstep = record_superstep
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("XRDSLAM_DISABLE_SUPER", raising=False)
        jpipe.run(stop_at=3)  # frame 3 only closes the group
    assert groups == [[2]]
    est = np.stack(jalgo.estimate_c2w_list)
    np.testing.assert_allclose(est[2], run.est[2], atol=1e-4, rtol=0)
    assert np.linalg.norm(est[2, :3, 3] - jalgo.gt_c2w_list[2][:3, 3]) > run.travelled[2]


@pytest.mark.parametrize("fid", [1, 2, 3, 4])
def test_port_tracks_the_jax_registry_run_alike(jax_registry_run, fid):
    """Handed the map and the predicted pose of a tracked frame of that run,
    the port's tracking (its own binning included) lands within 1 mm of the
    JAX package's pose: the port drifts as the reference does."""
    run = jax_registry_run
    jframe, init, (params, dead, count, radius), want = run.tracked[fid]
    cfg = copy.deepcopy(algorithm_configs["splaTAM"].xrdslam.algorithm)
    cfg.model.max_gaussians = run.cut["max_gaussians"]
    cfg.mapping_window_size = run.cut["mapping_window_size"]
    cam = Camera(**{k: getattr(run.camera, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    algo = cfg.setup(camera=cam, device="cpu")
    algo.set_initialized()
    algo.params, algo.dead, algo.model.n_gauss = gaussian_params_from_jax(params, "cpu", dead, count)
    algo.model.scene_radius = radius
    frame = Frame(fid=fid, rgb=jframe.rgb, depth=jframe.depth, init_pose=init, rot_rep="quat")
    got = algo.finish_tracking(algo.dispatch_tracking(frame))
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=1e-3, rtol=0)


def test_port_registry_run_drifts_as_the_jax_run_does(jax_registry_run, tmp_path):
    """The port's own pipeline on the first three frames of that run, at the
    same settings: it drifts too (every tracked pose ends farther from the
    truth than the first pose is), and its frame 1, whose map comes from a
    window of one frame (no random pick), lands within 3 mm of the JAX
    package's. Later frames differ by the mapping window's random picks."""
    run = jax_registry_run
    n = 3
    cam = Camera(**{k: getattr(run.camera, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    cfg = copy.deepcopy(algorithm_configs["splaTAM"].xrdslam)
    cfg.device = "cpu"
    cfg.algorithm.model.max_gaussians = run.cut["max_gaussians"]
    cfg.algorithm.mapping_window_size = run.cut["mapping_window_size"]
    cfg.tracker.save_re_render_result = False  # as the JAX run's
    pipe = cfg.setup(dataset=_first_frames(run.dataset, n, cam), out_dir=str(tmp_path), verbose=False)
    algo = pipe.algorithm
    do_mapping = algo.do_mapping
    algo.do_mapping = lambda frame: do_mapping(frame) if frame.fid < n - 1 else None  # no tracked frame sees it
    pipe.run()
    gt, est = np.stack(algo.gt_c2w_list), np.stack(algo.estimate_c2w_list)
    assert np.isfinite(est).all()
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    assert (err[1:] > run.travelled[1:n]).all(), (err, run.travelled[:n])
    np.testing.assert_allclose(est[1], run.tracked[1][3], atol=3e-3, rtol=0)


def test_the_smoke_gate_cannot_see_a_camera_that_never_moves():
    """Why the JAX package's SplaTAM smoke (tests/test_e2e_algorithms.py:
    48x64, 48 slots per tile, six frames, ATE < 6 cm) passes with fewer
    slots than the registry's: its gate cannot tell tracking from none. Its
    camera travels 2.2 cm in six frames, so a pose that never leaves the
    first frame's scores ATE well under 6 cm after Horn alignment. The
    registry run's 20 frames at 600x340 drift by metres, which its 10 cm
    gate does see."""
    from xrdslam_tpu.utils.eval_ate import evaluate_ate as jevaluate_ate

    ds = JSyntheticDataset(n_frames=6, height=48, width=64)
    first = np.linalg.inv(ds[0][3])
    gt = [first @ ds[i][3] for i in range(len(ds))]  # relative poses, as the smoke's pipeline keeps them
    travelled = np.linalg.norm(gt[-1][:3, 3] - gt[0][:3, 3])
    ate = jevaluate_ate(gt, [gt[0]] * len(gt))["rmse"]
    assert 0.02 < travelled < 0.03 and ate < 0.01, (travelled, ate)


def test_tiny_splatam_run_through_the_cli(tmp_path):
    from xrdslam_tpu_torch.scripts.run import main

    assert algorithm_configs["splaTAM"].xrdslam.device == "cuda"
    n = 6
    runner = main([
        "splaTAM", "--data-type", "synthetic", "--data", f"n_frames={n},height=48,width=64,scene=simple",
        "--out-dir", str(tmp_path), "--xrdslam.device", "cpu",
        "--xrdslam.algorithm.model.max-gaussians", "8192", "--xrdslam.algorithm.model.k-per-tile", "48",
        # the JAX package's SplaTAM smoke settings (tests/test_e2e_algorithms.py)
        "--xrdslam.algorithm.tracking-n-iters", "6", "--xrdslam.algorithm.mapping-n-iters", "10",
        "--xrdslam.algorithm.mapping-first-n-iters", "15", "--xrdslam.algorithm.mapping-window-size", "3",
        "--xrdslam.mapper.keyframe-every", "2",
    ])
    algo = runner.pipeline.algorithm
    assert len(algo.estimate_c2w_list) == n and all(np.isfinite(p).all() for p in algo.estimate_c2w_list)
    ate = evaluate_ate(algo.gt_c2w_list, algo.estimate_c2w_list)["rmse"] * 100
    assert ate < 6.0, f"ATE {ate:.2f} cm"
    assert algo.n_gauss > 100 and algo.keyframe_fids == [0, 2, 4]
    rgb, depth = algo.render_img(algo.estimate_c2w_list[-1])
    assert rgb.shape == (48, 64, 3) and depth.shape == (48, 64) and np.isfinite(rgb).all()
    means, colors = algo.get_cloud(None, None)
    assert means.shape == colors.shape == (algo.n_gauss, 3)
