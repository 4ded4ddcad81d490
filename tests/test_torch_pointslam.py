"""Point-SLAM in the port against the JAX package, and its run through the CLI.

The same numpy inputs go to both packages: frames of the JAX synthetic
scene, the JAX model's initial parameters carried across with
``pointslam_params_from_jax``, a map grown from two frames with the same
pixel picks, and the pixel samples the JAX steps draw from their keys (the
port's steps take them pre-drawn). The JAX kNN gathers its rows with
``jnp.take`` on the CPU; ``tests/test_torch_point_table.py`` holds the
port's gather to the Pallas kernel itself.

Tolerances: losses and gradients to 1e-4 relative (sums in another order);
poses to 1e-5. A mapping step is Adam's: an entry's first update is
lr * g / |g|, whatever |g|, so an entry whose gradient is ~0 when it first
moves (cancelling sums) may step either way in the two packages. The step
test holds the losses to 1e-4, and every parameter entry to 1e-5 except
those whose first nonzero gradient was below 1e-3 of its leaf's largest in
that iteration, which it counts.
"""
import copy
import dataclasses
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import xrdslam_tpu.algorithms.point_slam as jps_module  # noqa: E402
from xrdslam_tpu.algorithms.point_slam import PointSLAMConfig as JPointSLAMConfig  # noqa: E402
from xrdslam_tpu.common.frame import Frame as JFrame  # noqa: E402
from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset  # noqa: E402
from xrdslam_tpu.configs.registry import algorithm_configs as jalgorithm_configs  # noqa: E402
from xrdslam_tpu.engine.optimizers import AdamOptimizerConfig as JAdam  # noqa: E402
from xrdslam_tpu.engine.schedulers import PointSLAMSchedulerConfig as JSched  # noqa: E402
from xrdslam_tpu.models.conv_onet_pointslam import ConvOnet2Config as JConvOnet2Config  # noqa: E402
from xrdslam_tpu.ops import lie as jlie, lie_np as jlie_np, sampling as jsamp  # noqa: E402
from xrdslam_tpu_torch.algorithms.point_slam import PointSLAMConfig  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.configs.base import PrintableConfig  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.engine.optimizers import AdamOptimizerConfig  # noqa: E402
from xrdslam_tpu_torch.engine.schedulers import PointSLAMSchedulerConfig  # noqa: E402
from xrdslam_tpu_torch.models.conv_onet import masked_median  # noqa: E402
from xrdslam_tpu_torch.models.conv_onet_pointslam import ConvOnet2Config  # noqa: E402
from xrdslam_tpu_torch.ops import lie  # noqa: E402
from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import pointslam_params_from_jax  # noqa: E402

H, W = 24, 32
REL = 1e-4
N_GRAD = 16  # extra mapping and insertion pixels at the top colour gradients
LRS = {"decoder": (0.001, 0.005), "geometry": (0.03, 0.005), "color": (0.0, 0.005)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _config(cls, model_cls, adam, sched, n_grad=0, **model_kw):
    opts = {g: {"optimizer": adam(), "scheduler": sched(start_lr=a, end_lr=b)} for g, (a, b) in LRS.items()}
    opts["tracking_pose"] = {"optimizer": adam(lr=2e-3), "scheduler": None}
    return cls(rot_rep="quat", tracking_n_iters=3, mapping_n_iters=5, mapping_first_n_iters=5,
               mapping_window_size=3, tracking_sample=64, mapping_sample=96, min_sample_pixels=8,
               tracking_Wedge=4, tracking_Hedge=4, pixels_adding=300, max_keyframes=4,
               mapping_pixels_based_on_color_grad=n_grad, model=model_cls(max_points=8192, **model_kw),
               optimizers=opts)


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


def _jax_pick(jalgo, depth, n):
    """The pixel pick the JAX ``add_points_from_frame`` is about to draw."""
    seed = int(jax.random.split(jalgo._key)[1][0])
    n_valid = int((depth > 0).sum())
    return np.random.default_rng(seed).integers(0, n_valid, min(n, n_valid))


def _flat_jax(params):
    """The JAX parameters as numpy arrays in the order of the port's
    ``param_groups`` (linear weights transposed)."""
    def dec(d):
        out = [d["B"]]
        for w, b in zip(d["pts_w"], d["pts_b"]):
            out += [np.asarray(w).T, b]
        for w, b in zip(d["fc_w"], d["fc_b"]):
            out += [np.asarray(w).T, b]
        return out + [np.asarray(d["out_w"]).T, d["out_b"]]

    c = params["color"]
    geo = dec(params["decoder"]["geo"]) if "geo" in params["decoder"] else []  # not when loaded and fixed
    leaves = (geo + dec(params["decoder"]["col"]) + [params["geometry"]["feats"]]
              + [c["feats"], c["relpos_B"], np.asarray(c["nb_w1"]).T, c["nb_b1"], np.asarray(c["nb_w2"]).T, c["nb_b2"]])
    return [np.asarray(a) for a in leaves]


def _flat_port(model):
    return [p for ps in model.param_groups().values() for p in ps]


@pytest.fixture(scope="module")
def case():
    return make_case()


def make_case(**model_kw):
    """Both algorithms with the same initial model (``model_kw`` added to
    its settings), and a map grown in both from frames 0 and 1 at their
    true poses with the same pixel picks."""
    ds = JSyntheticDataset(n_frames=2, height=H, width=W)
    jcam = ds.get_camera()
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    jalgo = _config(JPointSLAMConfig, JConvOnet2Config, JAdam, JSched, **model_kw).setup(camera=jcam)
    algo = _config(PointSLAMConfig, ConvOnet2Config, AdamOptimizerConfig, PointSLAMSchedulerConfig,
                   **model_kw).setup(camera=cam, device="cpu")
    np_frozen = jax.tree_util.tree_map(np.asarray, jalgo.model.frozen)
    pointslam_params_from_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), algo.model, np_frozen)
    frames = []
    for i in (0, 1):
        _, rgb, depth, pose = ds[i]
        rgb, depth, pose = np.asarray(rgb, np.float32), np.asarray(depth, np.float32), np.asarray(pose, np.float32)
        jf = JFrame(fid=i, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
        tf = Frame(fid=i, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
        pick = _jax_pick(jalgo, depth, jalgo.config.pixels_adding)
        jalgo.add_points_from_frame(jf, jalgo.config.pixels_adding)
        algo.add_points_from_frame(tf, algo.config.pixels_adding, pick=pick)
        frames.append(SimpleNamespace(rgb=rgb, depth=depth, c2w=pose, jf=jf, tf=tf, pick=pick))
    return SimpleNamespace(jalgo=jalgo, algo=algo, frames=frames, cam=cam)


def test_insertion_and_dynamic_radii_match_jax(case):
    jm, tm = case.jalgo.point_map, case.algo.point_map
    assert tm.n_points == jm.n_points > 300  # both frames added points
    for name in ("cell_keys", "cell_count", "cell_list", "pos"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(tm.cell_data.view(np.int32), jm.cell_data.view(np.int32))
    np.testing.assert_array_equal(case.algo.maps["cell_data"].view(torch.int32).numpy(), jm.cell_data.view(np.int32))
    for got, want in zip(case.algo.cal_dynamic_radius(case.frames[1].rgb),
                         case.jalgo.cal_dynamic_radius(case.frames[1].rgb)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(case.algo._frame_rgbdr(case.frames[1].tf).numpy(),
                                  np.asarray(case.jalgo._frame_rgbdr(case.frames[1].jf)))


def test_colour_gradient_pixels_match_jax(case, monkeypatch):
    """The top colour-gradient pixels of a frame, and the points that
    insertion adds at them alone (no random pick) to an empty map."""
    jalgo, algo, f = case.jalgo, case.algo, case.frames[1]
    for got, want in zip(algo._top_grad_pixels(f.rgb, N_GRAD), jalgo._top_grad_pixels(f.rgb, N_GRAD)):
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(jalgo, "_key", jalgo._key)  # the shared algorithms are restored afterwards
    for a in (jalgo, algo):
        monkeypatch.setattr(a.config, "mapping_pixels_based_on_color_grad", N_GRAD)
        monkeypatch.setattr(a, "point_map", type(a.point_map)(max_points=a.config.model.max_points,
                                                              cell_size=a.point_map.cell_size))
        # the port writes an insertion into its device map in place: an empty one of its own here
        monkeypatch.setattr(a, "maps", a.maps if a is jalgo else a.point_map.device_state("cpu"))
    jalgo.add_points_from_frame(f.jf, 0)
    algo.add_points_from_frame(f.tf, 0)
    jm, tm = jalgo.point_map, algo.point_map
    assert tm.n_points == jm.n_points > 0 and tm.n_points % 3 == 0
    for name in ("cell_keys", "cell_count", "cell_list", "pos"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(algo.maps["cell_data"].view(torch.int32).numpy(), jm.cell_data.view(np.int32))


def test_masked_median_is_the_upper_one():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0, 9.0])
    assert masked_median(x, torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])).item() == 3.0
    assert masked_median(x, torch.zeros(5)).item() == 0.0


@pytest.fixture(scope="module")
def rays(case):
    """Rays of random pixels of frame 1 (some without depth) with the
    frame's rgb, depth and dynamic query radius: camera-frame directions,
    the pixels, the world rays at the frame's pose and a perturbed pose
    vector for tracking; and the JAX package's losses and gradients on them
    (both mapping stages, and tracking against the pose), from one jit."""
    f = case.frames[1]
    rng = np.random.default_rng(1)
    u, v = rng.integers(0, W, 80), rng.integers(0, H, 80)
    px = np.asarray(case.jalgo._frame_rgbdr(f.jf))[v, u].copy()
    px[::11, 3] = 0.0  # no depth
    dirs = np.asarray(jsamp.camera_ray_dirs(case.jalgo.camera))[v, u]
    rd = (dirs @ f.c2w[:3, :3].T).astype(np.float32)
    ro = np.broadcast_to(f.c2w[:3, 3], rd.shape).astype(np.float32)
    t_gt, q_gt = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="quat")
    pose0 = np.concatenate([t_gt + np.array([0.01, -0.02, 0.015]), q_gt + np.array([0.0, 0.01, -0.01, 0.0])])
    pose0 = pose0.astype(np.float32)
    jm, maps = case.jalgo.model, case.jalgo.maps
    ts, td, rq = jnp.asarray(px[:, :3]), jnp.asarray(px[:, 3:4]), jnp.asarray(px[:, 4])

    def map_loss(p, stage):
        return jm.get_loss(p, maps, jax.random.PRNGKey(0), jnp.asarray(ro), jnp.asarray(rd), ts, td, True, stage,
                           r_query=rq)[0]

    def track_loss(p, pose):
        rays_d = jnp.asarray(dirs) @ jlie.quaternion_to_matrix(pose[3:]).T
        rays_o = jnp.broadcast_to(pose[:3], rays_d.shape)
        return jm.get_loss(p, maps, jax.random.PRNGKey(0), rays_o, rays_d, ts, td, False, "color", r_query=rq)[0]

    # an exposure MLP in the JAX layout (w1 [8, 128], w2 [128, 12], as its
    # init draws them), a latent, and weights of a sum of the colours
    ep = {"w1": rng.normal(size=(8, 128)) * 0.01, "b1": rng.normal(size=(128,)) * 0.01,
          "w2": rng.normal(size=(128, 12)) * 0.01, "b2": rng.normal(size=(12,)) * 0.01}
    ep = {k: v.astype(np.float32) for k, v in ep.items()}
    latent = rng.normal(size=(8,)).astype(np.float32)
    w = rng.normal(size=(px.shape[0], 3)).astype(np.float32)

    def exposure_sum(p, ep, lat):
        rgb = jm.render_rays({**p, "exposure": ep}, maps, jax.random.PRNGKey(0), jnp.asarray(ro), jnp.asarray(rd), td,
                             "color", r_query=rq, exposure_feat=lat)["rgb"]
        return jnp.sum(rgb * w), rgb

    def all_losses(p, pose, ep, lat):
        return {"geometry": jax.value_and_grad(map_loss)(p, "geometry"),
                "color": jax.value_and_grad(map_loss)(p, "color"),
                "tracking": jax.value_and_grad(track_loss, argnums=1)(p, pose),
                "exposure": jax.value_and_grad(exposure_sum, argnums=(1, 2), has_aux=True)(p, ep, lat)}

    out = jax.jit(all_losses)(case.jalgo.model_params, jnp.asarray(pose0), ep, jnp.asarray(latent))
    return SimpleNamespace(dirs=dirs, px=px, ro=ro, rd=rd, pose0=pose0, exposure=(ep, latent, w),
                           jax=jax.tree_util.tree_map(np.asarray, out))


@pytest.mark.parametrize("stage", ["geometry", "color"])
def test_mapping_loss_and_map_grads_match_jax(case, rays, stage):
    loss_j, g_j = rays.jax[stage]
    px = rays.px
    tm = case.algo.model
    loss, _ = tm.get_loss(case.algo.maps, torch.from_numpy(rays.ro), torch.from_numpy(rays.rd),
                          torch.from_numpy(px[:, :3]), torch.from_numpy(px[:, 3:4]), True, stage,
                          r_query=torch.from_numpy(px[:, 4]))
    flat = _flat_port(tm)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    _close(loss.item(), float(loss_j), "loss")
    g_j = _flat_jax(g_j)
    assert len(grads) == len(g_j)
    for i, (g, want) in enumerate(zip(grads, g_j)):
        got = np.zeros_like(want) if g is None else g.numpy()
        _close(got, want, f"grad {i}")
    assert np.abs(g_j[46]).max() > 0  # the geometry table
    assert (np.abs(g_j[47]).max() > 0) == (stage == "color")  # the colour table


def test_tracking_loss_and_pose_grad_match_jax(case, rays):
    loss_j, g_j = rays.jax["tracking"]
    px = rays.px
    pose = torch.from_numpy(rays.pose0).requires_grad_(True)
    rays_d = torch.from_numpy(rays.dirs) @ lie.quaternion_to_matrix(pose[3:]).T
    loss, _ = case.algo.model.get_loss(case.algo.maps, pose[:3].expand(rays_d.shape), rays_d,
                                       torch.from_numpy(px[:, :3]), torch.from_numpy(px[:, 3:4]), False, "color",
                                       r_query=torch.from_numpy(px[:, 4]))
    (g,) = torch.autograd.grad(loss, [pose])
    _close(loss.item(), float(loss_j), "loss")
    _close(g.numpy(), g_j, "pose grad")
    assert np.abs(g_j).max() > 0


def _track_samples(jalgo, key):
    """The pixels the JAX ``track_step`` draws from ``key``."""
    c = jalgo.config
    out = []
    for k in jax.random.split(key, c.tracking_n_iters):
        k1, _ = jax.random.split(k)
        u, v = jsamp.sample_pixels(k1, c.tracking_sample, H, W, c.tracking_Hedge, c.tracking_Wedge)
        out.append((torch.from_numpy(np.asarray(u, np.int64)), torch.from_numpy(np.asarray(v, np.int64))))
    return out


def test_track_step_matches_jax(case):
    f = case.frames[1]
    t_gt, q_gt = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="quat")
    pose0 = np.concatenate([t_gt + np.array([0.02, -0.015, 0.01]), q_gt]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    best_j, loss_j = case.jalgo._track_step(case.jalgo.model_params, case.jalgo.maps,
                                            case.jalgo._frame_rgbdr(f.jf), jnp.asarray(pose0), key)
    best, loss = case.algo.track_step(case.algo._frame_rgbdr(f.tf), torch.from_numpy(pose0),
                                      _track_samples(case.jalgo, key))
    _close(loss.item(), float(loss_j), "best loss")
    np.testing.assert_allclose(best.numpy(), np.asarray(best_j), atol=1e-5, rtol=0)
    assert not np.array_equal(np.asarray(best_j), pose0)  # tracking moved the pose


def _stage_hash(stage):
    """A stand-in for Python's ``hash`` of a stage name, which the JAX mapping
    step folds into its keys and which changes from process to process."""
    return sum(map(ord, stage))


def _map_samples(jalgo, key, steps, n_slots, pixs):
    """The pixels the JAX ``map_step`` draws from ``key``, one (u, v) pair
    of [slots, pixels] per iteration, geometry phase first."""
    out = []
    for stage, n in zip(("geometry", "color"), steps):
        for k in jax.random.split(jax.random.fold_in(key, _stage_hash(stage) % 997), n):
            k1, _ = jax.random.split(k)
            uv = [jsamp.sample_pixels(kf, pixs, H, W) for kf in jax.random.split(k1, n_slots)]
            out.append(tuple(torch.from_numpy(np.stack([np.asarray(a[i], np.int64) for a in uv])) for i in (0, 1)))
    return out


def test_map_step_matches_jax(case, monkeypatch):
    map_step_matches_jax(case, monkeypatch)


def map_step_matches_jax(case, monkeypatch, after=None, atol=1e-5):
    """``test_map_step_matches_jax``'s check on ``case``'s two algorithms
    (the model's parameters restored after it), each entry held to
    ``atol``; ``after(model)`` runs after the check, before the restore."""
    jalgo, algo = case.jalgo, case.algo
    cfg = jalgo.config
    n_slots, n_iters = cfg.mapping_window_size, cfg.mapping_n_iters
    geo = int(cfg.mapping_geo_iter_ratio * n_iters)
    pixs = max(cfg.mapping_sample // n_slots, cfg.min_sample_pixels)
    f0, f1 = case.frames
    # a window of keyframe 0 and the current frame 1, padded with frame 1
    images = np.stack([np.asarray(jalgo._frame_rgbdr(f.jf)) for f in (f0, f1, f1)])
    poses = np.stack([np.concatenate([f.jf.t, f.jf.r]) for f in (f0, f1, f1)]).astype(np.float32)
    gu, gv = jalgo._top_grad_pixels(f1.rgb, N_GRAD)
    grad_uv = np.stack([gu, gv], -1)
    key = jax.random.PRNGKey(4)
    ys = []
    scan = jax.lax.scan

    def recording_scan(*a, **k):
        carry, y = scan(*a, **k)
        ys.append(y)
        return carry, y

    monkeypatch.setattr(jax.lax, "scan", recording_scan)
    monkeypatch.setattr(jps_module, "hash", _stage_hash, raising=False)  # the same draws in every process
    jp, _ = jalgo._map_step_raw(jalgo.model_params, jalgo.maps, jnp.asarray(images), jnp.asarray(poses),
                                jnp.asarray(grad_uv, jnp.int32), jnp.asarray(2, jnp.int32), key, None,
                                n_frames=n_slots, geo_steps=geo, color_steps=n_iters - geo, n_grad=N_GRAD)
    losses_j = np.concatenate([np.asarray(y) for y in ys])
    model = algo.model
    start = copy.deepcopy(model.state_dict())
    guard = algo._finite_guard
    step_grads = []  # the port's gradients of every iteration, as Adam gets them

    def recording_guard(loss, grads):
        grads = guard(loss, grads)
        step_grads.append([g.detach().numpy().copy() for g in grads])
        return grads

    monkeypatch.setattr(algo, "_finite_guard", recording_guard)
    try:
        losses = algo.map_step(torch.from_numpy(images), torch.from_numpy(poses), 2, n_iters,
                               torch.from_numpy(grad_uv), samples=_map_samples(jalgo, key, (geo, n_iters - geo), n_slots, pixs))
        _close(losses.numpy(), losses_j, "losses")
        assert len(step_grads) == n_iters
        hold_mapped_params(model, step_grads, jp, jalgo.model_params, atol)
        if after is not None:
            after(model)
    finally:
        model.load_state_dict(start)


def hold_mapped_params(model, step_grads, jax_params, jax_before, atol=1e-5) -> int:
    """The port's parameters after a mapping call against the JAX call's
    (``jax_params``; ``jax_before`` before it), given the port's gradients
    of every iteration as Adam got them (``step_grads``): every entry
    within ``atol`` except those whose first nonzero gradient was below
    1e-3 of its leaf's largest in that iteration (Adam's first step is lr *
    g / |g| whatever |g|), each leaf within twice the iterations' largest
    step, and each leaf moved in both or in neither. Returns the count of
    excused entries."""
    n_iters = len(step_grads)
    lrs = [lr for g, ps in model.param_groups().items() for lr in [max(LRS[g])] * len(ps)]
    before = _flat_jax(jax.tree_util.tree_map(np.asarray, jax_before))
    excused = 0
    for i, (p, want, lr, b) in enumerate(zip(_flat_port(model), _flat_jax(jax_params), lrs, before)):
        got = p.detach().numpy()
        g = np.stack([s[i] for s in step_grads])  # [iters, ...]
        rel = np.abs(g) / np.maximum(np.abs(g).reshape(n_iters, -1).max(1), 1e-30).reshape((-1,) + (1,) * got.ndim)
        moved = g != 0
        first = np.argmax(moved, 0)  # the iteration of each entry's first nonzero gradient
        weak = moved.any(0) & (np.take_along_axis(rel, first[None], 0)[0] < 1e-3)
        off = np.abs(got - want) > atol
        assert not (off & ~weak).any(), (i, int((off & ~weak).sum()), float(np.abs(got - want)[~weak].max()))
        assert np.abs(got - want).max() <= 2 * n_iters * lr + 1e-5, i
        assert not np.array_equal(got, b) or np.array_equal(want, b), i  # both moved, or neither
        excused += int(off.sum())
    print(f"entries off by more than {atol}, each with a first gradient under 1e-3 of its leaf's: {excused}")
    return excused


def test_render_img_at_a_frame(case):
    """``render_img`` at frame 1's pose with its depth, in chunks with a
    padded last one: finite colours in [0, 1], depth 0 where the frame has
    none and inside the surface samples' span (0.98-1.02 of the measured
    depth) elsewhere."""
    f = case.frames[1]
    rgb, depth = case.algo.render_img(f.c2w, f.depth)
    assert rgb.shape == (H, W, 3) and depth.shape == (H, W)
    assert np.isfinite(rgb).all() and np.isfinite(depth).all() and rgb.min() >= 0 and rgb.max() <= 1
    valid = f.depth > 0
    np.testing.assert_array_equal(depth[~valid], 0.0)
    rel = np.abs(depth[valid] - f.depth[valid]) / f.depth[valid]
    assert rel.max() <= 0.02 + 1e-6


def test_registry_entry_matches_jax():
    ours, theirs = algorithm_configs["point-slam"], jalgorithm_configs["point-slam"]

    def same(a, b, path):
        for f in dataclasses.fields(a):
            if f.name.startswith("_") or f.name == "device":  # the port's device; the reference's backend
                continue
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, PrintableConfig):
                same(va, vb, f"{path}.{f.name}")
            elif f.name == "optimizers":
                assert sorted(va) == sorted(set(va) & set(vb)), path
                for g in va:
                    for k in ("lr", "eps", "betas", "weight_decay", "max_norm", "accum_step"):
                        assert getattr(va[g]["optimizer"], k) == getattr(vb[g]["optimizer"], k), f"{g}.{k}"
                    sa, sb = va[g]["scheduler"], vb[g]["scheduler"]
                    assert (sa is None) == (sb is None), g
                    if sa is not None:
                        assert (sa.start_lr, sa.end_lr) == (sb.start_lr, sb.end_lr), g
            else:
                assert va == vb, f"{path}.{f.name}: {va!r} != {vb!r}"

    assert ours.algorithm_name == theirs.algorithm_name
    same(ours.xrdslam, theirs.xrdslam, "point-slam")  # the runner's data type: only synthetic data is ported


@pytest.fixture(scope="module")
def exposure_model(case, rays):
    """The port's model with an exposure MLP: the case's parameters and the
    ``rays`` fixture's exposure tree, carried across."""
    tree = jax.tree_util.tree_map(np.asarray, case.jalgo.model_params)
    tm = ConvOnet2Config(max_points=8192, model_encode_exposure=True).setup(camera=case.cam)
    pointslam_params_from_jax({**tree, "exposure": rays.exposure[0]}, tm,
                              jax.tree_util.tree_map(np.asarray, case.jalgo.model.frozen))
    return tm


def _exposure_render(case, rays, model, latent):
    px = rays.px
    return model.render_rays(case.algo.maps, torch.from_numpy(rays.ro), torch.from_numpy(rays.rd),
                             torch.from_numpy(px[:, 3:4]), "color", r_query=torch.from_numpy(px[:, 4]),
                             exposure_feat=latent)["rgb"]


def test_exposure_render_matches_jax(case, rays, exposure_model):
    """``render_rays`` with an exposure latent against JAX within 1e-5; the
    MLP moves the colours, and without a latent it is not applied."""
    (_, want), _ = rays.jax["exposure"]
    latent = torch.from_numpy(rays.exposure[1])
    with torch.no_grad():
        rgb = _exposure_render(case, rays, exposure_model, latent).numpy()
        plain = _exposure_render(case, rays, exposure_model, None).numpy()
        base = _exposure_render(case, rays, case.algo.model, None).numpy()
    np.testing.assert_allclose(rgb, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(plain, base)
    assert np.abs(rgb - base).max() > 1e-2


def test_exposure_grads_match_jax(case, rays, exposure_model):
    """The gradients of a weighted sum of the compensated colours in the
    exposure MLP and in the latent against JAX's; as in JAX, no optimizer
    group of the model holds the MLP."""
    tm = exposure_model
    _, (g_ep, g_lat) = rays.jax["exposure"]
    latent = torch.from_numpy(rays.exposure[1]).requires_grad_(True)
    mlp = [tm.exposure_w1, tm.exposure_b1, tm.exposure_w2, tm.exposure_b2]
    loss = torch.sum(_exposure_render(case, rays, tm, latent) * torch.from_numpy(rays.exposure[2]))
    grads = torch.autograd.grad(loss, mlp + [latent])
    for g, k in zip(grads, ("w1", "b1", "w2", "b2")):
        _close(g.numpy(), g_ep[k], f"exposure.{k}")
        assert np.abs(g_ep[k]).max() > 0, k
    _close(grads[-1].numpy(), g_lat, "latent")
    grouped = {id(p) for ps in tm.param_groups().values() for p in ps}
    assert not any(id(p) in grouped for p in mlp)


def test_exposure_mlp_compensates_affine():
    """The port's version of tests/test_point_slam.py's: training only the
    exposure MLP and the latent (Adam, lr 1e-2) reproduces a global gain and
    offset of the rendered colours that the frozen map cannot explain (in
    60 steps; the JAX test takes 300)."""
    from xrdslam_tpu_torch.ops.point_table import PointMap

    cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, height=48, width=64)
    model = ConvOnet2Config(max_points=2048, model_encode_exposure=True).setup(
        camera=cam, generator=torch.Generator().manual_seed(0))
    pm = PointMap(max_points=2048, cell_size=0.16)
    rng = np.random.RandomState(1)
    pm.add_points((rng.rand(400, 3) * 0.5 + np.array([0, 0, -1.5])).astype(np.float32))
    maps = pm.device_state("cpu")
    n = 64
    d = rng.randn(n, 3).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    rays_d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    rays_o, td, rq = torch.zeros((n, 3)), torch.full((n, 1), 1.5), torch.full((n,), 0.08)
    with torch.no_grad():
        base = model.render_rays(maps, rays_o, rays_d, td, "color", rq)["rgb"]
    target = base * torch.tensor([1.4, 0.7, 1.1]) + torch.tensor([0.1, -0.05, 0.02])
    latent = torch.zeros(model.config.model_exposure_dim, requires_grad=True)
    mlp = [model.exposure_w1, model.exposure_b1, model.exposure_w2, model.exposure_b2]
    opt = torch.optim.Adam(mlp + [latent], lr=1e-2)
    losses = []
    for _ in range(60):
        loss = torch.mean(torch.square(model.render_rays(maps, rays_o, rays_d, td, "color", rq,
                                                         exposure_feat=latent)["rgb"] - target))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        out = model.render_rays(maps, rays_o, rays_d, td, "color", rq, exposure_feat=latent)["rgb"]
    err0, err_n = float(torch.abs(base - target).mean()), float(torch.abs(out - target).mean())
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
    assert err_n < 0.2 * err0, (err0, err_n)


def test_smoke_settings_run_through_the_cli(tmp_path):
    """The JAX package's Point-SLAM smoke (tests/test_e2e_algorithms.py) on
    the port's per-frame path, through the CLI on the CPU, with its gates."""
    from xrdslam_tpu_torch.scripts.run import main

    n = 8
    a = "--xrdslam.algorithm."
    runner = main([
        "point-slam", "--data-type", "synthetic", "--data", f"n_frames={n},height=48,width=64",
        "--out-dir", str(tmp_path), "--xrdslam.device", "cpu",
        "--xrdslam.tracker.map-every", "2", "--xrdslam.tracker.lazy-start", "-1",
        "--xrdslam.mapper.keyframe-every", "2",
        a + "tracking-n-iters", "8", a + "mapping-n-iters", "20", a + "mapping-first-n-iters", "40",
        a + "mapping-window-size", "3", a + "tracking-sample", "192", a + "mapping-sample", "384",
        a + "min-sample-pixels", "40", a + "ray-batch-size", "512", a + "tracking-Wedge", "6",
        a + "tracking-Hedge", "6", a + "pixels-adding", "800", a + "max-keyframes", "8",
        a + "model.max-points", "8192",
    ])
    with open(tmp_path / "eval.tar", "rb") as f:
        data = pickle.load(f)
    assert len(data["estimate_c2w_list"]) == n and data["idx"] == n - 1
    ate = evaluate_ate(list(runner.pipeline.dataset.poses), data["estimate_c2w_list"])
    assert ate["rmse"] * 100 < 2.0, f"ATE {ate['rmse'] * 100:.2f} cm"
    algo = runner.pipeline.algorithm
    assert algo.point_map.n_points > 100
    assert algo.kf_count == 4  # frames 0, 2, 4, 6
