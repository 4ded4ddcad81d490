"""NICE-SLAM in the port against the JAX package, and its run through the CLI.

The same numpy inputs go to both packages: frames of the JAX synthetic
scene, the JAX model's initial parameters carried across with
``niceslam_params_from_jax``, and the pixel samples the JAX steps draw
from their keys (the port's steps take them pre-drawn).

Tolerances: the trilinear sampler and the occupancy renderer to 1e-5 of
the largest value (outputs and gradients); the model's raw outputs to
1e-4 of the largest; its renders, losses and gradients to grids, decoders
and pose, and the mapping step, against the JAX package run in float64
(``jax.enable_x64``): XLA's float32 on the CPU is itself up to 6e-4 of
the largest from its float64 value in the fine decoder's gradients, the
port's float32 within 3e-6; the renders, losses and gradients to 1e-4 of
the largest; the host frustum masks exactly (both float64);
the device masks to a share of cells (``DEV_MASK_SHARE``) whose float32
projection lands on a border another way. Steps: tracking's best pose to
1e-5; a mapping step is Adam's, whose first update of an entry is lr *
g / |g| whatever |g|, so an entry whose gradient is ~0 when it first moves
may step either way in the two packages: the step test holds every entry
to 1e-5 except those whose first nonzero gradient was below 1e-3 of its
leaf's largest in that iteration, which it counts.
"""
import dataclasses
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import xrdslam_tpu.algorithms.nice_slam as jns_module  # noqa: E402
from xrdslam_tpu.algorithms.nice_slam import NiceSLAMConfig as JNiceSLAMConfig  # noqa: E402
from xrdslam_tpu.common.mesher import MesherConfig as JMesherConfig  # noqa: E402
from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset  # noqa: E402
from xrdslam_tpu.configs.registry import algorithm_configs as jalgorithm_configs  # noqa: E402
from xrdslam_tpu.engine.optimizers import AdamOptimizerConfig as JAdam  # noqa: E402
from xrdslam_tpu.engine.schedulers import LRconfig as JLR, NiceSLAMSchedulerConfig as JSched  # noqa: E402
from xrdslam_tpu.models.conv_onet import ConvOnetConfig as JConvOnetConfig  # noqa: E402
from xrdslam_tpu.ops import lie as jlie, lie_np as jlie_np, rendering as jrendering  # noqa: E402
from xrdslam_tpu.ops import sampling as jsamp  # noqa: E402
from xrdslam_tpu.ops.trilinear import grid_sample_3d as jgrid_sample_3d  # noqa: E402
from xrdslam_tpu_torch.algorithms.nice_slam import NiceSLAMConfig  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.common.mesher import MesherConfig  # noqa: E402
from xrdslam_tpu_torch.configs.base import PrintableConfig  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.engine.optimizers import AdamOptimizerConfig  # noqa: E402
from xrdslam_tpu_torch.engine.schedulers import LRconfig, NiceSLAMSchedulerConfig  # noqa: E402
from xrdslam_tpu_torch.models.conv_onet import ConvOnetConfig  # noqa: E402
from xrdslam_tpu_torch.ops import lie, rendering  # noqa: E402
from xrdslam_tpu_torch.ops.trilinear import grid_sample_3d  # noqa: E402
from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import niceslam_params_from_jax  # noqa: E402

H, W = 24, 32
BOUND = [[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]]
REL = 1e-4
# share of a grid's cells in which the device masks of the two packages
# may differ: float32 projections of cells that lie on a border
DEV_MASK_SHARE = 0.002
STAGE_LRS = {  # the registry's (coarse, middle, fine, color) per group
    "decoder": (0.0, 0.0, 0.0, 0.005), "grid_coarse": (0.001, 0.0, 0.0, 0.0),
    "grid_middle": (0.0, 0.1, 0.005, 0.005), "grid_fine": (0.0, 0.0, 0.005, 0.005),
    "grid_color": (0.0, 0.0, 0.0, 0.005), "mapping_pose": (0.0, 0.0, 0.0, 0.001)}


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
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


# ---------------------------------------------------------------------------
# the sampler and the renderer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 6, 7, 4), (2, 5, 3, 8)])
def test_grid_sample_3d_matches_jax(shape):
    """Forward, the grid's gradient (K4's twin on the CPU) and the
    coordinates' gradient, on points inside, on and outside [-1, 1]; one
    grid is 2 cells along x."""
    rng = np.random.default_rng(0)
    grid = rng.standard_normal(shape).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, (300, 3)).astype(np.float32)
    pts[:6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0.5], [-1.0, 0.0, 1.0], [2.0, -3.0, 0.0], [0.0, 0.0, 0.0]]
    cot = rng.standard_normal((300, shape[-1])).astype(np.float32)
    out_j, vjp = jax.vjp(jgrid_sample_3d, jnp.asarray(grid), jnp.asarray(pts))
    g_grid_j, g_pts_j = vjp(jnp.asarray(cot))
    g = torch.from_numpy(grid).requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    out = grid_sample_3d(g, p)
    g_grid, g_pts = torch.autograd.grad(out, [g, p], torch.from_numpy(cot))
    _close(out.detach(), out_j, "forward", 1e-5)
    _close(g_grid, g_grid_j, "grid gradient", 1e-5)
    _close(g_pts, g_pts_j, "coordinate gradient", 1e-5)
    outside = np.abs(pts) > 1  # clamped to the border along that axis: no gradient there
    assert outside.sum() > 50 and (g_pts.numpy()[outside] == 0).all()


@pytest.mark.parametrize("occupancy", [True, False])
def test_raw2outputs_occupancy_matches_jax(occupancy):
    """Both branches, with saturated and empty rays among them; the
    gradients of a random weighting of the outputs to raw and z_vals."""
    rng = np.random.default_rng(1)
    raw = (rng.standard_normal((64, 20, 4)) * 2).astype(np.float32)
    raw[:4, :, 3] = 100.0  # saturated
    raw[4:8, :, 3] = -100.0
    z = np.sort(rng.uniform(0.1, 4.0, (64, 20)), -1).astype(np.float32)
    rays_d = rng.standard_normal((64, 3)).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((64,), (64,), (64, 3), (64, 20))]

    def jfn(r, zz):
        outs = jrendering.raw2outputs_occupancy(r, zz, jnp.asarray(rays_d), occupancy=occupancy)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (val_j, outs_j), grads_j = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(raw), jnp.asarray(z))
    r = torch.from_numpy(raw).requires_grad_(True)
    zz = torch.from_numpy(z).requires_grad_(True)
    outs = rendering.raw2outputs_occupancy(r, zz, torch.from_numpy(rays_d), occupancy=occupancy)
    val = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, cots))
    grads = torch.autograd.grad(val, [r, zz])
    for name, o, oj in zip(("depth", "depth_var", "rgb", "weights"), outs, outs_j):
        _close(o.detach(), oj, name, 1e-5)
    for name, gr, gj in zip(("raw", "z_vals"), grads, grads_j):
        assert np.isfinite(gr.numpy()).all()
        _close(gr, gj, f"d/d{name}", 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _sched(pkg, group):
    lr_cls, sched_cls = (JLR, JSched) if pkg == "jax" else (LRconfig, NiceSLAMSchedulerConfig)
    return sched_cls(stage_lr=lr_cls(**dict(zip(("coarse", "middle", "fine", "color"), STAGE_LRS[group]))))


def _algo_config(pkg, model_kw=None, **over):
    """The JAX package's tiny NICE-SLAM (tests/test_e2e_algorithms.py) in
    either package; ``model_kw`` adds to its model's settings."""
    cls, mesher, model, adam = ((JNiceSLAMConfig, JMesherConfig, JConvOnetConfig, JAdam) if pkg == "jax" else
                                (NiceSLAMConfig, MesherConfig, ConvOnetConfig, AdamOptimizerConfig))
    opts = {g: {"optimizer": adam(), "scheduler": _sched(pkg, g)} for g in STAGE_LRS}
    opts["tracking_pose"] = {"optimizer": adam(lr=1e-3), "scheduler": None}
    kw = dict(coarse=True, rot_rep="quat", tracking_n_iters=4, mapping_n_iters=5, mapping_first_n_iters=5,
              mapping_window_size=3, tracking_sample=96, mapping_sample=192, min_sample_pixels=24,
              ray_batch_size=512, tracking_Wedge=4, tracking_Hedge=4, mapping_bound=BOUND,
              marching_cubes_bound=BOUND, mapping_color_refine=False, max_keyframes=8,
              mesher=mesher(resolution=32),
              model=model(grid_len_middle=0.32, grid_len_fine=0.16, grid_len_color=0.16, rendering_n_samples=16,
                          rendering_n_surface=8, **(model_kw or {})),
              optimizers=opts)
    kw.update(over)
    return cls(**kw)


@pytest.fixture(scope="module")
def case():
    """Both algorithms with the same initial model, and frames 0-2 of the
    JAX synthetic scene."""
    ds = JSyntheticDataset(n_frames=3, height=H, width=W)
    jcam = ds.get_camera()
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    jalgo = _algo_config("jax").setup(camera=jcam)
    algo = _algo_config("torch").setup(camera=cam, device="cpu")
    niceslam_params_from_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), algo.model)
    frames = []
    for i in range(3):
        _, rgb, depth, pose = ds[i]
        frames.append(SimpleNamespace(rgb=np.asarray(rgb, np.float32), depth=np.asarray(depth, np.float32),
                                      c2w=np.asarray(pose, np.float32)))
    return SimpleNamespace(jalgo=jalgo, algo=algo, frames=frames, cam=cam)


def test_model_layout_matches_jax(case):
    jm, tm = case.jalgo.model, case.algo.model
    np.testing.assert_array_equal(tm.bounding_box, jm.bounding_box)
    assert tm.grid_shapes == jm.grid_shapes and "grid_coarse" in tm.grid_shapes
    assert tm.trainable_decoders == jm.trainable_decoders == ["color", "middle", "fine", "coarse"]
    assert tm.geo_supervision and jm.geo_supervision
    for name, grid in tm.grids.items():
        np.testing.assert_array_equal(grid.detach().numpy(), np.asarray(case.jalgo.model_params[name]))


def _f64(tree):
    """A JAX parameter tree in float64 (inside ``jax.enable_x64``)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def _flat_jax(params, model):
    """The JAX parameters as numpy arrays in the order of the port's
    ``param_groups`` (linear weights transposed)."""
    out = [np.asarray(params[g]) for g in model.grid_shapes]
    for name in sorted(model.trainable_decoders):
        d = params["decoder"][name]
        out += [np.asarray(d["B"])] if "B" in d else []
        for w, b in zip(d["pts_w"], d["pts_b"]):
            out += [np.asarray(w).T, np.asarray(b)]
        for w, b in zip(d.get("fc_w", []), d.get("fc_b", [])):
            out += [np.asarray(w).T, np.asarray(b)]
        out += [np.asarray(d["out_w"]).T, np.asarray(d["out_b"])]
    return out


def _flat_port(model):
    return [p for ps in model.param_groups().values() for p in ps]


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_query_raw_matches_jax(case, stage):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.6, 2.6, (2, 200, 3)).astype(np.float32)  # some outside the bound
    want = np.asarray(case.jalgo.model.query_raw(case.jalgo.model_params, jnp.asarray(pts), stage))
    got = case.algo.model.query_raw(torch.from_numpy(pts), stage).detach().numpy()
    assert got.shape == (2, 200, 4) and (want[..., 3] == 100.0).sum() > 20
    np.testing.assert_array_equal(got[..., 3] == 100.0, want[..., 3] == 100.0)
    inside = want[..., 3] != 100.0
    _close(got[inside], want[inside], f"raw {stage}")


@pytest.fixture(scope="module")
def rays(case):
    """Rays of random pixels of frame 1 (some without depth), a perturbed
    pose vector and the window of frames 0 and 1; the JAX package's
    renders, losses and gradients on them from one jit: mapping (each
    stage) to the parameters and the pose, tracking to the pose."""
    f = case.frames[1]
    rng = np.random.default_rng(3)
    u, v = rng.integers(0, W, 96), rng.integers(0, H, 96)
    ts = f.rgb[v, u]
    td = f.depth[v, u][:, None].copy()
    td[::13] = 0.0
    dirs = np.asarray(jsamp.camera_ray_dirs(case.jalgo.camera))[v, u]
    t_gt, q_gt = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="quat")
    pose = np.concatenate([t_gt + np.array([0.01, -0.02, 0.015]), q_gt + np.array([0.0, 0.01, -0.01, 0.0])])
    pose = pose.astype(np.float32)
    rm = (rng.uniform(size=96) > 0.1).astype(np.float32)
    jm = case.jalgo.model

    def rays_of(p):
        rd = jnp.asarray(dirs, jnp.float64) @ jlie.quaternion_to_matrix(p[3:]).T
        return jnp.broadcast_to(p[:3], rd.shape), rd

    def loss(params, p, is_mapping, stage):
        ro, rd = rays_of(p)
        return jm.get_loss(params, jax.random.PRNGKey(0), ro, rd, jnp.asarray(ts, jnp.float64),
                           jnp.asarray(td, jnp.float64), jnp.asarray(rm, jnp.float64), is_mapping, stage)

    def everything(params, p):
        out = {s: jax.value_and_grad(lambda a, b, s=s: loss(a, b, True, s)[0], argnums=(0, 1))(params, p)
               for s in ("coarse", "middle", "fine", "color")}
        out["tracking"] = jax.value_and_grad(lambda b: loss(params, b, False, "color")[0])(p)
        ro, rd = rays_of(p)
        out["render"] = jm.render_rays(params, jax.random.PRNGKey(0), ro, rd, jnp.asarray(td, jnp.float64), "color")
        return out

    with jax.enable_x64(True):
        out = jax.jit(everything)(_f64(case.jalgo.model_params), jnp.asarray(pose, jnp.float64))
        out = jax.tree_util.tree_map(np.asarray, out)
    return SimpleNamespace(dirs=dirs, ts=ts, td=td, rm=rm, pose=pose, jax=out)


def _port_loss(case, rays, pose, is_mapping, stage):
    rd = torch.from_numpy(rays.dirs) @ lie.quaternion_to_matrix(pose[3:]).T
    return case.algo.model.get_loss(pose[:3].expand(rd.shape), rd, torch.from_numpy(rays.ts),
                                    torch.from_numpy(rays.td), torch.from_numpy(rays.rm), is_mapping, stage)


def test_render_rays_matches_jax(case, rays):
    pose = torch.from_numpy(rays.pose)
    rd = torch.from_numpy(rays.dirs) @ lie.quaternion_to_matrix(pose[3:]).T
    out = case.algo.model.render_rays(pose[:3].expand(rd.shape), rd, torch.from_numpy(rays.td), "color")
    for k in ("z_vals", "depth", "rgb", "uncertainty", "weights"):
        _close(out[k].detach(), rays.jax["render"][k], k)


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_mapping_loss_and_grads_match_jax(case, rays, stage):
    """With geo supervision (the decoders train from scratch): the loss, the
    gradients to every grid and decoder and to the pose."""
    loss_j, (g_params_j, g_pose_j) = rays.jax[stage]
    pose = torch.from_numpy(rays.pose).requires_grad_(True)
    loss, parts = _port_loss(case, rays, pose, True, stage)
    assert "geo_loss" in parts
    flat = _flat_port(case.algo.model)
    grads = torch.autograd.grad(loss, flat + [pose], allow_unused=True)
    _close(loss.item(), float(loss_j), "loss")
    want = _flat_jax(g_params_j, case.algo.model) + [g_pose_j]
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(np.zeros_like(w) if g is None else g.numpy(), w, f"grad {i}")
    used = {"coarse": ["grid_coarse"], "middle": ["grid_middle"], "fine": ["grid_middle", "grid_fine"],
            "color": ["grid_middle", "grid_fine", "grid_color"]}[stage]
    for i, name in enumerate(case.algo.model.grid_shapes):
        assert (np.abs(want[i]).max() > 0) == (name in used), name
    assert np.abs(g_pose_j).max() > 0


def test_tracking_loss_and_pose_grad_match_jax(case, rays):
    loss_j, g_j = rays.jax["tracking"]
    pose = torch.from_numpy(rays.pose).requires_grad_(True)
    loss, parts = _port_loss(case, rays, pose, False, "color")
    (g,) = torch.autograd.grad(loss, [pose])
    _close(loss.item(), float(loss_j), "loss")
    _close(g.numpy(), g_j, "pose grad")
    assert set(parts) == {"depth_loss", "rgb_loss"} and np.abs(g_j).max() > 0


def test_frustum_masks_match_jax(case):
    """The host masks exactly; the device masks within ``DEV_MASK_SHARE``
    of each grid's cells of the JAX device masks, and of the host masks."""
    f = case.frames[1]
    want = case.jalgo.model.frustum_grid_masks(f.c2w, f.depth)
    got = case.algo.model.frustum_grid_masks(f.c2w, f.depth)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_dev = case.jalgo.model.frustum_grid_masks_dev(jnp.asarray(f.c2w), jnp.asarray(f.depth))
    got_dev = case.algo.model.frustum_grid_masks_dev(torch.from_numpy(f.c2w), torch.from_numpy(f.depth))
    for k in want:
        g, wd = got_dev[k].numpy(), np.asarray(want_dev[k])
        assert g.shape == wd.shape == want[k].shape
        limit = DEV_MASK_SHARE * g.size
        assert (g != wd).sum() <= limit and (g != want[k]).sum() <= limit, k
        if k != "grid_coarse":
            assert 0 < g.sum() < g.size, k  # the frustum cuts the grid


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

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
    f = case.frames[2]
    t_gt, q_gt = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="quat")
    pose0 = np.concatenate([t_gt + np.array([0.02, -0.015, 0.01]), q_gt]).astype(np.float32)
    key = jax.random.PRNGKey(5)
    best_j, loss_j = case.jalgo._track_step(case.jalgo.model_params, jnp.asarray(f.rgb), jnp.asarray(f.depth),
                                            jnp.asarray(pose0), key)
    best, loss = case.algo.track_step(torch.from_numpy(f.rgb), torch.from_numpy(f.depth), torch.from_numpy(pose0),
                                      _track_samples(case.jalgo, key))
    _close(loss.item(), float(loss_j), "best loss")
    np.testing.assert_allclose(best.numpy(), np.asarray(best_j), atol=1e-5, rtol=0)
    assert not np.array_equal(np.asarray(best_j), pose0)  # tracking moved the pose


def _stage_hash(stage):
    """A stand-in for Python's ``hash`` of a stage name, which the JAX mapping
    step folds into its keys and which changes from process to process."""
    return sum(map(ord, stage))


def _map_samples(key, phases, n_slots, pixs):
    """The pixels the JAX ``map_step`` draws from ``key``: (u, v) of [slots,
    pixels] per iteration."""
    out = []
    for stage, n in phases:
        if n <= 0:
            continue
        for k in jax.random.split(jax.random.fold_in(key, _stage_hash(stage) % 1000), n):
            k1, _ = jax.random.split(k)
            uv = [jsamp.sample_pixels(kf, pixs, H, W) for kf in jax.random.split(k1, n_slots)]
            out.append(tuple(torch.from_numpy(np.stack([np.asarray(a[i], np.int64) for a in uv])) for i in (0, 1)))
    return out


@pytest.mark.parametrize("coarse", [False, True])
def test_map_step_matches_jax(case, monkeypatch, coarse):
    """A mapping call on a window of keyframes 0, 1 and the current frame 2
    padded to 4 slots (n_valid 3): the fine phases with the frustum masks,
    the decoders and the poses (the oldest fixed), or the coarse phase; the
    lr factor of a later mapping call. (At a first call's factor, 5, the
    middle grid's lr is 0.5: an entry whose gradient is at the level of
    float32 noise steps 0.5 either way, and a later iteration that samples
    it renders another field in each package.)"""
    map_step_matches_jax(case, monkeypatch, coarse)


def map_step_matches_jax(case, monkeypatch, coarse, after=None):
    """``test_map_step_matches_jax``'s check on ``case``'s two algorithms
    (the model's parameters restored after it); ``after(model)`` runs
    after the check, before the restore."""
    jalgo, algo = case.jalgo, case.algo
    cfg = jalgo.config
    n_slots, n_iters, lr_factor = 4, 6, 1.0
    pixs = max(cfg.mapping_sample // n_slots, cfg.min_sample_pixels)
    fr = case.frames
    images = np.stack([np.concatenate([f.rgb, f.depth[..., None]], -1) for f in (fr[0], fr[1], fr[2], fr[2])])
    poses = []
    for j, f in enumerate((fr[0], fr[1], fr[2], fr[2])):
        t, q = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="quat")
        poses.append(np.concatenate([t + 0.01 * j, q]))
    poses = np.stack(poses).astype(np.float32)
    masks = {} if coarse else jalgo.model.frustum_grid_masks(fr[2].c2w, fr[2].depth)
    key = jax.random.PRNGKey(6)
    monkeypatch.setattr(jns_module, "hash", _stage_hash, raising=False)  # the same draws in every process
    with jax.enable_x64(True):
        jp, jposes, jcl = jalgo._map_step_raw(
            _f64(jalgo.model_params), jnp.asarray(images, jnp.float64), jnp.asarray(poses, jnp.float64),
            {k: jnp.asarray(v, jnp.float64) for k, v in masks.items()}, jnp.asarray(3, jnp.int32), key,
            n_frames=n_slots, n_iters=n_iters, lr_factor=lr_factor, optimize_pose=not coarse, coarse=coarse)
        jp, jposes, jcl = jax.tree_util.tree_map(np.asarray, (jp, jposes, jcl))
        samples = _map_samples(key, algo._phases(n_iters, coarse), n_slots, pixs)
    model = algo.model
    start = [p.detach().clone() for p in _flat_port(model)]
    guard = algo._finite_guard
    step_grads = []  # the port's gradients of every iteration, as Adam gets them

    def recording_guard(loss, grads):
        grads = guard(loss, grads)
        step_grads.append([g.detach().numpy().copy() for g in grads])
        return grads

    monkeypatch.setattr(algo, "_finite_guard", recording_guard)
    try:
        new_poses, n_clamped = algo.map_step(
            torch.from_numpy(images), torch.from_numpy(poses), {k: torch.from_numpy(v) for k, v in masks.items()},
            3, n_iters, lr_factor, not coarse, coarse, samples=samples)
        assert int(n_clamped) == int(jcl) == 0
        np.testing.assert_allclose(new_poses.numpy(), np.asarray(jposes), atol=1e-5, rtol=0)
        if not coarse:
            # the oldest is fixed (to the rounding of the quaternion's renormalisation)
            np.testing.assert_allclose(new_poses.numpy()[0], poses[0], atol=1e-6, rtol=0)
            assert np.abs(new_poses.numpy()[1:3] - poses[1:3]).max() > 0
        assert len(step_grads) == n_iters
        flat_port = _flat_port(model)
        names = list(model.param_groups())
        sizes = [len(ps) for ps in model.param_groups().values()]
        group_of = [n for n, s in zip(names, sizes) for _ in range(s)]
        wanted = _flat_jax(jp, model)
        before = _flat_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), model)
        trained = ["grid_coarse"] if coarse else ["grid_middle", "grid_fine", "grid_color", "decoder"]
        excused = 0
        i_step = 0  # index among the leaves the step trained
        for p, want, b, group in zip(flat_port, wanted, before, group_of):
            got = p.detach().numpy()
            if group not in trained:
                np.testing.assert_array_equal(got, b, err_msg=group)
                np.testing.assert_array_equal(want, b, err_msg=group)
                continue
            g = np.stack([s[i_step] for s in step_grads])
            i_step += 1
            rel = np.abs(g) / np.maximum(np.abs(g).reshape(n_iters, -1).max(1), 1e-30).reshape((-1,) + (1,) * got.ndim)
            moved = g != 0
            first = np.argmax(moved, 0)
            weak = moved.any(0) & (np.take_along_axis(rel, first[None], 0)[0] < 1e-3)
            off = np.abs(got - want) > 1e-5
            assert not (off & ~weak).any(), (group, int((off & ~weak).sum()), float(np.abs(got - want)[~weak].max()))
            excused += int(off.sum())
            assert not np.array_equal(got, b) or np.array_equal(want, b), group  # both moved, or neither
        if masks:
            # the masks kept the cells outside the frustum
            m = masks["grid_fine"][..., 0] == 0
            fine = list(model.grid_shapes).index("grid_fine")
            np.testing.assert_array_equal(model.grids["grid_fine"].detach().numpy()[m], before[fine][m])
        print(f"entries off by more than 1e-5, each with a first gradient under 1e-3 of its leaf's: {excused}")
        if after is not None:
            after(model)
    finally:
        with torch.no_grad():
            for p, s in zip(_flat_port(model), start):
                p.copy_(s)


def test_phase_groups_match_jax(case):
    """Each phase's groups and learning rates, the from-scratch decoder's
    colour lr and clip included."""
    for stage in ("middle", "fine", "color", "coarse"):
        for optimize_pose in (False, True):
            coarse = stage == "coarse"
            want = case.jalgo._phase_groups(stage, 5.0, optimize_pose, coarse)
            got = case.algo._phase_groups(stage, 5.0, optimize_pose, coarse)
            assert sorted(got) == sorted(want)
            for g in want:
                for k in ("lr", "eps", "betas", "weight_decay", "max_norm"):
                    assert getattr(got[g], k) == getattr(want[g], k), (stage, g, k)
    assert case.algo._phase_groups("middle", 1.0, False, False)["decoder"].max_norm == 10.0


def test_overlap_window_matches_jax(case, monkeypatch):
    """The overlap ranking's picks from the same numpy generator seed."""
    jalgo, algo = case.jalgo, case.algo
    ds = JSyntheticDataset(n_frames=3, height=96, width=128)  # an image wider than the 2 x 20 px edge
    jcam = ds.get_camera()
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    for a, c in ((jalgo, jcam), (algo, cam)):
        monkeypatch.setattr(a, "camera", c)
        monkeypatch.setattr(a, "kf_count", 6)
        monkeypatch.setattr(a, "kf_pose_host", a.kf_pose_host.copy())
    rng = np.random.default_rng(7)
    for j in range(6):
        c2w = np.asarray(ds[j % 3][3], np.float32).copy()
        c2w[:3, 3] += rng.uniform(-0.3, 0.3, 3)
        t, q = jlie_np.matrix_to_pose_vec(c2w, rot_rep="quat")
        jalgo.kf_pose_host[j] = algo.kf_pose_host[j] = np.concatenate([t, q])
    f = SimpleNamespace(depth=np.asarray(ds[2][2], np.float32), c2w=np.asarray(ds[2][3], np.float32))
    monkeypatch.setattr(jalgo, "_key", jax.random.PRNGKey(9))
    seed = int(jax.random.split(jalgo._key)[1][0])
    monkeypatch.setattr(algo, "rng", np.random.default_rng(seed))
    want = jalgo._select_window(f.depth, f.c2w)
    got = algo._select_window(f.depth, f.c2w)
    assert got == want and len(got) == 2 and got[-1] == 5


# ---------------------------------------------------------------------------
# the registry and the CLI
# ---------------------------------------------------------------------------

def test_registry_entry_matches_jax():
    ours, theirs = algorithm_configs["nice-slam"], jalgorithm_configs["nice-slam"]

    def same(a, b, path):
        for f in dataclasses.fields(a):
            if f.name.startswith("_") or f.name == "device":  # the port's device
                continue
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, PrintableConfig):
                same(va, vb, f"{path}.{f.name}")
            elif f.name == "optimizers":
                assert sorted(va) == sorted(vb), path
                for g in va:
                    for k in ("lr", "eps", "betas", "weight_decay", "max_norm", "accum_step"):
                        assert getattr(va[g]["optimizer"], k) == getattr(vb[g]["optimizer"], k), f"{g}.{k}"
                    sa, sb = va[g]["scheduler"], vb[g]["scheduler"]
                    assert (sa is None) == (sb is None), g
                    if sa is not None:
                        assert dataclasses.asdict(sa.stage_lr) == dataclasses.asdict(sb.stage_lr), g
            else:
                assert va == vb, f"{path}.{f.name}: {va!r} != {vb!r}"

    assert ours.algorithm_name == theirs.algorithm_name
    same(ours.xrdslam, theirs.xrdslam, "nice-slam")


def test_tiny_run_through_the_cli(tmp_path):
    """The JAX package's tiny NICE-SLAM settings through the CLI on the CPU,
    7 frames of 48x64: frames 4-5 are a group (eager here); finite poses and
    ATE, a mesh and a render."""
    from xrdslam_tpu_torch.scripts.run import main

    n = 7
    a = "--xrdslam.algorithm."
    bound = "[[-2.2,2.2],[-2.2,2.2],[-2.2,2.2]]"
    runner = main([
        "nice-slam", "--data-type", "synthetic", "--data", f"n_frames={n},height=48,width=64",
        "--out-dir", str(tmp_path), "--xrdslam.device", "cpu",
        "--xrdslam.tracker.save-re-render-result", "false",  # the sweep: tests/test_torch_sweep.py
        "--xrdslam.tracker.map-every", "2", "--xrdslam.mapper.keyframe-every", "2",
        a + "tracking-n-iters", "6", a + "mapping-n-iters", "10", a + "mapping-first-n-iters", "30",
        a + "mapping-window-size", "3", a + "tracking-sample", "160", a + "mapping-sample", "300",
        a + "min-sample-pixels", "40", a + "ray-batch-size", "1024", a + "tracking-Wedge", "6",
        a + "tracking-Hedge", "6", a + "mapping-bound", bound, a + "marching-cubes-bound", bound,
        a + "mapping-color-refine", "false", a + "max-keyframes", "8", a + "mesher.resolution", "24",
        a + "model.rendering-n-samples", "24", a + "model.rendering-n-surface", "12",
    ])
    with open(tmp_path / "eval.tar", "rb") as f:
        data = pickle.load(f)
    assert len(data["estimate_c2w_list"]) == n and all(np.isfinite(p).all() for p in data["estimate_c2w_list"])
    pipe = runner.pipeline
    assert pipe.groups == [4]
    ate = evaluate_ate(list(pipe.dataset.poses), data["estimate_c2w_list"])
    assert np.isfinite(ate["rmse"]) and ate["rmse"] * 100 < 2.0, f"ATE {ate['rmse'] * 100:.2f} cm"
    algo = pipe.algorithm
    mesh = algo.get_mesh()
    assert mesh is not None and len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all()
    rgb, depth = algo.render_img(data["estimate_c2w_list"][-1], pipe.dataset[n - 1][2])
    assert rgb.shape == (48, 64, 3) and np.isfinite(rgb).all() and np.isfinite(depth).all()
