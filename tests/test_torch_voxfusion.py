"""Vox-Fusion's model and steps in the port against the JAX package.

The same numpy inputs go to both packages: frames of the JAX synthetic
scene at 32x48, a JAX Vox-Fusion at small sizes (48 coarse probes, 5 hits
of 4 samples) after one mapping call on frame 0, its parameters carried
into the port with ``voxfusion_params_from_jax`` and its device voxel maps
with ``voxfusion_state_from_jax``, and the pixel samples the JAX steps draw
from their keys (the port's steps take them pre-drawn). The JAX model's
``table_lookup`` takes its XLA scatter on the CPU.

Tolerances: the sampler's masks and voxel ids exactly, its depths to 1e-6
of the largest; renders, losses and their gradients to the embedding
table, the decoder and the pose to 1e-4 of the largest (float32 sums in
another order); tracking's best pose to 1e-5; a mapping call's poses to 1e-5, its table
and decoder to 1e-4 (the call moves them by up to lr x iterations =
1.5e-2), except entries whose first nonzero gradient was below 1e-2 of
its tensor's largest in that iteration, at most 0.1% of the entries: such
a gradient is a sum that cancels (an embedding row that many samples
share), which float32 sums in another order change by percents, and Adam
steps an entry by about lr whatever its gradient's size.
"""
import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset  # noqa: E402
from xrdslam_tpu.configs.registry import algorithm_configs as jalgorithm_configs  # noqa: E402
from xrdslam_tpu.ops import lie as jlie, lie_np as jlie_np, sampling as jsamp  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.configs.base import PrintableConfig  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.ops import lie, scatter  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import voxfusion_params_from_jax, voxfusion_state_from_jax  # noqa: E402

H, W = 32, 48
REL = 1e-4
SMALL = dict(max_voxels=1024, num_embeddings=4096, coarse_steps=48, max_voxel_hit=5, samples_per_voxel=4)


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


def small_configs(**over):
    """The registry's Vox-Fusion in both packages at the tests' size."""
    pair = []
    for reg in (jalgorithm_configs, algorithm_configs):
        cfg = copy.deepcopy(reg["vox-fusion"].xrdslam.algorithm)
        cfg.tracking_n_iters, cfg.mapping_n_iters, cfg.mapping_first_n_iters = 8, 3, 20
        cfg.tracking_sample, cfg.mapping_sample, cfg.mapping_window_size = 128, 48, 4
        cfg.max_keyframes, cfg.ray_batch_size, cfg.mesh_resolution = 8, 512, 32
        for k, v in {**SMALL, **over}.items():
            setattr(cfg.model, k, v)
        pair.append(cfg)
    return pair


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(model):
    """The port model's parameters in the JAX package's layout."""
    def layer(m):
        return {"w": m.weight.detach().numpy().T.copy(), "b": m.bias.detach().numpy().copy()}

    return {"embeddings": {"table": model.embeddings.detach().numpy().copy()},
            "decoder": {"pts": [layer(m) for m in model.pts], "sdf_out": layer(model.sdf_out),
                        "color0": layer(model.color0), "color1": layer(model.color1)}}


@pytest.fixture(scope="module")
def case():
    """Both packages on one map: the port's first mapping call on frame 0
    (frame 1's voxels inserted too, so that later frames see a larger map),
    its parameters and maps carried into the JAX algorithm, and back into
    the port through the converters."""
    ds = JSyntheticDataset(n_frames=5, height=H, width=W)
    cam = ds.get_camera()
    jcfg, tcfg = small_configs()
    jalgo = jcfg.setup(camera=cam)
    algo = tcfg.setup(camera=Camera(cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width), device="cpu")
    frames = []
    for i in range(5):
        _, rgb, depth, c2w = ds[i]
        fr = Frame(fid=i, rgb=rgb, depth=depth, init_pose=c2w, rot_rep="axis_angle")
        frames.append(SimpleNamespace(rgb=fr.rgb_dev("cpu").numpy(), depth=depth.astype(np.float32),
                                      c2w=c2w.astype(np.float32), frame=fr))
    algo.do_mapping(frames[0].frame)
    algo.create_voxels(frames[1].frame)
    jalgo.model_params = jax.tree_util.tree_map(jnp.asarray, _jax_params(algo.model))
    jalgo.maps = {k: jnp.asarray(v.numpy()) for k, v in algo.maps.items()}
    voxfusion_params_from_jax(_np(jalgo.model_params), algo.model)
    voxfusion_state_from_jax(algo, _np(jalgo.maps))
    algo.model_opt_state = algo.model_opt.init(algo.model.param_groups())
    return SimpleNamespace(jalgo=jalgo, algo=algo, frames=frames, dirs=np.asarray(jalgo._dirs))


def _rays(case, i, n=256, seed=0, jitter=0.0):
    """``n`` random pixels of frame ``i``: their rays at its pose (shifted
    by ``jitter`` m), colours and depths."""
    f = case.frames[i]
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, W, n), rng.integers(0, H, n)
    rays_d = (case.dirs[v, u] @ f.c2w[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(f.c2w[:3, 3] + jitter, rays_d.shape).astype(np.float32)
    return rays_o, rays_d, f.rgb[v, u], f.depth[v, u][:, None]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_intersect_and_sample_matches_jax(case):
    """Rays of a frame (most hit voxels, some miss all) and random rays."""
    ro, rd, _, _ = _rays(case, 3)
    rng = np.random.default_rng(1)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    ro = np.concatenate([ro, rng.uniform(-1, 1, (64, 3)).astype(np.float32)])
    rd = np.concatenate([rd, d / np.linalg.norm(d, axis=-1, keepdims=True)])
    want = jax.jit(lambda m, o, d: case.jalgo.model.intersect_and_sample(m, o, d, None))(
        case.jalgo.maps, jnp.asarray(ro), jnp.asarray(rd))
    got = case.algo.model.intersect_and_sample(case.algo.maps, torch.from_numpy(ro), torch.from_numpy(rd))
    for name, g, w in zip(("z_vals", "dt", "vox_idx", "sample_mask", "ray_mask", "seg_vox"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        if g.dtype == np.float32 and name != "sample_mask":
            _close(g, w, name, 1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    ray_mask = got[4].numpy()
    assert 0 < ray_mask.sum() < len(ray_mask)  # some rays hit, some miss
    assert (got[5].numpy()[~ray_mask] == 0).all()  # a ray that misses points at voxel 0


def _jax_loss_fn(case, rgb, depth):
    model, maps = case.jalgo.model, case.jalgo.maps

    def fn(params, t, r, d_cam):
        rays_d = d_cam @ jlie.axis_angle_to_matrix(r).T
        rays_o = jnp.broadcast_to(t, rays_d.shape)
        loss, parts = model.get_loss(params, maps, None, rays_o, rays_d, jnp.asarray(rgb), jnp.asarray(depth))
        return loss, (parts, model.render_rays(params, maps, None, rays_o, rays_d))

    return fn


def test_render_loss_and_gradients_match_jax(case):
    """At a pose 1 cm off frame 3's: the render, the loss terms, and the
    loss's gradients to the table, each decoder tensor and the pose (t, r)."""
    f = case.frames[3]
    rng = np.random.default_rng(2)
    u, v = rng.integers(0, W, 300), rng.integers(0, H, 300)
    d_cam = case.dirs[v, u]
    t, r = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="axis_angle")
    t = (t + 0.01).astype(np.float32)
    r = r.astype(np.float32)
    fn = _jax_loss_fn(case, f.rgb[v, u], f.depth[v, u][:, None])
    (loss_j, (parts_j, out_j)), grads_j = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True))(
        case.jalgo.model_params, jnp.asarray(t), jnp.asarray(r), jnp.asarray(d_cam))

    model = case.algo.model
    tt, rr = torch.from_numpy(t).requires_grad_(True), torch.from_numpy(r).requires_grad_(True)
    rays_d = torch.from_numpy(d_cam) @ lie.axis_angle_to_matrix(rr).T
    rays_o = tt.expand(rays_d.shape)
    out = model.render_rays(case.algo.maps, rays_o, rays_d)
    loss, parts = model.get_loss(case.algo.maps, rays_o, rays_d, torch.from_numpy(f.rgb[v, u]),
                                 torch.from_numpy(f.depth[v, u][:, None]))
    for k in ("rgb", "depth", "sdf", "z_vals", "weights", "sample_mask"):
        _close(out[k].detach(), out_j[k], k)
    np.testing.assert_array_equal(out["ray_mask"].numpy(), np.asarray(out_j["ray_mask"]))
    _close(loss.item(), float(loss_j), "loss")
    for k in ("rgb", "depth", "sdf", "fs"):
        _close(parts[k].item(), float(parts_j[k]), f"loss term {k}")
    wrt = [model.embeddings] + model.decoder_params() + [tt, rr]
    grads = torch.autograd.grad(loss, wrt)
    g_params, g_t, g_r = grads_j
    dec = g_params["decoder"]
    want = ([g_params["embeddings"]["table"]]
            + [x for layer in dec["pts"] + [dec["sdf_out"], dec["color0"], dec["color1"]]
               for x in (np.asarray(layer["w"]).T, layer["b"])] + [g_t, g_r])
    names = ["table"] + [f"decoder[{i}]" for i in range(len(wrt) - 3)] + ["t", "r"]
    for name, g, w in zip(names, grads, want):
        _close(g, w, f"gradient to {name}")
    assert np.abs(grads[0].numpy()).max() > 0 and np.abs(grads[-1].numpy()).max() > 0


def test_query_sdf_grid_matches_jax(case):
    """The mesher's field: the SDF and colour inside the voxels, twice the
    truncation outside them; ``interp_embeddings`` with it."""
    ro, rd, _, td = _rays(case, 0, n=2000, seed=3)
    pts = (ro + rd * td + np.random.default_rng(3).normal(0, 0.15, ro.shape)).astype(np.float32)
    sdf_j, rgb_j = case.jalgo._query_sdf_grid(case.jalgo.model_params, case.jalgo.maps, jnp.asarray(pts))
    sdf, rgb = case.algo.query_sdf_grid(torch.from_numpy(pts))
    _close(sdf, sdf_j, "sdf")
    _close(rgb, rgb_j, "rgb")
    inside = np.asarray(sdf_j) != 0.1
    assert 200 < inside.sum() < len(pts) - 200


def test_render_img_matches_jax_and_mesh(case):
    """``render_img`` at frame 2's pose in chunks (the last one short), and
    ``get_mesh``: finite, with faces."""
    c2w = case.frames[2].c2w
    rgb_j, depth_j = case.jalgo.render_img(c2w)
    rgb, depth = case.algo.render_img(c2w)
    _close(rgb, rgb_j, "rgb")
    _close(depth, depth_j, "depth")
    mesh = case.algo.get_mesh()
    assert mesh is not None and len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all()


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _track_samples(jalgo, key):
    """The pixels the JAX ``track_step`` draws from ``key``."""
    c = jalgo.config
    out = []
    for k in jax.random.split(key, c.tracking_n_iters):
        k1, _ = jax.random.split(k)
        u, v = jsamp.sample_pixels(k1, c.tracking_sample, H, W)
        out.append((torch.from_numpy(np.asarray(u, np.int64)), torch.from_numpy(np.asarray(v, np.int64))))
    return out


def test_track_step_matches_jax(case):
    f = case.frames[2]
    t, r = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="axis_angle")
    t0 = (t + np.array([0.012, -0.008, 0.01])).astype(np.float32)
    r0 = (r + np.array([0.004, -0.003, 0.002])).astype(np.float32)
    key = jax.random.PRNGKey(5)
    bt_j, br_j, loss_j = case.jalgo._track_step(case.jalgo.model_params, case.jalgo.maps, jnp.asarray(f.rgb),
                                                jnp.asarray(f.depth), jnp.asarray(t0), jnp.asarray(r0), key)
    bt, br, loss = case.algo.track_step(torch.from_numpy(f.rgb), torch.from_numpy(f.depth), torch.from_numpy(t0),
                                        torch.from_numpy(r0), _track_samples(case.jalgo, key))
    _close(loss.item(), float(loss_j), "best loss")
    np.testing.assert_allclose(bt.numpy(), np.asarray(bt_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(br.numpy(), np.asarray(br_j), atol=1e-5, rtol=0)
    assert not np.array_equal(np.asarray(bt_j), t0)  # tracking moved the pose


def _map_samples(key, n_iters, n_slots, pixs):
    """The pixels the JAX ``map_step`` draws from ``key``: (u, v) of [slots,
    pixels] per iteration."""
    out = []
    for k in jax.random.split(key, n_iters):
        k1, _ = jax.random.split(k)
        uv = [jsamp.sample_pixels(kf, pixs, H, W) for kf in jax.random.split(k1, n_slots)]
        out.append(tuple(torch.from_numpy(np.stack([np.asarray(a[i], np.int64) for a in uv])) for i in (0, 1)))
    return out


def test_map_step_matches_jax(case, monkeypatch):
    """A mapping call from a fresh Adam state on a window of frames 0, 1
    and the current frame 2, padded to 4 slots (n_valid 3), poses optimised
    (the oldest fixed): the table, the decoder and the poses; one K4 call a
    mapping iteration. Tracking makes none."""
    jalgo, algo = case.jalgo, case.algo
    n_slots, n_iters = 4, 3
    fr = case.frames
    images = np.stack([np.concatenate([f.rgb, f.depth[..., None]], -1) for f in (fr[0], fr[1], fr[2], fr[2])])
    poses = []
    for j, f in enumerate((fr[0], fr[1], fr[2], fr[2])):
        t, r = jlie_np.matrix_to_pose_vec(f.c2w, rot_rep="axis_angle")
        poses.append(np.concatenate([t + 0.01 * j, r]))
    poses = np.stack(poses).astype(np.float32)
    key = jax.random.PRNGKey(6)
    sub = {g: jalgo.model_params[g] for g in ("decoder", "embeddings")}
    jp, _, jposes = jalgo._map_variant(n_slots, n_iters, True)(
        sub, jalgo.model_opt.init(sub), jalgo.maps, jnp.asarray(images), jnp.asarray(poses),
        jnp.asarray(3, jnp.int32), key)
    calls = []
    plain = scatter.scatter_add

    def counted(idx, g, rows):
        calls.append(idx.shape[0])
        return plain(idx, g, rows)

    guard = algo._finite_guard
    step_grads = []  # the port's gradients of every iteration, as Adam gets them

    def recording_guard(loss, grads):
        grads = guard(loss, grads)
        step_grads.append([g.detach().numpy().copy() for g in grads])
        return grads

    monkeypatch.setattr(scatter, "scatter_add", counted)
    monkeypatch.setattr(algo, "_finite_guard", recording_guard)
    params = [p for ps in algo.model.param_groups().values() for p in ps]
    start = [p.detach().clone() for p in params]
    try:
        new_poses = algo.map_step(torch.from_numpy(images), torch.from_numpy(poses), 3, n_iters, True,
                                  _map_samples(key, n_iters, n_slots, jalgo.config.mapping_sample))
        c = jalgo.config.model
        assert calls == [n_slots * jalgo.config.mapping_sample * c.max_voxel_hit * 8] * n_iters
        np.testing.assert_allclose(new_poses.numpy(), np.asarray(jposes), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(new_poses.numpy()[0], poses[0])  # the oldest is fixed
        assert np.abs(new_poses.numpy()[1:3] - poses[1:3]).max() > 0
        want = copy.deepcopy(algo.model)
        voxfusion_params_from_jax(_np(jp), want)
        wanted = [p for ps in want.param_groups().values() for p in ps]
        excused = 0
        for i, (got, w, s) in enumerate(zip(params, wanted, start)):
            got, w = got.detach().numpy(), w.detach().numpy()
            g = np.stack([it[i] for it in step_grads])
            scale = np.maximum(np.abs(g).reshape(n_iters, -1).max(1), 1e-30).reshape((-1,) + (1,) * got.ndim)
            first = np.argmax(g != 0, 0)
            weak = (g != 0).any(0) & (np.take_along_axis(np.abs(g) / scale, first[None], 0)[0] < 1e-2)
            off = np.abs(got - w) > 1e-4
            assert not (off & ~weak).any(), (i, int((off & ~weak).sum()), float(np.abs(got - w)[~weak].max()))
            excused += int(off.sum())
            assert not np.array_equal(got, s.numpy()), i  # every tensor moved
        assert excused <= 1e-3 * sum(p.numel() for p in params), excused
        f = case.frames[3]
        calls.clear()
        algo.track_step(torch.from_numpy(f.rgb), torch.from_numpy(f.depth), torch.zeros(3), torch.zeros(3))
        assert calls == []
    finally:
        with torch.no_grad():
            for p, s in zip(params, start):
                p.copy_(s)
        algo.model_opt_state = algo.model_opt.init(algo.model.param_groups())


# ---------------------------------------------------------------------------
# the registry and the converters
# ---------------------------------------------------------------------------

def test_registry_entry_matches_jax():
    """Every field that the port's entry sets, as the JAX entry sets it."""
    ours, theirs = algorithm_configs["vox-fusion"], jalgorithm_configs["vox-fusion"]

    def same(a, b, path):
        for f in dataclasses.fields(a):
            if f.name.startswith("_"):
                continue
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, PrintableConfig):
                same(va, vb, f"{path}.{f.name}")
            elif f.name == "optimizers":
                assert sorted(va) == sorted(vb)
                for g in va:
                    for k in ("lr", "eps", "betas", "weight_decay", "max_norm", "accum_step"):
                        assert getattr(va[g]["optimizer"], k) == getattr(vb[g]["optimizer"], k), f"{g}.{k}"
                    assert va[g]["scheduler"] is None and vb[g]["scheduler"] is None
            elif f.name != "device":
                assert va == vb, f"{path}.{f.name}: {va!r} != {vb!r}"

    assert ours.algorithm_name == theirs.algorithm_name
    same(ours.xrdslam, theirs.xrdslam, "vox-fusion")


def test_converters_round_trip(case):
    """The JAX parameters into the port and back to the JAX layout give the
    same arrays; the maps carried into the port are the JAX maps; a wrong
    shape raises."""
    jparams = _np(case.jalgo.model_params)
    model = copy.deepcopy(case.algo.model)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    voxfusion_params_from_jax(jparams, model)

    back = _jax_params(model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jparams)
    for k, v in _np(case.jalgo.maps).items():
        np.testing.assert_array_equal(case.algo.maps[k].numpy(), v, err_msg=k)
    bad = copy.deepcopy(jparams)
    bad["embeddings"]["table"] = bad["embeddings"]["table"][:10]
    with pytest.raises(ValueError, match="embeddings.table"):
        voxfusion_params_from_jax(bad, model)
    with pytest.raises(ValueError, match="hash_vals"):
        voxfusion_state_from_jax(case.algo, {"hash_vals": np.zeros(3, np.int32)})
