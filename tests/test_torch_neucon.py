"""NeuCon (NeuralRecon's network) in the port against the JAX package.

The same NumPy parameters (the port's initial tree, in the JAX package's
layouts) and inputs go through each JAX function and its port:

* the backbone on 2 views of 48x64, ``back_project`` with voxels in front
  of, behind and beside the cameras, the transposed convolution and
  ``_down2``, the U-Net at cr 1 and 1/4 (8^3) and the ConvGRU, in float32: to
  1e-4 of the largest output (they read ~5e-6), the counts exactly;
* ``fragment_step`` at n_vox 32 on a real fragment of the synthetic scene
  (3 + 1 views of 48x64, the hidden crops random): both packages in
  float64, occupancy on >= 99.9% of the voxels, TSDF where both are
  occupied and each level's new hidden state to 1e-9 of the largest (the
  two read ~1e-12 apart: the same function). In float32 the cascade's
  instance norms amplify rounding: the port's float32 run against JAX's
  float64 is held to 1e-2 of the largest, occupancy again on >= 99.9%;
* ``loss`` and its gradient for every parameter leaf against
  ``jax.value_and_grad``, both in float64: the loss to 1e-10, each leaf
  whose largest entry passes 1e-5 of the largest entry of all to 1e-6 of
  its own, every leaf to 1e-7 of the largest entry of all (the biases
  before an instance norm have a zero gradient, where both packages give
  rounding noise; the two read ~5e-8 apart, the voxel grid being float32
  in both);
* the layouts: the port's tree has the JAX model's paths and shapes,
  ``to_jax_layout`` undoes ``to_torch_layout`` on every leaf, and
  ``neucon_params_from_jax`` loads a JAX tree in place.

On the card (``cuda`` marker; skipped without one): one ``fragment_step``
on the card against the CPU's from the same inputs (float32: TSDF and
hidden states to 1e-2 of the largest, occupancy on >= 99.9%), and a second
call with the same bits; the loss on the card to 1e-4 of the CPU's, its
gradients finite and to 5e-2 of the largest entry of all, and cuDNN's
TF32 and determinism flags as they were before the call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.algorithms.neural_recon import NeuralReconConfig  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.models import neucon as T  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import neucon_params_from_jax  # noqa: E402
from xrdslam_tpu_torch.utils.neucon_train import level_targets, scene_sdf_numpy  # noqa: E402

N_VOX, VOXEL = 32, 0.15
SMOKE = dict(mapping_window_size=3, min_angle=0.0, min_distance=0.0, max_depth=3.0, img_size_w=64, img_size_h=48)


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


def _cl(t):
    """A channels-first tensor [1, C, ...] or [V, C, ...] as channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _jax_tree(tree, dtype=np.float32):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), tree)


@pytest.fixture(scope="module")
def tree():
    """The port's initial parameters, in the JAX package's layouts."""
    return T._init_tree(0)


@pytest.fixture(scope="module")
def fragment():
    """A fragment of the synthetic scene as the port assembles it (the
    views, projections, origin; JAX's assembly is held to it in
    ``test_torch_neural_recon.py``), random hidden crops and the level
    targets."""
    ds = SyntheticDataset(n_frames=8, height=48, width=64)
    algo = NeuralReconConfig(**SMOKE, model=T.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL)).setup(
        camera=ds.get_camera(), device=torch.device("cpu"))
    frames = []
    for i in range(4):
        _, rgb, depth, c2w = ds[i]
        f = Frame(fid=i, rgb=rgb, depth=depth, gt_pose=c2w, rot_rep="quat")
        f.set_pose(algo.finish_tracking(algo.dispatch_tracking(f)))
        frames.append(f)
    imgs, projs, origin, _, _ = algo._fragment_inputs(frames)
    rng = np.random.default_rng(7)
    hiddens = [rng.normal(size=(N_VOX // 2 ** (2 - i),) * 3 + (T.OUT_CHANNELS[i],)).astype(np.float32) * 0.1
               for i in range(3)]
    tsdf_t, occ_t = level_targets(algo.model.config, origin, scene_sdf_numpy("simple"), frames, ds.get_camera())
    return dict(imgs=imgs, projs=projs, origin=origin, hiddens=hiddens,
                tsdf_t=[t.numpy() for t in tsdf_t], occ_t=[t.numpy() for t in occ_t])


def _jax_model(tree, dtype):
    """A JAX NeuCon on ``tree`` (its own init draws ~100 random arrays op by op, ~35 s here)."""
    from xrdslam_tpu.models import neucon as J

    m = object.__new__(J.NeuCon)
    m.config = J.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL)
    m.params = _jax_tree(tree, dtype)
    return m


def _port_model(tree, dtype):
    m = T.NeuCon(T.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL), device="cpu")
    m.params = T.map_tree(lambda p, t: t.to(dtype), T.params_from_numpy(tree, "cpu"))
    return m


def test_backbone_matches_jax(tree):
    import jax

    from xrdslam_tpu.models import neucon as J

    imgs = np.random.default_rng(0).uniform(0, 255, (2, 48, 64, 3)).astype(np.float32)
    want = jax.jit(J.backbone2d_apply)(_jax_tree(tree["backbone"]), imgs)
    got = T.backbone2d_apply(T.params_from_numpy(tree, "cpu")["backbone"], torch.tensor(imgs))
    for g, w, c in zip(got, want, T.BACKBONE_CHANNELS):
        assert g.shape[1] == c
        _close(_cl(g), w, f"feat{c}", 1e-4)


def test_back_project_matches_jax():
    import jax

    from xrdslam_tpu.models import neucon as J

    rng = np.random.default_rng(1)
    V, h, w, C = 3, 12, 16, 24
    feats = rng.normal(size=(V, h, w, C)).astype(np.float32)
    K = np.array([[10.0, 0, 7.5], [0, 10.0, 5.5], [0, 0, 1]])
    projs = []
    for v in range(V):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * v, -0.1 * v, -0.5]
        w2c = np.linalg.inv(c2w)
        w2c[:3, :4] = K @ w2c[:3, :4]
        projs.append(w2c)
    projs = np.stack(projs).astype(np.float32)
    # in front of, behind and beside the cameras, and on the image border
    vox = np.concatenate([rng.uniform(-1, 1, (400, 3)) * [1, 1, 0] + [0, 0, 2],
                          rng.uniform(-3, 3, (400, 3)),
                          [[0.0, 0.0, -1.0], [-0.75, -0.55, 0.5]]]).astype(np.float32)
    want, wcount = jax.jit(J.back_project)(vox, feats, projs)
    got, gcount = T.back_project(torch.tensor(vox), torch.tensor(feats).permute(0, 3, 1, 2), torch.tensor(projs))
    np.testing.assert_array_equal(gcount.numpy(), np.asarray(wcount))
    assert 0 < int((np.asarray(wcount) > 0).sum()) < len(vox)
    _close(got.numpy(), want, "back_project", 1e-4)


def test_transposed_conv_and_down2_match_jax():
    import jax

    from xrdslam_tpu.models import neucon as J

    x = np.random.default_rng(2).normal(size=(8, 8, 8, 6)).astype(np.float32)
    p = {"w": np.random.default_rng(3).normal(size=(2, 2, 2, 6, 5)).astype(np.float32),
         "b": np.random.default_rng(4).normal(size=5).astype(np.float32)}
    xt = torch.tensor(x).permute(3, 0, 1, 2)[None]
    for name, jfn, tfn in (("up1", J._deconv3d, T._deconv3d), ("down1", J._down2, T._down2)):
        pt = T.params_from_numpy({"unet0": {name: p}}, "cpu")["unet0"][name]
        _close(_cl(tfn(pt, xt))[0], jax.jit(jfn)(_jax_tree(p), x), name, 1e-4)


@pytest.mark.parametrize("cr", [1.0, 0.25])
def test_unet_matches_jax(cr):
    import jax

    from xrdslam_tpu.models import neucon as J

    cin = 13
    p = jax.tree_util.tree_map(np.asarray, J.unet3d_init(jax.random.PRNGKey(1), cin, cr))
    x = np.random.default_rng(5).normal(size=(8, 8, 8, cin)).astype(np.float32)
    want = jax.jit(J.unet3d_apply)(_jax_tree(p), x)
    got = T.unet3d_apply(T.params_from_numpy({"unet0": p}, "cpu")["unet0"], torch.tensor(x).permute(3, 0, 1, 2)[None])
    assert got.shape[1] == int(96 * cr)
    _close(_cl(got)[0], want, f"unet cr {cr}", 1e-4)


def test_convgru_matches_jax():
    import jax

    from xrdslam_tpu.models import neucon as J

    p = jax.tree_util.tree_map(np.asarray, J.convgru_init(jax.random.PRNGKey(2), 24, 24))
    rng = np.random.default_rng(6)
    h, x = (rng.normal(size=(12, 12, 12, 24)).astype(np.float32) for _ in range(2))
    want = jax.jit(J.convgru_apply)(_jax_tree(p), h, x)
    pt = T.params_from_numpy({"gru0": p}, "cpu")["gru0"]
    cf = lambda a: torch.tensor(a).permute(3, 0, 1, 2)[None]  # noqa: E731
    _close(_cl(T.convgru_apply(pt, cf(h), cf(x)))[0], want, "convgru", 1e-4)


def _port_fragment(m, frag, dtype):
    to = lambda a: torch.tensor(np.asarray(a)).to(dtype)  # noqa: E731
    return m.fragment_step(m.params, to(frag["imgs"]), to(frag["projs"]), to(frag["origin"]),
                           [to(h) for h in frag["hiddens"]])


def _hold_fragment(got, want, rel):
    tsdf, occ, hid = got
    jt, jo, jh = (np.asarray(want[0]), np.asarray(want[1]), want[2])
    occ = occ.cpu().numpy()
    agree = float((occ == jo).mean())
    assert agree >= 0.999, f"occupancy agrees on {agree:.5f} of the voxels"
    both = occ & jo
    assert both.sum() > 100
    _close(tsdf.cpu().numpy()[both], jt[both], "tsdf", rel)
    for i, (g, w) in enumerate(zip(hid, jh)):
        _close(g.cpu().numpy(), w, f"hidden {i}", rel)


def test_fragment_step_matches_jax(tree, fragment):
    import jax

    f64 = {k: fragment[k] for k in ("imgs", "projs", "origin")}
    with jax.enable_x64(True):
        jm = _jax_model(tree, np.float64)
        # dispatched, not awaited: JAX computes while the port does
        want = jax.jit(jm.fragment_step)(jm.params, *(np.asarray(f64[k], np.float64) for k in ("imgs", "projs", "origin")),
                                         [np.asarray(h, np.float64) for h in fragment["hiddens"]], np.eye(4))
    got64 = _port_fragment(_port_model(tree, torch.float64), fragment, torch.float64)
    got32 = _port_fragment(_port_model(tree, torch.float32), fragment, torch.float32)
    want = jax.tree_util.tree_map(np.asarray, want)
    _hold_fragment(got64, want, 1e-9)
    _hold_fragment(got32, want, 1e-2)


def test_loss_and_gradients_match_jax(tree, fragment):
    import jax

    f = fragment
    args = [f["imgs"], f["projs"], f["origin"], f["hiddens"], np.eye(4), f["tsdf_t"], f["occ_t"]]
    with jax.enable_x64(True):
        jm = _jax_model(tree, np.float64)
        jargs = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), args)
        # dispatched, not awaited: JAX computes while the port does
        jloss, jgrad = jax.jit(jax.value_and_grad(jm.loss))(jm.params, *jargs)
    pm = _port_model(tree, torch.float64)
    targs = [torch.tensor(np.asarray(a, np.float64)) for a in args[:3]]
    targs += [[torch.tensor(np.asarray(h, np.float64)) for h in f["hiddens"]], None]
    targs += [[torch.tensor(np.asarray(t, np.float64)) for t in f[k]] for k in ("tsdf_t", "occ_t")]
    loss, grads = pm.value_and_grad(pm.params, *targs)
    jloss, jgrad = float(jloss), [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad)]
    assert abs(float(loss) - jloss) <= 1e-10 * abs(jloss), (float(loss), jloss)
    paths = [p for p, _ in T.leaves(pm.params)]
    assert len(paths) == len(jgrad) == len(grads)
    top = max(float(np.abs(g).max()) for g in jgrad)
    for p, g, w in zip(paths, grads, jgrad):
        g = T.to_jax_layout(p, g.numpy())
        err = float(np.abs(g - w).max())
        assert err <= 1e-7 * top, f"{'/'.join(p)}: {err:.3e} > 1e-7 x {top:.3e}"
        if float(np.abs(w).max()) > 1e-5 * top:
            _close(g, w, "/".join(p), 1e-6)


def test_layouts_and_the_converter(tree):
    import jax

    from xrdslam_tpu.models import neucon as J

    for p, a in T.leaves(tree):
        np.testing.assert_array_equal(T.to_jax_layout(p, T.to_torch_layout(p, a)), a)
    assert [p for p, _ in T.leaves(tree)] == [
        tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    m = T.NeuCon(T.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL, seed=1), device="cpu")
    first = m.params["unet2"]["up1"]["w"]
    neucon_params_from_jax(tree, m)
    assert m.params["unet2"]["up1"]["w"] is first  # in place
    for p, t in T.leaves(m.params):
        np.testing.assert_array_equal(T.to_jax_layout(p, t.numpy()), dict(T.leaves(tree))[p])
    # a transposed convolution's kernel is flipped on its spatial axes
    np.testing.assert_array_equal(first.numpy()[:, :, ::-1, ::-1, ::-1],
                                  np.transpose(tree["unet2"]["up1"]["w"], (3, 4, 0, 1, 2)))
    # the JAX model's own tree has the same paths and shapes (traced, not drawn)
    want = jax.eval_shape(lambda: J.NeuCon(J.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL)).params)
    assert [(p, a.shape) for p, a in T.leaves(tree)] == [(p, a.shape) for p, a in T.leaves(want)]


@pytest.mark.cuda
def test_cuda_fragment_step_matches_the_cpu(tree, fragment):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cpu = _port_fragment(_port_model(tree, torch.float32), fragment, torch.float32)
    runs = []
    for _ in range(2):
        m = T.NeuCon(T.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL), device="cuda")
        m.params = T.params_from_numpy(tree, "cuda")
        to = lambda a: torch.tensor(np.asarray(a)).cuda()  # noqa: E731
        runs.append(m.fragment_step(m.params, to(fragment["imgs"]), to(fragment["projs"]), to(fragment["origin"]),
                                    [to(h) for h in fragment["hiddens"]]))
    a, b = runs
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    _hold_fragment(a, (cpu[0].numpy(), cpu[1].numpy(), [h.numpy() for h in cpu[2]]), 1e-2)


@pytest.mark.cuda
def test_cuda_loss_and_gradients_match_the_cpu(tree, fragment):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    f = fragment
    out = {}
    for dev in ("cpu", "cuda"):
        m = T.NeuCon(T.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL), device=dev)
        m.params = T.params_from_numpy(tree, dev)
        to = lambda a: torch.tensor(np.asarray(a)).to(dev)  # noqa: E731
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
        out[dev] = m.value_and_grad(m.params, to(f["imgs"]), to(f["projs"]), to(f["origin"]),
                                    [to(h) for h in f["hiddens"]], None, [to(t) for t in f["tsdf_t"]],
                                    [to(t) for t in f["occ_t"]])
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic) == flags
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)), (float(lg), float(lc))
    assert all(torch.isfinite(g).all() for g in gg)
    # float32 gradients are ~1% (median) from their float64 values at these
    # random weights in either package (test_torch_neural_recon.py), so the
    # card's are held to 5e-2 of the largest entry of all
    top = max(float(g.abs().max()) for g in gc)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(gg, gc))
    assert err <= 5e-2 * top, (err, top)
