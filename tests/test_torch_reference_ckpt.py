"""The reference's torch checkpoints in the port against the JAX package's loaders.

The checkpoints are written here with the reference's layer names by
``tests/test_torch_convert.py``'s writers (the JAX package's own test of
its converters): DPVO's ``dpvo.pth`` with ``module.`` prefixes and an
``update.lmbda`` entry, NICE-SLAM's ``middle_fine.pt`` (the middle decoder
under ``coarse``, an encoder entry to skip) and ``coarse.pt``, and
Point-SLAM's ``middle_fine.pt``.

* ``utils/torch_convert``'s loaders give the JAX converters' trees, leaf for
  leaf (exactly), and its writers write the same state dicts back;
* a VONet loaded from the ``.pth`` gives JAX's ``extract_features`` (1e-4
  of the largest feature: float32 convolutions in another order through
  instance norms) and update outputs (1e-4 of the largest);
* NICE-SLAM with the decoders loaded: ``pretrained_available``,
  ``trainable_decoders``, ``geo_supervision``, the phase groups and the
  decoders equal JAX's, and one ``map_step`` equals JAX's
  (``tests/test_torch_niceslam.py``'s check, JAX in float64), the frozen
  decoders unchanged by it;
* Point-SLAM with the geometry decoder loaded: frozen, outside the
  decoder group, equal to JAX's, unchanged by one ``map_step`` that equals
  JAX's (``tests/test_torch_pointslam.py``'s check, its entries held to
  ``POINTSLAM_STEP_ATOL``, 2e-5 where that file's own case takes 1e-5:
  with this decoder frozen, the first iteration's colour-stage gradients
  of the two packages differ by up to 1.8e-5 of their leaf's largest
  entry, float32 sums in another order, and Adam's normalised steps carry
  such a share into the colour MLP's small entries: one entry of 6,656 in
  its first layer ends 1.16e-5 from JAX's);
* a file that does not convert leaves both models training from scratch.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_convert import _decoder_to_torch, _encoder_to_torch, _update_to_torch  # noqa: E402
from xrdslam_tpu.utils import torch_convert as jconvert  # noqa: E402
from xrdslam_tpu_torch.utils.param_tree import flatten_tree  # noqa: E402
from xrdslam_tpu_torch.models.conv_onet import MLPDecoder  # noqa: E402
from xrdslam_tpu_torch.models.vonet import VONet, VONetConfig  # noqa: E402
from xrdslam_tpu_torch.utils import torch_convert  # noqa: E402

POINTSLAM_STEP_ATOL = 2e-5


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


def _same_trees(got, want, what):
    a = flatten_tree(jax.tree_util.tree_map(np.asarray, got))
    b = flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(a) == sorted(b), what
    for k in b:
        assert a[k].dtype == np.float32, f"{what}: {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def _same_states(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# DPVO
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dpvo_pth(tmp_path_factory):
    """A ``dpvo.pth`` in the reference's layout (``module.`` prefixes, an
    ``update.lmbda``) of a random VONet's weights: (path, the tree, the
    state without the prefixes and lmbda)."""
    tree = VONet(VONetConfig(), seed=8).tree()
    state = {}
    _encoder_to_torch(state, "patchify.fnet", tree["fnet"])
    _encoder_to_torch(state, "patchify.inet", tree["inet"])
    _update_to_torch(state, tree["update"])
    ref = {"module." + k: v for k, v in state.items()}
    ref["module.update.lmbda"] = torch.zeros(1)
    path = str(tmp_path_factory.mktemp("dpvo") / "dpvo.pth")
    torch.save(ref, path)
    return path, tree, state


def test_dpvo_pth_loads_into_the_jax_tree(dpvo_pth, tmp_path):
    path, tree, state = dpvo_pth
    got = torch_convert.load_dpvo_weights(path)
    _same_trees(got, jconvert.load_dpvo_weights(path), "load_dpvo_weights")
    _same_trees(got, tree, "the written tree")
    back = str(tmp_path / "back.pth")
    torch_convert.save_dpvo_weights(back, got)
    _same_states(torch.load(back), state)


def test_vonet_from_the_pth_gives_jax_outputs(dpvo_pth):
    from xrdslam_tpu.models.vonet import VONet as JVONet, update_apply

    path, tree, _ = dpvo_pth
    net = VONet(VONetConfig(pretrained_path=path))
    assert net.loaded_from == path
    _same_trees(net.tree(), tree, "VONet")
    jparams = jax.tree_util.tree_map(jnp.asarray, jconvert.load_dpvo_weights(path))
    rng = np.random.default_rng(9)
    img = rng.uniform(size=(3, 48, 64)).astype(np.float32)
    for name, g, x in zip(("fmap", "imap"), net.extract_features(torch.from_numpy(img)),
                          JVONet.extract_features(jparams, jnp.asarray(img))):
        _close(g, x, name, 1e-4)
    E, E_real = 24, 20
    h, inp = rng.normal(scale=0.5, size=(2, E, 384)).astype(np.float32)
    corr = rng.normal(size=(E, 882)).astype(np.float32)
    pad = np.full(E - E_real, E)
    seg_kk = np.concatenate([rng.integers(0, 6, E_real), pad]).astype(np.int32)
    seg_ij = np.concatenate([rng.integers(0, 4, E_real), pad]).astype(np.int32)
    ix = np.concatenate([rng.integers(-1, E_real, E_real), np.full(E - E_real, -1)]).astype(np.int32)
    jx = np.concatenate([rng.integers(-1, E_real, E_real), np.full(E - E_real, -1)]).astype(np.int32)
    mask = np.arange(E) < E_real
    args = (h, inp, corr, seg_kk, seg_ij, ix, jx, mask)
    got = net.update(*(torch.from_numpy(a) for a in args), num_segments=E + 1)
    want = update_apply(jparams["update"], *args, num_segments=E + 1)
    for name, g, x in zip(("net", "delta", "weight"), got, want):
        _close(g, x, name, 1e-4)


# ---------------------------------------------------------------------------
# NICE-SLAM and Point-SLAM decoders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nice_files(tmp_path_factory):
    """NICE-SLAM's ``middle_fine.pt`` and ``coarse.pt`` in the reference's
    layout, of decoders drawn at full scale (not the 0.1x output layer of
    the initial ones): (middle_fine path, coarse path, the trees)."""
    gen = torch.Generator().manual_seed(12)
    trees = {"middle": MLPDecoder(32, generator=gen), "fine": MLPDecoder(64, generator=gen),
             "coarse": MLPDecoder(32, no_xyz=True, generator=gen)}
    with torch.no_grad():
        for dec in trees.values():
            dec.out.weight.mul_(10.0)
    trees = {k: torch_convert.decoder_tree(d) for k, d in trees.items()}
    d = tmp_path_factory.mktemp("nice")
    state = {}
    _decoder_to_torch(state, "decoder.coarse", trees["middle"])  # the middle decoder under its original name
    _decoder_to_torch(state, "decoder.fine", trees["fine"])
    state["encoder.ignored.weight"] = torch.zeros(2, 2)
    mf = str(d / "middle_fine.pt")
    torch.save({"model": state}, mf)
    cstate = {}
    _decoder_to_torch(cstate, "decoder", trees["coarse"])
    coarse = str(d / "coarse.pt")
    torch.save({"model": cstate}, coarse)
    return mf, coarse, trees


def test_nice_decoders_load_into_the_jax_trees(nice_files, tmp_path):
    mf, coarse, trees = nice_files
    got = torch_convert.load_nice_decoders(mf, coarse)
    _same_trees(got, jconvert.load_nice_decoders(mf, coarse), "load_nice_decoders")
    _same_trees(got, trees, "the written trees")
    back_mf, back_coarse = str(tmp_path / "mf.pt"), str(tmp_path / "c.pt")
    torch_convert.save_nice_decoders(back_mf, got, back_coarse)
    _same_trees(torch_convert.load_nice_decoders(back_mf, back_coarse), trees, "written back")


@pytest.fixture(scope="module")
def nice_case(nice_files):
    """``tests/test_torch_niceslam.py``'s two algorithms with the decoders
    loaded from the files."""
    from test_torch_niceslam import H, W, _algo_config
    from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.utils.from_jax import niceslam_params_from_jax

    mf, coarse, _ = nice_files
    paths = {"pretrained_decoders_middle_fine": mf, "pretrained_decoders_coarse": coarse}
    ds = JSyntheticDataset(n_frames=3, height=H, width=W)
    jcam = ds.get_camera()
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    jalgo = _algo_config("jax", model_kw=paths).setup(camera=jcam)
    algo = _algo_config("torch", model_kw=paths).setup(camera=cam, device="cpu")
    np_tree = jax.tree_util.tree_map(np.asarray, jalgo.model_params)
    niceslam_params_from_jax(np_tree, algo.model, jax.tree_util.tree_map(np.asarray, jalgo.model.frozen))
    frames = []
    for i in range(3):
        _, rgb, depth, pose = ds[i]
        frames.append(SimpleNamespace(rgb=np.asarray(rgb, np.float32), depth=np.asarray(depth, np.float32),
                                      c2w=np.asarray(pose, np.float32)))
    return SimpleNamespace(jalgo=jalgo, algo=algo, frames=frames, cam=cam)


def test_niceslam_with_the_decoders_loaded_is_jax(nice_case, nice_files, monkeypatch):
    from test_torch_niceslam import map_step_matches_jax

    jm, tm = nice_case.jalgo.model, nice_case.algo.model
    _, _, trees = nice_files
    assert tm.pretrained_available and jm.pretrained_available
    assert tm.trainable_decoders == jm.trainable_decoders == ["color"]
    assert not tm.geo_supervision and not jm.geo_supervision
    assert sorted(jm.frozen) == ["coarse", "fine", "middle"]
    for name in ("middle", "fine", "coarse"):
        _same_trees(torch_convert.decoder_tree(tm.decoders[name]), trees[name], name)
        _same_trees(jm.frozen[name], trees[name], f"jax {name}")
        assert not any(p.requires_grad for p in tm.decoders[name].parameters()), name
    assert tm.param_groups()["decoder"] == list(tm.decoders["color"].parameters())
    for stage in ("middle", "fine", "color", "coarse"):
        for optimize_pose in (False, True):
            coarse = stage == "coarse"
            want = nice_case.jalgo._phase_groups(stage, 1.0, optimize_pose, coarse)
            got = nice_case.algo._phase_groups(stage, 1.0, optimize_pose, coarse)
            assert sorted(got) == sorted(want)
            for g in want:
                for k in ("lr", "eps", "betas", "weight_decay", "max_norm"):
                    assert getattr(got[g], k) == getattr(want[g], k), (stage, g, k)

    def frozen_unchanged(model):
        for name in ("middle", "fine", "coarse"):
            _same_trees(torch_convert.decoder_tree(model.decoders[name]), trees[name], f"{name} after map_step")

    map_step_matches_jax(nice_case, monkeypatch, False, after=frozen_unchanged)


def test_point_slam_with_the_geo_decoder_loaded_is_jax(nice_files, monkeypatch):
    from test_torch_pointslam import make_case, map_step_matches_jax

    mf, _, trees = nice_files
    case = make_case(pretrained_decoders_middle_fine=mf)
    jm, tm = case.jalgo.model, case.algo.model
    assert tm.pretrained_available and jm.pretrained_available and tm.fixed_geo
    assert sorted(jm.frozen) == ["geo"] and "geo" not in case.jalgo.model_params["decoder"]
    _same_trees(torch_convert.decoder_tree(tm.geo_decoder), trees["middle"], "geo")
    _same_trees(jm.frozen["geo"], trees["middle"], "jax geo")
    geo = set(map(id, tm.geo_decoder.parameters()))
    assert not any(id(p) in geo for p in tm.param_groups()["decoder"])
    assert not any(p.requires_grad for p in tm.geo_decoder.parameters())
    map_step_matches_jax(case, monkeypatch, atol=POINTSLAM_STEP_ATOL, after=lambda model: _same_trees(
        torch_convert.decoder_tree(model.geo_decoder), trees["middle"], "geo after map_step"))


def test_a_file_that_does_not_convert_trains_from_scratch(tmp_path, capsys):
    from xrdslam_tpu_torch.models.conv_onet import ConvOnet, ConvOnetConfig
    from xrdslam_tpu_torch.models.conv_onet_pointslam import ConvOnet2, ConvOnet2Config

    stub = tmp_path / "middle_fine.pt"
    stub.write_text("version https://git-lfs.github.com/spec/v1\n")  # a file stored as a pointer
    bound = np.array([[-1.0, 1.0]] * 3, np.float32)
    nice = ConvOnet(ConvOnetConfig(pretrained_decoders_middle_fine=stub), None, bound)
    assert not nice.pretrained_available and nice.geo_supervision
    assert nice.trainable_decoders == ["color", "middle", "fine"]
    point = ConvOnet2(ConvOnet2Config(max_points=64, pretrained_decoders_middle_fine=stub), None)
    assert not point.pretrained_available and not point.fixed_geo
    assert all(p.requires_grad for p in point.geo_decoder.parameters())
    out = capsys.readouterr().out
    assert "training decoders from scratch" in out and "training from scratch" in out
