"""DPVO's ops and network in the port against the JAX package.

The same numpy inputs, made from a seed, go to the JAX function and its
port: the projective ops (``reproject`` with and without ``tonly``,
``point_cloud``, ``flow_mag``), the correlation (``bilinear_sample`` with
points outside the map, ``patch_correlation`` chunked and unchunked,
``extract_patches``), ``bundle_adjust`` on a scene of ``tests/test_ba.py``'s
kind (4 frames, 24 patches) and on a system that is not positive definite,
and VONet on the committed trained weights (``pretrained/dpvo_synth.npz``,
loaded by each package's ``load_params``): ``extract_features`` at 64x80
and ``update_apply`` with padded edges at the reserved segment.

Tolerances: the projective ops to 1e-5 of the largest value (pixels of
~100); the correlation to 1e-5 of the largest (the port sums each tap's
dot product, the reference the blend's); the bundle adjuster's poses to
1e-5 and depths to 1e-4 (two Gauss-Newton steps through two Cholesky
solves of a 24 x 24 system); the encoders to 1e-4 of the largest feature
(float32 convolutions in another order, through instance norms); the
update operator's outputs to 1e-4 of the largest.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.ops import ba as jba, correlation as jcorr, lie as jlie, projective as jproj  # noqa: E402
from xrdslam_tpu_torch.ops import ba, correlation, lie, projective  # noqa: E402

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "pretrained", "dpvo_synth.npz")


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


def _t(a):
    return torch.as_tensor(np.array(a))


def _poses(rng, n):
    """n world-to-camera poses near the identity: t [n, 3], q [n, 4]."""
    r = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    q = np.asarray(jlie.axis_angle_to_quaternion(jnp.asarray(r)), np.float32)
    t = rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    return t, q


def test_lie_quaternions_and_se3_exp():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 7, 4)).astype(np.float32)
    v = rng.normal(size=(7, 3)).astype(np.float32)
    xi = np.concatenate([rng.normal(size=(7, 6)), np.zeros((1, 6))]).astype(np.float32)
    _close(lie.quaternion_multiply(_t(a), _t(b)), jlie.quaternion_multiply(a, b), "quaternion_multiply", 1e-6)
    _close(lie.quaternion_rotate(_t(a), _t(v)), jlie.quaternion_rotate(a, v), "quaternion_rotate", 1e-6)
    _close(lie.se3_exp(_t(xi)), jlie.se3_exp(xi), "se3_exp", 1e-6)


@pytest.mark.parametrize("tonly", [False, True])
def test_reproject(tonly):
    rng = np.random.default_rng(1)
    t, q = _poses(rng, 5)
    intr = np.array([60.0, 60.0, 40.0, 30.0], np.float32)
    E = 40
    uvd = np.concatenate([rng.uniform(0, 80, (E, 3, 3, 2)), rng.uniform(0.2, 2.0, (E, 3, 3, 1))], -1)
    uvd = uvd.astype(np.float32)
    ii, jj = rng.integers(0, 5, E), rng.integers(0, 5, E)
    got = projective.reproject(_t(t), _t(q), _t(uvd), _t(intr), _t(ii), _t(jj), tonly=tonly)
    want = jproj.reproject(t, q, uvd, intr, ii, jj, tonly=tonly)
    _close(got, want, f"reproject tonly={tonly}", 1e-5)


def test_point_cloud_and_flow_mag():
    rng = np.random.default_rng(2)
    t, q = _poses(rng, 4)
    intr = np.array([60.0, 60.0, 40.0, 30.0], np.float32)
    E = 30
    uvd = np.concatenate([rng.uniform(0, 80, (E, 2)), rng.uniform(0.2, 2.0, (E, 1))], -1).astype(np.float32)
    ii, jj = rng.integers(0, 4, E), rng.integers(0, 4, E)
    _close(projective.point_cloud(_t(t), _t(q), _t(uvd), _t(intr), _t(ii)),
           jproj.point_cloud(t, q, uvd, intr, ii), "point_cloud", 1e-5)
    _close(projective.flow_mag(_t(t), _t(q), _t(uvd[:, None]), _t(intr), _t(ii), _t(jj)),
           jproj.flow_mag(t, q, uvd[:, None], intr, ii, jj), "flow_mag", 1e-5)


def test_bilinear_sample_outside_the_map():
    rng = np.random.default_rng(3)
    fmap = rng.normal(size=(5, 9, 11)).astype(np.float32)
    # inside, on the last row and column, half out and fully out of the map
    pts = np.concatenate([rng.uniform(-2.0, 12.0, (60, 2)),
                          [[10.0, 8.0], [10.5, 3.2], [-0.5, 4.0], [3.0, -0.7], [-5.0, -5.0], [11.0, 9.0]]])
    pts = pts.astype(np.float32)
    got = correlation.bilinear_sample(_t(fmap), _t(pts))
    _close(got, jcorr.bilinear_sample(fmap, pts), "bilinear_sample", 1e-6)
    assert float(got[-2].abs().max()) == 0.0 and float(got[-1].abs().max()) == 0.0


def test_patch_correlation_chunked_and_extract_patches():
    rng = np.random.default_rng(4)
    F_, C, H, W, E = 3, 16, 12, 14, 64
    fmaps = rng.normal(size=(F_, C, H, W)).astype(np.float32)
    centers = rng.uniform(-1.0, 14.0, (E, 2)).astype(np.float32)
    gp = np.asarray(jcorr.extract_patches(fmaps[0], centers, p=3))
    _close(correlation.extract_patches(_t(fmaps[0]), _t(centers), p=3), gp, "extract_patches", 1e-6)
    d = np.arange(3, dtype=np.float32) - 1.0
    dy, dx = np.meshgrid(d, d, indexing="ij")
    coords = (centers[:, None, None] + np.stack([dx, dy], -1) + rng.normal(scale=2.0, size=(E, 1, 1, 2)))
    coords = coords.astype(np.float32)
    jj = rng.integers(0, F_, E).astype(np.int32)
    jf = jnp.asarray(fmaps)
    want = np.asarray(jcorr.patch_correlation_chunked(jf, gp, coords, jj, radius=3, chunk=16))
    for chunk in (16, 24, 64):  # 24: a shorter last chunk
        got = correlation.patch_correlation_chunked(_t(fmaps), _t(gp), _t(coords), _t(jj), radius=3, chunk=chunk)
        _close(got, want, f"patch_correlation chunk={chunk}", 1e-5)
    _close(correlation.patch_correlation(_t(fmaps), _t(gp), _t(coords), _t(jj), radius=3), want,
           "patch_correlation", 1e-5)


def _ba_scene(seed=0, n_frames=4, n_patches=24):
    """tests/test_ba.py's scene: points seen from a moving camera, exact
    targets; then the poses and depths perturbed."""
    rng = np.random.RandomState(seed)
    intr = np.array([120.0, 120.0, 80.0, 60.0], np.float32)
    pts_w = rng.rand(n_patches, 3) * np.array([2, 2, 1]) + np.array([-1, -1, 3.0])
    ts, qs, Rs = [], [], []
    for i in range(n_frames):
        t = np.array([0.1 * i, 0.02 * i, 0.0])
        R = np.asarray(jlie.axis_angle_to_matrix(jnp.asarray([0.0, 0.01 * i, 0.0])), np.float64)
        ts.append(-R @ t)
        qs.append(np.asarray(jlie.matrix_to_quaternion(jnp.asarray(R))))
        Rs.append(R)

    def pix(f, p):
        pc = Rs[f] @ p + ts[f]
        return [intr[0] * pc[0] / pc[2] + intr[2], intr[1] * pc[1] / pc[2] + intr[3]], pc[2]

    patches = np.array([pix(0, p)[0] + [1.0 / pix(0, p)[1]] for p in pts_w], np.float32)
    ii, jj, kk, tg = [], [], [], []
    for f in range(n_frames):
        for k in range(n_patches):
            ii.append(0), jj.append(f), kk.append(k), tg.append(pix(f, pts_w[k])[0])
    t = np.array(ts, np.float32) + rng.normal(scale=0.01, size=(n_frames, 3)).astype(np.float32) * (
        np.arange(n_frames) > 0)[:, None]
    patches[:, 2] *= (1.0 + 0.1 * rng.uniform(-1, 1, n_patches)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (len(ii), 2)).astype(np.float32)
    return (t, np.array(qs, np.float32), patches, np.array(tg, np.float32), w, np.array(ii), np.array(jj),
            np.array(kk), intr)


def test_bundle_adjust_against_jax():
    t, q, patches, tg, w, ii, jj, kk, intr = _ba_scene()
    mask = np.ones(len(ii), np.float32)
    mask[-5:] = 0.0  # padded edges
    got = ba.bundle_adjust(_t(t), _t(q), _t(patches), _t(tg), _t(w), _t(ii), _t(jj), _t(kk), _t(intr), t0=1,
                           iterations=2, edge_mask=_t(mask))
    want = jba.bundle_adjust(t, q, patches, tg, w, ii, jj, kk, intr, t0=1, iterations=2, edge_mask=mask)
    for name, g, x, rel in zip(("poses_t", "poses_q", "patches"), got, want, (1e-5, 1e-5, 1e-4)):
        _close(g, x, f"bundle_adjust {name}", rel)
    assert not np.allclose(np.asarray(got[0]), t)  # it moved


def test_bundle_adjust_not_positive_definite():
    """Each edge's weight is negative in one coordinate, so the reduced
    system is indefinite: the reference's Cholesky solve gives NaN and it
    takes no pose step; neither may the port (cholesky_ex's ``info``)."""
    t, q, patches, tg, w, ii, jj, kk, intr = _ba_scene(seed=1)
    w[:, 0] = -50.0
    mask = np.ones(len(ii), np.float32)
    got = ba.bundle_adjust(_t(t), _t(q), _t(patches), _t(tg), _t(w), _t(ii), _t(jj), _t(kk), _t(intr), t0=1,
                           iterations=2, edge_mask=_t(mask))
    want = jba.bundle_adjust(t, q, patches, tg, w, ii, jj, kk, intr, t0=1, iterations=2, edge_mask=mask)
    np.testing.assert_array_equal(np.asarray(want[0]), t)  # JAX took no step
    _close(got[0], want[0], "poses_t", 1e-6)
    _close(got[1], want[1], "poses_q", 1e-6)
    _close(got[2], want[2], "patches", 1e-5)


@pytest.fixture(scope="module")
def weights():
    from xrdslam_tpu.engine.dpvo_train import load_params as jload
    from xrdslam_tpu_torch.engine.dpvo_train import load_params
    from xrdslam_tpu_torch.models.vonet import VONet, VONetConfig

    if not os.path.exists(WEIGHTS):
        pytest.fail(f"the trained DPVO weights are missing at {WEIGHTS}")
    net = VONet(VONetConfig())
    net.load_tree(load_params(WEIGHTS))
    return jload(WEIGHTS), net


def test_vonet_checkpoint_round_trip(weights, tmp_path):
    from xrdslam_tpu_torch.engine.dpvo_train import load_params, save_params
    from xrdslam_tpu_torch.models.vonet import VONet, VONetConfig

    _, net = weights
    path = str(tmp_path / "w.npz")
    save_params(path, net.tree())
    back = VONet(VONetConfig(pretrained_path=path))
    assert back.loaded_from == path
    for (k, a), b in zip(net.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k
    assert sorted(load_params(path)) == ["fnet", "inet", "update"]


def test_extract_features(weights):
    from xrdslam_tpu.models.vonet import VONet as JVONet

    jparams, net = weights
    img = np.random.default_rng(5).uniform(size=(3, 64, 80)).astype(np.float32)
    got = net.extract_features(_t(img))
    want = JVONet.extract_features(jparams, jnp.asarray(img))
    for name, g, x in zip(("fmap", "imap"), got, want):
        assert g.shape == (x.shape[0], 16, 20)
        _close(g, x, name, 1e-4)


def test_update_apply_with_padded_edges(weights):
    from xrdslam_tpu.models.vonet import update_apply

    jparams, net = weights
    rng = np.random.default_rng(6)
    E, E_real = 48, 40
    h = rng.normal(scale=0.5, size=(E, 384)).astype(np.float32)
    inp = rng.normal(scale=0.5, size=(E, 384)).astype(np.float32)
    corr = rng.normal(size=(E, 882)).astype(np.float32)
    kk, jj = rng.integers(0, 12, E_real), rng.integers(0, 5, E_real)
    ii = kk // 4
    _, seg_kk = np.unique(kk, return_inverse=True)
    _, seg_ij = np.unique(ii * 100003 + jj, return_inverse=True)
    pad = np.full(E - E_real, E)
    seg_kk, seg_ij = np.concatenate([seg_kk, pad]).astype(np.int32), np.concatenate([seg_ij, pad]).astype(np.int32)
    ix = np.concatenate([rng.integers(-1, E_real, E_real), np.full(E - E_real, -1)]).astype(np.int32)
    jx = np.concatenate([rng.integers(-1, E_real, E_real), np.full(E - E_real, -1)]).astype(np.int32)
    mask = np.arange(E) < E_real
    got = net.update(_t(h), _t(inp), _t(corr), _t(seg_kk), _t(seg_ij), _t(ix), _t(jx), _t(mask), num_segments=E + 1)
    want = update_apply(jparams["update"], h, inp, corr, seg_kk, seg_ij, ix, jx, mask, num_segments=E + 1)
    for name, g, x in zip(("net", "delta", "weight"), got, want):
        _close(g, x, name, 1e-4)
    assert float(got[0][E_real:].abs().max()) == 0.0 and float(got[2][E_real:].abs().max()) == 0.0
