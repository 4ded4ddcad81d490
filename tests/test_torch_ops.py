"""Op parity of the port against the JAX package on the same numpy inputs:
Lie conversions, OneBlob, z sampling (the jitter drawn once and given to
both), SDF rendering, the losses, the MLP and the camera rays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.common.camera import Camera as JCamera  # noqa: E402
from xrdslam_tpu.ops import encodings as jenc, lie as jlie, losses as jlosses, mlp as jmlp  # noqa: E402
from xrdslam_tpu.ops import rendering as jrend, sampling as jsamp  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.ops import encodings as tenc, lie as tlie, losses as tlosses, mlp as tmlp  # noqa: E402
from xrdslam_tpu_torch.ops import rendering as trend, sampling as tsamp  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def T(a):
    return torch.tensor(np.asarray(a))


def _rotvecs(rng, n=64):
    r = rng.standard_normal((n, 3)).astype(np.float32)
    r[:8] *= 1e-5  # small-angle (Taylor) branch
    r[8] = 0.0
    r[9:16] *= 3.0 / np.linalg.norm(r[9:16], axis=1, keepdims=True)  # near pi
    return r


def test_axis_angle_to_matrix_and_grad():
    r = _rotvecs(np.random.default_rng(0))
    np.testing.assert_allclose(tlie.axis_angle_to_matrix(T(r)).numpy(),
                               np.asarray(jlie.axis_angle_to_matrix(jnp.asarray(r))), atol=1e-6, rtol=0)
    w = np.random.default_rng(1).standard_normal((64, 3, 3)).astype(np.float32)
    gj = jax.grad(lambda v: jnp.sum(jlie.axis_angle_to_matrix(v) * w))(jnp.asarray(r))
    rt = T(r).requires_grad_(True)
    torch.sum(tlie.axis_angle_to_matrix(rt) * T(w)).backward()
    assert torch.isfinite(rt.grad).all()  # no NaN from the unselected Taylor branch, also at r = 0
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(gj), atol=1e-5, rtol=0)


def test_matrix_to_axis_angle():
    R = np.asarray(jlie.axis_angle_to_matrix(jnp.asarray(_rotvecs(np.random.default_rng(2)))))
    np.testing.assert_allclose(tlie.matrix_to_axis_angle(T(R)).numpy(),
                               np.asarray(jlie.matrix_to_axis_angle(jnp.asarray(R))), atol=1e-5, rtol=0)


def test_oneblob():
    x = np.random.default_rng(3).uniform(-0.1, 1.1, (200, 3)).astype(np.float32)
    np.testing.assert_allclose(tenc.oneblob_encode(T(x), 16).numpy(),
                               np.asarray(jenc.oneblob_encode(jnp.asarray(x), 16)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("perturb", [False, True])
def test_coslam_z_vals(perturb):
    rng = np.random.default_rng(4)
    td = rng.uniform(0.3, 4.0, (128, 1)).astype(np.float32)
    td[::7] = 0.0  # invalid depth: uniform fallback
    key = jax.random.PRNGKey(5)
    want = np.asarray(jsamp.coslam_z_vals(key, jnp.asarray(td), 128, 0.0, 5.0, 32, 0.1, 11, perturb))
    # the JAX jitter is uniform(key, z_vals.shape); hand the same draw to the port
    noise = T(np.asarray(jax.random.uniform(key, (128, 43)))) if perturb else None
    got = tsamp.coslam_z_vals(T(td), 128, 0.0, 5.0, 32, 0.1, 11, perturb, noise=noise).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_camera_ray_dirs():
    kw = dict(fx=50.0, fy=52.0, cx=29.5, cy=19.5, height=40, width=60)
    np.testing.assert_allclose(tsamp.camera_ray_dirs(Camera(**kw)).numpy(),
                               np.asarray(jsamp.camera_ray_dirs(JCamera(**kw))), atol=1e-6, rtol=0)


def _render_case(rng, n=96, s=43):
    z = np.sort(rng.uniform(0.0, 5.0, (n, s)), axis=1).astype(np.float32)
    surf = rng.uniform(0.5, 4.5, (n, 1))
    sdf = np.clip((surf - z) / 0.3, -3, 3).astype(np.float32)  # one sign change per ray
    sdf[:10] = np.abs(sdf[:10]) + 0.1  # rays with no crossing
    raw = np.concatenate([rng.standard_normal((n, s, 3)).astype(np.float32), sdf[..., None]], -1)
    return raw, z


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_sdf(white_bkgd):
    raw, z = _render_case(np.random.default_rng(6))
    want = jrend.raw2outputs_sdf(jnp.asarray(raw), jnp.asarray(z), 0.1, 1.0, white_bkgd)
    got = trend.raw2outputs_sdf(T(raw), T(z), 0.1, 1.0, white_bkgd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_losses(masked):
    rng = np.random.default_rng(7)
    n, s = 96, 43
    _, z = _render_case(rng, n, s)
    td = rng.uniform(0.0, 4.0, (n, 1)).astype(np.float32)
    td[::5] = 0.0
    sdf = rng.standard_normal((n, s)).astype(np.float32)
    rgb, trgb = rng.uniform(size=(n, 3)).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32)
    depth = rng.uniform(0, 4, n).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else T(mask)
    pairs = [
        (jlosses.sdf_losses(jnp.asarray(z), jnp.asarray(td), jnp.asarray(sdf), 0.1, ray_mask=jm),
         tlosses.sdf_losses(T(z), T(td), T(sdf), 0.1, ray_mask=tm)),
        (jlosses.rgb_depth_losses(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(trgb), jnp.asarray(td),
                                  100.0, 0.05, jm),
         tlosses.rgb_depth_losses(T(rgb), T(depth), T(trgb), T(td), 100.0, 0.05, tm)),
        (jlosses.sdf_masks(jnp.asarray(z), jnp.asarray(td), 0.1, jm), tlosses.sdf_masks(T(z), T(td), 0.1, tm)),
        ((jlosses.masked_mean(jnp.asarray(depth), jm),), (tlosses.masked_mean(T(depth), tm),)),
    ]
    for want, got in pairs:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_smoothness_tv():
    grid = np.random.default_rng(8).standard_normal((7, 7, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(tlosses.smoothness_tv(T(grid), 8).item(),
                               float(jlosses.smoothness_tv(jnp.asarray(grid), 8)), rtol=1e-6)


def test_mlp_matches_jax_layout():
    dims = [80, 32, 16]
    params = jmlp.mlp_init(jax.random.PRNGKey(9), dims)
    net = tmlp.MLP(dims)
    with torch.no_grad():
        for layer, w in zip(net.layers, params["w"]):
            layer.weight.copy_(T(np.asarray(w).T))
    x = np.random.default_rng(10).standard_normal((50, 80)).astype(np.float32)
    np.testing.assert_allclose(net(T(x)).detach().numpy(), np.asarray(jmlp.mlp_apply(params, jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    assert all(layer.bias is None for layer in net.layers)
