"""SplaTAM's clone/split densification and device-count growth in the port,
against the JAX package.

The same numpy inputs go to both packages (the JAX rasterizer's Pallas
kernels in interpret mode, as ``tests/test_splatam_densify.py`` runs them);
split noise is fed from numpy into both (``jax.random.normal`` patched to
return it). Tolerances:

* ``append_rows``, the growth at a full table and the median of the
  growth mask: exact, but for a split's jittered means, within 4e-7 (one
  ulp at the scene's ~2 m): XLA sums the rotated offset's three products
  with fused multiply-adds, torch rounds each product;
* the screen-space gradient (``render(..., duv=)``): 1e-4 relative, sums in
  another order;
* a densifying ``map_step`` at ``n_valid = 1`` on the same binning: the
  count and the dead mask exact, the losses to 1e-4 relative, the table
  within ``test_torch_splatam.py``'s rule for a mapping call (entries off
  by more than 1e-5 under 0.1%, none by more than Adam's 2 n_iters lr).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.experimental.pallas as pl  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.algorithms.splatam import SplaTAMConfig as JSplaTAMConfig  # noqa: E402
from xrdslam_tpu.common.frame import Frame as JFrame  # noqa: E402
from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset  # noqa: E402
from xrdslam_tpu.configs.registry import algorithm_configs as jconfigs  # noqa: E402
from xrdslam_tpu.models.gaussian_splatting import GaussianSplattingConfig as JGSConfig  # noqa: E402
from xrdslam_tpu_torch.algorithms.splatam import SplaTAMConfig, median_of_positive  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.models.gaussian_splatting import GAUSS_GROUPS, GaussianSplattingConfig  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import gaussian_params_from_jax  # noqa: E402

H, W = 32, 48
NTX, NTY = W // 16, H // 16
G = 40_000  # > 32,768 rows: the JAX scatter takes its exact fp32 branch
N_ITERS = 5
# densify at iterations 2 and 4 of a 5-iteration call
DENSIFY = dict(start_after=1, remove_big_after=0, stop_after=100, densify_every=2, grad_thresh=1e-8,
               num_to_split_into=2, removal_opacity_threshold=0.005, final_removal_opacity_threshold=0.005,
               reset_opacities_every=10**9)
LRS = {k: v["optimizer"].lr for k, v in algorithm_configs["splaTAM"].xrdslam.algorithm.optimizers.items()}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture()
def interp_kernels(monkeypatch):
    import xrdslam_tpu.ops.gaussian_raster as gr
    import xrdslam_tpu.ops.pallas_scatter as ps

    orig = pl.pallas_call
    monkeypatch.setattr(gr.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(ps.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _feed_noise(monkeypatch, noise: np.ndarray) -> None:
    """Every ``jax.random.normal`` draw returns ``noise``."""
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise).reshape(shape))


def _close(got, want, what, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


@pytest.fixture(scope="module")
def case():
    """Both algorithms (densification on), frame 1, and a perturbed map grown
    on frame 0: means jittered (no depth ties in the binning's sort), a
    third of the scales small (cloned, the rest split), opacities spread."""
    ds = JSyntheticDataset(n_frames=2, height=H, width=W)
    jcam = ds.get_camera()
    common = dict(rot_rep="quat", tracking_n_iters=3, mapping_n_iters=N_ITERS, mapping_first_n_iters=N_ITERS,
                  mapping_window_size=2, mapping_use_gaussian_splatting_densification=True)
    jalgo = JSplaTAMConfig(model=JGSConfig(max_gaussians=G, k_per_tile=48, mapping_densify_dict=dict(DENSIFY)),
                           **common, optimizers=jconfigs["splaTAM"].xrdslam.algorithm.optimizers).setup(camera=jcam)
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    algo = SplaTAMConfig(model=GaussianSplattingConfig(max_gaussians=G, k_per_tile=48,
                                                       mapping_densify_dict=dict(DENSIFY)),
                         **common, optimizers=algorithm_configs["splaTAM"].xrdslam.algorithm.optimizers).setup(
        camera=cam, device="cpu")
    frames = []
    for i in (0, 1):
        _, rgb, depth, pose = ds[i]
        rgb = np.array(JFrame(fid=i, rgb=rgb, depth=depth).rgb_jax())  # the uint16 round trip
        frames.append(SimpleNamespace(rgb=rgb, depth=np.asarray(depth, np.float32), c2w=np.asarray(pose, np.float32)))
    f0 = frames[0]
    params, dead, count = jalgo._grow_fn_raw(jalgo.params, jalgo.dead, jnp.asarray(0, jnp.int32),
                                             jnp.asarray(f0.rgb), jnp.asarray(f0.depth), jnp.asarray(f0.c2w),
                                             first=True, ntx=NTX, nty=NTY)
    params = jax.tree_util.tree_map(np.array, params)
    dead, count = np.array(dead), int(count)
    rng = np.random.default_rng(0)
    params["means3D"][:count] += rng.normal(0, 2e-3, (count, 3)).astype(np.float32)
    params["logit_opacities"] = rng.normal(3.0, 1.0, params["logit_opacities"].shape).astype(np.float32)
    params["logit_opacities"][:count:97] = -8.0  # under the removal threshold
    params["log_scales"][:count:3] = np.log(0.004)  # small: cloned
    params["log_scales"][:count:131] = 0.0  # bigger than 0.1 scene radius: removed
    params["unnorm_rotations"][:count] = rng.normal(0, 1, (count, 4)).astype(np.float32)
    params["rgb_colors"] = np.clip(params["rgb_colors"] + rng.normal(0, 0.05, (G, 3)), 0, 1).astype(np.float32)
    radius = float(f0.depth.max() / 3.0)
    for m in (jalgo.model, algo.model):
        m.scene_radius = radius
        m.n_gauss = count
    return SimpleNamespace(jalgo=jalgo, algo=algo, frames=frames, params=params, dead=dead, count=count,
                           noise=rng.standard_normal((G, 3)).astype(np.float32))


def _jax_params(case):
    return jax.tree_util.tree_map(jnp.asarray, case.params)


def _torch_state(case):
    params, dead, count = gaussian_params_from_jax(case.params, "cpu", case.dead, case.count)
    return params, dead, torch.tensor(count)


def _jax_bin(case, w2c):
    tiles, mask = case.jalgo._bin_jit(case.params, case.dead, jnp.asarray(case.count, jnp.int32), jnp.asarray(w2c))
    return np.array(tiles), np.array(mask)


@pytest.mark.parametrize("how", ["clone", "split"])
def test_append_rows_matches_jax(case, how, monkeypatch):
    _feed_noise(monkeypatch, case.noise)
    rng = np.random.default_rng(1)
    mask = (rng.uniform(size=G) < 0.3) & (np.arange(G) < case.count)
    kw = {} if how == "clone" else dict(repeat=2, scale_div=1.6)
    count = G - 700 if how == "clone" else case.count  # the clone overflows the table: rows past its end dropped
    jp, jdead, jcount = case.jalgo.model.append_rows(_jax_params(case), jnp.asarray(case.dead), jnp.asarray(count),
                                                     jnp.asarray(mask), key=jax.random.PRNGKey(0), **kw)
    params, dead, _ = _torch_state(case)
    tp, tdead, tcount = case.algo.model.append_rows(params, dead, torch.tensor(count), torch.from_numpy(mask),
                                                    noise=torch.from_numpy(case.noise), **kw)
    assert int(tcount) == int(jcount) == min(count + mask.sum() * (1 if how == "clone" else 2), G)
    np.testing.assert_array_equal(tdead.numpy(), np.asarray(jdead))
    for k in GAUSS_GROUPS:
        if how == "split" and k == "means3D":
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=4e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)


def test_screen_gradient_matches_jax(case):
    """d loss / d duv, the densification signal, in both packages."""
    f = case.frames[1]
    w2c = np.linalg.inv(f.c2w).astype(np.float32)
    tiles, mask = _jax_bin(case, w2c)
    jm, m = case.jalgo.model, case.algo.model
    jalive = jm.alive_mask(jnp.asarray(case.dead), case.count)

    def jloss(duv):
        out = jm.render(_jax_params(case), jalive, jnp.asarray(w2c), (jnp.asarray(tiles), jnp.asarray(mask)), NTX,
                        NTY, duv=duv)
        return jm.get_loss(out, jnp.asarray(f.rgb), jnp.asarray(f.depth), True)

    want = jax.grad(jloss)(jnp.zeros((G, 2), jnp.float32))
    params, dead, count = _torch_state(case)
    duv = torch.zeros((G, 2), requires_grad=True)
    out = m.render(params, m.alive_mask(dead, count), torch.from_numpy(w2c),
                   (torch.from_numpy(tiles), torch.from_numpy(mask)), NTX, NTY, duv=duv)
    (got,) = torch.autograd.grad(m.get_loss(out, torch.from_numpy(f.rgb), torch.from_numpy(f.depth), True), [duv])
    assert (np.abs(np.asarray(want)).sum(1) > 0).sum() > 100
    _close(got.numpy(), want, "d loss / d duv")


@pytest.mark.parametrize("n", [0, 1, 6, 7])
def test_median_of_positive_matches_jax(n):
    """The growth mask's median depth error: jnp.nanmedian of the positive
    entries (0 when there is none), odd and even counts."""
    rng = np.random.default_rng(n)
    x = np.zeros(50, np.float32)
    x[rng.choice(50, n, replace=False)] = rng.uniform(0.1, 2.0, n).astype(np.float32)
    want = jnp.nanmedian(jnp.where(x > 0, x, jnp.nan))
    want = float(jnp.where(jnp.isfinite(want), want, 0.0))
    assert float(median_of_positive(torch.from_numpy(x))) == want


def test_grow_step_drops_rows_past_the_table_as_jax(case):
    """Growth at a nearly full table: the count stops at the capacity and
    the rows past the end are dropped, in both packages."""
    f = case.frames[1]
    count = G - 300
    jp, jdead, jcount = case.jalgo._grow_fn_raw(_jax_params(case), jnp.asarray(case.dead),
                                                jnp.asarray(count, jnp.int32), jnp.asarray(f.rgb), jnp.asarray(f.depth),
                                                jnp.asarray(f.c2w), first=True, ntx=NTX, nty=NTY)
    params, dead, _ = _torch_state(case)
    params, dead, new = case.algo.grow_step(params, dead, torch.tensor(count), torch.from_numpy(f.rgb),
                                            torch.from_numpy(f.depth), torch.from_numpy(f.c2w), True)
    assert int(new) == int(jcount) == G
    np.testing.assert_array_equal(dead.numpy(), np.asarray(jdead))
    for k in GAUSS_GROUPS:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), atol=1e-5, rtol=1e-6, err_msg=k)


def test_densifying_map_step_matches_jax(case, interp_kernels, monkeypatch):
    _feed_noise(monkeypatch, case.noise)
    f = case.frames[1]
    w2c = np.linalg.inv(f.c2w).astype(np.float32)
    tiles, mask = _jax_bin(case, w2c)
    image = np.concatenate([f.rgb, f.depth[..., None]], -1)[None]
    jfn = jax.jit(functools.partial(case.jalgo._map_step_raw, n_iters=N_ITERS, ntx=NTX, nty=NTY, densify=True))
    jp, jdead, jcount, jlosses = jfn(case.params, case.dead, jnp.asarray(case.count, jnp.int32), jnp.asarray(image),
                                     jnp.asarray(w2c)[None], tiles[None], mask[None], jnp.asarray(1, jnp.int32),
                                     jax.random.PRNGKey(0))
    params, dead, count = _torch_state(case)
    gp, dead, count, losses = case.algo.map_step(params, dead, count, torch.from_numpy(image),
                                                 torch.from_numpy(w2c)[None], torch.from_numpy(tiles)[None],
                                                 torch.from_numpy(mask)[None], 1, N_ITERS, densify=True,
                                                 noise=torch.from_numpy(case.noise))
    jcount, jdead = int(jcount), np.asarray(jdead)
    assert int(count) == jcount > case.count + 100  # the densify steps appended clones and splits
    _close(losses.numpy(), jlosses, "losses")
    np.testing.assert_array_equal(dead.numpy(), jdead)
    assert jdead[:case.count].sum() > case.dead[:case.count].sum()  # split parents and removals died
    for k in GAUSS_GROUPS:
        got, want = gp[k].numpy(), np.asarray(jp[k])
        off = np.abs(got - want) > 1e-5
        assert off.mean() < 1e-3 and np.abs(got - want).max() <= 2 * N_ITERS * LRS[k] + 1e-5, k
        np.testing.assert_array_equal(got[jcount:], case.params[k][jcount:], err_msg=k)
