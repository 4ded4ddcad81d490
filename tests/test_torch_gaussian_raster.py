"""The port's tile rasterizer and scatter-add against the JAX package.

The CPU path of ``xrdslam_tpu_torch.ops.gaussian_raster`` is its plain
twins (``raster_fwd_torch`` / ``raster_bwd_torch`` and ``index_add_``);
they are held against the JAX rasterizer, whose Pallas kernels run in
interpret mode on the CPU (``pl_compat``). The CUDA kernels (K4, K5, K6)
are compared with the twins on the card (``cuda`` marker):
``python -m pytest --noconftest -m cuda tests/test_torch_gaussian_raster.py``.

Tolerances. The forward agrees to 1e-5 absolute: both composite in fp32,
and only the order of the transmittance sums differs (a sequential cumsum
against the TPU kernel's doubling scan). The gradients agree to 1e-4 of
their largest entry: the per-pixel and per-tile sums are taken in other
orders, and the backward's suffix term cancels (total - prefix). The JAX
gradient here goes through ``scatter_add_matmul``'s exact fp32 branch, as
it does on SplaTAM's path (131,072 rows): the table has more than 32,768
rows. Its bf16 branch (small tables) is compared at a bf16 tolerance.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.ops import gaussian_raster as tgr  # noqa: E402
from xrdslam_tpu_torch.ops import scatter as tsc  # noqa: E402

H, W = 32, 48
NTX, NTY = W // 16, H // 16
G_LIVE = 150
G_ROWS = 40_000  # > 32,768: the JAX scatter takes its exact fp32 branch
K = 48
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from xrdslam_tpu.ops import gaussian_raster, pallas_scatter

    return SimpleNamespace(jax=jax, jnp=jnp, gr=gaussian_raster, ps=pallas_scatter)


def _scene(seed=0):
    """G_ROWS gaussian rows, the first G_LIVE alive: random footprints,
    denser to the left (full tiles there, partly filled ones to the right),
    depth ties, a few opaque gaussians centred on pixels (their alpha
    saturates at 0.99), some dead, some behind the camera or off screen."""
    rng = np.random.default_rng(seed)
    n = G_ROWS
    u = (rng.beta(0.7, 2.5, n) * (W + 16) - 8).astype(np.float32)
    v = rng.uniform(-8, H + 8, n).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, n).astype(np.float32)
    depth[10:40] = depth[5]  # ties: the depth sort must be stable
    depth[40:45] = -1.0  # behind the camera
    sigma = rng.uniform(0.6, 4.0, n).astype(np.float32)
    op = rng.uniform(0.05, 0.95, n).astype(np.float32)
    sat = np.arange(50, 60)
    u[sat] = rng.integers(0, W, sat.size)
    v[sat] = rng.integers(0, H, sat.size)
    op[sat] = 0.999
    ch = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    alive = np.zeros(n, np.float32)
    alive[:G_LIVE] = 1.0
    alive[[3, 77, 120]] = 0.0
    return SimpleNamespace(u=u, v=v, depth=depth, sigma=sigma, op=op, ch=ch, alive=alive)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def binned(jx, scene):
    s = scene
    args = [jx.jnp.asarray(a) for a in (s.u, s.v, s.depth, 3 * s.sigma, s.alive)]
    ids, mask = jx.gr.bin_gaussians_device(*args, H, W, k_per_tile=K, max_span=4)
    return np.array(ids), np.array(mask)


@pytest.mark.parametrize("max_span", [4, 6])
def test_bin_gaussians_device_equals_jax(jx, scene, max_span):
    s = scene
    args = (s.u, s.v, s.depth, 3 * s.sigma, s.alive)
    want_ids, want_mask = jx.gr.bin_gaussians_device(*[jx.jnp.asarray(a) for a in args], H, W, k_per_tile=K,
                                                     max_span=max_span)
    ids, mask = tgr.bin_gaussians_device(*[torch.from_numpy(a) for a in args], H, W, k_per_tile=K,
                                         max_span=max_span)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert mask.numpy().all(axis=1).any() and not mask.numpy().all()  # full and partly filled tiles
    assert ids.dtype == torch.int32 and mask.dtype == torch.bool


def test_numpy_binner_is_the_reference_one(jx, scene):
    s = scene
    live = slice(0, G_LIVE)
    args = (s.u[live], s.v[live], s.depth[live], 3 * s.sigma[live], s.alive[live] > 0, H, W)
    got, want = tgr.bin_gaussians(*args, k_per_tile=K), jx.gr.bin_gaussians(*args, k_per_tile=K)
    np.testing.assert_array_equal(got.tile_ids, want.tile_ids)
    np.testing.assert_array_equal(got.tile_mask, want.tile_mask)


def _jax_args(jx, s, binned):
    jnp = jx.jnp
    return [jnp.asarray(a) for a in (s.u, s.v, s.sigma, s.op * s.alive, s.ch)], [jnp.asarray(b) for b in binned]


def _torch_args(s, binned, requires_grad=False):
    ts = [torch.tensor(a, requires_grad=requires_grad) for a in (s.u, s.v, s.sigma, s.op * s.alive, s.ch)]
    return ts, [torch.from_numpy(b) for b in binned]


def test_pack_tile_data_matches_jax(jx, scene, binned):
    (ja, jb), (ta, tb) = _jax_args(jx, scene, binned), _torch_args(scene, binned)
    want = np.asarray(jx.gr._pack_tile_data(*ja, *jb)).transpose(0, 2, 1)  # JAX keeps [T, 16, K]
    np.testing.assert_array_equal(tgr._pack_tile_data(*ta, *tb).numpy(), want)


def test_rasterize_forward_matches_jax(jx, scene, binned):
    (ja, jb), (ta, tb) = _jax_args(jx, scene, binned), _torch_args(scene, binned)
    want = np.asarray(jx.gr.rasterize(*ja, *jb, NTX, NTY))
    got = tgr.rasterize(*ta, *tb, NTX, NTY)
    assert got.shape == (H, W, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_rasterize_vjp_matches_jax(jx, scene, binned):
    s = scene
    (ja, jb), (ta, tb) = _jax_args(jx, s, binned), _torch_args(s, binned, requires_grad=True)
    gout = np.random.default_rng(1).standard_normal((H, W, 8)).astype(np.float32)
    _, vjp = jx.jax.vjp(lambda *a: jx.gr.rasterize(*a, *jb, NTX, NTY), *ja)
    want = vjp(jx.jnp.asarray(gout))
    got = torch.autograd.grad(tgr.rasterize(*ta, *tb, NTX, NTY), ta, torch.from_numpy(gout))
    # the cases the gradient must handle are present
    tiled = tgr._pack_tile_data(*[t.detach() for t in ta], *tb)
    assert (~tb[1]).any(), "no masked slots"
    sat = tgr._alphas(*[tiled.transpose(1, 2)[:, None, i, :] for i in range(4)], tb[1][:, None, :],
                      *tgr._pixel_grid(NTX * NTY, NTX, "cpu"))
    assert (sat == tgr.ALPHA_MAX).any(), "no saturated alpha"
    for name, g, w in zip(("u", "v", "sigma", "opacity", "channels"), got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g.numpy() - w).max() <= REL * scale, name


def test_raster_bwd_zeroes_masked_slots(scene, binned):
    ta, tb = _torch_args(scene, binned)
    tiled = tgr._pack_tile_data(*ta, *tb)
    gout = torch.from_numpy(np.random.default_rng(2).standard_normal((H, W, 8)).astype(np.float32))
    dg = tgr.raster_bwd_torch(tiled, gout, NTX, NTY)
    assert dg.shape == tiled.shape
    assert float(dg[~tb[1]].abs().max()) == 0.0
    assert float(dg[..., [4, 13, 14, 15]].abs().max()) == 0.0
    assert float(dg[tb[1]].abs().max()) > 0.0


@pytest.mark.parametrize("rows", [300, 40_000])  # the Pallas branch and the XLA branch of the reference
def test_scatter_add_matches_jax(jx, rows):
    rng = np.random.default_rng(rows)
    n = 5_000
    idx = rng.integers(0, rows, n).astype(np.int32)
    idx[:500] = 7  # many adds into one row
    g = rng.standard_normal((n, 16)).astype(np.float32)
    g[1000:1500] = 0.0
    got = tsc.scatter_add(torch.from_numpy(idx), torch.from_numpy(g), rows).numpy()
    exact = np.asarray(jx.jnp.zeros((rows, 16), jx.jnp.float32).at[jx.jnp.asarray(idx)].add(jx.jnp.asarray(g)))
    np.testing.assert_allclose(got, exact, atol=1e-5, rtol=0)
    ref = np.asarray(jx.ps.scatter_add_matmul(jx.jnp.asarray(idx), jx.jnp.asarray(g), rows))
    # the reference's Pallas branch rounds g to bf16 (8 bits of mantissa)
    tol = 1e-5 if rows > 32_768 else 2 ** -8 * np.abs(g).max() * np.bincount(idx, minlength=rows).max()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def test_scatter_add_drops_out_of_range_rows():
    idx = torch.tensor([0, 5, -1, 2], dtype=torch.int32)
    g = torch.ones((4, 2))
    np.testing.assert_array_equal(tsc.scatter_add(idx, g, 3).numpy(), [[1, 1], [0, 0], [1, 1]])


def test_wrappers_reject_other_devices():
    meta = torch.empty((6, 48, 16), device="meta")
    with pytest.raises(ValueError):
        tgr.raster_fwd(meta, NTX, NTY)
    with pytest.raises(ValueError):
        tgr.raster_bwd(meta, torch.empty((H, W, 8), device="meta"), NTX, NTY)
    with pytest.raises(ValueError):
        tsc.scatter_add(torch.empty(4, dtype=torch.int32, device="meta"), torch.empty((4, 16), device="meta"), 9)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 48, 300])
def test_cuda_raster_kernels_match_twins(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    s = _scene(k)
    args = [torch.as_tensor(a, device=dev) for a in (s.u, s.v, s.depth, 3 * s.sigma, s.alive)]
    ids, mask = tgr.bin_gaussians_device(*args, H, W, k_per_tile=k, max_span=4)
    ta = [torch.as_tensor(a, device=dev).requires_grad_(True) for a in (s.u, s.v, s.sigma, s.op * s.alive, s.ch)]
    tiled = tgr._pack_tile_data(*[t.detach() for t in ta], ids, mask)
    gout = torch.randn((H, W, 8), generator=torch.Generator(device=dev).manual_seed(k), device=dev)
    before = dict(tgr.LAUNCHES), dict(tsc.LAUNCHES)
    out = tgr.rasterize(*ta, ids, mask, NTX, NTY)
    grads = torch.autograd.grad(out, ta, gout)
    dg = tgr.raster_bwd(tiled, gout, NTX, NTY)
    torch.cuda.synchronize()
    assert tgr.LAUNCHES["raster_fwd"] == before[0]["raster_fwd"] + 1
    assert tgr.LAUNCHES["raster_bwd"] == before[0]["raster_bwd"] + 2
    assert tsc.LAUNCHES["scatter_add"] == before[1]["scatter_add"] + 1
    assert (out - tgr.raster_fwd_torch(tiled, NTX, NTY)).abs().max().item() <= 1e-5
    dg_w = tgr.raster_bwd_torch(tiled, gout, NTX, NTY)
    assert (dg - dg_w).abs().max().item() <= REL * dg_w.abs().max().item()
    acc = tsc.scatter_add_torch(ids.reshape(-1), dg_w.reshape(-1, 16), G_ROWS)
    for g, w in zip(grads, (acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3], acc[:, 5:13])):
        assert (g - w).abs().max().item() <= REL * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows", [(1, 1), (5_000, 300), (214_016, 131_072)])
def test_cuda_scatter_add_matches_twin(n, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(n)
    idx = torch.randint(0, rows, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((n, 16), generator=gen, device=dev)
    g[: n // 3] = 0.0
    got = tsc.scatter_add(idx, g, rows)
    want = tsc.scatter_add_torch(idx, g, rows)
    # fp32 atomics add in another order than index_add_
    assert (got - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1.0)
