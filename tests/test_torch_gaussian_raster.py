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

    # the kernels alone, jitted so that cases of one shape trace them once
    return SimpleNamespace(jax=jax, jnp=jnp, gr=gaussian_raster, ps=pallas_scatter,
                           fwd=jax.jit(gaussian_raster._fwd_pallas, static_argnums=1),
                           bwd=jax.jit(gaussian_raster._bwd_pallas, static_argnums=2))


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
    dg = tgr.raster_bwd_torch(tiled, gout, tgr.raster_fwd_torch(tiled, NTX, NTY), NTX, NTY)
    assert dg.shape == tiled.shape
    assert float(dg[~tb[1]].abs().max()) == 0.0
    assert float(dg[..., [4, 13, 14, 15]].abs().max()) == 0.0
    assert float(dg[tb[1]].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the cases the kernels' design branches on
# ---------------------------------------------------------------------------

CASE_GRID = (2, 2)  # tiles across, down
# name -> (slots per tile K, live slots of each tile)
CASES = {
    "masked_tail": (64, (64, 40, 17, 1)),
    "empty_tile": (64, (64, 0, 30, 64)),
    "saturated": (64, (64, 64, 50, 64)),
    "clamped": (64, (64, 64, 64, 64)),
    "k300": (300, (300, 257, 256, 100)),  # K not a multiple of the kernels' 256-slot stage
    "k512": (512, (512, 300, 0, 256)),  # two stages, as SplaTAM's K = 512 runs
}


def _case(name):
    """One gaussian per slot of a 2 x 2 tile grid, random around its tile;
    ids [4, K] name them in order and each tile's live slots are a prefix,
    as binning fills them (the masked slots carry data too). "saturated":
    tile 0 starts with 40 wide opaque gaussians, alpha 0.99 at every pixel,
    so exp(log T) is exactly 0 there after 23 of them; "clamped": every 6th
    slot is an opaque gaussian centred on a pixel, its alpha clamped at
    0.99 there only."""
    k, live = CASES[name]
    ntx, nty = CASE_GRID
    rng = np.random.default_rng(list(CASES).index(name))
    n_tiles = ntx * nty
    t = np.arange(n_tiles)[:, None]
    u = (t % ntx) * 16 + rng.uniform(-8, 24, (n_tiles, k))
    v = (t // ntx) * 16 + rng.uniform(-8, 24, (n_tiles, k))
    sigma = rng.uniform(0.6, 4.0, (n_tiles, k))
    op = rng.uniform(0.05, 0.95, (n_tiles, k))
    if name == "saturated":
        u[0, :40], v[0, :40], sigma[0, :40], op[0, :40] = 7.5, 7.5, 200.0, 0.999
    if name == "clamped":
        every = slice(0, k, 6)
        u[:, every] = (t % ntx) * 16 + rng.integers(0, 16, u[:, every].shape)
        v[:, every] = (t // ntx) * 16 + rng.integers(0, 16, v[:, every].shape)
        op[:, every] = 0.999
    f32 = lambda a: a.reshape(-1).astype(np.float32)  # noqa: E731
    return SimpleNamespace(u=f32(u), v=f32(v), sigma=f32(sigma), op=f32(op),
                           ch=rng.uniform(0, 1, (n_tiles * k, 8)).astype(np.float32),
                           ids=np.arange(n_tiles * k, dtype=np.int32).reshape(n_tiles, k),
                           mask=np.arange(k)[None, :] < np.asarray(live)[:, None],
                           gout=rng.standard_normal((nty * 16, ntx * 16, 8)).astype(np.float32))


def _case_tiled(c):
    ta = [torch.from_numpy(a) for a in (c.u, c.v, c.sigma, c.op, c.ch)]
    return tgr._pack_tile_data(*ta, torch.from_numpy(c.ids), torch.from_numpy(c.mask))


@pytest.mark.parametrize("case", list(CASES))
def test_raster_cases_match_jax(jx, case):
    """The twins against the JAX kernels (interpret mode) in each case the
    CUDA kernels branch on: masked tails, an empty tile, a tile whose
    transmittance reaches exactly 0, clamped alphas, K across stages.
    ``raster_bwd`` gets the forward's image, as the autograd function
    passes it."""
    c = _case(case)
    ntx, nty = CASE_GRID
    tiled = _case_tiled(c)
    tiled_j = jx.jnp.asarray(tiled.numpy().transpose(0, 2, 1))  # the JAX kernels take [T, 16, K]
    image = tgr.raster_fwd(tiled, ntx, nty)
    want = np.asarray(jx.fwd(tiled_j, ntx))  # [T, 8, 256]
    np.testing.assert_allclose(tgr._image_to_tiles(image, ntx, nty).numpy().transpose(0, 2, 1), want, atol=1e-5,
                               rtol=0)
    gout = torch.from_numpy(c.gout)
    gt = jx.jnp.asarray(tgr._image_to_tiles(gout, ntx, nty).numpy().transpose(0, 2, 1))  # channel-major
    # the reference multiplies by the mask after its kernel
    want = np.asarray(jx.bwd(tiled_j, gt, ntx)).transpose(0, 2, 1) * c.mask[..., None]
    got = tgr.raster_bwd(tiled, gout, image, ntx, nty).numpy()
    assert not got[~c.mask].any()
    for name, cols in (("u", 0), ("v", 1), ("sigma", 2), ("opacity", 3), ("channels", slice(5, 13))):
        scale = np.abs(want[..., cols]).max()
        assert scale > 0 and np.abs(got[..., cols] - want[..., cols]).max() <= REL * scale, name
    # the case is what its name says
    rows = [tiled.transpose(1, 2)[:, None, i, :] for i in range(4)]
    alpha = tgr._alphas(*rows, torch.from_numpy(c.mask)[:, None, :], *tgr._pixel_grid(ntx * nty, ntx, "cpu"))
    if case == "saturated":
        log_t = torch.cumsum(torch.log1p(-alpha), dim=-1)
        assert (torch.exp(log_t[0, :, 30]) == 0).all() and (torch.exp(log_t[1:, :, -1]) > 0).any()
    if case == "clamped":
        raw = rows[3] * torch.exp(-((tgr._pixel_grid(ntx * nty, ntx, "cpu")[0] - rows[0]) ** 2
                                    + (tgr._pixel_grid(ntx * nty, ntx, "cpu")[1] - rows[1]) ** 2)
                                  * (0.5 / rows[2] ** 2))
        assert (raw > tgr.ALPHA_MAX).sum() >= 4 * 10 and (alpha == tgr.ALPHA_MAX).sum() < alpha.numel() / 100


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
        tgr.raster_bwd(meta, torch.empty((H, W, 8), device="meta"), torch.empty((H, W, 8), device="meta"), NTX, NTY)
    with pytest.raises(ValueError):
        tsc.scatter_add(torch.empty(4, dtype=torch.int32, device="meta"), torch.empty((4, 16), device="meta"), 9)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", [1, 48, 300, *CASES])
def test_cuda_raster_kernels_match_twins(case):
    """K5, K6 (through ``rasterize`` and alone, with the forward's image)
    and K4 against the twins: on a random scene binned on the card at K =
    ``case``, or on one of ``CASES``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    if isinstance(case, int):
        s = _scene(case)
        args = [torch.as_tensor(a, device=dev) for a in (s.u, s.v, s.depth, 3 * s.sigma, s.alive)]
        ids, mask = tgr.bin_gaussians_device(*args, H, W, k_per_tile=case, max_span=4)
        ntx, nty, seed = NTX, NTY, case
        ta = [torch.as_tensor(a, device=dev) for a in (s.u, s.v, s.sigma, s.op * s.alive, s.ch)]
    else:
        c = _case(case)
        ids, mask = torch.as_tensor(c.ids, device=dev), torch.as_tensor(c.mask, device=dev)
        (ntx, nty), seed = CASE_GRID, list(CASES).index(case)
        ta = [torch.as_tensor(a, device=dev) for a in (c.u, c.v, c.sigma, c.op, c.ch)]
    tiled = tgr._pack_tile_data(*ta, ids, mask)
    ta = [t.requires_grad_(True) for t in ta]
    gout = torch.randn((16 * nty, 16 * ntx, 8), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    before = dict(tgr.LAUNCHES), dict(tsc.LAUNCHES)
    out = tgr.rasterize(*ta, ids, mask, ntx, nty)
    grads = torch.autograd.grad(out, ta, gout)
    torch.cuda.synchronize()
    assert tgr.LAUNCHES["raster_fwd"] == before[0]["raster_fwd"] + 1
    assert tgr.LAUNCHES["raster_bwd"] == before[0]["raster_bwd"] + 1
    assert tsc.LAUNCHES["scatter_add"] == before[1]["scatter_add"] + 1
    img_w = tgr.raster_fwd_torch(tiled, ntx, nty)
    dg_w = tgr.raster_bwd_torch(tiled, gout, img_w, ntx, nty)
    dg = tgr.raster_bwd(tiled, gout, out.detach(), ntx, nty)
    torch.cuda.synchronize()
    assert (out - img_w).abs().max().item() <= 1e-5
    assert (dg - dg_w).abs().max().item() <= REL * dg_w.abs().max().item()
    assert not dg[~mask].any()
    acc = tsc.scatter_add_torch(ids.reshape(-1), dg_w.reshape(-1, 16), ta[0].shape[0])
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
    # the kernel adds each row in sorted order, index_add_ in another
    assert (got - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1.0)
