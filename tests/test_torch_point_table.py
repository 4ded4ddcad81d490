"""The point table of the port against the JAX package: the row gather (K7),
the host map, the spatial-hash kNN and the feature lookup.

The same numpy inputs go to both packages. The JAX row gather runs its
Pallas kernels (K7a at width 1024, K7b at 128) in interpret mode on the
CPU; the JAX kNN is made to take that path too. Tolerances: gathers and the
host map are compared as bits (the rows carry int32 ids bitcast to float32,
most of them denormal floats); distances to 1e-6 relative; neighbour ids,
counts and the 1e6 position sentinels exactly wherever a pick is valid
(D2 < 1e10); gradients of gathers and lookups (scatter-adds in another
order) to 1e-6 relative.

The CUDA kernel is compared with its twin on the card (``cuda`` marker):
``python -m pytest --noconftest -m cuda tests/test_torch_point_table.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import xrdslam_tpu.ops.row_gather as jrg  # noqa: E402
from xrdslam_tpu.ops import pallas_scatter as jps  # noqa: E402
from xrdslam_tpu.ops import point_table as jpt  # noqa: E402
from xrdslam_tpu_torch.ops import point_table as tpt  # noqa: E402
from xrdslam_tpu_torch.ops import row_gather as trg  # noqa: E402
from xrdslam_tpu_torch.ops import scatter as tsc  # noqa: E402

REL = 1e-6
MAX_POINTS = 8192
HASH_CAP = 4096  # union rows: 16 MiB, not the default 256 MiB


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture()
def pallas_gather(monkeypatch):
    """The JAX row gather through its Pallas kernels, in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(jrg.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jrg, "_on_tpu", lambda: True)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


def _ids_table(rows, width, seed):
    """A table whose words are int32 ids bitcast to float32 (denormals) and
    ordinary floats, as the union rows hold."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((rows, width)).astype(np.float32)
    t[:, ::3] = rng.integers(0, 1 << 20, (rows, len(range(0, width, 3)))).astype(np.int32).view(np.float32)
    return t


@pytest.mark.parametrize("width", [1024, 128])  # K7a, K7b
def test_row_gather_twin_equals_the_pallas_kernels(pallas_gather, width):
    table = _ids_table(700, width, width)
    idx = np.random.default_rng(1).integers(0, 700, 300).astype(np.int32)
    want = np.asarray(jrg._row_gather_impl(jnp.asarray(table), jnp.asarray(idx)))
    got = trg.row_gather(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(table[idx]))


def test_row_gather_gradient_matches_jax():
    rng = np.random.default_rng(2)
    rows = 5000  # above the reference's size switch: its exact fp32 scatter, not the bf16 Pallas branch
    table = rng.standard_normal((rows, 128)).astype(np.float32)
    idx = rng.integers(0, rows, (40, 7)).astype(np.int32)
    idx[0] = 3  # repeats: rows add up
    g = rng.standard_normal((40, 7, 128)).astype(np.float32)
    want = jrg._rg_bwd((jnp.asarray(idx), rows), jnp.asarray(g))[0]
    t = torch.from_numpy(table).requires_grad_(True)
    out = trg.row_gather(t, torch.from_numpy(idx))
    assert out.shape == (40, 7, 128)
    (got,) = torch.autograd.grad(out, [t], torch.from_numpy(g))
    _close(got.numpy(), want, "d table")


def test_row_gather_out_of_range_rows_are_zero():
    table = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    got = trg.row_gather(table, torch.tensor([2, -1, 3, 0], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), [[8, 9, 10, 11], [0, 0, 0, 0], [0, 0, 0, 0], [0, 1, 2, 3]])


def _cloud(seed, n, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def maps():
    """The same insertions into both packages' maps: two spread batches, 300
    points in one cell (its rows keep 192 of them), more into those full
    rows (an overflowed map), then a duplicate of a stored point (two
    candidates at equal distance)."""
    jm = jpt.PointMap(max_points=MAX_POINTS, cell_size=0.16, hash_cap=HASH_CAP)
    tm = tpt.PointMap(max_points=MAX_POINTS, cell_size=0.16, hash_cap=HASH_CAP)
    batches = (_cloud(3, 400), _cloud(4, 600, 0.2, 0.8), _cloud(5, 300, 0.5, 0.62), _cloud(6, 20, 0.5, 0.62),
               np.repeat(_cloud(7, 1, 0.3, 0.3), 2, 0))
    for pts in batches:
        assert jm.add_points(pts) == tm.add_points(pts)
    assert tm.overflowed and jm.overflowed
    return jm, tm


def test_host_map_equals_jax(maps):
    jm, tm = maps
    for name in ("cell_keys", "cell_count", "cell_list", "pos"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(_bits(tm.cell_data), _bits(jm.cell_data))
    assert tm.n_points == jm.n_points and tm.cell_count.max() == tm.per_cell
    q = np.concatenate([_cloud(8, 200, -0.1, 1.1), _cloud(9, 5, 3.0, 4.0)])
    for radius in (0.05, np.random.default_rng(10).uniform(0.02, 0.08, len(q))):
        np.testing.assert_array_equal(tm.neighbor_counts(q, radius), jm.neighbor_counts(q, radius))


def test_device_state_keeps_the_bits(maps):
    _, tm = maps
    st = tm.device_state("cpu")
    np.testing.assert_array_equal(st["cell_data"].view(torch.int32).numpy(), _bits(tm.cell_data))
    assert st["cell_data"].data_ptr() != tm.cell_data.ctypes.data  # a copy, as an upload is
    assert st["cell_size"].dtype == torch.float32 and st["per_cell"] == tm.per_cell


@pytest.mark.parametrize("with_pos", [False, True])
def test_knn_matches_jax(pallas_gather, maps, with_pos):
    jm, tm = maps
    dup = tm.pos[tm.n_points - 1]
    q = np.concatenate([
        _cloud(11, 120, 0.0, 1.0),  # partial rows
        _cloud(12, 40, 0.5, 0.62),  # full (overflowed) rows
        _cloud(13, 20, 5.0, 6.0),  # no row at all
        (dup + np.array([0.01, 0.0, 0.0], np.float32))[None],  # two candidates at one distance
    ]).astype(np.float32)
    want = [np.asarray(a) for a in jpt.knn_query(jm.device_state(), jnp.asarray(q), k=8, with_pos=with_pos)]
    got = [a.numpy() for a in tpt.knn_query(tm.device_state("cpu"), torch.from_numpy(q), k=8, with_pos=with_pos)]
    D2, I, nv = got[:3]
    valid = want[0] < 1e10
    assert valid[:120].any() and not valid[120 + 40:-1].any() and valid[-1, :2].all()
    np.testing.assert_array_equal(nv, want[2])
    np.testing.assert_array_equal(D2 < 1e10, valid)
    np.testing.assert_array_equal(D2[~valid], want[0][~valid])
    _close(D2[valid], want[0][valid], "D2")
    np.testing.assert_array_equal(I[valid], want[1][valid])
    assert I.dtype == np.int32 and I[valid].max() < tm.n_points
    assert D2[-1, 0] == D2[-1, 1] and I[-1, 0] < I[-1, 1]  # the tie keeps the lower candidate first
    if with_pos:
        np.testing.assert_array_equal(got[3][valid], want[3][valid])
        np.testing.assert_array_equal(got[3][~valid], want[3][~valid])
        assert (got[3][~valid] == 1e6).all()


def test_knn_finds_the_nearest_points():
    tm = tpt.PointMap(max_points=2048, cell_size=0.16, hash_cap=HASH_CAP)
    pts = _cloud(0, 500)
    tm.add_points(pts)
    q = pts[:40] + 0.01
    D2, _, nv = tpt.knn_query(tm.device_state("cpu"), torch.from_numpy(q), k=8)
    d_all = np.linalg.norm(pts[None] - q[:, None], axis=-1)
    np.testing.assert_allclose(np.sqrt(D2[:, 0].numpy()), np.sort(d_all, 1)[:, 0], atol=1e-5)
    assert int(nv.min()) >= 1


def test_table_lookup_matches_jax():
    rng = np.random.default_rng(14)
    rows = 40_000  # above the reference's Pallas size switch: its exact fp32 branch, as at Point-SLAM's 262,144
    table = rng.standard_normal((rows, 32)).astype(np.float32)
    idx = rng.integers(0, rows, (3000, 8)).astype(np.int32)
    idx[:50] = 7  # a row many entries add into
    g = rng.standard_normal((3000, 8, 32)).astype(np.float32)
    jt = jnp.asarray(table)
    want, vjp = jax.vjp(lambda t: jps.table_lookup(t, jnp.asarray(idx), True), jt)
    (want_g,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_(True)
    got = tsc.table_lookup(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got_g,) = torch.autograd.grad(got, [t], torch.from_numpy(g))
    _close(got_g.numpy(), want_g, "d table")


def test_wrappers_reject_other_devices():
    meta = torch.empty((8, 1024), device="meta")
    with pytest.raises(ValueError):
        trg.row_gather(meta, torch.zeros(3, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,width", [(1, 1024), (24_960, 1024), (24_960, 128), (777, 8)])
def test_cuda_row_gather_matches_twin_bit_for_bit(n, width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    table = torch.from_numpy(_ids_table(65_536, width, n)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    idx = torch.randint(0, 65_536, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[: n // 10] = -3  # out of range: zero rows in both
    before = trg.LAUNCHES["row_gather"]
    got = trg.row_gather(table, idx)
    torch.cuda.synchronize()
    assert trg.LAUNCHES["row_gather"] == before + 1
    assert torch.equal(got.view(torch.int32), trg.row_gather_torch(table, idx).view(torch.int32))


@pytest.mark.cuda
def test_cuda_scatter_add_at_the_table_lookup_shape():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, 262_144, (24_960, 8), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((24_960, 8, 32), generator=gen, device=dev)
    table = torch.zeros((262_144, 32), device=dev, requires_grad=True)
    before = tsc.LAUNCHES["scatter_add"]
    (got,) = torch.autograd.grad(tsc.table_lookup(table, idx), [table], g)
    want = tsc.scatter_add_torch(idx.reshape(-1), g.reshape(-1, 32), 262_144)
    assert tsc.LAUNCHES["scatter_add"] == before + 1
    # the kernel adds each row in sorted order, index_add_ in another
    assert (got - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1.0)
