"""The port's row scatter-add (K4) and its ordering against the JAX package.

``ops.scatter`` orders the ids (a stable sort and the row pointers), then
sums each output row in that order: on the card in one CUDA kernel, on the
CPU in its plain twin ``scatter_add_sorted_torch``. The CPU tests hold the
ordering and the twin against numpy and against the reference's
``scatter_add_matmul``, both its Pallas branch (small tables, bf16 one-hot
matmuls, run in interpret mode on the CPU) and its exact XLA branch.

The CUDA kernel is held against the twin on the card (``cuda`` marker),
and must give the same bits twice:
``python -m pytest --noconftest -m cuda tests/test_torch_scatter.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.ops import scatter as tsc  # noqa: E402

BWD_RTOL = 1e-4  # chip_smoke.py's: of max |twin|, whose index_add_ adds in another order on the card


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _ids(rng, n, rows):
    """Seeded ids with every feature of the kernel's input: empty rows, one
    row longer than a piece (100 entries), ids past the table."""
    idx = rng.integers(0, rows, n).astype(np.int32)
    idx[:100] = 3
    idx[100:120] = rows + 5  # dropped
    return idx


@pytest.mark.parametrize("rows", [300, 40_000])  # the Pallas branch and the XLA branch of the reference
def test_ordering_glue_matches_jax(rows):
    jnp = pytest.importorskip("jax.numpy")
    from xrdslam_tpu.ops import pallas_scatter

    rng = np.random.default_rng(rows)
    n = 2_000
    idx = _ids(rng, n, rows)
    g = rng.standard_normal((n, 16)).astype(np.float32)
    g[1000:1200] = 0.0
    order = tsc.scatter_order(torch.from_numpy(idx), rows)
    perm = np.argsort(idx, kind="stable")
    np.testing.assert_array_equal(order.perm.numpy(), perm)
    np.testing.assert_array_equal(order.keys.numpy(), idx[perm])
    np.testing.assert_array_equal(order.row_ptr.numpy(), np.searchsorted(idx[perm], np.arange(rows + 1)))
    got = tsc.scatter_add_ordered(order, torch.from_numpy(g)).numpy()
    ref = np.asarray(pallas_scatter.scatter_add_matmul(jnp.asarray(idx), jnp.asarray(g), rows))
    # the reference's Pallas branch rounds g to bf16 (8 bits of mantissa)
    tol = 1e-5 if rows > 32_768 else 2 ** -8 * np.abs(g).max() * np.bincount(idx[idx < rows]).max()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _case(name: str, dev):
    """(idx, g, rows) of a named case, seeded."""
    gen = torch.Generator(device=dev).manual_seed(len(name))
    n, c, rows = 50_000, 16, 20_000
    idx = torch.randint(0, rows, (n,), generator=gen, device=dev, dtype=torch.int32)
    if name == "empty_rows":
        idx = idx % 100 * 200  # 100 of 20,000 rows hold entries
    elif name == "out_of_range":
        idx[::3] = -1 - idx[::3]
        idx[1::3] += rows
    elif name == "one_segment":
        n = 100_000
        idx = torch.full((n,), 7, device=dev, dtype=torch.int32)
    elif name.startswith("longer_than_piece"):
        idx = torch.randint(0, 40, (n,), generator=gen, device=dev, dtype=torch.int32)  # ~1,250 a row
        c = {"longer_than_piece": 16, "longer_than_piece_c32": 32, "longer_than_piece_c3": 3}[name]
    elif name == "c32":
        c = 32
    g = torch.randn((n, c), generator=gen, device=dev)
    if name == "all_zero":
        g.zero_()
    return idx, g, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c16", "c32", "empty_rows", "out_of_range", "all_zero", "one_segment",
                                  "longer_than_piece", "longer_than_piece_c32", "longer_than_piece_c3"])
def test_cuda_scatter_add_is_deterministic_and_matches_twin(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    idx, g, rows = _case(name, torch.device("cuda"))
    want = tsc.scatter_add_torch(idx, g, rows)
    got = []
    for _ in range(2):
        # leave garbage where the output will be allocated: every row must be written
        torch.full((rows, g.shape[1]), float("nan"), device=g.device)
        before = tsc.LAUNCHES["scatter_add"]
        got.append(tsc.scatter_add(idx, g, rows))
        assert tsc.LAUNCHES["scatter_add"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1]), "two launches on the same inputs gave different bits"
    assert (got[0] - want).abs().max().item() <= BWD_RTOL * want.abs().max().item()
    empty = torch.ones(rows, dtype=torch.bool, device=g.device)
    empty[idx[(idx >= 0) & (idx < rows)].long()] = False
    assert not got[0][empty].any()
    # an ordering built once serves many sums (SplaTAM's binning)
    order = tsc.scatter_order(idx, rows)
    assert torch.equal(tsc.scatter_add_ordered(order, g), got[0])
    assert torch.equal(tsc.scatter_add_ordered(order, g), got[0])
