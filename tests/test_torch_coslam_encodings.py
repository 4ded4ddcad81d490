"""Co-SLAM's packed hash and tri-plane encodings in the port against the
JAX package (``ops/hashgrid_packed.py``, ``ops/triplane.py``).

The same numpy tables and points (some outside [0,1]^3) go through both;
the forward, the tables' gradients and the position gradient are compared
(tolerance: 1e-5 of the largest entry, for sums in another order). The
packed hash zeroes dx outside the open box; the tri-plane does not. A
pre-packed copy (``packed=``, tracking) gives the same forward and dx.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.ops import encodings as tenc  # noqa: E402
from xrdslam_tpu_torch.ops import hashgrid_packed as thp  # noqa: E402
from xrdslam_tpu_torch.ops import triplane as ttp  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


N = 400
REL = 1e-5
HASH_ARGS = (4, 2, 10, 4, 48)  # resolutions 4, 9 (dense), 21, 48 (hashed); T = 2^10
TP_ARGS = ((16, 40), (4, 3))  # two scales of tri-planes, 4 and 3 features


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from xrdslam_tpu.ops import encodings, hashgrid_packed, triplane

    return SimpleNamespace(jax=jax, jnp=jnp, enc=encodings, hp=hashgrid_packed, tp=triplane)


def _points(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.15, 1.15, (N, 3)).astype(np.float32)
    inside = np.all((x > 0.0) & (x < 1.0), axis=1)
    assert 0 < inside.sum() < N
    return x, inside


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= REL * scale, f"{what}: max abs err {err:.3e} > {REL} x {scale:.3e}"


def _run_torch(fn, tables, x, g, packed=None):
    tt = {k: torch.tensor(v, requires_grad=True) for k, v in tables.items()}
    xx = torch.tensor(x, requires_grad=True)
    out = fn(tt, xx, packed)
    torch.sum(out * torch.from_numpy(g)).backward()
    grads = {k: None if v.grad is None else v.grad.numpy() for k, v in tt.items()}
    return out.detach().numpy(), grads, xx.grad.numpy()


def _run_jax(jx, fn, tables, x, g):
    jt = {k: jx.jnp.asarray(v) for k, v in tables.items()}
    out, vjp = jx.jax.vjp(fn, jt, jx.jnp.asarray(x))
    dt, dx = vjp(jx.jnp.asarray(g))
    return np.asarray(out), {k: np.asarray(v) for k, v in dt.items()}, np.asarray(dx)


@pytest.fixture(scope="module")
def packed_case(jx):
    spec = tenc.hashgrid_spec(*HASH_ARGS)
    jspec = jx.enc.hashgrid_spec(*HASH_ARGS)
    assert tuple(spec) == tuple(jspec) and any(spec.dense) and not all(spec.dense)
    rng = np.random.default_rng(0)
    tables = {k: np.asarray(v) * 1e3 for k, v in jx.hp.packed_init(jx.jax.random.PRNGKey(0), jspec).items()}
    x, inside = _points(1)
    g = rng.standard_normal((N, spec.out_dim)).astype(np.float32)
    want = _run_jax(jx, lambda t, xx: jx.hp.packed_hash_encode(t, xx, jspec), tables, x, g)
    got = _run_torch(lambda t, xx, p: thp.packed_hash_encode(t, xx, spec, packed=p), tables, x, g)
    return SimpleNamespace(spec=spec, tables=tables, x=x, inside=inside, g=g, want=want, got=got)


@pytest.fixture(scope="module")
def tri_case(jx):
    spec = ttp.triplane_spec(*TP_ARGS)
    jspec = jx.tp.triplane_spec(*TP_ARGS)
    assert spec.out_dim == jspec.out_dim == 21
    rng = np.random.default_rng(2)
    tables = {k: np.asarray(v) * 1e3 for k, v in jx.tp.triplane_init(jx.jax.random.PRNGKey(0), jspec).items()}
    x, inside = _points(3)
    g = rng.standard_normal((N, spec.out_dim)).astype(np.float32)
    want = _run_jax(jx, lambda t, xx: jx.tp.triplane_encode(t, xx, jspec), tables, x, g)
    got = _run_torch(lambda t, xx, p: ttp.triplane_encode(t, xx, spec, packed=p), tables, x, g)
    return SimpleNamespace(spec=spec, tables=tables, x=x, inside=inside, g=g, want=want, got=got)


@pytest.fixture(params=["packed", "triplane"])
def case(request, packed_case, tri_case):
    return packed_case if request.param == "packed" else tri_case


def test_forward_matches_jax(case):
    _close(case.got[0], case.want[0], "encoding")


def test_table_gradients_match_jax(case):
    assert sorted(case.got[1]) == sorted(case.want[1])
    for k in case.want[1]:
        assert case.got[1][k].shape == case.tables[k].shape
        # the reference's packed-hash gradient of a dense level comes through
        # its padded pack; the rows it adds are never gathered
        _close(case.got[1][k], case.want[1][k], f"d / d {k}")


def test_dx_matches_jax_everywhere(case):
    _close(case.got[2], case.want[2], "dx")


def test_dx_outside_the_box(packed_case, tri_case):
    """The packed hash zeroes dx outside the open box (per axis, on the
    unclipped x); the tri-plane keeps the gradient at the clamped point."""
    outside_axis = (packed_case.x <= 0.0) | (packed_case.x >= 1.0)
    assert np.all(packed_case.got[2][outside_axis] == 0.0)
    assert np.abs(packed_case.got[2][~outside_axis]).max() > 0.0
    out_tri = (tri_case.x <= 0.0) | (tri_case.x >= 1.0)
    assert np.abs(tri_case.got[2][out_tri]).max() > 0.0


def test_prepacked_tables_give_the_same_forward_and_dx(packed_case, tri_case):
    for case, pack, enc in (
        (packed_case, lambda t: thp.pack_gather_tables(t, packed_case.spec),
         lambda t, xx, p: thp.packed_hash_encode(t, xx, packed_case.spec, packed=p)),
        (tri_case, lambda t: ttp.triplane_pack(t, tri_case.spec),
         lambda t, xx, p: ttp.triplane_encode(t, xx, tri_case.spec, packed=p)),
    ):
        packed = pack({k: torch.tensor(v) for k, v in case.tables.items()})
        out, _, dx = _run_torch(enc, case.tables, case.x, case.g, packed=packed)
        np.testing.assert_array_equal(out, case.got[0])
        np.testing.assert_allclose(dx, case.got[2], atol=1e-6 * np.abs(case.got[2]).max(), rtol=0)


def test_prepacked_hash_tables_get_no_gradient(packed_case):
    """With ``packed`` given the packed hash is a constant of the encode
    (tracking): no table gradient, so no scatter."""
    tt = {k: torch.tensor(v, requires_grad=True) for k, v in packed_case.tables.items()}
    xx = torch.tensor(packed_case.x, requires_grad=True)
    packed = thp.pack_gather_tables(tt, packed_case.spec)
    out = thp.packed_hash_encode(tt, xx, packed_case.spec, packed=packed)
    torch.sum(out * torch.from_numpy(packed_case.g)).backward()
    assert all(v.grad is None for v in tt.values()) and xx.grad is not None


def test_dense_levels_are_exact_against_the_per_vertex_encode():
    """All-dense spec: the packed encode equals the per-vertex reference
    encode when the vertex grids hold the same values."""
    spec = tenc.hashgrid_spec(3, 2, 10, 3, 7)
    assert all(spec.dense)
    tables = thp.packed_init(spec, torch.Generator().manual_seed(0))
    ref = torch.zeros((spec.n_levels, spec.table_size, spec.n_features))
    for l, r in enumerate(spec.resolutions):
        r1 = r + 1
        v = tables[f"v{l}"].reshape(r1, r1, r1, spec.n_features)  # [x, y, z]
        # the per-vertex dense index is x + (R+1) (y + (R+1) z)
        ref[l, :r1 ** 3] = v.permute(2, 1, 0, 3).reshape(-1, spec.n_features)
    x = torch.rand((257, 3), generator=torch.Generator().manual_seed(1)) * 0.98 + 0.01
    np.testing.assert_allclose(thp.packed_hash_encode(tables, x, spec).numpy(),
                               tenc.hashgrid_encode(ref, x, spec).numpy(), rtol=1e-5, atol=1e-9)


def test_triplane_pack_matches_jax(jx, tri_case):
    jspec = jx.tp.triplane_spec(*TP_ARGS)
    want = jx.tp.triplane_pack({k: jx.jnp.asarray(v) for k, v in tri_case.tables.items()}, jspec)
    got = ttp.triplane_pack({k: torch.tensor(v) for k, v in tri_case.tables.items()}, tri_case.spec)
    for s, R in enumerate(TP_ARGS[0]):
        # the reference pads the rows to a fast TPU gather size; the rest agrees
        np.testing.assert_array_equal(got[f"s{s}"].numpy(), np.asarray(want[f"s{s}"])[:, :R * R])
