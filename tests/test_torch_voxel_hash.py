"""Vox-Fusion's voxel hash and masked SDF losses in the port against the JAX package.

The same numpy inputs go to both packages; everything here is held to
exact equality but the losses (1e-6 of the largest): the hash's bits over
negative, large and ``EMPTY_KEY`` coordinates; the host allocator's
tables; ``lookup_voxels`` on a host-built map; ``insert_points_device``
from an empty map, then again (idempotent), then on new points
(incremental), every table and count after each call, at a ``max_new``
below the point set's voxels (several calls to converge; one vertex
chunk) and above it (two vertex chunks of 8,192 candidates), and at
capacities the points overflow; the device insertion against the host
allocator as sets of voxel coordinates; the fixed-size compaction against
``jnp.nonzero(size=..., fill_value=...)``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.ops import losses as jlosses  # noqa: E402
from xrdslam_tpu.ops import voxel_hash as jvh  # noqa: E402
from xrdslam_tpu_torch.ops import losses  # noqa: E402
from xrdslam_tpu_torch.ops import voxel_hash as vh  # noqa: E402

VS = 0.2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _points(seed: int, n: int, lo: float, hi: float) -> np.ndarray:
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("cap", [1 << 16, 1 << 12, 1000])
def test_hash_bits_match_jax(cap):
    rng = np.random.default_rng(cap)
    k = rng.integers(-2**31, 2**31, (2000, 3), dtype=np.int64).astype(np.int32)
    k[:4] = vh.EMPTY_KEY
    k[4:8] = [[-1, -7, 3], [2**31 - 1, -2**31, 0], [0, 0, 0], [-50, 49, -51]]
    k[8:1000] = rng.integers(-60, 60, (992, 3))  # the range of a map shifted by init_pose_offset
    want = np.asarray(jvh._hash_i32(*(jnp.asarray(k[:, i]) for i in range(3)), cap))
    got = vh._hash_i32(*(torch.from_numpy(k[:, i]) for i in range(3)), cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vh._hash_np(k, cap), want)
    np.testing.assert_array_equal(vh._hash_np(k, cap), jvh._hash_np(k, cap))
    assert got.min() >= 0 and got.max() < cap


def test_host_map_and_lookup_match_jax():
    """The host allocator's tables, then ``lookup_voxels`` on its map for
    inserted, absent and ``EMPTY_KEY`` coordinates."""
    pts = np.concatenate([_points(0, 1500, -1.0, 1.0), _points(1, 300, 9.0, 10.5)])
    jmap = jvh.VoxelHashMap(max_voxels=1024, max_vertices=4096, voxel_size=VS, hash_cap=1 << 13)
    tmap = vh.VoxelHashMap(max_voxels=1024, max_vertices=4096, voxel_size=VS, hash_cap=1 << 13)
    assert jmap.insert_points(pts) and tmap.insert_points(pts)
    for k in ("hash_keys", "hash_vals", "vox_coords", "vox_vertex_idx", "n_voxels", "n_vertices", "overflowed"):
        np.testing.assert_array_equal(getattr(tmap, k), getattr(jmap, k), err_msg=k)
    jstate, tstate = jmap.device_state(), tmap.device_state()
    assert sorted(jstate) == sorted(tstate)
    for k in jstate:
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]), err_msg=k)
    rng = np.random.default_rng(2)
    q = np.concatenate([jmap.vox_coords[:jmap.n_voxels], rng.integers(-8, 60, (500, 3)),
                        np.full((3, 3), vh.EMPTY_KEY)]).astype(np.int32)
    want = np.asarray(jvh.lookup_voxels(jstate["hash_keys"], jstate["hash_vals"], jnp.asarray(q)))
    got = vh.lookup_voxels(tstate["hash_keys"], tstate["hash_vals"], torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:jmap.n_voxels], np.arange(jmap.n_voxels))
    assert (got[jmap.n_voxels:] == -1).sum() > 400


def test_compact_matches_jnp_nonzero():
    rng = np.random.default_rng(3)
    for n, size, p in ((100, 16, 0.3), (100, 64, 0.3), (50, 8, 0.0), (40, 8, 1.0)):
        mask = rng.random(n) < p
        (want,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=n)
        np.testing.assert_array_equal(vh.compact(torch.from_numpy(mask), size).numpy(), np.asarray(want))


def _numpy(maps):
    return {k: v.numpy().copy() for k, v in maps.items()}


def _assert_maps_equal(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("max_voxels,max_vertices,max_new", [
    (2048, 8192, 256),  # several calls until the points are in; one vertex chunk
    (2048, 8192, 2048),  # two vertex chunks
    (96, 400, 256),  # both capacities overflow
])
def test_insert_points_device_matches_jax(max_voxels, max_vertices, max_new):
    """From an empty map, twice on the same points (idempotent once all are
    in), then on new points: every table and count after each call."""
    cap = 1 << 12
    kw = dict(voxel_size=VS, max_voxels=max_voxels, max_vertices=max_vertices, max_new=max_new)
    jins = jax.jit(functools.partial(jvh.insert_points_device, **kw))
    a = _points(4, 3000, -0.7, 0.8)
    b = _points(5, 3000, 1.6, 4.0)
    valid_a = np.random.default_rng(6).random(3000) > 0.1
    jmaps = jvh.empty_device_maps(max_voxels, max_vertices, hash_cap=cap)
    tmaps = vh.empty_device_maps(max_voxels, max_vertices, hash_cap=cap)
    counts = []
    for step, (pts, valid) in enumerate([(a, valid_a)] * 8 + [(b, np.ones(3000, bool))] * 2):
        jmaps = jins(jmaps, jnp.asarray(pts), jnp.asarray(valid))
        vh.insert_points_device(tmaps, torch.from_numpy(pts), torch.from_numpy(valid), **kw)
        _assert_maps_equal(_numpy(tmaps), jmaps, f"call {step}")
        counts.append((int(tmaps["n_voxels"]), int(tmaps["n_vertices"])))
    print(counts)
    if max_voxels == 96:
        assert counts[-1] == (96, 400)  # both full
        return
    assert counts[0][0] > 0 and counts[7] == counts[6]  # idempotent once the points are in
    assert counts[8][0] > counts[7][0]  # incremental
    if max_new == 2048:  # more than 1,024 new voxels in one call: the second vertex chunk allocates
        assert counts[8][0] - counts[7][0] > 1024


def test_device_insertion_matches_host_allocator():
    """The same voxel coordinates and vertex count as the host allocator;
    each vertex key has one row, shared by its voxels; every voxel found."""
    pts = _points(7, 2000, -0.8, 0.7)
    host = vh.VoxelHashMap(max_voxels=2048, max_vertices=8192, voxel_size=VS, hash_cap=1 << 12)
    host.insert_points(pts)
    maps = vh.empty_device_maps(2048, 8192, hash_cap=1 << 12)
    for _ in range(8):
        vh.insert_points_device(maps, torch.from_numpy(pts), torch.ones(2000, dtype=torch.bool), voxel_size=VS,
                                max_voxels=2048, max_vertices=8192, max_new=512)
    nv = int(maps["n_voxels"])
    coords = maps["vox_coords"][:nv].numpy()
    assert nv == host.n_voxels and int(maps["n_vertices"]) == host.n_vertices
    assert set(map(tuple, coords.tolist())) == set(map(tuple, host.vox_coords[:nv].tolist()))
    vvi = maps["vox_vertex_idx"][:nv].numpy()
    seen = {}
    for i in range(nv):
        for ci, off in enumerate(vh.CORNERS):
            assert seen.setdefault(tuple((coords[i] + off).tolist()), vvi[i, ci]) == vvi[i, ci]
    assert len(set(seen.values())) == len(seen) == host.n_vertices
    found = vh.lookup_voxels(maps["hash_keys"], maps["hash_vals"], torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(found, np.arange(nv))
    np.testing.assert_allclose(maps["vox_centers"][:nv].numpy(), (coords.astype(np.float32) + np.float32(0.5)) * np.float32(VS),
                               rtol=0, atol=0)


@pytest.mark.parametrize("masks", ["none", "ray", "ray+sample"])
def test_sdf_losses_match_jax(masks):
    rng = np.random.default_rng(8)
    z = np.sort(rng.uniform(0.1, 3.0, (64, 24)), -1).astype(np.float32)
    td = rng.uniform(0.5, 2.5, (64, 1)).astype(np.float32)
    td[:4] = 0.0
    sdf = rng.standard_normal((64, 24)).astype(np.float32)
    rm = (rng.random(64) > 0.3).astype(np.float32) if masks != "none" else None
    sm = (rng.random((64, 24)) > 0.4).astype(np.float32) if masks == "ray+sample" else None

    def opt(x, f):
        return None if x is None else f(x)

    want = jlosses.sdf_losses(jnp.asarray(z), jnp.asarray(td), jnp.asarray(sdf), 0.05,
                              ray_mask=opt(rm, jnp.asarray), sample_mask=opt(sm, jnp.asarray))
    got = losses.sdf_losses(torch.from_numpy(z), torch.from_numpy(td), torch.from_numpy(sdf), 0.05,
                            ray_mask=opt(rm, torch.from_numpy), sample_mask=opt(sm, torch.from_numpy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, atol=0)
    if sm is not None:  # the sample mask changes the losses
        unmasked = losses.sdf_losses(torch.from_numpy(z), torch.from_numpy(td), torch.from_numpy(sdf), 0.05,
                                     ray_mask=torch.from_numpy(rm))
        assert all(abs(g.item() - u.item()) > 1e-6 for g, u in zip(got, unmasked))
