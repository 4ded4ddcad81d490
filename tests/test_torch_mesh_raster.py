"""The port's tile mesh rasterizer against the JAX package's.

The same meshes go through ``render_mesh_depth_np`` of both packages at
64x48 on the CPU: ``tests/test_eval_surface.py``'s three cases (a frontal
plane, a tilted plane with its perspective-correct depth, the nearest of
two quads winning), a seeded random mesh of 300 faces through the tile
pass alone, and one of 5,000 faces (more than 4,096) through the hybrid of
the tile pass and the scatter-min splat. Each holds the same covered pixels
and the same depth within 1e-5 m; the three planes also keep the JAX
test's own expectations. The tile pass is also held to one tile a chunk
(the depths do not depend on the chunking).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu.ops import mesh_raster as jraster  # noqa: E402
from xrdslam_tpu.utils.io import Mesh as JMesh  # noqa: E402
from xrdslam_tpu_torch.ops import mesh_raster  # noqa: E402
from xrdslam_tpu_torch.utils.io import Mesh  # noqa: E402

H, W = 48, 64
CAM = (60.0, 60.0, 31.5, 23.5)
DEPTH_ATOL = 1e-5  # m


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _quad(z: float, half: float = 10.0, tilt: float = 0.0):
    """Two triangles over x, y in [-half, half] at z_cam = z + tilt * x
    (identity pose: p_world = (x, y, -z_cam))."""
    xs = np.array([-half, half, half, -half], np.float64)
    ys = np.array([-half, -half, half, half], np.float64)
    v = np.stack([xs, ys, -(z + tilt * xs)], -1).astype(np.float32)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _random_mesh(n_faces: int, seed: int):
    """Triangles of a few pixels to a few tiles, 1.5-4.5 m in front of the
    camera, some of them crossing the image border."""
    rng = np.random.default_rng(seed)
    centres = np.stack([rng.uniform(-2.0, 2.0, n_faces), rng.uniform(-1.5, 1.5, n_faces),
                        -rng.uniform(1.5, 4.5, n_faces)], -1)
    v = (centres[:, None, :] + rng.normal(0.0, 0.12, (n_faces, 3, 3))).reshape(-1, 3).astype(np.float32)
    return v, np.arange(3 * n_faces, dtype=np.int32).reshape(-1, 3)


def _frontal(d):
    np.testing.assert_allclose(d, 2.0, atol=1e-4)


def _tilted(d):
    u = np.arange(W) + 0.5
    # the plane z = 2 + b x_cam with x_cam = (u - cx) / fx * z
    np.testing.assert_allclose(d[24], 2.0 / (1.0 - 0.3 * (u - CAM[2]) / CAM[0]), rtol=2e-3)


def _nearest(d):
    assert abs(d[24, 32] - 1.0) < 1e-3  # the centre: the near quad
    assert abs(d[24, 0] - 3.0) < 1e-3  # the near quad spans u in [1.5, 61.5]


def _two_quads():
    nv, nf = _quad(1.0, half=0.5)
    fv, ff = _quad(3.0, half=10.0)
    return np.concatenate([nv, fv]), np.concatenate([nf, ff + 4]).astype(np.int32)


CASES = {
    "frontal": (lambda: _quad(2.0), _frontal),
    "tilted": (lambda: _quad(2.0, half=3.0, tilt=0.3), _tilted),
    "nearest": (_two_quads, _nearest),
    "random-tiles": (lambda: _random_mesh(300, 0), None),
    "random-hybrid": (lambda: _random_mesh(5000, 1), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_depth_matches_jax(case):
    make, expect = CASES[case]
    v, f = make()
    assert (len(f) > mesh_raster.HYBRID_FACES) == (case == "random-hybrid")
    c2w = np.eye(4)
    if case.startswith("random"):  # a pose off the identity
        c2w[:3, 3] = [0.1, -0.05, 0.2]
    want = jraster.render_mesh_depth_np(JMesh(v, f), c2w, *CAM, H, W)
    got = mesh_raster.render_mesh_depth_np(Mesh(v, f), c2w, *CAM, H, W, device="cpu")
    assert got.shape == want.shape == (H, W) and got.dtype == np.float32
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=DEPTH_ATOL, rtol=0)
    assert (got > 0).mean() > 0.2
    if expect is not None:
        expect(got)
    if case == "random-tiles":  # one tile a chunk: the same depths
        verts, faces = mesh_raster.mesh_tensors(Mesh(v, f), torch.device("cpu"))
        w2c = torch.as_tensor(np.linalg.inv(c2w).astype(np.float32))
        k = mesh_raster.default_k_per_tile(len(f), H, W)
        one = mesh_raster.render_mesh_depth(verts, faces, w2c, *CAM, H, W, k_per_tile=k, chunk=1)
        np.testing.assert_array_equal(one.numpy(), got)
