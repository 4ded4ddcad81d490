"""TSDF fusion and Point-SLAM's mesh in the port against the JAX package.

* ``ops.tsdf_fusion.TSDFVolume`` against the JAX package's on the same
  rendered frames at their poses: tsdf, weight and colour within 1e-6 (the
  two compute the same float32 operations, element by element), and the
  same mesh;
* the flat wall of ``tests/test_point_slam.py``;
* ``PointSLAM.get_mesh`` against the JAX package's on the same state (the
  model carried across, the same point map and keyframes) at a tiny camera
  and ``mesh_resolution`` 32: each vertex within 1e-4 of one of JAX's, one
  to one, with the same triangles on them and colours within 1e-4. The
  renders differ by float32 rounding, which moves the vertices and with
  them the order the marching tetrahedra number them in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.ops.tsdf_fusion import TSDFVolume  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _faces(faces):
    """Faces as a set: each started at its smallest vertex (winding kept),
    in lexicographic order."""
    faces = np.take_along_axis(faces, (np.argmin(faces, 1)[:, None] + np.arange(3)) % 3, 1)
    return faces[np.lexsort(faces.T[::-1])]


def test_tsdf_volume_matches_jax():
    """Three frames of the simple scene at 48x64 in chunks smaller than the
    volume (the last one partial)."""
    pytest.importorskip("jax")
    from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset
    from xrdslam_tpu.ops.tsdf_fusion import TSDFVolume as JTSDFVolume

    ds = JSyntheticDataset(n_frames=3, height=48, width=64)
    jcam = ds.get_camera()
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    jvol = JTSDFVolume(ds.bounds, voxel_size=0.08)
    vol = TSDFVolume(ds.bounds, voxel_size=0.08, chunk=40_000)
    assert vol.tsdf.shape[0] % vol.chunk != 0
    for i in range(3):
        _, rgb, depth, c2w = ds[i]
        jvol.integrate(rgb, depth, c2w, jcam)
        vol.integrate(rgb, depth, c2w, cam)
    for name in ("tsdf", "weight", "color"):
        np.testing.assert_allclose(getattr(vol, name).numpy(), np.asarray(getattr(jvol, name)), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert int((vol.weight > 0).sum()) > 1000 and float(vol.weight.max()) == 3.0
    got, want = vol.extract_mesh(), jvol.extract_mesh()
    assert len(got.faces) > 100
    for a, b in ((got.vertices, want.vertices), (got.faces, want.faces), (got.vertex_colors, want.vertex_colors)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_tsdf_fusion_flat_wall():
    """tests/test_point_slam.py's case: a wall at depth 2 seen from the
    identity pose meshes at z = -2."""
    cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, height=48, width=64)
    vol = TSDFVolume(np.array([[-1.5, 1.5], [-1.5, 1.5], [-2.5, 0.5]]), voxel_size=0.05)
    vol.integrate(np.full((48, 64, 3), 0.5, np.float32), np.full((48, 64), 2.0, np.float32), np.eye(4), cam)
    mesh = vol.extract_mesh()
    assert mesh is not None and len(mesh.vertices) > 100
    # depth is along the ray, not planar: the image borders skew the wall
    assert abs(np.median(mesh.vertices[:, 2]) + 2.0) < 0.1
    np.testing.assert_allclose(mesh.vertex_colors, 0.5, atol=1e-6)


def test_get_mesh_matches_jax():
    pytest.importorskip("jax")
    from scipy.spatial import cKDTree
    from test_torch_pointslam_group import make_jcase

    jalgo, algo, _ = make_jcase()
    got, want = algo.get_mesh(), jalgo.get_mesh()
    assert got.vertices.shape == want.vertices.shape and len(got.faces) > 100
    dist, match = cKDTree(want.vertices).query(got.vertices)
    assert dist.max() <= 1e-4 and len(np.unique(match)) == len(match)
    np.testing.assert_array_equal(_faces(match[got.faces]), _faces(want.faces))
    np.testing.assert_allclose(got.vertex_colors, np.asarray(want.vertex_colors)[match], atol=1e-4, rtol=0)
    assert np.isfinite(got.vertices).all()
