"""The port's host-side mesh and evaluation copies against the JAX
package's: marching tetrahedra (both paths), the frustum test, mesh
culling and cleaning, the 3D reconstruction metrics, the 2D render metrics,
the PLY round trip and the synthetic scenes' exact meshes. The same inputs
must give equal outputs (the scenes' SDFs are evaluated in float32 by
torch and by jax: vertices within 1e-6 m).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu.common import metrics as jmetrics, synthetic as jsyn  # noqa: E402
from xrdslam_tpu.ops import frustum as jfrustum, marching_tets as jmt  # noqa: E402
from xrdslam_tpu.utils import eval_recon as jrecon, io as jio, mesh_ops as jmesh_ops  # noqa: E402
from xrdslam_tpu_torch.common import metrics, synthetic  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.ops import frustum, marching_tets as mt  # noqa: E402
from xrdslam_tpu_torch.utils import eval_recon, io, mesh_ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _volume():
    g = np.linspace(-1.0, 1.0, 28, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    vol = np.sqrt((x - 0.1) ** 2 + (y + 0.05) ** 2 + (z * 1.3) ** 2) - 0.6 + 0.05 * np.sin(7 * x)
    mask = (x + 0.3 * y) < 0.45
    return vol.astype(np.float32), mask


def _assert_same_mesh(got, want, atol=0.0):
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("masked", [False, True])
def test_marching_tetrahedra_matches_jax(path, masked):
    vol, mask = _volume()
    args = (vol, 0.0, (-1.0, -0.9, -1.1), (2 / 27, 2 / 27, 2 / 27), mask if masked else None)
    if path == "native":
        lib, jlib = mt._load_native(), jmt._load_native()
        if lib is None or jlib is None:
            pytest.skip("no C++ compiler: the native library cannot be built")
        got, want = mt._marching_tets_native(lib, *args), jmt._marching_tets_native(jlib, *args)
    else:
        got, want = mt._marching_tets_numpy(*args), jmt._marching_tets_numpy(*args)
    assert got[1].shape[0] > 100
    _assert_same_mesh(got, want)
    assert mt.backend() in ("native", "numpy")


def test_points_in_frustum_matches_jax():
    rng = np.random.default_rng(0)
    cam = Camera(fx=30.0, fy=31.0, cx=15.5, cy=11.5, height=24, width=32)
    from xrdslam_tpu.common.camera import Camera as JCamera

    jcam = JCamera(fx=30.0, fy=31.0, cx=15.5, cy=11.5, height=24, width=32)
    pts = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    poses = []
    for i in range(3):
        c2w = np.eye(4)
        a = 0.7 * i
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        poses.append(c2w)
    for kw in (dict(), dict(near=0.3, far=2.0, edge_margin=2)):
        got = frustum.points_in_frustum(pts, poses, cam, **kw)
        np.testing.assert_array_equal(got, jfrustum.points_in_frustum(pts, poses, jcam, **kw))
        assert 0 < got.sum() < len(pts)


@pytest.fixture(scope="module")
def scene():
    """The simple scene's exact mesh, a noisy copy as a reconstruction, and
    a short sequence to cull them with."""
    kw = dict(n_frames=4, height=24, width=32, scene="simple")
    gt = synthetic.simple_gt_mesh(0.1)
    rng = np.random.default_rng(1)
    rec = io.Mesh(gt.vertices + rng.normal(0, 0.01, gt.vertices.shape).astype(np.float32), gt.faces.copy(),
                  rng.uniform(size=gt.vertices.shape).astype(np.float32))
    return synthetic.SyntheticDataset(**kw), jsyn.SyntheticDataset(**kw), gt, rec


def test_scene_meshes_match_jax(scene):
    _, _, gt, _ = scene
    want = jsyn.simple_gt_mesh(0.1)
    _assert_same_mesh((gt.vertices, gt.faces), (want.vertices, want.faces), atol=1e-6)
    got, want = synthetic.office_gt_mesh(0.1), jsyn.office_gt_mesh(0.1)
    _assert_same_mesh((got.vertices, got.faces), (want.vertices, want.faces), atol=1e-6)
    ds = synthetic.SyntheticDataset(n_frames=1, height=8, width=8, scene="office")
    assert ds.gt_mesh(0.1).faces.shape == got.faces.shape


@pytest.mark.parametrize("eval_rec", [False, True])
def test_cull_and_clean_mesh_match_jax(scene, eval_rec):
    ds, jds, _, rec = scene
    est = [p @ np.diag([1, 1, 1, 1]).astype(np.float32) for p in ds.poses]
    got = mesh_ops.cull_mesh(ds, rec, estimate_c2w_list=est, eval_rec=eval_rec)
    want = jmesh_ops.cull_mesh(jds, jio.Mesh(rec.vertices, rec.faces, rec.vertex_colors), estimate_c2w_list=est,
                               eval_rec=eval_rec)
    assert 0 < got.faces.shape[0] < rec.faces.shape[0]
    _assert_same_mesh((got.vertices, got.faces), (want.vertices, want.faces))
    np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)
    got_c = mesh_ops.clean_mesh(got, min_len=50)
    want_c = jmesh_ops.clean_mesh(want, min_len=50)
    _assert_same_mesh((got_c.vertices, got_c.faces), (want_c.vertices, want_c.faces))


def test_calc_3d_metric_matches_jax(scene):
    _, _, gt, rec = scene
    got = eval_recon.calc_3d_metric(rec, gt, n_points=20000)
    want = jrecon.calc_3d_metric(jio.Mesh(rec.vertices, rec.faces), jio.Mesh(gt.vertices, gt.faces), n_points=20000)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    assert 0.0 < got["accuracy_cm"] < 10.0 and 0.0 < got["completion_ratio_pct"] <= 100.0


def test_render_metrics_match_jax():
    rng = np.random.default_rng(2)
    gt = rng.uniform(size=(60, 70, 3))
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1)
    depth = rng.uniform(0.5, 3, (60, 70))
    depth[::7] = 0.0
    pd = depth + rng.normal(0, 0.01, depth.shape)
    mask = depth > 0
    for name in ("psnr", "ssim", "ms_ssim"):
        args = (pred, gt, mask) if name == "psnr" else (pred, gt)
        assert getattr(metrics, name)(*args) == getattr(jmetrics, name)(*args)
    assert metrics.ssim(pred[..., 0], gt[..., 0]) == jmetrics.ssim(pred[..., 0], gt[..., 0])
    assert metrics.depth_l1(pd, depth, mask) == jmetrics.depth_l1(pd, depth, mask)
    assert metrics.depth_l1(pd, depth) == jmetrics.depth_l1(pd, depth)


def test_ply_round_trip_reads_in_both_packages(scene, tmp_path):
    _, _, _, rec = scene
    for colors in (rec.vertex_colors, None):
        path = os.path.join(tmp_path, "m.ply")
        io.Mesh(rec.vertices, rec.faces, colors).export(path)
        got, want = io.read_ply(path), jio.read_ply(path)
        for m in (got, want):
            np.testing.assert_array_equal(m.vertices, rec.vertices)
            np.testing.assert_array_equal(m.faces, rec.faces)
        if colors is not None:
            np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)
