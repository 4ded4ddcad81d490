"""The port's offline evaluation against the JAX package's.

The same meshes (the synthetic office's exact mesh at 40 cm, 7,576 faces:
the rasterizer's hybrid path) go through both packages on the CPU:

* ``calc_2d_metric`` at 3 views of 64x64, without unseen points and
  without alignment, and with unseen points (rejected views: the same
  draws) after the ICP alignment: the same depth-L1 within 1e-3 cm (the
  renders agree within 1e-5 m) over the same number of views;
* ``evaluate_3d_reconstruction`` on a shifted copy at tau 5 cm: the same
  precision, recall, F-score, curves and distance statistics, and the same
  bytes in each of the files it writes;
* ``ds-eval``'s ``main`` and the JAX package's ``main``, each on its own
  copy of one fabricated outputs dir (a 20-frame trajectory with 3 mm
  noise, the office mesh jittered by 2 mm as the reconstruction, an
  ``eval_2d.json``): ``eval_result.json`` with the same keys, every number
  within 1e-9 of JAX's (relative) but the unseen-view depth-L1, within
  1e-3 cm; the ATE plot; a CUDA device where there is none raises.
"""
import json
import os
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu.scripts import eval as jeval  # noqa: E402
from xrdslam_tpu.utils import eval_recon as jrecon  # noqa: E402
from xrdslam_tpu.utils.io import Mesh as JMesh  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.scripts import eval as teval  # noqa: E402
from xrdslam_tpu_torch.utils import eval_recon  # noqa: E402
from xrdslam_tpu_torch.utils.io import Mesh  # noqa: E402

DEPTH_L1_ATOL_CM = 1e-3
REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def office():
    """The office's exact mesh at 40 cm, and the same shifted by (1, -2, 3) cm."""
    gt = SyntheticDataset(n_frames=2, height=32, width=32, scene="office").gt_mesh(voxel=0.4)
    return gt, Mesh(gt.vertices + np.array([0.01, -0.02, 0.03], np.float32), gt.faces)


def _jax_mesh(m):
    return JMesh(m.vertices, m.faces, m.vertex_colors)


@pytest.mark.parametrize("unseen", [False, True])
def test_calc_2d_metric_matches_jax(office, unseen):
    gt, rec = office
    pc_unseen = None
    if unseen:  # points near the room's middle: some drawn views see them and are drawn again
        pc_unseen = np.random.default_rng(0).uniform(-0.5, 0.5, (8, 3)) + gt.vertices.mean(0)
    kw = dict(n_imgs=3, align=unseen, pc_unseen=pc_unseen, height=64, width=64, focal=40.0)
    got = eval_recon.calc_2d_metric(rec, gt, device="cpu", **kw)
    want = jrecon.calc_2d_metric(_jax_mesh(rec), _jax_mesh(gt), **kw)
    assert got["views"] == 3 and got["render_s_per_view"] > 0
    assert np.isfinite(got["depth_l1_cm"]) and got["depth_l1_cm"] > 0
    assert abs(got["depth_l1_cm"] - want["depth_l1_cm"]) <= DEPTH_L1_ATOL_CM, (got, want)


def test_evaluate_3d_reconstruction_matches_jax(office, tmp_path):
    gt, rec = office
    got = eval_recon.evaluate_3d_reconstruction(rec, gt, distance_thresh=0.05, out_dir=str(tmp_path / "port"),
                                                scene_name="sc")
    want = jrecon.evaluate_3d_reconstruction(_jax_mesh(rec), _jax_mesh(gt), distance_thresh=0.05,
                                             out_dir=str(tmp_path / "jax"), scene_name="sc")
    assert set(got) == set(want)
    for k in ("precision", "recall", "fscore"):
        assert got[k] == want[k], k
    assert got["dist_stats"] == want["dist_stats"]
    for k in ("edges_source", "cum_source", "edges_target", "cum_target", "transform"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0.0 < got["fscore"] <= 1.0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for name in names:
        with open(tmp_path / "port" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name


def _outputs_dir(root, office):
    """An outputs dir as a run leaves it, and the ground-truth mesh's path."""
    out = str(root / "outputs")
    os.makedirs(os.path.join(out, "mesh"))
    rng = np.random.default_rng(0)
    gt_poses, est = [], []
    for i in range(20):
        p = np.eye(4)
        p[:3, 3] = [0.1 * i, 0.02 * i, 1.0]
        gt_poses.append(p)
        q = p.copy()
        q[:3, 3] += rng.normal(0, 0.003, 3)
        est.append(q)
    with open(os.path.join(out, "eval.tar"), "wb") as f:
        pickle.dump({"gt_c2w_list": gt_poses, "estimate_c2w_list": est}, f)
    gt = office[0]
    gt_path = str(root / "gt.ply")
    gt.export(gt_path)
    Mesh(gt.vertices + rng.normal(0, 0.002, gt.vertices.shape).astype(np.float32), gt.faces).export(
        os.path.join(out, "mesh", "final_mesh_rec.ply"))
    with open(os.path.join(out, "eval_2d.json"), "w") as f:
        json.dump({"psnr": 30.0, "ssim": 0.9, "ms_ssim": 0.95, "lpips": None, "depth_l1": 1.0, "frames": 2}, f)
    return out, gt_path


def _hold(got, want, path):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _hold(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=REL,
                                   err_msg=path)
    elif isinstance(want, (int, float)) and want is not None:
        tol = DEPTH_L1_ATOL_CM if path == ".unseen_depth_l1_cm" else REL * abs(want)
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, path


def test_ds_eval_matches_jax(tmp_path, office):
    port_out, gt_path = _outputs_dir(tmp_path, office)
    jax_out = str(tmp_path / "jax_outputs")
    shutil.copytree(port_out, jax_out)
    args = ["--gt-mesh", gt_path, "--distance-thresh", "0.05", "--n-imgs-2d", "3"]
    res = teval.main(["--output", port_out, *args, "--device", "cpu"])
    jeval.main(["--output", jax_out, *args])
    with open(os.path.join(port_out, "eval_result.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_out, "eval_result.json")) as f:
        want = json.load(f)
    _hold(got, want, "")
    assert got["ate_rmse_cm"] < 1.0 and np.isfinite(got["unseen_depth_l1_cm"])
    assert got["render_metrics"]["psnr"] == 30.0
    assert set(res["seconds"]) == {"ate", "3d", "tnt", "2d", "2d_render_s_per_view"}
    assert os.path.exists(os.path.join(port_out, "eval_ate_plot.png"))
    assert os.path.exists(os.path.join(port_out, "tnt", "scene.recall.ply"))
    if not torch.cuda.is_available():  # before any work
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teval.main(["--output", str(tmp_path / "absent"), *args])
