"""NeuralRecon in the port against the JAX package: host code, the
pipeline run, training and checkpoints.

* The host helpers give JAX's arrays: ``_resize_bilinear`` (down and up),
  ``_rotate_view_to_align_xyplane`` (random and degenerate views),
  ``_GlobalVolume`` (growing on both sides, masked writes), the keyframe
  gating, ``_fragment_inputs`` (with and without a crop of the image) and
  ``level_targets`` (exactly; the port's scene SDF in float64 against
  JAX's numpy SDF: the same occupancy, TSDF to 1e-6).
* The pipeline run: ``tests/test_neucon.py::test_neuralrecon_pipeline_smoke``'s
  configuration (8 frames of 48x64, n_vox 32, window 3, no gating) through
  both pipelines with the same weights and frames: the same fragment count,
  volume origins and shapes, occupancy on >= 99.9% of the voxels, TSDF
  where both are occupied and the hidden volumes to 1e-2 of the largest
  (float32: the cascade's instance norms amplify rounding, see
  ``test_torch_neucon.py``).
* Training: ``train_sequence`` on the run's first two fragments, one step
  each (the second reads the first's hidden state), from the same
  parameters: the first loss to 1e-5, the second, after an Adam step, to
  1e-2. In float32 each package's gradient is itself ~1% (median over the
  leaves; 10-14% at worst) from its float64 value at these random
  weights, and Adam's first step moves each weight by the learning rate
  times the sign of its gradient, so the second loss reads ~0.6% apart;
  in float64 the two read 7e-8 apart at both steps (too slow for this
  suite: ~100 s). ``test_torch_neucon.py`` holds the gradients in
  float64.
* Checkpoints written by either package load in the other, bit for bit.
* The registry's ``neuralRecon`` entry equals the JAX one, and a tiny CLI
  run on the CPU fuses a fragment.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.algorithms import neural_recon as R  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.models import neucon as T  # noqa: E402
from xrdslam_tpu_torch.pipeline.slam import MapperConfig, SLAMPipelineConfig, TrackerConfig  # noqa: E402
from xrdslam_tpu_torch.utils import neucon_train as NT  # noqa: E402

N_FRAMES, H, W = 8, 48, 64
N_VOX, VOXEL = 32, 0.15
SMOKE = dict(mapping_window_size=3, min_angle=0.0, min_distance=0.0, max_depth=3.0, img_size_w=W, img_size_h=H)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, what, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


class FramesOf:
    """A dataset of another package's frames, as numpy."""

    def __init__(self, ds):
        self.ds = ds
        c = ds.get_camera()
        self.camera = Camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, height=c.height, width=c.width)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        idx, rgb, depth, c2w = self.ds[i]
        return idx, np.asarray(rgb), np.asarray(depth), np.asarray(c2w)

    def get_camera(self):
        return self.camera


@pytest.fixture(scope="module")
def tree():
    return T._init_tree(0)


def _jax_model_config(tree):
    """The JAX model config at the smoke's size whose model carries ``tree``
    (the JAX model's own init draws ~100 random arrays op by op, ~35 s here)."""
    import jax
    import jax.numpy as jnp

    from xrdslam_tpu.models import neucon as J

    def make(config):
        m = object.__new__(J.NeuCon)
        m.config = config
        m.params = jax.tree_util.tree_map(jnp.asarray, tree)
        return m

    return J.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL, _target=make)


def _cv_frames(ds, frame_cls):
    """Frames at the poses NeuralRecon's tracking gives them (the dataset's
    OpenGL c2w with y and z flipped)."""
    frames = []
    for i in range(len(ds)):
        _, rgb, depth, c2w = ds[i]
        cv = np.asarray(c2w, np.float32).copy()
        cv[:3, 1] *= -1
        cv[:3, 2] *= -1
        frames.append(frame_cls(fid=i, rgb=np.asarray(rgb), depth=np.asarray(depth), init_pose=cv, gt_pose=c2w,
                                rot_rep="quat"))
    return frames


@pytest.fixture(scope="module")
def jax_run(tree, tmp_path_factory):
    """The JAX smoke's pipeline run on ``tree``: (its pipeline, its dataset)."""
    pytest.importorskip("jax")
    from xrdslam_tpu.algorithms.neural_recon import NeuralReconConfig as JConfig
    from xrdslam_tpu.common.synthetic import SyntheticDataset
    from xrdslam_tpu.pipeline import slam as jslam

    ds = SyntheticDataset(n_frames=N_FRAMES, height=H, width=W)
    cfg = jslam.SLAMPipelineConfig(
        tracker=jslam.TrackerConfig(map_every=1, render_freq=-1, use_relative_pose=False,
                                    save_re_render_result=False),
        mapper=jslam.MapperConfig(keyframe_every=100),
        algorithm=JConfig(**SMOKE, model=_jax_model_config(tree)))
    pipe = cfg.setup(dataset=ds, out_dir=str(tmp_path_factory.mktemp("jax_neucon")), verbose=False)
    pipe.run()
    return pipe, ds


def _port_algo(camera, tree=None):
    algo = R.NeuralReconConfig(**SMOKE, model=T.NeuConModelConfig(n_vox=N_VOX, voxel_size=VOXEL)).setup(
        camera=camera, device=torch.device("cpu"))
    if tree is not None:
        from xrdslam_tpu_torch.utils.from_jax import neucon_params_from_jax

        neucon_params_from_jax(tree, algo.model)
    return algo


def test_host_helpers_match_jax():
    from xrdslam_tpu.algorithms import neural_recon as J

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    for h, w in ((31, 45), (48, 64), (40, 52)):
        np.testing.assert_array_equal(R._resize_bilinear(img, h, w), J._resize_bilinear(img, h, w))
    poses = [np.eye(4)]
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        a, b, c, d = q
        pose = np.eye(4)
        pose[:3, :3] = [[a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                        [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
                        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d]]
        pose[:3, 3] = rng.normal(size=3)
        poses.append(pose)
    down = np.eye(4)
    down[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]  # the camera's -y is world z: no rotation needed
    poses.append(down)
    for p in poses:
        np.testing.assert_array_equal(R._rotate_view_to_align_xyplane(p), J._rotate_view_to_align_xyplane(p))
        for q in poses:
            want = None
            for angle, dist in ((15.0, 0.1), (90.0, 10.0), (0.0, 0.0)):
                ja = J.NeuralRecon.__new__(J.NeuralRecon)
                ja.config = J.NeuralReconConfig(min_angle=angle, min_distance=dist)
                ja.frag_frames = [type("F", (), {"get_pose": lambda self, p=p: p})()]
                ja.check_keyframe(type("F", (), {"get_pose": lambda self, q=q: q})())
                want = len(ja.frag_frames) == 2
                assert R.keyframe_passes(p, q, angle, dist) == want
    # the volumes: grow on both sides, masked writes, crops of unwritten space
    for channels, fill in ((0, 1.0), (3, 0.0)):
        got, want = R._GlobalVolume(channels, fill), J._GlobalVolume(channels, fill)
        for lo, dim in (([0, 0, 0], 4), ([-3, 2, 1], 4), ([5, -2, -6], 3), ([1, 1, 1], 2)):
            lo = np.array(lo)
            block = rng.normal(size=(dim,) * 3 + ((channels,) if channels else ())).astype(np.float32)
            mask = rng.uniform(size=(dim,) * 3) > 0.5
            for v in (got, want):
                v.write(lo, block, mask=mask if dim != 2 else None)
            np.testing.assert_array_equal(got.data, want.data)
            np.testing.assert_array_equal(got.origin, want.origin)
            np.testing.assert_array_equal(got.crop(lo - 1, dim + 2), want.crop(lo - 1, dim + 2))
            np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("size", [(H, W), (H + 12, W + 8)])
def test_fragment_inputs_and_targets_match_jax(tree, size):
    """The camera at the configured size, and larger (cropped, then resized)."""
    from xrdslam_tpu.algorithms.neural_recon import NeuralReconConfig as JConfig
    from xrdslam_tpu.common.frame import Frame as JFrame
    from xrdslam_tpu.common.synthetic import SyntheticDataset, scene_sdf
    from xrdslam_tpu.utils import neucon_train as JT

    ds = SyntheticDataset(n_frames=N_FRAMES, height=size[0], width=size[1])
    jalgo = JConfig(**SMOKE, model=_jax_model_config(tree)).setup(camera=ds.get_camera())
    algo = _port_algo(FramesOf(ds).get_camera())
    assert (algo.h_crop, algo.w_crop) == (jalgo.h_crop, jalgo.w_crop)
    np.testing.assert_array_equal(algo.cam_intr, jalgo.cam_intr)
    jfrags = JT.collect_fragments(jalgo, _cv_frames(ds, JFrame))
    frags = NT.collect_fragments(algo, _cv_frames(FramesOf(ds), Frame))
    assert len(frags) == len(jfrags) == 2
    for f, jf in zip(frags, jfrags):
        for k in ("imgs", "projs", "vol_origin"):
            np.testing.assert_array_equal(f[k].numpy(), np.asarray(jf[k]), err_msg=k)
        np.testing.assert_array_equal(f["origin_vox"], jf["origin_vox"])
        np.testing.assert_array_equal(f["aligned_T"], np.asarray(jf["aligned_T"]))
        assert [x.fid for x in f["frames"]] == [x.fid for x in jf["frames"]]
    if size == (H, W):  # the targets of the first fragment, from each package's SDF
        f = frags[0]
        tsdf, occ = NT.level_targets(algo.model.config, f["vol_origin"].numpy(), NT.scene_sdf_numpy("simple"),
                                     f["frames"], algo.camera)
        jtsdf, jocc = JT.level_targets(jalgo.model.config, np.asarray(jfrags[0]["vol_origin"]), scene_sdf,
                                       jfrags[0]["frames"], jalgo.camera)
        for a, b, c, d in zip(tsdf, jtsdf, occ, jocc):
            np.testing.assert_array_equal(c.numpy(), np.asarray(d))
            _close(a.numpy(), b, "tsdf target", 1e-6)
            assert 0 < float(c.numpy().mean()) < 1


def test_pipeline_run_matches_jax(jax_run, tree, tmp_path):
    pipe, ds = jax_run
    cfg = SLAMPipelineConfig(tracker=TrackerConfig(map_every=1), mapper=MapperConfig(keyframe_every=100),
                             algorithm=R.NeuralReconConfig(**SMOKE, model=T.NeuConModelConfig(n_vox=N_VOX,
                                                                                               voxel_size=VOXEL)),
                             device="cpu")
    port = cfg.setup(dataset=FramesOf(ds), out_dir=str(tmp_path), verbose=False)
    from xrdslam_tpu_torch.utils.from_jax import neucon_params_from_jax

    neucon_params_from_jax(tree, port.algorithm.model)
    port.run()
    got, want = port.algorithm, pipe.algorithm
    assert got.fragment_id == want.fragment_id == 2
    np.testing.assert_array_equal(np.stack(got.estimate_c2w_list), np.stack(want.estimate_c2w_list))
    for g, w in [(got.tsdf_vol, want.tsdf_vol), (got.occ_vol, want.occ_vol)] + list(zip(got.hidden_vols,
                                                                                       want.hidden_vols)):
        np.testing.assert_array_equal(g.origin, w.origin)
        assert g.data.shape == w.data.shape
    occ, jocc = got.occ_vol.data > 0, want.occ_vol.data > 0
    agree = float((occ == jocc).mean())
    assert agree >= 0.999, agree
    both = occ & jocc
    assert both.sum() > 100
    _close(got.tsdf_vol.data[both], want.tsdf_vol.data[both], "tsdf", 1e-2)
    for i, (g, w) in enumerate(zip(got.hidden_vols, want.hidden_vols)):
        _close(g.data, w.data, f"hidden {i}", 1e-2)
    assert np.abs(got.hidden_vols[-1].data).max() > 0
    mesh = got.get_mesh()
    jmesh = want.get_mesh()
    assert (mesh is None) == (jmesh is None)
    pts, _ = got.get_cloud()
    jpts, _ = want.get_cloud()
    assert abs(len(pts) - len(jpts)) <= 1e-3 * len(jpts)


def test_training_steps_track_jax(jax_run, tree):
    from xrdslam_tpu.common.frame import Frame as JFrame
    from xrdslam_tpu.common.synthetic import scene_sdf
    from xrdslam_tpu.utils import neucon_train as JT

    pipe, ds = jax_run
    jfrags = JT.collect_fragments(pipe.algorithm, _cv_frames(ds, JFrame))[:2]
    _, jlosses = JT.train_sequence(pipe.algorithm, jfrags, scene_sdf, epochs=1, steps_per_fragment=1)
    algo = _port_algo(FramesOf(ds).get_camera(), tree)
    frags = NT.collect_fragments(algo, _cv_frames(FramesOf(ds), Frame))[:2]
    params, losses = NT.train_sequence(algo, frags, NT.scene_sdf_numpy("simple"), epochs=1, steps_per_fragment=1)
    assert len(losses) == len(jlosses) == 2
    _close(losses[0], jlosses[0], "the first loss", 1e-5)
    _close(losses[1], jlosses[1], "the second loss", 1e-2)
    # trained in a copy: the model's own parameters are untouched
    np.testing.assert_array_equal(T.params_to_numpy(algo.model.params)["gru0"]["convz"]["w"],
                                  tree["gru0"]["convz"]["w"])
    assert not np.array_equal(T.params_to_numpy(params)["gru0"]["convz"]["w"], tree["gru0"]["convz"]["w"])


def test_checkpoints_load_across_packages(tree, tmp_path):
    import jax

    from xrdslam_tpu.utils import neucon_train as JT

    jtree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    JT.save_params(str(tmp_path / "jax.npz"), jtree)
    like = T.params_from_numpy(T._init_tree(1), "cpu")
    got = NT.load_params(str(tmp_path / "jax.npz"), like)
    for (p, a), (q, b) in zip(T.leaves(T.params_to_numpy(got)), T.leaves(tree)):
        assert p == q
        np.testing.assert_array_equal(a, b)
    NT.save_params(str(tmp_path / "port.npz"), got)
    back = JT.load_params(str(tmp_path / "port.npz"), jtree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_registry_entry_equals_the_reference():
    pytest.importorskip("jax")
    from xrdslam_tpu.configs.registry import algorithm_configs as jconfigs

    got, want = algorithm_configs["neuralRecon"].xrdslam, jconfigs["neuralRecon"].xrdslam
    for node in ("algorithm", "algorithm.model"):
        g, w = got, want
        for k in node.split("."):
            g, w = getattr(g, k), getattr(w, k)
        for f in dataclasses.fields(g):
            if f.name in ("_target", "model", "optimizers"):
                continue
            assert getattr(g, f.name) == getattr(w, f.name), f"{node}.{f.name}"
    for k in ("map_every", "use_relative_pose"):
        assert getattr(got.tracker, k) == getattr(want.tracker, k), k
    assert got.device == "cuda"


def test_cli_fuses_a_fragment_on_the_cpu(tmp_path, capsys):
    from xrdslam_tpu_torch.scripts.run import main

    runner = main(["neuralRecon", "--data-type", "synthetic", "--data", f"n_frames=6,height={H},width={W}",
                   "--out-dir", str(tmp_path), "--xrdslam.device", "cpu",
                   "--xrdslam.algorithm.mapping-window-size", "3", "--xrdslam.algorithm.min-angle", "0",
                   "--xrdslam.algorithm.min-distance", "0", "--xrdslam.algorithm.img-size-w", str(W),
                   "--xrdslam.algorithm.img-size-h", str(H), "--xrdslam.algorithm.model.n-vox", str(N_VOX),
                   "--xrdslam.algorithm.model.voxel-size", str(VOXEL)])
    algo = runner.pipeline.algorithm
    assert algo.fragment_id == 1 and np.isfinite(algo.tsdf_vol.data).all()
    assert "pretrained weights not found" in capsys.readouterr().out
    assert (tmp_path / "eval.tar").exists()
