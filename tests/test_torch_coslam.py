"""Co-SLAM in the port: step parity with the JAX package for each of its
three scene encodings, the full-image render and the mesh, the per-frame
run through the CLI entry point, and the port's boundaries (no jax import,
no CPU fallback for a CUDA request, unported options refused).

Step parity carries a small JAX JointEncoding over with ``params_from_jax``
and compares ``get_loss`` and its gradients on the same rays, with the z
jitter off, for the exact hash, the packed hash (the registry's default)
and the tri-plane. The encodings' position gradients differ outside
[0,1]^3 (the JAX exact hash on the CPU runs its plain reference, zeroed
there; the port's follows the TPU kernel and is not); the bounds here keep
every sample inside the box, so both compute the same function.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.algorithms.base import Algorithm as JAlgorithm, AlgorithmConfig as JAlgorithmConfig  # noqa: E402
from xrdslam_tpu.algorithms.coslam import CoSLAMConfig as JCoSLAMConfig  # noqa: E402
from xrdslam_tpu.common.mesher import MesherConfig as JMesherConfig  # noqa: E402
from xrdslam_tpu.common.camera import Camera as JCamera  # noqa: E402
from xrdslam_tpu.common.frame import Frame as JFrame  # noqa: E402
from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset  # noqa: E402
from xrdslam_tpu.models.joint_encoding import JointEncodingConfig as JJointEncodingConfig  # noqa: E402
from xrdslam_tpu.ops import lie as jlie, sampling as jsamp  # noqa: E402
from xrdslam_tpu_torch.algorithms.base import Algorithm, AlgorithmConfig  # noqa: E402
from xrdslam_tpu_torch.algorithms.coslam import CoSLAMConfig  # noqa: E402
from xrdslam_tpu_torch.common.mesher import MesherConfig  # noqa: E402
from xrdslam_tpu_torch.common.camera import Camera  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.engine.optimizers import AdamOptimizerConfig, GroupOptimizers  # noqa: E402
from xrdslam_tpu_torch.models.joint_encoding import JointEncoding, JointEncodingConfig  # noqa: E402
from xrdslam_tpu_torch.ops import lie  # noqa: E402
from xrdslam_tpu_torch.pipeline.slam import SLAMPipelineConfig, resolve_device  # noqa: E402
from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate  # noqa: E402
from xrdslam_tpu_torch.utils.from_jax import params_from_jax  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = dict(fx=50.0, fy=50.0, cx=29.5, cy=19.5, height=40, width=60)
BOUND = np.array([[-6.0, 6.0]] * 3, np.float32)  # every sample of a 5 m ray from near the centre is inside
MODEL = dict(n_levels=4, hashsize=10, base_resolution=8, training_perturb=0)
# the three scene encodings: the exact per-vertex hash, the packed hash (the
# registry's default) and two scales of small tri-planes
ENCODINGS = {"exact": dict(hash_packed=False), "packed": dict(hash_packed=True),
             "triplane": dict(encoding="triplane", triplane_resolutions=(16, 32), triplane_features=(4, 4))}
REL = 1e-4


@pytest.fixture(scope="module", params=list(ENCODINGS))
def models(request):
    kw = {**MODEL, **ENCODINGS[request.param]}
    jmodel = JJointEncodingConfig(**kw).setup(camera=JCamera(**CAM), bounding_box=BOUND)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = JointEncoding(JointEncodingConfig(**kw), Camera(**CAM), BOUND)
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), tmodel)
    assert tmodel.spec == jmodel.spec and any(tmodel.spec.dense) and not all(tmodel.spec.dense)
    assert tmodel.input_ch == jmodel.input_ch
    return jmodel, params, tmodel


def _jax_tables(grads):
    """The JAX table gradient(s) as {name: array}, named as in the port."""
    t = grads["embed_fn"]["table"]
    return dict(t) if isinstance(t, dict) else {"": t}


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(0)
    n = 96
    u, v = rng.integers(0, CAM["width"], n), rng.integers(0, CAM["height"], n)
    dirs = np.asarray(jsamp.camera_ray_dirs(JCamera(**CAM)))[v, u]
    ts = rng.uniform(size=(n, 3)).astype(np.float32)
    td = rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    td[::9] = 0.0  # invalid depth
    r0 = (0.2 * rng.standard_normal(3)).astype(np.float32)
    t0 = (0.3 * rng.standard_normal(3)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return dirs, ts, td, r0, t0, mask


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= REL * scale, f"{what}: max abs err {err:.3e} > {REL} x {scale:.3e}"


def test_tracking_loss_and_pose_grads_match_jax(models, rays):
    jmodel, params, tmodel = models
    dirs, ts, td, r0, t0, _ = rays

    def jloss(r, t):
        rd = jnp.asarray(dirs) @ jlie.axis_angle_to_matrix(r).T
        loss, _ = jmodel.get_loss(params, jax.random.PRNGKey(1), jnp.broadcast_to(t, rd.shape), rd,
                                  jnp.asarray(ts), jnp.asarray(td), None, False, False)
        return loss

    want, (gr, gt) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(r0), jnp.asarray(t0))
    r = torch.tensor(r0, requires_grad=True)
    t = torch.tensor(t0, requires_grad=True)
    rd = torch.from_numpy(dirs) @ lie.axis_angle_to_matrix(r).T
    loss, _ = tmodel.get_loss(t.expand(rd.shape), rd, torch.from_numpy(ts), torch.from_numpy(td), None, False, False,
                              packed=tmodel.pack_tables())
    got_r, got_t = torch.autograd.grad(loss, [r, t])
    _close(loss.item(), float(want), "loss")
    _close(got_r.numpy(), gr, "d loss / d r")
    _close(got_t.numpy(), gt, "d loss / d t")


def test_first_mapping_loss_and_map_grads_match_jax(models, rays):
    jmodel, params, tmodel = models
    dirs, ts, td, r0, t0, mask = rays
    rd = np.asarray(jnp.asarray(dirs) @ jlie.axis_angle_to_matrix(jnp.asarray(r0)).T)
    ro = np.broadcast_to(t0, rd.shape).copy()

    def jloss(p):
        loss, _ = jmodel.get_loss(p, jax.random.PRNGKey(1), jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(ts),
                                  jnp.asarray(td), jnp.asarray(mask), True, True)
        return loss

    want, grads = jax.jit(jax.value_and_grad(jloss))(params)
    loss, _ = tmodel.get_loss(*(torch.tensor(a) for a in (ro, rd, ts, td, mask)), True, True)
    groups = tmodel.param_groups()
    n_tables = len(groups["embed_fn"])
    got = torch.autograd.grad(loss, groups["embed_fn"] + groups["decoder"])
    _close(loss.item(), float(want), "loss")
    names = [""] if n_tables == 1 else list(tmodel.embed_fn.keys())
    jt = _jax_tables(grads)
    assert sorted(jt) == sorted(names)
    for name, g in zip(names, got[:n_tables]):
        # the reference pads a packed dense level's rows; its vertex-grid gradient has no padding
        _close(g.numpy(), jt[name], f"d loss / d table {name}")
    jw = grads["decoder"]["sdf"]["w"] + grads["decoder"]["color"]["w"]
    for i, (g, w) in enumerate(zip(got[n_tables:], jw)):
        _close(g.numpy().T, w, f"d loss / d decoder weight {i}")


def test_later_mapping_loss_and_smoothness_match_jax(models, rays, monkeypatch):
    """A mapping step after the first adds the smoothness term: the hash
    encodings' TV over a random sub-grid (both sides get the JAX draws of
    its offset and jitter), the tri-plane's TV on the planes (no draws).
    Its weight is 1e-6, so the unweighted TV and its own table gradient
    are held apart from the total's."""
    jmodel, params, tmodel = models
    dirs, ts, td, r0, t0, mask = rays
    rd = np.asarray(jnp.asarray(dirs) @ jlie.axis_angle_to_matrix(jnp.asarray(r0)).T)
    ro = np.broadcast_to(t0, rd.shape).copy()
    key = jax.random.PRNGKey(1)
    k_smooth = jax.random.split(key)[1]
    k1, k2 = jax.random.split(k_smooth)
    draws = [np.asarray(jax.random.uniform(k1, (3,))), np.asarray(jax.random.uniform(k2, (1, 1, 1, 3)))]
    hashed = tmodel.tp_spec is None

    def feed_draws():  # torch.rand gives the sub-grid's offset, then its jitter
        queue = list(draws) if hashed else []

        def rand(*size, **kw):
            want_draw = queue.pop(0)
            assert tuple(np.atleast_1d(size[0] if len(size) == 1 else size)) == want_draw.shape
            return torch.tensor(want_draw)

        monkeypatch.setattr(torch, "rand", rand)
        return queue

    def jloss(p):
        return jmodel.get_loss(p, key, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(ts), jnp.asarray(td),
                               jnp.asarray(mask), True, False)

    (want, jparts), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    jtv, jtv_grads = jax.jit(jax.value_and_grad(lambda p: jmodel.smoothness(p, k_smooth)))(params)
    queue = feed_draws()
    loss, parts = tmodel.get_loss(*(torch.tensor(a) for a in (ro, rd, ts, td, mask)), True, False)
    assert not queue
    queue = feed_draws()
    tv = tmodel.smoothness()
    assert not queue
    monkeypatch.undo()
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        if k != "smooth_loss":
            _close(parts[k].item(), float(jparts[k]), k)
    _close(loss.item(), float(want), "loss")
    _close(tv.item(), float(jtv), "smoothness")
    tables = tmodel.param_groups()["embed_fn"]
    names = [""] if len(tables) == 1 else list(tmodel.embed_fn.keys())
    got = torch.autograd.grad(loss, tables)
    got_tv = torch.autograd.grad(tv, tables)
    jt, jtv_t = _jax_tables(grads), _jax_tables(jtv_grads)
    for name, g, gs in zip(names, got, got_tv):
        _close(g.numpy(), jt[name], f"d loss / d table {name}")
        _close(gs.numpy(), jtv_t[name], f"d smoothness / d table {name}")


def test_query_sdf_matches_jax(models):
    jmodel, params, tmodel = models
    pts = np.random.default_rng(1).uniform(-5.0, 5.0, (7, 11, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.query_sdf)(params, jnp.asarray(pts)))
    with torch.no_grad():
        got = tmodel.query_sdf(torch.tensor(pts)).numpy()
    assert got.shape == (7, 11)
    _close(got, want, "sdf")


def test_unported_encodings_are_refused():
    # every encoding is ported; a separate color grid is not
    for enc in ENCODINGS.values():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            JointEncoding(JointEncodingConfig(oneGrid=False, **enc), Camera(**CAM), BOUND)
    with pytest.raises(ValueError, match="encoding"):
        JointEncoding(JointEncodingConfig(encoding="dense"), Camera(**CAM), BOUND)


def test_cuda_request_without_cuda_raises():
    assert SLAMPipelineConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True, text=True)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_no_jax_in_the_port():
    code = ("import importlib, pkgutil, sys, xrdslam_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'xrdslam_tpu_torch.'): importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'xrdslam_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, env={**os.environ, "PYTHONPATH": REPO})


def test_finite_guard_zeroes_and_adam_still_steps():
    good = [torch.ones(3), torch.full((2,), 2.0)]
    assert all(torch.equal(a, b) for a, b in zip(Algorithm._finite_guard(torch.tensor(0.5), good), good))
    bad = [torch.ones(3), torch.tensor([1.0, float("nan")])]
    for loss in (torch.tensor(0.5), torch.tensor(float("inf"))):
        assert all(float(g.abs().sum()) == 0.0 for g in Algorithm._finite_guard(loss, bad))
    # as in the reference, a zeroed step is weakened, not skipped: Adam moves on its momentum
    p = [torch.zeros(3)]
    opt = GroupOptimizers({"g": AdamOptimizerConfig(lr=0.1)})
    st = opt.init({"g": p})
    opt.update({"g": [torch.ones(3)]}, st, {"g": p})
    before = p[0].clone()
    opt.update({"g": Algorithm._finite_guard(torch.tensor(float("nan")), [torch.ones(3)])}, st, {"g": p})
    assert not torch.equal(p[0], before)


def test_tracking_lr_schedule_matches_jax():
    cam = JCamera(**CAM)
    jsched = JAlgorithm(JAlgorithmConfig(tracking_lr_decay=0.05, tracking_n_iters=10), cam)._tracking_lr_schedule(1e-3)
    tsched = Algorithm(AlgorithmConfig(tracking_lr_decay=0.05, tracking_n_iters=10), Camera(**CAM),
                       "cpu")._tracking_lr_schedule(1e-3)
    for step in range(10):
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-6)
    assert Algorithm(AlgorithmConfig(), Camera(**CAM), "cpu")._tracking_lr_schedule(1e-3) is None


@pytest.mark.parametrize("scene", ["simple", "office"])
def test_synthetic_frames_and_upload_match_jax(scene):
    kw = dict(n_frames=3, height=12, width=16, scene=scene)
    _, rgb_j, depth_j, pose_j = JSyntheticDataset(**kw)[2]
    _, rgb, depth, pose = SyntheticDataset(**kw)[2]
    np.testing.assert_array_equal(pose, pose_j)
    np.testing.assert_allclose(depth, depth_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(rgb, rgb_j, atol=1e-3, rtol=0)
    # the uint16 round trip gives both packages the same pixel values
    f_j = JFrame(fid=0, rgb=rgb_j, depth=depth_j)
    np.testing.assert_array_equal(Frame(fid=0, rgb=rgb_j, depth=depth_j).rgb_dev(torch.device("cpu")).numpy(),
                                  np.asarray(f_j.rgb_jax()))


@pytest.mark.parametrize("scene", ["simple", "office"])
def test_kept_renders_equal_fresh_traces(scene):
    """With ``keep_renders`` on, a longer sequence takes a shorter one's
    frames (copies) and traces only the rest, in other batches; every frame
    equals a fresh dataset's, bit for bit."""
    from xrdslam_tpu_torch.common import synthetic

    kw = dict(height=12, width=16, scene=scene)
    synthetic.keep_renders()
    try:
        short = SyntheticDataset(n_frames=3, **kw)
        short.prerender(batch=2)
        longer = SyntheticDataset(n_frames=5, **kw)
        longer.prerender(batch=8)
        assert (short.n_shared, longer.n_shared) == (0, 3)
        assert longer[1][1] is not short[1][1]
    finally:
        synthetic.keep_renders(False)
    fresh = SyntheticDataset(n_frames=5, **kw)
    assert fresh.n_shared == 0
    for i in range(5):
        for a, b in zip(longer[i][1:], fresh[i][1:]):
            np.testing.assert_array_equal(a, b)


def test_tiny_run_through_the_cli(tmp_path):
    from xrdslam_tpu_torch.scripts.run import main

    n = 6  # two keyframes (frames 0 and 5), the fewest frames that make them
    runner = main([
        "co-slam", "--data-type", "synthetic", "--data", f"n_frames={n},height=40,width=60,scene=simple",
        "--out-dir", str(tmp_path), "--xrdslam.device", "cpu",
        "--xrdslam.tracker.save-re-render-result", "false",  # the sweep: tests/test_torch_sweep.py
        "--xrdslam.algorithm.mapping-bound", "[[-2.2,2.2],[-2.2,2.2],[-2.2,2.2]]",
        "--xrdslam.algorithm.mapping-first-n-iters", "30",
        "--xrdslam.algorithm.tracking-sample", "128", "--xrdslam.algorithm.mapping-sample", "256",
        "--xrdslam.algorithm.tracking-Hedge", "4", "--xrdslam.algorithm.tracking-Wedge", "4",
        "--xrdslam.algorithm.model.hashsize", "12", "--xrdslam.algorithm.model.n-levels", "8",
        "--xrdslam.algorithm.model.trainging-smooth-pts", "16",
        "--xrdslam.algorithm.model.training-n-sample-d", "16",
    ])
    with open(tmp_path / "eval.tar", "rb") as f:
        data = pickle.load(f)
    assert len(data["estimate_c2w_list"]) == n and data["idx"] == n - 1
    ate = evaluate_ate(list(runner.pipeline.dataset.poses), data["estimate_c2w_list"])
    assert ate["rmse"] * 100 < 6.0, f"ATE {ate['rmse'] * 100:.2f} cm"
    assert runner.pipeline.algorithm.kf_count == 2  # frames 0 and 5


IMG_CAM = dict(fx=30.0, fy=30.0, cx=15.5, cy=11.5, height=24, width=32)
MC_BOUND = [[-1.5, 1.5], [-1.2, 1.2], [-1.0, 1.4]]


@pytest.fixture(scope="module", params=["packed", "triplane"])
def algos(request):
    """The JAX and the port's CoSLAM at 24x32 with the same parameters and
    two keyframes (for the mesh's frustum mask), mesher resolution 32."""
    kw = {**MODEL, **ENCODINGS[request.param]}
    from xrdslam_tpu.configs.registry import algorithm_configs as jreg
    from xrdslam_tpu_torch.configs.registry import algorithm_configs as treg

    common = dict(mapping_bound=BOUND.tolist(), marching_cubes_bound=MC_BOUND, ray_batch_size=300)
    jalgo = JCoSLAMConfig(model=JJointEncodingConfig(**kw), mesher=JMesherConfig(resolution=32),
                          optimizers=jreg["co-slam"].xrdslam.algorithm.optimizers, **common).setup(
        camera=JCamera(**IMG_CAM))
    talgo = CoSLAMConfig(model=JointEncodingConfig(**kw), mesher=MesherConfig(resolution=32),
                         optimizers=treg["co-slam"].xrdslam.algorithm.optimizers, **common).setup(
        camera=Camera(**IMG_CAM), device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), talgo.model)
    kf_t = np.array([[0.0, 0.0, 0.0], [0.1, -0.05, 0.2]], np.float32)
    kf_r = np.array([[0.0, 0.0, 0.0], [0.05, 0.3, -0.02]], np.float32)
    jalgo.kf_pose_t = jalgo.kf_pose_t.at[:2].set(kf_t)
    jalgo.kf_pose_r = jalgo.kf_pose_r.at[:2].set(kf_r)
    talgo.kf_pose_t[:2] = torch.from_numpy(kf_t)
    talgo.kf_pose_r[:2] = torch.from_numpy(kf_r)
    jalgo.kf_count = talgo.kf_count = 2
    return jalgo, talgo


def test_render_img_matches_jax(algos):
    jalgo, talgo = algos
    rng = np.random.default_rng(5)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(jlie.axis_angle_to_matrix(jnp.asarray([0.1, -0.2, 0.05])))
    c2w[:3, 3] = [0.2, -0.1, 0.3]
    depth = rng.uniform(0.5, 3.0, (IMG_CAM["height"], IMG_CAM["width"])).astype(np.float32)
    depth[::5, ::3] = 0.0  # invalid depth: the samples fall back to [near, far]
    for gt in (None, depth):  # uniform samples, then depth-guided
        want_c, want_d = jalgo.render_img(c2w, gt_depth=gt)
        got_c, got_d = talgo.render_img(c2w, gt_depth=gt)
        assert got_c.shape == (24, 32, 3) and got_d.shape == (24, 32)
        if gt is None:
            _close(got_c, want_c, "rendered color")
            _close(got_d, want_d, "rendered depth")
            continue
        # The render's mask ends each ray's weights at its first sdf sign
        # change: where a sample's sdf is within float rounding of zero, the
        # two packages may end a ray one sample apart. At most 1% of the
        # pixels may differ so; all others agree to REL.
        off = ((np.abs(got_c - want_c).max(-1) > REL * np.abs(want_c).max())
               | (np.abs(got_d - want_d) > REL * np.abs(want_d).max()))
        assert off.mean() <= 0.01, f"{off.sum()} of {off.size} pixels differ"
        _close(got_c[~off], want_c[~off], "rendered color")
        _close(got_d[~off], want_d[~off], "rendered depth")


def test_get_mesh_matches_jax(algos):
    jalgo, talgo = algos
    want, got = jalgo.get_mesh(), talgo.get_mesh()
    assert want is not None and got is not None, "the random map has no surface in the grid"
    assert got.faces.shape == want.faces.shape and got.vertices.shape == want.vertices.shape
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.vertex_colors, want.vertex_colors, atol=1e-5, rtol=0)
    # the keyframes' frusta mask the grid: a mesh of the whole grid is larger
    talgo.kf_count = 0
    try:
        assert talgo.get_mesh().faces.shape[0] > got.faces.shape[0]
    finally:
        talgo.kf_count = 2
