"""SplaTAM's fused per-frame step and the pipeline's group path in the port.

On the CPU the group program runs eagerly:

* ``dispatch_superstep`` / ``finish_superstep`` give the bits of the
  per-frame sequence that the step fuses (``dispatch_tracking`` from the
  device prediction, ``do_mapping`` and ``add_keyframe`` at the tracked
  pose), from the same state and generator states, so with the same window
  picks: with and without a keyframe, with densification;
* with a window of one frame (``n_valid = 1``: no random pick) the port's
  ``fused_step`` matches the JAX package's ``_fused_raw`` run through
  ``jax.jit`` (its Pallas raster in interpret mode) on the same numpy state
  and frame: the pose within 1e-3, the count and the dead mask exactly, the
  gaussian table within ``test_torch_splatam.py``'s rule for a mapping
  call, the keyframe store exactly (the JAX store's row 0 carried across
  with ``splatam_state_from_jax``, row 1 the step's) but for the new row's
  w2c, within 1e-3. The two
  packages bin on their own, so the map's means are jittered to keep depth
  ties out of the binning's sort;
* on a stub algorithm the port's pipeline sends the JAX pipeline's frames
  through groups at SplaTAM's registry settings (``map_every`` 1,
  ``keyframe_every`` 5, relative poses), and none with
  ``XRDSLAM_DISABLE_SUPER=1``.

On the card (``cuda`` marker; skipped without one) a replay of the captured
step is held against the eager step from the same state: the same
launches, and the eager step's bits, or, where two eager steps already
differ, a distance from eager no larger than ``SPREAD`` times theirs.
"""
import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.configs.registry import algorithm_configs  # noqa: E402
from xrdslam_tpu_torch.models.gaussian_splatting import GAUSS_GROUPS  # noqa: E402
from xrdslam_tpu_torch.ops import gaussian_raster, lie_np, scatter  # noqa: E402

H, W = 32, 48
# a replay against an eager step where two eager steps differ (cuDNN's SSIM
# backward may sum in another order in each call): at most this many times
# their distance
SPREAD = 4.0
DENSIFY = dict(start_after=1, remove_big_after=0, stop_after=100, densify_every=2, grad_thresh=1e-8,
               num_to_split_into=2, removal_opacity_threshold=0.005, final_removal_opacity_threshold=0.005,
               reset_opacities_every=10**9)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _algo(device="cpu", densify=False):
    """A small SplaTAM (the registry's but for the sizes) after frames 0 and
    1 of its sequence went per frame (both keyframes), and frames 0..3."""
    ds = SyntheticDataset(n_frames=4, height=H, width=W, scene="simple")
    cfg = copy.deepcopy(algorithm_configs["splaTAM"].xrdslam.algorithm)
    cfg.tracking_n_iters, cfg.mapping_n_iters, cfg.mapping_first_n_iters = 3, 4, 4
    cfg.mapping_window_size, cfg.max_keyframes = 4, 4
    cfg.model.max_gaussians, cfg.model.k_per_tile = 16384, 256
    cfg.mapping_use_gaussian_splatting_densification = densify
    cfg.model.mapping_densify_dict = dict(DENSIFY)
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    gts = [ds[i][3] for i in range(4)]
    frames = [Frame(fid=i, rgb=ds[i][1], depth=ds[i][2], init_pose=gts[i], rot_rep="quat") for i in range(4)]
    for f in frames[:2]:
        if algo.is_initialized():
            f.set_pose(algo.finish_tracking(algo.dispatch_tracking(f)))
        algo.do_mapping(f)
        algo.add_keyframe(f)
        algo.estimate_c2w_list.append(f.get_pose())
    return algo, frames, gts


def _pose_vec(algo, c2w):
    return tuple(torch.as_tensor(np.asarray(v, np.float32), device=algo.device)
                 for v in lie_np.matrix_to_pose_vec(np.asarray(c2w, np.float32), rot_rep="quat"))


@pytest.mark.parametrize("do_kf,densify", [(True, False), (False, False), (True, True)])
def test_group_step_gives_the_per_frame_sequence_bits(do_kf, densify):
    algo, frames, gts = _algo(densify=densify)
    prev, prev2 = algo.estimate_c2w_list[1], algo.estimate_c2w_list[0]
    cur = frames[2]
    saved = algo.save_state()
    n_before = algo.n_gauss
    got = algo.finish_superstep(algo.dispatch_superstep([cur], do_kf, prev, prev2))
    got_state = [t.clone() for t in algo._state_tensors()]
    got_count, got_fids = algo.n_gauss, list(algo.keyframe_fids)
    assert got_count > n_before and got_fids == [0, 1] + [2] * do_kf
    assert int(got_state[-1]) == got_count
    # the per-frame path from the same state: tracking from the device
    # prediction, mapping and the keyframe at the tracked pose
    algo.load_state(saved)
    assert algo.n_gauss == n_before and algo.keyframe_fids == [0, 1]
    tp, qp = algo.predict_quat(*_pose_vec(algo, prev), *_pose_vec(algo, prev2))
    frame = Frame(fid=2, rgb=cur.rgb, depth=cur.depth, rot_rep="quat")
    frame.t, frame.r = tp.numpy(), qp.numpy()
    bt, bq = algo.dispatch_tracking(frame)
    frame.t, frame.r = bt.numpy(), bq.numpy()
    algo.do_mapping(frame)
    if do_kf:
        algo.add_keyframe(frame)
    np.testing.assert_array_equal(got[0], lie_np.pose_vec_to_matrix(frame.t, frame.r, rot_rep="quat"))
    assert algo.n_gauss == got_count and algo.keyframe_fids == got_fids
    for a, b in zip(got_state, algo._state_tensors()):
        assert torch.equal(a, b), "the state after the group step differs from the per-frame sequence's"
    if do_kf:  # the keyframe's host pose, set at the finish (through a pose vector)
        np.testing.assert_allclose(cur.get_pose(), got[0], atol=1e-6, rtol=0)


def test_densify_grows_the_count_inside_the_mapping_program():
    """The same frame and state, with and without densification: clones and
    splits add rows inside the mapping program, the parameters stay finite."""
    counts = {}
    for densify in (False, True):
        algo, frames, _ = _algo(densify=densify)
        algo.finish_superstep(algo.dispatch_superstep([frames[2]], False, algo.estimate_c2w_list[1],
                                                      algo.estimate_c2w_list[0]))
        counts[densify] = algo.n_gauss
        n = algo.n_gauss
        assert all(torch.isfinite(algo.params[g][:n]).all() for g in GAUSS_GROUPS)
    assert counts[True] > counts[False], counts


@pytest.fixture()
def interp_kernels(monkeypatch):
    """The JAX package's Pallas raster and scatter in interpret mode, as its
    own tests run them on the CPU."""
    import jax.experimental.pallas as pl

    import xrdslam_tpu.ops.gaussian_raster as gr
    import xrdslam_tpu.ops.pallas_scatter as ps

    orig = pl.pallas_call
    monkeypatch.setattr(gr.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(ps.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def test_fused_step_matches_jax(interp_kernels):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from xrdslam_tpu.algorithms.splatam import SplaTAMConfig as JSplaTAMConfig
    from xrdslam_tpu.common.frame import Frame as JFrame
    from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset
    from xrdslam_tpu.configs.registry import algorithm_configs as jconfigs
    from xrdslam_tpu.models.gaussian_splatting import GaussianSplattingConfig as JGSConfig
    from xrdslam_tpu_torch.algorithms.splatam import SplaTAMConfig
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.models.gaussian_splatting import GaussianSplattingConfig
    from xrdslam_tpu_torch.utils.from_jax import splatam_state_from_jax

    G = 40_000  # > 32,768 rows: the JAX scatter takes its exact fp32 branch
    n_iters, wn = 3, 3
    common = dict(rot_rep="quat", tracking_n_iters=4, mapping_n_iters=n_iters, mapping_first_n_iters=n_iters,
                  mapping_window_size=wn, max_keyframes=2)
    ds = JSyntheticDataset(n_frames=2, height=H, width=W)
    jcam = ds.get_camera()
    jalgo = JSplaTAMConfig(model=JGSConfig(max_gaussians=G, k_per_tile=48), **common,
                           optimizers=jconfigs["splaTAM"].xrdslam.algorithm.optimizers).setup(camera=jcam)
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    algo = SplaTAMConfig(model=GaussianSplattingConfig(max_gaussians=G, k_per_tile=48), **common,
                         optimizers=algorithm_configs["splaTAM"].xrdslam.algorithm.optimizers).setup(
        camera=cam, device="cpu")
    imgs = []
    for i in (0, 1):
        _, rgb, depth, pose = ds[i]
        imgs.append((np.array(JFrame(fid=i, rgb=rgb, depth=depth).rgb_jax()), np.asarray(depth, np.float32),
                     np.asarray(pose, np.float32)))
    (rgb0, depth0, gt0), (rgb1, depth1, gt1) = imgs
    ntx, nty = W // 16, H // 16
    params, dead, count = jalgo._grow_fn_raw(jalgo.params, jalgo.dead, jnp.asarray(0, jnp.int32), jnp.asarray(rgb0),
                                             jnp.asarray(depth0), jnp.asarray(gt0), first=True, ntx=ntx, nty=nty)
    params = jax.tree_util.tree_map(np.array, params)
    dead, count = np.array(dead), int(count)
    rng = np.random.default_rng(0)
    # distinct depths: the two packages' binning sorts then agree
    params["means3D"][:count] += rng.normal(0, 2e-3, (count, 3)).astype(np.float32)
    params["logit_opacities"] = rng.normal(3.0, 1.0, params["logit_opacities"].shape).astype(np.float32)
    params["logit_opacities"][:count:97] = -8.0
    params["rgb_colors"] = np.clip(params["rgb_colors"] + rng.normal(0, 0.05, (G, 3)), 0, 1).astype(np.float32)
    radius = float(depth0.max() / 3.0)
    jalgo.model.scene_radius = algo.model.scene_radius = radius
    # frame 0 as keyframe 0 of the JAX store, carried across with the table
    jalgo.add_keyframe(JFrame(fid=0, rgb=rgb0, depth=depth0, init_pose=gt0, rot_rep="quat"))
    splatam_state_from_jax(algo, params, dead, count, np.asarray(jalgo.kf_rgb_u16)[:1], np.asarray(jalgo.kf_depth)[:1],
                           np.asarray(jalgo.kf_w2c)[:1])
    prev, prev2 = gt0, gt0 @ np.linalg.inv(gt1) @ gt0  # a pose "before" frame 0: the prediction is near frame 1
    pv = [np.asarray(v, np.float32) for c2w in (prev, prev2)
          for v in lie_np.matrix_to_pose_vec(np.asarray(c2w, np.float32), rot_rep="quat")]
    win_slots = np.zeros(wn - 1, np.int64)

    jfn = jax.jit(functools.partial(jalgo._fused_raw, ntx=ntx, nty=nty, n_iters=n_iters, densify=False, do_kf=True))
    jout = jfn(params, dead, jnp.asarray(count, jnp.int32), jalgo.kf_rgb_u16, jalgo.kf_depth, jalgo.kf_w2c,
               jnp.asarray(rgb1), jnp.asarray(depth1), jnp.asarray(win_slots, jnp.int32), jnp.asarray(1, jnp.int32),
               *map(jnp.asarray, pv), jax.random.PRNGKey(0), jnp.asarray(1, jnp.int32))
    jp, jdead, jcount, jkf_rgb, jkf_depth, jkf_w2c, jt, jq = jax.tree_util.tree_map(np.asarray, jout)
    t, q, got_count = algo.fused_step(torch.from_numpy(rgb1), torch.from_numpy(depth1), torch.from_numpy(win_slots),
                                      torch.tensor(1), torch.zeros(n_iters, dtype=torch.int64),
                                      torch.tensor([1]), *map(torch.from_numpy, pv), do_kf=True,
                                      densify=False)
    np.testing.assert_allclose(t.numpy(), jt, atol=1e-3, rtol=0)
    np.testing.assert_allclose(q.numpy(), jq, atol=1e-3, rtol=0)
    assert np.abs(jt[0] - gt1[:3, 3]).max() < 0.05  # tracked near the truth
    assert int(got_count) == int(jcount) > count
    np.testing.assert_array_equal(algo.dead.numpy(), jdead)
    frozen = (np.arange(G) >= int(jcount)) | dead
    lrs = {k: v["optimizer"].lr for k, v in algorithm_configs["splaTAM"].xrdslam.algorithm.optimizers.items()}
    for k in GAUSS_GROUPS:
        got, want = algo.params[k].numpy(), jp[k]
        off = np.abs(got - want) > 1e-5
        # test_torch_splatam.py's rule for a mapping call: an entry off by
        # more is one whose ~0 gradient Adam stepped the other way
        assert off.mean() < 1e-3 and np.abs(got - want).max() <= 2 * n_iters * lrs[k] + 1e-5, k
        np.testing.assert_array_equal(got[frozen], want[frozen], err_msg=k)
    # keyframe row 0 as loaded, row 1 written by the step
    np.testing.assert_array_equal(algo.kf_rgb.numpy().astype(np.int32) + 32768, jkf_rgb.astype(np.int32))
    np.testing.assert_array_equal(algo.kf_depth.numpy(), jkf_depth)
    np.testing.assert_array_equal(algo.kf_w2c[0].numpy(), jkf_w2c[0])
    np.testing.assert_allclose(algo.kf_w2c[1].numpy(), jkf_w2c[1], atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# the pipeline's group split, against the JAX pipeline's
# ---------------------------------------------------------------------------

class _Stub:
    """An algorithm that logs what the pipeline asks of it; its group step
    returns one pose, as SplaTAM's."""

    def __init__(self, log):
        self.log = log
        self.config = SimpleNamespace(rot_rep="quat")
        self.initialized = False
        self.estimate_c2w_list, self.gt_c2w_list, self.gt_c2w_list_ori = [], [], []

    def is_initialized(self):
        return self.initialized

    def get_estimate_c2w_list(self):
        return self.estimate_c2w_list

    def dispatch_tracking(self, frame):
        self.log.append(("track", frame.fid))
        return "handle" if self.initialized else None

    def finish_tracking(self, handle):
        return None if handle is None else np.eye(4, dtype=np.float32)

    def do_mapping(self, frame):
        self.log.append(("map", frame.fid))
        self.initialized = True

    def add_keyframe(self, frame):
        self.log.append(("keyframe", frame.fid))

    def add_framepose(self, c2w, gt, gt_ori):
        self.log.append(("pose", len(self.estimate_c2w_list)))
        self.estimate_c2w_list.append(np.asarray(c2w))

    def update_framepose(self, idx, c2w):
        self.estimate_c2w_list[idx] = np.asarray(c2w)

    def dispatch_superstep(self, frames, do_kf, prev_c2w=None, prev2_c2w=None, prev_tr=None, prev2_tr=None):
        self.log.append(("group", tuple(f.fid for f in frames), do_kf, prev_tr is not None))
        return np.zeros((1, 3), np.float32), np.tile(np.float32([1, 0, 0, 0]), (1, 1))

    def finish_superstep(self, handle):
        self.log.append(("fetch",))
        return [np.eye(4, dtype=np.float32)]


class _StubDataset:
    def __init__(self, n, camera):
        self.n, self.camera = n, camera

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.01 * i, 0.0, 0.0]
        return i, np.zeros((4, 4, 3), np.float32), np.ones((4, 4), np.float32), pose

    def get_camera(self):
        return self.camera


def _run_stub(pipeline_mod, camera, n, lazy_start, tmp_path, **cfg):
    """The pipeline at SplaTAM's registry tracker and mapper settings."""
    log = []
    algo_cfg = SimpleNamespace(setup=lambda **kw: _Stub(log))
    config = pipeline_mod.SLAMPipelineConfig(
        tracker=pipeline_mod.TrackerConfig(map_every=1, lazy_start=lazy_start, use_relative_pose=True),
        mapper=pipeline_mod.MapperConfig(keyframe_every=5), algorithm=algo_cfg, **cfg)
    pipe = pipeline_mod.SLAMPipeline(config, _StubDataset(n, camera), out_dir=str(tmp_path), verbose=False)
    pipe._finish_run = lambda: None
    pipe.run()
    return log


@pytest.mark.parametrize("n,lazy_start", [(3, -1), (4, -1), (12, -1), (12, 4), (9, 8), (20, 3)])
def test_pipeline_groups_as_jax(n, lazy_start, tmp_path):
    pytest.importorskip("jax")
    from xrdslam_tpu.common.camera import Camera as JCamera
    from xrdslam_tpu.pipeline import slam as jslam
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.pipeline import slam as tslam

    cam = dict(fx=4.0, fy=4.0, cx=2.0, cy=2.0, height=4, width=4)
    want = _run_stub(jslam, JCamera(**cam), n, lazy_start, tmp_path / "jax")
    got = _run_stub(tslam, Camera(**cam), n, lazy_start, tmp_path / "port", device="cpu")
    assert got == want
    heads = [e[1][0] for e in got if e[0] == "group"]
    assert heads == list(range(max(2, lazy_start + 2), n - 1))
    assert [e[2] for e in got if e[0] == "group"] == [h % 5 == 0 for h in heads]


def test_pipeline_disable_super_sends_every_frame_alone(tmp_path, monkeypatch):
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.pipeline import slam as tslam

    monkeypatch.setenv("XRDSLAM_DISABLE_SUPER", "1")
    log = _run_stub(tslam, Camera(fx=4.0, fy=4.0, cx=2.0, cy=2.0, height=4, width=4), 12, -1, tmp_path, device="cpu")
    assert not any(e[0] == "group" for e in log)
    assert [e[1] for e in log if e[0] == "map"] == list(range(12))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _launches():
    return {**gaussian_raster.LAUNCHES, **scatter.LAUNCHES}


def _reset():
    gaussian_raster.reset_launches()
    scatter.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("densify", [False, True])
def test_cuda_step_replay_equals_eager_step(densify):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    algo, frames, _ = _algo("cuda", densify=densify)
    est = algo.estimate_c2w_list
    key, program, inputs = algo.group_call([frames[2]], True, est[1], est[0])
    algo.graphs(key, program, inputs)  # the warm-up and the capture
    assert key in algo.graphs.captures
    saved = algo.save_state()
    runs = []
    for how in ("eager", "eager", "replay"):
        algo.load_state(saved)
        _reset()
        out = program(*inputs) if how == "eager" else algo.graphs(key, program, inputs)
        torch.cuda.synchronize()
        runs.append(([o.clone() for o in out] + [t.clone() for t in algo._state_tensors()], _launches()))
    assert algo.graphs.replays[key] == 1
    assert runs[2][1] == runs[0][1] and all(runs[0][1][k] > 0 for k in ("raster_fwd", "raster_bwd", "scatter_add"))

    def dist(a, b):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

    spread = dist(runs[0][0], runs[1][0])
    assert dist(runs[0][0], runs[2][0]) <= SPREAD * spread, (dist(runs[0][0], runs[2][0]), spread)
    if spread == 0.0:
        assert all(torch.equal(x, y) for x, y in zip(runs[0][0], runs[2][0]))
