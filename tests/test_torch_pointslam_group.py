"""Point-SLAM's group step and the map's in-place upload in the port.

On the CPU the two group programs (the head, the tail) run eagerly, on
point maps of ``SMALL_HASH`` rows:

* ``PointMap.upload`` writes an insertion into the tensors of
  ``device_state`` in place: their addresses stay, their bits become the
  new ``device_state``'s;
* ``dispatch_superstep`` / ``finish_superstep`` give the bits of the
  per-frame steps a group fuses (``track_step`` from ``predict_q``, the
  point insertion at the tracked pose, the window's ``map_step``, the
  keyframe row, ``track_step`` on each tail frame), from the same state
  and generators, with and without a keyframe, with the window taking
  every keyframe and picking among them;
* with no tracking iterations (so that no tracking draw decides a pose),
  on the JAX package's insertion pick, window pick and mapping draws
  rebuilt from its keys, the port's group gives the JAX
  ``dispatch_superstep``'s chained poses, inserted points, keyframe rows
  and mapped parameters;
* on a stub algorithm the port's pipeline splits the Point-SLAM
  registry's 50-frame schedule (``lazy_start`` 20, ``map_every`` 5,
  ``keyframe_every`` 20) into the JAX pipeline's groups and frames.

On the card (``cuda`` marker; skipped without one) a replay of both
captured graphs is held against the eager group from the same state: the
same bits, with the same K7 and K4 launches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.algorithms.point_slam import PointSLAMConfig  # noqa: E402
from xrdslam_tpu_torch.common.frame import Frame  # noqa: E402
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.engine.optimizers import AdamOptimizerConfig  # noqa: E402
from xrdslam_tpu_torch.engine.schedulers import PointSLAMSchedulerConfig  # noqa: E402
from xrdslam_tpu_torch.models.conv_onet_pointslam import ConvOnet2Config  # noqa: E402
from xrdslam_tpu_torch.ops import lie_np, row_gather, scatter  # noqa: E402
from xrdslam_tpu_torch.ops.point_table import PointMap  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


G = 3  # frames a group
H, W = 24, 32  # tests/test_torch_pointslam.py's camera
MAP_STATE = ("pos", "cell_keys", "cell_count", "cell_list", "cell_data")  # the host map's arrays
SMALL_HASH = 1 << 12
# The JAX comparison holds the tail's mapped parameters as the per-frame
# mapping test does (tests/test_torch_pointslam.py: entries whose first
# gradient was below 1e-3 of their leaf's excused) at twice its 1e-5: its
# inputs agree to float32 rounding (poses predicted and points inserted in
# each package) where the per-frame test's are the same arrays, and three
# colour-table entries, first moved in the colour phase at 1.3e-3 to
# 5.3e-3 of their leaf's largest gradient, land 1.1e-5 to 1.4e-5 from JAX's
MAPPED_ATOL = 2e-5


def _config(**over):
    """tests/test_torch_pointslam.py's tiny Point-SLAM (its ``_config`` with
    the port's classes), keyframe capacity for a group's keyframe."""
    lrs = {"decoder": (0.001, 0.005), "geometry": (0.03, 0.005), "color": (0.0, 0.005)}
    opts = {g: {"optimizer": AdamOptimizerConfig(), "scheduler": PointSLAMSchedulerConfig(start_lr=a, end_lr=b)}
            for g, (a, b) in lrs.items()}
    opts["tracking_pose"] = {"optimizer": AdamOptimizerConfig(lr=2e-3), "scheduler": None}
    cfg = PointSLAMConfig(rot_rep="quat", tracking_n_iters=3, mapping_n_iters=5, mapping_first_n_iters=5,
                          mapping_window_size=3, tracking_sample=64, mapping_sample=96, min_sample_pixels=8,
                          tracking_Wedge=4, tracking_Hedge=4, pixels_adding=300, max_keyframes=4,
                          model=ConvOnet2Config(max_points=8192), optimizers=opts)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def small_map(algo, jax_package: bool = False) -> None:
    """A point map of ``SMALL_HASH`` rows in place of the algorithm's
    65,536 (256 MiB of rows), before any insertion: a tiny scene fills a
    few hundred."""
    pm = algo.point_map
    algo.point_map = type(pm)(max_points=pm.max_points, cell_size=pm.cell_size, hash_cap=SMALL_HASH)
    if jax_package:
        algo.maps = algo._replicate_params(algo.point_map.device_state())
    else:
        algo.maps = algo.point_map.device_state(algo.device)


def _algo(n_kf: int, device: str = "cpu"):
    """A tiny Point-SLAM after its first mapping (frame 0) with keyframes
    at frames 0 .. n_kf - 1 (their true poses), and the frames of its
    sequence: the group's head is frame ``max(n_kf, 2)``."""
    h = max(n_kf, 2)
    ds = SyntheticDataset(n_frames=h + G, height=H, width=W)
    algo = _config().setup(camera=ds.get_camera(), device=device)
    small_map(algo)
    frames = [Frame(fid=i, rgb=ds[i][1], depth=ds[i][2], init_pose=ds[i][3], rot_rep="quat") for i in range(h + G)]
    algo.do_mapping(frames[0])
    for f in frames[:n_kf]:
        algo.add_keyframe(f)
    return algo, frames, [ds[i][3] for i in range(h + G)], h


def _pose_vec(algo, c2w):
    return torch.cat([algo._tensor(v) for v in lie_np.matrix_to_pose_vec(np.asarray(c2w, np.float32),
                                                                          rot_rep="quat")])


def _eager(key, program, inputs):
    return tuple(program(*inputs))


def test_upload_writes_device_state_bits_in_place():
    rng = np.random.default_rng(0)
    pm = PointMap(max_points=4096, cell_size=0.16, hash_cap=1 << 10, per_cell=24)
    pm.add_points(rng.random((300, 3), dtype=np.float32))
    maps = pm.device_state("cpu")
    ptrs = {k: maps[k].data_ptr() for k in ("cell_keys", "cell_data", "cell_size")}
    assert pm.upload(maps) == 0  # nothing changed since device_state
    pm.add_points(rng.random((200, 3), dtype=np.float32) + 0.5)
    rows = pm.upload(maps)
    assert 0 < rows < pm.hash_cap  # the changed rows only
    want = pm.device_state("cpu")
    for k in ("cell_keys", "cell_data"):
        assert maps[k].data_ptr() == ptrs[k], k
        np.testing.assert_array_equal(maps[k].view(torch.int32).numpy(), want[k].view(torch.int32).numpy(), err_msg=k)
    assert maps["cell_size"].data_ptr() == ptrs["cell_size"] and maps["n_points"] == pm.n_points == 500


@pytest.mark.parametrize("n_kf,do_kf", [(1, True), (3, False), (3, True)])
def test_group_step_gives_the_per_frame_bits(n_kf, do_kf):
    """kf_count 1: the window takes every keyframe; 3: it picks at random
    (window 3, so 2 keyframe slots)."""
    algo, frames, gts, h = _algo(n_kf)
    cfg = algo.config
    group = frames[h:h + G]
    saved = algo.save_state()
    got = algo.finish_superstep(algo.dispatch_superstep(group, do_kf, gts[h - 1], gts[h - 2]))
    got_state = [t.detach().clone() for t in algo._state_tensors()]
    got_map = {k: getattr(algo.point_map, k).copy() for k in MAP_STATE}
    assert algo.kf_count == n_kf + do_kf and algo.keyframe_fids == list(range(n_kf)) + [h] * do_kf
    # the per-frame steps it fuses, from the same state
    algo.load_state(saved)
    rgbdrs = [algo._frame_rgbdr(f) for f in group]
    p1, p2 = _pose_vec(algo, gts[h - 1]), _pose_vec(algo, gts[h - 2])
    best, _ = algo.track_step(rgbdrs[0], algo.predict_q(p1, p2))
    head = Frame(fid=h, rgb=group[0].rgb, depth=group[0].depth, rot_rep="quat")
    head.t, head.r = best.numpy()[:3].copy(), best.numpy()[3:].copy()
    algo.add_points_from_frame(head, cfg.pixels_adding)
    k = cfg.mapping_window_size - 1
    if n_kf <= k:
        slots = list(range(n_kf))
    else:
        slots = sorted(int(s) for s in algo.rng.permutation(n_kf - 1)[:k - 1]) + [n_kf - 1]
    idx = torch.tensor(slots, dtype=torch.long)
    images, poses = algo.pad_window(torch.cat([algo.kf_images[idx], rgbdrs[0][None]]),
                                    torch.cat([algo.kf_pose[idx], best[None]]), rgbdrs[0][None], best,
                                    cfg.mapping_window_size)
    algo.map_step(images, poses, len(slots) + 1, cfg.mapping_n_iters)
    if do_kf:
        algo.kf_images[n_kf] = rgbdrs[0]
        algo.kf_pose[n_kf] = best
    want = [best]
    last, before = best, p1
    for rgbdr in rgbdrs[1:]:
        bj, _ = algo.track_step(rgbdr, algo.predict_q(last, before))
        want.append(bj)
        last, before = bj, last
    for j, pose in enumerate(want):
        np.testing.assert_array_equal(got[j], lie_np.pose_vec_to_matrix(pose[:3].numpy(), pose[3:].numpy(),
                                                                         rot_rep="quat"), err_msg=f"frame {j}")
    for a, b in zip(got_state, algo._state_tensors()):
        assert torch.equal(a, b), "the state after the group differs from the per-frame steps'"
    for name, a in got_map.items():
        np.testing.assert_array_equal(a, getattr(algo.point_map, name), err_msg=name)
    assert algo.point_map.n_points > saved[1]["point_map"]["n_points"]  # the head added points


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def make_jcase():
    """Both packages' tiny Point-SLAM with the same initial model (the JAX
    package's initial draws taken from numpy, which spares its ~50 small
    random-init compiles), small point maps grown in both from frames 0-2
    at their true poses with the same pixel picks, frames 0-2 keyframes (so
    that a window picks two of them at random), initialized, at
    ``mesh_resolution`` 32; and the frames 0 .. 2 + G as (rgb, depth,
    c2w)."""
    import jax
    import jax.numpy as jnp
    from test_torch_pointslam import _config as both_config, _jax_pick

    from xrdslam_tpu.algorithms.point_slam import PointSLAMConfig as JPointSLAMConfig
    from xrdslam_tpu.common.frame import Frame as JFrame
    from xrdslam_tpu.common.synthetic import SyntheticDataset as JSyntheticDataset
    from xrdslam_tpu.engine.optimizers import AdamOptimizerConfig as JAdam
    from xrdslam_tpu.engine.schedulers import PointSLAMSchedulerConfig as JSched
    from xrdslam_tpu.models.conv_onet_pointslam import ConvOnet2Config as JConvOnet2Config
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.utils.from_jax import pointslam_params_from_jax

    ds = JSyntheticDataset(n_frames=3 + G, height=H, width=W)
    jcam = ds.get_camera()
    cam = Camera(**{k: getattr(jcam, k) for k in ("fx", "fy", "cx", "cy", "height", "width")})
    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                   jnp.asarray(rng.standard_normal(shape), dtype))
        mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
                   jnp.asarray(rng.uniform(minval, maxval, shape), dtype))
        jalgo = both_config(JPointSLAMConfig, JConvOnet2Config, JAdam, JSched).setup(camera=jcam)
    algo = _config().setup(camera=cam, device="cpu")
    small_map(jalgo, jax_package=True)
    small_map(algo)
    for a in (jalgo, algo):
        a.config.mesh_resolution = 32
    pointslam_params_from_jax(jax.tree_util.tree_map(np.asarray, jalgo.model_params), algo.model,
                              jax.tree_util.tree_map(np.asarray, jalgo.model.frozen))
    items = [tuple(np.asarray(x, np.float32) for x in ds[i][1:]) for i in range(3 + G)]
    for i, (rgb, depth, pose) in enumerate(items[:3]):
        jf = JFrame(fid=i, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
        tf = Frame(fid=i, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
        pick = _jax_pick(jalgo, depth, jalgo.config.pixels_adding)
        jalgo.add_points_from_frame(jf, jalgo.config.pixels_adding)
        algo.add_points_from_frame(tf, algo.config.pixels_adding, pick=pick)
        jalgo.add_keyframe(jf)
        algo.add_keyframe(tf)
    jalgo.set_initialized()
    algo.set_initialized()
    return jalgo, algo, items


def test_group_step_matches_jax_at_zero_iterations(monkeypatch):
    """No tracking iterations, so that no tracking draw decides a pose: the
    port's group on the JAX package's insertion pick, window pick and the
    tail's mapping draws (rebuilt from its keys, as
    tests/test_torch_pointslam.py rebuilds a mapping call's) gives the JAX
    ``dispatch_superstep``'s chained constant-velocity poses within 1e-5,
    the points it inserts at the head's pose (positions within 1e-6, the
    rows' members the same), its keyframe rows, and, after the tail's
    ``mapping_n_iters`` mapping iterations, its model's parameters as
    ``hold_mapped_params`` holds the per-frame mapping test's, at
    MAPPED_ATOL."""
    jax = pytest.importorskip("jax")

    import xrdslam_tpu.algorithms.point_slam as jps_module
    from test_torch_pointslam import _map_samples, _stage_hash, hold_mapped_params

    from xrdslam_tpu.common.frame import Frame as JFrame

    jalgo, algo, items = make_jcase()
    for a in (jalgo, algo):
        a.config.tracking_n_iters = 0
    cfg = jalgo.config
    n_iters, wn = cfg.mapping_n_iters, cfg.mapping_window_size
    geo = int(cfg.mapping_geo_iter_ratio * n_iters)
    assert n_iters > 0 and 0 < geo < n_iters  # both mapping phases run
    prev2, prev = items[1][2], items[2][2]
    key, n_points = jalgo._key, algo.point_map.n_points
    keys = []
    for _ in range(4):  # _next_key's: the head's tracking, the insertion's pick, the window's pick, the tail
        key, k = jax.random.split(key)
        keys.append(k)
    n_px = int((items[3][1] > 0).sum())
    map_key = jax.random.split(keys[3], G + 1)[G]  # map_tail's mapping key
    pixs = max(cfg.mapping_sample // wn, cfg.min_sample_pixels)
    draws = {"pick": np.random.default_rng(int(keys[1][0])).integers(0, n_px, min(cfg.pixels_adding, n_px)),
             "slots": sorted(int(s) for s in np.random.default_rng(int(keys[2][0])).permutation(2)[:1]) + [2],
             "tail": (_map_samples(jalgo, map_key, (geo, n_iters - geo), wn, pixs), [None] * (G - 1))}
    monkeypatch.setattr(jps_module, "hash", _stage_hash, raising=False)  # the same draws in every process
    jax_before = jalgo.model_params
    jframes = [JFrame(fid=3 + j, rgb=rgb, depth=d, rot_rep="quat") for j, (rgb, d, _) in enumerate(items[3:])]
    handle = jalgo.dispatch_superstep(jframes, True, prev, prev2)
    jax_head = torch.from_numpy(np.concatenate([np.asarray(handle[0][0]), np.asarray(handle[1][0])]))
    want = np.stack(jalgo.finish_superstep(handle))
    heads = []

    def on_jax_head(key, program, inputs):
        """Both programs eagerly; the port's head pose kept and held
        below, JAX's passed on (so that the insertion and the tail start
        from the same pose in both packages)."""
        out = tuple(program(*inputs))
        if key == ("head",):
            heads.append(out[0])
            return (jax_head,)
        return out

    guard, step_grads = algo._finite_guard, []

    def recording_guard(loss, grads):  # the port's gradients of every iteration, as Adam gets them
        grads = guard(loss, grads)
        step_grads.append([g.detach().numpy().copy() for g in grads])
        return grads

    monkeypatch.setattr(algo, "_finite_guard", recording_guard)
    frames = [Frame(fid=3 + j, rgb=rgb, depth=d, rot_rep="quat") for j, (rgb, d, _) in enumerate(items[3:])]
    pt, pq = algo.group_step(frames, True, _pose_vec(algo, prev), _pose_vec(algo, prev2), run=on_jax_head,
                             draws=draws)
    got = np.stack([lie_np.pose_vec_to_matrix(t, q, rot_rep="quat") for t, q in zip(pt.numpy(), pq.numpy())])
    assert got.shape == (G, 4, 4)
    head = heads[0].numpy()
    np.testing.assert_allclose(lie_np.pose_vec_to_matrix(head[:3], head[3:], rot_rep="quat"), want[0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got[-1, :3, 3] - prev[:3, 3]).max() > 1e-3  # the chain is not the identity
    tm, jm = algo.point_map, jalgo.point_map
    assert tm.n_points == jm.n_points > n_points  # the head added points
    np.testing.assert_allclose(tm.pos, jm.pos, atol=1e-6, rtol=0)
    for name in ("cell_keys", "cell_count", "cell_list"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert algo.kf_count == jalgo.kf_count == 4 and algo.keyframe_fids == jalgo.keyframe_fids == [0, 1, 2, 3]
    np.testing.assert_array_equal(algo.kf_images.numpy(), np.asarray(jalgo.kf_images))
    np.testing.assert_allclose(algo.kf_pose.numpy(), np.asarray(jalgo.kf_pose), atol=1e-5, rtol=0)
    assert len(step_grads) == n_iters
    hold_mapped_params(algo.model, step_grads, jalgo.model_params, jax_before, atol=MAPPED_ATOL)


def test_pipeline_groups_as_jax(tmp_path, monkeypatch):
    """The Point-SLAM registry's schedule on 50 frames, on the stub of
    tests/test_torch_coslam_group.py: frames 0-20 mapped one by one (the
    lazy start), groups at 30, 35 and 40 (a keyframe at 40), the rest per
    frame."""
    pytest.importorskip("jax")
    import time

    from test_torch_coslam_group import _Clock, _run_stub

    from xrdslam_tpu.common.camera import Camera as JCamera
    from xrdslam_tpu.pipeline import slam as jslam
    from xrdslam_tpu_torch.common.camera import Camera
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.pipeline import slam as tslam

    reg = algorithm_configs["point-slam"].xrdslam
    args = (50, reg.tracker.map_every, reg.mapper.keyframe_every, reg.tracker.lazy_start)
    assert args == (50, 5, 20, 20)
    cam = dict(fx=4.0, fy=4.0, cx=2.0, cy=2.0, height=4, width=4)
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    want, want_times = _run_stub(jslam, JCamera(**cam), *args, tmp_path / "jax", clock)
    got, got_times = _run_stub(tslam, Camera(**cam), *args, tmp_path / "port", clock, device="cpu")
    assert got == want and got_times == want_times
    assert [(e[1][0], e[2]) for e in got if e[0] == "group"] == [(30, False), (35, False), (40, True)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _launches():
    return {**row_gather.LAUNCHES, **scatter.LAUNCHES}


@pytest.mark.cuda
def test_cuda_group_replay_equals_eager_group():
    """Both graphs (the head, the tail with a keyframe) captured by a first
    group; from its state again, the eager group and a replay give the same
    poses, state and host map, with the same K7 and K4 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    algo, frames, gts, h = _algo(3, "cuda")
    group = frames[h:h + G]
    p1, p2 = _pose_vec(algo, gts[h - 1]), _pose_vec(algo, gts[h - 2])
    saved = algo.save_state()
    algo.group_step(group, True, p1, p2)  # the warm-ups and the captures
    assert set(algo.graphs.captures) == {("head",), (G, algo.config.mapping_n_iters, 0, True)}
    runs = []
    for run in (_eager, algo.graphs):
        algo.load_state(saved)
        row_gather.reset_launches()
        scatter.reset_launches()
        out = algo.group_step([Frame(fid=f.fid, rgb=f.rgb, depth=f.depth, rot_rep="quat") for f in group], True,
                              p1, p2, run=run)
        torch.cuda.synchronize()
        runs.append(([o.clone() for o in out], [t.detach().clone() for t in algo._state_tensors()],
                     {k: getattr(algo.point_map, k).copy() for k in MAP_STATE}, _launches()))
    assert all(n == 1 for n in algo.graphs.replays.values()) and len(algo.graphs.replays) == 2
    (eo, es, em, el), (ro, rs, rm, rl) = runs
    assert rl == el and el["row_gather"] > 0 and el["scatter_add"] > 0, (el, rl)
    for a, b in list(zip(eo, ro)) + list(zip(es, rs)):
        assert torch.equal(a, b)
    for name in MAP_STATE:
        np.testing.assert_array_equal(em[name], rm[name], err_msg=name)
