"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

1. Prints the card (torch and nvidia-smi).
2. Builds every kernel from ``xrdslam_tpu_torch/kernels/*.cu``, one nvcc per
   source, all at once, and prints their ptxas reports.
3. Holds each kernel against its plain PyTorch twin at the shapes of the
   main paths and times both with CUDA events (median of 20 runs, twin,
   kernel, kernel, twin), beside its bound (the least time the card could
   take, from the bytes it must move and the operations it must do):
   the hash-grid kernels K1-K3 at Co-SLAM's mapping shapes (N = 176,128
   points, some outside [0,1]^3); the rasterizer K5/K6 and the scatter-add
   K4 on gaussians grown from an office frame at 600x340 and binned at its
   pose (836 tiles, K = 256, 131,072 rows), with a seeded random upstream
   gradient. K4 is also timed against ``Tensor.index_add_``.
4. Runs, through the port's runner: Co-SLAM (exact hash grid) on the
   synthetic office at 600x340 with the benchmark settings (ATE <= 10 cm);
   SplaTAM on the office at 600x340 for 20 frames with the registry's
   settings but 512 slots per tile (ATE <= 10 cm); and SplaTAM's main
   path, the same with the registry's settings (256 slots per tile; ATE
   reported: see ``SPLATAM_GATE``). Every pose must be finite and every
   kernel of each main path launched (the launch counts are zeroed just
   before each run and read just after).
5. Profiles one tracking and one mapping call of each with torch.profiler:
   wall time, device busy time and the kernels that take it.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises (non-zero exit,
no result).

    python3 chip_smoke.py --slots-probe

builds the kernels and measures SplaTAM's registry run against one change
at a time (``SLOTS_PROBE``: a larger table, more slots per tile, the JAX
package's smoke schedule), the evidence behind ``SPLATAM_GATE``; it prints
one JSON line per setting and no result line.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

COSLAM_FRAMES = 60
SPLATAM_FRAMES = 20
# SplaTAM's accuracy gate runs the main path's data and settings with one
# change: 512 slots per tile. A tile keeps the K nearest of the gaussians
# whose binning box (3 sigma + 8 px) overlaps it, up to 38 x 38 of them for
# the ~1 px gaussians grown one per pixel. At the registry's 256 the map
# grown from a frame leaves most of that frame's silhouette below 0.5 (the
# "[coverage]" line), and the reference package's per-frame tracking drifts
# on such a map at the registry's schedule (40 tracking and 60 mapping
# iterations per frame); tests/test_torch_splatam.py shows that drift in the
# JAX package and holds the port's tracking to it. The registry run's ATE
# is reported ungated. ``--slots-probe`` measures the registry run against
# one change at a time.
SPLATAM_GATE = {"algorithm.model.k_per_tile": 512}
G262144 = {"algorithm.model.max_gaussians": 262_144}
# the JAX package's SplaTAM smoke schedule (tests/test_e2e_algorithms.py)
SMOKE_SCHEDULE = {"algorithm.tracking_n_iters": 6, "algorithm.mapping_n_iters": 10,
                  "algorithm.mapping_first_n_iters": 15, "algorithm.mapping_window_size": 3,
                  "mapper.keyframe_every": 2}
SLOTS_PROBE = {
    "registry": {},
    "table262144": G262144,
    "k512": SPLATAM_GATE,
    "table262144_k512": {**G262144, **SPLATAM_GATE},
    "table262144_k512_track10": {**G262144, **SPLATAM_GATE, "algorithm.tracking_n_iters": 10},
    "k1024": {"algorithm.model.k_per_tile": 1024},
    "smoke_schedule": SMOKE_SCHEDULE,
}
N_MAP = 176_128  # (2048 keyframe + 2048 current rays) x 43 samples
N_TRACK = 44_032  # 1024 rays x 43 samples
HEIGHT, WIDTH = 340, 600
ATE_LIMIT_CM = 10.0
FWD_ATOL = 1e-5
BWD_RTOL = 1e-4  # of max |twin|: sums in another order (fp32 atomics in K2-K4)
# NVIDIA H100 SXM, published peaks (data sheet): HBM rate and float32 rate
# outside the tensor cores, the rate of the kernels' arithmetic
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def interleaved(kern, twin):
    """(kernel ms, twin ms): twin, kernel, kernel, twin, so both see the
    same card state; the better of each pair."""
    t1, k1, k2, t2 = cuda_ms(twin), cuda_ms(kern), cuda_ms(kern), cuda_ms(twin)
    return min(k1, k2), min(t1, t2)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check(name: str, err: float, limit: float, scale: float) -> None:
    if not np.isfinite(err) or err > limit:
        raise RuntimeError(f"kernel {name} disagrees with its twin: max abs err {err:.3e} > {limit:.3e}")
    print(f"[check] {name}: max abs err {err:.3e} (limit {limit:.3e}, max |twin| {scale:.3e})")


def steady_stats(frame_times):
    """Steady per-frame seconds as the reference benchmark computes them:
    drop the first 15 frames, then frames slower than 4x the median."""
    t = np.asarray(frame_times[15:])
    med = np.median(t)
    keep = t[t < 4 * med]
    return float(np.mean(keep)), int(len(t) - len(keep))


def reset_all_launches() -> None:
    from xrdslam_tpu_torch.ops import gaussian_raster, hashgrid_fast, scatter

    for mod in (hashgrid_fast, gaussian_raster, scatter):
        mod.reset_launches()


def all_launches():
    from xrdslam_tpu_torch.ops import gaussian_raster, hashgrid_fast, scatter

    return {**hashgrid_fast.LAUNCHES, **gaussian_raster.LAUNCHES, **scatter.LAUNCHES}


# ---------------------------------------------------------------------------
# kernels against their twins
# ---------------------------------------------------------------------------

def check_hashgrid(spec, device):
    """K1-K3 vs twin at the mapping shapes; returns the per-kernel records."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (N_MAP, 3)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.standard_normal((N_MAP, spec.out_dim)).astype(np.float32), device=device)
    table = torch.as_tensor(rng.standard_normal((spec.n_levels, spec.table_size, 2)).astype(np.float32), device=device)

    out_k = hf.hashgrid_fwd(table, x, spec)
    dt_k, dx_k = hf.hashgrid_bwd(table, x, g, spec, True, True)
    torch.cuda.synchronize()
    out_t = hf.hashgrid_fwd_torch(table, x, spec)
    dt_t, dx_t = hf.hashgrid_bwd_torch(table, x, g, spec, True, True)
    err = {"fwd": float((out_k - out_t).abs().max()), "dx": float((dx_k - dx_t).abs().max()),
           "dtable": float((dt_k - dt_t).abs().max())}
    scale = {"fwd": float(out_t.abs().max()), "dx": float(dx_t.abs().max()), "dtable": float(dt_t.abs().max())}
    limit = {"fwd": FWD_ATOL, "dx": BWD_RTOL * scale["dx"], "dtable": BWD_RTOL * scale["dtable"]}
    for k in err:
        check(k, err[k], limit[k], scale[k])

    xt, gt = x[:N_TRACK].contiguous(), g[:N_TRACK].contiguous()
    times = {
        "fwd": (lambda: hf.hashgrid_fwd(table, x, spec), lambda: hf.hashgrid_fwd_torch(table, x, spec)),
        "dx": (lambda: hf.hashgrid_bwd(table, x, g, spec, False, True),
               lambda: hf.hashgrid_bwd_torch(table, x, g, spec, False, True)),
        "dtable": (lambda: hf.hashgrid_bwd(table, x, g, spec, True, False),
                   lambda: hf.hashgrid_bwd_torch(table, x, g, spec, True, False)),
        "dx+dtable": (lambda: hf.hashgrid_bwd(table, x, g, spec, True, True),
                      lambda: hf.hashgrid_bwd_torch(table, x, g, spec, True, True)),
        "fwd@track": (lambda: hf.hashgrid_fwd(table, xt, spec), lambda: hf.hashgrid_fwd_torch(table, xt, spec)),
        "dx@track": (lambda: hf.hashgrid_bwd(table, xt, gt, spec, False, True),
                     lambda: hf.hashgrid_bwd_torch(table, xt, gt, spec, False, True)),
    }
    ms = {}
    for k, (kern, twin) in times.items():
        ms[k] = interleaved(kern, twin)
        n = N_TRACK if k.endswith("@track") else N_MAP
        print(f"[time] {k:10s} N={n}: kernel {ms[k][0]:.4f} ms, twin {ms[k][1]:.4f} ms")
    # Bounds at N points x L levels. Bytes: each input read once, each output
    # written once. Operations per (point, level), float only: 3 x 4 for the
    # cell position and fraction; per corner 2 products for its weight, and
    # 2 multiply-adds (4 operations) for the forward, for the dtable terms or
    # for g.f and the 3 derivative terms (about 10) of dx.
    pl = N_MAP * spec.n_levels
    dx_out = torch.empty((N_MAP, 3), device=device)
    bounds = {
        "fwd": bound(nbytes(table, x, out_k), pl * (12 + 8 * 6)),
        "dx": bound(nbytes(table, x, g, dx_out), pl * (12 + 8 * 12)),
        "dtable": bound(nbytes(x, g, dt_k), pl * (12 + 8 * 6)),
    }
    for k, (b_ms, by) in bounds.items():
        print(f"[bound] {k}: {b_ms:.4f} ms ({by})")
    src = "xrdslam_tpu_torch/kernels/hashgrid.cu"
    ref = "xrdslam_tpu/ops/hashgrid_fast.py"
    rows = (("hashgrid_fwd", "fwd", f"{ref}:202", "hashgrid_fwd"),
            ("hashgrid_bwd[dx]", "dx", f"{ref}:216", "hashgrid_bwd_dx"),
            ("hashgrid_bwd[dtable]", "dtable", f"{ref}:95", "hashgrid_bwd_dtable"))
    # no single PyTorch call computes a hash-grid encoding or its gradients
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep, "counter": counter,
             "max_abs_err": err[k], "ms": ms[k][0], "plain_ms": ms[k][1], "bound_ms": bounds[k][0],
             "bound_by": bounds[k][1], "library_ms": None}
            for name, k, rep, counter in rows]


def grown_office_frame(device, model_overrides=None):
    """The gaussians SplaTAM grows from office frame 0 at 600x340, binned at
    that frame's pose, as its main path bins them, with the registry's
    model settings and ``model_overrides``: (algo, params, dead, w2c, tiles,
    mask, count, the frame's depth)."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs

    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, rgb, depth, pose = ds[0]
    cfg = copy.deepcopy(algorithm_configs["splaTAM"].xrdslam.algorithm)
    for name, value in (model_overrides or {}).items():
        setattr(cfg.model, name, value)
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    fr = Frame(fid=0, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
    c2w = torch.as_tensor(fr.get_pose(), device=device)
    params, dead, count = algo.grow_step(algo.params, algo.dead, 0, fr.rgb_dev(device), fr.depth_dev(device), c2w,
                                         True)
    w2c = torch.linalg.inv(c2w)
    tiles, mask = algo.binning(params, dead, count, w2c)
    return algo, params, dead, w2c, tiles, mask, count, depth


def coverage(sil, depth):
    """How much of a frame a map covers: the mean silhouette over the pixels
    with depth, and the shares below growth's 0.5 and above tracking's
    0.99."""
    s = sil[:HEIGHT, :WIDTH].cpu().numpy()[depth > 0]
    return {"mean_sil": float(s.mean()), "below_0.5": float(np.mean(s < 0.5)), "above_0.99": float(np.mean(s > 0.99))}


def check_raster(device):
    """K5, K6, K4 vs twins on a grown office frame; returns the records."""
    import torch

    from xrdslam_tpu_torch.ops import gaussian_raster as gr
    from xrdslam_tpu_torch.ops import scatter as sc

    algo, params, dead, w2c, tiles, mask, count, frame_depth = grown_office_frame(device)
    ntx, nty = algo.ntx, algo.nty
    n_tiles, k = tiles.shape
    G = algo.config.model.max_gaussians
    print(f"[raster] grown {count} gaussians; {n_tiles} tiles ({ntx} x {nty}), K = {k}, "
          f"{int(mask.sum())} of {mask.numel()} slots used")
    u, v, depth, sigma = algo.model.project(params, w2c)
    opacity = torch.sigmoid(params["logit_opacities"][:, 0]) * algo.model.alive_mask(dead, count)
    ch = torch.cat([params["rgb_colors"], depth[:, None], torch.ones_like(depth[:, None]), (depth * depth)[:, None],
                    torch.zeros((G, 2), device=device)], -1)
    tiled = gr._pack_tile_data(u, v, sigma, opacity, ch, tiles, mask)
    gen = torch.Generator(device=device).manual_seed(0)
    gout = torch.randn((nty * 16, ntx * 16, gr.N_CH), generator=gen, device=device)

    out_k = gr.raster_fwd(tiled, ntx, nty)
    # the fresh map as the registry's slots render it (see SPLATAM_GATE)
    print(f"[coverage] grown frame at K = {k}: {json.dumps(coverage(out_k[..., 4], frame_depth))}")
    dg_k = gr.raster_bwd(tiled, gout, ntx, nty)
    idx = tiles.reshape(-1).contiguous()
    torch.cuda.synchronize()
    out_t = gr.raster_fwd_torch(tiled, ntx, nty)
    dg_t = gr.raster_bwd_torch(tiled, gout, ntx, nty)
    g_rows = dg_t.reshape(-1, gr.ROW).contiguous()  # K4's input on the main path: K6's output
    acc_k = sc.scatter_add(idx, g_rows, G)
    acc_t = sc.scatter_add_torch(idx, g_rows, G)
    torch.cuda.synchronize()
    err = {"raster_fwd": float((out_k - out_t).abs().max()), "raster_bwd": float((dg_k - dg_t).abs().max()),
           "scatter_add": float((acc_k - acc_t).abs().max())}
    scale = {"raster_fwd": float(out_t.abs().max()), "raster_bwd": float(dg_t.abs().max()),
             "scatter_add": float(acc_t.abs().max())}
    limit = {"raster_fwd": FWD_ATOL, "raster_bwd": BWD_RTOL * scale["raster_bwd"],
             "scatter_add": BWD_RTOL * scale["scatter_add"]}
    for name in err:
        check(name, err[name], limit[name], scale[name])
    del out_t, dg_t

    lib_out = torch.empty((G, gr.ROW), device=device)

    def library():
        lib_out.zero_()
        lib_out.index_add_(0, idx, g_rows)

    ms = {
        "raster_fwd": interleaved(lambda: gr.raster_fwd(tiled, ntx, nty), lambda: gr.raster_fwd_torch(tiled, ntx, nty)),
        "raster_bwd": interleaved(lambda: gr.raster_bwd(tiled, gout, ntx, nty),
                                  lambda: gr.raster_bwd_torch(tiled, gout, ntx, nty)),
        "scatter_add": interleaved(lambda: sc.scatter_add(idx, g_rows, G), lambda: sc.scatter_add_torch(idx, g_rows, G)),
    }
    lib_ms = min(cuda_ms(library), cuda_ms(library))
    for name, (k_ms, t_ms) in ms.items():
        print(f"[time] {name:12s}: kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms")
    print(f"[time] scatter_add : index_add_ {lib_ms:.4f} ms")
    # Bounds. Pairs: (pixel, used slot), 256 pixels per used slot; unused
    # slots need no work. Operations per pair, float, exp and log1p counted
    # as one each: forward 28 (offset 2, r^2 3, scale 1, exp 1, opacity 1,
    # clamp 2, exp of the running log 1, weight 1, 8 channel multiply-adds 16,
    # log1p 1, running sum 1 - the clamp counted once); backward 60 (the
    # forward's 12 before the channels, g.c 16, contribution and prefix 3,
    # dalpha 4, the common term 2, 4 + 8 products, and 12 sums over pixels).
    # K4: one add per nonzero entry; bytes of every input and output.
    pairs = 256 * int(mask.sum())
    nonzero = int((g_rows != 0).sum())
    bounds = {
        "raster_fwd": bound(nbytes(tiled, out_k), 28 * pairs),
        "raster_bwd": bound(nbytes(tiled, gout, dg_k), 60 * pairs),
        "scatter_add": bound(nbytes(idx, g_rows, acc_k), nonzero),
    }
    for name, (b_ms, by) in bounds.items():
        print(f"[bound] {name}: {b_ms:.4f} ms ({by})")
    src = "xrdslam_tpu_torch/kernels/"
    rows = (("raster_fwd", "gaussian_raster.cu", "xrdslam_tpu/ops/gaussian_raster.py:239", None),
            ("raster_bwd", "gaussian_raster.cu", "xrdslam_tpu/ops/gaussian_raster.py:265", None),
            ("scatter_add", "scatter.cu", "xrdslam_tpu/ops/pallas_scatter.py:38", lib_ms))
    return [{"name": name, "route": "cuda", "source": src + f, "replaces": rep, "counter": name,
             "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": lib}
            for name, f, rep, lib in rows]


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

def run_slam(algorithm: str, data: str, counters=(), overrides=None, ate_limit_cm=None, tag: str = ""):
    """One algorithm through the port's runner on synthetic ``data`` with
    the registry's settings and ``overrides`` ({dotted config path under
    ``xrdslam``: value}); returns (pipeline, results). The launch counts
    are zeroed just before the run and read just after; each of
    ``counters`` must have moved. Poses must be finite; the ATE must be at
    most ``ate_limit_cm`` where one is given."""
    import torch

    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate

    name = algorithm + tag
    cfg = copy.deepcopy(algorithm_configs[algorithm])
    cfg.data, cfg.data_type = data, "synthetic"
    cfg.out_dir = os.path.join(ROOT, "build", f"chip_smoke_{name}")
    cfg.xrdslam.device = "cuda"
    for path, value in (overrides or {}).items():
        *parents, leaf = path.split(".")
        node = cfg.xrdslam
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    runner = cfg.setup()
    pipeline = runner.setup()
    n_frames = len(pipeline.dataset)
    t0 = time.time()
    pipeline.dataset.prerender()
    torch.cuda.synchronize()
    print(f"[slam] {name}: rendered {n_frames} frames ({data}) in {time.time() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.time()
    pipeline.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: v for k, v in all_launches().items() if k in counters}
    algo = pipeline.algorithm
    est = algo.estimate_c2w_list
    if len(est) != n_frames or algo._nonfinite_poses or not all(np.isfinite(p).all() for p in est):
        raise RuntimeError(f"{name}: non-finite or missing poses ({algo._nonfinite_poses} non-finite of {len(est)})")
    ate_cm = evaluate_ate(algo.gt_c2w_list, est)["rmse"] * 100.0
    res = {"run": name, "data": data, "overrides": overrides or {}, "frames": n_frames, "wall_s": wall,
           "ate_rmse_cm": ate_cm, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "keyframes": len(algo.keyframe_fids),
           # translation error of each frame before alignment (cm)
           "frame_err_cm": [round(float(np.linalg.norm(e[:3, 3] - g[:3, 3])) * 100, 3)
                            for e, g in zip(est, algo.gt_c2w_list)]}
    if n_frames > 15:
        res["steady_s_per_frame"], res["spikes_dropped"] = steady_stats(pipeline.frame_times)
    if algorithm == "splaTAM":
        res["gaussians"] = algo.n_gauss
        res["gaussians_alive"] = int(algo.model.alive_mask(algo.dead, algo.n_gauss).sum())
    with open(os.path.join(cfg.out_dir, "timings.json")) as f:
        res["phases"] = json.load(f)
    print(f"[slam] {json.dumps(res)}")
    if ate_limit_cm is not None and ate_cm > ate_limit_cm:
        raise RuntimeError(f"{name}: ATE {ate_cm:.3f} cm > {ate_limit_cm} cm")
    if algorithm == "splaTAM" and not 0 < algo.n_gauss <= algo.config.model.max_gaussians:
        raise RuntimeError(f"{name}: gaussian count {algo.n_gauss} outside (0, {algo.config.model.max_gaussians}]")
    missing = [k for k in counters if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"{name}: kernels never launched on the main path: {missing}")
    return pipeline, res


def profile(name: str, phases) -> None:
    """torch.profiler over one call of each phase (after one warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for phase, fn in phases.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device rows only: an operator row repeats its kernels' time
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
        print(f"[profile] {name} {phase}: wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
              f"({100 * dev_ms / max(wall_ms, 1e-9):.1f}%), kernels {sum(e.count for e in evs)}")
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def last_frame(pipeline):
    """A Frame of the run's last image at its estimated pose."""
    from xrdslam_tpu_torch.common.frame import Frame

    algo = pipeline.algorithm
    _, rgb, depth, _ = pipeline.dataset[len(pipeline.dataset) - 1]
    return Frame(fid=-1, rgb=rgb, depth=depth, init_pose=algo.estimate_c2w_list[-1], rot_rep=algo.config.rot_rep)


def profile_coslam(pipeline) -> None:
    """One tracking and one (non-first) mapping call on the last frame; it
    updates the finished run's map."""
    algo = pipeline.algorithm
    fr = last_frame(pipeline)
    args = (fr.rgb_dev(algo.device), fr.depth_dev(algo.device), algo._pose(fr.t), algo._pose(fr.r))
    profile("co-slam", {"track": lambda: algo.track_step(*args),
                        "map": lambda: algo.map_step(*args, algo.config.mapping_n_iters, False, algo._cur_cap())})


def profile_splatam(pipeline) -> None:
    """One tracking call (binning + 40 iterations) and one mapping call
    (growth, window binning, 60 iterations) on the last frame, as the
    pipeline makes them; the mapping calls update the finished run's map."""
    algo = pipeline.algorithm
    fr = last_frame(pipeline)
    profile("splaTAM", {"track": lambda: algo.finish_tracking(algo.dispatch_tracking(fr)),
                        "map": lambda: algo.do_mapping(fr)})


def slots_probe(device) -> None:
    """SplaTAM's registry run (the office at 600x340, 20 frames) against one
    change at a time (``SLOTS_PROBE``, dotted config paths under
    ``xrdslam``): the coverage of the map grown from frame 0 at that
    setting, then the run's ATE and per-frame error. Nothing is gated but
    finite poses."""
    import torch

    data = f"n_frames={SPLATAM_FRAMES},height={HEIGHT},width={WIDTH},scene=office"
    prefix = "algorithm.model."
    for name, overrides in SLOTS_PROBE.items():
        model = {k[len(prefix):]: v for k, v in overrides.items() if k.startswith(prefix)}
        algo, params, dead, w2c, tiles, mask, count, depth = grown_office_frame(device, model)
        out = algo.model.render(params, algo.model.alive_mask(dead, count), w2c, (tiles, mask), algo.ntx, algo.nty)
        cov = coverage(out["sil"], depth)
        del algo, params, dead, tiles, mask, out
        _, res = run_slam("splaTAM", data, overrides=overrides, tag=f"@{name}")
        torch.cuda.empty_cache()
        print(json.dumps({"slots_probe": name, "overrides": overrides, "grown_frame_coverage": cov,
                          "ate_rmse_cm": res["ate_rmse_cm"], "frame_err_cm": res["frame_err_cm"],
                          "gaussians": res["gaussians"], "steady_s_per_frame": res["steady_s_per_frame"]}))


def main(argv) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.models.joint_encoding import JointEncoding
    from xrdslam_tpu_torch.pipeline.slam import resolve_device

    device = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    sources = ("hashgrid", "gaussian_raster", "scatter")
    t0 = time.perf_counter()
    kernels.build_all(sources)
    print(f"[build] {len(sources)} sources in parallel: {time.perf_counter() - t0:.3f} s")
    for src in sources:
        info = kernels.BUILD_INFO[src]
        print(f"[build] {src}.cu: nvcc {info['seconds']:.3f} s")
        print("\n".join("[ptxas] " + ln for ln in str(info["ptxas"]).splitlines() if ln.strip()))
    if argv == ["--slots-probe"]:
        slots_probe(device)
        return
    if argv:
        raise SystemExit(f"chip_smoke.py: unknown arguments {argv}")

    # the office spec, as the Co-SLAM run's model builds it
    model_cfg = algorithm_configs["co-slam"].xrdslam.algorithm.model
    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office")
    spec = JointEncoding(model_cfg, ds.get_camera(), ds.bounds).spec
    print(f"[spec] levels {spec.n_levels}, T=2^{spec.log2_table_size}, res {spec.resolutions}, "
          f"dense {sum(spec.dense)}")
    records = check_hashgrid(spec, device) + check_raster(device)
    torch.cuda.empty_cache()

    office = f"height={HEIGHT},width={WIDTH},scene=office"
    # the reference benchmark's Co-SLAM settings: the registry's entry with
    # the scene's bounds and a keyframe table sized to the run
    bounds = SyntheticDataset(office).bounds.tolist()
    pipeline, res = run_slam("co-slam", f"n_frames={COSLAM_FRAMES},{office}",
                             ("hashgrid_fwd", "hashgrid_bwd_dx", "hashgrid_bwd_dtable"),
                             {"algorithm.mapping_bound": bounds,
                              "algorithm.max_keyframes": max(COSLAM_FRAMES // 5 + 2, 8)}, ATE_LIMIT_CM)
    launches = dict(res["launches"])
    profile_coslam(pipeline)
    del pipeline
    torch.cuda.empty_cache()
    splatam_data = f"n_frames={SPLATAM_FRAMES},{office}"
    # SplaTAM's accuracy at full width (see SPLATAM_GATE)
    run_slam("splaTAM", splatam_data, overrides=SPLATAM_GATE, ate_limit_cm=ATE_LIMIT_CM, tag="@k512")
    torch.cuda.empty_cache()
    # the main path: full width, registry settings (ATE reported, not gated)
    pipeline, res = run_slam("splaTAM", splatam_data, ("raster_fwd", "raster_bwd", "scatter_add"))
    launches.update(res["launches"])
    profile_splatam(pipeline)
    for r in records:
        r["launches"] = launches[r.pop("counter")]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
