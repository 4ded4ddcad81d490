"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

1. Prints the card (torch and nvidia-smi).
2. Builds every kernel from ``xrdslam_tpu_torch/kernels/*.cu``, one nvcc per
   source, all at once, and prints their ptxas reports.
3. Holds each kernel against its plain PyTorch twin at the shapes of the
   main paths and times both with CUDA events (median of 20 runs, twin,
   kernel, kernel, twin), beside its bound (the least time the card could
   take, from the bytes it must move and the operations it must do, on
   the float32 and on the special-function units):
   the hash-grid kernels K1-K3 at Co-SLAM's mapping shapes (N = 176,128
   points, some outside [0,1]^3) and the plane-layout hash-grid kernels
   K8/K9 at the same shapes (nothing in the repository calls them: they
   are held at function level); the rasterizer K5/K6 and the scatter-add
   K4 on gaussians grown from an office frame at 600x340 and binned at its
   pose (836 tiles, K = 256, 131,072 rows), with a seeded random upstream
   gradient, and K5/K6 again binned with K = 512 (the SplaTAM gate's);
   K5/K6 also by device time. K4 is also timed against
   ``Tensor.index_add_``. The row
   gather K7 at Point-SLAM's mapping shape: the union rows of the point map
   grown from office frame 0 at 600x340 (registry settings), gathered for
   the 24,960 surface samples of 4,992 rays (bit for bit against the twin,
   at width 1024 for K7a and 128 for K7b, timed against
   ``torch.index_select``); and K4 at ``table_lookup``'s shape, the
   199,680 neighbour rows of those samples into the 262,144 x 32 table.
4. Runs, through the port's runner: Co-SLAM on the synthetic office at
   600x340 with the benchmark settings, twice (gated): with the exact hash
   grid (K1-K3) and at the registry's default, the packed hash (K4 as its
   tables' gradient, launches equal to the schedule's); Co-SLAM at the
   accuracy protocol (``bench_accuracy.py``'s configuration: the
   tri-plane, 200 frames; gated on ATE, K4 launches equal to the
   schedule's), then its protocol row: PSNR, SSIM and depth-L1 of
   ``render_img`` every 50 frames, and accuracy, completion and completion
   ratio of its culled mesh against the scene's exact one, printed as one
   ``[protocol]`` line beside the JAX package's row of
   ``BENCH_ACCURACY.json`` and the verdicts of ``bench_accuracy.py``'s
   gates (read from the two files as data; only the ATE gate and finite
   values fail the smoke);
   SplaTAM on the office at 600x340 for 20 frames with the registry's
   settings but 512 slots per tile (gated); SplaTAM's main path,
   the same with the registry's settings (256 slots per tile; ATE
   reported: see ``SPLATAM_GATE``); and Point-SLAM's main path, the
   registry's settings on the office at 600x340 for 12 frames (gated; K7
   and K4 launches equal to the schedule's). A gated run's ATE must be at most
   10 cm and at most half that of a camera frozen at frame 0
   (``FROZEN_ATE_SHARE``). Every pose must be finite and every kernel of
   each main path launched (the launch counts are zeroed just before each
   run and read just after).
5. Profiles one tracking and one mapping call of each run on a main path
   and of SplaTAM's K = 512 run with torch.profiler
   (Point-SLAM's mapping call with 60 iterations): wall time, device busy
   time and the kernels that take it. ``[elapsed]`` lines stamp the
   phases.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises (non-zero exit,
no result).

    python3 chip_smoke.py --slots-probe

builds the kernels and measures SplaTAM's registry run against one change
at a time (``SLOTS_PROBE``: a larger table, more slots per tile, the JAX
package's smoke schedule), the evidence behind ``SPLATAM_GATE``; it prints
one JSON line per setting and no result line.

    python3 chip_smoke.py --raster-variants

builds the rasterizer with one change at a time (``RASTER_VARIANTS``) and
times each beside the shipped K5/K6 on the grown office frame at K = 256
and 512 (``[variant]`` lines, no result line): what each part of the
kernels' design costs or saves.

    python3 chip_smoke.py --pointslam-repeat N

runs Point-SLAM's gated main path N times and prints each run's ATE beside
its gate (nothing gated, no result line): the spread between runs.
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
PROTOCOL_FRAMES = 200  # bench_accuracy.py's sequence
PROTOCOL_RENDER_FREQ = 50  # bench_accuracy.py's default render_freq
SPLATAM_FRAMES = 20
POINTSLAM_FRAMES = 12  # a first mapping of 1,500 iterations, then 11 x (40 tracking + 300 mapping)
# The profiled Point-SLAM mapping call runs 60 of the registry's 300
# iterations: torch.profiler took ~4.5 minutes of the host to process a
# 300-iteration call (420,000 kernels); the iterations are alike.
POINTSLAM_PROFILE_MAP_ITERS = 60
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
# A gated run must also score at most this share of the ATE of a camera
# that never moves (every pose frame 0's): the office tour moves 0.6 cm a
# frame, so over Point-SLAM's 12 frames that camera scores 2.16 cm, far
# inside ATE_LIMIT_CM, and only this bound tells tracking from none.
FROZEN_ATE_SHARE = 0.5
FWD_ATOL = 1e-5
BWD_RTOL = 1e-4  # of max |twin|: sums in another order (fp32 atomics in K2-K4)
# NVIDIA H100 SXM, published peaks (data sheet): HBM rate and float32 rate
# outside the tensor cores, the rate of the kernels' arithmetic; and the
# special-function units' rate (exp, log, reciprocal): 16 a clock on each
# of the 132 SMs at the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_SFU_OPS_PER_S = 132 * 16 * 1.98e9


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


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn``'s kernels per call, from torch.profiler over
    ``reps`` calls: the card's own time, without the host's launch gaps that
    CUDA events around a short kernel also take in."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in evs) / 1e3 / reps


def interleaved(kern, twin):
    """(kernel ms, twin ms): twin, kernel, kernel, twin, so both see the
    same card state; the better of each pair."""
    t1, k1, k2, t2 = cuda_ms(twin), cuda_ms(kern), cuda_ms(kern), cuda_ms(twin)
    return min(k1, k2), min(t1, t2)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, n_sfu: float = 0.0):
    """(bound ms, what bounds it): the largest of bytes over the memory
    rate, float32 operations over the float32 rate and special-function
    operations over the special-function rate ("operations" for both)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, max(n_ops / PEAK_F32_OPS_PER_S, n_sfu / PEAK_SFU_OPS_PER_S)
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


def _counted_modules():
    from xrdslam_tpu_torch.ops import gaussian_raster, hashgrid_fast, hashgrid_planes, row_gather, scatter

    return hashgrid_fast, hashgrid_planes, gaussian_raster, scatter, row_gather


def reset_all_launches() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def all_launches():
    return {k: v for mod in _counted_modules() for k, v in mod.LAUNCHES.items()}


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


def check_hashgrid_planes(spec, device):
    """K8/K9 vs twin at the mapping shape, on the plane layout of a random
    office-spec table; returns the per-kernel records (0 launches: no path
    calls them)."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_planes as hp

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (N_MAP, 3)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.standard_normal((N_MAP, spec.out_dim)).astype(np.float32), device=device)
    table = torch.as_tensor(rng.standard_normal((spec.n_levels, spec.table_size, 2)).astype(np.float32), device=device)
    planes = hp.pack_table(table)

    out_k = hp.hashgrid_planes_fwd(planes, x, spec)
    dp_k, dx_k = hp.hashgrid_planes_bwd(planes, x, g, spec)
    torch.cuda.synchronize()
    out_t = hp.hashgrid_planes_fwd_torch(planes, x, spec)
    dp_t, dx_t = hp.hashgrid_planes_bwd_torch(planes, x, g, spec)
    err = {"fwd": float((out_k - out_t).abs().max()), "dx": float((dx_k - dx_t).abs().max()),
           "dplanes": float((dp_k - dp_t).abs().max())}
    scale = {"fwd": float(out_t.abs().max()), "dx": float(dx_t.abs().max()), "dplanes": float(dp_t.abs().max())}
    limit = {"fwd": FWD_ATOL, "dx": BWD_RTOL * scale["dx"], "dplanes": BWD_RTOL * scale["dplanes"]}
    for k in err:
        check(f"planes {k}", err[k], limit[k], scale[k])
    del out_t, dp_t, dx_t
    ms = {"fwd": interleaved(lambda: hp.hashgrid_planes_fwd(planes, x, spec),
                             lambda: hp.hashgrid_planes_fwd_torch(planes, x, spec)),
          "bwd": interleaved(lambda: hp.hashgrid_planes_bwd(planes, x, g, spec),
                             lambda: hp.hashgrid_planes_bwd_torch(planes, x, g, spec))}
    for k, (k_ms, t_ms) in ms.items():
        print(f"[time] planes {k} N={N_MAP}: kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms")
    # Bounds as for K1-K3; K9's operations per corner are K2's and K3's
    # together (the weight once): 2 + 4 + 10.
    pl = N_MAP * spec.n_levels
    bounds = {"fwd": bound(nbytes(planes, x, out_k), pl * (12 + 8 * 6)),
              "bwd": bound(nbytes(planes, x, g, dx_k, dp_k), pl * (12 + 8 * 16))}
    for k, (b_ms, by) in bounds.items():
        print(f"[bound] planes {k}: {b_ms:.4f} ms ({by})")
    src, ref = "xrdslam_tpu_torch/kernels/hashgrid.cu", "xrdslam_tpu/ops/pallas_hashgrid.py"
    rows = (("hashgrid_planes_fwd", "fwd", f"{ref}:103 (_fwd_kernel; nothing in the repository calls it)",
             err["fwd"]),
            ("hashgrid_planes_bwd", "bwd", f"{ref}:123 (_bwd_kernel; nothing in the repository calls it)",
             max(err["dx"], err["dplanes"])))
    # no single PyTorch call computes a hash-grid encoding or its gradients
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep, "counter": None,
             "max_abs_err": e, "ms": ms[k][0], "plain_ms": ms[k][1], "bound_ms": bounds[k][0],
             "bound_by": bounds[k][1], "library_ms": None}
            for name, k, rep, e in rows]


def check_scatter_coslam(spec, device):
    """K4 at the shapes Co-SLAM's encodings give it (mapping: N = 176,128
    points): the packed hash's finest level (rows of 16 into T = 65,536) and
    the tri-plane's finer scale (rows of 4 x 8 moments into 512^2 cells),
    rows from the cells of random points; returns the records."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_packed, triplane
    from xrdslam_tpu_torch.ops import scatter as sc

    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (N_MAP, 3)).astype(np.float32), device=device)
    u0, _ = triplane._cells(x, 512)
    cases = {
        "scatter_add[packed hash]": (hashgrid_packed._cells(x, spec)[0][:, -1].to(torch.int32), 16, spec.table_size),
        "scatter_add[triplane]": ((u0[:, 0] * 512 + u0[:, 1]).to(torch.int32), 32, 512 * 512),
    }
    records = []
    for name, (idx, width, rows) in cases.items():
        idx = idx.contiguous()
        g = torch.as_tensor(rng.standard_normal((N_MAP, width)).astype(np.float32), device=device)
        acc_k = sc.scatter_add(idx, g, rows)
        torch.cuda.synchronize()
        acc_t = sc.scatter_add_torch(idx, g, rows)
        err = float((acc_k - acc_t).abs().max())
        scale = float(acc_t.abs().max())
        check(name, err, BWD_RTOL * scale, scale)
        idx_long = idx.long()
        lib_out = torch.empty((rows, width), device=device)

        def index_add():
            lib_out.zero_()
            lib_out.index_add_(0, idx_long, g)

        k_ms, t_ms = interleaved(lambda: sc.scatter_add(idx, g, rows), lambda: sc.scatter_add_torch(idx, g, rows))
        lib_ms = min(cuda_ms(index_add) for _ in range(2))
        b_ms, by = bound(nbytes(idx, g, acc_k), int((g != 0).sum()))
        print(f"[time] {name}: kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms, index_add_ {lib_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({by}); device time (profiler) kernel "
              f"{device_ms(lambda: sc.scatter_add(idx, g, rows)):.4f} ms, index_add_ {device_ms(index_add):.4f} ms")
        records.append({"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": name, "max_abs_err": err,
                        "ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms})
    return records


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
    """K5, K6 (at the registry's K = 256 and the gate's 512) and K4 vs
    twins on a grown office frame; returns the records."""
    import torch

    records = check_raster_at(device, 256, with_scatter=True)
    torch.cuda.empty_cache()
    return records + check_raster_at(device, SPLATAM_GATE["algorithm.model.k_per_tile"], with_scatter=False)


def raster_inputs(device, k_per_tile: int):
    """K5/K6's inputs on the main path's data: the gaussians grown from
    office frame 0, binned with ``k_per_tile`` slots, packed; and a seeded
    random upstream gradient. (tiled, gout, tile ids, tile mask, table
    rows, the frame's depth)."""
    import torch

    from xrdslam_tpu_torch.ops import gaussian_raster as gr

    algo, params, dead, w2c, tiles, mask, count, frame_depth = grown_office_frame(
        device, {"k_per_tile": k_per_tile})
    ntx, nty = algo.ntx, algo.nty
    G = algo.config.model.max_gaussians
    print(f"[raster] grown {count} gaussians; {tiles.shape[0]} tiles ({ntx} x {nty}), K = {tiles.shape[1]}, "
          f"{int(mask.sum())} of {mask.numel()} slots used")
    u, v, depth, sigma = algo.model.project(params, w2c)
    opacity = torch.sigmoid(params["logit_opacities"][:, 0]) * algo.model.alive_mask(dead, count)
    ch = torch.cat([params["rgb_colors"], depth[:, None], torch.ones_like(depth[:, None]), (depth * depth)[:, None],
                    torch.zeros((G, 2), device=device)], -1)
    tiled = gr._pack_tile_data(u, v, sigma, opacity, ch, tiles, mask)
    gen = torch.Generator(device=device).manual_seed(0)
    gout = torch.randn((nty * 16, ntx * 16, gr.N_CH), generator=gen, device=device)
    return tiled, gout, tiles, mask, G, frame_depth


def check_raster_at(device, k_per_tile: int, with_scatter: bool):
    """K5 and K6 (and K4, ``with_scatter``) against their twins on the
    gaussians grown from office frame 0 and binned with ``k_per_tile``
    slots; times each (K5 and K6 also by device time) and returns the
    records, named with a ``[k<K>]`` suffix away from the registry's K."""
    import torch

    from xrdslam_tpu_torch.ops import gaussian_raster as gr
    from xrdslam_tpu_torch.ops import scatter as sc

    tiled, gout, tiles, mask, G, frame_depth = raster_inputs(device, k_per_tile)
    ntx, nty = gout.shape[1] // 16, gout.shape[0] // 16
    k = tiles.shape[1]
    tag = "" if k == 256 else f"[k{k}]"
    out_k = gr.raster_fwd(tiled, ntx, nty)
    # the fresh map as these slots render it (see SPLATAM_GATE)
    print(f"[coverage] grown frame at K = {k}: {json.dumps(coverage(out_k[..., 4], frame_depth))}")
    dg_k = gr.raster_bwd(tiled, gout, out_k, ntx, nty)
    torch.cuda.synchronize()
    out_t = gr.raster_fwd_torch(tiled, ntx, nty)
    dg_t = gr.raster_bwd_torch(tiled, gout, out_t, ntx, nty)
    err = {"raster_fwd": float((out_k - out_t).abs().max()), "raster_bwd": float((dg_k - dg_t).abs().max())}
    scale = {"raster_fwd": float(out_t.abs().max()), "raster_bwd": float(dg_t.abs().max())}
    limit = {"raster_fwd": FWD_ATOL, "raster_bwd": BWD_RTOL * scale["raster_bwd"]}
    if with_scatter:
        idx = tiles.reshape(-1).contiguous()
        g_rows = dg_t.reshape(-1, gr.ROW).contiguous()  # K4's input on the main path: K6's output
        acc_k = sc.scatter_add(idx, g_rows, G)
        acc_t = sc.scatter_add_torch(idx, g_rows, G)
        torch.cuda.synchronize()
        err["scatter_add"] = float((acc_k - acc_t).abs().max())
        scale["scatter_add"] = float(acc_t.abs().max())
        limit["scatter_add"] = BWD_RTOL * scale["scatter_add"]
    for name in err:
        check(name + tag, err[name], limit[name], scale[name])
    del out_t, dg_t

    ms = {
        "raster_fwd": interleaved(lambda: gr.raster_fwd(tiled, ntx, nty), lambda: gr.raster_fwd_torch(tiled, ntx, nty)),
        "raster_bwd": interleaved(lambda: gr.raster_bwd(tiled, gout, out_k, ntx, nty),
                                  lambda: gr.raster_bwd_torch(tiled, gout, out_k, ntx, nty)),
    }
    dev_ms = {"raster_fwd": device_ms(lambda: gr.raster_fwd(tiled, ntx, nty)),
              "raster_bwd": device_ms(lambda: gr.raster_bwd(tiled, gout, out_k, ntx, nty))}
    lib_ms = {"raster_fwd": None, "raster_bwd": None}
    if with_scatter:
        ms["scatter_add"] = interleaved(lambda: sc.scatter_add(idx, g_rows, G),
                                        lambda: sc.scatter_add_torch(idx, g_rows, G))
        lib_out = torch.empty((G, gr.ROW), device=device)

        def library():
            lib_out.zero_()
            lib_out.index_add_(0, idx, g_rows)

        lib_ms["scatter_add"] = min(cuda_ms(library), cuda_ms(library))
        print(f"[time] scatter_add : index_add_ {lib_ms['scatter_add']:.4f} ms")
    for name, (k_ms, t_ms) in ms.items():
        dev = f", device {dev_ms[name]:.4f} ms" if name in dev_ms else ""
        print(f"[time] {name + tag:12s}: kernel {k_ms:.4f} ms{dev}, twin {t_ms:.4f} ms")
    # Bounds: the work of one walk over the live (pixel, slot) pairs, 256
    # pixels per live slot; masked slots need no work. Float32 operations
    # per pair: forward 28 (offset 2, r^2 3, scale 1, exp 1, opacity 1,
    # clamp 2, exp of the running log 1, weight 1, 8 channel multiply-adds
    # 16, log1p 1, running sum 1 - the clamp counted once); backward 60 (the
    # forward's 12 before the channels, g.c 16, contribution and prefix 3,
    # dalpha 4, the common term 2, 4 + 8 products, and 12 sums over pixels).
    # Special-function operations per pair: two exp and a log1p, and in the
    # backward a division. K4: one add per nonzero entry. Bytes: every input
    # read once and every output written once.
    pairs = 256 * int(mask.sum())
    bounds = {
        "raster_fwd": bound(nbytes(tiled, out_k), 28 * pairs, 3 * pairs),
        "raster_bwd": bound(nbytes(tiled, gout, out_k, dg_k), 60 * pairs, 4 * pairs),
    }
    if with_scatter:
        bounds["scatter_add"] = bound(nbytes(idx, g_rows, acc_k), int((g_rows != 0).sum()))
    for name, (b_ms, by) in bounds.items():
        live = f"; {pairs} live (pixel, slot) pairs" if name != "scatter_add" else ""
        print(f"[bound] {name + tag}: {b_ms:.4f} ms ({by}{live})")
    src = "xrdslam_tpu_torch/kernels/"
    rows = (("raster_fwd", "gaussian_raster.cu", "xrdslam_tpu/ops/gaussian_raster.py:239"),
            ("raster_bwd", "gaussian_raster.cu", "xrdslam_tpu/ops/gaussian_raster.py:265"),
            ("scatter_add", "scatter.cu", "xrdslam_tpu/ops/pallas_scatter.py:38"))
    return [{"name": name + tag, "route": "cuda", "source": src + f, "replaces": rep, "counter": name + tag,
             "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": lib_ms[name]}
            for name, f, rep in rows if name in ms]


def check_point_table(device):
    """K7 (both widths) and K4 at Point-SLAM's mapping shapes vs their twins;
    returns the records."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops import row_gather as rg
    from xrdslam_tpu_torch.ops import scatter as sc
    from xrdslam_tpu_torch.ops.point_table import hash_probe, knn_query

    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, rgb, depth, pose = ds[0]
    cfg = copy.deepcopy(algorithm_configs["point-slam"].xrdslam.algorithm)
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    fr = Frame(fid=0, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
    t0 = time.perf_counter()
    algo.add_points_from_frame(fr, cfg.pixels_adding)
    torch.cuda.synchronize()
    pm = algo.point_map
    print(f"[pointmap] office frame 0: {pm.n_points} points from {cfg.pixels_adding} pixels in "
          f"{time.perf_counter() - t0:.3f} s (insertion and upload), {int((pm.cell_count > 0).sum())} rows, "
          f"fullest {int(pm.cell_count.max())} of {pm.per_cell}, overflowed {pm.overflowed}")
    t0 = time.perf_counter()
    algo.maps = pm.device_state(device)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    up_b = pm.cell_data.nbytes + pm.cell_keys.nbytes
    print(f"[pointmap] upload after an insertion: {up_b / 2**20:.1f} MiB in {1e3 * up_s:.3f} ms "
          f"({up_b / up_s / 1e9:.2f} GB/s, host clock)")
    # a mapping iteration's queries: the surface samples of 12 window slots x
    # 416 pixels, on this frame at its pose (as render_rays places them)
    n_slots = cfg.mapping_window_size
    n_rays = n_slots * max(cfg.mapping_sample // n_slots, cfg.min_sample_pixels)
    gen = torch.Generator(device=device).manual_seed(0)
    u = torch.randint(0, WIDTH, (n_rays,), generator=gen, device=device)
    v = torch.randint(0, HEIGHT, (n_rays,), generator=gen, device=device)
    c2w = torch.as_tensor(fr.get_pose(), device=device)
    rays_d = algo._dirs[v, u] @ c2w[:3, :3].T
    d = fr.depth_dev(device)[v, u][:, None]
    m = cfg.model
    t = torch.linspace(0.0, 1.0, m.rendering_n_surface, device=device)
    z = m.rendering_near_end_surface * d * (1 - t) + m.rendering_far_end_surface * d * t
    far = torch.minimum(5.0 * d.mean(), (d * 1.2).max())
    z = torch.where(d > 0, z, torch.linspace(0.1, 1.0, m.rendering_n_surface, device=device) * far)
    pts = (c2w[:3, 3] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    n = pts.shape[0]
    idx, found = hash_probe(algo.maps, pts)
    table = algo.maps["cell_data"]
    table128 = table[:, :128].contiguous()
    print(f"[pointmap] {n} queries: {int(found.sum())} found a row, {int(torch.unique(idx).numel())} distinct rows")

    got = {"row_gather": rg.row_gather_rows(table, idx), "row_gather[C=128]": rg.row_gather_rows(table128, idx)}
    torch.cuda.synchronize()
    want = {"row_gather": rg.row_gather_torch(table, idx), "row_gather[C=128]": rg.row_gather_torch(table128, idx)}
    err = {}
    for name in got:
        same = torch.equal(got[name].view(torch.int32), want[name].view(torch.int32))
        if not same:
            raise RuntimeError(f"kernel {name} disagrees with its twin: the gathered rows differ in their bits")
        err[name] = float((got[name] - want[name]).abs().max())  # 0 when the bits agree (no NaN in the rows)
        print(f"[check] {name}: [{n}, {got[name].shape[1]}] equal to the twin bit for bit")

    # K4 at table_lookup's shape: the neighbour ids of these queries, a
    # seeded upstream gradient, into the 262,144-row feature table
    _, nb, _ = knn_query(algo.maps, pts, k=m.pointcloud_nn_num)
    nb = nb.reshape(-1).contiguous()
    g = torch.randn((nb.shape[0], m.c_dim), generator=gen, device=device)
    R = m.max_points
    acc_k = sc.scatter_add(nb, g, R)
    acc_t = sc.scatter_add_torch(nb, g, R)
    torch.cuda.synchronize()
    err["scatter_add[table_lookup]"] = float((acc_k - acc_t).abs().max())
    scale = float(acc_t.abs().max())
    check("scatter_add[table_lookup]", err["scatter_add[table_lookup]"], BWD_RTOL * scale, scale)
    print(f"[pointmap] table_lookup: {nb.shape[0]} rows of {m.c_dim} into {R}")

    idx_long = idx.long()
    nb_long = nb.long()
    lib_out = torch.empty((R, m.c_dim), device=device)

    def index_add():
        lib_out.zero_()
        lib_out.index_add_(0, nb_long, g)

    ms = {
        "row_gather": interleaved(lambda: rg.row_gather_rows(table, idx), lambda: rg.row_gather_torch(table, idx)),
        "row_gather[C=128]": interleaved(lambda: rg.row_gather_rows(table128, idx),
                                         lambda: rg.row_gather_torch(table128, idx)),
        "scatter_add[table_lookup]": interleaved(lambda: sc.scatter_add(nb, g, R),
                                                 lambda: sc.scatter_add_torch(nb, g, R)),
    }
    lib = {
        "row_gather": min(cuda_ms(lambda: torch.index_select(table, 0, idx_long)) for _ in range(2)),
        "row_gather[C=128]": min(cuda_ms(lambda: torch.index_select(table128, 0, idx_long)) for _ in range(2)),
        "scatter_add[table_lookup]": min(cuda_ms(index_add) for _ in range(2)),
    }
    for name, (k_ms, t_ms) in ms.items():
        print(f"[time] {name}: kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms, library {lib[name]:.4f} ms")
    dev = {
        "row_gather": (device_ms(lambda: rg.row_gather_rows(table, idx)),
                       device_ms(lambda: torch.index_select(table, 0, idx_long))),
        "row_gather[C=128]": (device_ms(lambda: rg.row_gather_rows(table128, idx)),
                              device_ms(lambda: torch.index_select(table128, 0, idx_long))),
        "scatter_add[table_lookup]": (device_ms(lambda: sc.scatter_add(nb, g, R)), device_ms(index_add)),
    }
    for name, (k_ms, l_ms) in dev.items():
        print(f"[time] {name}: device time (profiler) kernel {k_ms:.4f} ms, library {l_ms:.4f} ms")
    # Bounds. K7: each distinct row read once, each output row written once,
    # the ids read; no arithmetic. K4: as for SplaTAM's shape.
    distinct = int(torch.unique(idx).numel())
    bounds = {
        "row_gather": bound(distinct * table.shape[1] * 4 + nbytes(got["row_gather"], idx), 0),
        "row_gather[C=128]": bound(distinct * 128 * 4 + nbytes(got["row_gather[C=128]"], idx), 0),
        "scatter_add[table_lookup]": bound(nbytes(nb, g, acc_k), int((g != 0).sum())),
    }
    for name, (b_ms, by) in bounds.items():
        print(f"[bound] {name}: {b_ms:.4f} ms ({by})")
    rows = (("row_gather", "row_gather.cu", "xrdslam_tpu/ops/row_gather.py:47", "row_gather"),
            # no path gathers at width 128: the main path launches K7 at 1024 only
            ("row_gather[C=128]", "row_gather.cu", "xrdslam_tpu/ops/row_gather.py:29", None),
            ("scatter_add[table_lookup]", "scatter.cu", "xrdslam_tpu/ops/pallas_scatter.py:38",
             "scatter_add[point-slam]"))
    return [{"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/" + f, "replaces": rep,
             "counter": counter, "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": lib[name]}
            for name, f, rep, counter in rows]


def pointslam_schedule(cfg, n_frames: int):
    """K7 and K4 launches of a Point-SLAM run in which every frame is mapped
    and the first is not tracked: one gather per ``query_raw`` (each
    mapping and tracking iteration); one table gradient per geometry
    iteration, two per colour iteration, none in tracking."""
    a = cfg.xrdslam.algorithm
    if n_frames - 1 > cfg.xrdslam.tracker.lazy_start:
        raise ValueError("the schedule assumes that every frame is mapped (lazy start)")
    iters = [a.mapping_first_n_iters] + [a.mapping_n_iters] * (n_frames - 1)
    geo = [int(a.mapping_geo_iter_ratio * it) for it in iters]
    return {"row_gather": sum(iters) + a.tracking_n_iters * (n_frames - 1),
            "scatter_add": sum(g + 2 * (it - g) for g, it in zip(geo, iters))}


def coslam_scatter_schedule(cfg, n_frames: int, spec, encoding: str) -> int:
    """K4 launches of a Co-SLAM run whose frames are mapped every
    ``map_every`` and on the last frame: the packed hash scatters one table
    gradient per level for each encode that a mapping backward
    differentiates (the rays'; after the first mapping also the smoothness
    grid's); the tri-plane one per plane and scale for the rays' encode
    (its smoothness is a TV on the planes). Tracking's tables are
    constants: none."""
    a, t = cfg.xrdslam.algorithm, cfg.xrdslam.tracker
    n_later = sum(1 for i in range(1, n_frames) if i % t.map_every == 0 or i == n_frames - 1)
    first, later = a.mapping_first_n_iters, a.mapping_n_iters * n_later
    if encoding == "triplane":
        per = 3 * len(cfg.xrdslam.algorithm.model.triplane_resolutions)
        return per * (first + later)
    return spec.n_levels * (first + 2 * later)


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

def run_slam(algorithm: str, data: str, counters=(), overrides=None, ate_limit_cm=None, tag: str = "", config=None):
    """One algorithm through the port's runner on synthetic ``data`` with
    the registry's settings and ``overrides`` ({dotted config path under
    ``xrdslam``: value}); returns (pipeline, results). The launch counts
    are zeroed just before the run and read just after; each of
    ``counters`` must have moved. Poses must be finite; where
    ``ate_limit_cm`` is given, the ATE must be at most that and at most
    ``FROZEN_ATE_SHARE`` of the ATE of a camera frozen at frame 0.
    ``config`` replaces the registry's entry."""
    import torch

    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate

    name = algorithm + tag
    cfg = copy.deepcopy(config or algorithm_configs[algorithm])
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
    frozen_cm = evaluate_ate(algo.gt_c2w_list, [algo.gt_c2w_list[0]] * n_frames)["rmse"] * 100.0
    res = {"run": name, "data": data, "overrides": overrides or {}, "frames": n_frames, "wall_s": wall,
           "ate_rmse_cm": ate_cm, "frozen_ate_cm": frozen_cm, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "keyframes": len(algo.keyframe_fids),
           # translation error of each frame before alignment (cm)
           "frame_err_cm": [round(float(np.linalg.norm(e[:3, 3] - g[:3, 3])) * 100, 3)
                            for e, g in zip(est, algo.gt_c2w_list)]}
    if n_frames > 15:
        res["steady_s_per_frame"], res["spikes_dropped"] = steady_stats(pipeline.frame_times)
    else:  # too few frames for the steady rule: the mean after the first (its first mapping)
        res["s_per_frame_after_first"] = float(np.mean(pipeline.frame_times[1:]))
    if algorithm == "splaTAM":
        res["gaussians"] = algo.n_gauss
        res["gaussians_alive"] = int(algo.model.alive_mask(algo.dead, algo.n_gauss).sum())
    if algorithm == "point-slam":
        res["n_points"] = algo.point_map.n_points
        res["overflowed"] = algo.point_map.overflowed
    with open(os.path.join(cfg.out_dir, "timings.json")) as f:
        res["phases"] = json.load(f)
    print(f"[slam] {json.dumps(res)}")
    if ate_limit_cm is not None:
        limit = min(ate_limit_cm, FROZEN_ATE_SHARE * frozen_cm)
        print(f"[gate] {name}: ATE {ate_cm:.4f} cm against {limit:.4f} cm (the smaller of {ate_limit_cm} cm and "
              f"{FROZEN_ATE_SHARE} x {frozen_cm:.4f} cm, the ATE of a camera frozen at frame 0)")
        if ate_cm > limit:
            raise RuntimeError(f"{name}: ATE {ate_cm:.3f} cm > {limit:.3f} cm")
    if algorithm == "splaTAM" and not 0 < algo.n_gauss <= algo.config.model.max_gaussians:
        raise RuntimeError(f"{name}: gaussian count {algo.n_gauss} outside (0, {algo.config.model.max_gaussians}]")
    missing = [k for k in counters if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"{name}: kernels never launched on the main path: {missing}")
    return pipeline, res


def protocol_config(bounds):
    """Co-SLAM as ``bench_accuracy.py::build_coslam`` configures it: the
    registry's entry with the tri-plane, the scene's bounds for mapping and
    meshing, a keyframe table sized to the run, 30,000 rays per render
    chunk and a mesher at resolution 256."""
    from xrdslam_tpu_torch.common.mesher import MesherConfig
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.models.joint_encoding import JointEncodingConfig

    cfg = copy.deepcopy(algorithm_configs["co-slam"])
    a = cfg.xrdslam.algorithm
    a.seed = 0
    a.mapping_bound = a.marching_cubes_bound = bounds
    a.max_keyframes = PROTOCOL_FRAMES // 5 + 2
    a.ray_batch_size = 30000
    a.mesher = MesherConfig(resolution=256)
    a.model = JointEncodingConfig(encoding="triplane")
    return cfg


def reference_row():
    """The JAX package's co-slam row of ``BENCH_ACCURACY.json`` and
    ``bench_accuracy.py``'s gates for it, both read as data."""
    import ast

    with open(os.path.join(ROOT, "BENCH_ACCURACY.json")) as f:
        row = next(r for r in json.load(f)["algorithms"] if r["algorithm"] == "co-slam")
    with open(os.path.join(ROOT, "bench_accuracy.py")) as f:
        tree = ast.parse(f.read())
    gates = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign) and any(getattr(t, "id", "") == "GATES" for t in n.targets))
    return row, gates["co-slam"]


def protocol_row(pipeline, ate_cm: float) -> dict:
    """``bench_accuracy.run_algo``'s co-slam row of a finished run: PSNR,
    SSIM and depth-L1 of ``render_img`` at the estimated pose every
    ``PROTOCOL_RENDER_FREQ`` frames; accuracy, completion and completion
    ratio of the culled mesh against the culled exact mesh. Prints the
    ``[protocol]`` line and raises if a value is not finite."""
    from xrdslam_tpu_torch.common import metrics as M
    from xrdslam_tpu_torch.ops import marching_tets
    from xrdslam_tpu_torch.utils.eval_recon import calc_3d_metric
    from xrdslam_tpu_torch.utils.mesh_ops import cull_mesh

    algo, ds = pipeline.algorithm, pipeline.dataset
    est = algo.estimate_c2w_list
    t0 = time.perf_counter()
    sums = {"psnr": 0.0, "ssim": 0.0, "depth_l1": 0.0}
    frames = list(range(0, len(ds), PROTOCOL_RENDER_FREQ))
    for i in frames:
        _, gt_rgb, gt_depth, _ = ds[i]
        color, depth = algo.render_img(np.asarray(est[i]), gt_depth=gt_depth, idx=i)
        mask = gt_depth > 0
        sums["psnr"] += M.psnr(color, gt_rgb, mask)
        sums["ssim"] += M.ssim(color, gt_rgb)
        sums["depth_l1"] += M.depth_l1(depth, gt_depth, mask) * 100.0
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = algo.get_mesh()
    if mesh is None:
        raise RuntimeError("co-slam@protocol: get_mesh found no surface")
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = cull_mesh(ds, mesh, estimate_c2w_list=est, eval_rec=True)
    gt = cull_mesh(ds, ds.gt_mesh(voxel=0.02))
    m3 = calc_3d_metric(rec, gt)
    t_metric = time.perf_counter() - t0
    print(f"[protocol] render sweep ({len(frames)} frames) {t_render:.3f} s; get_mesh {t_mesh:.3f} s "
          f"(marching tetrahedra: {marching_tets.backend()} path; {len(mesh.vertices)} vertices, "
          f"{len(mesh.faces)} faces); culls and 3D metrics {t_metric:.3f} s")
    row = {"ate_cm": ate_cm, "psnr": sums["psnr"] / len(frames), "ssim": sums["ssim"] / len(frames),
           "depth_l1_cm": sums["depth_l1"] / len(frames), "accuracy_cm": m3["accuracy_cm"],
           "completion_cm": m3["completion_cm"], "completion_ratio_pct": m3["completion_ratio_pct"],
           "precision_pct": m3["precision_pct"], "recall_pct": m3["recall_pct"], "f1_pct": m3["f1_pct"]}
    jax_row, gates = reference_row()
    verdicts = {k: bool(row[k] <= thr) if op == "<=" else bool(row[k] >= thr) for k, (op, thr) in gates.items()}
    print("[protocol] " + json.dumps({"port": row, "jax": {k: jax_row.get(k) for k in row},
                                      "gates": {k: list(v) for k, v in gates.items()}, "port_passes": verdicts,
                                      "frames": len(ds), "render_freq": PROTOCOL_RENDER_FREQ}))
    bad = [k for k, v in row.items() if not np.isfinite(v)]
    if bad:
        raise RuntimeError(f"co-slam@protocol: non-finite {bad}")
    return row


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
        top = sorted(evs, key=lambda e: -e.self_device_time_total)
        # the 12 largest rows, and every copy between host and device
        for e in top[:12] + [e for e in top[12:] if e.key.startswith("Memcpy HtoD")]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def last_frame(pipeline):
    """A Frame of the run's last image at its estimated pose."""
    from xrdslam_tpu_torch.common.frame import Frame

    algo = pipeline.algorithm
    _, rgb, depth, _ = pipeline.dataset[len(pipeline.dataset) - 1]
    return Frame(fid=-1, rgb=rgb, depth=depth, init_pose=algo.estimate_c2w_list[-1], rot_rep=algo.config.rot_rep)


def profile_coslam(pipeline, name: str = "co-slam") -> None:
    """One tracking and one (non-first) mapping call on the last frame; it
    updates the finished run's map."""
    algo = pipeline.algorithm
    fr = last_frame(pipeline)
    args = (fr.rgb_dev(algo.device), fr.depth_dev(algo.device), algo._pose(fr.t), algo._pose(fr.r))
    profile(name, {"track": lambda: algo.track_step(*args),
                        "map": lambda: algo.map_step(*args, algo.config.mapping_n_iters, False, algo._cur_cap())})


def profile_splatam(pipeline, name: str = "splaTAM") -> None:
    """One tracking call (binning + 40 iterations) and one mapping call
    (growth, window binning, 60 iterations) on the last frame, as the
    pipeline makes them; the mapping calls update the finished run's map."""
    algo = pipeline.algorithm
    fr = last_frame(pipeline)
    profile(name, {"track": lambda: algo.finish_tracking(algo.dispatch_tracking(fr)),
                   "map": lambda: algo.do_mapping(fr)})


def profile_pointslam(pipeline) -> None:
    """One tracking call (40 iterations) and one mapping call (insertion,
    the map's upload, ``POINTSLAM_PROFILE_MAP_ITERS`` iterations) on the
    last frame, as the pipeline makes them; the mapping calls update the
    finished run's map."""
    algo = pipeline.algorithm
    fr = last_frame(pipeline)
    algo.config.mapping_n_iters = POINTSLAM_PROFILE_MAP_ITERS
    profile("point-slam", {"track": lambda: algo.finish_tracking(algo.dispatch_tracking(fr)),
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


# ``--raster-variants``: kernels/gaussian_raster.cu rebuilt with one change
# each, (text, replacement) pairs, to time what each part of the design
# costs or saves. The first three change the function (the "[variant]"
# line prints their error against the twin) and measure a cost only.
RASTER_VARIANTS = {
    "no_row_sums": [("const float s = warp_reduce_scatter(v, lane);", "const float s = v[lane >> 1];")],
    "fast_log1p": [("log1pf(-alpha)", "__logf(1.0f - alpha)")],
    "fast_exp": [("expf(", "__expf(")],
    "ieee_division": [("__fdividef(suffix, fmaxf(1.0f - alpha, 1e-6f))", "suffix / fmaxf(1.0f - alpha, 1e-6f)")],
    "whole_tile_forward": [
        ("constexpr int kFwdPix = kTile * kTile / 2;", "constexpr int kFwdPix = kTile * kTile;"),
        ("const int tile = blockIdx.x / 2, row0 = (blockIdx.x % 2) * (kTile / 2), t = threadIdx.x;",
         "const int tile = blockIdx.x, row0 = 0, t = threadIdx.x;"),
        ("raster_fwd_kernel<kFwdPixPerThread><<<2 * n_tiles,", "raster_fwd_kernel<kFwdPixPerThread><<<n_tiles,")],
    "fwd_2_px_per_thread": [("constexpr int kFwdPixPerThread = 1;", "constexpr int kFwdPixPerThread = 2;")],
    "fwd_4_px_per_thread": [("constexpr int kFwdPixPerThread = 1;", "constexpr int kFwdPixPerThread = 4;")],
    "bwd_1_px_per_thread": [("constexpr int kBwdPixPerThread = 4;", "constexpr int kBwdPixPerThread = 1;")],
    "bwd_2_px_per_thread": [("constexpr int kBwdPixPerThread = 4;", "constexpr int kBwdPixPerThread = 2;")],
}


def raster_variants(device) -> None:
    """K5 and K6 as shipped and as each of ``RASTER_VARIANTS`` on the
    gaussians grown from office frame 0 (K = 256 and 512): milliseconds by
    CUDA events and by device time, and the largest error against the twin
    (K6's relative to its largest entry). Nothing is gated."""
    import ctypes

    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import gaussian_raster as gr

    src = (kernels.SOURCE_DIR / "gaussian_raster.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in RASTER_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"raster variant {name}: {old!r} is not in gaussian_raster.cu")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on raster variant {name}:\n{err}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xr_raster_fwd.argtypes = [p, p, i, i, i, p]
        lib.xr_raster_bwd.argtypes = [p, p, p, p, i, i, i, p]
        lib.xr_cuda_error_string.argtypes, lib.xr_cuda_error_string.restype = [i], ctypes.c_char_p
        libs[name] = lib
    for k_per_tile in (256, SPLATAM_GATE["algorithm.model.k_per_tile"]):
        tiled, gout, tiles, _, _, _ = raster_inputs(device, k_per_tile)
        ntx, nty = gout.shape[1] // 16, gout.shape[0] // 16
        n_tiles, k = tiles.shape
        img_t = gr.raster_fwd_torch(tiled, ntx, nty)
        dg_t = gr.raster_bwd_torch(tiled, gout, img_t, ntx, nty)
        img, dg = torch.empty_like(img_t), torch.empty_like(tiled)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in {"shipped": gr._lib(), **libs}.items():
            def fwd():
                kernels.check(lib, lib.xr_raster_fwd(tiled.data_ptr(), img.data_ptr(), n_tiles, k, ntx, stream), name)

            def bwd():
                kernels.check(lib, lib.xr_raster_bwd(tiled.data_ptr(), gout.data_ptr(), img_t.data_ptr(),
                                                     dg.data_ptr(), n_tiles, k, ntx, stream), name)

            fwd()
            bwd()
            torch.cuda.synchronize()
            err_f = float((img - img_t).abs().max())
            err_b = float((dg - dg_t).abs().max() / dg_t.abs().max())
            ms_f, ms_b = min(cuda_ms(fwd), cuda_ms(fwd)), min(cuda_ms(bwd), cuda_ms(bwd))
            print(f"[variant] K = {k} {name}: raster_fwd {ms_f:.4f} ms, device {device_ms(fwd):.4f} ms, "
                  f"max abs err {err_f:.1e}; raster_bwd {ms_b:.4f} ms, device {device_ms(bwd):.4f} ms, "
                  f"max err / max |twin| {err_b:.1e}", flush=True)
        del tiled, gout, img_t, dg_t, img, dg
        torch.cuda.empty_cache()


def pointslam_repeat(n_runs: int) -> None:
    """Point-SLAM's gated main path (registry settings, 12 office frames)
    ``n_runs`` times in one process, each run's ATE beside its gate and
    nothing gated: the spread that fp32 atomics leave between runs of the
    same code and seed."""
    import torch

    data = f"n_frames={POINTSLAM_FRAMES},height={HEIGHT},width={WIDTH},scene=office"
    for i in range(n_runs):
        pipeline, res = run_slam("point-slam", data, ("row_gather", "scatter_add"), tag=f"#{i}")
        print(f"[repeat] point-slam run {i}: ATE {res['ate_rmse_cm']:.4f} cm, gate "
              f"{min(ATE_LIMIT_CM, FROZEN_ATE_SHARE * res['frozen_ate_cm']):.4f} cm", flush=True)
        del pipeline
        torch.cuda.empty_cache()


T0 = time.perf_counter()


def stamp(what: str) -> None:
    print(f"[elapsed] {what}: {time.perf_counter() - T0:.1f} s", flush=True)


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

    sources = ("hashgrid", "gaussian_raster", "scatter", "row_gather")
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
    if argv == ["--raster-variants"]:
        raster_variants(device)
        return
    if len(argv) == 2 and argv[0] == "--pointslam-repeat":
        pointslam_repeat(int(argv[1]))
        return
    if argv:
        raise SystemExit(f"chip_smoke.py: unknown arguments {argv}")

    # the office spec, as the Co-SLAM run's model builds it
    model_cfg = algorithm_configs["co-slam"].xrdslam.algorithm.model
    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office")
    spec = JointEncoding(model_cfg, ds.get_camera(), ds.bounds).spec
    print(f"[spec] levels {spec.n_levels}, T=2^{spec.log2_table_size}, res {spec.resolutions}, "
          f"dense {sum(spec.dense)}")
    records = check_hashgrid(spec, device)
    records += check_hashgrid_planes(spec, device)
    records += check_scatter_coslam(spec, device)
    stamp("hash-grid kernels checked")
    records += check_raster(device)
    stamp("rasterizer kernels checked")
    records += check_point_table(device)
    stamp("point-table kernels checked")
    torch.cuda.empty_cache()

    office = f"height={HEIGHT},width={WIDTH},scene=office"
    # the reference benchmark's Co-SLAM settings: the registry's entry with
    # the scene's bounds and a keyframe table sized to the run
    bounds = SyntheticDataset(office).bounds.tolist()
    coslam_data = f"n_frames={COSLAM_FRAMES},{office}"
    bench = {"algorithm.mapping_bound": bounds, "algorithm.max_keyframes": max(COSLAM_FRAMES // 5 + 2, 8)}
    # the exact hash grid (K1-K3), an option of the registry's entry
    pipeline, res = run_slam("co-slam", coslam_data, ("hashgrid_fwd", "hashgrid_bwd_dx", "hashgrid_bwd_dtable"),
                             {**bench, "algorithm.model.hash_packed": False}, ATE_LIMIT_CM, tag="@exact")
    launches = dict(res["launches"])
    profile_coslam(pipeline, "co-slam@exact")
    stamp("co-slam@exact run and profile")
    del pipeline
    torch.cuda.empty_cache()
    # Co-SLAM's main path: the registry's default, the packed hash (K4 as
    # its tables' gradient), and the accuracy protocol's tri-plane
    coslam_runs = (
        ("@packed", coslam_data, None, bench),
        ("@protocol", f"n_frames={PROTOCOL_FRAMES},{office}", protocol_config(bounds), None),
    )
    for tag, data, config, overrides in coslam_runs:
        pipeline, res = run_slam("co-slam", data, ("scatter_add",), overrides, ATE_LIMIT_CM, tag=tag, config=config)
        model = pipeline.algorithm.model
        encoding = "triplane" if model.tp_spec is not None else "packed"
        want = coslam_scatter_schedule(config or algorithm_configs["co-slam"], res["frames"], model.spec, encoding)
        print(f"[launches] co-slam{tag}: {json.dumps(res['launches'])}; schedule scatter_add {want}")
        if res["launches"]["scatter_add"] != want:
            raise RuntimeError(f"co-slam{tag}: scatter_add launches {res['launches']['scatter_add']} != {want}")
        launches[f"scatter_add[{'packed hash' if encoding == 'packed' else 'triplane'}]"] = res["launches"]["scatter_add"]
        if tag == "@protocol":  # before the profile's calls change the map
            protocol_row(pipeline, res["ate_rmse_cm"])
            stamp("co-slam protocol row")
        profile_coslam(pipeline, f"co-slam{tag}")
        stamp(f"co-slam{tag} run and profile")
        del pipeline, model
        torch.cuda.empty_cache()
    splatam_data = f"n_frames={SPLATAM_FRAMES},{office}"
    # SplaTAM's accuracy at full width (see SPLATAM_GATE)
    raster = ("raster_fwd", "raster_bwd", "scatter_add")
    pipeline, res = run_slam("splaTAM", splatam_data, raster, overrides=SPLATAM_GATE, ate_limit_cm=ATE_LIMIT_CM,
                             tag="@k512")
    launches.update({f"{name}[k512]": n for name, n in res["launches"].items()})
    profile_splatam(pipeline, "splaTAM@k512")
    stamp("splaTAM@k512 run and profile")
    del pipeline
    torch.cuda.empty_cache()
    # the main path: full width, registry settings (ATE reported, not gated)
    pipeline, res = run_slam("splaTAM", splatam_data, raster)
    launches.update(res["launches"])
    profile_splatam(pipeline)
    stamp("splaTAM run and profile")
    del pipeline
    torch.cuda.empty_cache()
    # Point-SLAM's main path: full width, registry settings
    pipeline, res = run_slam("point-slam", f"n_frames={POINTSLAM_FRAMES},{office}", ("row_gather", "scatter_add"),
                             ate_limit_cm=ATE_LIMIT_CM)
    want = pointslam_schedule(algorithm_configs["point-slam"], POINTSLAM_FRAMES)
    print(f"[launches] point-slam: {json.dumps(res['launches'])}; schedule {json.dumps(want)}")
    if res["launches"] != want:
        raise RuntimeError(f"point-slam: launches {res['launches']} differ from the schedule {want}")
    launches["row_gather"] = res["launches"]["row_gather"]
    launches["scatter_add[point-slam]"] = res["launches"]["scatter_add"]
    stamp("point-slam run")
    profile_pointslam(pipeline)
    stamp("point-slam profile")
    for r in records:
        counter = r.pop("counter")
        r["launches"] = 0 if counter is None else launches[counter]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
