"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

1. Prints the card (torch and nvidia-smi).
2. Builds the hash-grid kernels from ``xrdslam_tpu_torch/kernels/hashgrid.cu``.
3. Holds each kernel against its plain PyTorch twin at the mapping shapes of
   the office scene (N = 176,128 points, some outside [0,1]^3) and times
   both with CUDA events (median of 20 runs).
4. Runs Co-SLAM (exact hash grid) through the port's runner on the
   synthetic office at 600x340 with the benchmark settings, and checks that
   every pose is finite, ATE <= 10 cm, and every kernel was launched.
5. Profiles one tracking and one mapping call with torch.profiler: wall
   time, device busy time and the kernels that take it.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises (non-zero exit,
no result).
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

N_FRAMES = 60
N_MAP = 176_128  # (2048 keyframe + 2048 current rays) x 43 samples
N_TRACK = 44_032  # 1024 rays x 43 samples
HEIGHT, WIDTH = 340, 600
ATE_LIMIT_CM = 10.0
FWD_ATOL = 1e-5
BWD_RTOL = 1e-4  # of max |twin|: fp32 atomics sum in another order


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


def steady_stats(frame_times):
    """Steady per-frame seconds as the reference benchmark computes them:
    drop the first 15 frames, then frames slower than 4x the median."""
    t = np.asarray(frame_times[15:])
    med = np.median(t)
    keep = t[t < 4 * med]
    return float(np.mean(keep)), int(len(t) - len(keep))


def check_kernels(spec, device):
    """Kernel vs twin at the mapping shapes; returns the per-kernel records."""
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
    err = {
        "fwd": float((out_k - out_t).abs().max()),
        "dx": float((dx_k - dx_t).abs().max()),
        "dtable": float((dt_k - dt_t).abs().max()),
    }
    scale = {"fwd": float(out_t.abs().max()), "dx": float(dx_t.abs().max()), "dtable": float(dt_t.abs().max())}
    limit = {"fwd": FWD_ATOL, "dx": BWD_RTOL * scale["dx"], "dtable": BWD_RTOL * scale["dtable"]}
    for k in err:
        if not np.isfinite(err[k]) or err[k] > limit[k]:
            raise RuntimeError(f"kernel {k} disagrees with its twin: max abs err {err[k]:.3e} > {limit[k]:.3e}")
        print(f"[check] {k}: max abs err {err[k]:.3e} (limit {limit[k]:.3e}, max |twin| {scale[k]:.3e})")

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
        # twin, kernel, kernel, twin: both see the same card state
        t1, k1, k2, t2 = cuda_ms(twin), cuda_ms(kern), cuda_ms(kern), cuda_ms(twin)
        ms[k] = (min(k1, k2), min(t1, t2))
        n = N_TRACK if k.endswith("@track") else N_MAP
        print(f"[time] {k:10s} N={n}: kernel {ms[k][0]:.4f} ms, twin {ms[k][1]:.4f} ms")
    src = "xrdslam_tpu_torch/kernels/hashgrid.cu"
    ref = "xrdslam_tpu/ops/hashgrid_fast.py"
    return [
        {"name": "hashgrid_fwd", "route": "cuda", "source": src, "replaces": f"{ref}:202",
         "counter": "hashgrid_fwd", "max_abs_err": err["fwd"], "ms": ms["fwd"][0], "plain_ms": ms["fwd"][1]},
        {"name": "hashgrid_bwd[dx]", "route": "cuda", "source": src, "replaces": f"{ref}:216",
         "counter": "hashgrid_bwd_dx", "max_abs_err": err["dx"], "ms": ms["dx"][0], "plain_ms": ms["dx"][1]},
        {"name": "hashgrid_bwd[dtable]", "route": "cuda", "source": src, "replaces": f"{ref}:95",
         "counter": "hashgrid_bwd_dtable", "max_abs_err": err["dtable"], "ms": ms["dtable"][0],
         "plain_ms": ms["dtable"][1]},
    ]


def run_slam(n_frames: int):
    """Co-SLAM through the port's runner; returns (pipeline, results)."""
    import torch

    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf
    from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate

    data = f"n_frames={n_frames},height={HEIGHT},width={WIDTH},scene=office"
    cfg = copy.deepcopy(algorithm_configs["co-slam"])
    cfg.data, cfg.data_type = data, "synthetic"
    cfg.out_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    cfg.xrdslam.device = "cuda"
    # the reference benchmark's settings: the registry's co-slam entry with
    # the scene's bounds and a keyframe table sized to the run
    cfg.xrdslam.algorithm.mapping_bound = SyntheticDataset(data).bounds.tolist()
    cfg.xrdslam.algorithm.max_keyframes = max(n_frames // 5 + 2, 8)
    runner = cfg.setup()
    pipeline = runner.setup()
    t0 = time.time()
    pipeline.dataset.prerender()
    torch.cuda.synchronize()
    print(f"[slam] rendered {n_frames} frames in {time.time() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launches()
    t0 = time.time()
    pipeline.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(hf.LAUNCHES)
    algo = pipeline.algorithm
    est = algo.estimate_c2w_list
    if len(est) != n_frames or algo._nonfinite_poses or not all(np.isfinite(p).all() for p in est):
        raise RuntimeError(f"non-finite or missing poses ({algo._nonfinite_poses} non-finite of {len(est)})")
    ate_cm = evaluate_ate(list(np.asarray(pipeline.dataset.poses)), est)["rmse"] * 100.0
    spf, spikes = steady_stats(pipeline.frame_times)
    res = {"frames": n_frames, "steady_s_per_frame": spf, "spikes_dropped": spikes, "wall_s": wall,
           "ate_rmse_cm": ate_cm, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "keyframes": algo.kf_count}
    with open(os.path.join(cfg.out_dir, "timings.json")) as f:
        res["phases"] = json.load(f)
    print(f"[slam] {json.dumps(res)}")
    if ate_cm > ATE_LIMIT_CM:
        raise RuntimeError(f"ATE {ate_cm:.3f} cm > {ATE_LIMIT_CM} cm")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    return pipeline, res


def profile(pipeline) -> None:
    """torch.profiler over one tracking and one (non-first) mapping call on
    the last frame; it updates the finished run's map."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    algo = pipeline.algorithm
    _, rgb, depth, _ = pipeline.dataset[len(pipeline.dataset) - 1]
    from xrdslam_tpu_torch.common.frame import Frame

    fr = Frame(fid=-1, rgb=rgb, depth=depth, init_pose=algo.estimate_c2w_list[-1])
    args = (fr.rgb_dev(algo.device), fr.depth_dev(algo.device), algo._pose(fr.t), algo._pose(fr.r))
    phases = {"track": lambda: algo.track_step(*args),
              "map": lambda: algo.map_step(*args, algo.config.mapping_n_iters, False, algo._cur_cap())}
    for name, fn in phases.items():
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
        print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
              f"({100 * dev_ms / max(wall_ms, 1e-9):.1f}%), kernels {sum(e.count for e in evs)}")
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.models.joint_encoding import JointEncoding
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.pipeline.slam import resolve_device

    device = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    kernels.load("hashgrid")
    info = kernels.BUILD_INFO["hashgrid"]
    print(f"[build] hashgrid.cu: {time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s)")
    print("\n".join("[ptxas] " + ln for ln in str(info["ptxas"]).splitlines() if ln.strip()))

    # the office spec, as the SLAM run's model builds it
    model_cfg = algorithm_configs["co-slam"].xrdslam.algorithm.model
    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office")
    spec = JointEncoding(model_cfg, ds.get_camera(), ds.bounds).spec
    print(f"[spec] levels {spec.n_levels}, T=2^{spec.log2_table_size}, res {spec.resolutions}, "
          f"dense {sum(spec.dense)}")
    records = check_kernels(spec, device)

    pipeline, res = run_slam(N_FRAMES)
    for r in records:
        r["launches"] = res["launches"][r.pop("counter")]
    profile(pipeline)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
