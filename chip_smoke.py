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
   K5/K6 also by device time. The row
   gather K7 at Point-SLAM's mapping shape: the union rows of the point map
   grown from office frame 0 at 600x340 (registry settings), gathered for
   the 24,960 surface samples of 4,992 rays (bit for bit against the twin,
   at width 1024 for K7a and 128 for K7b, timed against
   ``torch.index_select``); and K4 at ``table_lookup``'s shape, the
   199,680 neighbour rows of those samples into the 262,144 x 32 table.
   K4 at each of its six shapes (SplaTAM's, ``table_lookup``'s, the
   packed hash's and the tri-plane's on uniform random points, and the
   main-path launches of the packed hash over its 16 levels and of the
   tri-plane over its 6 planes on office surface samples) must give the
   same bits in two launches, and is timed with and
   without its ordering beside ``Tensor.index_add_`` and torch's
   deterministic ``index_put_(accumulate=True)``; the hash-grid dx must
   give the same bits in every launch. Every kernel is also timed by
   device time, and a ``[launch]`` line gives what a launch costs the host
   beyond it (CUDA events minus device time).
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

    python3 chip_smoke.py --scatter-variants

checks and times K4 at its six shapes (as the default run does) beside
K4's former atomic design, rebuilt from ``ATOMIC_SCATTER_CU`` with scalar and
with float4 atomics, and the main paths' single K4 launch against one per
level or plane (``[lever]`` lines); then rebuilds the hash-grid backward
with one change at a time (``HASHGRID_VARIANTS``) and times dx, dtable and
both (``[variant]`` lines, no result line).

    python3 chip_smoke.py --determinism-probe

runs each main path for a few frames under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints
every operation torch names as non-deterministic (``[determinism]`` lines,
no result line).

    python3 chip_smoke.py --pointslam-repeat N --protocol-repeat M

runs Point-SLAM's gated main path N times, then Co-SLAM at the accuracy
protocol (tri-plane, 200 frames, seed 0) and its row M times (either flag
alone also works), and prints each run's ATE beside its gate, a digest of
its poses' bits and the rows (nothing gated, no result line), and whether
the runs of each kind were identical.
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


def same_bits(name: str, outs) -> None:
    """Raise unless every tensor of ``outs`` (launches on the same inputs)
    has the same bits as the first."""
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise RuntimeError(f"kernel {name} gave different bits on the same inputs")
    print(f"[check] {name}: the same bits in {len(outs)} launches")


def scatter_case(name: str, idx, g, rows: int, device, order=None):
    """K4 at one shape (ids ``idx`` [N], g [N, C] into ``rows``): checked
    against its twin and for the same bits in two launches, from the ids and
    on ``order`` (a caller's ordering built once, which may leave out zero
    entries: where a row is longer than a piece that regroups its sum, so
    each is held to the twin on its own); then timed from the ids (its
    ordering included) and on ``order``, the sums alone; beside
    ``index_add_`` and torch's deterministic ``index_put_(accumulate=True)``,
    by CUDA events and by device time. Returns the record's numbers."""
    import torch

    from xrdslam_tpu_torch.ops import scatter as sc

    order = order or sc.scatter_order(idx, rows)
    outs = [sc.scatter_add(idx, g, rows) for _ in range(2)]
    same_bits(name, outs)
    on_order = [sc.scatter_add_ordered(order, g) for _ in range(2)]
    same_bits(f"{name} on a built ordering", on_order)
    acc_t = sc.scatter_add_torch(idx, g, rows)
    scale = float(acc_t.abs().max())
    err = float((outs[0] - acc_t).abs().max())
    check(name, err, BWD_RTOL * scale, scale)
    check(f"{name} on a built ordering", float((on_order[0] - acc_t).abs().max()), BWD_RTOL * scale, scale)
    del outs, on_order, acc_t
    ok = (idx >= 0) & (idx < rows)
    idx_long, g_ok = idx[ok].long(), g[ok].contiguous()
    lib_out = torch.empty((rows, g.shape[1]), device=device)

    def index_add():
        lib_out.zero_()
        lib_out.index_add_(0, idx_long, g_ok)

    def index_put():
        torch.use_deterministic_algorithms(True)
        try:
            lib_out.zero_()
            lib_out.index_put_((idx_long,), g_ok, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(False)

    kern = lambda: sc.scatter_add(idx, g, rows)  # noqa: E731
    sums = lambda: sc.scatter_add_ordered(order, g)  # noqa: E731
    k_ms, t_ms = interleaved(kern, lambda: sc.scatter_add_torch(idx, g, rows))
    sort = lambda: torch.sort(idx, stable=True)  # noqa: E731
    ev = {"sums": min(cuda_ms(sums), cuda_ms(sums)), "order": min(cuda_ms(lambda: sc.scatter_order(idx, rows))
                                                                  for _ in range(2)),
          "sort": min(cuda_ms(sort), cuda_ms(sort)),
          "index_add_": min(cuda_ms(index_add), cuda_ms(index_add)),
          "index_put_": min(cuda_ms(index_put), cuda_ms(index_put))}
    dev = {"kernel": device_ms(kern), "sums": device_ms(sums), "sort": device_ms(sort),
           "index_add_": device_ms(index_add), "index_put_": device_ms(index_put)}
    for vname, lib in SCATTER_VARIANTS.items():
        atomic_variant(vname, lib, idx, g, rows, device)
    b_ms, by = bound(nbytes(idx, g) + rows * g.shape[1] * 4, int((g_ok != 0).sum()))
    print(f"[time] {name}: N={idx.shape[0]} x {g.shape[1]} into {rows} rows; kernel {k_ms:.4f} ms "
          f"(device {dev['kernel']:.4f}), the sums alone on a built ordering {ev['sums']:.4f} (device "
          f"{dev['sums']:.4f}), the ordering {ev['order']:.4f} (its torch.sort {ev['sort']:.4f}, device "
          f"{dev['sort']:.4f}); twin {t_ms:.4f}; index_add_ {ev['index_add_']:.4f} "
          f"(device {dev['index_add_']:.4f}); deterministic index_put_ {ev['index_put_']:.4f} (device "
          f"{dev['index_put_']:.4f}); bound {b_ms:.4f} ms ({by})", flush=True)
    if dev["kernel"] > dev["index_put_"]:
        print(f"[note] {name}: K4's device time {dev['kernel']:.4f} ms is above deterministic index_put_'s "
              f"{dev['index_put_']:.4f}")
    return {"max_abs_err": err, "ms": k_ms, "device_ms": dev["kernel"], "sums_ms": ev["sums"],
            "sums_device_ms": dev["sums"], "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": ev["index_add_"], "index_put_det_ms": ev["index_put_"],
            "index_put_det_device_ms": dev["index_put_"]}


# ``--scatter-variants``: K4's former design, one fp32 atomicAdd per (entry, channel)
# into a table the wrapper zeroes (zero entries skipped), and the same design
# with one float4 atomicAdd per (entry, 4 channels) (sm_90, global memory).
# Built from this source beside the shipped kernel and timed at K4's shapes
# (the price of determinism); not part of the package.
ATOMIC_SCATTER_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256)
scatter_add_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g, float* __restrict__ out, int64_t n,
                   int c_dim, int64_t num_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * c_dim) return;
  const int64_t e = t / c_dim;
  const float val = __ldg(g + t);
  if (val == 0.0f) return;
  const int64_t row = (int64_t)__ldg(idx + e);
  if (row < 0 || row >= num_rows) return;
  atomicAdd(out + row * c_dim + (t - e * c_dim), val);
}
__global__ void __launch_bounds__(256)
scatter_add4_kernel(const int32_t* __restrict__ idx, const float4* __restrict__ g, float4* __restrict__ out,
                    int64_t n, int c4, int64_t num_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * c4) return;
  const int64_t e = t / c4;
  const float4 val = __ldg(g + t);
  if (val.x == 0.0f && val.y == 0.0f && val.z == 0.0f && val.w == 0.0f) return;
  const int64_t row = (int64_t)__ldg(idx + e);
  if (row < 0 || row >= num_rows) return;
  atomicAdd(out + row * c4 + (t - e * c4), val);
}
extern "C" int xr_scatter_add_atomic(const int32_t* idx, const float* g, float* out, long long n, int c_dim,
                                     long long num_rows, int vec4, void* stream) {
  const int64_t threads = (int64_t)n * (vec4 ? c_dim / 4 : c_dim);
  if (threads == 0) return 0;
  const unsigned int blocks = (unsigned int)((threads + 255) / 256);
  if (vec4)
    scatter_add4_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(idx, (const float4*)g, (float4*)out, n, c_dim / 4,
                                                                  num_rows);
  else
    scatter_add_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(idx, g, out, n, c_dim, num_rows);
  return (int)cudaGetLastError();
}
extern "C" const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
"""
SCATTER_VARIANTS = {}  # name -> the atomic library, set by --scatter-variants


def atomic_variant(name: str, lib, idx, g, rows: int, device) -> None:
    """K4's former atomic design (scalar, or ``float4`` atomics where ``name`` ends
    in 4) at one shape, its zero fill included: error against the twin, ms
    by CUDA events and device time, and whether two launches agree."""
    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import scatter as sc

    vec4 = int(name.endswith("4"))

    def run():
        out = torch.zeros((rows, g.shape[1]), device=device)
        kernels.check(lib, lib.xr_scatter_add_atomic(idx.data_ptr(), g.data_ptr(), out.data_ptr(), idx.shape[0],
                                                     g.shape[1], rows, vec4, kernels.stream(g)), name)
        return out

    a, b = run(), run()
    torch.cuda.synchronize()
    want = sc.scatter_add_torch(idx, g, rows)
    err = float((a - want).abs().max() / want.abs().max())
    print(f"[variant] K4 {name}: {min(cuda_ms(run), cuda_ms(run)):.4f} ms, device {device_ms(run):.4f} ms, "
          f"max err / max |twin| {err:.1e}, two launches {'the same' if torch.equal(a, b) else 'differ'}", flush=True)


def build_variants(source: str, variants, out_dir) -> dict:
    """``kernels/<source>.cu`` with each variant's (text, replacement) edits,
    or a variant's whole text where it is a string, compiled in parallel
    (one nvcc each) into ``out_dir``; name -> the loaded library."""
    import ctypes

    from xrdslam_tpu_torch import kernels

    src = (kernels.SOURCE_DIR / f"{source}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        if isinstance(edits, str):
            text = edits
        else:
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {old!r} is not in {source}.cu")
                text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.xr_cuda_error_string.argtypes, lib.xr_cuda_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return libs


# ``--scatter-variants`` also rebuilds kernels/hashgrid.cu with one change at
# a time: float2 atomics only (no float4 for an aligned pair of entries),
# scalar atomics (the former dtable: 16 per (point, level)), and dx summed with
# three fp32 atomics per (point, level) into a zeroed dx (the former dx) in
# place of the warp shuffles.
HASHGRID_VARIANTS = {
    "float2_only": [("if (!kPlanes && (e[0] ^ e[1]) == 1u) {", "if (false) {")],
    "pr4_dtable": [("if (!kPlanes && (e[0] ^ e[1]) == 1u) {", "if (false) {"),
                   ("if (!kPlanes) {\n    atomicAdd(reinterpret_cast<float2*>",
                    "if (false) {\n    atomicAdd(reinterpret_cast<float2*>")],
    "dx_atomics": [("for (int off = (1 << log2_lp) >> 1; off > 0; off >>= 1) {",
                    "for (int off = 0; off > 0; off >>= 1) {"),
                   ("  if (l == 0 && p < n) {\n    dx[3 * p + 0] = ddx;\n    dx[3 * p + 1] = ddy;\n"
                    "    dx[3 * p + 2] = ddz;\n  }",
                    "  if (p < n && l < lv.n_levels) {\n    atomicAdd(dx + 3 * p + 0, ddx);\n"
                    "    atomicAdd(dx + 3 * p + 1, ddy);\n    atomicAdd(dx + 3 * p + 2, ddz);\n  }")],
}


def hashgrid_variants(spec, device) -> None:
    """The hash-grid backward as shipped and as each of ``HASHGRID_VARIANTS``
    at N = 176,128 (the mapping shape, random points as ``check_hashgrid``):
    dx alone, dtable alone and both, by CUDA events and device time, with
    the error against the twin. Nothing is gated."""
    import ctypes

    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    libs = build_variants("hashgrid", HASHGRID_VARIANTS, kernels.BUILD_DIR / "variants")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (N_MAP, 3)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.standard_normal((N_MAP, spec.out_dim)).astype(np.float32), device=device)
    table = torch.as_tensor(rng.standard_normal((spec.n_levels, spec.table_size, 2)).astype(np.float32), device=device)
    dt_t, dx_t = hf.hashgrid_bwd_torch(table, x, g, spec)
    res, dense = hf.level_args(spec)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in {"shipped": kernels.load("hashgrid"), **libs}.items():
        lib.xr_hashgrid_bwd.argtypes = [p, p, p, p, p, ll, i, i, p, p, p]
        for case, (nd, nx) in {"dx": (False, True), "dtable": (True, False), "dx+dtable": (True, True)}.items():
            def run():
                dt = torch.zeros_like(table) if nd else None
                dx = torch.zeros((N_MAP, 3), device=device) if nx else None  # zeroed for the atomic variant
                kernels.check(lib, lib.xr_hashgrid_bwd(
                    table.data_ptr(), x.data_ptr(), g.data_ptr(), dx.data_ptr() if nx else None,
                    dt.data_ptr() if nd else None, N_MAP, spec.n_levels, spec.log2_table_size, res, dense,
                    kernels.stream(x)), name)
                return dt, dx

            dt, dx = run()
            torch.cuda.synchronize()
            errs = []
            if nd:
                errs.append(f"dtable {float((dt - dt_t).abs().max() / dt_t.abs().max()):.1e}")
            if nx:
                errs.append(f"dx {float((dx - dx_t).abs().max() / dx_t.abs().max()):.1e}")
            print(f"[variant] hashgrid_bwd {name} [{case}]: {min(cuda_ms(run), cuda_ms(run)):.4f} ms, device "
                  f"{device_ms(run):.4f} ms (zero fills included); max err / max |twin|: {', '.join(errs)}",
                  flush=True)


def scatter_variants(spec, device) -> None:
    """K4 at its six shapes beside its former atomic design (scalar and float4
    atomics), ``index_add_`` and torch's deterministic ``index_put_``; then
    the hash-grid backward's variants. Prints ``[time]``, ``[lever]`` and
    ``[variant]`` lines; nothing but the kernels' checks is gated."""
    import ctypes

    from xrdslam_tpu_torch import kernels

    lib = build_variants("scatter", {"atomic": ATOMIC_SCATTER_CU}, kernels.BUILD_DIR / "variants")["atomic"]
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.xr_scatter_add_atomic.argtypes = [p, p, p, ll, ctypes.c_int, ll, ctypes.c_int, p]
    SCATTER_VARIANTS.update({"atomic": lib, "atomic_float4": lib})
    check_scatter_coslam(spec, device)
    check_raster_at(device, 256, with_scatter=True)
    check_point_table(device)
    SCATTER_VARIANTS.clear()
    hashgrid_variants(spec, device)


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
    err["dx+dtable"] = max(err["dx"], err["dtable"])
    # dx is summed without atomics: the same bits on every launch
    same_bits("hashgrid_bwd[dx]", [dx_k, hf.hashgrid_bwd(table, x, g, spec, False, True)[1],
                                   hf.hashgrid_bwd(table, x, g, spec, True, True)[1]])

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
    ms, dev = {}, {}
    for k, (kern, twin) in times.items():
        ms[k] = interleaved(kern, twin)
        dev[k] = device_ms(kern)
        n = N_TRACK if k.endswith("@track") else N_MAP
        print(f"[time] {k:10s} N={n}: kernel {ms[k][0]:.4f} ms, device {dev[k]:.4f} ms, twin {ms[k][1]:.4f} ms")
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
        "dx+dtable": bound(nbytes(table, x, g, dx_out, dt_k), pl * (12 + 8 * 16)),
    }
    for k, (b_ms, by) in bounds.items():
        print(f"[bound] {k}: {b_ms:.4f} ms ({by})")
    src = "xrdslam_tpu_torch/kernels/hashgrid.cu"
    ref = "xrdslam_tpu/ops/hashgrid_fast.py"
    rows = (("hashgrid_fwd", "fwd", f"{ref}:202", "hashgrid_fwd"),
            ("hashgrid_bwd[dx]", "dx", f"{ref}:216", "hashgrid_bwd_dx"),
            ("hashgrid_bwd[dtable]", "dtable", f"{ref}:95", "hashgrid_bwd_dtable"),
            # mapping's call: K2 and K3 in one backward
            ("hashgrid_bwd[dx+dtable]", "dx+dtable", f"{ref}:216 and :95", "hashgrid_bwd_dx_dtable"))
    # no single PyTorch call computes a hash-grid encoding or its gradients
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep, "counter": counter,
             "max_abs_err": err[k], "ms": ms[k][0], "device_ms": dev[k], "plain_ms": ms[k][1],
             "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None}
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
    kern = {"fwd": lambda: hp.hashgrid_planes_fwd(planes, x, spec), "bwd": lambda: hp.hashgrid_planes_bwd(planes, x, g, spec)}
    ms = {"fwd": interleaved(kern["fwd"], lambda: hp.hashgrid_planes_fwd_torch(planes, x, spec)),
          "bwd": interleaved(kern["bwd"], lambda: hp.hashgrid_planes_bwd_torch(planes, x, g, spec))}
    dev = {k: device_ms(fn) for k, fn in kern.items()}
    for k, (k_ms, t_ms) in ms.items():
        print(f"[time] planes {k} N={N_MAP}: kernel {k_ms:.4f} ms, device {dev[k]:.4f} ms, twin {t_ms:.4f} ms")
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
             "max_abs_err": e, "ms": ms[k][0], "device_ms": dev[k], "plain_ms": ms[k][1], "bound_ms": bounds[k][0],
             "bound_by": bounds[k][1], "library_ms": None}
            for name, k, rep, e in rows]


def office_surface_points(device, n_rays: int = 4096):
    """Co-SLAM's mapping samples on office frame 0 at 600x340 at its pose,
    normalised to the scene's bounds as the model encodes them: 4,096 random
    pixels x 43 depth-guided samples (32 uniform, 11 within 10 cm of the
    surface), [N_MAP, 3]."""
    import torch

    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops.sampling import camera_ray_dirs, coslam_z_vals

    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, _, depth, pose = ds[0]
    c = algorithm_configs["co-slam"].xrdslam.algorithm.model
    gen = torch.Generator(device=device).manual_seed(0)
    u = torch.randint(0, WIDTH, (n_rays,), generator=gen, device=device)
    v = torch.randint(0, HEIGHT, (n_rays,), generator=gen, device=device)
    c2w = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    rays_d = camera_ray_dirs(ds.get_camera(), device)[v, u] @ c2w[:3, :3].T
    d = torch.as_tensor(depth, device=device)[v, u][:, None]
    z = coslam_z_vals(d, n_rays, c.cam_near, c.cam_far, c.training_n_sample_d, c.training_range_d,
                      c.training_n_range_d, False)
    pts = c2w[:3, 3] + rays_d[:, None, :] * z[..., None]
    b = torch.as_tensor(ds.bounds, dtype=torch.float32, device=device)
    return ((pts - b[:, 0]) / (b[:, 1] - b[:, 0])).reshape(-1, 3).contiguous()


def check_scatter_coslam(spec, device):
    """K4 at the shapes Co-SLAM's encodings give it (mapping: N = 176,128
    points): the packed hash's finest level (rows of 16 into T = 65,536) and
    the tri-plane's finer scale (rows of 4 x 8 moments into 512^2 cells),
    rows from the cells of uniform random points (shapes that the main
    paths no longer launch: no launches in the record); and the main paths'
    launches on office surface samples (``office_surface_points``): the
    packed hash's over its 16 levels stacked and the tri-plane's over its 6
    planes stacked. Times each main-path launch against one launch per
    level or plane; returns the records."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_packed, triplane
    from xrdslam_tpu_torch.ops import scatter as sc

    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (N_MAP, 3)).astype(np.float32), device=device)
    u0, _ = triplane._cells(x, 512)
    surface = office_surface_points(device)
    n = surface.shape[0]
    rid, _ = hashgrid_packed._cells(surface, spec)
    level_rows = [t.shape[0] for t in hashgrid_packed.pack_gather_tables(hashgrid_packed.packed_init(spec), spec)]
    stacked, offsets = hashgrid_packed.stacked_rows(rid, level_rows)
    planes = []  # the tri-plane's 6 planes stacked row-wise, as triplane._splat stacks them
    for R in (128, 512):
        cells, _ = triplane._cells(surface, R)
        planes += [((cells[:, a] * R + cells[:, b]), R) for a, b in triplane.PLANES]
    first = np.cumsum([0] + [R * R for _, R in planes])
    all_ids = torch.cat([r + int(f) for (r, _), f in zip(planes, first)]).to(torch.int32)
    # name -> (ids, width, rows, whose launches the record carries)
    cases = {
        "scatter_add[packed hash]": (hashgrid_packed._cells(x, spec)[0][:, -1].to(torch.int32), 16, spec.table_size,
                                     None),
        "scatter_add[triplane]": ((u0[:, 0] * 512 + u0[:, 1]).to(torch.int32), 32, 512 * 512, None),
        "scatter_add[packed hash, office surface]": (stacked, 16, offsets[-1], "scatter_add[co-slam@packed]"),
        "scatter_add[triplane, office surface]": (all_ids, 32, int(first[-1]), "scatter_add[co-slam@protocol]"),
    }
    records, g_of = [], {}
    for name, (idx, width, rows, counter) in cases.items():
        g = g_of[name] = torch.as_tensor(rng.standard_normal((idx.shape[0], width)).astype(np.float32), device=device)
        rec = scatter_case(name, idx.contiguous(), g, rows, device)
        records.append({"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": counter, **rec})
    # The levers: the main paths' one launch over the packed hash's 16
    # levels and over the tri-plane's 6 planes, against one launch per level
    # or plane, on the surface samples (orderings included)
    g, gm = g_of["scatter_add[packed hash, office surface]"], g_of["scatter_add[triplane, office surface]"]
    levers = {
        f"packed hash, office surface: one launch over {spec.n_levels} levels":
            ((stacked, g, offsets[-1]),
             [(rid[:, l].to(torch.int32).contiguous(), g.reshape(n, -1, 16)[:, l].contiguous(),
               offsets[l + 1] - offsets[l]) for l in range(spec.n_levels)]),
        "tri-plane, office surface: one launch over 6 planes":
            ((all_ids, gm, int(first[-1])),
             [(r.to(torch.int32).contiguous(), gm[k * n:(k + 1) * n], R * R) for k, (r, R) in enumerate(planes)]),
    }
    for what, (one, per) in levers.items():
        t_one = min(cuda_ms(lambda: sc.scatter_add(*one)) for _ in range(2))
        t_per = min(cuda_ms(lambda: [sc.scatter_add(*a) for a in per]) for _ in range(2))
        print(f"[lever] {what} {t_one:.4f} ms, one per level or plane {t_per:.4f} ms (device "
              f"{device_ms(lambda: sc.scatter_add(*one)):.4f} and "
              f"{device_ms(lambda: [sc.scatter_add(*a) for a in per]):.4f})")
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
    for name in err:
        check(name + tag, err[name], limit[name], scale[name])
    if with_scatter:
        # K4's input on the main path: K6's output; the main path sums it on
        # its binning's ordering (masked slots left out), built once
        k4 = scatter_case("scatter_add", tiles.reshape(-1).contiguous(), dg_t.reshape(-1, gr.ROW).contiguous(), G,
                          device, order=gr.Binning(tiles, mask).order(G))
    del out_t, dg_t

    ms = {
        "raster_fwd": interleaved(lambda: gr.raster_fwd(tiled, ntx, nty), lambda: gr.raster_fwd_torch(tiled, ntx, nty)),
        "raster_bwd": interleaved(lambda: gr.raster_bwd(tiled, gout, out_k, ntx, nty),
                                  lambda: gr.raster_bwd_torch(tiled, gout, out_k, ntx, nty)),
    }
    dev_ms = {"raster_fwd": device_ms(lambda: gr.raster_fwd(tiled, ntx, nty)),
              "raster_bwd": device_ms(lambda: gr.raster_bwd(tiled, gout, out_k, ntx, nty))}
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
    # backward a division. Bytes: every input read once and every output
    # written once.
    pairs = 256 * int(mask.sum())
    bounds = {
        "raster_fwd": bound(nbytes(tiled, out_k), 28 * pairs, 3 * pairs),
        "raster_bwd": bound(nbytes(tiled, gout, out_k, dg_k), 60 * pairs, 4 * pairs),
    }
    for name, (b_ms, by) in bounds.items():
        print(f"[bound] {name + tag}: {b_ms:.4f} ms ({by}; {pairs} live (pixel, slot) pairs)")
    src, ref = "xrdslam_tpu_torch/kernels/gaussian_raster.cu", "xrdslam_tpu/ops/gaussian_raster.py"
    records = [{"name": name + tag, "route": "cuda", "source": src, "replaces": f"{ref}:{line}", "counter": name + tag,
                "max_abs_err": err[name], "ms": ms[name][0], "device_ms": dev_ms[name], "plain_ms": ms[name][1],
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
               for name, line in (("raster_fwd", 239), ("raster_bwd", 265))]
    if with_scatter:
        records.append({"name": "scatter_add" + tag, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": "scatter_add" + tag, **k4})
    return records


def check_point_table(device):
    """K7 (both widths) and K4 at Point-SLAM's mapping shapes vs their twins;
    returns the records."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops import row_gather as rg
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
    print(f"[pointmap] table_lookup: {nb.shape[0]} rows of {m.c_dim} into {R}; {int(torch.unique(nb).numel())} "
          f"distinct, the most on one row {int(torch.bincount(nb.long()).max())}")
    k4 = scatter_case("scatter_add[table_lookup]", nb, g, R, device)

    idx_long = idx.long()
    kern = {"row_gather": lambda: rg.row_gather_rows(table, idx),
            "row_gather[C=128]": lambda: rg.row_gather_rows(table128, idx)}
    ms = {"row_gather": interleaved(kern["row_gather"], lambda: rg.row_gather_torch(table, idx)),
          "row_gather[C=128]": interleaved(kern["row_gather[C=128]"], lambda: rg.row_gather_torch(table128, idx))}
    lib_fn = {"row_gather": lambda: torch.index_select(table, 0, idx_long),
              "row_gather[C=128]": lambda: torch.index_select(table128, 0, idx_long)}
    lib = {name: min(cuda_ms(fn) for _ in range(2)) for name, fn in lib_fn.items()}
    dev = {name: (device_ms(kern[name]), device_ms(lib_fn[name])) for name in kern}
    for name, (k_ms, t_ms) in ms.items():
        print(f"[time] {name}: kernel {k_ms:.4f} ms (device {dev[name][0]:.4f}), twin {t_ms:.4f} ms, index_select "
              f"{lib[name]:.4f} ms (device {dev[name][1]:.4f})")
    # Bounds: each distinct row read once, each output row written once, the
    # ids read; no arithmetic.
    distinct = int(torch.unique(idx).numel())
    bounds = {
        "row_gather": bound(distinct * table.shape[1] * 4 + nbytes(got["row_gather"], idx), 0),
        "row_gather[C=128]": bound(distinct * 128 * 4 + nbytes(got["row_gather[C=128]"], idx), 0),
    }
    for name, (b_ms, by) in bounds.items():
        print(f"[bound] {name}: {b_ms:.4f} ms ({by})")
    rows = (("row_gather", "xrdslam_tpu/ops/row_gather.py:47", "row_gather"),
            # no path gathers at width 128: the main path launches K7 at 1024 only
            ("row_gather[C=128]", "xrdslam_tpu/ops/row_gather.py:29", None))
    records = [{"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/row_gather.cu", "replaces": rep,
                "counter": counter, "max_abs_err": err[name], "ms": ms[name][0], "device_ms": dev[name][0],
                "plain_ms": ms[name][1], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": lib[name]}
               for name, rep, counter in rows]
    return records + [{"name": "scatter_add[table_lookup]", "route": "cuda",
                       "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                       "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": "scatter_add[point-slam]", **k4}]


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


def coslam_scatter_schedule(cfg, n_frames: int, encoding: str) -> int:
    """K4 launches of a Co-SLAM run whose frames are mapped every
    ``map_every`` and on the last frame: the packed hash scatters its tables'
    gradient (all levels in one launch) for each encode that a mapping
    backward differentiates (the rays'; after the first mapping also the
    smoothness grid's); the tri-plane its planes' moments (all planes and
    scales in one launch) for the rays' encode (its smoothness is a TV on the
    planes). Tracking's tables are constants: none."""
    a, t = cfg.xrdslam.algorithm, cfg.xrdslam.tracker
    n_later = sum(1 for i in range(1, n_frames) if i % t.map_every == 0 or i == n_frames - 1)
    first, later = a.mapping_first_n_iters, a.mapping_n_iters * n_later
    return first + later if encoding == "triplane" else first + 2 * later


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

    libs = build_variants("gaussian_raster", RASTER_VARIANTS, kernels.BUILD_DIR / "variants")
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in [kernels.load("gaussian_raster"), *libs.values()]:
        lib.xr_raster_fwd.argtypes = [p, p, i, i, i, p]
        lib.xr_raster_bwd.argtypes = [p, p, p, p, i, i, i, p]
        lib.xr_cuda_error_string.argtypes, lib.xr_cuda_error_string.restype = [i], ctypes.c_char_p
    for k_per_tile in (256, SPLATAM_GATE["algorithm.model.k_per_tile"]):
        tiled, gout, tiles, _, _, _ = raster_inputs(device, k_per_tile)
        ntx, nty = gout.shape[1] // 16, gout.shape[0] // 16
        n_tiles, k = tiles.shape
        img_t = gr.raster_fwd_torch(tiled, ntx, nty)
        dg_t = gr.raster_bwd_torch(tiled, gout, img_t, ntx, nty)
        img, dg = torch.empty_like(img_t), torch.empty_like(tiled)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in {"shipped": kernels.load("gaussian_raster"), **libs}.items():
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


def trajectory_digest(pipeline) -> str:
    """A digest of the bits of a run's estimated poses."""
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(np.asarray(pipeline.algorithm.estimate_c2w_list)).tobytes()).hexdigest()[:16]


def repeat_runs(pointslam: int, protocol: int) -> None:
    """Point-SLAM's gated main path (registry settings, 12 office frames)
    ``pointslam`` times, then Co-SLAM at the accuracy protocol (tri-plane,
    200 frames, seed 0) and its row ``protocol`` times, in one process:
    each run's ATE (full precision) beside its gate, a digest of its poses'
    bits, and the protocol rows; nothing gated. Prints whether the runs of
    each kind were identical."""
    import torch

    office = f"height={HEIGHT},width={WIDTH},scene=office"
    seen = {}
    for i in range(pointslam):
        pipeline, res = run_slam("point-slam", f"n_frames={POINTSLAM_FRAMES},{office}", ("row_gather", "scatter_add"),
                                 tag=f"#{i}")
        digest = trajectory_digest(pipeline)
        seen.setdefault("point-slam", []).append((res["ate_rmse_cm"], digest))
        print(f"[repeat] point-slam run {i}: ATE {res['ate_rmse_cm']!r} cm, gate "
              f"{min(ATE_LIMIT_CM, FROZEN_ATE_SHARE * res['frozen_ate_cm']):.4f} cm, poses {digest}", flush=True)
        del pipeline
        torch.cuda.empty_cache()
    bounds = office_bounds(office)
    for i in range(protocol):
        pipeline, res = run_slam("co-slam", f"n_frames={PROTOCOL_FRAMES},{office}", ("scatter_add",),
                                 tag=f"@protocol#{i}", config=protocol_config(bounds))
        row = protocol_row(pipeline, res["ate_rmse_cm"])
        digest = trajectory_digest(pipeline)
        seen.setdefault("co-slam@protocol", []).append((json.dumps(row), digest))
        print(f"[repeat] co-slam@protocol run {i}: ATE {res['ate_rmse_cm']!r} cm, poses {digest}, row "
              f"{json.dumps(row)}", flush=True)
        del pipeline
        torch.cuda.empty_cache()
    for name, runs in seen.items():
        print(f"[repeat] {name}: {len(runs)} runs, identical: {all(r == runs[0] for r in runs)}")


def office_bounds(office: str):
    """The synthetic office's bounds as a nested list (the mapping bound)."""
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset

    return SyntheticDataset(office).bounds.tolist()


def determinism_probe() -> None:
    """Each main path, short, under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: every operation torch names as having no
    deterministic implementation on the card, with the number of its
    warnings. Co-SLAM (packed hash, 8 frames), Co-SLAM at the protocol's
    configuration (tri-plane, 8 frames, then one ``render_img``), SplaTAM
    (registry settings, 3 frames) and Point-SLAM (registry settings, 3
    frames). Nothing is gated."""
    import collections
    import warnings

    import torch

    office = f"height={HEIGHT},width={WIDTH},scene=office"
    bounds = office_bounds(office)
    bench = {"algorithm.mapping_bound": bounds, "algorithm.max_keyframes": 8}
    runs = (("co-slam", "@packed", 8, bench, None), ("co-slam", "@protocol", 8, None, protocol_config(bounds)),
            ("splaTAM", "", 3, None, None), ("point-slam", "", 3, None, None))
    for algorithm, tag, frames, overrides, config in runs:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                # a control: an operation torch names on every card
                torch.histc(torch.rand(100, device="cuda"))
                pipeline, _ = run_slam(algorithm, f"n_frames={frames},{office}", overrides=overrides,
                                       tag=tag + "#probe", config=config)
                if tag == "@protocol":
                    _, _, gt_depth, _ = pipeline.dataset[0]
                    pipeline.algorithm.render_img(np.asarray(pipeline.algorithm.estimate_c2w_list[0]),
                                                  gt_depth=gt_depth, idx=0)
                    torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        named = collections.Counter(str(w.message).split("\n")[0][:200] for w in caught
                                    if "deterministic" in str(w.message))
        print(f"[determinism] {algorithm}{tag}: {len(named)} operations named (the control histc among them), "
              f"{len(caught)} warnings in all")
        for msg, count in named.most_common():
            print(f"[determinism]   x{count:<6d} {msg}")
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
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
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
    if argv == ["--determinism-probe"]:
        determinism_probe()
        return
    repeats = dict(zip(argv[::2], argv[1::2]))
    if argv and len(argv) % 2 == 0 and set(repeats) <= {"--pointslam-repeat", "--protocol-repeat"}:
        repeat_runs(int(repeats.get("--pointslam-repeat", 0)), int(repeats.get("--protocol-repeat", 0)))
        return

    # the office spec, as the Co-SLAM run's model builds it
    model_cfg = algorithm_configs["co-slam"].xrdslam.algorithm.model
    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office")
    spec = JointEncoding(model_cfg, ds.get_camera(), ds.bounds).spec
    print(f"[spec] levels {spec.n_levels}, T=2^{spec.log2_table_size}, res {spec.resolutions}, "
          f"dense {sum(spec.dense)}, dense entries {[(r + 1) ** 3 for r, d in zip(spec.resolutions, spec.dense) if d]}")
    if argv == ["--scatter-variants"]:
        scatter_variants(spec, device)
        return
    if argv:
        raise SystemExit(f"chip_smoke.py: unknown arguments {argv}")
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
    bounds = office_bounds(office)
    coslam_data = f"n_frames={COSLAM_FRAMES},{office}"
    bench = {"algorithm.mapping_bound": bounds, "algorithm.max_keyframes": max(COSLAM_FRAMES // 5 + 2, 8)}
    # the exact hash grid (K1-K3), an option of the registry's entry
    pipeline, res = run_slam("co-slam", coslam_data, ("hashgrid_fwd", "hashgrid_bwd_dx", "hashgrid_bwd_dtable",
                                                      "hashgrid_bwd_dx_dtable"),
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
        want = coslam_scatter_schedule(config or algorithm_configs["co-slam"], res["frames"], encoding)
        print(f"[launches] co-slam{tag}: {json.dumps(res['launches'])}; schedule scatter_add {want}")
        if res["launches"]["scatter_add"] != want:
            raise RuntimeError(f"co-slam{tag}: scatter_add launches {res['launches']['scatter_add']} != {want}")
        launches[f"scatter_add[co-slam{tag}]"] = res["launches"]["scatter_add"]
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
        # what a launch costs the host beyond the card's own time
        print(f"[launch] {r['name']}: CUDA events {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
              f"events - device {1e3 * (r['ms'] - r['device_ms']):.1f} us")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
