// Multiresolution hash-grid encoding for Hopper (sm_90a).
//
// Replaces the five Pallas kernels of the per-vertex hash grid. From
// xrdslam_tpu/ops/hashgrid_fast.py (table [L, T, 2], tcnn's layout):
//   K1 _trilerp_fwd_kernel (:202)  -> hashgrid_fwd_kernel<false>, with the
//      corner gather fused in (on the TPU the gather was an XLA op);
//   K2 _trilerp_bwd_kernel (:216)  -> hashgrid_bwd_kernel<false>, dx part;
//   K3 _dtable_kernel      (:95)   -> hashgrid_bwd_kernel<false>, dtable part.
// From xrdslam_tpu/ops/pallas_hashgrid.py (the TPU's plane layout
// [L, 2, T/128, 128], entry e of feature f at planes[l, f, e >> 7, e & 127],
// which is [L, 2, T] in memory):
//   K8 _fwd_kernel (:103)          -> hashgrid_fwd_kernel<true>;
//   K9 _bwd_kernel (:123)          -> hashgrid_bwd_kernel<true>, dx and
//      dplanes (on the TPU one-hot MXU matmuls; here fp32 atomics).
// The two layouts differ only in where an entry's two features live (the
// Entry helpers below); the cell, hash and trilinear code is shared.
//
// Other layouts: x [N, 3] f32, encoding [N, L*2] f32, dx [N, 3] f32; the
// table gradient has the table's layout.
//
// What bounds it on this card: every (point, level) reads 8 random 8-byte
// table entries (and in the backward adds 16 floats to random entries), so the
// kernels are bound by memory latency, not by arithmetic or bandwidth. The
// design keeps the traffic to those rows and nothing else: one thread per
// (point, level) with the level fastest, so the threads of one point sit in
// one warp, read x once through the cache and write the point's encoding as
// one contiguous run; each [L, T, 2] entry is read as one float2 (a plane
// entry as two floats T apart: two 4-byte loads); no [L, 2, 8, N]
// feature residual is saved (the backward re-gathers, which costs the same
// rows the TPU's residual would have re-read from device memory).
//
// dx (K2, K9) is the gradient at the clamped point with no mask outside
// [0,1]^3, exactly as the TPU kernels compute it. The per-level terms of a
// point are summed with fp32 atomics; so is dtable (K3, K9). Atomic sums are
// not deterministic: their order, and so their last bits, change from run
// to run.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success, after checking cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct Levels {
  int n_levels;
  int log2_t;
  int res[kMaxLevels];
  int dense[kMaxLevels];
};

// Same arithmetic as _level_indices (hashgrid_fast.py:49-74): clamp x to
// [0,1], cell origin floor(x*res) clamped to [0, res-1], fraction in cell.
__device__ __forceinline__ void cell_axis(float x, int res, float* frac, uint32_t* i0) {
  const float p = fminf(fmaxf(x, 0.0f), 1.0f) * (float)res;
  int i = (int)floorf(p);
  i = min(max(i, 0), res - 1);
  *frac = p - (float)i;
  *i0 = (uint32_t)i;
}

// Dense stride on coarse levels, XOR-prime hash masked to T on fine ones,
// in wrapping uint32 arithmetic like the reference.
__device__ __forceinline__ uint32_t corner_row(uint32_t gx, uint32_t gy, uint32_t gz, uint32_t res,
                                               bool dense, uint32_t mask) {
  if (dense) {
    const uint32_t s = res + 1u;
    return gx + s * (gy + s * gz);
  }
  return ((gx * 1u) ^ (gy * 2654435761u) ^ (gz * 805459861u)) & mask;
}

// Entry e's two features within a level's 2T floats: adjacent in [L, T, 2]
// (one 8-byte load), T apart in the plane layout [L, 2, T].
template <bool kPlanes>
__device__ __forceinline__ float2 load_entry(const float* __restrict__ level, uint32_t e, uint32_t t) {
  if (kPlanes) return make_float2(__ldg(level + e), __ldg(level + t + e));
  return __ldg(reinterpret_cast<const float2*>(level) + e);
}

template <bool kPlanes>
__device__ __forceinline__ void add_entry(float* level, uint32_t e, uint32_t t, float a, float b) {
  float* d = kPlanes ? level + e : level + 2 * e;
  atomicAdd(d, a);
  atomicAdd(d + (kPlanes ? t : 1u), b);
}

template <bool kPlanes>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                    float* __restrict__ out, int64_t n, Levels lv) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * lv.n_levels) return;
  const int64_t p = t / lv.n_levels;
  const int l = (int)(t - p * lv.n_levels);
  const int res = lv.res[l];
  const bool dense = lv.dense[l] != 0;
  const uint32_t mask = (1u << lv.log2_t) - 1u;
  float fx, fy, fz;
  uint32_t ix, iy, iz;
  cell_axis(__ldg(x + 3 * p + 0), res, &fx, &ix);
  cell_axis(__ldg(x + 3 * p + 1), res, &fy, &iy);
  cell_axis(__ldg(x + 3 * p + 2), res, &fz, &iz);
  const uint32_t tsize = 1u << lv.log2_t;
  const float* level = table + ((int64_t)l << (lv.log2_t + 1));
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
    const uint32_t e = corner_row(ix + cx, iy + cy, iz + cz, (uint32_t)res, dense, mask);
    const float w = (cx ? fx : 1.0f - fx) * (cy ? fy : 1.0f - fy) * (cz ? fz : 1.0f - fz);
    const float2 f = load_entry<kPlanes>(level, e, tsize);
    a0 += w * f.x;
    a1 += w * f.y;
  }
  reinterpret_cast<float2*>(out)[t] = make_float2(a0, a1);
}

template <bool kPlanes>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                    const float* __restrict__ g, float* __restrict__ dx,
                    float* __restrict__ dtable, int64_t n, Levels lv) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * lv.n_levels) return;
  const int64_t p = t / lv.n_levels;
  const int l = (int)(t - p * lv.n_levels);
  const int res = lv.res[l];
  const bool dense = lv.dense[l] != 0;
  const uint32_t mask = (1u << lv.log2_t) - 1u;
  const float resf = (float)res;
  float fx, fy, fz;
  uint32_t ix, iy, iz;
  cell_axis(__ldg(x + 3 * p + 0), res, &fx, &ix);
  cell_axis(__ldg(x + 3 * p + 1), res, &fy, &iy);
  cell_axis(__ldg(x + 3 * p + 2), res, &fz, &iz);
  const float2 gg = __ldg(reinterpret_cast<const float2*>(g) + t);
  const uint32_t tsize = 1u << lv.log2_t;
  const int64_t level_off = (int64_t)l << (lv.log2_t + 1);
  const float* level = table + level_off;
  float ddx = 0.0f, ddy = 0.0f, ddz = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
    const uint32_t e = corner_row(ix + cx, iy + cy, iz + cz, (uint32_t)res, dense, mask);
    const float wx = cx ? fx : 1.0f - fx;
    const float wy = cy ? fy : 1.0f - fy;
    const float wz = cz ? fz : 1.0f - fz;
    if (dtable != nullptr) {
      const float w = wx * wy * wz;
      add_entry<kPlanes>(dtable + level_off, e, tsize, w * gg.x, w * gg.y);
    }
    if (dx != nullptr) {
      const float2 f = load_entry<kPlanes>(level, e, tsize);
      const float gf = gg.x * f.x + gg.y * f.y;
      ddx += gf * ((cx ? wy : -wy) * wz * resf);
      ddy += gf * (wx * (cy ? 1.0f : -1.0f) * wz * resf);
      ddz += gf * (wx * wy * (cz ? 1.0f : -1.0f) * resf);
    }
  }
  if (dx != nullptr) {
    atomicAdd(dx + 3 * p + 0, ddx);
    atomicAdd(dx + 3 * p + 1, ddy);
    atomicAdd(dx + 3 * p + 2, ddz);
  }
}

int make_levels(int n_levels, int log2_t, const int* res, const int* dense, Levels* lv) {
  if (n_levels < 1 || n_levels > kMaxLevels || log2_t < 7 || log2_t > 30) return (int)cudaErrorInvalidValue;
  lv->n_levels = n_levels;
  lv->log2_t = log2_t;
  for (int i = 0; i < n_levels; ++i) {
    lv->res[i] = res[i];
    lv->dense[i] = dense[i];
  }
  return 0;
}

unsigned int n_blocks(int64_t threads) { return (unsigned int)((threads + kThreads - 1) / kThreads); }

template <bool kPlanes>
int launch_fwd(const float* table, const float* x, float* out, long long n, int n_levels, int log2_t,
               const int* res, const int* dense, void* stream) {
  Levels lv;
  int err = make_levels(n_levels, log2_t, res, dense, &lv);
  if (err != 0 || n == 0) return err;
  hashgrid_fwd_kernel<kPlanes><<<n_blocks(n * n_levels), kThreads, 0, (cudaStream_t)stream>>>(table, x, out, n, lv);
  return (int)cudaGetLastError();
}

template <bool kPlanes>
int launch_bwd(const float* table, const float* x, const float* g, float* dx, float* dtable, long long n,
               int n_levels, int log2_t, const int* res, const int* dense, void* stream) {
  Levels lv;
  int err = make_levels(n_levels, log2_t, res, dense, &lv);
  if (err != 0 || n == 0 || (dx == nullptr && dtable == nullptr)) return err;
  hashgrid_bwd_kernel<kPlanes><<<n_blocks(n * n_levels), kThreads, 0, (cudaStream_t)stream>>>(
      table, x, g, dx, dtable, n, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [L, 2^log2_t, 2], x [n, 3] -> out [n, L*2]. res/dense: host arrays of L ints.
int xr_hashgrid_fwd(const float* table, const float* x, float* out, long long n, int n_levels,
                    int log2_t, const int* res, const int* dense, void* stream) {
  return launch_fwd<false>(table, x, out, n, n_levels, log2_t, res, dense, stream);
}

// g [n, L*2] -> dx [n, 3] and/or dtable [L, 2^log2_t, 2], each accumulated
// with atomics into memory the caller zeroed; a null pointer skips that
// output (tracking passes dtable = null: its table is constant).
int xr_hashgrid_bwd(const float* table, const float* x, const float* g, float* dx, float* dtable,
                    long long n, int n_levels, int log2_t, const int* res, const int* dense,
                    void* stream) {
  return launch_bwd<false>(table, x, g, dx, dtable, n, n_levels, log2_t, res, dense, stream);
}

// The same two functions on the plane layout planes [L, 2, 2^log2_t]
// (K8, K9); dplanes has the planes' layout.
int xr_hashgrid_planes_fwd(const float* planes, const float* x, float* out, long long n, int n_levels,
                           int log2_t, const int* res, const int* dense, void* stream) {
  return launch_fwd<true>(planes, x, out, n, n_levels, log2_t, res, dense, stream);
}

int xr_hashgrid_planes_bwd(const float* planes, const float* x, const float* g, float* dx, float* dplanes,
                           long long n, int n_levels, int log2_t, const int* res, const int* dense,
                           void* stream) {
  return launch_bwd<true>(planes, x, g, dx, dplanes, n, n_levels, log2_t, res, dense, stream);
}

const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
