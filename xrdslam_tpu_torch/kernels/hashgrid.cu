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
// The forward (K1, K8). Every (point, level) reads 8 table entries of 8
// bytes. The whole table (16 levels x 2^16 x 8 B = 8.4 MB at the office
// spec) sits in the 50 MB L2, so DRAM bytes are far from the limit; what
// sets the pace is the number of 32-byte sector requests the corner loads
// make through L1 and L2 (an inference from the code and from sector counts
// of the port's own grid_corners on the CPU; the card's profilers do not
// run on its machine). The former design (one thread per (point, level),
// levels fastest) gave a warp 2 points x 16 levels: each corner load
// touched 16 tables, 32 sectors for 256 useful bytes, and mixed dense and
// hashed levels. This one:
//  - level-major warps: a warp's 32 lanes are 32 consecutive points at one
//    level, so an instruction reads one level's table, the dense/hash branch
//    is uniform, and consecutive samples of a ray share cells and sectors on
//    the coarse levels; a thread takes kFwdLevels (G) levels of its point
//    and issues their loads before their multiply-adds;
//  - x-pair loads: corners (0, cy, cz) and (1, cy, cz) are entries e0 and
//    e1; where they form one aligned 16-byte pair of [L, T, 2] (a dense
//    level's e and e + 1 for even e, a hashed level's e and e ^ 1 for even
//    ix) one float4 load brings both, else a second float2 load follows (on
//    the plane layout one float2 per feature, two scalars for e1 else);
//  - x staged in shared memory (one load per point) and the block's
//    outputs, one contiguous [P, 2L] run of out, staged there too and
//    written as 16-byte stores;
//  - the same arithmetic per (point, level) as the former kernel
//    (cell_axis, corner_row, the weight product's association, the sum
//    over corners in the order c = 0..7): the same bits.
// Measured (chip_smoke.py and its --hashgrid-fwd-variants; H100 80GB HBM3,
// 700 W; device time at N = 176,128, office surface samples; PERF.md):
// K1 0.066 ms against 0.093 for the former kernel, K8 0.115 against 0.212.
// Loads alone, no weights, take as long: the access pattern is the floor.
// G is per layout. K1 takes G = 2: summed over the exact-hash Co-SLAM run's
// own launches (1,030, 710 of them at N <= 44,032) its time is 2%
// below G = 4's and 4% below G = 1's, at 70 registers against 122. K8 takes
// G = 4, 13-15% faster than G = 2 on the plane layout. G = 16 spills.
// Without staging the outputs 56% slower; without x-pair loads 6% slower.
// 4x the points per block, the largest L1 carveout, and the hashed levels'
// loads kept out of L1 are each slower: a sector another warp of the SM
// fetched is worth keeping in L1.
//
// The backward (K2, K3, K9) is bound the same way, by memory latency: one
// thread per (point, level) with the level fastest (below), each entry read
// as one float2 (a plane entry as two floats T apart); no [L, 2, 8, N]
// feature residual is saved (the backward re-gathers, which costs the same
// rows the TPU's residual would have re-read from device memory).
//
// dx (K2, K9) is the gradient at the clamped point with no mask outside
// [0,1]^3, exactly as the TPU kernels compute it. A point's levels sit on
// adjacent lanes of one warp, and their terms are summed with warp shuffles
// in a fixed order and stored once: dx has the same bits on every run, as
// the TPU's K2, which sums a point's levels in registers (:216).
//
// dtable (K3, K9) is summed with atomics, so its last bits change from run
// to run (the TPU's K3 keeps a level's planes resident while the points
// add into them in order, hashgrid_fast.py:95). What held it back was the
// number of atomics: 16 scalar atomics per (point, level), 45 M per mapping
// pass at N = 176,128. Here a corner's feature pair is one float2 atomic
// (sm_90, global memory), and the two corners of an x-pair whose entries
// form one aligned 16-byte pair (a dense level's e and e + 1 for even e, a
// hashed level's e and e ^ 1 for even ix: half of them) one float4 atomic:
// 6 atomics per (point, level) on [L, T, 2] on average, the plane layout
// keeps its 16 scalar ones. The dense levels accumulated privately in
// shared memory by blocks of points and flushed once per block were
// measured slower on the card at this shape and not kept; an owner-ordered
// sum, which would sort 1.4 M (entry, value) pairs a level, was not built.
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

// Adds (a, b) to entry e: one float2 atomic (sm_90, global memory) where the
// features are adjacent, two float atomics on the plane layout.
template <bool kPlanes>
__device__ __forceinline__ void add_entry(float* level, uint32_t e, uint32_t t, float a, float b) {
  if (!kPlanes) {
    atomicAdd(reinterpret_cast<float2*>(level) + e, make_float2(a, b));
    return;
  }
  float* d = kPlanes ? level + e : level + 2 * e;
  atomicAdd(d, a);
  atomicAdd(d + (kPlanes ? t : 1u), b);
}

// Adds w[i] * g to entries e[0] and e[1]: where they are the two entries of
// one aligned 16-byte pair of [L, T, 2], one float4 atomic (sm_90, global
// memory), else one add_entry each.
template <bool kPlanes>
__device__ __forceinline__ void add_pair(float* level, const uint32_t e[2], uint32_t t, const float w[2], float2 g) {
  if (!kPlanes && (e[0] ^ e[1]) == 1u) {
    const int lo = (int)(e[0] & 1u);  // 1 when e[1] is the even entry
    atomicAdd(reinterpret_cast<float4*>(level) + (e[0] >> 1),
              make_float4(w[lo] * g.x, w[lo] * g.y, w[1 - lo] * g.x, w[1 - lo] * g.y));
    return;
  }
  add_entry<kPlanes>(level, e[0], t, w[0] * g.x, w[0] * g.y);
  add_entry<kPlanes>(level, e[1], t, w[1] * g.x, w[1] * g.y);
}

// G, the levels of one point a thread takes, for each layout (the header;
// chip_smoke.py --hashgrid-fwd-variants rebuilds this file with other values)
template <bool kPlanes>
constexpr int kFwdLevels = kPlanes ? 4 : 2;

// Entries e0 and e1 of an x-pair (corners (0, cy, cz) and (1, cy, cz)). One
// load brings e0's aligned pair (e0 & ~1, e0 | 1): a float4 of [L, T, 2], a
// float2 per feature of [L, 2, T]; e1 comes from it where e0 ^ e1 == 1, else
// from a load of its own.
template <bool kPlanes>
__device__ __forceinline__ void load_pair(const float* __restrict__ level, uint32_t e0, uint32_t e1, uint32_t t,
                                          float2* f0, float2* f1) {
  float2 even, odd;  // the pair's entries e0 & ~1 and e0 | 1
  if (kPlanes) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(level + (e0 & ~1u)));
    const float2 b = __ldg(reinterpret_cast<const float2*>(level + t + (e0 & ~1u)));
    even = make_float2(a.x, b.x);
    odd = make_float2(a.y, b.y);
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(level) + (e0 >> 1));
    even = make_float2(v.x, v.y);
    odd = make_float2(v.z, v.w);
  }
  const bool e0_odd = (e0 & 1u) != 0u;
  *f0 = e0_odd ? odd : even;
  *f1 = (e0 ^ e1) == 1u ? (e0_odd ? even : odd) : load_entry<kPlanes>(level, e1, t);
}

// A staged point's floats in shared memory: its 2L outputs padded to a
// multiple of 4 and by 4 more (16-byte rows; a warp's rows start on
// different banks).
__host__ __device__ __forceinline__ int fwd_row(int n_levels) { return (2 * n_levels + 4) & ~3; }

// Forward, level-major: a block of 8 warps takes 32 x chunks consecutive
// points; its warp tasks are (32 points, G levels), chunks x groups of them.
template <bool kPlanes>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                    float* __restrict__ out, int64_t n, Levels lv, int chunks) {
  constexpr int G = kFwdLevels<kPlanes>;
  extern __shared__ float4 fwd_smem[];
  const int nl = lv.n_levels;
  const int groups = (nl + G - 1) / G;
  const int row = fwd_row(nl);
  const int pb = 32 * chunks;
  float* xs = reinterpret_cast<float*>(fwd_smem);  // [pb, 3]
  float* os = xs + 3 * pb;                           // [pb, row]: 16-byte aligned (pb is a multiple of 32)
  const int64_t p0 = (int64_t)blockIdx.x * pb;
  const int np = (int)(n - p0 < pb ? n - p0 : pb);
  for (int i = threadIdx.x; i < 3 * np; i += kThreads) xs[i] = __ldg(x + 3 * p0 + i);
  __syncthreads();
  const uint32_t mask = (1u << lv.log2_t) - 1u;
  const uint32_t tsize = 1u << lv.log2_t;
  for (int task = threadIdx.x >> 5; task < chunks * groups; task += kThreads / 32) {
    const int q = (task / groups) * 32 + (threadIdx.x & 31);  // the point within the block
    const int l0 = (task % groups) * G;
    if (q >= np) continue;
    const float px = xs[3 * q + 0], py = xs[3 * q + 1], pz = xs[3 * q + 2];
    float fx[G], fy[G], fz[G];
    float2 f[G][8];
    // every load of the task's levels, then their multiply-adds
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int l = l0 + j;
      if (l >= nl) break;
      const int res = lv.res[l];
      const bool dense = lv.dense[l] != 0;
      uint32_t ix, iy, iz;
      cell_axis(px, res, &fx[j], &ix);
      cell_axis(py, res, &fy[j], &iy);
      cell_axis(pz, res, &fz[j], &iz);
      const float* level = table + ((int64_t)l << (lv.log2_t + 1));
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // x-pair k = 2 cy + cz: corners c = k and k + 4
        const uint32_t gy = iy + (k >> 1), gz = iz + (k & 1);
        load_pair<kPlanes>(level, corner_row(ix, gy, gz, (uint32_t)res, dense, mask),
                           corner_row(ix + 1, gy, gz, (uint32_t)res, dense, mask), tsize, &f[j][k], &f[j][k + 4]);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int l = l0 + j;
      if (l >= nl) break;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
        const float w = (cx ? fx[j] : 1.0f - fx[j]) * (cy ? fy[j] : 1.0f - fy[j]) * (cz ? fz[j] : 1.0f - fz[j]);
        a0 += w * f[j][c].x;
        a1 += w * f[j][c].y;
      }
      reinterpret_cast<float2*>(os + q * row)[l] = make_float2(a0, a1);
    }
  }
  __syncthreads();
  // the block's [np, 2L] outputs are one contiguous run of out: 16-byte
  // stores where 2L is a multiple of 4, else 8-byte ones
  if (nl % 2 == 0) {
    const int w = nl / 2;
    float4* dst = reinterpret_cast<float4*>(out + p0 * 2 * nl);
    for (int i = threadIdx.x; i < np * w; i += kThreads) {
      const int r = i / w;
      dst[i] = reinterpret_cast<const float4*>(os + r * row)[i - r * w];
    }
  } else {
    float2* dst = reinterpret_cast<float2*>(out + p0 * 2 * nl);
    for (int i = threadIdx.x; i < np * nl; i += kThreads) {
      const int r = i / nl;
      dst[i] = reinterpret_cast<const float2*>(os + r * row)[i - r * nl];
    }
  }
}

// Backward, point-major: one thread per (point, level slot), the slots of a
// point padded to the next power of two lp <= 32, so that a point's levels
// are adjacent lanes of one warp. dx: each lane's terms for its level, then
// a butterfly of warp shuffles over the point's lanes in a fixed order, and
// one store; no atomics, no fill, the same bits on every run. dtable: each
// (point, level) adds its 8 corners x 2 features into the zeroed table with
// add_pair's vector atomics.
template <bool kPlanes>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                    const float* __restrict__ g, float* __restrict__ dx,
                    float* __restrict__ dtable, int64_t n, Levels lv, int log2_lp) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p = t >> log2_lp;
  const int l = (int)(t & ((1 << log2_lp) - 1));
  float ddx = 0.0f, ddy = 0.0f, ddz = 0.0f;
  if (p < n && l < lv.n_levels) {
    const int res = lv.res[l];
    const bool dense = lv.dense[l] != 0;
    const uint32_t mask = (1u << lv.log2_t) - 1u;
    const float resf = (float)res;
    float fx, fy, fz;
    uint32_t ix, iy, iz;
    cell_axis(__ldg(x + 3 * p + 0), res, &fx, &ix);
    cell_axis(__ldg(x + 3 * p + 1), res, &fy, &iy);
    cell_axis(__ldg(x + 3 * p + 2), res, &fz, &iz);
    const float2 gg = __ldg(reinterpret_cast<const float2*>(g) + p * lv.n_levels + l);
    const uint32_t tsize = 1u << lv.log2_t;
    const int64_t level_off = (int64_t)l << (lv.log2_t + 1);
    const float* level = table + level_off;
    // the corners in x-pairs (0, cy, cz), (1, cy, cz): on a dense level their
    // rows are e and e + 1, on a hashed one e and e ^ 1 when ix is even
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cy = q >> 1, cz = q & 1;
      const float wy = cy ? fy : 1.0f - fy;
      const float wz = cz ? fz : 1.0f - fz;
      const uint32_t e[2] = {corner_row(ix, iy + cy, iz + cz, (uint32_t)res, dense, mask),
                             corner_row(ix + 1, iy + cy, iz + cz, (uint32_t)res, dense, mask)};
      const float w[2] = {(1.0f - fx) * wy * wz, fx * wy * wz};
      if (dtable != nullptr) add_pair<kPlanes>(dtable + level_off, e, tsize, w, gg);
      if (dx != nullptr) {
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const float wx = cx ? fx : 1.0f - fx;
          const float2 f = load_entry<kPlanes>(level, e[cx], tsize);
          const float gf = gg.x * f.x + gg.y * f.y;
          ddx += gf * ((cx ? wy : -wy) * wz * resf);
          ddy += gf * (wx * (cy ? 1.0f : -1.0f) * wz * resf);
          ddz += gf * (wx * wy * (cz ? 1.0f : -1.0f) * resf);
        }
      }
    }
  }
  if (dx == nullptr) return;  // uniform over the grid: every lane of a warp reaches the shuffles
  for (int off = (1 << log2_lp) >> 1; off > 0; off >>= 1) {
    ddx += __shfl_xor_sync(0xffffffffu, ddx, off);
    ddy += __shfl_xor_sync(0xffffffffu, ddy, off);
    ddz += __shfl_xor_sync(0xffffffffu, ddz, off);
  }
  if (l == 0 && p < n) {
    dx[3 * p + 0] = ddx;
    dx[3 * p + 1] = ddy;
    dx[3 * p + 2] = ddz;
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
  // the pair loads read 16 bytes of [L, T, 2] (8 of [L, 2, T]); the staged
  // outputs are written 16 bytes at a time
  if (reinterpret_cast<uintptr_t>(table) % (kPlanes ? 8 : 16) != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // chunks x groups warp tasks for a block's 8 warps; shared memory for any
  // G <= 16 and L <= 32 at most 256 x (3 + 36) floats (G = L = 16), 39.9 KB:
  // below the 48 KB a launch takes without opting in
  const int groups = (n_levels + kFwdLevels<kPlanes> - 1) / kFwdLevels<kPlanes>;
  const int chunks = groups >= kThreads / 32 ? 1 : (kThreads / 32) / groups;
  const int64_t pb = 32 * chunks;
  const size_t smem = sizeof(float) * pb * (3 + fwd_row(n_levels));
  hashgrid_fwd_kernel<kPlanes><<<(unsigned int)((n + pb - 1) / pb), kThreads, smem, (cudaStream_t)stream>>>(
      table, x, out, n, lv, chunks);
  return (int)cudaGetLastError();
}

template <bool kPlanes>
int launch_bwd(const float* table, const float* x, const float* g, float* dx, float* dtable, long long n,
               int n_levels, int log2_t, const int* res, const int* dense, void* stream) {
  Levels lv;
  int err = make_levels(n_levels, log2_t, res, dense, &lv);
  if (err != 0 || n == 0 || (dx == nullptr && dtable == nullptr)) return err;
  int log2_lp = 0;
  while ((1 << log2_lp) < n_levels) ++log2_lp;
  hashgrid_bwd_kernel<kPlanes><<<n_blocks(n << log2_lp), kThreads, 0, (cudaStream_t)stream>>>(
      table, x, g, dx, dtable, n, lv, log2_lp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [L, 2^log2_t, 2], x [n, 3] -> out [n, L*2]. res/dense: host arrays of L ints.
int xr_hashgrid_fwd(const float* table, const float* x, float* out, long long n, int n_levels,
                    int log2_t, const int* res, const int* dense, void* stream) {
  return launch_fwd<false>(table, x, out, n, n_levels, log2_t, res, dense, stream);
}

// g [n, L*2] -> dx [n, 3] (every entry written) and/or dtable [L, 2^log2_t,
// 2] (accumulated into memory the caller zeroed); a null pointer skips that
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
