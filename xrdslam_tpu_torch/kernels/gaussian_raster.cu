// Tile rasterizer of isotropic gaussians for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of xrdslam_tpu/ops/gaussian_raster.py:
//   K5 _fwd_kernel (:239), via _fwd_pallas (:373) -> raster_fwd_kernel;
//   K6 _bwd_kernel (:265), via _bwd_pallas (:390) -> raster_bwd_kernel.
// The per-gaussian sum over tiles that follows K6 (_raster_bwd, :428-431)
// is K4, in scatter.cu.
//
// Layouts. tiled [T, K, 16] f32: per tile, its K depth-sorted slots, each
// one 64-byte row u, v, sigma, opacity, mask, ch0..7, 0, 0, 0 (the TPU
// kept the transpose [T, 16, K] for its lanes). The image is
// [H_pad, W_pad, 8] f32, H_pad = 16 * nty, W_pad = 16 * ntx, tile
// t = ty * ntx + tx (the TPU wrote channel-major [T, 8, 256] blocks for its
// lanes and transposed after). dg [T, K, 16] f32: per slot d u, d v,
// d sigma, d opacity, 0, d ch0..7, 0, 0, 0, and all zero for a slot whose
// mask is off (the reference multiplies by the mask after its kernel).
//
// Arithmetic is the reference's, per (pixel, slot) (_alphas, :222-229):
//   alpha = clip(op * exp(-r^2 * 0.5 / max(sigma^2, 1e-12)), 0, 0.99),
//   0 where the mask is off; the transmittance T is exp of the exclusive
//   running sum of log1p(-alpha) (_transmittance, :234-236), never a
//   running product. The backward forms suffix_k = total - inclusive
//   prefix_k of contrib = (gout . ch_k) * w_k (_suffix_sum, :229-232), so
//   the cancellation is the reference's; dalpha is zeroed where the raw
//   alpha exceeds 0.99 or the mask is off. There is no alpha or
//   transmittance threshold. Two kinds of work are skipped, both exactly:
//   a masked slot (alpha 0: it moves no sum, and its dg row is zero), and,
//   in the forward only, the rest of a block's slots once exp(log T) is 0
//   at every one of its pixels (log T only falls, so every later weight is
//   0; the backward's suffix there is the reference's rounding residue, not
//   0, so the backward walks on).
//
// What bounds it on this card: the SMs' instruction issue. At SplaTAM's
// full width (836 tiles, K = 256) a grown office frame has ~37 M live
// (pixel, slot) pairs, each with two expf and a log1pf (~16 and ~30
// instructions in SASS) and, in the backward, a division: ~70 issued
// instructions a pair in the forward and ~110 in the backward, plus ~50 a
// slot per warp for the backward's cross-lane sums, against 13.7 MB of
// tile data. The design spends the issue slots on the pairs:
//  * Slots are staged 256 at a time, live ones only, in order (a ballot
//    scan compacts them), in a precomputed form: float4 (u, v,
//    -0.5 / max(sigma^2, 1e-12), opacity) and two float4 of channels, so a
//    pair takes 3 vector reads of a broadcast shared-memory address, and
//    the per-slot constant is computed once, with the per-pair code's
//    arithmetic (gauss and alpha are unchanged).
//  * A thread owns P pixels of one column of its block (rows apart), so
//    that each slot read and each cross-lane sum serves P pixels. P is 1 in
//    the forward, where more pixels a thread leave fewer warps to hide the
//    exp/log1p chains' latency, and 4 in the backward, where 4 pixels share
//    each slot's cross-lane sums: the fastest of 1, 2 and 4 on the H100
//    (chip_smoke.py --raster-variants times the others).
//  * The forward renders half a tile (8 rows) per block: its pixels are
//    independent, and 1,672 blocks of 128 threads fill the SMs more evenly
//    than 836 of 256.
//  * The backward walks the slots once. Each pixel's total = gout . image,
//    since the forward's image is sum_k ch_k w_k; the walk keeps the prefix
//    and forms suffix = total - prefix as it goes. Its division runs as
//    __fdividef (within 2 ulp for the divisor's range [1e-6, 1]): the IEEE
//    division takes a slow path for denormal dividends, and the suffixes of
//    a sparsely covered tile are denormal; it cost a third of the kernel.
//  * The backward's per-slot sums over the tile's 256 pixels (16 columns of
//    the slot's dg row) are a warp reduce-scatter: four halving shuffle
//    steps and a pairwise sum leave column lane / 2 in lane, 16 shuffles
//    per slot where 16 independent warp sums take 80; a warp writes its
//    partial row to shared memory, and the block adds the warps' partials
//    and writes the rows once per 32 slots. Nothing is atomic; each slot's
//    row is written by one block, and the backward is deterministic.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success, after checking cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kFwdPix = kTile * kTile / 2;  // pixels per forward block: half a tile
constexpr int kBwdPix = kTile * kTile;      // pixels per backward block: a tile
constexpr int kFwdPixPerThread = 1;
constexpr int kBwdPixPerThread = 4;
constexpr int kRow = 16;             // floats per slot row
constexpr int kCh = 8;
constexpr int kChunk = 256;          // slots staged in shared memory at once
constexpr int kSub = 32;             // slots per block-wide sum (backward) or T = 0 test (forward)
constexpr float kAlphaMax = 0.99f;
constexpr unsigned kFull = 0xffffffffu;

// The live slots of one chunk, in order, as the walk reads them.
struct Stage {
  float4 geo[kChunk];    // u, v, -0.5 / max(sigma^2, 1e-12), opacity
  float4 ch[kChunk][2];  // ch0..3, ch4..7
  float sig[kChunk];     // sigma, for the backward's output scale
  int idx[kChunk];       // the slot's index in the tile
  int warp_live[kBwdPix / 32];
};

// Stage the live slots among [base, base + n) of a tile into st, in order;
// returns how many (the same in every thread). With dg (the tile's rows of
// the gradient), a masked slot's row is written as zeros here, since the
// walk never sees it. The caller synchronises before (st is in use) and
// the last round synchronises after.
template <int NT>
__device__ int stage_live(Stage& st, const float4* __restrict__ src, int base, int n, float4* __restrict__ dg) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int staged = 0;
  for (int r = 0; r < n; r += NT) {
    const int j = r + threadIdx.x;
    float4 a = {}, b = {}, c = {}, d = {};
    bool live = false;
    if (j < n) {
      const float4* row = src + (int64_t)(base + j) * (kRow / 4);
      a = row[0];
      b = row[1];
      c = row[2];
      d = row[3];
      live = b.x > 0.5f;
      if (!live && dg != nullptr) {
        float4* o = dg + (int64_t)(base + j) * (kRow / 4);
        o[0] = o[1] = o[2] = o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    const unsigned vote = __ballot_sync(kFull, live);
    if (lane == 0) st.warp_live[warp] = __popc(vote);
    __syncthreads();
    int pos = staged;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      const int cnt = st.warp_live[w];
      pos += w < warp ? cnt : 0;
      staged += cnt;
    }
    if (live) {
      pos += __popc(vote & ((1u << lane) - 1u));
      st.geo[pos] = make_float4(a.x, a.y, -(0.5f / fmaxf(a.z * a.z, 1e-12f)), a.w);
      st.ch[pos][0] = make_float4(b.y, b.z, b.w, c.x);
      st.ch[pos][1] = make_float4(c.y, c.z, c.w, d.x);
      st.sig[pos] = a.z;
      st.idx[pos] = base + j;
    }
    __syncthreads();  // warp_live is rewritten by the next round; the stage is complete
  }
  return staged;
}

// The row in its tile of thread t's pixel i, in a block of `pixels`
// pixels from row row0 with p pixels a thread: the thread owns column
// t % 16 at rows pixels / 16 / p apart.
__device__ __forceinline__ int pixel_row(int row0, int pixels, int t, int i, int p) {
  return row0 + t / kTile + i * (pixels / kTile / p);
}

// Block b renders rows 0-7 (b even) or 8-15 (b odd) of tile b / 2.
template <int P>
__global__ void __launch_bounds__(kFwdPix / P)
raster_fwd_kernel(const float* __restrict__ tiled, float* __restrict__ out, int k_slots, int ntx) {
  constexpr int NT = kFwdPix / P;
  __shared__ Stage st;
  const int tile = blockIdx.x / 2, row0 = (blockIdx.x % 2) * (kTile / 2), t = threadIdx.x;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int ipx = tx * kTile + t % kTile;
  const float px = (float)ipx;
  float py[P], log_t[P], acc[P][kCh];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    py[i] = (float)(ty * kTile + pixel_row(row0, kFwdPix, t, i, P));
    log_t[i] = 0.0f;  // sum of log1p(-alpha) over the slots before this one
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[i][c] = 0.0f;
  }
  const float4* src = reinterpret_cast<const float4*>(tiled) + (int64_t)tile * k_slots * (kRow / 4);
  bool dark = false;  // exp(log T) is 0 at every pixel of the block
  for (int base = 0; base < k_slots && !dark; base += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    const int n_live = stage_live<NT>(st, src, base, min(kChunk, k_slots - base), nullptr);
    for (int sub = 0; sub < n_live && !dark; sub += kSub) {
      const int end = min(sub + kSub, n_live);
      for (int j = sub; j < end; ++j) {
        const float4 g = st.geo[j], c0 = st.ch[j][0], c1 = st.ch[j][1];
        const float du = px - g.x;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float dv = py[i] - g.y;
          const float gauss = expf((du * du + dv * dv) * g.z);
          const float alpha = fminf(fmaxf(g.w * gauss, 0.0f), kAlphaMax);
          const float w = alpha * expf(log_t[i]);
          acc[i][0] += c0.x * w;
          acc[i][1] += c0.y * w;
          acc[i][2] += c0.z * w;
          acc[i][3] += c0.w * w;
          acc[i][4] += c1.x * w;
          acc[i][5] += c1.y * w;
          acc[i][6] += c1.z * w;
          acc[i][7] += c1.w * w;
          log_t[i] += log1pf(-alpha);
        }
      }
      bool mine = true;
#pragma unroll
      for (int i = 0; i < P; ++i) mine = mine && expf(log_t[i]) == 0.0f;
      dark = __syncthreads_and(mine) != 0;
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float4* o = reinterpret_cast<float4*>(out + ((int64_t)py[i] * ntx * kTile + ipx) * kCh);
    o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// One halving step of the warp reduce-scatter: a lane keeps the upper half
// of v[0, 2N) where its bit OFF is set, the lower half where it is not,
// adds what its partner (lane ^ OFF) holds of that half, and leaves the
// result in v[0, N).
template <int N, int OFF>
__device__ __forceinline__ void halve(float (&v)[kRow], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// Entry lane / 2 of v summed over the warp's 32 lanes (v is clobbered).
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[kRow], int lane) {
  halve<8, 16>(v, lane);
  halve<4, 8>(v, lane);
  halve<2, 4>(v, lane);
  halve<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// Block b takes tile b.
template <int P>
__global__ void __launch_bounds__(kBwdPix / P)
raster_bwd_kernel(const float* __restrict__ tiled, const float* __restrict__ gout, const float* __restrict__ image,
                  float* __restrict__ dg, int k_slots, int ntx) {
  constexpr int NT = kBwdPix / P, NW = NT / 32;
  __shared__ Stage st;
  __shared__ float part[NW][kSub][kRow];  // per warp and slot: the dg row summed over the warp's pixels
  const int tile = blockIdx.x, t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const float px = (float)(tx * kTile + t % kTile);
  float py[P], go[P][kCh], total[P], prefix[P], log_t[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int ipy = ty * kTile + pixel_row(0, kBwdPix, t, i, P);
    py[i] = (float)ipy;
    const int64_t at = ((int64_t)ipy * ntx * kTile + tx * kTile + t % kTile) * kCh;
    const float4 g0 = *reinterpret_cast<const float4*>(gout + at), g1 = *reinterpret_cast<const float4*>(gout + at + 4);
    const float4 m0 = *reinterpret_cast<const float4*>(image + at), m1 = *reinterpret_cast<const float4*>(image + at + 4);
    go[i][0] = g0.x; go[i][1] = g0.y; go[i][2] = g0.z; go[i][3] = g0.w;
    go[i][4] = g1.x; go[i][5] = g1.y; go[i][6] = g1.z; go[i][7] = g1.w;
    // total = sum over slots of (gout . ch_k) w_k = gout . image
    total[i] = go[i][0] * m0.x + go[i][1] * m0.y + go[i][2] * m0.z + go[i][3] * m0.w +
               go[i][4] * m1.x + go[i][5] * m1.y + go[i][6] * m1.z + go[i][7] * m1.w;
    prefix[i] = 0.0f;
    log_t[i] = 0.0f;
  }
  const float4* src = reinterpret_cast<const float4*>(tiled) + (int64_t)tile * k_slots * (kRow / 4);
  float* dst = dg + (int64_t)tile * k_slots * kRow;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int base = 0; base < k_slots; base += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    const int n_live = stage_live<NT>(st, src, base, min(kChunk, k_slots - base), dst4);
    for (int sub = 0; sub < n_live; sub += kSub) {
      const int m = min(kSub, n_live - sub);
      for (int jj = 0; jj < m; ++jj) {
        const int j = sub + jj;
        const float4 g = st.geo[j], c0 = st.ch[j][0], c1 = st.ch[j][1];
        const float ch[kCh] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float du = px - g.x;
        float v[kRow];  // this thread's pixels' share of the slot's dg row (unscaled)
#pragma unroll
        for (int q = 0; q < kRow; ++q) v[q] = 0.0f;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float dv = py[i] - g.y;
          const float r2 = du * du + dv * dv;
          const float gauss = expf(r2 * g.z);
          const float raw_alpha = g.w * gauss;
          const float alpha = fminf(fmaxf(raw_alpha, 0.0f), kAlphaMax);
          const float t_k = expf(log_t[i]);
          const float w = alpha * t_k;
          float gdotc = 0.0f;
#pragma unroll
          for (int c = 0; c < kCh; ++c) gdotc += go[i][c] * ch[c];
          prefix[i] += gdotc * w;
          const float suffix = total[i] - prefix[i];
          // __fdividef: see the header
          float dalpha = t_k * gdotc - __fdividef(suffix, fmaxf(1.0f - alpha, 1e-6f));
          if (raw_alpha > kAlphaMax) dalpha = 0.0f;
          const float d_common = dalpha * g.w * gauss;
          v[0] += d_common * du;
          v[1] += d_common * dv;
          v[2] += d_common * r2;
          v[3] += dalpha * gauss;
#pragma unroll
          for (int c = 0; c < kCh; ++c) v[5 + c] += go[i][c] * w;
          log_t[i] += log1pf(-alpha);
        }
        const float s = warp_reduce_scatter(v, lane);
        if ((lane & 1) == 0) part[warp][jj][lane >> 1] = s;
      }
      __syncthreads();
      // one output value per thread: column col of slot sub + jj, summed over the warps
      for (int o = t; o < m * kRow; o += NT) {
        const int jj = o / kRow, col = o - jj * kRow;
        float val = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) val += part[w][jj][col];
        const float sig = st.sig[sub + jj];
        const float sig2 = fmaxf(sig * sig, 1e-12f);
        if (col < 2) val = val / sig2;
        else if (col == 2) val = val / (sig2 * fmaxf(sig, 1e-6f));
        dst[(int64_t)st.idx[sub + jj] * kRow + col] = val;
      }
      __syncthreads();  // part is rewritten by the next sub-chunk
    }
  }
}

bool bad_args(int n_tiles, int k_slots, int ntx) {
  return n_tiles < 1 || k_slots < 1 || ntx < 1 || n_tiles % ntx != 0;
}

}  // namespace

extern "C" {

// tiled [n_tiles, k_slots, 16] -> out [16 * n_tiles / ntx, 16 * ntx, 8].
int xr_raster_fwd(const float* tiled, float* out, int n_tiles, int k_slots, int ntx, void* stream) {
  if (bad_args(n_tiles, k_slots, ntx)) return (int)cudaErrorInvalidValue;
  raster_fwd_kernel<kFwdPixPerThread><<<2 * n_tiles, kFwdPix / kFwdPixPerThread, 0, (cudaStream_t)stream>>>(
      tiled, out, k_slots, ntx);
  return (int)cudaGetLastError();
}

// tiled [n_tiles, k_slots, 16], gout and image (the forward's output)
// [16 * n_tiles / ntx, 16 * ntx, 8] -> dg [n_tiles, k_slots, 16] (every
// entry written).
int xr_raster_bwd(const float* tiled, const float* gout, const float* image, float* dg, int n_tiles, int k_slots,
                  int ntx, void* stream) {
  if (bad_args(n_tiles, k_slots, ntx)) return (int)cudaErrorInvalidValue;
  raster_bwd_kernel<kBwdPixPerThread><<<n_tiles, kBwdPix / kBwdPixPerThread, 0, (cudaStream_t)stream>>>(
      tiled, gout, image, dg, k_slots, ntx);
  return (int)cudaGetLastError();
}

const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
