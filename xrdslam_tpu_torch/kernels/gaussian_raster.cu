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
//   running product; every slot is composited, with no early stop.
// The backward forms suffix_k = total - inclusive_prefix_k of
// contrib = (gout . ch_k) * w_k (_suffix_sum, :229-232): one pass over the
// slots for total, a second for the gradients, so the cancellation is the
// reference's. dalpha is zeroed where the raw alpha exceeds 0.99 or the
// mask is off.
//
// What bounds it on this card: operations. At SplaTAM's full width (836
// tiles, K = 256) a render is 54.8 M (pixel, slot) pairs with an exp and a
// log1p each (the backward does both passes, so twice that), against
// 13.7 MB of tile data: well above the card's operations-per-byte line.
// Design: one block per 16x16 tile, one thread per pixel (256 threads),
// walking the slots front to back. Slots are staged 256 at a time in shared
// memory (16 KB), so every thread reads the same slot at once (a broadcast,
// no bank conflicts) and the tile data is read from device memory once per
// pass. The backward's per-slot sums over the tile's 256 pixels (12 values:
// u, v, sigma, opacity terms and 8 channels) are warp shuffles, then 8 warp
// partials per slot in shared memory (12 KB for 32 slots), summed by the
// block once per 32 slots, so a block synchronises 2 times per 32 slots
// instead of per slot. Nothing is atomic: each slot's row is written by one
// block, and the backward is deterministic.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success, after checking cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block, one per pixel
constexpr int kRow = 16;             // floats per slot
constexpr int kCh = 8;
constexpr int kChunk = 256;          // slots staged in shared memory at once
constexpr int kSub = 32;             // slots per block-wide reduction in the backward
constexpr int kWarps = kPix / 32;
constexpr int kVals = 4 + kCh;       // per-slot sums: u, v, sigma, opacity terms, channels
constexpr float kAlphaMax = 0.99f;

struct Slot {
  float u, v, sig, op;
  bool on;
};

__device__ __forceinline__ Slot read_slot(const float* s) {
  return Slot{s[0], s[1], s[2], s[3], s[4] > 0.5f};
}

// Stage slots [base, base + n) of a tile into shared memory as float4s.
__device__ __forceinline__ void stage(float4* dst, const float4* src, int base, int n) {
  for (int i = threadIdx.x; i < n * (kRow / 4); i += kPix) dst[i] = src[(int64_t)base * (kRow / 4) + i];
}

__global__ void __launch_bounds__(kPix)
raster_fwd_kernel(const float* __restrict__ tiled, float* __restrict__ out, int k_slots, int ntx) {
  __shared__ float4 sg[kChunk * (kRow / 4)];
  const int tile = blockIdx.x;
  const int lin = threadIdx.x;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int ipx = tx * kTile + (lin % kTile), ipy = ty * kTile + lin / kTile;
  const float px = (float)ipx, py = (float)ipy;
  const float4* src = reinterpret_cast<const float4*>(tiled + (int64_t)tile * k_slots * kRow);
  float acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
  float log_t = 0.0f;  // sum of log1p(-alpha) over the slots before this one
  for (int base = 0; base < k_slots; base += kChunk) {
    const int n = min(kChunk, k_slots - base);
    __syncthreads();  // the previous chunk is no longer read
    stage(sg, src, base, n);
    __syncthreads();
    const float* s = reinterpret_cast<const float*>(sg);
    for (int j = 0; j < n; ++j, s += kRow) {
      const Slot g = read_slot(s);
      const float du = px - g.u, dv = py - g.v;
      const float inv2s2 = 0.5f / fmaxf(g.sig * g.sig, 1e-12f);
      const float gauss = expf(-(du * du + dv * dv) * inv2s2);
      const float alpha = g.on ? fminf(fmaxf(g.op * gauss, 0.0f), kAlphaMax) : 0.0f;
      const float w = alpha * expf(log_t);
#pragma unroll
      for (int c = 0; c < kCh; ++c) acc[c] += s[5 + c] * w;
      log_t += log1pf(-alpha);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + ((int64_t)ipy * ntx * kTile + ipx) * kCh);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kPix)
raster_bwd_kernel(const float* __restrict__ tiled, const float* __restrict__ gout, float* __restrict__ dg,
                  int k_slots, int ntx) {
  __shared__ float4 sg[kChunk * (kRow / 4)];
  __shared__ float part[kWarps][kSub][kVals];
  const int tile = blockIdx.x;
  const int lin = threadIdx.x;
  const int warp = lin / 32, lane = lin % 32;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int ipx = tx * kTile + (lin % kTile), ipy = ty * kTile + lin / kTile;
  const float px = (float)ipx, py = (float)ipy;
  const float4* src = reinterpret_cast<const float4*>(tiled + (int64_t)tile * k_slots * kRow);
  float* dst = dg + (int64_t)tile * k_slots * kRow;
  float go[kCh];
  {
    const float4* gp = reinterpret_cast<const float4*>(gout + ((int64_t)ipy * ntx * kTile + ipx) * kCh);
    const float4 a = gp[0], b = gp[1];
    go[0] = a.x; go[1] = a.y; go[2] = a.z; go[3] = a.w;
    go[4] = b.x; go[5] = b.y; go[6] = b.z; go[7] = b.w;
  }

  // pass 1: total = sum over all slots of contrib = (gout . ch) * w
  float total = 0.0f, log_t = 0.0f;
  for (int base = 0; base < k_slots; base += kChunk) {
    const int n = min(kChunk, k_slots - base);
    __syncthreads();
    stage(sg, src, base, n);
    __syncthreads();
    const float* s = reinterpret_cast<const float*>(sg);
    for (int j = 0; j < n; ++j, s += kRow) {
      const Slot g = read_slot(s);
      const float du = px - g.u, dv = py - g.v;
      const float inv2s2 = 0.5f / fmaxf(g.sig * g.sig, 1e-12f);
      const float gauss = expf(-(du * du + dv * dv) * inv2s2);
      const float alpha = g.on ? fminf(fmaxf(g.op * gauss, 0.0f), kAlphaMax) : 0.0f;
      const float w = alpha * expf(log_t);
      float gdotc = 0.0f;
#pragma unroll
      for (int c = 0; c < kCh; ++c) gdotc += go[c] * s[5 + c];
      total += gdotc * w;
      log_t += log1pf(-alpha);
    }
  }

  // pass 2: per-slot gradients, summed over the tile's pixels
  float prefix = 0.0f;
  log_t = 0.0f;
  for (int base = 0; base < k_slots; base += kChunk) {
    const int n = min(kChunk, k_slots - base);
    __syncthreads();
    stage(sg, src, base, n);
    __syncthreads();
    for (int sub = 0; sub < n; sub += kSub) {
      const int m = min(kSub, n - sub);
      for (int jj = 0; jj < m; ++jj) {
        const float* s = reinterpret_cast<const float*>(sg) + (sub + jj) * kRow;
        const Slot g = read_slot(s);
        const float du = px - g.u, dv = py - g.v;
        const float sig2 = fmaxf(g.sig * g.sig, 1e-12f);
        const float inv2s2 = 0.5f / sig2;
        const float r2 = du * du + dv * dv;
        const float gauss = expf(-r2 * inv2s2);
        const float raw_alpha = g.op * gauss;
        const float alpha = g.on ? fminf(fmaxf(raw_alpha, 0.0f), kAlphaMax) : 0.0f;
        const float t_k = expf(log_t);
        const float w = alpha * t_k;
        float gdotc = 0.0f;
#pragma unroll
        for (int c = 0; c < kCh; ++c) gdotc += go[c] * s[5 + c];
        prefix += gdotc * w;
        const float suffix = total - prefix;
        float dalpha = t_k * gdotc - suffix / fmaxf(1.0f - alpha, 1e-6f);
        if (raw_alpha > kAlphaMax || !g.on) dalpha = 0.0f;
        const float d_common = dalpha * g.op * gauss;
        float vals[kVals];
        vals[0] = d_common * du;
        vals[1] = d_common * dv;
        vals[2] = d_common * r2;
        vals[3] = dalpha * gauss;
#pragma unroll
        for (int c = 0; c < kCh; ++c) vals[4 + c] = go[c] * w;
#pragma unroll
        for (int q = 0; q < kVals; ++q) {
          const float r = warp_sum(vals[q]);
          if (lane == 0) part[warp][jj][q] = r;
        }
        log_t += log1pf(-alpha);
      }
      __syncthreads();
      // one output value per thread: slot jj, value q, summed over the warps
      for (int o = lin; o < m * kRow; o += kPix) {
        const int jj = o / kRow, col = o - jj * kRow;
        const float* s = reinterpret_cast<const float*>(sg) + (sub + jj) * kRow;
        const Slot g = read_slot(s);
        float val = 0.0f;
        const int q = col < 4 ? col : col - 1;  // column 4 is the mask's: no gradient
        if (g.on && col != 4 && q < kVals) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) val += part[w][jj][q];
          const float sig2 = fmaxf(g.sig * g.sig, 1e-12f);
          if (col < 2) val = val / sig2;
          else if (col == 2) val = val / (sig2 * fmaxf(g.sig, 1e-6f));
        }
        dst[(int64_t)(base + sub + jj) * kRow + col] = val;
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
  raster_fwd_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(tiled, out, k_slots, ntx);
  return (int)cudaGetLastError();
}

// tiled [n_tiles, k_slots, 16], gout [16 * n_tiles / ntx, 16 * ntx, 8]
// -> dg [n_tiles, k_slots, 16] (every entry written).
int xr_raster_bwd(const float* tiled, const float* gout, float* dg, int n_tiles, int k_slots, int ntx,
                  void* stream) {
  if (bad_args(n_tiles, k_slots, ntx)) return (int)cudaErrorInvalidValue;
  raster_bwd_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(tiled, gout, dg, k_slots, ntx);
  return (int)cudaGetLastError();
}

const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
