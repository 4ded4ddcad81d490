// Row scatter-add for Hopper (sm_90a): out[idx[e], c] += g[e, c].
//
// Replaces K4, the Pallas kernel xrdslam_tpu/ops/pallas_scatter.py
// _scatter_kernel (:38), reached through scatter_add_matmul (:65), which
// computes zeros([R, C]).at[idx].add(g) as bf16 one-hot matmuls on the
// TPU's matrix unit. What that function computes on SplaTAM's path: the
// rasterizer backward adds N = 836 tiles x 256 slots = 214,016 rows of
// C = 16 into R = 131,072 gaussians, and for tables over 32,768 rows at
// C = 16 scatter_add_matmul takes its XLA-scatter branch
// (pallas_scatter.py:80-81), an exact fp32 .at[idx].add(g); only the Pallas
// body rounds g to bf16 (:59). This kernel computes the exact fp32 sum at
// every size. The size switch is a cost heuristic of the TPU and is not
// ported. Out-of-range indices are dropped, as JAX drops them.
//
// What bounds it on this card: memory. Each entry reads its index and C
// floats and adds them into a random row of the table; there is no
// arithmetic to speak of. The design reads g once, coalesced (one thread
// per (entry, channel), channel fastest, so a warp covers two whole
// 64-byte rows), and adds with fp32 atomicAdd into the output the wrapper
// zeroes (red.global.add: no return value is waited for).
//
// Zero entries are skipped. The rasterizer backward's masked slots are all
// zero and all point at row 0; adding them would pile ~10^5 atomics onto
// one 64-byte row. Skipping them changes no bit of the result: the sum
// starts at +0.0, and adding +0.0 or -0.0 to it, or to any value it can
// reach without them, returns that value.
//
// Atomic sums are not deterministic: the order of the adds into a row, and
// so the last bits of the row, change from run to run. A gaussian seen by
// several tiles gets one add per tile per channel; at SplaTAM's sizes a
// gaussian spans at most 4 x 4 tiles, so no row takes more than 16 adds
// per channel from unmasked slots.
//
// C interface (bound with ctypes): returns a cudaError_t code, 0 on
// success, after checking cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g, float* __restrict__ out,
                   int64_t n, int c_dim, int64_t num_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * c_dim) return;
  const int64_t e = t / c_dim;
  const float val = __ldg(g + t);
  if (val == 0.0f) return;
  const int64_t row = (int64_t)__ldg(idx + e);
  if (row < 0 || row >= num_rows) return;
  atomicAdd(out + row * c_dim + (t - e * c_dim), val);
}

}  // namespace

extern "C" {

// idx [n] int32, g [n, c_dim] f32 -> out [num_rows, c_dim] f32, accumulated
// into memory the caller zeroed.
int xr_scatter_add(const int32_t* idx, const float* g, float* out, long long n, int c_dim,
                   long long num_rows, void* stream) {
  if (n < 0 || c_dim < 1 || num_rows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t threads = (int64_t)n * c_dim;
  const unsigned int blocks = (unsigned int)((threads + kThreads - 1) / kThreads);
  scatter_add_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(idx, g, out, n, c_dim, num_rows);
  return (int)cudaGetLastError();
}

const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
