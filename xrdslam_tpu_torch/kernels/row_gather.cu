// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :].
//
// Replaces K7, the Pallas kernels of xrdslam_tpu/ops/row_gather.py:
// _flat_kernel (:47, pallas_call :86), one DMA per row of a flat table
// whose width is a multiple of 1024 elements, and _kernel (:29,
// pallas_call :102), the same for rows exactly 128 wide. Both compute
// table[idx]; this kernel serves every width divisible by 4. Its one caller
// is Point-SLAM's spatial-hash kNN (xrdslam_tpu/ops/point_table.py:195),
// which gathers one 1024-float union row per query: 24,960 queries per
// mapping iteration, 7,500 per tracking iteration.
//
// The rows carry int32 point ids bitcast to float32 (point_table.py:126).
// An id below 2^23 is a denormal float, so the kernel moves bits and does
// no arithmetic on them: 16-byte words (int4) loaded and stored as they
// are, which no flush-to-zero mode can touch.
//
// What bounds it on this card: memory. It reads each gathered row and
// writes it once (4 KiB each way at width 1024) and computes nothing. The
// design gives each output row to one warp: lane l copies words l, l + 32,
// ... of the row, so a warp's load and store each cover 512 contiguous
// bytes, and eight 16-byte loads per lane are in flight at width 1024
// before the first store. Rows the TPU kernel would read out of range
// (ids outside [0, num_rows)) are written as zeros here and in the twin.
//
// C interface (bound with ctypes): returns a cudaError_t code, 0 on
// success, after checking cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kUnroll = 8;  // 16-byte words per lane in flight (a 1024-float row)

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int4* __restrict__ table, const int32_t* __restrict__ idx, int4* __restrict__ out,
                  int64_t n, int64_t words, int64_t num_rows) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int64_t src_row = (int64_t)__ldg(idx + row);
  int4* dst = out + row * words;
  if (src_row < 0 || src_row >= num_rows) {
    const int4 zero = make_int4(0, 0, 0, 0);
    for (int64_t w = lane; w < words; w += 32) dst[w] = zero;
    return;
  }
  const int4* src = table + src_row * words;
  int64_t w = lane;
  for (; w + 32 * (kUnroll - 1) < words; w += 32 * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(src + w + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[w + 32 * u] = v[u];
  }
  for (; w < words; w += 32) dst[w] = __ldg(src + w);
}

}  // namespace

extern "C" {

// table [num_rows, width] f32 (or any 4-byte type), idx [n] int32 ->
// out [n, width]; width % 4 == 0 and both pointers 16-byte aligned.
int xr_row_gather(const void* table, const int32_t* idx, void* out, long long n, long long width,
                  long long num_rows, void* stream) {
  if (n < 0 || width < 0 || width % 4 != 0 || num_rows < 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)table | (uintptr_t)out) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (n == 0 || width == 0) return 0;
  const unsigned int blocks = (unsigned int)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  row_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)table, idx, (int4*)out, n, width / 4, num_rows);
  return (int)cudaGetLastError();
}

const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
