// Row scatter-add for Hopper (sm_90a): out = zeros([R, C]).at[idx].add(g),
// each output row summed by its owner in a fixed order.
//
// Replaces K4, the Pallas kernel xrdslam_tpu/ops/pallas_scatter.py
// _scatter_kernel (:38), reached through scatter_add_matmul (:65), which
// computes zeros([R, C]).at[idx].add(g) as bf16 one-hot matmuls on the
// TPU's matrix unit. On the TPU the grid runs in order on one core: the
// kernel keeps an output row block resident while the input blocks add into
// it in order (:38-62), and large tables take XLA's exact scatter (:80-81),
// so a run of the same inputs gives the same bits every time. Its callers
// here: the rasterizer backward (SplaTAM: 836 tiles x 256 slots = 214,016
// rows of C = 16 into 131,072 gaussians), Point-SLAM's table_lookup
// gradient (199,680 x 32 into 262,144), the packed hash's tables (C = 16)
// and the tri-plane's moment splat (C = 32). This kernel computes the exact
// fp32 sum at every size; the size switch is a cost heuristic of the TPU
// and is not ported. Out-of-range ids are dropped, as JAX drops them.
//
// Determinism. An fp32 atomicAdd sums a row in whatever order the adds
// arrive, so its last bits change from run to run; on a chaotic path
// (Point-SLAM's tracking) that spread reaches the trajectory. Here nothing
// is summed with an atomic. The entries are ordered by row first (the
// wrapper's stable sort of the ids: sorted position j holds entry perm[j],
// ties in ascending entry index), and row_ptr_kernel finds each row's
// segment [row_ptr[r], row_ptr[r+1]) of sorted positions. Then every output
// row has one owner that sums its segment in that order and writes it once
// (rows_kernel, one thread per row and vector of channels):
//   * a row of at most kPiece entries is summed entry by entry in sorted
//     order; an empty row is written as zeros, so no separate fill runs;
//   * a longer row is cut into pieces of kPiece entries counted from the
//     row's first position; a launch before (pieces_kernel) sums each piece
//     in order into a slot of partial sums, and the owner adds its pieces'
//     partials in order. A long segment is so spread over one thread per
//     piece (a segment of 10^5 entries is 782 pieces) and its sum's
//     grouping depends only on where the row starts and how long it is.
// The same ids and g give the same bits at every launch, and the ordering
// holds no state that a launch changes, so it can serve many launches
// (SplaTAM's binning serves 40 tracking or 60 mapping iterations).
//
// Zero entries add nothing to a sum in order: a sum that starts at +0.0
// never reaches -0.0 (x + -x is +0.0 in round-to-nearest), and adding +0.0
// or -0.0 to any other value returns it. So within a row of at most kPiece
// entries, leaving zeros out gives the same bits. In a longer row they also
// move the pieces' boundaries, which regroups the sum: leaving them out
// (as the rasterizer's ordering leaves out its masked slots, all zeros at
// row 0) can change the last bits, not the function.
//
// What bounds it on this card: memory. Each entry's C floats are read once,
// each output row is written once, and the ordering reads and writes the
// ids a few times; a long row's partials are written and read once more
// (a 1/kPiece share of its entries). Both summing kernels read g rows as
// float4 (a warp covers 8 rows at C = 16 and 4 at C = 32, each row a
// contiguous 64 or 128 bytes) and rows_kernel writes the table row-major,
// coalesced.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success, after checking cudaGetLastError() for the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 128;  // entries one thread sums in sequence; longer rows are cut into pieces

// row_ptr[r] = the first sorted position whose id is >= r, for r in
// [0, num_rows]: a binary search of the sorted ids per row. Ids below 0 sort
// before row_ptr[0] and ids >= num_rows after row_ptr[num_rows]: dropped.
__global__ void __launch_bounds__(kThreads)
row_ptr_kernel(const int32_t* __restrict__ keys, int64_t n, int64_t num_rows, int32_t* __restrict__ row_ptr) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > num_rows) return;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(keys + mid) < r) lo = mid + 1;
    else hi = mid;
  }
  row_ptr[r] = (int32_t)lo;
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void add(T& s, const T& v) {
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  __device__ static void store(float* p, const T& v) { *reinterpret_cast<float4*>(p) = v; }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void add(T& s, const T& v) { s += v; }
  __device__ static void store(float* p, const T& v) { *p = v; }
};

// The sum of sorted positions [a, b) of the channels [c, c + V) of g, in
// sorted order. Loads run ahead of the adds in groups of 8.
template <int V>
__device__ __forceinline__ typename Vec<V>::T sum_run(const int64_t* __restrict__ perm, const float* __restrict__ g,
                                                      int64_t a, int64_t b, int c_dim, int c) {
  using W = Vec<V>;
  typename W::T s = W::zero();
  int64_t j = a;
  for (; j + 8 <= b; j += 8) {
    typename W::T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = W::load(g + __ldg(perm + j + u) * c_dim + c);
#pragma unroll
    for (int u = 0; u < 8; ++u) W::add(s, v[u]);
  }
  for (; j < b; ++j) W::add(s, W::load(g + __ldg(perm + j) * c_dim + c));
  return s;
}

// Where a long row's piece keeps its partial sum: every window of kPiece
// sorted positions has two slots, 0 for the row at the window's first
// position and 1 for a row that starts later in the window. A row longer
// than kPiece starts at most one piece in a window (at most one such row
// starts inside it), and only its piece 0 can take slot 1.
__device__ __forceinline__ int64_t piece_slot(int64_t a, int64_t piece) {
  const int64_t start = a + piece * kPiece, w = start / kPiece;
  return 2 * w + (w * kPiece < a ? 1 : 0);
}

// One thread per (window of kPiece sorted positions, vector of channels):
// the pieces of long rows that start in the window (at most one for each of
// the rows at its two ends), each summed in sorted order into its slot.
template <int V>
__global__ void __launch_bounds__(kThreads)
pieces_kernel(const int32_t* __restrict__ keys, const int64_t* __restrict__ perm, const int32_t* __restrict__ row_ptr,
              const float* __restrict__ g, float* __restrict__ partials, int64_t n, int c_dim, int64_t num_rows) {
  const int lanes = c_dim / V;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t w = t / lanes;
  const int64_t p0 = w * kPiece;
  if (p0 >= n) return;
  const int c = (int)(t - w * lanes) * V;
  const int64_t p1 = min(p0 + kPiece, n) - 1;
  const int32_t ends[2] = {__ldg(keys + p0), __ldg(keys + p1)};
  for (int e = 0; e < 2; ++e) {
    const int32_t row = ends[e];
    if (row < 0 || row >= num_rows || (e == 1 && row == ends[0])) continue;
    const int64_t a = __ldg(row_ptr + row), b = __ldg(row_ptr + row + 1);
    if (b - a <= kPiece) continue;
    const int64_t piece = p0 <= a ? 0 : (p0 - a + kPiece - 1) / kPiece;
    const int64_t start = a + piece * kPiece;
    if (start > p1 || start >= b) continue;
    Vec<V>::store(partials + piece_slot(a, piece) * c_dim + c,
                  sum_run<V>(perm, g, start, min(start + kPiece, b), c_dim, c));
  }
}

// One thread per (row, vector of channels), the row's owner: a row of at
// most kPiece entries summed in sorted order, a longer one as the sum of
// its pieces' partials in order; every row written (an empty one as zeros).
template <int V>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int64_t* __restrict__ perm, const int32_t* __restrict__ row_ptr, const float* __restrict__ g,
            const float* __restrict__ partials, float* __restrict__ out, int c_dim, int64_t num_rows) {
  using W = Vec<V>;
  const int lanes = c_dim / V;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = t / lanes;
  if (r >= num_rows) return;
  const int c = (int)(t - r * lanes) * V;
  const int64_t a = __ldg(row_ptr + r), b = __ldg(row_ptr + r + 1);
  if (b - a <= kPiece) {
    W::store(out + r * c_dim + c, sum_run<V>(perm, g, a, b, c_dim, c));
    return;
  }
  const int64_t n_pieces = (b - a + kPiece - 1) / kPiece;
  typename W::T s = W::zero();
  int64_t i = 0;
  for (; i + 8 <= n_pieces; i += 8) {
    typename W::T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = W::load(partials + piece_slot(a, i + u) * c_dim + c);
#pragma unroll
    for (int u = 0; u < 8; ++u) W::add(s, v[u]);
  }
  for (; i < n_pieces; ++i) W::add(s, W::load(partials + piece_slot(a, i) * c_dim + c));
  W::store(out + r * c_dim + c, s);
}

template <int V>
int launch_sum(const int32_t* keys, const int64_t* perm, const int32_t* row_ptr, const float* g, float* out,
               float* partials, int64_t n, int c_dim, int64_t num_rows, cudaStream_t stream) {
  const int lanes = c_dim / V;
  const int64_t piece_threads = (n + kPiece - 1) / kPiece * lanes, row_threads = num_rows * lanes;
  if (piece_threads > 0) {
    pieces_kernel<V><<<(unsigned int)((piece_threads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        keys, perm, row_ptr, g, partials, n, c_dim, num_rows);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  rows_kernel<V><<<(unsigned int)((row_threads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      perm, row_ptr, g, partials, out, c_dim, num_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots of partial sums for n entries (each of c_dim floats): two per
// window of kPiece sorted positions.
long long xr_scatter_slots(long long n) { return 2 * ((n + kPiece - 1) / kPiece); }

// keys [n] int32: the ids sorted ascending -> row_ptr [num_rows + 1] int32.
int xr_scatter_order(const int32_t* keys, long long n, long long num_rows, int32_t* row_ptr, void* stream) {
  if (n < 0 || n >= (1ll << 31) || num_rows < 0 || num_rows >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((num_rows + 1 + kThreads - 1) / kThreads);
  row_ptr_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(keys, n, num_rows, row_ptr);
  return (int)cudaGetLastError();
}

// The ordering of xr_scatter_order (keys, perm [n] int64: the entry at each
// sorted position, row_ptr) and g [n, c_dim] f32 -> out [num_rows, c_dim]
// f32, every row written. partials: xr_scatter_slots(n) * c_dim floats of
// scratch. vec4: g and out are 16-byte aligned and c_dim % 4 == 0 (float4
// loads and stores).
int xr_scatter_sum(const int32_t* keys, const int64_t* perm, const int32_t* row_ptr, const float* g, float* out,
                   float* partials, long long n, int c_dim, long long num_rows, int vec4, void* stream) {
  if (n < 0 || n >= (1ll << 31) || c_dim < 1 || num_rows < 0 || (vec4 && c_dim % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (num_rows == 0) return 0;
  if (vec4) return launch_sum<4>(keys, perm, row_ptr, g, out, partials, n, c_dim, num_rows, (cudaStream_t)stream);
  return launch_sum<1>(keys, perm, row_ptr, g, out, partials, n, c_dim, num_rows, (cudaStream_t)stream);
}

const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
