// Streaming norm reductions for Hopper (sm_90a), bound through a plain C ABI.
//
// Replaces the two Pallas TPU kernels of slate_tpu/ops/pallas_norms.py:
//   col_reduce (pallas_call at :202)  per-column sum / max / sum-of-squares of |a|
//   row_sums   (pallas_call at :243)  per-row sums of |a|
// both under the triangle masks GE / LOWER / UPPER / LOWER_STRICT / UPPER_STRICT and
// the unit-diagonal fill of _block_abs (:94-116).
//
// Bound: each is one pass over the matrix, so the bytes bound it: m*n*itemsize read
// once at 3.35 TB/s (H100 SXM) — 0.32 ms at 16384^2 f32.  The arithmetic (an abs and
// an add or max per element) is ~100x below the card's f32 rate, but an SM must
// retire about 3 elements per cycle to keep up with HBM, so the per-element
// instruction count matters too.  Design for that:
//   * no padding copy and no per-element mask test: a thread reduces one column
//     (col_reduce) or one row (row_sums), and every triangle mask keeps an interval
//     of that line, so the mask becomes the loop bounds; the unit diagonal is one
//     element, skipped in the loop and added as 1; masked-out elements are never
//     loaded, and the inner loop is a pointer bump, a load, an abs and an add;
//   * coalesced rows: col_reduce blocks are 32 columns x 8 row lanes, so each warp
//     reads one contiguous row segment (128 B in f32); row_sums gives each row one
//     warp whose lanes stride across the columns;
//   * eight independent loads per loop trip, to keep enough bytes in flight;
//   * enough blocks for several waves: the reduced dimension is split across
//     gridDim.y until there are about 32 blocks per SM, and each split writes its own
//     row of a (splits, n|m) partial, folded afterwards by the caller (no float
//     atomics, so results are deterministic).  Without the split a 16384^2 col_reduce
//     is 1024 blocks: one wave where 8 blocks fit on an SM (op=max, 32 registers) but
//     1.3 waves where 6 fit (op=sum, 40 registers), and it then took twice as long;
//   * accumulation in the input's real type, as the Pallas kernel does.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// mask modes (pallas_norms._MODE_*); 0 (GE) keeps every element
constexpr int kModeLower = 1;
constexpr int kModeUpper = 2;
constexpr int kModeLowerStrict = 3;
constexpr int kModeUpperStrict = 4;

constexpr int kOpSum = 0;
constexpr int kOpMax = 1;
constexpr int kOpSumsq = 2;

constexpr int kColTile = 32;   // columns per col_reduce block (one warp wide)
constexpr int kRowLanes = 8;   // row lanes per col_reduce block
constexpr int kRowsPerBlock = 8;  // rows (warps) per row_sums block
constexpr int kUnroll = 8;     // independent loads per thread per loop trip

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }
__device__ __forceinline__ int64_t imax(int64_t x, int64_t y) { return x > y ? x : y; }

__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }

// max that propagates NaN like jnp.max / torch.amax
template <typename T>
__device__ __forceinline__ T nan_max(T acc, T v) {
  return (v > acc || v != v) ? v : acc;
}

template <typename T, int OP>
__device__ __forceinline__ T accumulate(T acc, T v) {
  if (OP == kOpMax) return nan_max(acc, v);
  if (OP == kOpSumsq) return acc + v * v;
  return acc + v;
}

template <typename T, int OP>
__device__ __forceinline__ T fold(T x, T y) {
  return OP == kOpMax ? nan_max(x, y) : x + y;
}

// Accumulate |p[0]|, |p[step]|, ... (count elements), kUnroll loads in flight.
template <typename T, int OP>
__device__ __forceinline__ T strip(T acc, const T* __restrict__ p, int64_t step,
                                   int64_t count) {
  int64_t i = 0;
  for (; i + kUnroll <= count; i += kUnroll, p += kUnroll * step) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = absval(p[u * step]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = accumulate<T, OP>(acc, v[u]);
  }
  for (; i < count; ++i, p += step) acc = accumulate<T, OP>(acc, absval(*p));
  return acc;
}

// Accumulate the elements of one line (a column or a row) whose index k lies in
// [lo, hi) and is one of this thread's: k = base + j*stride.  Element k sits at
// line + k*k_step.  If this thread owns index diag (the unit diagonal; -1 for
// none), that element is not read and counts as 1, whatever the mask.
template <typename T, int OP>
__device__ __forceinline__ T reduce_line(const T* __restrict__ line, int64_t k_step,
                                         int64_t base, int stride, int64_t lo,
                                         int64_t hi, int64_t diag) {
  const bool own_diag = diag >= base && (diag - base) % stride == 0;
  const int64_t cut_lo = own_diag ? imin(hi, diag) : hi;      // [lo, cut_lo)
  const int64_t cut_hi = own_diag ? imax(lo, diag + 1) : hi;  // [cut_hi, hi)
  T acc = T(0);
  int64_t segs[2][2] = {{lo, cut_lo}, {cut_hi, hi}};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int64_t b = segs[s][0], e = segs[s][1];
    const int64_t first = b <= base ? base : base + (b - base + stride - 1) / stride * stride;
    if (e > first)
      acc = strip<T, OP>(acc, line + first * k_step, stride * k_step,
                         (e - first + stride - 1) / stride);
  }
  return own_diag ? accumulate<T, OP>(acc, T(1)) : acc;
}

// grid (ceil(n/32), splits), block (32, 8).  Split s covers rows
// [s*rows_per_split, min(m, (s+1)*rows_per_split)); thread (tx, ty) reduces rows
// r0+ty, r0+ty+8, ... of column c; the 8 lanes fold in shared memory and the
// block writes out[s, c].  The mask keeps the rows: LOWER r >= c, UPPER r <= c,
// LOWER_STRICT r > c, UPPER_STRICT r < c.
template <typename T, int OP>
__global__ void __launch_bounds__(kColTile * kRowLanes)
col_reduce_kernel(const T* __restrict__ a, int64_t m, int64_t n, int64_t lda,
                  int mode, int unit_diag, int64_t rows_per_split,
                  T* __restrict__ out) {
  __shared__ T part[kRowLanes][kColTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t c = (int64_t)blockIdx.x * kColTile + tx;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = imin(m, r0 + rows_per_split);
  T acc = T(0);
  if (c < n) {
    int64_t lo = r0, hi = r1;
    if (mode == kModeLower) lo = imax(lo, c);
    if (mode == kModeLowerStrict) lo = imax(lo, c + 1);
    if (mode == kModeUpper) hi = imin(hi, c + 1);
    if (mode == kModeUpperStrict) hi = imin(hi, c);
    const int64_t diag = (unit_diag && c >= r0 && c < r1) ? c : -1;
    acc = reduce_line<T, OP>(a + c, lda, r0 + ty, kRowLanes, lo, hi, diag);
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < n) {
    T s = part[0][tx];
#pragma unroll
    for (int k = 1; k < kRowLanes; ++k) s = fold<T, OP>(s, part[k][tx]);
    out[(int64_t)blockIdx.y * n + c] = s;
  }
}

// grid (ceil(m/8), splits), block 256: warp w of block b reduces row r = b*8 + w
// over columns [s*cols_per_split, min(n, (s+1)*cols_per_split)), lane l taking
// columns c0+l, c0+l+32, ..., and writes out[s, r].  The mask keeps the columns:
// LOWER c <= r, UPPER c >= r, LOWER_STRICT c < r, UPPER_STRICT c > r.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
row_sums_kernel(const T* __restrict__ a, int64_t m, int64_t n, int64_t lda,
                int mode, int unit_diag, int64_t cols_per_split,
                T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= m) return;  // the whole warp leaves together; no block barrier follows
  const int64_t c0 = (int64_t)blockIdx.y * cols_per_split;
  const int64_t c1 = imin(n, c0 + cols_per_split);
  int64_t lo = c0, hi = c1;
  if (mode == kModeLower) hi = imin(hi, r + 1);
  if (mode == kModeLowerStrict) hi = imin(hi, r);
  if (mode == kModeUpper) lo = imax(lo, r);
  if (mode == kModeUpperStrict) lo = imax(lo, r + 1);
  const int64_t diag = (unit_diag && r >= c0 && r < c1) ? r : -1;
  T acc = reduce_line<T, kOpSum>(a + r * lda, 1, c0 + lane, 32, lo, hi, diag);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(int64_t)blockIdx.y * m + r] = acc;
}

template <typename T>
int launch_col_reduce(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                      int unit_diag, int op, int64_t rows_per_split, int splits,
                      void* out, void* stream) {
  const dim3 block(kColTile, kRowLanes);
  const dim3 grid((unsigned)((n + kColTile - 1) / kColTile), (unsigned)splits);
  cudaStream_t s = (cudaStream_t)stream;
  const T* src = (const T*)a;
  T* dst = (T*)out;
  switch (op) {
    case kOpSum:
      col_reduce_kernel<T, kOpSum><<<grid, block, 0, s>>>(
          src, m, n, lda, mode, unit_diag, rows_per_split, dst);
      break;
    case kOpMax:
      col_reduce_kernel<T, kOpMax><<<grid, block, 0, s>>>(
          src, m, n, lda, mode, unit_diag, rows_per_split, dst);
      break;
    case kOpSumsq:
      col_reduce_kernel<T, kOpSumsq><<<grid, block, 0, s>>>(
          src, m, n, lda, mode, unit_diag, rows_per_split, dst);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_row_sums(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                    int unit_diag, int64_t cols_per_split, int splits, void* out,
                    void* stream) {
  const dim3 block(32 * kRowsPerBlock);
  const dim3 grid((unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)splits);
  row_sums_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)a, m, n, lda, mode, unit_diag, cols_per_split, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_col_reduce_f32(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                         int unit_diag, int op, int64_t rows_per_split, int splits,
                         void* out, void* stream) {
  return launch_col_reduce<float>(a, m, n, lda, mode, unit_diag, op,
                                  rows_per_split, splits, out, stream);
}

int slate_col_reduce_f64(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                         int unit_diag, int op, int64_t rows_per_split, int splits,
                         void* out, void* stream) {
  return launch_col_reduce<double>(a, m, n, lda, mode, unit_diag, op,
                                   rows_per_split, splits, out, stream);
}

int slate_row_sums_f32(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                       int unit_diag, int64_t cols_per_split, int splits, void* out,
                       void* stream) {
  return launch_row_sums<float>(a, m, n, lda, mode, unit_diag, cols_per_split,
                                splits, out, stream);
}

int slate_row_sums_f64(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                       int unit_diag, int64_t cols_per_split, int splits, void* out,
                       void* stream) {
  return launch_row_sums<double>(a, m, n, lda, mode, unit_diag, cols_per_split,
                                 splits, out, stream);
}

}  // extern "C"
