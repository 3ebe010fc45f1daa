// Streaming norm reductions for Hopper (sm_90a), bound through a plain C ABI.
//
// Replaces the two Pallas TPU kernels of slate_tpu/ops/pallas_norms.py:
//   col_reduce (pallas_call at :202)  per-column sum / max / sum-of-squares of |a|
//   row_sums   (pallas_call at :243)  per-row sums of |a|
// both under the triangle masks GE / LOWER / UPPER / LOWER_STRICT / UPPER_STRICT and
// the unit-diagonal fill of _block_abs (:94-116).
//
// What bounds them: each is one pass over the matrix, so the bytes do: m*n*itemsize
// read once at 3.35 TB/s (H100 SXM), 0.32 ms at 16384^2 f32.  The arithmetic (an abs
// and an add or max per element) is ~100x below the card's rate, but with one load
// instruction per element an SM must retire about 3 loads per cycle to keep up with
// HBM, so the load instructions per byte, the bytes in flight and the order in which
// the rows stream decide how close a kernel comes to the bound.  The design:
//
//   1. 16-byte loads.  A thread loads V = 16 / itemsize adjacent elements at once
//      (float4 / double2), kUnroll = 8 loads (128 bytes) in flight, 32 KB a block.
//      col_reduce: a thread owns V adjacent columns, a warp 32*V columns (512
//      contiguous bytes of a row per warp load), and the block's 8 warps are row
//      lanes, so the blocks of one split read whole rows together.  row_sums: a row
//      has a team of WPR warps whose threads take consecutive 16-byte pieces of it, so
//      a long row (WPR = 8, one row per block) streams 4 KB contiguous per block load
//      step, and its loads ask L2 for the whole 256-byte block around them (the
//      .L2::256B prefetch size); rows shorter than one team trip share a block, up to
//      8 of them.  A cp.async / TMA ring through shared memory was not tried: these
//      plain loads already keep several times the bytes in flight per SM that
//      Little's law asks for at the HBM rate.
//   2. Masks are loop bounds.  A triangle mask keeps one interval of each column or
//      row.  col_reduce: for the V columns c0..c0+V-1 of a thread the masks differ
//      only on the rows of the band [c0, c0+V); rows below it are kept by GE / UPPER
//      / UPPER_STRICT for all V columns, rows above it by GE / LOWER / LOWER_STRICT.
//      So the rows outside the band are whole vector loads, and the band (at most V
//      rows, one per warp) is done with per-element predicates, which also skip the
//      unit diagonal.  row_sums: the kept interval [lo, hi) of a row is cut at
//      V-aligned columns; the aligned groups inside it are vector loads except the
//      group that holds the diagonal, and the ragged head, the ragged tail and that
//      group (each at most V elements, one per thread) are per-element predicates.
//      A unit diagonal is never read and counts as 1 in the split that holds it.  A
//      masked-out element is never loaded.
//   3. Never past the view.  A group of V columns that reaches past the view's width
//      n is loaded element by element (only its columns < n), and row_sums' tail stops
//      at n, so a view whose row stride exceeds its width reads nothing beyond it.
//      The V-wide instantiations need a 16-byte aligned base and row pitch; the
//      wrapper picks the V = 1 instantiation of the same kernels otherwise, and the
//      entry points refuse a V > 1 launch on an unaligned input.
//   4. The fold of the splits inside the launch.  The reduced dimension is split
//      across gridDim.y until there are about 32 blocks per SM (several waves, so a
//      partly filled last wave costs little).  A block writes its tile's values to
//      row blockIdx.y of a (splits x kept) partial, bumps an integer counter of its
//      tile, and the block that brings the counter to `splits` folds the partial in
//      a fixed order of split indices (kThreads / tile chunks of consecutive splits,
//      each folded in split order, then the chunks in a fixed pairwise tree), writes
//      the result and resets the counter to 0 for the next call on its stream.  No
//      float atomics: two calls on one input give bitwise the same result.  One
//      launch per wrapper call; with one split the block writes the result directly.
//      (A thread-block cluster folding through distributed shared memory would hold
//      at most 8-16 splits, too few for tall-skinny inputs, so one mechanism serves
//      every shape; at 16384^2 the partial is ~0.2 % of the bytes and stays in L2.)
//   5. Accumulation in the input's real type, as the Pallas kernel does.
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

constexpr int kThreads = 256;         // threads per block, both kernels
constexpr int kWarps = kThreads / 32;  // col_reduce: row lanes; row_sums: up to 8 rows
constexpr int kUnroll = 8;            // independent loads per thread per loop trip

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

__device__ __forceinline__ bool keep(int mode, int64_t r, int64_t c) {
  switch (mode) {
    case kModeLower: return r >= c;
    case kModeUpper: return r <= c;
    case kModeLowerStrict: return r > c;
    case kModeUpperStrict: return r < c;
    default: return true;
  }
}

// V adjacent elements of one line
template <typename T, int V>
struct Pack {
  T v[V];
};

// One load of V adjacent elements: a single 16-byte load where V * sizeof(T) == 16
// (p must then be 16-byte aligned), a plain load for V == 1.
template <typename T, int V>
struct Load;
// With L2_256 the load also asks L2 to fetch the whole 256-byte block around it (the
// .L2::256B prefetch size): a row's next bytes.
template <typename T>
struct Load<T, 1> {
  template <bool L2_256>
  static __device__ __forceinline__ Pack<T, 1> full(const T* p) { return {{__ldg(p)}}; }
};
template <>
struct Load<float, 4> {
  template <bool L2_256>
  static __device__ __forceinline__ Pack<float, 4> full(const float* p) {
    float4 q;
    if (L2_256)
      asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
          : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
          : "l"(p));
    else
      q = __ldg(reinterpret_cast<const float4*>(p));
    return {{q.x, q.y, q.z, q.w}};
  }
};
template <>
struct Load<double, 2> {
  template <bool L2_256>
  static __device__ __forceinline__ Pack<double, 2> full(const double* p) {
    double2 q;
    if (L2_256)
      asm("ld.global.nc.L1::no_allocate.L2::256B.v2.f64 {%0, %1}, [%2];"
          : "=d"(q.x), "=d"(q.y)
          : "l"(p));
    else
      q = __ldg(reinterpret_cast<const double2*>(p));
    return {{q.x, q.y}};
  }
};

// The first nv (< V) elements of a group that reaches past the view's width, one
// load each; the rest read as 0, which no op can tell from an absent element.
template <typename T, int V, bool FULL, bool L2_256>
__device__ __forceinline__ Pack<T, V> load_group(const T* p, int nv) {
  if (FULL) return Load<T, V>::template full<L2_256>(p);
  Pack<T, V> g;
#pragma unroll
  for (int j = 0; j < V; ++j) g.v[j] = j < nv ? __ldg(p + j) : T(0);
  return g;
}

// acc[j] <- op over k < count of |p[k*step + j]|, kUnroll group loads in flight; the
// last partial trip is predicated, so it too keeps its loads in flight.
template <typename T, int V, int OP, bool FULL, bool L2_256 = false>
__device__ __forceinline__ void strip(T (&acc)[V], const T* __restrict__ p, int64_t step,
                                      int64_t count, int nv) {
  int64_t i = 0;
  for (; i + kUnroll <= count; i += kUnroll, p += kUnroll * step) {
    Pack<T, V> g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) g[u] = load_group<T, V, FULL, L2_256>(p + u * step, nv);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = accumulate<T, OP>(acc[j], absval(g[u].v[j]));
  }
  if (i < count) {
    Pack<T, V> g[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u < count) g[u] = load_group<T, V, FULL, L2_256>(p + u * step, nv);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = accumulate<T, OP>(acc[j], absval(g[u].v[j]));
  }
}

// The tile's W values (thread t < W holds value t, for kept index blockIdx.x*W + t)
// go to out; with several splits, through the partial and the last block's fold.
template <typename T, int OP, int W>
__device__ __forceinline__ void finish(T value, int64_t kept, T* __restrict__ partial,
                                       int* __restrict__ counters, T* __restrict__ out) {
  __shared__ T chunk[kThreads];
  __shared__ int is_last;
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * W;
  const int width = (int)imin(W, kept - base);
  const int splits = (int)gridDim.y;
  if (splits == 1) {
    if (t < width) out[base + t] = value;
    return;
  }
  if (t < width) partial[(int64_t)blockIdx.y * kept + base + t] = value;
  __threadfence();  // the partial is visible device-wide before the counter moves
  __syncthreads();
  if (t == 0) is_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();  // and this block sees every split's partial
  constexpr int K = kThreads / W;  // chunks of consecutive splits per value (a power of 2)
  const int j = t % W, k = t / W;
  const int s_lo = k * splits / K, s_hi = (k + 1) * splits / K;
  T acc = T(0);
  if (j < width) {
    const T* p = partial + base + j;
    int s = s_lo;
    for (; s + kUnroll <= s_hi; s += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(p + (int64_t)(s + u) * kept);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = fold<T, OP>(acc, v[u]);
    }
    for (; s < s_hi; ++s) acc = fold<T, OP>(acc, __ldcg(p + (int64_t)s * kept));
  }
  chunk[t] = acc;
#pragma unroll
  for (int half = K / 2; half > 0; half /= 2) {
    __syncthreads();
    if (k < half) chunk[t] = fold<T, OP>(chunk[t], chunk[t + half * W]);
  }
  if (t < width) out[base + t] = chunk[t];
  if (t == 0) counters[blockIdx.x] = 0;
}

// grid (ceil(n / (32 V)), splits), block 256.  Split s covers rows
// [s*rows_per_split, min(m, (s+1)*rows_per_split)); lane l of warp w owns columns
// c0 = blockIdx.x*32V + l*V .. c0+V-1 and rows w, w+8, ... of each row segment.
// The mask keeps the rows: LOWER r >= c, UPPER r <= c, LOWER_STRICT r > c,
// UPPER_STRICT r < c.
template <typename T, int V, int OP>
__global__ void __launch_bounds__(kThreads)
col_reduce_kernel(const T* __restrict__ a, int64_t m, int64_t n, int64_t lda, int mode,
                  int unit_diag, int64_t rows_per_split, T* __restrict__ partial,
                  int* __restrict__ counters, T* __restrict__ out) {
  constexpr int kTile = 32 * V;
  __shared__ T part[kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t c0 = (int64_t)blockIdx.x * kTile + lane * V;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = imin(m, r0 + rows_per_split);
  T acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = T(0);
  if (c0 < n) {
    const int nv = (int)imin(V, n - c0);
    const bool below = mode == 0 || mode == kModeUpper || mode == kModeUpperStrict;
    const bool above = mode == 0 || mode == kModeLower || mode == kModeLowerStrict;
    // rows [r0, c0) and [c0 + V, r1): the same mask for all V columns
    const int64_t seg[2][2] = {{r0, below ? imin(r1, c0) : r0},
                               {imax(r0, c0 + V), above ? r1 : r0}};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int64_t first = seg[s][0] + w;
      if (first < seg[s][1]) {
        const T* p = a + first * lda + c0;
        const int64_t count = (seg[s][1] - first + kWarps - 1) / kWarps;
        if (nv == V)
          strip<T, V, OP, true>(acc, p, kWarps * lda, count, V);
        else
          strip<T, V, OP, false>(acc, p, kWarps * lda, count, nv);
      }
    }
    // the band [c0, c0 + V): one row per warp, element by element
    const int64_t r = imax(r0, c0) + w;
    if (r < imin(r1, c0 + V)) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int64_t c = c0 + j;
        if (j < nv && keep(mode, r, c) && !(unit_diag && r == c))
          acc[j] = accumulate<T, OP>(acc[j], absval(a[r * lda + c]));
      }
    }
    if (unit_diag && w == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < nv && c0 + j >= r0 && c0 + j < r1) acc[j] = accumulate<T, OP>(acc[j], T(1));
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[w][lane * V + j] = acc[j];
  __syncthreads();
  T value = T(0);
  if (threadIdx.x < kTile) {
    value = part[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) value = fold<T, OP>(value, part[q][threadIdx.x]);
  }
  finish<T, OP, kTile>(value, n, partial, counters, out);
}

// grid (ceil(m / (8 / WPR)), splits), block 256: a block sums 8 / WPR rows, each with
// a team of WPR warps, over columns [s*cols_per_split, min(n, (s+1)*cols_per_split)).
// The mask keeps the columns: LOWER c <= r, UPPER c >= r, LOWER_STRICT c < r,
// UPPER_STRICT c > r.
template <typename T, int V, int WPR>
__global__ void __launch_bounds__(kThreads)
row_sums_kernel(const T* __restrict__ a, int64_t m, int64_t n, int64_t lda, int mode,
                int unit_diag, int64_t cols_per_split, T* __restrict__ partial,
                int* __restrict__ counters, T* __restrict__ out) {
  constexpr int kRows = kWarps / WPR;  // rows per block
  constexpr int kTeam = 32 * WPR;      // threads per row
  __shared__ T warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int tr = threadIdx.x % kTeam;  // this thread's rank in its row's team
  const int64_t r = (int64_t)blockIdx.x * kRows + threadIdx.x / kTeam;
  const int64_t c_lo = (int64_t)blockIdx.y * cols_per_split;
  const int64_t c_hi = imin(n, c_lo + cols_per_split);
  T sum = T(0);
  if (r < m) {
    int64_t lo = c_lo, hi = c_hi;
    if (mode == kModeLower) hi = imin(hi, r + 1);
    if (mode == kModeLowerStrict) hi = imin(hi, r);
    if (mode == kModeUpper) lo = imax(lo, r);
    if (mode == kModeUpperStrict) lo = imax(lo, r + 1);
    const T* row = a + r * lda;
    // [A, B): the V-aligned groups inside [lo, hi); [g, g + V): the diagonal's group
    const int64_t A = imin((lo + V - 1) / V * V, hi);
    const int64_t B = imax(hi / V * V, A);
    const int64_t g = r / V * V;
    const bool hole = A <= g && g + V <= B;
    const int64_t seg[2][2] = {{A, hole ? g : B}, {hole ? g + V : B, B}};
    T acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = T(0);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int64_t groups = (seg[s][1] - seg[s][0]) / V;
      if (tr < groups)
        strip<T, V, kOpSum, true, true>(acc, row + seg[s][0] + tr * V, kTeam * V,
                                        (groups - tr + kTeam - 1) / kTeam, V);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) sum += acc[j];
    // the ragged head, the ragged tail and the diagonal's group: an element a thread
    const int64_t pred[3][2] = {{lo, A}, {B, hi}, {g, hole ? g + V : g}};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int64_t c = pred[s][0] + tr;
      if (c < pred[s][1] && !(unit_diag && c == r)) sum += absval(row[c]);
    }
    if (unit_diag && tr == 0 && r >= c_lo && r < c_hi) sum += T(1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  T value = T(0);
  if (threadIdx.x < kRows) {
    value = warp_sums[threadIdx.x * WPR];
#pragma unroll
    for (int q = 1; q < WPR; ++q) value += warp_sums[threadIdx.x * WPR + q];
  }
  finish<T, kOpSum, kRows>(value, m, partial, counters, out);
}

template <typename T>
bool aligned16(const void* a, int64_t lda) {
  return (uintptr_t)a % 16 == 0 && (lda * (int64_t)sizeof(T)) % 16 == 0;
}

template <typename T, int V>
int launch_col_reduce(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                      int unit_diag, int op, int64_t rows_per_split, int splits,
                      void* partial, void* counters, void* out, cudaStream_t s) {
  const dim3 grid((unsigned)((n + 32 * V - 1) / (32 * V)), (unsigned)splits);
  const T* src = (const T*)a;
  T* part = (T*)partial;
  int* ctr = (int*)counters;
  T* dst = (T*)out;
  switch (op) {
    case kOpSum:
      col_reduce_kernel<T, V, kOpSum><<<grid, kThreads, 0, s>>>(
          src, m, n, lda, mode, unit_diag, rows_per_split, part, ctr, dst);
      break;
    case kOpMax:
      col_reduce_kernel<T, V, kOpMax><<<grid, kThreads, 0, s>>>(
          src, m, n, lda, mode, unit_diag, rows_per_split, part, ctr, dst);
      break;
    case kOpSumsq:
      col_reduce_kernel<T, V, kOpSumsq><<<grid, kThreads, 0, s>>>(
          src, m, n, lda, mode, unit_diag, rows_per_split, part, ctr, dst);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int V, int WPR>
int launch_row_sums(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                    int unit_diag, int64_t cols_per_split, int splits, void* partial,
                    void* counters, void* out, cudaStream_t s) {
  constexpr int kRows = kWarps / WPR;
  const dim3 grid((unsigned)((m + kRows - 1) / kRows), (unsigned)splits);
  row_sums_kernel<T, V, WPR><<<grid, kThreads, 0, s>>>(
      (const T*)a, m, n, lda, mode, unit_diag, cols_per_split, (T*)partial,
      (int*)counters, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_row_sums(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                    int unit_diag, int64_t cols_per_split, int splits, int wpr,
                    void* partial, void* counters, void* out, cudaStream_t s) {
  switch (wpr) {
    case 1:
      return launch_row_sums<T, V, 1>(a, m, n, lda, mode, unit_diag, cols_per_split,
                                      splits, partial, counters, out, s);
    case 2:
      return launch_row_sums<T, V, 2>(a, m, n, lda, mode, unit_diag, cols_per_split,
                                      splits, partial, counters, out, s);
    case 4:
      return launch_row_sums<T, V, 4>(a, m, n, lda, mode, unit_diag, cols_per_split,
                                      splits, partial, counters, out, s);
    case 8:
      return launch_row_sums<T, V, 8>(a, m, n, lda, mode, unit_diag, cols_per_split,
                                      splits, partial, counters, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// vec: elements per load, 1 or the 16-byte width VW (4 for f32, 2 for f64)
template <typename T, int VW>
int col_reduce_entry(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                     int unit_diag, int op, int64_t rows_per_split, int splits, int vec,
                     void* partial, void* counters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 1)
    return launch_col_reduce<T, 1>(a, m, n, lda, mode, unit_diag, op, rows_per_split,
                                   splits, partial, counters, out, s);
  if (vec != VW) return (int)cudaErrorInvalidValue;
  if (!aligned16<T>(a, lda)) return (int)cudaErrorMisalignedAddress;
  return launch_col_reduce<T, VW>(a, m, n, lda, mode, unit_diag, op, rows_per_split,
                                  splits, partial, counters, out, s);
}

template <typename T, int VW>
int row_sums_entry(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                   int unit_diag, int64_t cols_per_split, int splits, int vec, int wpr,
                   void* partial, void* counters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 1)
    return launch_row_sums<T, 1>(a, m, n, lda, mode, unit_diag, cols_per_split, splits,
                                 wpr, partial, counters, out, s);
  if (vec != VW) return (int)cudaErrorInvalidValue;
  if (!aligned16<T>(a, lda)) return (int)cudaErrorMisalignedAddress;
  return launch_row_sums<T, VW>(a, m, n, lda, mode, unit_diag, cols_per_split, splits,
                                wpr, partial, counters, out, s);
}

}  // namespace

extern "C" {

int slate_col_reduce_f32(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                         int unit_diag, int op, int64_t rows_per_split, int splits,
                         int vec, void* partial, void* counters, void* out,
                         void* stream) {
  return col_reduce_entry<float, 4>(a, m, n, lda, mode, unit_diag, op, rows_per_split,
                                    splits, vec, partial, counters, out, stream);
}

int slate_col_reduce_f64(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                         int unit_diag, int op, int64_t rows_per_split, int splits,
                         int vec, void* partial, void* counters, void* out,
                         void* stream) {
  return col_reduce_entry<double, 2>(a, m, n, lda, mode, unit_diag, op, rows_per_split,
                                     splits, vec, partial, counters, out, stream);
}

int slate_row_sums_f32(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                       int unit_diag, int64_t cols_per_split, int splits, int vec, int wpr,
                       void* partial, void* counters, void* out, void* stream) {
  return row_sums_entry<float, 4>(a, m, n, lda, mode, unit_diag, cols_per_split, splits,
                                  vec, wpr, partial, counters, out, stream);
}

int slate_row_sums_f64(const void* a, int64_t m, int64_t n, int64_t lda, int mode,
                       int unit_diag, int64_t cols_per_split, int splits, int vec, int wpr,
                       void* partial, void* counters, void* out, void* stream) {
  return row_sums_entry<double, 2>(a, m, n, lda, mode, unit_diag, cols_per_split, splits,
                                   vec, wpr, partial, counters, out, stream);
}

}  // extern "C"
