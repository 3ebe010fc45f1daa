// Row pivots of the blocked LU kept on the card, its panel LU, and its private copy
// and NaN guard, bound through a plain C ABI.
//
// Replaces no Pallas kernel: the JAX package's LU is XLA's, which keeps its pivots on
// the device by itself.  The two pivot kernels were added for the port's own blocked
// LU (linalg/lu.py::_getrf_tiled), so that a library panel's LAPACK ipiv becomes row
// moves on the card: before them every panel's ipiv went to the host, was replayed in
// Python into a permutation of the m - k0 rows below the panel and came back, one host
// sync a panel, and the lookahead pipeline could overlap nothing.  The copy-and-scan
// and the guard were added so that the NaN guard on the same route costs nothing when
// A holds no NaN: before them it read A and the factor again and rewrote the whole
// factor, about 29 ms a solve at 49152^2 f64.
//
//   pivot_moves  a panel's w sequential swaps (1-based ipiv, relative to its top row
//                k0) -> a list of 2w (dst, src) absolute row pairs, (-1, -1) where no
//                row moves.  Applying the list moves row src to row dst for every pair.
//   move_rows    applies such a list to a column range of a row-major matrix (or to a
//                vector, one element a row), for elements of 4, 8 or 16 bytes, so
//                every dtype and the int64 permutation share it.
//   copy_scan_nan    the LU's private row-major copy of A, and in the same pass the
//                1-based index of A's first column that holds a NaN (0 for none),
//                written to one device int32: what the NaN guard asks of A.
//   guard_lost_nan   the NaN guard on the factor, predicated on that index: it does
//                nothing when A held no NaN; otherwise, when the factor lost every
//                NaN, it NaN-fills every row of the columns from the first NaN
//                column on (linalg/lu.py::_mark_lost_nan's rule, bit for bit).
//   getrf        the library's partially pivoted LU of one column-major panel,
//                cuSOLVER's getrf queued on the caller's stream through a handle of
//                this library's own.  PyTorch reaches cuSOLVER for a non-square
//                matrix only through its process-wide preferred linear-algebra
//                library, which would switch every other thread's LUs while a panel
//                is factored; its default sends the panel to MAGMA's batched kernels,
//                one idamax launch a column.
//
// What bounds them:
//   pivot_moves: latency.  The w swaps are sequential by definition; one thread replays
//   them in shared memory, about 4 dependent shared-memory accesses a swap (~15 us at
//   w = 512).  Its bytes are nothing (4w in, 16w out).
//   move_rows: the bytes of the moved rows, each read once and written once:
//   2 * rows * ncols * itemsize at 3.35 TB/s (H100 SXM), 0.24 ms for 1024 rows of
//   49152 f64.
//   copy_scan_nan: the bytes, A read once and the copy written once:
//   2 * m * n * itemsize at 3.35 TB/s, 11.5 ms at 49152^2 f64.
//   guard_lost_nan: latency where A held no NaN (two launches whose blocks read one
//   int32 and return); otherwise one read of the factor and, where the NaN was lost,
//   one write of the columns it fills.
//
// The design:
//   1. Slots, not a window.  A replay can touch only the w panel rows and the w swap
//      targets, so 2w slots in shared memory hold the rows that can move, whatever the
//      panel's height (a window of m - k0 positions would take 192 KiB at 49152 rows
//      and cap the height the kernel takes).  Slot s < w is panel row s; slot w + k is
//      swap k's target when the target lies below the panel and no earlier swap names
//      it.  Each thread finds its swap's slot by scanning the swaps before it (w^2 / 2
//      compares over 1024 threads, broadcast reads).  An ipiv entry outside the window
//      is taken as no swap, so a corrupt pivot can never send the mover out of bounds.
//   2. The list has a fixed size, 2w, with (-1, -1) in the slots that keep their row,
//      so the caller queues the row moves without reading a count back: no host sync.
//   3. Rows move whole and in parallel.  A block of move_rows owns a segment of
//      columns for every pair of the list: it reads the segment of every source row
//      into shared memory, waits at __syncthreads, and writes every destination row.
//      Columns are independent, so a row is always read before it is overwritten,
//      with one launch, no global scratch and each byte read once and written once.
//      The segment is the largest power of two of bytes, at most 256, for which the
//      list's segments fit in 64 KiB of shared memory (three blocks an SM); a list
//      too long for that takes one element a row and up to kMaxSmem.  Consecutive
//      threads take consecutive elements of one row's segment, so the loads and stores
//      of a warp are whole 32-byte sectors from 32 bytes a segment up, and a thread
//      keeps 8 loads in flight before it stores any to shared memory.
//      A laswp that is parallel over columns and sequential over the swaps was not
//      taken: each of its threads would chain 2w dependent memory round trips, about
//      0.6 ms a panel at w = 512 on the critical path.
//   4. copy_scan_nan streams the matrix as 16-byte packs (neighbouring threads on
//      neighbouring packs) wherever the bases and the row pitch allow, and as single
//      scalars elsewhere; a matrix whose rows lie back to back is walked as one long
//      row.  A block takes one pack a thread and leaves: blocks start in order, so
//      the blocks in flight read and write one narrow stretch of memory at a time
//      (12.7 ms at 49152^2 f64, as fast as clone; a persistent grid-stride loop over
//      the same blocks took 13.5, PERF.md §6).  Complex elements are two scalars, a
//      NaN in either part counts.  A thread keeps the smallest NaN column it has seen
//      in a register; only a block that saw one reduces it (warp min, then shared
//      memory) and publishes it with one compare-and-swap loop, so a clean matrix
//      makes no atomics.  The column is worked out only for a NaN found.
//   5. guard_lost_nan's two kernels read the index on the card, in stream order:
//      no host sync, and nothing to do when it is 0, so their grids are one wave of
//      blocks that loop.  The first sets a flag on the
//      first NaN it meets in the factor (every block leaves once the flag is set);
//      the second fills only when the index is set and the flag is not.
// The pivot entry points return cudaGetLastError() after their launch, or
// cudaErrorInvalidValue for arguments the kernels do not take; the getrf entry points
// return a cusolverStatus_t.

#include <cuComplex.h>
#include <cuda_runtime.h>
#include <cusolverDn.h>
#include <stdint.h>

#include <climits>
#include <cstring>

#include <mutex>

namespace {

constexpr int kListThreads = 1024;       // pivot_moves: one block
constexpr int kMoveThreads = 256;        // move_rows: threads a block
constexpr int kIlp = 8;                  // move_rows: loads in flight a thread
constexpr int kSegTarget = 64 * 1024;    // move_rows: shared bytes a block aims at
constexpr int kMaxSegBytes = 256;        // move_rows: widest segment of a row
constexpr int kMaxSmem = 200 * 1024;     // either kernel: most shared bytes a block takes

// ---------------------------------------------------------------------------
// pivot_moves
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kListThreads)
pivot_moves_kernel(const int* __restrict__ ipiv, int w, int64_t mw, int row0,
                   int2* __restrict__ out) {
  extern __shared__ int smem[];
  int* piv = smem;           // w: swap k's target, 0-based within the window
  int* slot = piv + w;       // w: the slot of swap k's target
  int* rows = slot + w;      // 2w: the window row each slot holds, replayed
  const int tid = threadIdx.x;

  for (int k = tid; k < w; k += blockDim.x) {
    const int j = ipiv[k] - 1;
    piv[k] = (j < 0 || j >= mw) ? k : j;
  }
  __syncthreads();
  for (int k = tid; k < w; k += blockDim.x) {
    const int j = piv[k];
    int s = j;
    if (j >= w) {
      int first = k;
      for (int q = 0; q < k; ++q) {
        if (piv[q] == j) {
          first = q;
          break;
        }
      }
      s = w + first;
    }
    slot[k] = s;
    rows[k] = k;
    rows[w + k] = j;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < w; ++k) {
      const int s = slot[k];
      const int t = rows[k];
      rows[k] = rows[s];
      rows[s] = t;
    }
  }
  __syncthreads();
  for (int s = tid; s < 2 * w; s += blockDim.x) {
    // a target slot is live only for the first swap that names a row below the panel
    const bool live = s < w || slot[s - w] == s;
    const int pos = s < w ? s : piv[s - w];
    const int src = rows[s];
    out[s] = (live && src != pos) ? make_int2(row0 + pos, row0 + src) : make_int2(-1, -1);
  }
}

// ---------------------------------------------------------------------------
// move_rows
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMoveThreads)
move_rows_kernel(T* __restrict__ a, int64_t lda, int64_t ncols,
                 const int2* __restrict__ moves, int npairs, int seg_shift) {
  extern __shared__ unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int seg = 1 << seg_shift;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * seg;
  const int width = static_cast<int>(ncols - c0 < seg ? ncols - c0 : seg);
  const int total = npairs << seg_shift;
  // kIlp independent loads in flight per thread before any is stored
  for (int base = threadIdx.x; base < total; base += kMoveThreads * kIlp) {
    T v[kIlp];
    int at[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const int i = base + j * kMoveThreads;
      at[j] = -1;
      if (i < total && (i & (seg - 1)) < width) {
        const int2 mv = __ldg(&moves[i >> seg_shift]);
        if (mv.x >= 0) {
          v[j] = a[static_cast<int64_t>(mv.y) * lda + c0 + (i & (seg - 1))];
          at[j] = i;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j)
      if (at[j] >= 0) buf[at[j]] = v[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kMoveThreads) {
    const int e = i & (seg - 1);
    if (e < width) {
      const int2 mv = __ldg(&moves[i >> seg_shift]);
      if (mv.x >= 0) a[static_cast<int64_t>(mv.x) * lda + c0 + e] = buf[i];
    }
  }
}

// log2 of the elements a block takes of each row: the largest power of two of bytes,
// at most kMaxSegBytes, whose npairs segments fit in kSegTarget; one element when even
// that does not fit.  -1 when one element a row exceeds kMaxSmem.
int segment_shift(int npairs, int itemsize) {
  if (static_cast<int64_t>(npairs) * itemsize > kMaxSmem) return -1;
  int bytes = kMaxSegBytes;
  while (bytes > itemsize && static_cast<int64_t>(npairs) * bytes > kSegTarget) bytes /= 2;
  int shift = 0;
  while ((itemsize << (shift + 1)) <= bytes) ++shift;
  return shift;
}

template <typename T>
int move_rows_entry(void* a, int64_t lda, int64_t ncols, const void* moves, int npairs,
                    void* stream) {
  if (a == nullptr || moves == nullptr || lda < 1 || ncols < 0 || npairs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncols == 0 || npairs == 0) return 0;
  const int shift = segment_shift(npairs, static_cast<int>(sizeof(T)));
  if (shift < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t seg = int64_t{1} << shift;
  const int64_t blocks = (ncols + seg - 1) / seg;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(npairs) * seg * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(move_rows_kernel<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  move_rows_kernel<T><<<static_cast<unsigned>(blocks), kMoveThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(a), lda, ncols, static_cast<const int2*>(moves), npairs, shift);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// copy_scan_nan and guard_lost_nan
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;        // threads a block, one pack each at a time

// A matrix as the scan kernels walk it (ops/cuda_pivots.py::scan_plan works it out):
// `rows` rows of `len` packs of VW scalars, `lds` / `ldd` packs apart in the source
// and the copy; `units` blocks' worth of packs a row.
struct ScanView {
  int64_t rows, len, units, lds, ldd;
};

template <typename S, int VW>
struct Pack {
  S v[VW];
};

template <typename S, int VW>
__device__ __forceinline__ Pack<S, VW> load_pack(const S* p) {
  static_assert(VW == 1 || VW * sizeof(S) == 16, "a pack is one scalar or 16 bytes");
  Pack<S, VW> out;
  if constexpr (VW == 1) {
    out.v[0] = __ldg(p);
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &u, sizeof(u));
  }
  return out;
}

template <typename S, int VW>
__device__ __forceinline__ void store_pack(S* p, const Pack<S, VW>& x) {
  if constexpr (VW == 1) {
    p[0] = x.v[0];
  } else {
    uint4 u;
    memcpy(&u, &x, sizeof(u));
    *reinterpret_cast<uint4*>(p) = u;
  }
}

template <typename S, int VW>
__device__ __forceinline__ bool has_nan(const Pack<S, VW>& x) {
  bool nan = false;
#pragma unroll
  for (int e = 0; e < VW; ++e) nan |= x.v[e] != x.v[e];
  return nan;
}

// The block's smallest `best` (0-based column, INT_MAX for none) into the 1-based
// *first (0 for none), kept at the smallest any block publishes.  Every thread of
// the block calls it; a block that saw no NaN leaves at the first barrier.
__device__ __forceinline__ void publish_first(int best, int* first) {
  __shared__ int warp_best[kScanThreads / 32];
  if (!__syncthreads_or(best != INT_MAX)) return;
  best = __reduce_min_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kScanThreads / 32; ++w) best = min(best, warp_best[w]);
  const int mine = best + 1;
  int old = *reinterpret_cast<volatile int*>(first);
  while (old == 0 || old > mine) {
    const int prev = atomicCAS(first, old, mine);
    if (prev == old) break;
    old = prev;
  }
}

// Copy (kCopy) and scan src, or scan it alone.  Scalar s of a view row belongs to
// column (s / comps) % n of the matrix: the row of a flat view runs over every row
// of the matrix.
template <typename S, int VW, bool kCopy>
__global__ void __launch_bounds__(kScanThreads)
copy_scan_kernel(const S* __restrict__ src, S* __restrict__ dst, ScanView w, int comps,
                 int64_t n, int* __restrict__ first) {
  int best = INT_MAX;
  const int64_t total = w.rows * w.units;
  for (int64_t u = blockIdx.x; u < total; u += gridDim.x) {
    const int64_t r = w.rows == 1 ? 0 : u / w.units;    // no division on a flat view
    const int64_t v = (u - r * w.units) * kScanThreads + threadIdx.x;
    if (v >= w.len) continue;
    const Pack<S, VW> x = load_pack<S, VW>(src + (r * w.lds + v) * VW);
    if constexpr (kCopy) store_pack<S, VW>(dst + (r * w.ldd + v) * VW, x);
    if (has_nan(x)) {
#pragma unroll
      for (int e = 0; e < VW; ++e)
        if (x.v[e] != x.v[e]) best = min(best, static_cast<int>((v * VW + e) / comps % n));
    }
  }
  publish_first(best, first);
}

// Sets *kept when the factor holds a NaN; nothing to do when *first is 0.
template <typename S, int VW>
__global__ void __launch_bounds__(kScanThreads)
guard_scan_kernel(const S* __restrict__ a, ScanView w, const int* __restrict__ first,
                  int* kept) {
  if (*first == 0) return;
  volatile int* flag = kept;
  const int64_t total = w.rows * w.units;
  for (int64_t u = blockIdx.x; u < total; u += gridDim.x) {
    if (*flag) return;
    const int64_t r = w.rows == 1 ? 0 : u / w.units;    // no division on a flat view
    const int64_t v = (u - r * w.units) * kScanThreads + threadIdx.x;
    if (v < w.len && has_nan(load_pack<S, VW>(a + (r * w.lds + v) * VW))) {
      *flag = 1;
      return;
    }
  }
}

template <typename S>
__device__ __forceinline__ S quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Where *first is set and *kept is not, every row's columns from *first - 1 on
// become NaN (a complex element NaN + 0i): what masked_fill_ writes for nan.
template <typename S>
__global__ void __launch_bounds__(kScanThreads)
guard_fill_kernel(S* __restrict__ a, int64_t lda, int64_t m, int64_t n, int comps,
                  int64_t units, const int* __restrict__ first,
                  const int* __restrict__ kept) {
  const int f = *first;
  if (f == 0 || *kept) return;
  const int64_t c0 = f - 1;
  const S nan = quiet_nan<S>();
  for (int64_t u = blockIdx.x; u < m * units; u += gridDim.x) {
    const int64_t r = u / units;
    const int64_t c = (u - r * units) * kScanThreads + threadIdx.x;
    if (c >= c0 && c < n) {
      S* e = a + (r * lda + c) * comps;
      e[0] = nan;
      if (comps == 2) e[1] = S(0);
    }
  }
}

bool bad_view(const ScanView& w, int vw, int scalar) {
  return w.rows < 0 || w.len < 0 || w.lds < 0 || w.ldd < 0 ||
         (vw != 1 && vw * scalar != 16);
}

template <typename S>
int copy_scan_entry(const void* src, void* dst, ScanView w, int vw, int comps, int64_t n,
                    int blocks, int* first, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(first, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (w.rows == 0 || w.len == 0) return 0;
  const S* s = static_cast<const S*>(src);
  S* d = static_cast<S*>(dst);
  if (vw == 1) {
    if (d != nullptr)
      copy_scan_kernel<S, 1, true><<<blocks, kScanThreads, 0, stream>>>(s, d, w, comps, n, first);
    else
      copy_scan_kernel<S, 1, false><<<blocks, kScanThreads, 0, stream>>>(s, d, w, comps, n, first);
  } else {
    constexpr int kVw = 16 / sizeof(S);
    if (d != nullptr)
      copy_scan_kernel<S, kVw, true><<<blocks, kScanThreads, 0, stream>>>(s, d, w, comps, n, first);
    else
      copy_scan_kernel<S, kVw, false><<<blocks, kScanThreads, 0, stream>>>(s, d, w, comps, n, first);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int guard_entry(void* a, ScanView w, int vw, int64_t lda, int64_t m, int64_t n, int comps,
                int blocks, const int* first, int* kept, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(kept, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (m == 0 || n == 0) return 0;
  S* p = static_cast<S*>(a);
  if (vw == 1)
    guard_scan_kernel<S, 1><<<blocks, kScanThreads, 0, stream>>>(p, w, first, kept);
  else
    guard_scan_kernel<S, 16 / sizeof(S)><<<blocks, kScanThreads, 0, stream>>>(p, w, first, kept);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t units = (n + kScanThreads - 1) / kScanThreads;
  guard_fill_kernel<S><<<blocks, kScanThreads, 0, stream>>>(p, lda, m, n, comps, units,
                                                            first, kept);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// getrf: one cuSOLVER handle a device, made on first use.  A handle holds one
// stream, so setting it and queueing the factor happen under one lock.
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;
std::mutex g_solver_lock;
cusolverDnHandle_t g_solver[kMaxDevices] = {};

// the current device's handle; call with g_solver_lock held
cusolverStatus_t solver(cusolverDnHandle_t* out) {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return CUSOLVER_STATUS_INVALID_VALUE;
  if (g_solver[dev] == nullptr) {
    const cusolverStatus_t st = cusolverDnCreate(&g_solver[dev]);
    if (st != CUSOLVER_STATUS_SUCCESS) {
      g_solver[dev] = nullptr;
      return st;
    }
  }
  *out = g_solver[dev];
  return CUSOLVER_STATUS_SUCCESS;
}

bool bad_shape(int dtype, int m, int n, const void* a, int lda) {
  return dtype < 0 || dtype > 3 || m < 0 || n < 0 || a == nullptr || lda < (m > 1 ? m : 1);
}

}  // namespace

extern "C" {

// The workspace, in elements, cuSOLVER's getrf takes for an m x n column-major
// matrix of dtype 0 (f32), 1 (f64), 2 (c64) or 3 (c128).
int slate_getrf_lwork(int dtype, int m, int n, void* a, int lda, int* lwork) {
  if (bad_shape(dtype, m, n, a, lda) || lwork == nullptr)
    return static_cast<int>(CUSOLVER_STATUS_INVALID_VALUE);
  std::lock_guard<std::mutex> hold(g_solver_lock);
  cusolverDnHandle_t h;
  cusolverStatus_t st = solver(&h);
  if (st != CUSOLVER_STATUS_SUCCESS) return static_cast<int>(st);
  switch (dtype) {
    case 0:
      st = cusolverDnSgetrf_bufferSize(h, m, n, static_cast<float*>(a), lda, lwork);
      break;
    case 1:
      st = cusolverDnDgetrf_bufferSize(h, m, n, static_cast<double*>(a), lda, lwork);
      break;
    case 2:
      st = cusolverDnCgetrf_bufferSize(h, m, n, static_cast<cuComplex*>(a), lda, lwork);
      break;
    default:
      st = cusolverDnZgetrf_bufferSize(h, m, n, static_cast<cuDoubleComplex*>(a), lda,
                                       lwork);
  }
  return static_cast<int>(st);
}

// cuSOLVER's partially pivoted LU of the m x n column-major a in place, queued on
// stream: ipiv (min(m, n) int32, 1-based) and info (one int32) on the device, work
// of slate_getrf_lwork elements.  No host sync.
int slate_getrf(int dtype, int m, int n, void* a, int lda, void* work, void* ipiv,
                void* info, void* stream) {
  if (bad_shape(dtype, m, n, a, lda) || work == nullptr || ipiv == nullptr ||
      info == nullptr)
    return static_cast<int>(CUSOLVER_STATUS_INVALID_VALUE);
  std::lock_guard<std::mutex> hold(g_solver_lock);
  cusolverDnHandle_t h;
  cusolverStatus_t st = solver(&h);
  if (st == CUSOLVER_STATUS_SUCCESS)
    st = cusolverDnSetStream(h, static_cast<cudaStream_t>(stream));
  if (st != CUSOLVER_STATUS_SUCCESS) return static_cast<int>(st);
  int* piv = static_cast<int*>(ipiv);
  int* inf = static_cast<int*>(info);
  switch (dtype) {
    case 0:
      return static_cast<int>(cusolverDnSgetrf(h, m, n, static_cast<float*>(a), lda,
                                               static_cast<float*>(work), piv, inf));
    case 1:
      return static_cast<int>(cusolverDnDgetrf(h, m, n, static_cast<double*>(a), lda,
                                               static_cast<double*>(work), piv, inf));
    case 2:
      return static_cast<int>(cusolverDnCgetrf(h, m, n, static_cast<cuComplex*>(a), lda,
                                               static_cast<cuComplex*>(work), piv, inf));
    default:
      return static_cast<int>(cusolverDnZgetrf(h, m, n, static_cast<cuDoubleComplex*>(a),
                                               lda, static_cast<cuDoubleComplex*>(work),
                                               piv, inf));
  }
}

int slate_pivot_moves(const void* ipiv, int w, int64_t mw, int row0, void* out,
                      void* stream) {
  if (ipiv == nullptr || out == nullptr || w < 0 || mw < w || row0 < 0 ||
      w > kMaxSmem / 16 || row0 + mw > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w == 0) return 0;
  const size_t smem = static_cast<size_t>(w) * 4 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(pivot_moves_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  pivot_moves_kernel<<<1, kListThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ipiv), w, mw, row0, static_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}

int slate_move_rows(void* a, int64_t lda, int64_t ncols, int itemsize, const void* moves,
                    int npairs, void* stream) {
  switch (itemsize) {
    case 4:
      return move_rows_entry<uint32_t>(a, lda, ncols, moves, npairs, stream);
    case 8:
      return move_rows_entry<unsigned long long>(a, lda, ncols, moves, npairs, stream);
    case 16:
      return move_rows_entry<uint4>(a, lda, ncols, moves, npairs, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The private row-major copy of src (dtype 0 f32, 1 f64, 2 c64, 3 c128) into dst, or
// with dst null the scan of src alone, walked as the view (rows, len, lds, ldd) of
// vw-scalar packs; *first (one device int32) becomes the 1-based index of the first
// of its n columns that holds a NaN, 0 for none.  blocks: the grid (a block a
// kScanThreads packs where it fits).  No host sync.
int slate_copy_scan_nan(int dtype, const void* src, void* dst, int64_t rows, int64_t len,
                        int64_t lds, int64_t ldd, int vw, int64_t n, int blocks,
                        void* first, void* stream) {
  const int scalar = (dtype == 0 || dtype == 2) ? 4 : 8;
  const ScanView w{rows, len, (len + kScanThreads - 1) / kScanThreads, lds, ldd};
  if (dtype < 0 || dtype > 3 || src == nullptr || first == nullptr || n < 1 ||
      n >= INT_MAX || blocks < 1 || bad_view(w, vw, scalar))
    return static_cast<int>(cudaErrorInvalidValue);
  const int comps = dtype >= 2 ? 2 : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(first);
  return scalar == 4 ? copy_scan_entry<float>(src, dst, w, vw, comps, n, blocks, f, st)
                     : copy_scan_entry<double>(src, dst, w, vw, comps, n, blocks, f, st);
}

// The NaN guard on the m x n factor a (row pitch lda elements, walked for its scan as
// the view (rows, len, lds) of vw-scalar packs): nothing where *first is 0; else the
// columns from *first - 1 on are NaN-filled unless the factor holds a NaN.  kept: one
// device int32 of scratch.  blocks: the grid of both launches (one wave).  Two
// launches, no host sync.
int slate_guard_lost_nan(int dtype, void* a, int64_t lda, int64_t m, int64_t n,
                         int64_t rows, int64_t len, int64_t lds, int vw, int blocks,
                         const void* first, void* kept, void* stream) {
  const int scalar = (dtype == 0 || dtype == 2) ? 4 : 8;
  const ScanView w{rows, len, (len + kScanThreads - 1) / kScanThreads, lds, 0};
  if (dtype < 0 || dtype > 3 || a == nullptr || first == nullptr || kept == nullptr ||
      lda < 0 || m < 0 || n < 0 || n >= INT_MAX || blocks < 1 || bad_view(w, vw, scalar))
    return static_cast<int>(cudaErrorInvalidValue);
  const int comps = dtype >= 2 ? 2 : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* f = static_cast<const int*>(first);
  int* k = static_cast<int*>(kept);
  return scalar == 4 ? guard_entry<float>(a, w, vw, lda, m, n, comps, blocks, f, k, st)
                     : guard_entry<double>(a, w, vw, lda, m, n, comps, blocks, f, k, st);
}

}  // extern "C"
