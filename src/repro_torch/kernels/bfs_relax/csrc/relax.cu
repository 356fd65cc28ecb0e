// Segmented relax reduction for the dense BSP engine, Hopper (sm_90a).
//
//   out[s, v] = combine(base[s, v], reduce_{e : dst[e] == v} cand[s, e])
//
// Replaces the TPU kernel repro/kernels/bfs_relax/kernel.py
// `relax_kernel_blockmap` (and, through the Python wrappers, its min-only
// twins `bfs_relax_kernel_blockmap` and `bfs_relax_kernel`).  The TPU kernel
// walks a scalar-prefetched block map and reduces a one-hot [bE, bN] compare
// per tile.  Here dst is ascending, so the edges of vertex v are the span
// [row_ptr[v], row_ptr[v + 1]) of a CSR offset array built once per layout on
// the host, and no compare is needed at all.
//
// Bound: the kernel must read each candidate once and each base / row offset
// once and write each output once, so it is memory-bound:
//   bytes = 4*S*E (cand) + 4*(n+1) (row_ptr) + 2*4*S*n (base, out)
// over the card's bandwidth (3.35 TB/s on an H100 SXM).  The operations
// (one compare or add per candidate) are far below the card's rate.
//
// Design: merge-based CSR partitioning (Merrill & Garland, "Merge-based
// Parallel Sparse Matrix-Vector Multiplication", SC 2016).  The n row ends
// and the E edges form one merged list of n + E items (row end v comes
// before edge j when row_ptr[v + 1] <= j); every block takes kTile items of
// it, every thread kItems, whatever the degrees.  So a hub row spreads over
// many blocks and a run of short rows shares one warp's lanes: the time
// does not follow the longest row.
//   1. relax_partition_kernel: one thread per tile boundary finds its
//      (row, edge) start by a binary search of row_ptr.  The split depends
//      on row_ptr alone: the wrapper keeps it for a row_ptr's later calls,
//      and it serves every source.
//   2. relax_rowptr_kernel: one block per tile loops over the sources.  The
//      bound is bandwidth, so the kernel's job is to keep loads in flight:
//      a block issues all its loads at once (row ends, the candidates in
//      16-byte loads where the span is aligned, the base of its rows), and
//      loads source s + 1 into registers while it reduces source s from
//      shared memory.  Each thread finds its own start by a search in
//      shared memory and reduces its items in one walk; a segmented scan
//      over the threads (shuffles, then the warps in order) hands each
//      thread the partial of the row it starts inside.  A row that ends in
//      the tile gets base folded in and is written directly, in row order.
//      A row cut by the tile's start leaves its partial in `head`, the row
//      still open at the tile's end leaves its partial in `tail` (scratch
//      from the wrapper, [S, tiles] each).
//   3. relax_fixup_kernel: one warp per tile whose first row was cut, for
//      every source: its lanes fold that row's `tail` partials of the
//      earlier tiles with a fixed shuffle tree, then `base` and the tile's
//      `head`.
// No atomics anywhere: `min` is exact and `sum` repeats bit for bit from run
// to run.  Templated over {float, int32} x {min, sum}.  [S, E] is indexed
// with 64-bit offsets: at LiveJournal scale S * E passes 2^31 from S = 32.
//
// A float `sum` accumulates in double and rounds once, when it writes out.
// The LiveJournal-sized R-MAT graph has a hub that gathers the PageRank of
// a great many degree-one vertices, all nearly equal; a float running sum
// of equal terms rounds the same way at every add, and after 20 iterations
// a float32 sum stood 3% off a float64 power iteration there.  The plain
// version (ref.py) accumulates in float64 too.  int32 `sum` wraps in both.
//
// The candidate gather `where(frontier[:, src], relax(state[:, src], w),
// identity)` stays as torch ops outside this kernel, as it stays in XLA
// outside the Pallas kernel in the JAX package (graph/traversal.py:594-598).
//
// Plain C interface, loaded with ctypes: the entry point returns the first
// cudaError_t of its three launches (cudaGetLastError()), and the wrapper
// raises on anything but cudaSuccess.  The kernels launch on the caller's
// stream, do not synchronise and allocate nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;                // 4 warps per tile block
constexpr int kItems = 16;                   // merged items (row ends + edges) per thread
constexpr int kTile = kThreads * kItems;     // merged items per block
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = kTile / 4 / kThreads;  // 16-byte candidate loads per thread, at most
constexpr int kRowRegs = 2;                  // row ends and base values kept in registers
constexpr int kAuxThreads = 256;             // partition and fix-up blocks
constexpr unsigned kFull = 0xffffffffu;

#ifdef RELAX_PHASE_CLOCKS
// A diagnosis build (chip_smoke.py's relax_phases): thread 0 of each of
// the first kClockedTiles blocks records clock64() at the reduction's
// phase boundaries for source 0.  The default build records nothing.
constexpr int kClockedTiles = 1 << 16;
constexpr int kPhaseMarks = 7;
__device__ long long g_phase_clock[kClockedTiles][kPhaseMarks];
#define PHASE_MARK(i)                                                       \
  do {                                                                      \
    if (threadIdx.x == 0 && b < kClockedTiles) g_phase_clock[b][i] = clock64(); \
  } while (0)
#else
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#endif

// the register type a lane reduces in: double for a float sum, else T
template <typename T, bool kMin>
using acc_t = std::conditional_t<!kMin && std::is_same_v<T, float>, double, T>;

template <typename A, bool kMin>
__device__ __forceinline__ A identity_of() {
  if constexpr (!kMin) {
    return A(0);
  } else if constexpr (std::is_same_v<A, float>) {
    return __int_as_float(0x7f800000);  // +inf
  } else {
    return INT_MAX;
  }
}

template <typename T, bool kMin>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (kMin) {
    return b < a ? b : a;
  } else {
    return a + b;
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t x) {
  if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(x);
  } else {
    return static_cast<T>(x);
  }
}

// The number of row ends among the first `diag` items of the merge of the
// row ends ends(0..rows) with the edge offsets e_lo + (0..edges).
template <typename F>
__device__ __forceinline__ int64_t merge_search(int64_t diag, int64_t rows, int64_t edges,
                                                int64_t e_lo, F ends) {
  int64_t lo = diag > edges ? diag - edges : 0;
  int64_t hi = diag < rows ? diag : rows;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ends(mid) <= e_lo + diag - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// starts[t] = (row, edge) where tile t's items begin, t in [0, tiles]
__global__ void __launch_bounds__(kAuxThreads)
    relax_partition_kernel(const int32_t* __restrict__ row_ptr, int64_t n, int64_t e,
                           int64_t tiles, int2* __restrict__ starts) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kAuxThreads + threadIdx.x;
  if (t > tiles) return;
  const int64_t diag = t * kTile < n + e ? t * kTile : n + e;
  const int64_t i = merge_search(diag, n, e, 0, [&](int64_t r) {
    return static_cast<int64_t>(__ldg(row_ptr + r + 1));
  });
  starts[t] = make_int2(static_cast<int>(i), static_cast<int>(diag - i));
}

// One source's candidates for the tile, held in registers from their loads
// to their stores into shared memory: loaded while the previous source is
// reduced.  The span starts with up to 3 candidates before a 16-byte
// boundary (threads 0-3 take those) and ends with up to 3 after the last
// one (threads 4-7).
struct CandRegs {
  uint4 vec[kVecs];
  uint32_t edge;
};

struct CandSpan {
  const uint32_t* src;  // cand[s] + j0
  int head, vecs, count;
};

__device__ __forceinline__ CandSpan cand_span(const uint32_t* src, int count) {
  const int head =
      min(count, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2));
  return {src, head, (count - head) >> 2, count};
}

__device__ __forceinline__ int edge_slot(const CandSpan& c) {
  const int t = threadIdx.x;
  if (t < 4) return t < c.head ? t : -1;
  const int k = c.head + 4 * c.vecs + t - 4;
  return t < 8 && k < c.count ? k : -1;
}

__device__ __forceinline__ void load_cand(CandRegs& r, const CandSpan& c) {
  const uint4* sv = reinterpret_cast<const uint4*>(c.src + c.head);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k < c.vecs) r.vec[i] = __ldg(sv + k);
  }
  const int k = edge_slot(c);
  if (k >= 0) r.edge = __ldg(c.src + k);
}

__device__ __forceinline__ void store_cand(uint32_t* __restrict__ dst, const CandRegs& r,
                                           const CandSpan& c) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k < c.vecs) {
      uint32_t* d = dst + c.head + 4 * k;
      d[0] = r.vec[i].x;
      d[1] = r.vec[i].y;
      d[2] = r.vec[i].z;
      d[3] = r.vec[i].w;
    }
  }
  const int k = edge_slot(c);
  if (k >= 0) dst[k] = r.edge;
}

template <typename T, bool kMin>
__global__ void __launch_bounds__(kThreads, 8)
    relax_rowptr_kernel(const int32_t* __restrict__ row_ptr, const int2* __restrict__ starts,
                        const T* __restrict__ cand, const T* __restrict__ base,
                        T* __restrict__ out, acc_t<T, kMin>* __restrict__ head,
                        acc_t<T, kMin>* __restrict__ tail, int64_t s_count, int64_t n,
                        int64_t e, int64_t tiles) {
  using A = acc_t<T, kMin>;
  __shared__ uint32_t s_items[kTile];  // the tile's candidates, then its row ends
  __shared__ A s_out[kTile];           // the partial of each row that ends in the tile
  __shared__ A s_warp[kWarps];
  __shared__ int s_wflag[kWarps];

  const int64_t b = blockIdx.x;
  PHASE_MARK(0);
  const int2 st0 = starts[b];
  const int2 st1 = starts[b + 1];
  const int i0 = st0.x, j0 = st0.y;
  const int nr = st1.x - i0;  // rows that end in this tile
  const int ne = st1.y - j0;  // edges in this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* s_cand = s_items;
  int32_t* s_end = reinterpret_cast<int32_t*>(s_items + ne);  // row ends, as offsets from j0
  const auto* cand_bits = reinterpret_cast<const uint32_t*>(cand);
  const auto* base_bits = reinterpret_cast<const uint32_t*>(base);
  const A ident = identity_of<A, kMin>();

  // every load of source 0 in flight at once: row ends, candidates, base
  int32_t ends[kRowRegs];
  uint32_t base_reg[kRowRegs];
#pragma unroll
  for (int i = 0; i < kRowRegs; ++i) {
    const int k = tid + i * kThreads;
    if (k < nr) {
      ends[i] = __ldg(row_ptr + i0 + 1 + k);
      base_reg[i] = __ldg(base_bits + i0 + k);
    }
  }
  CandSpan span = cand_span(cand_bits + j0, ne);
  CandRegs regs;
  load_cand(regs, span);
  // row i0 began in an earlier tile and ends in this one
  const bool cut = nr > 0 && __ldg(row_ptr + i0) < j0;
  const bool open_end = i0 + nr < n;  // a row is still open at the tile's end
#pragma unroll
  for (int i = 0; i < kRowRegs; ++i) {
    const int k = tid + i * kThreads;
    if (k < nr) s_end[k] = ends[i] - j0;
  }
  for (int k = tid + kRowRegs * kThreads; k < nr; k += kThreads) {
    s_end[k] = __ldg(row_ptr + i0 + 1 + k) - j0;
  }
  __syncthreads();
  PHASE_MARK(1);

  // this thread's items, [d0, d0 + cnt) of the tile, start at local (ti0, tj0)
  const int d0 = min(tid * kItems, nr + ne);
  const int cnt = min(kItems, nr + ne - d0);
  const int ti0 = static_cast<int>(
      merge_search(d0, nr, ne, 0, [&](int64_t r) { return static_cast<int64_t>(s_end[r]); }));
  const int tj0 = d0 - ti0;
  const int end0 = ti0 < nr ? s_end[ti0] : INT_MAX;
  PHASE_MARK(2);

  for (int64_t s = 0; s < s_count; ++s) {
    store_cand(s_items, regs, span);
    __syncthreads();  // source s is staged; source s - 1 is done with s_out
    if (s == 0) PHASE_MARK(3);
    if (s + 1 < s_count) {  // source s + 1's candidates load while s is reduced
      span = cand_span(cand_bits + (s + 1) * e + j0, ne);
      load_cand(regs, span);
    }

    // one walk: rows that start and end in this thread's items go to
    // s_out; the first row end (row ti0) keeps its partial in `first`
    A a = ident, first = ident;
    int flag = 0;
    int ti = ti0, tj = tj0, nxt = end0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k < cnt) {
        if (nxt <= tj) {  // row ti ends before edge tj
          if (flag) {
            s_out[ti] = a;
          } else {
            first = a;
            flag = 1;
          }
          a = ident;
          ++ti;
          nxt = ti < nr ? s_end[ti] : INT_MAX;
        } else {
          a = combine<A, kMin>(a, static_cast<A>(from_bits<T>(s_cand[tj])));
          ++tj;
        }
      }
    }
    // inclusive segmented scan of the partials left open after each
    // thread's last row end; a thread with a row end starts a new segment
    A v = a;
    int f = flag;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const A pv = __shfl_up_sync(kFull, v, off);
      const int pf = __shfl_up_sync(kFull, f, off);
      if (lane >= off) {
        if (!f) v = combine<A, kMin>(pv, v);
        f |= pf;
      }
    }
    if (lane == 31) {
      s_warp[warp] = v;
      s_wflag[warp] = f;
    }
    if (s == 0) PHASE_MARK(4);
    __syncthreads();  // every walk is done with the candidates
    A pre = ident;    // the earlier warps, back to the nearest row end
    for (int w = warp - 1; w >= 0; --w) {
      pre = combine<A, kMin>(s_warp[w], pre);
      if (s_wflag[w]) break;
    }
    if (!f) v = combine<A, kMin>(pre, v);
    A carry = __shfl_up_sync(kFull, v, 1);  // the open partial this thread starts inside
    if (lane == 0) carry = pre;
    if (flag) s_out[ti0] = combine<A, kMin>(carry, first);
    if (tid == kThreads - 1 && open_end) tail[s * tiles + b] = v;
    __syncthreads();
    if (s == 0) PHASE_MARK(5);

    // base folded in, rows written in order; the cut row's partial waits
    // for the fix-up.  Source s + 1's base loads as s's is used.
    const int64_t row0 = s * n + i0;
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) {
      const int k = tid + i * kThreads;
      if (k < nr) {
        if (k == 0 && cut) {
          head[s * tiles + b] = s_out[0];
        } else {
          out[row0 + k] = static_cast<T>(
              combine<A, kMin>(static_cast<A>(from_bits<T>(base_reg[i])), s_out[k]));
        }
        if (s + 1 < s_count) base_reg[i] = __ldg(base_bits + row0 + n + k);
      }
    }
    for (int k = tid + kRowRegs * kThreads; k < nr; k += kThreads) {
      out[row0 + k] = static_cast<T>(combine<A, kMin>(
          static_cast<A>(from_bits<T>(__ldg(base_bits + row0 + k))), s_out[k]));
    }
  }
  PHASE_MARK(6);
}

// one warp per tile: the row cut by the tile's start, if it ends in the
// tile, gets base, the earlier tiles' tails and this tile's head, for
// every source
template <typename T, bool kMin>
__global__ void __launch_bounds__(kAuxThreads)
    relax_fixup_kernel(const int32_t* __restrict__ row_ptr, const int2* __restrict__ starts,
                       const T* __restrict__ base, T* __restrict__ out,
                       const acc_t<T, kMin>* __restrict__ head,
                       const acc_t<T, kMin>* __restrict__ tail, int64_t s_count, int64_t n,
                       int64_t tiles) {
  using A = acc_t<T, kMin>;
  const int64_t b = (static_cast<int64_t>(blockIdx.x) * kAuxThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= tiles) return;  // whole warps leave together
  const int2 st0 = starts[b];
  const int64_t r = st0.x;
  if (starts[b + 1].x == st0.x) return;  // no row ends in this tile
  const int64_t first_edge = __ldg(row_ptr + r);
  if (first_edge >= st0.y) return;  // row r begins in this tile
  const int64_t first = (r + first_edge) / kTile;  // the tile of its first edge
  for (int64_t s = 0; s < s_count; ++s) {
    A acc = identity_of<A, kMin>();
    for (int64_t k = first + lane; k < b; k += 32) {
      acc = combine<A, kMin>(acc, tail[s * tiles + k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = combine<A, kMin>(acc, __shfl_down_sync(kFull, acc, off));
    }
    if (lane == 0) {
      const int64_t at = s * n + r;
      const A v = combine<A, kMin>(static_cast<A>(base[at]), acc);
      out[at] = static_cast<T>(combine<A, kMin>(v, head[s * tiles + b]));
    }
  }
}

template <typename T, bool kMin>
int launch(const void* row_ptr, const void* cand, const void* base, void* out, void* starts,
           int partition, void* head, void* tail, int64_t s, int64_t n, int64_t e,
           cudaStream_t stream) {
  using A = acc_t<T, kMin>;
  const int64_t tiles = (n + e + kTile - 1) / kTile;
  const int64_t part_blocks = (tiles + 1 + kAuxThreads - 1) / kAuxThreads;
  const int64_t fix_blocks = (tiles * 32 + kAuxThreads - 1) / kAuxThreads;
  if (s < 1 || tiles < 1 || tiles > INT_MAX || fix_blocks > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  auto* st = static_cast<int2*>(starts);
  cudaError_t err;
  if (partition) {
    relax_partition_kernel<<<static_cast<unsigned>(part_blocks), kAuxThreads, 0, stream>>>(
        rp, n, e, tiles, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  relax_rowptr_kernel<T, kMin><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      rp, st, static_cast<const T*>(cand), static_cast<const T*>(base), static_cast<T*>(out),
      static_cast<A*>(head), static_cast<A*>(tail), s, n, e, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_fixup_kernel<T, kMin><<<static_cast<unsigned>(fix_blocks), kAuxThreads, 0, stream>>>(
      rp, st, static_cast<const T*>(base), static_cast<T*>(out), static_cast<const A*>(head),
      static_cast<const A*>(tail), s, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// merged items per tile: the wrapper sizes `starts` ([tiles + 1] int2) and
// `head`, `tail` ([S, tiles] of the accumulator type each) from it
int relax_tile_items() { return kTile; }

// dtype: 0 = float32, 1 = int32.  reduce: 0 = min, 1 = sum.
// partition: 0 when `starts` already holds this row_ptr's tile starts.
int relax_rowptr_launch(int dtype, int reduce, const void* row_ptr, const void* cand,
                        const void* base, void* out, void* starts, int partition, void* head,
                        void* tail, long long s, long long n, long long e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && reduce == 0)
    return launch<float, true>(row_ptr, cand, base, out, starts, partition, head, tail, s, n, e,
                               st);
  if (dtype == 0 && reduce == 1)
    return launch<float, false>(row_ptr, cand, base, out, starts, partition, head, tail, s, n, e,
                                st);
  if (dtype == 1 && reduce == 0)
    return launch<int32_t, true>(row_ptr, cand, base, out, starts, partition, head, tail, s, n,
                                 e, st);
  if (dtype == 1 && reduce == 1)
    return launch<int32_t, false>(row_ptr, cand, base, out, starts, partition, head, tail, s, n,
                                  e, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef RELAX_PHASE_CLOCKS
// the phase clocks of the first `tiles` blocks (at most kClockedTiles),
// [tiles][kPhaseMarks] int64, into host memory
int relax_phase_clocks(void* host, long long tiles) {
  const long long n = tiles < kClockedTiles ? tiles : kClockedTiles;
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_phase_clock, n * kPhaseMarks * sizeof(long long)));
}
#endif

const char* relax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
