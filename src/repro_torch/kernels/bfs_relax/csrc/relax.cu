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
// Design: one warp per (s, v).  Its lanes stride over the span, each keeping
// a partial in a register; a warp-shuffle tree combines the 32 partials in a
// fixed order, and lane 0 folds in base[s, v] and writes out[s, v].  There
// are no atomics, so `min` is exact and `sum` is the same from run to run.
// Templated over {float, int32} x {min, sum}.  [S, E] is indexed with 64-bit
// offsets: at LiveJournal scale S * E passes 2^31 from S = 32.
//
// A float `sum` accumulates in double and rounds once, when it writes out.
// The LiveJournal-sized R-MAT graph has a hub that gathers the PageRank of
// a great many degree-one vertices, all nearly equal; a float running sum
// of equal terms rounds the same way at every add, and after 20 iterations
// a float32 sum stood 3% off a float64 power iteration there.  The plain
// version (ref.py) accumulates in float64 too.  int32 `sum` wraps in both.
//
// Bound: the kernel reads each candidate once and each base / row offset
// once and writes each output once, so it is memory-bound:
//   bytes = 4*S*E (cand) + 4*(n+1) (row_ptr) + 2*4*S*n (base, out)
// over the card's bandwidth (3.35 TB/s on an H100 SXM).  The operations
// (one compare or add per candidate) are far below the card's rate.  A
// warp per vertex leaves lanes idle on low-degree vertices; that is the
// first thing a later performance change would attack.
//
// The candidate gather `where(frontier[:, src], relax(state[:, src], w),
// identity)` stays as torch ops outside this kernel, as it stays in XLA
// outside the Pallas kernel in the JAX package (graph/traversal.py:594-598).
// Fusing it in is later work.
//
// Plain C interface, loaded with ctypes: every entry point returns the
// cudaError_t of the launch (cudaGetLastError()), and the wrapper raises on
// anything but cudaSuccess.  The kernel launches on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps per block, one (s, v) row each

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

template <typename T, bool kMin>
__global__ void __launch_bounds__(kThreads)
    relax_rowptr_kernel(const int32_t* __restrict__ row_ptr,
                        const T* __restrict__ cand,
                        const T* __restrict__ base, T* __restrict__ out,
                        int64_t n, int64_t e, int64_t rows) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const int64_t s = row / n;
  const int64_t v = row - s * n;
  const int64_t lo = __ldg(row_ptr + v);
  const int64_t hi = __ldg(row_ptr + v + 1);
  using A = acc_t<T, kMin>;
  const T* c = cand + s * e;
  A acc = identity_of<A, kMin>();
  for (int64_t i = lo + lane; i < hi; i += 32) {
    acc = combine<A, kMin>(acc, static_cast<A>(__ldg(c + i)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = combine<A, kMin>(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) {
    out[row] = static_cast<T>(combine<A, kMin>(static_cast<A>(base[row]), acc));
  }
}

template <typename T, bool kMin>
int launch(const void* row_ptr, const void* cand, const void* base, void* out,
           int64_t s, int64_t n, int64_t e, cudaStream_t stream) {
  const int64_t rows = s * n;
  const int64_t blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  relax_rowptr_kernel<T, kMin><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const T*>(cand),
      static_cast<const T*>(base), static_cast<T*>(out), n, e, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = int32.  reduce: 0 = min, 1 = sum.
int relax_rowptr_launch(int dtype, int reduce, const void* row_ptr,
                        const void* cand, const void* base, void* out,
                        long long s, long long n, long long e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && reduce == 0)
    return launch<float, true>(row_ptr, cand, base, out, s, n, e, st);
  if (dtype == 0 && reduce == 1)
    return launch<float, false>(row_ptr, cand, base, out, s, n, e, st);
  if (dtype == 1 && reduce == 0)
    return launch<int32_t, true>(row_ptr, cand, base, out, s, n, e, st);
  if (dtype == 1 && reduce == 1)
    return launch<int32_t, false>(row_ptr, cand, base, out, s, n, e, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* relax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
