// Per-partition frontier sums of the BSP window loop, Hopper (sm_90a).
//
//   out[w * R + r, p] = sum over v with part_of[v] == p of x[r, v] * weight_w[v]
//
// x is an [R, n] bool frontier; weight_w an [n] int32 per-vertex weight (a
// vertex's local or remote out-degree), or null for 1 (the count of
// frontier vertices); part_of an [n] int32 partition id, where an id outside
// [0, P) counts nowhere (the mesh's padding rows carry -1).  The output is
// weighting-major, [W * R, P] int32.  Sums are taken in uint32, that is
// modulo 2^32: the adds commute, so the result does not depend on their
// order, and it is the exact int64 sum narrowed to int32 (narrowing is a
// ring map), which is what the plain version (ref.py) computes.
//
// Replaces no TPU kernel.  The JAX package counts per edge, with
// jax.ops.segment_sum over each edge's partition id under XLA
// (repro/graph/traversal.py).  The port counts per vertex: a frontier
// vertex's local out-degree is the local edges it examines.  Before this
// kernel it summed by an int64 prefix sum over vertices grouped by
// partition: a cat, a gather by the grouping, an int64 cumsum and a
// boundary read, some 10 GB of traffic a call at LiveJournal's size for a
// few hundred output integers, at any frontier size.
//
// Bound: each input byte read once -- the frontier (R * n bytes), each
// loaded weight (4 * n) and the part ids (4 * n) -- and the output written
// once, at the card's bandwidth (3.35 TB/s on an H100 SXM).  At R = 16,
// n = 5.06 M and one loaded weight: 122 MB, 0.036 ms.  The adds (one per
// frontier vertex, row and weighting) stay far below the card's integer
// rate while the frontier is sparse; on an all-true frontier the
// shared-memory adds become the limit.
//
// Design.  A block takes a chunk of kChunk vertices and all rows of its row
// group; thread t takes the chunk's vertices t, t + kThreads, ...
// (kVerts of them), so a warp's loads of one row's bytes, of the part ids
// and of the weights are each 32 consecutive elements, whatever the row's
// alignment.  A thread reads its part ids and loaded weights once and
// keeps them, for every row, in its own column of shared memory (vertex k
// of thread t at [k][t]: a warp's reads of any mix of k fall in 32 distinct
// banks).  Each row's kVerts bytes become a mask of frontier vertices;
// an empty mask, the common case of a sparse frontier, costs the loads and
// no more, and otherwise the thread visits only the set bits (a warp loops
// as long as its busiest lane).  It adds runs of vertices of one part in
// registers and each run to a shared-memory counter per (weighting, row,
// part).  The block then adds each non-zero counter to the output with one
// global atomicAdd, into an output the launch zeroes first
// (cudaMemsetAsync).  Where W * R * P counters do not fit kCounterWords,
// the rows are cut into groups, one per blockIdx.y.
//
// Plain C interface, loaded with ctypes: the entry point returns the first
// cudaError_t of its memset and launch, and the wrapper raises on anything
// but cudaSuccess.  It runs on the caller's stream, does not synchronise
// and allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVerts = 16;                 // vertices per thread, kThreads apart
constexpr int kChunk = kThreads * kVerts;  // vertices per block
constexpr int kMaxWeights = 3;
constexpr int kCounterWords = 8192;        // 32 KB of shared uint32 counters at most
// a block's shared memory: the counters, the part ids and each loaded weight
constexpr size_t kColumnBytes = sizeof(uint32_t) * kChunk;
constexpr size_t kDefaultSmem = 48 * 1024;  // the most a launch takes without opting in

struct Weights {
  const int32_t* p[kMaxWeights];  // null: a weight of 1
  int column[kMaxWeights];        // the weight's shared column, -1 for a null one
};

template <int kW>
__device__ __forceinline__ void flush(int part, const uint32_t (&run)[kW], uint32_t* acc,
                                      int weight_stride, int parts) {
  if (static_cast<unsigned>(part) >= static_cast<unsigned>(parts)) return;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    if (run[w]) atomicAdd(acc + w * weight_stride + part, run[w]);
  }
}

// one row's frontier vertices (the set bits of `mask`) into the block's
// counters: `acc` is this row's counter of weighting 0 and part 0,
// weighting w's lie w * weight_stride on; `col` is this thread's shared
// column of part ids, its weights' columns kChunk words apart
template <int kW>
__device__ __forceinline__ void count_row(uint32_t mask, const int32_t* col, const Weights& wt,
                                          uint32_t* acc, int weight_stride, int parts) {
  int cur = -1;
  uint32_t run[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) run[w] = 0u;
  while (mask) {
    const int at = (__ffs(mask) - 1) * kThreads;
    mask &= mask - 1;
    const int part = col[at];
    if (part != cur) {
      flush<kW>(cur, run, acc, weight_stride, parts);
      cur = part;
#pragma unroll
      for (int w = 0; w < kW; ++w) run[w] = 0u;
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int c = wt.column[w];
      run[w] += c < 0 ? 1u : static_cast<uint32_t>(col[(c + 1) * kChunk + at]);
    }
  }
  flush<kW>(cur, run, acc, weight_stride, parts);
}

template <int kW>
__global__ void __launch_bounds__(kThreads)
    part_count_kernel(const uint8_t* __restrict__ x, Weights wt,
                      const int32_t* __restrict__ part_of, uint32_t* __restrict__ out,
                      int64_t rows, int64_t n, int parts, int group_rows) {
  // [kW][group_rows][parts] counters, then the columns: part ids, weights
  extern __shared__ uint32_t smem[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * group_rows;
  const int rg = static_cast<int>(rows - r0 < group_rows ? rows - r0 : group_rows);
  const int weight_stride = group_rows * parts;
  const int counters = kW * weight_stride;
  uint32_t* acc = smem;
  int32_t* col = reinterpret_cast<int32_t*>(smem + counters) + threadIdx.x;
  for (int i = threadIdx.x; i < counters; i += kThreads) acc[i] = 0u;

  // this thread's part ids and weights into its own column: no other
  // thread reads them, so the counters' barrier below is the only one
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kVerts; ++k) {
    const int64_t v = v0 + k * kThreads;
    const bool in = v < n;
    col[k * kThreads] = in ? __ldg(part_of + v) : -1;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      if (wt.p[w] != nullptr) {
        col[(wt.column[w] + 1) * kChunk + k * kThreads] = in ? __ldg(wt.p[w] + v) : 0;
      }
    }
  }
  __syncthreads();

  for (int rr = 0; rr < rg; ++rr) {
    const uint8_t* row = x + (r0 + rr) * n + v0;
    uint32_t mask = 0u;
#pragma unroll
    for (int k = 0; k < kVerts; ++k) {
      const bool set = v0 + k * kThreads < n && __ldg(row + k * kThreads) != 0;
      mask |= static_cast<uint32_t>(set) << k;
    }
    if (mask) count_row<kW>(mask, col, wt, acc + rr * parts, weight_stride, parts);
  }
  __syncthreads();
  // counters of rows past `rg` stay 0 and are skipped with the other zeros
  for (int i = threadIdx.x; i < counters; i += kThreads) {
    const uint32_t v = acc[i];
    if (v == 0u) continue;
    const int w = i / weight_stride;
    const int rr = (i - w * weight_stride) / parts;
    const int p = i - w * weight_stride - rr * parts;
    atomicAdd(out + ((static_cast<int64_t>(w) * rows + r0 + rr) * parts + p), v);
  }
}

template <int kW>
int launch(const uint8_t* x, Weights wt, const int32_t* part_of, uint32_t* out, int64_t rows,
           int64_t n, int parts, int group_rows, cudaStream_t stream) {
  const int64_t groups = (rows + group_rows - 1) / group_rows;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  int loaded = 0;
  for (int w = 0; w < kW; ++w) {
    wt.column[w] = wt.p[w] == nullptr ? -1 : loaded++;
  }
  const int64_t counters = static_cast<int64_t>(kW) * group_rows * parts;
  if (rows < 1 || n < 1 || parts < 1 || group_rows < 1 || groups > 65535 ||
      chunks > 0x7fffffff || counters > kCounterWords) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(uint32_t) * counters + kColumnBytes * (1 + loaded);
  cudaError_t err = cudaSuccess;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(part_count_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * kW * static_cast<size_t>(rows) * parts, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  part_count_kernel<kW>
      <<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(groups)), kThreads, smem,
         stream>>>(x, wt, part_of, out, rows, n, parts, group_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vertices a block takes, and shared counters a block holds: the wrapper
// sizes the grid and the row groups from them
int part_count_chunk_vertices() { return kChunk; }
int part_count_counter_words() { return kCounterWords; }

// weights: n_weights pointers, null for ones.  out: [n_weights * rows, parts]
// int32, zeroed here.
int part_count_launch(const void* x, const void* w0, const void* w1, const void* w2,
                      int n_weights, const void* part_of, void* out, long long rows, long long n,
                      int parts, int group_rows, void* stream) {
  const Weights wt = {{static_cast<const int32_t*>(w0), static_cast<const int32_t*>(w1),
                       static_cast<const int32_t*>(w2)},
                      {-1, -1, -1}};
  const auto* xs = static_cast<const uint8_t*>(x);
  const auto* po = static_cast<const int32_t*>(part_of);
  auto* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_weights) {
    case 1: return launch<1>(xs, wt, po, o, rows, n, parts, group_rows, st);
    case 2: return launch<2>(xs, wt, po, o, rows, n, parts, group_rows, st);
    case 3: return launch<3>(xs, wt, po, o, rows, n, parts, group_rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* part_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
