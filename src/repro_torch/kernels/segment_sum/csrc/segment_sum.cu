// Sorted segment sum, Hopper (sm_90a).
//
//   out[n, :] = sum_{e : ids[e] == n} vals[e, :]      (float32 out, [N, D])
//
// Replaces the TPU kernel repro/kernels/segment_sum/kernel.py
// `sorted_segment_sum_kernel`.  The TPU kernel turns each (row block x edge
// block) tile into a one-hot [bE, bN] matrix and contracts it on the MXU,
// skipping tiles off the band of the sorted ids.  On Hopper that one-hot
// product is pure waste: with sorted ids the edges of a segment are one
// contiguous run, so the sum is a segmented reduction over runs.
//
// Bound: every value is read once and every output written once, one add
// per value, so the kernel is memory-bound:
//   bytes = E*D*sizeof(val) + E*sizeof(id) + 4*N*D
// over the card's bandwidth (3.35 TB/s on an H100 SXM).  At ogbn-products
// (E = 61.9 M, D = 128, float32) that is 33.2 GB, about 9.9 ms.
//
// Design: edge-parallel, so a skewed segment cannot serialise the call.
// A warp takes a fixed sub-chunk of kSub consecutive edges and a slice of
// 32 * VEC columns; each lane walks the sub-chunk in order, summing the runs
// of equal ids in registers (VEC = 4: one 16-byte load of four float32, or
// 8 bytes of four bfloat16, per lane and edge; kUnroll edges are loaded
// before they are added, to keep loads in flight).  A run that lies wholly
// inside a sub-chunk is a whole segment: the lane stores it to `out`
// directly.  The first and the last run of a sub-chunk may continue into a
// neighbour, so they go to a carry buffer, slots 2k and 2k+1 (a sub-chunk
// with one run writes it to slot 2k and a zero of the same id to 2k+1).
// The carry buffer is again a sorted segment sum, 64 times shorter, and the
// same kernel runs on it; the last level holds at most kSub entries, is one
// sub-chunk, and stores every run.  ogbn-products takes 5 levels.  A
// segment is stored by exactly one level; segments without an edge keep the
// zero the wrapper allocated.  There are no atomics and the order of every
// add is fixed, so the result is the same from run to run.
//
// Ids outside [0, N) are summed like any other and dropped at the store, as
// jax.ops.segment_sum drops them.  Ids are int32 or int64; values float32 or
// bfloat16, accumulated in float32; the carry levels are float32 and int64.
// Offsets into [E, D] are 64-bit: at E = 61.9 M, D = 128 they pass 2^31.
//
// Plain C interface, loaded with ctypes: the entry point launches one level
// on the caller's stream and returns its cudaGetLastError(); the Python
// wrapper allocates the output and the carry buffers and loops the levels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLanes = 32;  // lanes across columns
constexpr int kWarps = 8;   // sub-chunks per block
constexpr int kThreads = kLanes * kWarps;
constexpr int kSub = 128;   // edges per sub-chunk; must match _SUB in kernel.py
constexpr int kUnroll = 8;  // edges loaded ahead of their adds

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&x)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VEC == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    } else {
      x[0] = __ldg(p);
    }
  } else {
    if constexpr (VEC == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
    } else {
      const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
      x[0] = __bfloat162float(__ushort_as_bfloat16(b));
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

template <typename I, typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_sum_level_kernel(const I* __restrict__ ids, const T* __restrict__ vals,
                             int64_t m, int64_t d, int64_t n_seg, int64_t n_sub,
                             float* __restrict__ out, int64_t* __restrict__ carry_ids,
                             float* __restrict__ carry_vals) {
  const int64_t sub = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.y;
  if (sub >= n_sub) return;  // whole warps leave together
  const int64_t c0 = (static_cast<int64_t>(blockIdx.y) * kLanes + threadIdx.x) * VEC;
  const bool has_cols = c0 < d;  // with VEC = 4, d % 4 == 0: all four in range
  const bool writes_id = threadIdx.x == 0 && blockIdx.y == 0;
  const bool last_level = carry_ids == nullptr;
  const int64_t lo = sub * kSub;
  const int64_t hi = lo + kSub < m ? lo + kSub : m;

  auto store_out = [&](int64_t id, const float (&acc)[VEC]) {
    if (has_cols && id >= 0 && id < n_seg) store_vec<VEC>(out + id * d + c0, acc);
  };
  auto store_carry = [&](int64_t slot, int64_t id, const float (&acc)[VEC]) {
    if (writes_id) carry_ids[slot] = id;
    if (has_cols) store_vec<VEC>(carry_vals + slot * d + c0, acc);
  };

  int64_t cur = static_cast<int64_t>(ids[lo]);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  bool first = true;  // the run in `acc` is the sub-chunk's first

  for (int64_t base = lo; base < hi; base += kUnroll) {
    int64_t id[kUnroll];
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u;
      id[u] = cur;
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[u][j] = 0.f;
      if (i < hi) {
        id[u] = static_cast<int64_t>(ids[i]);
        if (has_cols) load_vec<T, VEC>(vals + i * d + c0, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u < hi) {
        if (id[u] != cur) {  // the run of `cur` ends here
          if (first && !last_level) {
            store_carry(2 * sub, cur, acc);
          } else {
            store_out(cur, acc);
          }
          first = false;
          cur = id[u];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += x[u][j];
      }
    }
  }
  // the sub-chunk's last run
  if (last_level) {
    store_out(cur, acc);
  } else if (first) {  // one run: it is both the first and the last
    store_carry(2 * sub, cur, acc);
    float zero[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) zero[j] = 0.f;
    store_carry(2 * sub + 1, cur, zero);
  } else {
    store_carry(2 * sub + 1, cur, acc);
  }
}

template <typename I, typename T, int VEC>
int launch(const void* ids, const void* vals, int64_t m, int64_t d, int64_t n_seg,
           void* out, void* carry_ids, void* carry_vals, cudaStream_t stream) {
  const int64_t n_sub = (m + kSub - 1) / kSub;
  const int64_t gx = (n_sub + kWarps - 1) / kWarps;
  const int64_t gy = (d + kLanes * VEC - 1) / (kLanes * VEC);
  if (m < 1 || gx < 1 || gy < 1 || gx > 0x7fffffffLL || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(kLanes, kWarps);
  segment_sum_level_kernel<I, T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const I*>(ids), static_cast<const T*>(vals), m, d, n_seg, n_sub,
      static_cast<float*>(out), static_cast<int64_t*>(carry_ids),
      static_cast<float*>(carry_vals));
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int dispatch_vals(int val_code, int vec, const void* ids, const void* vals, int64_t m,
                  int64_t d, int64_t n_seg, void* out, void* cids, void* cvals,
                  cudaStream_t st) {
  if (val_code == 0 && vec == 4)
    return launch<I, float, 4>(ids, vals, m, d, n_seg, out, cids, cvals, st);
  if (val_code == 0 && vec == 1)
    return launch<I, float, 1>(ids, vals, m, d, n_seg, out, cids, cvals, st);
  if (val_code == 1 && vec == 4)
    return launch<I, __nv_bfloat16, 4>(ids, vals, m, d, n_seg, out, cids, cvals, st);
  if (val_code == 1 && vec == 1)
    return launch<I, __nv_bfloat16, 1>(ids, vals, m, d, n_seg, out, cids, cvals, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One level.  id_code: 0 = int32, 1 = int64.  val_code: 0 = float32,
// 1 = bfloat16.  vec: 4 (d % 4 == 0, aligned rows) or 1.  carry_ids and
// carry_vals are null on the last level (m <= kSub).
int segment_sum_level_launch(int id_code, int val_code, int vec, const void* ids,
                             const void* vals, long long m, long long d,
                             long long n_seg, void* out, void* carry_ids,
                             void* carry_vals, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((carry_ids == nullptr) != (carry_vals == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (carry_ids == nullptr && m > kSub) return static_cast<int>(cudaErrorInvalidValue);
  if (id_code == 0)
    return dispatch_vals<int32_t>(val_code, vec, ids, vals, m, d, n_seg, out, carry_ids,
                                  carry_vals, st);
  if (id_code == 1)
    return dispatch_vals<int64_t>(val_code, vec, ids, vals, m, d, n_seg, out, carry_ids,
                                  carry_vals, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
