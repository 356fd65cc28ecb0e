// Flash attention forward (causal and/or sliding window, GQA), Hopper (sm_90a).
//
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // g] / sqrt(d) + mask) v[b, j, h // g]
//
// with the layout [B, S, H, d] for q and o and [B, S, Hk, d] for k and v,
// g = H / Hk, and the mask keeping key j for query i when j < S, j <= i (if
// causal) and j > i - window (if a window is given).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// `flash_attention_kernel`.  That kernel runs a grid (B, H, n_q, n_k) whose
// innermost key axis runs in order on one core, carrying the streaming
// softmax state (m, l, acc) in VMEM scratch, and skips key blocks above the
// diagonal or outside the window.  Here a block owns one (query tile, head,
// batch) and loops over the key tiles itself, with the same skip expressed
// as the loop's bounds, and (m, l, acc) live in float32 registers.  Its
// wrapper pads S and d to whole TPU tiles and (contrary to its comment)
// leaves padded keys unmasked; here nothing is padded in device memory and
// every key at or past S is masked.
//
// Bound: the FLOPs are 4 * B * H * d * pairs, pairs the (query, key) pairs
// inside the mask (two products, QK^T and PV); the bytes are q, k, v read
// once and o written once.  At the Mixtral-8x22B 32k prefill (window 4096)
// that is 3.09e12 FLOP against 0.6 GB, so the kernel is bound by the tensor
// cores: 3.1 ms at 989 TFLOP/s bf16 on an H100 SXM.
//
// Two kernels:
//  * bfloat16: one block of 4 warps per 64 query rows, 16 rows per warp,
//    key tiles of 64.  Q, K and V tiles go to shared memory (rows padded by
//    8 elements, so ldmatrix reads hit distinct banks); the products run on
//    the tensor cores with mma.sync m16n8k16 (bf16 in, float32 accumulate),
//    fragments loaded with ldmatrix (V transposed by ldmatrix.trans).  P is
//    rounded to bf16 for the PV product, as the TPU kernel rounds it to
//    v's type.  The head dimension is padded to a multiple of 16 in shared
//    memory only (template DK), with zeros.  No cp.async, TMA or wgmma yet:
//    loads and math do not overlap within a block, so the kernel relies on
//    a second resident block per SM.
//  * float32: plain FMAs (no TF32: its 10-bit mantissa would miss the
//    1e-5 tolerance), one block of 128 threads per 32 query rows, key tiles
//    of 32, scores and probabilities in shared memory.  It serves float32
//    callers; the main path runs bfloat16.
// Query tiles are launched last-first, so the long rows of a causal mask
// start early.
//
// Plain C interface, loaded with ctypes: the entry point returns the
// cudaError_t of the launch, runs on the caller's stream and allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;   // bf16 kernel: query rows per block (16 per warp)
constexpr int kBK = 64;   // bf16 kernel: keys per tile
constexpr int kThreadsBf16 = 128;
constexpr int kFQ = 32;   // float32 kernel: query rows per block
constexpr int kFK = 32;   // float32 kernel: keys per tile
constexpr int kThreadsF32 = 128;
constexpr int kMaxD = 128;

// key tiles [t_lo, t_hi) that hold a key some row of [q0, q0 + bq) keeps
__device__ __forceinline__ void key_tile_range(int q0, int bq, int bk, int s, bool causal,
                                               int window, int* t_lo, int* t_hi) {
  int k_lo = 0, k_hi = s;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (causal) k_hi = min(s, q0 + bq);
  *t_lo = k_lo / bk;
  *t_hi = k_hi > k_lo ? (k_hi + bk - 1) / bk : *t_lo;
}

__device__ __forceinline__ bool keep(int row, int col, int s, bool causal, int window) {
  return col < s && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// ---------------------------------------------------------------- bfloat16

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + rows) of one head, columns [0, DK), into shared memory
// with row stride LD; rows past s and columns past d are zero
template <int DK, int LD>
__device__ __forceinline__ void load_tile_bf16(bf16* __restrict__ dst,
                                               const bf16* __restrict__ src, int row0,
                                               int rows, int s, int64_t stride, int d,
                                               bool vec) {
  if (vec) {  // d % 8 == 0 and 16-byte aligned rows: one uint4 per 8 columns
    constexpr int kChunks = DK / 8;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreadsBf16) {
      const int r = idx / kChunks;
      const int c = (idx - r * kChunks) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (row0 + r < s && c < d) {
        x = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c));
      }
      *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DK; idx += kThreadsBf16) {
      const int r = idx / DK;
      const int c = idx - r * DK;
      bf16 x = __float2bfloat16(0.f);
      if (row0 + r < s && c < d) x = src[(row0 + r) * stride + c];
      dst[r * LD + c] = x;
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int s, int h,
                          int hk, int d, float scale_log2, int causal_i, int window,
                          int vec_i) {
  constexpr int LD = DK + 8;  // shared row stride, in elements
  constexpr int KSTEPS = DK / 16;
  constexpr int ONB = DK / 8;  // output n-blocks of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LD;
  bf16* sV = sK + kBK * LD;

  const bool causal = causal_i != 0;
  const bool vec = vec_i != 0;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int q0 = qt * kBQ;
  const int64_t q_stride = static_cast<int64_t>(h) * d;
  const int64_t kv_stride = static_cast<int64_t>(hk) * d;
  const bf16* qb = q + static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * d;
  const bf16* kb = k + static_cast<int64_t>(b) * s * kv_stride + static_cast<int64_t>(kvh) * d;
  const bf16* vb = v + static_cast<int64_t>(b) * s * kv_stride + static_cast<int64_t>(kvh) * d;
  bf16* ob = o + static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * d;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group
  const int mi = lane >> 3;  // ldmatrix: which 8x8 matrix this lane addresses
  const int mr = lane & 7;   // ldmatrix: which row of it

  load_tile_bf16<DK, LD>(sQ, qb, q0, kBQ, s, q_stride, d, vec);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ldsm_x4(qf[kk], sQ + (warp * 16 + (mi & 1) * 8 + mr) * LD + kk * 16 + (mi >> 1) * 8);
  }

  float acc[ONB][4];
#pragma unroll
  for (int nb = 0; nb < ONB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int t_lo, t_hi;
  key_tile_range(q0, kBQ, kBK, s, causal, window, &t_lo, &t_hi);
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<DK, LD>(sK, kb, k0, kBK, s, kv_stride, d, vec);
    load_tile_bf16<DK, LD>(sV, vb, k0, kBK, s, kv_stride, d, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[kBK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, sK + (np * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale into log2 units and mask, where the tile is not wholly kept
    const bool full = k0 + kBK <= s && (!causal || k0 + kBK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + kBQ - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[nb][i] * scale_log2;
        if (!full && !keep(row[i >> 1], k0 + nb * 8 + 2 * t4 + (i & 1), s, causal, window)) {
          x = -INFINITY;
        }
        sc[nb][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing kept yet
      corr[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(sc[nb][i] - m_use[i >> 1]);
        sc[nb][i] = p;
        psum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
#pragma unroll
    for (int nb = 0; nb < ONB; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }

    // O += P V: P's accumulator fragments are the A fragments of PV
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DK / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, sV + (kk * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // normalise and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int nb = 0; nb < ONB; ++nb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= s) continue;
      const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
      const int c = nb * 8 + 2 * t4;
      bf16* dst = ob + row[r] * q_stride + c;
      const float x0 = acc[nb][2 * r] * inv;
      const float x1 = acc[nb][2 * r + 1] * inv;
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < d) dst[0] = __float2bfloat16(x0);
        if (c + 1 < d) dst[1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DK>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
                int hk, int d, float scale_log2, int causal, int window, int vec,
                cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * (DK + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  flash_fwd_bf16_kernel<DK><<<grid, kThreadsBf16, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s, h, hk, d, scale_log2, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- float32

__global__ void __launch_bounds__(kThreadsF32)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int s, int h,
                         int hk, int d, float scale, int causal_i, int window) {
  extern __shared__ __align__(16) float fsm[];
  const int ld = d + 1;  // odd row stride: rows fall on distinct banks
  float* sQ = fsm;                 // [kFQ][ld]
  float* sK = sQ + kFQ * ld;       // [kFK][ld]
  float* sV = sK + kFK * ld;       // [kFK][ld]
  float* sP = sV + kFK * ld;       // [kFQ][kFK + 1]
  float* sM = sP + kFQ * (kFK + 1);  // running max per row
  float* sL = sM + kFQ;              // running sum per row
  float* sC = sL + kFQ;              // this tile's correction per row

  const bool causal = causal_i != 0;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int q0 = qt * kFQ;
  const int64_t q_stride = static_cast<int64_t>(h) * d;
  const int64_t kv_stride = static_cast<int64_t>(hk) * d;
  const float* qb = q + static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * d;
  const float* kb = k + static_cast<int64_t>(b) * s * kv_stride + static_cast<int64_t>(kvh) * d;
  const float* vb = v + static_cast<int64_t>(b) * s * kv_stride + static_cast<int64_t>(kvh) * d;
  float* ob = o + static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * d;

  const int tid = threadIdx.x;
  const int my_row = tid >> 2;  // 4 threads per query row
  const int part = tid & 3;     // columns part, part + 4, ... and keys likewise

  for (int idx = tid; idx < kFQ * d; idx += kThreadsF32) {
    const int r = idx / d, c = idx - r * d;
    sQ[r * ld + c] = q0 + r < s ? qb[(q0 + r) * q_stride + c] : 0.f;
  }
  if (tid < kFQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[kMaxD / 4];
#pragma unroll
  for (int j = 0; j < kMaxD / 4; ++j) acc[j] = 0.f;

  int t_lo, t_hi;
  key_tile_range(q0, kFQ, kFK, s, causal, window, &t_lo, &t_hi);
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kFK;
    __syncthreads();
    for (int idx = tid; idx < kFK * d; idx += kThreadsF32) {
      const int r = idx / d, c = idx - r * d;
      const bool in = k0 + r < s;
      sK[r * ld + c] = in ? kb[(k0 + r) * kv_stride + c] : 0.f;
      sV[r * ld + c] = in ? vb[(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();
    // scores: thread (my_row, part) takes keys part, part + 4, ...
    for (int j = part; j < kFK; j += 4) {
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(sQ[my_row * ld + c], sK[j * ld + c], dot);
      const bool kept = keep(q0 + my_row, k0 + j, s, causal, window);
      sP[my_row * (kFK + 1) + j] = kept ? dot * scale : -INFINITY;
    }
    __syncthreads();
    if (tid < kFQ) {  // one thread per row: the streaming softmax update
      float* p = sP + tid * (kFK + 1);
      float mx = -INFINITY;
      for (int j = 0; j < kFK; ++j) mx = fmaxf(mx, p[j]);
      const float m_new = fmaxf(sM[tid], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = 0; j < kFK; ++j) {
        p[j] = expf(p[j] - m_use);
        sum += p[j];
      }
      const float corr = expf(sM[tid] - m_use);
      sC[tid] = corr;
      sL[tid] = sL[tid] * corr + sum;
      sM[tid] = m_new;
    }
    __syncthreads();
    const float corr = sC[my_row];
    const float* p = sP + my_row * (kFK + 1);
#pragma unroll
    for (int j = 0; j < kMaxD / 4; ++j) {
      const int c = part + 4 * j;
      if (c < d) {
        float a = acc[j] * corr;
        for (int kk = 0; kk < kFK; ++kk) a = fmaf(p[kk], sV[kk * ld + c], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
  const int r = q0 + my_row;
  if (r < s) {
    const float l = sL[my_row];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxD / 4; ++j) {
      const int c = part + 4 * j;
      if (c < d) ob[r * q_stride + c] = acc[j] * inv;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
               int hk, int d, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kFQ + 2 * kFK) * (d + 1) + kFQ * (kFK + 1) + 3 * kFQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kFQ - 1) / kFQ, h, b);
  flash_fwd_f32_kernel<<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, h, hk, d, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  vec: 1 when
// d % 8 == 0 and q, k, v start on 16 bytes (bf16 tiles load 16 bytes at a
// time).  Shapes are checked by the Python wrapper; this refuses the rest.
int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                     long long b, long long s, long long h, long long hk, long long d,
                     int causal, long long window, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 || d > kMaxD ||
      s > 0x7fffffffLL || b > 65535 || h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int win = window > 0 ? static_cast<int>(window < s ? window : s) : 0;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const int B = static_cast<int>(b), S = static_cast<int>(s), H = static_cast<int>(h);
  const int HK = static_cast<int>(hk), D = static_cast<int>(d);
  if (dtype == 0) return launch_f32(q, k, v, o, B, S, H, HK, D, scale, causal, win, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const float sl2 = scale * 1.4426950408889634f;  // log2(e): exp2 of log2 units
  switch ((D + 15) / 16) {
    case 1: return launch_bf16<16>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    case 2: return launch_bf16<32>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    case 3: return launch_bf16<48>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    case 4: return launch_bf16<64>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    case 5: return launch_bf16<80>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    case 6: return launch_bf16<96>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    case 7: return launch_bf16<112>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    case 8: return launch_bf16<128>(q, k, v, o, B, S, H, HK, D, sl2, causal, win, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
