// Sorted segment sum, Hopper (sm_90a).
//
//   out[n, :] = sum_{e : ids[e] == n} vals[e, :]      (float32 out, [N, D])
//
// Replaces the TPU kernel repro/kernels/segment_sum/kernel.py:61
// `sorted_segment_sum_kernel`.  The TPU kernel turns each (row block x edge
// block) tile into a one-hot [bE, bN] matrix and contracts it on the MXU,
// skipping tiles off the band of the sorted ids.  On Hopper that one-hot
// product is pure waste: with sorted ids the edges of a segment are one
// contiguous run, so the sum is a segmented reduction over runs.
//
// Bound: every value and id is read once and every output written once, one
// add per value, so the kernel is memory-bound:
//   bytes = E*D*sizeof(val) + E*sizeof(id) + 4*N*D
// over the card's bandwidth (3.35 TB/s on an H100 SXM).  At ogbn-products
// (E = 61.9 M, N = 2.45 M, int32 ids, float32) that is 9.90 ms at D = 128,
// 5.83 ms at PNA's D = 75 and 0.151 ms at D = 1.
//
// Design.  To reach that bound DRAM must see each value byte once, in whole
// 32-byte sectors, with enough bytes in flight, whatever D is; and the SM
// must spend few instructions a row, since at D = 75 in bfloat16 a row is
// only 150 bytes.
//
//  * A block owns a span of whole rows [lo, hi) (`span`, chosen per level by
//    kernel.py: up to 4,096 rows, or 2 MB of float32 rows, fewer where the
//    level is small, so that about two blocks a streaming multiprocessor
//    stay busy).  Rows are contiguous, so the span's values are ONE byte
//    range.  One producer thread copies it from global to shared memory in
//    16-byte-aligned pieces with `cp.async.bulk` onto an mbarrier, through a
//    ring of 4 chunks (8 KB; 16 KB on a level of at most 3 blocks an SM,
//    32 KB on a level of one block; 2 KB on the narrow path), so the next
//    chunks' copies overlap the adds of the current one.  Chunks are cut at 16-byte addresses, not at rows, so
//    every D and either dtype streams at full width; a row that straddles
//    two chunks is read across the ring's seam.  The span's ids (at most
//    16 KB of int32) come in beside the first chunks as one more bulk copy.
//    The producer peels the at most 15 bytes before the first and after the
//    last 16-byte boundary of the span (a view at an odd row offset) with
//    plain loads into the same ring positions.
//  * Threads sum a row once all of it has landed (all of its columns of the
//    pass, see below), so a slot is released one chunk after it was read.
//  * Wide rows (D >= 32): columns go across the consumer threads, up to
//    kWideCols a thread and 256 threads (columns beyond 2,048 take further
//    passes over the span).  All consumer threads walk the same rows, so the
//    test for a new id is warp-uniform and a finished run's columns are
//    stored together, coalesced.  A block ends with one producer warp.  Each
//    consumer warp goes at its own pace: it releases a slot by a relaxed
//    arrive on the slot's second mbarrier, and the producer refills the slot
//    once every consumer warp has.  There is no block-wide barrier in the
//    loop, and the only thread whose mbarrier arrive has release semantics
//    (the producer's) has no stores to `out` for it to wait for.
//  * Narrow rows (D < 32, such as D = 1 for node degrees): a block is one
//    warp and edges go across lanes, kNarrowRows consecutive rows a lane
//    (256 rows a pass).  A lane sums its own rows' runs, then a segmented
//    warp scan (`__shfl_up_sync` on head flags set where the id changes)
//    joins the runs that cross lanes, so all 32 lanes work at any D.
//  * Carries are per block.  A run that lies wholly inside the span is a
//    whole segment and is stored straight to `out`.  The first and the last
//    run of the span may continue into a neighbour, so they go to the carry
//    buffer, slots 2b and 2b+1 (a span of one run writes it to slot 2b and a
//    zero of the same id to 2b+1).  The carry buffer is again a sorted
//    segment sum and the same kernel runs on it; a level that fits one block
//    is the last and stores every run.  ogbn-products takes 3 levels at D =
//    1, 75 and 128, a 168,960-edge MeshGraphNet batch 2.  One C call
//    launches every level of a call.  A segment is stored by exactly one
//    level; segments without an edge keep the zero the wrapper allocated.
//    There are no atomics and the order of every add is fixed, so the
//    result is the same from run to run.
//
// Ids outside [0, N) are summed like any other and dropped at the store, as
// jax.ops.segment_sum drops them.  Ids are int32 or int64; values float32 or
// bfloat16, accumulated in float32; the carry levels are float32 and int64.
// Offsets into [E, D] are 64-bit; offsets inside a span are 32-bit (the
// wrapper keeps span * D below 2^30).
//
// Plain C interface, loaded with ctypes: the entry point launches every
// level of one call on the caller's stream and returns the first nonzero
// cudaGetLastError(); the Python wrapper chooses each level's span and
// allocates the output and the carry buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kNarrowD = 32;         // D below this takes the narrow path
constexpr int kNarrowSpan = 1024;    // rows of a narrow block's span, at most
constexpr int kWideSpan = 4096;      // rows of a wide block's span, at most
constexpr int kNarrowStages = 4, kNarrowChunk = 2048;  // ring of 8 KB
constexpr int kWideStages = 4, kWideChunk = 8192;      // ring of 32 KB
constexpr int kFewChunk = 16384;     // a wide level of few blocks: ring of 64 KB
constexpr int kLastChunk = 32768;    // a wide level of one block: ring of 128 KB
constexpr int kFewBlocksPerSM = 3;   // "few": at most this many blocks an SM
constexpr int kWideThreads = 256;    // consumer threads of a wide block, at most
constexpr int kWideCols = 8;         // columns a wide thread owns in a pass, at most
constexpr int kNarrowRows = 8;       // consecutive rows a narrow lane owns in a pass
constexpr int kUnroll = 4;           // rows a wide thread loads ahead of their adds
constexpr int kBarBytes = 128;       // the mbarriers: two a ring slot, one for the ids
static_assert((2 * kWideStages + 1) * 8 <= kBarBytes, "the mbarriers must fit");
// a wide pass's columns of a row fit one chunk (the refill lags one chunk)
static_assert(kWideCols * kWideThreads * 4 <= kWideChunk, "a pass's row must fit a chunk");
static_assert(kNarrowD * 4 <= kNarrowChunk, "a narrow row must fit a chunk");

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

#ifdef SEG_PHASE_CLOCKS
// A diagnosis build (compare.py --phases): thread 0 of every block sums the
// clock64() cycles its loop over chunks spends waiting for a chunk, summing
// it, and releasing it after (wide: __syncwarp() and the arrive; narrow:
// __syncthreads() and the refill); the sums of all blocks and their count
// add up here.  The default build records nothing.
__device__ unsigned long long g_phase_clock[4];
struct PhaseClock {
  long long mark;
  unsigned long long spent[3];
  __device__ void start() {
    mark = clock64();
    for (int i = 0; i < 3; ++i) spent[i] = 0;
  }
  __device__ void lap(int phase) {
    const long long now = clock64();
    spent[phase] += static_cast<unsigned long long>(now - mark);
    mark = now;
  }
  __device__ void flush() {
    if (threadIdx.x != 0) return;
    for (int i = 0; i < 3; ++i) atomicAdd(&g_phase_clock[i], spent[i]);
    atomicAdd(&g_phase_clock[3], 1ull);
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void flush() {}
};
#endif

// shared memory: [mbarriers | the span's ids (+16 for their alignment) | ring]
__host__ __device__ constexpr int ids_region_bytes(int span, int id_bytes) {
  return round_up(span * id_bytes + 16, 128);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A consumer warp's arrive once it has read a slot.  The default release
// semantics make the compiler wait for the thread's stores to `out` to land
// first (MEMBAR.ALL.CTA); the reads it must order are done, their values
// already added, so the relaxed form (PTX ISA 8.6, CUDA 12.7) is enough.
__device__ __forceinline__ void mbar_arrive_read(uint64_t* bar) {
#if __CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1207
  asm volatile("mbarrier.arrive.relaxed.cta.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
#else
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
#endif
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte-aligned global `src` to 16-byte-
// aligned shared `dst`; the barrier counts them when they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

__device__ __forceinline__ uintptr_t umax(uintptr_t a, uintptr_t b) { return a > b ? a : b; }
__device__ __forceinline__ uintptr_t umin(uintptr_t a, uintptr_t b) { return a < b ? a : b; }

// One block's span: its ids staged in shared memory and its values streamed
// through the ring.  Chunk k holds the span's bytes [vbase + k * chunk_bytes,
// vbase + (k + 1) * chunk_bytes); its seq-th copy (a wide span of several
// column passes copies every chunk once a pass) lands in slot seq % stages,
// so element g of the span (row g / D, column g % D) lies at
// ring[(off + g + rot) & mask], rot = rotation(seq - k).
template <typename I, typename T>
struct Span {
  const T* v;       // the span's first value in global memory
  I* ids;           // the span's ids in shared memory, row r at ids[r]
  T* ring;
  uint64_t* bars;   // bars[s]: slot s landed; bars[stages]: the ids; bars[stages + 1 + s]:
                    // slot s read by every consumer warp (wide path)
  uintptr_t vbase;  // the span's first value rounded down to 16 bytes
  uintptr_t va0;    // its bulk part [va0, va1), 16-byte-aligned
  uintptr_t va1;
  int total;        // rows * D elements
  int off;          // elements from vbase to the span's first value
  int head;         // elements [0, head) are peeled
  int tail;         // and so are [tail, total)
  int tail_chunk;   // the chunk the tail lies in
  int nch, stages, chunk_bytes, chunk_e, mask;

  __device__ void init(unsigned char* smem, const I* gids, const T* gvals, int rows, int d,
                       int span, int stages_, int chunk_bytes_, int consumer_warps) {
    bars = reinterpret_cast<uint64_t*>(smem);
    unsigned char* id_region = smem + kBarBytes;
    ring = reinterpret_cast<T*>(id_region + ids_region_bytes(span, sizeof(I)));
    stages = stages_;
    chunk_bytes = chunk_bytes_;
    chunk_e = chunk_bytes / static_cast<int>(sizeof(T));
    mask = stages * chunk_e - 1;
    v = gvals;
    total = rows * d;
    const uintptr_t va = reinterpret_cast<uintptr_t>(gvals);
    const uintptr_t vend = va + static_cast<uintptr_t>(total) * sizeof(T);
    vbase = va & ~uintptr_t{15};
    va0 = (va + 15) & ~uintptr_t{15};
    va1 = vend & ~uintptr_t{15};
    off = static_cast<int>((va - vbase) / sizeof(T));
    head = min(total, static_cast<int>((va0 - va) / sizeof(T)));
    const uintptr_t tail_start = umax(va0, va1);
    tail = max(head, static_cast<int>((tail_start - va) / sizeof(T)));
    tail_chunk = static_cast<int>((tail_start - vbase) / chunk_bytes);
    nch = (off + total + chunk_e - 1) / chunk_e;

    // ids: one bulk copy of their 16-byte-aligned part, the rest peeled
    const uintptr_t ia = reinterpret_cast<uintptr_t>(gids);
    const uintptr_t ibase = ia & ~uintptr_t{15};
    const uintptr_t ia0 = (ia + 15) & ~uintptr_t{15};
    const uintptr_t ia1 = (ia + static_cast<uintptr_t>(rows) * sizeof(I)) & ~uintptr_t{15};
    ids = reinterpret_cast<I*>(id_region + (ia - ibase));
    const int ihead = min(rows, static_cast<int>((ia0 - ia) / sizeof(I)));
    const int itail = max(ihead, static_cast<int>((umax(ia0, ia1) - ia) / sizeof(I)));
    const int t = threadIdx.x;
    if (t == 0) {
      for (int s = 0; s <= stages; ++s) mbar_init(&bars[s], 1);
      for (int s = 0; s < stages; ++s) mbar_init(&bars[stages + 1 + s], consumer_warps);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
      const uint32_t bytes = ia1 > ia0 ? static_cast<uint32_t>(ia1 - ia0) : 0u;
      mbar_expect_tx(&bars[stages], bytes);
      if (bytes) bulk_load(id_region + (ia0 - ibase), reinterpret_cast<const void*>(ia0), bytes,
                           &bars[stages]);
    }
    if (t < ihead) ids[t] = gids[t];
    if (t < rows - itail) ids[itail + t] = gids[itail + t];
  }

  // Copy chunk k into ring slot (seq % stages), the seq-th use of the ring.
  // Only thread `producer` acts: it stores the chunk's peeled elements, then
  // arrives on the slot's barrier (release: readers that see the chunk land
  // see them too) and issues the bulk copy.
  __device__ void issue(int seq, int k, int producer) {
    if (static_cast<int>(threadIdx.x) != producer) return;
    const int s = seq % stages;
    const int rot = rotation(seq - k);
    if (k == 0) {
      for (int t = 0; t < head; ++t) ring[(off + rot + t) & mask] = v[t];
    }
    if (k == tail_chunk) {
      for (int t = tail; t < total; ++t) ring[(off + rot + t) & mask] = v[t];
    }
    // the chunk the slot held before, if this thread stored peeled bytes in
    // it: order those stores before the copy engine writes the slot again
    const int prev = seq >= stages ? (seq - stages) % nch : -1;
    if ((prev == 0 && head > 0) || (prev == tail_chunk && total > tail)) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    const uintptr_t w0 = vbase + static_cast<uintptr_t>(k) * chunk_bytes;
    const uintptr_t b0 = umax(w0, va0);
    const uintptr_t b1 = umin(w0 + chunk_bytes, va1);
    const uint32_t bytes = b1 > b0 ? static_cast<uint32_t>(b1 - b0) : 0u;
    mbar_expect_tx(&bars[s], bytes);
    if (bytes) {
      bulk_load(reinterpret_cast<unsigned char*>(ring) + static_cast<size_t>(s) * chunk_bytes +
                    (b0 - w0),
                reinterpret_cast<const void*>(b0), bytes, &bars[s]);
    }
  }

  __device__ void wait(int seq) { mbar_wait(&bars[seq % stages], (seq / stages) & 1); }
  // the ring positions a pass's chunks are shifted by: `before` chunks were
  // copied in earlier passes
  __device__ int rotation(int before) const { return (before % stages) * chunk_e; }
  __device__ void wait_ids() { mbar_wait(&bars[stages], 0); }
  // a consumer warp has read the seq-th use of the ring; the producer waits
  // for every consumer warp's before reusing the slot
  __device__ void release(int seq) { mbar_arrive_read(&bars[stages + 1 + seq % stages]); }
  __device__ void wait_read(int seq) {
    mbar_wait(&bars[stages + 1 + seq % stages], (seq / stages) & 1);
  }
};

// Where a block stores a run of `id` in column c.  A run that ended inside
// the span is a whole segment, unless it is the span's first run (id0),
// which may continue to the left: that one is carried.
template <typename I>
struct Stores {
  float* out;
  float* first;  // carry slot 2b, or null on the last level
  float* last;   // carry slot 2b + 1
  int64_t d, n_seg;
  I id0;

  __device__ __forceinline__ void run(I id, int c, float a) const {
    if (first != nullptr && id == id0) {
      first[c] = a;
    } else if (id >= 0 && static_cast<int64_t>(id) < n_seg) {
      out[static_cast<int64_t>(id) * d + c] = a;
    }
  }
  // the span's last run, still open when the span ends
  __device__ __forceinline__ void final_run(I id, int c, float a) const {
    if (first == nullptr) {
      if (id >= 0 && static_cast<int64_t>(id) < n_seg) out[static_cast<int64_t>(id) * d + c] = a;
    } else if (id == id0) {  // one run: it is both the first and the last
      first[c] = a;
      last[c] = 0.f;
    } else {
      last[c] = a;
    }
  }
};

// the passes over a span of D columns, `per_pass` columns a pass
__device__ __forceinline__ int passes(int d, int per_pass) {
  return per_pass > 0 ? (d + per_pass - 1) / per_pass : 1;
}

// D >= 32: the consumer threads t < cols (whole warps) own columns
// c0 + j * cols + t, j < KC, of each pass (c0 = pass * KC * cols) and sum the
// rows whose pass columns have all landed, all threads on the same rows (the
// id test is warp-uniform and a run's columns are stored together).  Each
// consumer warp goes at its own pace: no block-wide barrier, only the slot
// barriers.  A row's pass columns are at most one chunk, so a warp releases
// a slot one chunk after reading it, as on the narrow path.
template <typename I, typename T, int KC>
__device__ void wide_span(Span<I, T>& sp, const Stores<I>& st, int rows, int d, int cols) {
  const int t = threadIdx.x;
  const int per_pass = KC * cols;
  const int uses = passes(d, per_pass) * sp.nch;
  float acc[KC];
  I cur = st.id0;
  int ra = 0;  // rows below ra are summed in this pass
  PhaseClock clock;
  clock.start();
  for (int seq = 0; seq < uses; ++seq) {
    const int pass = seq / sp.nch;
    const int k = seq - pass * sp.nch;
    const int c0 = pass * per_pass;
    const int c_end = min(d, c0 + per_pass);
    sp.wait(seq);
    clock.lap(0);
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = 0.f;
      cur = st.id0;
      ra = 0;
    }
    int rb = rows;  // rows whose pass columns have landed
    if (k < sp.nch - 1) {
      const int landed = (k + 1) * sp.chunk_e - sp.off;  // span elements [0, landed)
      rb = landed >= c_end ? min(rows, (landed - c_end) / d + 1) : 0;
    }
    {
      const int rot = sp.rotation(seq - k);
      const int base = sp.off + rot + c0 + t;
      int r = ra;
      for (; r + kUnroll <= rb; r += kUnroll) {
        I id[kUnroll];
        float x[kUnroll][KC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          id[u] = sp.ids[r + u];
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const bool has = c0 + j * cols + t < c_end;
            x[u][j] = has ? to_f32(sp.ring[(base + (r + u) * d + j * cols) & sp.mask]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (id[u] != cur) {  // the run of `cur` ends here, in every column
#pragma unroll
            for (int j = 0; j < KC; ++j) {
              if (c0 + j * cols + t < c_end) st.run(cur, c0 + j * cols + t, acc[j]);
              acc[j] = 0.f;
            }
            cur = id[u];
          }
#pragma unroll
          for (int j = 0; j < KC; ++j) acc[j] += x[u][j];
        }
      }
      for (; r < rb; ++r) {
        const I id = sp.ids[r];
        if (id != cur) {
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            if (c0 + j * cols + t < c_end) st.run(cur, c0 + j * cols + t, acc[j]);
            acc[j] = 0.f;
          }
          cur = id;
        }
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (c0 + j * cols + t < c_end) {
            acc[j] += to_f32(sp.ring[(base + r * d + j * cols) & sp.mask]);
          }
        }
      }
      if (k == sp.nch - 1) {  // the pass's last chunk: flush the span's last run
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (c0 + j * cols + t < c_end) st.final_run(cur, c0 + j * cols + t, acc[j]);
        }
      }
    }
    ra = rb;
    clock.lap(1);
    __syncwarp();
    // the chunk before this one is read: its slot may be refilled
    if (seq >= 1 && (t & 31) == 0) sp.release(seq - 1);
    clock.lap(2);
  }
  clock.flush();
}

// The wide path's producer: refills each slot once every consumer warp has
// released it (one chunk after reading it), running up to a ring ahead.
template <typename I, typename T>
__device__ void wide_producer(Span<I, T>& sp, int uses, int producer) {
  for (int seq = sp.stages; seq < uses; ++seq) {
    sp.wait_read(seq - sp.stages);
    sp.issue(seq, seq % sp.nch, producer);
  }
}

// D < 32: one warp; lane l owns rows g + kNarrowRows * l + u of a pass
// starting at row g.  A row is read once its chunk and the one before have
// landed (a row is at most 124 bytes, less than a chunk), so a slot is
// refilled one chunk after it was read, as on the wide path.  The warp's
// lane 0 refills it after a __syncthreads().
template <typename I, typename T>
__device__ void narrow_span(Span<I, T>& sp, const Stores<I>& st, int rows, int d) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kPass = 32 * kNarrowRows;
  const int lane = threadIdx.x;
  I cur = st.id0;     // the open run's id
  float carry = 0.f;  // lane c < d: column c's partial of the open run
  int ra = 0;         // rows below ra are summed
  PhaseClock clock;
  clock.start();
  for (int k = 0; k < sp.nch; ++k) {
    sp.wait(k);
    clock.lap(0);
    const int rb = k == sp.nch - 1 ? rows : min(rows, ((k + 1) * sp.chunk_e - sp.off) / d);
    for (int g = ra; g < rb; g += kPass) {
      const int r0 = g + kNarrowRows * lane;
      I id[kNarrowRows];
      bool h[kNarrowRows];  // a run starts at this row
#pragma unroll
      for (int u = 0; u < kNarrowRows; ++u) {
        // rows past rb repeat the last id and add zeros: they start no run
        id[u] = sp.ids[min(r0 + u, rb - 1)];
      }
      I left = __shfl_up_sync(kAll, id[kNarrowRows - 1], 1);
      if (lane == 0) left = cur;
      h[0] = id[0] != left;
#pragma unroll
      for (int u = 1; u < kNarrowRows; ++u) h[u] = id[u] != id[u - 1];
      bool inner = false;  // a run starts at a row u >= 1 of this lane
#pragma unroll
      for (int u = 1; u < kNarrowRows; ++u) inner = inner || h[u];
      const bool flag = h[0] || inner;  // the lane's last run starts in the lane
      // the next lane starts a run: this lane's last run ends with it
      const bool ends = __shfl_down_sync(kAll, static_cast<int>(h[0]), 1) != 0 && lane < 31;
      const bool flush_open = __shfl_sync(kAll, static_cast<int>(h[0]), 0) != 0;
      // the segmented scan's steps: take the lane `o` below unless a run
      // started between it and here
      unsigned take = 0;
      bool f = flag;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int o = 1 << s;
        const bool fu = __shfl_up_sync(kAll, static_cast<int>(f), o) != 0;
        if (lane >= o) {
          if (!f) take |= 1u << s;
          f = f || fu;
        }
      }
      if (flush_open) {  // the open run ended with the previous pass
        if (lane < d) st.run(cur, lane, carry);
        carry = 0.f;
      }
      float new_carry = carry;
      const int p0 = sp.off + r0 * d;
      for (int c = 0; c < d; ++c) {
        float x[kNarrowRows];
#pragma unroll
        for (int u = 0; u < kNarrowRows; ++u) {
          x[u] = r0 + u < rb ? to_f32(sp.ring[(p0 + u * d + c) & sp.mask]) : 0.f;
        }
        // the lane's own runs: the first (up to its first inner start), the
        // whole ones inside, and the last (from its last start)
        float first = 0.f, run = 0.f;
        bool seen = false;
#pragma unroll
        for (int u = 0; u < kNarrowRows; ++u) {
          if (u > 0 && h[u]) {
            if (seen) {
              st.run(id[u - 1], c, run);
            } else {
              first = run;
            }
            seen = true;
            run = 0.f;
          }
          run += x[u];
        }
        const float cin = __shfl_sync(kAll, carry, c);  // lane 0's run may continue
        if (lane == 0 && !h[0]) {
          if (seen) {
            first += cin;
          } else {
            run += cin;
          }
        }
        // segmented inclusive scan of the lanes' last runs
        float tot = run;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const float up = __shfl_up_sync(kAll, tot, 1 << s);
          if (take & (1u << s)) tot += up;
        }
        const float before = __shfl_up_sync(kAll, tot, 1);  // the run entering this lane
        if (seen) st.run(id[0], c, h[0] || lane == 0 ? first : first + before);
        if (ends) st.run(id[kNarrowRows - 1], c, tot);
        const float open = __shfl_sync(kAll, tot, 31);
        if (lane == c) new_carry = open;
      }
      carry = new_carry;
      cur = __shfl_sync(kAll, id[kNarrowRows - 1], 31);
    }
    ra = rb;
    clock.lap(1);
    __syncthreads();  // chunk k - 1 is read: refill its slot
    const int next = k - 1 + sp.stages;
    if (k >= 1 && next < sp.nch) sp.issue(next, next, 0);
    clock.lap(2);
  }
  clock.flush();
  if (lane < d) st.final_run(cur, lane, carry);
}

// One level.  KC = 0: the narrow path; else the wide path with KC columns a
// thread in a pass.  Block b sums rows [b * span, min(m, (b + 1) * span)).
template <typename I, typename T, int KC>
__global__ void __launch_bounds__(kWideThreads + 32)
    segment_sum_level_kernel(const I* __restrict__ ids, const T* __restrict__ vals, int64_t m,
                             int64_t d, int64_t n_seg, int64_t span, int chunk_bytes,
                             float* __restrict__ out, int64_t* __restrict__ carry_ids,
                             float* __restrict__ carry_vals) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int64_t lo = b * span;
  const int rows = static_cast<int>(span < m - lo ? span : m - lo);
  const int dd = static_cast<int>(d);
  Span<I, T> sp;
  // wide blocks end with one producer warp; a narrow block's lane 0 produces
  const int cols = KC == 0 ? 0 : static_cast<int>(blockDim.x) - 32;
  if constexpr (KC == 0) {
    sp.init(smem, ids + lo, vals + lo * d, rows, dd, static_cast<int>(span), kNarrowStages,
            chunk_bytes, 1);
  } else {
    sp.init(smem, ids + lo, vals + lo * d, rows, dd, static_cast<int>(span), kWideStages,
            chunk_bytes, cols / 32);
  }
  const bool last_level = carry_ids == nullptr;
  const int uses = KC == 0 ? sp.nch : sp.nch * passes(dd, KC * cols);
  for (int seq = 0; seq < sp.stages && seq < uses; ++seq) sp.issue(seq, seq % sp.nch, cols);
  __syncthreads();
  sp.wait_ids();
  Stores<I> st;
  st.out = out;
  st.first = last_level ? nullptr : carry_vals + 2 * b * d;
  st.last = last_level ? nullptr : carry_vals + (2 * b + 1) * d;
  st.d = d;
  st.n_seg = n_seg;
  st.id0 = sp.ids[0];
  if constexpr (KC == 0) {
    narrow_span<I, T>(sp, st, rows, dd);
  } else {
    if (static_cast<int>(threadIdx.x) < cols) {
      wide_span<I, T, KC>(sp, st, rows, dd, cols);
    } else if (static_cast<int>(threadIdx.x) == cols) {
      wide_producer<I, T>(sp, uses, cols);
    }
  }
  if (!last_level && threadIdx.x == 0) {
    carry_ids[2 * b] = static_cast<int64_t>(st.id0);
    carry_ids[2 * b + 1] = static_cast<int64_t>(sp.ids[rows - 1]);
  }
}

// the columns a wide thread owns in a pass, and the block's threads
void wide_shape(int64_t d, int* kc, int* threads) {
  int c = 1;
  while (c < kWideCols && (d + c - 1) / c > kWideThreads) c *= 2;
  const int64_t per = (d + c - 1) / c;
  *kc = c;
  *threads = static_cast<int>(per > kWideThreads ? kWideThreads : (per + 31) / 32 * 32);
}

template <typename I, typename T, int KC>
int launch_level(const void* ids, const void* vals, int64_t m, int64_t d, int64_t n_seg,
                 int64_t span, int64_t blocks, int threads, int chunk, int smem, void* out,
                 void* carry_ids, void* carry_vals, cudaStream_t stream) {
  auto kernel = segment_sum_level_kernel<I, T, KC>;
  static bool attr_set = false;  // once a process: the largest ring and span
  if (!attr_set) {
    const int most = kBarBytes + ids_region_bytes(kWideSpan, sizeof(I)) + kWideStages * kLastChunk;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const I*>(ids), static_cast<const T*>(vals), m, d, n_seg, span, chunk,
      static_cast<float*>(out), static_cast<int64_t*>(carry_ids), static_cast<float*>(carry_vals));
  return static_cast<int>(cudaGetLastError());
}

template <typename I, typename T>
int launch(const void* ids, const void* vals, int64_t m, int64_t d, int64_t n_seg, int64_t span,
           void* out, void* carry_ids, void* carry_vals, cudaStream_t stream) {
  const bool last = carry_ids == nullptr;
  if (m < 1 || d < 1 || span < 1 || span * d >= (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (m + span - 1) / span;
  if (blocks > 0x7fffffffLL || (last && blocks != 1)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (d < kNarrowD) {
    if (span > kNarrowSpan) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kBarBytes + ids_region_bytes(static_cast<int>(span), sizeof(I)) +
                     kNarrowStages * kNarrowChunk;
    return launch_level<I, T, 0>(ids, vals, m, d, n_seg, span, blocks, 32, kNarrowChunk, smem,
                                 out, carry_ids, carry_vals, stream);
  }
  if (span > kWideSpan) return static_cast<int>(cudaErrorInvalidValue);
  int kc = 1, threads = 32;
  wide_shape(d, &kc, &threads);
  threads += 32;  // the producer warp
  // a level of few blocks has shared memory to spare: bigger chunks keep
  // more bytes in flight a block
  static int sms = 0;
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) {
    sms = 132;
  }
  const int chunk = last ? kLastChunk : blocks <= kFewBlocksPerSM * sms ? kFewChunk : kWideChunk;
  const int smem =
      kBarBytes + ids_region_bytes(static_cast<int>(span), sizeof(I)) + kWideStages * chunk;
  switch (kc) {
    case 1:
      return launch_level<I, T, 1>(ids, vals, m, d, n_seg, span, blocks, threads, chunk, smem, out,
                                   carry_ids, carry_vals, stream);
    case 2:
      return launch_level<I, T, 2>(ids, vals, m, d, n_seg, span, blocks, threads, chunk, smem, out,
                                   carry_ids, carry_vals, stream);
    case 4:
      return launch_level<I, T, 4>(ids, vals, m, d, n_seg, span, blocks, threads, chunk, smem, out,
                                   carry_ids, carry_vals, stream);
    default:
      return launch_level<I, T, kWideCols>(ids, vals, m, d, n_seg, span, blocks, threads, chunk,
                                           smem, out, carry_ids, carry_vals, stream);
  }
}

template <typename I>
int dispatch_vals(int val_code, const void* ids, const void* vals, int64_t m, int64_t d,
                  int64_t n_seg, int64_t span, void* out, void* cids, void* cvals,
                  cudaStream_t st) {
  if (val_code == 0) return launch<I, float>(ids, vals, m, d, n_seg, span, out, cids, cvals, st);
  if (val_code == 1) {
    return launch<I, __nv_bfloat16>(ids, vals, m, d, n_seg, span, out, cids, cvals, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Every level of one call, on `stream`.  `plan` holds n_levels pairs
// (entries, span); level i > 0 reads the carries level i - 1 wrote.  The
// carries are two parts of carry_ids ([*] int64) and carry_vals ([*, d]
// float32): level i writes part i % 2, which starts at entry 0 or `part`.
// id_code: 0 = int32, 1 = int64; val_code: 0 = float32, 1 = bfloat16 (the
// first level's types; the carries are int64 and float32).  The last level
// must be one block.  Returns the first nonzero cudaGetLastError().
int segment_sum_launch(int id_code, int val_code, const void* ids, const void* vals, long long d,
                       long long n_seg, int n_levels, const long long* plan, void* out,
                       void* carry_ids, void* carry_vals, long long part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (id_code < 0 || id_code > 1 || val_code < 0 || val_code > 1 || n_levels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t* cid = static_cast<int64_t*>(carry_ids);
  float* cval = static_cast<float*>(carry_vals);
  for (int i = 0; i < n_levels; ++i) {
    const int64_t m = plan[2 * i], span = plan[2 * i + 1];
    const bool last = i == n_levels - 1;
    const int64_t w = i % 2 ? part : 0, r = (i - 1) % 2 ? part : 0;
    void* dst_ids = last ? nullptr : cid + w;
    void* dst_vals = last ? nullptr : cval + w * d;
    int rc;
    if (i == 0 && id_code == 0) {
      rc = dispatch_vals<int32_t>(val_code, ids, vals, m, d, n_seg, span, out, dst_ids, dst_vals, st);
    } else if (i == 0) {
      rc = dispatch_vals<int64_t>(val_code, ids, vals, m, d, n_seg, span, out, dst_ids, dst_vals, st);
    } else {
      rc = launch<int64_t, float>(cid + r, cval + r * d, m, d, n_seg, span, out, dst_ids, dst_vals,
                                  st);
    }
    if (rc != 0) return rc;
  }
  return 0;
}

#ifdef SEG_PHASE_CLOCKS
// the summed phase cycles (wait, sum, sync and refill) and the block count
// since the last call, as 4 uint64 into host memory; then zeroes them
int segment_sum_phase_clocks(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_clock, sizeof(g_phase_clock));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clock, zero, sizeof(zero)));
}
#endif

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
