// Level-scheduled SpTRSV for Hopper (sm_90a), one thread block per solve.
//
// Replaces the Pallas TPU kernels sptrsv_groups_pallas (K1) and
// sptrsv_groups_pallas_multi (K2) of src/repro/kernels/sptrsv_level.py.
// What they compute, for every row in dependency order, with R right-hand
// sides side by side (K1 is R == 1):
//
//     x[row] = (c[row] - sum_d coef[d] * x[idx[d]]) * dinv[row]
//
// What bounds it on this card: the chain of dependent steps.  A solve
// moves a few MB (the schedule, c and x once: microseconds at 3.35 TB/s);
// its time is the number of steps times the latency of one step: a
// gather of x from L1/L2, an FMA chain, a store and a barrier, plus the
// bookkeeping of every warp that takes part in the step.
//
// What the design does about it:
//   * Steps = the DAG's depth.  The host packing (kernels/sptrsv_level.py:
//     pack_groups) fuses the schedule compiler's carry chains into whole
//     rows and re-levels them without a cap on lanes per step, so no
//     carry buffer exists and a row longer than max_deps costs no extra
//     steps (lung2's backward IC(0) sweep: 2,717 schedule steps -> 479).
//   * The schedule is out of the step's critical path.  Each step's lanes
//     are cut into tiles (header, 16-byte lane records, (index, coef)
//     pairs).  One producer warp streams the tiles into a ring of stages
//     in dynamic shared memory with TMA bulk copies (cp.async.bulk,
//     mbarrier expect_tx), up to the ring's depth ahead of the consumers;
//     a consumer reads its lane from shared memory, never from a chain of
//     dependent global loads.
//   * Narrow steps (at most 32 lanes, none long: most of lung2's) share a
//     tile in runs, and consumer warp 0 solves a run alone, one step after
//     another, ordering its writes with __syncwarp; the other warps skip
//     the tile.  A run costs no block barrier and no other warp's time.
//     A lane record's bit 31 marks the last lane of its step, and a
//     ballot over 32 records finds where the step ends.
//   * A wide step ends with a named barrier over the consumer warps only
//     (barrier.sync 1), which makes its x writes visible to the block;
//     tiles inside a step need none.  Before a thread waits at the
//     barrier it has read its first lane of the step and loaded c[row]:
//     everything that does not depend on x.  The wrapper sizes the
//     consumer warps per schedule and R from a rough cost of the wide
//     steps (more warps: fewer rounds of lanes per thread, but more
//     bookkeeping and a slower barrier).
//   * A lane's gathers go out in chunks before their FMAs (its first 4,
//     then 8 at a time behind them), so a lane of up to 12 deps pays one
//     trip to L1/L2.  Long lanes (more than LONG_DEPS deps, first in their
//     step) get a warp each: a strided sum, two chunks of 4 per thread in
//     flight, and a __shfl_xor_sync reduction.  Short lanes get a thread
//     per lane and column, or with R % 4 == 0 (K2) per lane and 4 columns
//     (float4 gathers of x and c: a quarter of the items and loads, so
//     torso2's steps at R = 8 take one round of items, not two); the
//     items of a step rotate over the threads from tile to tile so that
//     no thread idles while another takes two.
//   * A row of more than FAR_DEPS deps (kernels/sptrsv_level.py) would not
//     fit a ring stage; its (index, coef) pairs stay in device memory
//     (`far`), its record's dep offset is ~(its first pair there), and its
//     warp streams them from L2/HBM.  Rows of any length solve in one step.
//   * x and c stay in device memory (lung2's x is 438 KB, over the 227 KB
//     of shared memory), in the 50 MB L2; x is written during the kernel,
//     so it is read with plain coherent loads, never the read-only path.
//     The ring takes 96 KB, leaving the rest of the SM's 256 KB to L1,
//     which holds recent rows of x (K2 on torso2 at R = 8: 18% faster
//     than with a 192 KB ring; K1 within 1%).
//   * The dependency-free rows of the first level (x = c * dinv, 108,648
//     of lung2's backward sweep) go to a multi-block kernel launched
//     first on the same stream.
//
// Built by kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeaderWords = 4;    // lanes, long lanes, flags, 0
constexpr int kEndsStep = 1;       // header flags: the tile ends its step
constexpr int kNarrowRun = 2;      //   the tile holds a run of narrow steps
constexpr int kCountMask = 0x7fffffff;   // lane record .w: dep count, and
                                         // bit 31: last lane of its step
constexpr int kMaxStages = 16;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;   // full + empty
constexpr int kProducerThreads = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// TMA bulk copy global -> shared; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the step barrier: consumer warps only (the producer never joins)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("barrier.sync 1, %0;" :: "r"(threads) : "memory");
}

// the SM's cycle counter; the "memory" clobber keeps the read in place
// among the step's loads, stores and barriers
__device__ __forceinline__ long long clock_stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kChunk deps of one lane, e = first, first + step, ...: their gathers of
// x (column r of the row-major (n+1, R) x; kOneCol is K1, R == 1) and
// coefficients, zero from `count` on.  All kChunk loads go out before any
// FMA waits on one, so a lane pays one trip to L1/L2 per chunk.
template <bool kOneCol, int kChunk>
struct Chunk {
  float v[kChunk], cf[kChunk];

  __device__ __forceinline__ void load(const int2* dep, int first, int step,
                                       int count, const float* x, int R,
                                       int r) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int e = first + k * step;
      v[k] = 0.0f;
      cf[k] = 0.0f;
      if (e < count) {
        const int2 d = dep[e];
        cf[k] = __int_as_float(d.y);
        v[k] = x[kOneCol ? (size_t)d.x : (size_t)d.x * R + r];
      }
    }
  }

  __device__ __forceinline__ float dot(float tot) const {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) tot = fmaf(cf[k], v[k], tot);
    return tot;
  }
};

// sum coef * x[idx] over deps first, first + step, ... < count, kChunk
// at a time, the next chunk's loads in flight while this one's FMAs wait
template <bool kOneCol, int kChunk>
__device__ __forceinline__ float gather_dot(const int2* dep, int first,
                                            int step, int count,
                                            const float* x, int R, int r) {
  Chunk<kOneCol, kChunk> a, b;
  float tot = 0.0f;
  a.load(dep, first, step, count, x, R, r);
  for (int e = first + kChunk * step;; e += 2 * kChunk * step) {
    if (e >= count) return a.dot(tot);
    b.load(dep, e, step, count, x, R, r);
    tot = a.dot(tot);
    if (e + kChunk * step >= count) return b.dot(tot);
    a.load(dep, e + kChunk * step, step, count, x, R, r);
    tot = b.dot(tot);
  }
}

// One short lane and column: x[row] = (c[row] - sum coef * x[idx]) * dinv.
// Its first 4 deps (lung2's rows hold 1-3) go out in a short chunk and
// the rest in chunks of 8 behind them: a lane of up to 12 deps pays one
// trip to L1/L2.
template <bool kOneCol>
__device__ __forceinline__ void solve_short(const int4 L, const int* w,
                                            float cr, int r, int R,
                                            float* x) {
  const int2* dep = reinterpret_cast<const int2*>(w + L.z);
  const int count = L.w & kCountMask;
  Chunk<kOneCol, 4> head;
  head.load(dep, 0, 1, count, x, R, r);
  float tot = 0.0f;
  for (int e = 4; e < count; e += 8) {
    Chunk<kOneCol, 8> rest;
    rest.load(dep, e, 1, count, x, R, r);
    tot = rest.dot(tot);
  }
  tot = head.dot(tot);
  x[kOneCol ? (size_t)L.x : (size_t)L.x * R + r] =
      (cr - tot) * __int_as_float(L.y);
}

// a row too long for a tile: its pairs in device memory.  Out of line:
// a second inlined copy of the gather in the long-lane loop cost K1 7% on
// lung2's IC(0) L^T and 1-4% elsewhere (registers, on an H100)
template <bool kOneCol>
__device__ __noinline__ float far_dot(const int2* dep, int lane, int count,
                                      const float* x, int R, int r) {
  return gather_dot<kOneCol, 4>(dep, lane, 32, count, x, R, r);
}

// Four columns at once (K2 with R % 4 == 0): float4 gathers of x.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// sum coef * x[idx, col..col+3] over deps first, first + step, ... <
// count, 8 deps' float4 gathers in flight per trip to L1/L2
__device__ __forceinline__ float4 gather_dot4(const int2* dep, int first,
                                              int step, int count,
                                              const float* x, int R,
                                              int col) {
  float4 tot = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e0 = first; e0 < count; e0 += 8 * step) {
    float4 v[8];
    float cf[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * step;
      v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      cf[k] = 0.0f;
      if (e < count) {
        const int2 d = dep[e];
        cf[k] = __int_as_float(d.y);
        v[k] = ld4(x + (size_t)d.x * R + col);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      tot.x = fmaf(cf[k], v[k].x, tot.x);
      tot.y = fmaf(cf[k], v[k].y, tot.y);
      tot.z = fmaf(cf[k], v[k].z, tot.z);
      tot.w = fmaf(cf[k], v[k].w, tot.w);
    }
  }
  return tot;
}

__device__ __forceinline__ void store4(float* x, float4 cr, float4 tot,
                                       float dinv) {
  *reinterpret_cast<float4*>(x) =
      make_float4((cr.x - tot.x) * dinv, (cr.y - tot.y) * dinv,
                  (cr.z - tot.z) * dinv, (cr.w - tot.w) * dinv);
}

// One short lane and kW columns from col on (kW = 4: float4 gathers).
template <bool kOneCol, int kW>
__device__ __forceinline__ void solve_item(const int4 L, const int* w,
                                           const float* c, int col, int R,
                                           float* x) {
  if constexpr (kW == 4) {
    const float4 cr = ld4(c + (size_t)L.x * R + col);
    store4(x + (size_t)L.x * R + col, cr,
           gather_dot4(reinterpret_cast<const int2*>(w + L.z), 0, 1,
                       L.w & kCountMask, x, R, col),
           __int_as_float(L.y));
  } else {
    solve_short<kOneCol>(L, w, c[(size_t)L.x * R + col], col, R, x);
  }
}

// Threads [0, consumers) consume tiles; the last warp produces them.  An
// item is a short lane and kW of its R columns (kW = 1, or 4 when R % 4 ==
// 0), so a lane has R / kW items.
//
// kStamp (K1's stamped form, for the per-step profile) records clock64()
// into stamps (S + 2 int64 for S tile steps): [0] at the kernel's entry,
// [1] when the consumers start, [2 + k] when tile step k has ended: for a
// wide step, thread 0 after the step's barrier; for a narrow step, warp
// 0's lane 0 after its __syncwarp.  Warp 0 takes part in every step, so
// it alone counts the steps (`ended`), and a step's span is stamp to
// stamp on the critical path.  Without kStamp the stamps compile away.
template <bool kOneCol, int kW, bool kStamp>
__global__ void __launch_bounds__(1024, 1)
sptrsv_tiles_kernel(const int4* __restrict__ tiles,
                    const int* __restrict__ tile_ptr, int num_tiles,
                    const int2* __restrict__ far,
                    const float* __restrict__ c, float* x, int R,
                    int stage_bytes, int num_stages,
                    long long* __restrict__ stamps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + kBarrierBytes;
  const int consumers = blockDim.x - kProducerThreads;
  const int cwarps = consumers >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = kOneCol ? 1 : R;
  const int per_lane = kOneCol ? 1 : R / kW;      // items of a short lane

  if (threadIdx.x == 0) {
    if constexpr (kStamp) stamps[0] = clock_stamp();
    for (int s = 0; s < num_stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == cwarps) {                     // producer warp
    // the warp loads the offsets of 32 tiles at a time, one chunk ahead,
    // so that lane 0 never waits on a global load between two copies
    int lo = tile_ptr[min(lane, num_tiles)];
    int hi = tile_ptr[min(lane + 1, num_tiles)];
    int s = 0, use = 0;
    for (int t0 = 0; t0 < num_tiles; t0 += 32) {
      const int lo_next = tile_ptr[min(t0 + 32 + lane, num_tiles)];
      const int hi_next = tile_ptr[min(t0 + 33 + lane, num_tiles)];
      const int count = min(32, num_tiles - t0);
      for (int j = 0; j < count; ++j) {
        const int a = __shfl_sync(0xffffffffu, lo, j);
        const int b = __shfl_sync(0xffffffffu, hi, j);
        if (lane == 0) {
          if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
          const unsigned bytes = 16u * (unsigned)(b - a);
          mbar_expect_tx(&full[s], bytes);
          bulk_load(ring + (size_t)s * stage_bytes, tiles + a, bytes,
                    &full[s]);
        }
        if (++s == num_stages) { s = 0; ++use; }
        __syncwarp();
      }
      lo = lo_next;
      hi = hi_next;
    }
    return;
  }

  const int tid = threadIdx.x;
  int s = 0;
  unsigned phase = 0;
  int pending = 0;          // what ended last: 1 a wide step, 2 a narrow one
  int rot = 0, lrot = 0;    // items / long lanes of the step before the tile
  int ended = 0;            // kStamp: tile steps ended (warp 0 counts)
  if constexpr (kStamp) {
    if (tid == 0) stamps[1] = clock_stamp();
  }
  for (int t = 0; t < num_tiles; ++t) {
    mbar_wait(&full[s], phase);
    const int* w = reinterpret_cast<const int*>(ring + (size_t)s * stage_bytes);
    const int n_lanes = w[0], n_long = w[1], flags = w[2];
    const bool ends = flags & kEndsStep;
    const int4* rec = reinterpret_cast<const int4*>(w + kHeaderWords);
    const int items = (n_lanes - n_long) * per_lane;
    if (flags & kNarrowRun) {
      // a run of narrow steps (each at most 32 lanes, none long): warp 0
      // solves them alone, step after step, ordering its writes with
      // __syncwarp; the other warps go on to the next tile
      if (pending == 1) {
        consumer_sync(consumers);
        if constexpr (kStamp) {
          if (tid == 0) stamps[1 + ended] = clock_stamp();
        }
      }
      if (warp == 0) {
        for (int pos = 0; pos < n_lanes;) {
          // the step's lanes end at the first lane flagged last
          const int mine = pos + lane;
          const int4 L = mine < n_lanes ? rec[mine] : make_int4(0, 0, 0, 0);
          int len = __ffs(__ballot_sync(0xffffffffu, L.w < 0));
          if (len == 0) len = min(32, n_lanes - pos);   // never: packing
          for (int i = lane; i < len * per_lane; i += 32) {
            const int q = kOneCol ? i : i / per_lane;
            const int4 Li = kOneCol ? L : rec[pos + q];
            solve_item<kOneCol, kW>(Li, w, c, (i - q * per_lane) * kW, cols,
                                    x);
          }
          __syncwarp();
          if constexpr (kStamp) {
            ++ended;
            if (lane == 0) stamps[1 + ended] = clock_stamp();
          }
          pos += len;
        }
      }
      pending = 2;
    } else {
      int first = tid - rot;
      if (first < 0) first += consumers;
      // what does not depend on x, read before the step barrier (at
      // R == 1 c[row] too: solve_short takes it as a value)
      int4 rec0 = make_int4(0, 0, 0, 0);
      float c0 = 0.0f;
      if (first < items) {
        rec0 = rec[n_long + (kOneCol ? first : first / per_lane)];
        if constexpr (kOneCol) c0 = c[rec0.x];
      }
      if (pending != 0) {
        consumer_sync(consumers);
        if constexpr (kStamp) {
          if (pending == 1 && tid == 0) stamps[1 + ended] = clock_stamp();
        }
      }

      // long lanes: one warp each, a strided sum and a shuffle reduction;
      // the pairs of a row too long for a tile come from `far`
      int l = warp - lrot;
      if (l < 0) l += cwarps;
      for (; l < n_long; l += cwarps) {
        const int4 L = rec[l];
        const int count = L.w & kCountMask;
        if constexpr (kW == 4) {
          for (int col = 0; col < cols; col += 4) {
            float4 t = L.z >= 0
                ? gather_dot4(reinterpret_cast<const int2*>(w + L.z), lane,
                              32, count, x, cols, col)
                : gather_dot4(far + ~L.z, lane, 32, count, x, cols, col);
            t.x = warp_sum(t.x);
            t.y = warp_sum(t.y);
            t.z = warp_sum(t.z);
            t.w = warp_sum(t.w);
            if (lane == 0) {
              store4(x + (size_t)L.x * cols + col,
                     ld4(c + (size_t)L.x * cols + col), t,
                     __int_as_float(L.y));
            }
          }
          continue;
        }
        for (int r = 0; r < cols; ++r) {
          const float cr = c[(size_t)L.x * cols + r];
          const float tot = warp_sum(
              L.z >= 0
                  ? gather_dot<kOneCol, 4>(
                        reinterpret_cast<const int2*>(w + L.z), lane, 32,
                        count, x, cols, r)
                  : far_dot<kOneCol>(far + ~L.z, lane, count, x, cols, r));
          if (lane == 0) {
            x[(size_t)L.x * cols + r] = (cr - tot) * __int_as_float(L.y);
          }
        }
      }

      // short lanes: one thread per item
      for (int i = first; i < items; i += consumers) {
        const int q = kOneCol ? i : i / per_lane;
        const int4 L = i == first ? rec0 : rec[n_long + q];
        if constexpr (kOneCol) {
          solve_short<true>(L, w, i == first ? c0 : c[L.x], 0, 1, x);
        } else {
          solve_item<false, kW>(L, w, c, (i - q * per_lane) * kW, cols, x);
        }
      }
      pending = ends ? 1 : 0;
      if constexpr (kStamp) ended += ends;
      // rotate the next tile of this step by what this one handed out
      for (rot += items; rot >= consumers; rot -= consumers) {}
      for (lrot += n_long; lrot >= cwarps; lrot -= cwarps) {}
    }
    if (ends) rot = lrot = 0;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage may be refilled
    if (++s == num_stages) { s = 0; phase ^= 1; }
  }
  if constexpr (kStamp) {
    if (pending == 1) {                     // the last step was wide
      consumer_sync(consumers);
      if (tid == 0) stamps[1 + ended] = clock_stamp();
    }
  }
}

// x = c * dinv for the dependency-free rows, many blocks
__global__ void sptrsv_free_rows_kernel(const int* __restrict__ row,
                                        const float* __restrict__ dinv,
                                        int num_free,
                                        const float* __restrict__ c,
                                        float* x, int R) {
  const long long items = (long long)num_free * R;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i / R), r = (int)(i - (long long)k * R);
    const size_t at = (size_t)row[k] * R + r;
    x[at] = c[at] * dinv[k];
  }
}

bool bad_config(int threads, int stage_bytes, int num_stages, int R) {
  return threads < 64 || threads > 1024 || threads % 32 != 0 ||
         num_stages < 1 || num_stages > kMaxStages || stage_bytes % 16 != 0 ||
         R < 1;
}

cudaError_t launch_free(const int* free_row, const float* free_dinv,
                        int num_free, const float* c, float* x, int R,
                        cudaStream_t st) {
  if (num_free > 0) {
    const long long items = (long long)num_free * R;
    const int blocks = (int)((items + 255) / 256 < 1056 ? (items + 255) / 256
                                                         : 1056);
    sptrsv_free_rows_kernel<<<blocks, 256, 0, st>>>(free_row, free_dinv,
                                                    num_free, c, x, R);
  }
  return cudaGetLastError();
}

template <bool kOneCol, int kW, bool kStamp>
cudaError_t launch_tiles(const void* tiles, const int* tile_ptr,
                         int num_tiles, const void* far, const float* c,
                         float* x, int R, int threads, int stage_bytes,
                         int num_stages, long long* stamps,
                         cudaStream_t st) {
  if (num_tiles > 0) {
    const int smem = kBarrierBytes + num_stages * stage_bytes;
    auto kernel = sptrsv_tiles_kernel<kOneCol, kW, kStamp>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<1, threads, smem, st>>>(static_cast<const int4*>(tiles),
                                     tile_ptr, num_tiles,
                                     static_cast<const int2*>(far), c, x, R,
                                     stage_bytes, num_stages, stamps);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the solve on `stream`: the dependency-free pass (when
// num_free > 0), then the tile kernel with `threads` threads (consumers
// plus one producer warp) and a ring of num_stages x stage_bytes; `far`
// holds the (index, coef) pairs of rows too long for a tile.
// Returns the first cudaError_t (0 on success).  x (n+1, R) is allocated
// (and zeroed) by the caller; the kernels allocate nothing.
extern "C" int sptrsv_tiles_launch(const void* tiles, const int* tile_ptr,
                                   int num_tiles, const void* far,
                                   const int* free_row,
                                   const float* free_dinv, int num_free,
                                   const float* c, float* x, int R,
                                   int threads, int stage_bytes,
                                   int num_stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_config(threads, stage_bytes, num_stages, R)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R > 1 && R % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(x)) &
       15) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);   // float4 path
  }
  cudaError_t err = launch_free(free_row, free_dinv, num_free, c, x, R, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto launch = R == 1       ? launch_tiles<true, 1, false>
                : R % 4 == 0 ? launch_tiles<false, 4, false>
                             : launch_tiles<false, 1, false>;
  return static_cast<int>(launch(tiles, tile_ptr, num_tiles, far, c, x, R,
                                 threads, stage_bytes, num_stages, nullptr,
                                 st));
}

// K1's stamped form, in two launches so that each can be timed by events:
// the dependency-free pass alone, then the tile kernel with kStamp,
// which writes num_steps + 2 clock64() stamps (see sptrsv_tiles_kernel)
// for the tile steps' num_steps.  R == 1.
extern "C" int sptrsv_free_launch(const int* free_row, const float* free_dinv,
                                  int num_free, const float* c, float* x,
                                  void* stream) {
  return static_cast<int>(launch_free(free_row, free_dinv, num_free, c, x, 1,
                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int sptrsv_tiles_stamped_launch(const void* tiles,
                                           const int* tile_ptr, int num_tiles,
                                           const void* far, const float* c,
                                           float* x, int threads,
                                           int stage_bytes, int num_stages,
                                           long long* stamps, void* stream) {
  if (bad_config(threads, stage_bytes, num_stages, 1) || stamps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_tiles<true, 1, true>(
      tiles, tile_ptr, num_tiles, far, c, x, 1, threads, stage_bytes,
      num_stages, stamps, static_cast<cudaStream_t>(stream)));
}
