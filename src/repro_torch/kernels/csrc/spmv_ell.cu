// ELL sparse matrix-vector product for Hopper (sm_90a), on a row-sorted
// sliced ELL.
//
// Replaces the Pallas TPU kernel spmv_ell_pallas (K4) of
// src/repro/kernels/spmv_ell.py.  What it computes, for every row i of
// the padded ELL arrays (n_rows = n_pad rows):
//
//     y[i] = sum_d coef[i, d] * x_pad[idx[i, d]]
//
// Rows are independent.  float32 and float64 share one template, as the
// TPU kernel runs in ell_coef's dtype.
//
// What bounds it on this card: bytes.  A product does one FMA per slot but
// reads an index and a coefficient per slot, a gathered x entry per slot
// and writes y once: far below the ~20 operations per byte at which the
// H100's float32 units, rather than its 3.35 TB/s of HBM, would set the
// pace.  Tensor cores have no role here.
//
// What the design does about it.  The kernel never reads the row-major
// ELL: kernels/spmv_ell.py packs it once into a sliced form (SlicedEll)
// that stores only the slots a row needs and lays them out for coalesced
// loads.  Rows are sorted by length within windows of SIGMA rows and cut
// into 32-row slices, each padded only to its own widest row and stored
// column-major; rows longer than LONG_SLOTS go to a CSR-like list.
//   * Slice warps (warp ids 0..num_slices-1): one warp per slice, lane i
//     owns row row_of[32 s + i].  The warp steps over the slice's width d:
//     one step reads 128 B of idx and 128 or 256 B of coef, coalesced.
//     The step loop is unrolled by kUnroll, loads first, so kUnroll
//     index/coefficient loads and then kUnroll gathers of x are in flight
//     at once; the sum stays in a register, added in slot order, and y is
//     written once (lanes past the last row write nothing).
//   * Long-row warps (the warp ids after them): one warp per long row,
//     lanes striding over its slots (lane, lane + 32, ...), unrolled by
//     kLongUnroll (a long row's warp is alone on the row's latency
//     chain: lung2's longest holds 2,143 slots), then a __shfl_xor_sync
//     tree; lane 0 writes y.  This mirrors the SpTRSV kernel's long lanes
//     (csrc/sptrsv_level.cu).
//   * idx, coef and the pointers are read through the read-only path
//     (__ldg); x is gathered at random, and its n entries (at most a few
//     MB) stay in the 50 MB L2 after their first use.
//   * The grid is sized for the card: as many 256-thread blocks as the
//     warps need, at most the SMs times the blocks an SM holds at once,
//     with a grid-stride loop over warps beyond that.
// Padding slots of a slice index the zero last entry of x_pad with
// coefficient 0, so the loop needs no mask.
//
// Built by kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;        // slots in flight per lane, slice warps
constexpr int kLongUnroll = 8;    // the same, long-row warps
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// sum over k = first, first + step, ... < end of coef[k] * x[idx[k]], in
// that order, U terms' loads issued before their FMAs
template <int U, typename T>
__device__ __forceinline__ T strided_sum(const int* __restrict__ idx,
                                         const T* __restrict__ coef,
                                         const T* __restrict__ x, int first,
                                         int end, int step) {
  T acc = T(0);
  int k = first;
  for (; k + (U - 1) * step < end; k += U * step) {
    int j[U];
    T c[U], v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      j[u] = __ldg(idx + k + u * step);
      c[u] = __ldg(coef + k + u * step);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(x + j[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) acc = fma_t(c[u], v[u], acc);
  }
  for (; k < end; k += step) {
    acc = fma_t(__ldg(coef + k), __ldg(x + __ldg(idx + k)), acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int* __restrict__ slice_ptr,
                const int* __restrict__ row_of, const int* __restrict__ idx,
                const T* __restrict__ coef,
                const int* __restrict__ long_rows,
                const int* __restrict__ long_ptr,
                const int* __restrict__ long_idx,
                const T* __restrict__ long_coef, const T* __restrict__ x,
                T* __restrict__ y, int num_slices, int num_long) {
  const int lane = threadIdx.x & 31;
  const int total = num_slices + num_long;
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < total;
       w += gridDim.x * kWarps) {
    if (w < num_slices) {
      const int beg = __ldg(slice_ptr + w);
      const int end = __ldg(slice_ptr + w + 1);
      const int row = __ldg(row_of + w * 32 + lane);
      const T acc = strided_sum<kUnroll>(idx, coef, x, beg + lane, end, 32);
      if (row >= 0) y[row] = acc;
    } else {
      const int j = w - num_slices;
      T acc = strided_sum<kLongUnroll>(long_idx, long_coef, x,
                                       __ldg(long_ptr + j) + lane,
                                       __ldg(long_ptr + j + 1), 32);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      }
      if (lane == 0) y[__ldg(long_rows + j)] = acc;
    }
  }
}

// blocks of spmv_ell_kernel<T> resident on the card at once, per device
template <typename T>
int max_blocks(int* err) {
  static int cached[kMaxDevices];
  int dev = 0;
  *err = static_cast<int>(cudaGetDevice(&dev));
  if (*err != 0) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  *err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (*err == 0) {
    *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spmv_ell_kernel<T>, kThreads, 0));
  }
  if (*err != 0) return 0;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = blocks;
  return blocks;
}

template <typename T>
int launch(const int* slice_ptr, const int* row_of, const int* idx,
           const T* coef, const int* long_rows, const int* long_ptr,
           const int* long_idx, const T* long_coef, const T* x, T* y,
           int num_slices, int num_long, void* stream) {
  const int warps = num_slices + num_long;
  if (warps <= 0) return 0;
  int err = 0;
  const int cap = max_blocks<T>(&err);
  if (err != 0) return err;
  int blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > cap) blocks = cap;
  spmv_ell_kernel<T><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      slice_ptr, row_of, idx, coef, long_rows, long_ptr, long_idx, long_coef,
      x, y, num_slices, num_long);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch y (n_rows,) = SlicedEll @ x on `stream`; returns the cudaError_t
// of the launch (0 on success).  The kernel allocates nothing and writes
// every row that the packed form holds (all of y: every row lands in a
// slice or in the long list).
extern "C" int spmv_ell_f32_launch(const int* slice_ptr, const int* row_of,
                                   const int* idx, const float* coef,
                                   const int* long_rows, const int* long_ptr,
                                   const int* long_idx,
                                   const float* long_coef, const float* x,
                                   float* y, int num_slices, int num_long,
                                   void* stream) {
  return launch<float>(slice_ptr, row_of, idx, coef, long_rows, long_ptr,
                       long_idx, long_coef, x, y, num_slices, num_long,
                       stream);
}

extern "C" int spmv_ell_f64_launch(const int* slice_ptr, const int* row_of,
                                   const int* idx, const double* coef,
                                   const int* long_rows, const int* long_ptr,
                                   const int* long_idx,
                                   const double* long_coef, const double* x,
                                   double* y, int num_slices, int num_long,
                                   void* stream) {
  return launch<double>(slice_ptr, row_of, idx, coef, long_rows, long_ptr,
                        long_idx, long_coef, x, y, num_slices, num_long,
                        stream);
}
