// ELL sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spmv_ell_pallas (K4) of
// src/repro/kernels/spmv_ell.py.  What it computes, for every row i of
// the padded ELL arrays (n_rows = n_pad rows, D slots each, row-major):
//
//     y[i] = sum_d coef[i, d] * x_pad[idx[i, d]]
//
// Rows are independent.  Padding slots index the zero last entry of x_pad
// with coefficient 0, and padding rows (n <= i < n_pad) come out 0, so
// the kernel needs no masks beyond the grid's ragged edge.  float32 and
// float64 share one template, as the TPU kernel runs in ell_coef's dtype.
//
// What bounds it on this card: bytes.  A product does one FMA per slot
// (2 * n_pad * D operations) but reads an index and a coefficient per
// slot, a gathered x entry per slot and writes y once: far below the
// ~20 operations per byte at which the H100's float32 units, rather than
// its 3.35 TB/s of HBM, would set the pace.
//
// What the design does about it (the simple, correct first version):
//   * One thread per row loops over the row's D slots and keeps the sum
//     in a register; y is written once, coalesced.
//   * idx, coef and x are read through the read-only path (__ldg): x is
//     gathered at random, and its n entries (at most a few MB) stay in
//     the 50 MB L2 after their first use.
// Known limits: the row-major ELL makes neighbouring threads read
// addresses D elements apart, so idx/coef loads are not coalesced, and
// every padding slot is read.  A column-major ELL (coalesced), or a
// CSR-vector kernel for rows as skewed as lung2's (one row of 2,143
// entries pads every row to that width), is later work.
//
// Built by kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int* __restrict__ idx, const T* __restrict__ coef,
                const T* __restrict__ x, T* __restrict__ y, int n_rows,
                int D) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  T acc = T(0);
  for (int d = 0; d < D; ++d) {
    acc = fma_t(__ldg(coef + base + d), __ldg(x + __ldg(idx + base + d)),
                acc);
  }
  y[row] = acc;
}

template <typename T>
int launch(const int* idx, const T* coef, const T* x, T* y, int n_rows,
           int D, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  spmv_ell_kernel<T><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(idx, coef, x, y,
                                                            n_rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch y (n_rows,) = ELL(idx, coef) @ x on `stream`; returns the
// cudaError_t of the launch (0 on success).  The kernel allocates nothing
// and writes every entry of y.
extern "C" int spmv_ell_f32_launch(const int* idx, const float* coef,
                                   const float* x, float* y, int n_rows,
                                   int D, void* stream) {
  return launch<float>(idx, coef, x, y, n_rows, D, stream);
}

extern "C" int spmv_ell_f64_launch(const int* idx, const double* coef,
                                   const double* x, double* y, int n_rows,
                                   int D, void* stream) {
  return launch<double>(idx, coef, x, y, n_rows, D, stream);
}
