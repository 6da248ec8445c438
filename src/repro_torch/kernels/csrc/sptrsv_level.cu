// Level-scheduled SpTRSV for Hopper (sm_90a), one thread block per solve.
//
// Replaces the Pallas TPU kernels sptrsv_groups_pallas (K1) and
// sptrsv_groups_pallas_multi (K2) of src/repro/kernels/sptrsv_level.py.
// What they compute, for s = 0..S-1 in order and every lane of step s:
//
//     tot             = sum_d coef[d] * x[idx[d]] + carry[carry_in]
//     x[row]          = (c[row] - tot) * dinv        (final lanes, row < n)
//     carry[carry_out]= tot                          (partial-row lanes)
//
// with R right-hand sides solved side by side (K1 is R == 1).
//
// What bounds it on this card: the S dependent steps.  A step has a few
// hundred lanes, so the bytes it moves (the schedule once, c once, x once:
// a few MB per solve) take microseconds at 3.35 TB/s; the time is S times
// the latency of one step (lane metadata load -> dependent gather of x ->
// FMA chain -> store -> barrier).
//
// What the design does about it (the simple, correct first version):
//   * One launch per solve and one block of up to 1024 threads that loops
//     over the steps; __syncthreads() ends a step.  Within one block the
//     barrier makes the step's global writes visible to every thread of
//     the next step, and the schedule compiler guarantees that no lane
//     reads a row or carry finalized in its own step, so lanes of a step
//     need no ordering among themselves.  No per-step launch overhead.
//   * x, carry and c live in device memory (lung2's x is 438 KB, over the
//     227 KB of shared memory); the working set stays in the 50 MB L2.
//     x and carry are read with plain loads (never the read-only path),
//     since they are written during the kernel.
//   * The schedule is repacked on the host into a step-major lane list
//     with padding lanes and zero-coefficient padding slots dropped
//     (kernels/sptrsv_level.py: pack_schedule), so a thread touches only
//     real work.
// Known limit: one block runs on one of the 132 SMs.  A persistent
// multi-block kernel with a grid barrier, or per-step launches replayed
// as a CUDA graph, is later work.
//
// Built by kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024)
sptrsv_levels_kernel(const int* __restrict__ step_ptr,
                     const int* __restrict__ lane_row,
                     const int* __restrict__ lane_cin,
                     const int* __restrict__ lane_cout,
                     const float* __restrict__ lane_dinv,
                     const int* __restrict__ dep_ptr,
                     const int* __restrict__ dep_idx,
                     const float* __restrict__ dep_coef,
                     const float* __restrict__ c,
                     float* x, float* carry,
                     int num_steps, int n, int n_carry, int R) {
  for (int s = 0; s < num_steps; ++s) {
    const int lo = step_ptr[s];
    const int items = (step_ptr[s + 1] - lo) * R;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int lane = lo + it / R;
      const int r = it - (it / R) * R;
      float tot = 0.0f;
      const int e_end = dep_ptr[lane + 1];
      for (int e = dep_ptr[lane]; e < e_end; ++e) {
        tot = fmaf(dep_coef[e], x[(size_t)dep_idx[e] * R + r], tot);
      }
      tot += carry[(size_t)lane_cin[lane] * R + r];
      const int row = lane_row[lane];
      if (row < n) {
        x[(size_t)row * R + r] = (c[(size_t)row * R + r] - tot) *
                                 lane_dinv[lane];
      }
      const int cout = lane_cout[lane];
      if (cout < n_carry) {
        carry[(size_t)cout * R + r] = tot;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the solve on `stream`; returns the cudaError_t of the launch
// (0 on success).  x (n+1, R) and carry (n_carry+2, R) must be zeroed by
// the caller; the kernel allocates nothing.
extern "C" int sptrsv_levels_launch(
    const int* step_ptr, const int* lane_row, const int* lane_cin,
    const int* lane_cout, const float* lane_dinv, const int* dep_ptr,
    const int* dep_idx, const float* dep_coef, const float* c, float* x,
    float* carry, int num_steps, int n, int n_carry, int R, int threads,
    void* stream) {
  sptrsv_levels_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      step_ptr, lane_row, lane_cin, lane_cout, lane_dinv, dep_ptr, dep_idx,
      dep_coef, c, x, carry, num_steps, n, n_carry, R);
  return static_cast<int>(cudaGetLastError());
}
