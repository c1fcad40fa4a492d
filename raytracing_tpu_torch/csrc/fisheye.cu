// fisheye_op1: op1 on the analytic Maxwell fisheye, final state only.
//
// Replaces raytracing_tpu/kernels/fisheye.py::_fisheye_kernel (fisheye.py:33,
// launched at fisheye.py:106).  Same arithmetic: first-order Kahan-
// compensated positions, the trig-free tangent normalize(n u + (grad n0 +
// grad n1) ds/2), trapezoid traveltime.
//
// One thread per ray; the whole state (x, y, cx, cy, ux, uy, n, gx, gy, tt)
// lives in registers for every step, and each ray is read and written once
// as coalesced struct-of-arrays planes (7 x 4 bytes a ray).  The loop is
// fisheye.cuh's fisheye_op1_run: a step issues 43.5 instructions on its
// usual path (fma_probe --sass fisheye_op1, PERF.md section 5): 35 counted
// FP32 operations, the reciprocal's MUFU.RCP and two FFMA, one MUFU.RSQ,
// two guard compares and a share of the guard branch, the loop and the
// carry.  Against 28 bytes per ray for the whole run, so at thousands of
// steps the kernel is bound by FP32 issue, not memory: the design keeps
// every step's traffic in registers and masks the ragged edge instead of
// padding.
#include "fisheye.cuh"

namespace rt {

__global__ void __launch_bounds__(kThreads)
fisheye_op1_kernel(const float* __restrict__ x0, const float* __restrict__ y0,
                   const float* __restrict__ ux0, const float* __restrict__ uy0,
                   float* __restrict__ out_x, float* __restrict__ out_y,
                   float* __restrict__ out_tt, int n_rays, int steps, float ds) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  fisheye_op1_run(x0[r], y0[r], ux0[r], uy0[r], steps, ds, out_x[r],
                  out_y[r], out_tt[r]);
}

}  // namespace rt

extern "C" int rt_fisheye_op1(const void* x, const void* y, const void* ux,
                              const void* uy, void* out_x, void* out_y,
                              void* out_tt, int n, int steps, float ds,
                              void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + rt::kThreads - 1) / rt::kThreads;
  rt::fisheye_op1_kernel<<<blocks, rt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(ux), static_cast<const float*>(uy),
      static_cast<float*>(out_x), static_cast<float*>(out_y),
      static_cast<float*>(out_tt), n, steps, ds);
  return static_cast<int>(cudaGetLastError());
}
