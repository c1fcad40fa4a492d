// dynamic_step, dynamic_step_strat and dynamic_step_grid: the dynamic
// integrator (kinematics plus the paraxial tangent d(state)/d(theta0), the
// KMAH caustic count, Kahan carries) for op1/op2/op6/op8, one step loop
// instantiated on three media (media.cuh nag_h).
//
// Replaces raytracing_tpu/kernels/dynamic.py::_make_dynamic_kernel
// (dynamic.py:347-586):
// * dynamic_step: the analytic fields of _field_fn_h, launched at
//   dynamic.py:646 (dynamic_trace_final), rt_dynamic_step (row 11 of the
//   kernel table in PERF.md);
// * dynamic_step_strat: the stratified tables of _strat_nag_h, launched at
//   dynamic.py:722 (dynamic_trace_final_strat), rt_dynamic_step_strat
//   (row 12);
// * dynamic_step_grid: the 2-D per-cell tables of _tile_nag_h /
//   _tile_nag_c1_h, launched in resume form at engine/segmented.py:1702
//   (grid_trace_dynamic_tiled), rt_dynamic_step_grid (row 8).
//
// All three read and write the 18 state planes of JAX's resume layout
// (segmented.py:1844-1850: x, y, cx, cy, ux, uy, tt, dsim, active, dpx, dpy,
// dth, sgn, kmah, kdx, kdy, kdt, ktt) with a global step offset, so k steps
// then n - k equal n steps; the JAX analytic and stratified kernels take
// (pos0, theta0) instead, which is the launch state dth = 1, active = 1,
// everything else 0.  The TPU's tiled grid window, Morton sort and replay
// ladder are not ported: every ray reads its own cell's row of the whole
// table (media.cuh Grid), so one launch serves any grid.
//
// One thread per ray, the state and the nine field channels in registers
// across every step; the field is evaluated once a step, after the move,
// and carried.  A step is ~190-370 FP32 operations against 140 bytes of
// state a ray for the whole launch (plus a 32-144-byte table row a step on
// the sampled media, served by L1/L2), so the kernel is bound by FP32
// issue.  A thread leaves its loop once its ray is frozen (box exit or the
// step limit): a frozen ray's state never changes again.
//
// The step loop, its carry and the state planes are in dynamic.cuh, whose
// __host__ __device__ functions the CPU tests also build with g++.
#include "dynamic.cuh"

namespace rt {

template <class Medium, int OP>
__global__ void __launch_bounds__(kThreads)
    dynamic_kernel(DynArgs a, Medium medium) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  Dyn s = load_dyn(a, r);
  run_dyn<Medium, OP>(a, medium, s);
  store_dyn(a, r, s);
}

template <class Medium>
static int launch_dynamic(int op, const DynArgs& a, const Medium& m,
                          cudaStream_t s) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  switch (op) {
    case 1: dynamic_kernel<Medium, 1><<<blocks, kThreads, 0, s>>>(a, m); break;
    case 2: dynamic_kernel<Medium, 2><<<blocks, kThreads, 0, s>>>(a, m); break;
    case 6: dynamic_kernel<Medium, 6><<<blocks, kThreads, 0, s>>>(a, m); break;
    case 8: dynamic_kernel<Medium, 8><<<blocks, kThreads, 0, s>>>(a, m); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

static DynArgs dynamic_args(void* const* in, void* const* out, int n,
                            int steps, float ds, float limit, float offset,
                            float limx_i, float limx_s, float limy_i,
                            float limy_s) {
  DynArgs a;
  for (int k = 0; k < NDSLOTS; ++k) {
    a.in.p[k] = in[k];
    a.out.p[k] = out[k];
  }
  a.n = n;
  a.steps = steps;
  a.ds = ds;
  a.limit = limit;
  a.offset = offset;
  a.box[0] = limx_i;
  a.box[1] = limx_s;
  a.box[2] = limy_i;
  a.box[3] = limy_s;
  return a;
}

}  // namespace rt

#define RT_DYN_PARAMS                                                       \
  int op, void *const *in, void *const *out, int n, int steps, float ds,    \
      float limit, float offset, float limx_i, float limx_s, float limy_i, \
      float limy_s
#define RT_DYN_ARGS                                                       \
  rt::dynamic_args(in, out, n, steps, ds, limit, offset, limx_i, limx_s, \
                   limy_i, limy_s)

// dynamic_step: the analytic fields (row 11 of the kernel table)
extern "C" int rt_dynamic_step(int field, RT_DYN_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt::DynArgs a = RT_DYN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case rt::FISHEYE:
      return rt::launch_dynamic(op, a, rt::Analytic<rt::FISHEYE>{}, s);
    case rt::VERT:
      return rt::launch_dynamic(op, a, rt::Analytic<rt::VERT>{}, s);
    case rt::INTERFACE:
      return rt::launch_dynamic(op, a, rt::Analytic<rt::INTERFACE>{}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic_step_strat: 1-D stratified tables, ch = 6 (parity) or 4 (C1); row 12
extern "C" int rt_dynamic_step_strat(int ch, RT_DYN_PARAMS, RT_TABLE_PARAMS,
                                     void* stream) {
  if (n <= 0) return 0;
  const rt::DynArgs a = RT_DYN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 6: return rt::launch_dynamic(op, a, rt::Strat<6>{RT_TABLE}, s);
    case 4: return rt::launch_dynamic(op, a, rt::Strat<4>{RT_TABLE}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic_step_grid: the 2-D per-cell table, cell_ch = 36 (parity) or 16
// (C1); row 8
extern "C" int rt_dynamic_step_grid(int cell_ch, RT_DYN_PARAMS,
                                    RT_TABLE_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt::DynArgs a = RT_DYN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_ch) {
    case 36: return rt::launch_dynamic(op, a, rt::Grid<36>{RT_TABLE}, s);
    case 16: return rt::launch_dynamic(op, a, rt::Grid<16>{RT_TABLE}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
