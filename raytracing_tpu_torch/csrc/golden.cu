// golden_step, golden_step_strat, golden_step_grid: the resumable
// golden/Newton momentum-cost integrator for op5, op9, op10, op11, op10n and
// op11n, one step loop instantiated on three media (media.cuh).
//
// Replaces raytracing_tpu/kernels/golden.py::_make_kernel (golden.py:138),
// launched at golden.py:649 for golden_trace_final and, in its resume form,
// at engine/segmented.py:165 and :778: golden_step on the analytic fields
// (rt_golden_step), golden_step_strat on the 1-D tables (the strat
// injection, golden.py:520-527; rt_golden_step_strat, row 3s) and
// golden_step_grid on the 2-D per-cell table (the tile injection,
// golden.py:491-518; rt_golden_step_grid, row 5).  Template parameters:
// medium x stepper {curvature, 2nd-order Taylor} x solver {golden schedule,
// seeded Newton} x iso (op5/op9 fold the anisotropy factor to 1).  The
// schedule runs at run time: iters == 0 is the closed-form seed (+ `polish`
// Newton steps for the anisotropic ops), iters > 0 the transcendental-free
// golden bracket with per-iteration rotations read from the scalar bundle
// (golden.py:548), then `polish` Newton steps clipped to the final bracket
// width.
//
// The TPU kernel takes the cost's first and second derivatives by nested
// jax.jvp (golden.py:306-328).  Here the cost is written once, templated on
// its scalar type, and evaluated on Dual2 {v, d1, d2}: a truncated Taylor
// number whose product and rsqrt carry exactly what jvp-of-jvp carries.  The
// clip bounds (0.15 polish, 0.3 Newton, L_final after a bracket) and the
// |d2| < 1e-12 floor are part of the result and kept.
//
// One thread per ray, state in registers for every step, coalesced planes
// read and written once, ragged edge masked, and a thread stops stepping
// once its ray is frozen.  A step costs ~150-900 FP32 operations (each
// Newton step is one Dual2 cost, ~4 plain costs; each bracket iteration one
// cost) against ~60 bytes a ray for the whole launch: FP32-issue bound.
//
// The loop itself, its arguments and launchers are in golden.cuh.
#include "golden.cuh"

// golden_step: the analytic fields (row 3 of the kernel table)
extern "C" int rt_golden_step(int field, RT_GOLDEN_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt::GoldenArgs a = RT_GOLDEN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case rt::FISHEYE:
      return rt::launch_golden(curv, newton, iso, a,
                               rt::Analytic<rt::FISHEYE>{}, s);
    case rt::VERT:
      return rt::launch_golden(curv, newton, iso, a, rt::Analytic<rt::VERT>{},
                               s);
    case rt::INTERFACE:
      return rt::launch_golden(curv, newton, iso, a,
                               rt::Analytic<rt::INTERFACE>{}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// golden_step_strat: 1-D stratified tables, ch = 6 or 4; row 3s
extern "C" int rt_golden_step_strat(int ch, RT_GOLDEN_PARAMS, RT_TABLE_PARAMS,
                                    void* stream) {
  if (n <= 0) return 0;
  const rt::GoldenArgs a = RT_GOLDEN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 6:
      return rt::launch_golden(curv, newton, iso, a, rt::Strat<6>{RT_TABLE},
                               s);
    case 4:
      return rt::launch_golden(curv, newton, iso, a, rt::Strat<4>{RT_TABLE},
                               s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// golden_step_grid: the 2-D per-cell table, cell_ch = 36 or 16; row 5,
// golden family
extern "C" int rt_golden_step_grid(int cell_ch, RT_GOLDEN_PARAMS,
                                   RT_TABLE_PARAMS, void* stream) {
  if (n <= 0) return 0;
  if (!rt::table2_fits(nx, ny))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::GoldenArgs a = RT_GOLDEN_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_ch) {
    case 36:
      return rt::launch_golden(curv, newton, iso, a, rt::Grid<36>{RT_TABLE},
                               s);
    case 16:
      return rt::launch_golden(curv, newton, iso, a, rt::Grid<16>{RT_TABLE},
                               s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
