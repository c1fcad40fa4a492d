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
// State in registers for every step, coalesced planes read and written
// once, ragged edge masked, and a ray stops stepping once it is frozen:
// one ray a thread on the analytic fisheye and the grid, the persistent
// refill loop (a lane whose ray froze takes the next) on the other media,
// whose fans mix rays of very different lifetimes in a warp (golden.cuh).
// A step costs ~150-900 FP32 operations (each Newton step is one Dual2
// cost, ~4 plain costs; each bracket iteration one cost) against ~60 bytes
// a ray for the whole launch: FP32-issue bound.
//
// The loop itself, its arguments and launchers are in golden.cuh.
#include "golden.cuh"

// The refill loop's grid: blocks of 128 threads that a launch of the
// variant (curv, newton, iso) on medium (0 analytic, field = code; 1
// stratified, ch = code; 2 grid, cell_ch = code) takes for n rays on the
// current device, into *blocks; 0 where the medium runs one ray a thread
extern "C" int rt_golden_refill_blocks(int medium, int code, int curv,
                                       int newton, int iso, int n,
                                       int* blocks) {
  using rt::golden_refill_blocks;
  if (n <= 0 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (medium == 0) {
    switch (code) {
      case rt::FISHEYE:
        return golden_refill_blocks<rt::Analytic<rt::FISHEYE>>(
            curv, newton, iso, n, blocks);
      case rt::VERT:
        return golden_refill_blocks<rt::Analytic<rt::VERT>>(curv, newton,
                                                            iso, n, blocks);
      case rt::INTERFACE:
        return golden_refill_blocks<rt::Analytic<rt::INTERFACE>>(
            curv, newton, iso, n, blocks);
    }
  } else if (medium == 1) {
    switch (code) {
      case 6:
        return golden_refill_blocks<rt::Strat<6>>(curv, newton, iso, n,
                                                  blocks);
      case 4:
        return golden_refill_blocks<rt::Strat<4>>(curv, newton, iso, n,
                                                  blocks);
    }
  } else if (medium == 2) {
    switch (code) {
      case 36:
        return golden_refill_blocks<rt::Grid<36>>(curv, newton, iso, n,
                                                  blocks);
      case 16:
        return golden_refill_blocks<rt::Grid<16>>(curv, newton, iso, n,
                                                  blocks);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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
