// fused_step, fused_step_strat, fused_step_grid, fused_step_nodes and
// fused_sweep_grid: the resumable fused integrator for op1/2/3/4/6/7/8/12,
// one step loop instantiated on four media (media.cuh).
//
// Replaces raytracing_tpu/kernels/fused.py::_make_kernel (fused.py:336),
// launched at fused.py:740 for fused_trace_final(_strat) and, in its resume
// form, at engine/segmented.py:165 and :778:
// * fused_step: the analytic _field_fn (fused.py:44), rt_fused_step;
// * fused_step_strat: the 1-D tables of _strat_nag (fused.py:65),
//   rt_fused_step_strat (row 2s of the kernel table in PERF.md);
// * fused_step_grid: the 2-D per-cell table of _tile_nag (fused.py:205)
//   with _hermite_blend or c1_blend, rt_fused_step_grid (row 5);
// * fused_step_nodes: the parity Hermite node table of _supercell_nag
//   (fused.py:151), launched for engine/segmented.py::grid_trace (:1581),
//   rt_fused_step_nodes (row 7);
// * fused_sweep_grid: the DELTA_S candidate sweep on the 2-D grid
//   (engine/segmented.py::_tiled_sweep_segments, :968, _make_kernel's
//   per_block_scal, fused.py:365-370), rt_fused_sweep_grid (row 6): the
//   Grid<36|16> loop with a per-ray step size and step limit.
// The Pallas factory's compile-time arguments (medium, op) are template
// parameters here; stats is a run-time flag (a uniform branch).
//
// What it computes is the TPU kernel's step: the tangent carried as (ux, uy)
// and turned by degree-5 small-angle rotations, Kahan-compensated positions,
// the strict box-exit freeze, traveltime, dist_sim, the optional Welford
// tracker of m_x = n ux, and op7's 4-point window with its order ramp on the
// global step number offset + i + 1.  The kernel always runs in resume form:
// the full state is read from the input planes and written to the output
// planes, with a global step offset, so chained launches equal one launch.
//
// The whole carry (up to 20 floats) stays in registers across every step;
// state is read and written once a ray as coalesced planes, the ragged edge
// is masked.  fused_step on the interface and fused_step_strat run the
// persistent refill loop (fused.cuh): their fans put rays of very
// different lifetimes in one warp, and a lane whose ray froze takes the
// next ray instead of idling until the warp's longest ray ends (one ray a
// thread, 56 % of the lane-steps of the interface fan's warps belonged to
// frozen rays); both entry points take the loop's ray counter, one int on
// the card that a refill launch zeroes on its stream first.  The other media, and the
// fisheye and vert fields, run one ray a thread.  A step is 30-120 FP32 operations
// (op12 evaluates the field four times) against ~64 bytes a ray for the
// whole launch, so the kernel is bound by FP32 issue, not memory; a
// sampled medium adds one 32-byte (1-D) or 64-144-byte (2-D) table read per
// field evaluation, served by L1/L2 (the tables are at most 37.5 MB).  A
// thread leaves its step loop as soon as its ray is frozen (box exit or the
// step limit) — results are unchanged, since a frozen ray's state never
// changes again.
//
// The sweep is n_cand independent trajectories, each reading its own (ds,
// limit) from two per-ray arrays once before the loop
// (FusedArgs::ds_ray/limit_ray, null for every other kernel).  The TPU form
// duplicated each candidate over a 1024-lane block with its own window;
// here a candidate is one ray, and the launch takes as long as its longest
// candidate's chain of dependent steps (3039 at the fisheye search's
// finest divisor): latency, not FP32 issue or bytes, bounds it.  So it has
// a kernel of its own (fused.cuh sweep_kernel, on the grid loop above)
// built for latency: each candidate on a warp of its own, in one-warp
// blocks spread over the SMs, which prefer L1 to shared memory, so that
// no candidate waits on another's steps or table reads and an SM's L1
// holds the band of cells its few candidates cross on every turn.  On an
// H100 80GB HBM3 at 700 W (PERF.md), the fisheye search's 300 candidates
// packed 128 to a block filled 3 SMs and took 1.09 ms, against 0.74 ms for
// their longest alone; spread, they take 0.56 ms.  Holding the cell's row
// in registers across steps, and loading the row of the cell predicted for
// the next step while a step computes, were measured too: both lengthened
// the chain (0.64 and 0.78 ms, against 0.59 for the spread loop in the same
// runs), since the rows are L1 hits once a candidate's orbit repeats.
//
// The loop itself, its arguments and launchers are in fused.cuh.
#include "fused.cuh"

// fused_step: the analytic fields (row 2 of the kernel table); counter is
// the refill loop's (one int on the card; the interface's launches zero
// and use it)
extern "C" int rt_fused_step(int field, RT_FUSED_PARAMS, void* counter,
                             void* stream) {
  if (n <= 0) return 0;
  rt::FusedArgs a = RT_FUSED_ARGS;
  a.next = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case rt::FISHEYE:
      return rt::launch_fused(op, a, rt::Analytic<rt::FISHEYE>{}, s);
    case rt::VERT:
      return rt::launch_fused(op, a, rt::Analytic<rt::VERT>{}, s);
    case rt::INTERFACE:
      return rt::launch_fused(op, a, rt::Analytic<rt::INTERFACE>{}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fused_step_strat: 1-D stratified tables, ch = 6 (parity) or 4 (C1); row
// 2s; counter as rt_fused_step's
extern "C" int rt_fused_step_strat(int ch, RT_FUSED_PARAMS, RT_TABLE_PARAMS,
                                   void* counter, void* stream) {
  if (n <= 0) return 0;
  rt::FusedArgs a = RT_FUSED_ARGS;
  a.next = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 6: return rt::launch_fused(op, a, rt::Strat<6>{RT_TABLE}, s);
    case 4: return rt::launch_fused(op, a, rt::Strat<4>{RT_TABLE}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fused_step_grid: the 2-D per-cell table, cell_ch = 36 (parity) or 16 (C1);
// row 5, fused family
extern "C" int rt_fused_step_grid(int cell_ch, RT_FUSED_PARAMS,
                                  RT_TABLE_PARAMS, void* stream) {
  if (n <= 0) return 0;
  if (!rt::table2_fits(nx, ny))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::FusedArgs a = RT_FUSED_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_ch) {
    case 36: return rt::launch_fused(op, a, rt::Grid<36>{RT_TABLE}, s);
    case 16: return rt::launch_fused(op, a, rt::Grid<16>{RT_TABLE}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fused_step_nodes: the parity Hermite node table, node_ch = 9; row 7
extern "C" int rt_fused_step_nodes(int node_ch, RT_FUSED_PARAMS,
                                   RT_TABLE_PARAMS, void* stream) {
  if (n <= 0) return 0;
  if (!rt::table2_fits(nx, ny))
    return static_cast<int>(cudaErrorInvalidValue);
  if (node_ch != 9) return static_cast<int>(cudaErrorInvalidValue);
  const rt::FusedArgs a = RT_FUSED_ARGS;
  return rt::launch_fused(op, a, rt::Nodes{RT_TABLE},
                    static_cast<cudaStream_t>(stream));
}

// fused_sweep_grid: fused_step_grid's step with a per-ray step size and
// step limit (ds_ray, limit_ray: n floats each, on the card), in the
// sweep's own kernel (sweep_kernel); the scalar ds and limit of
// RT_FUSED_PARAMS are unread; row 6
extern "C" int rt_fused_sweep_grid(int cell_ch, RT_FUSED_PARAMS,
                                   const void* ds_ray, const void* limit_ray,
                                   RT_TABLE_PARAMS, void* stream) {
  if (n <= 0) return 0;
  if (!rt::table2_fits(nx, ny))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ds_ray == nullptr || limit_ray == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::FusedArgs a = RT_FUSED_ARGS;
  a.ds_ray = static_cast<const float*>(ds_ray);
  a.limit_ray = static_cast<const float*>(limit_ray);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_ch) {
    case 36: return rt::launch_sweep(op, a, rt::Grid<36>{RT_TABLE}, s);
    case 16: return rt::launch_sweep(op, a, rt::Grid<16>{RT_TABLE}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The refill loop's grid for n rays of op, with or without the stats:
// blocks of 128 threads, written to *blocks, 0 where the medium runs one
// ray a thread.  medium 0 is rt_fused_step's (code = field), 1
// rt_fused_step_strat's (code = ch).
extern "C" int rt_fused_refill_blocks(int medium, int code, int op,
                                      int stats, int n, int* blocks) {
  using rt::refill_blocks_of;
  if (n <= 0 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (medium == 0) {
    switch (code) {
      case rt::FISHEYE:
        return refill_blocks_of<rt::Analytic<rt::FISHEYE>>(op, stats, n,
                                                           blocks);
      case rt::VERT:
        return refill_blocks_of<rt::Analytic<rt::VERT>>(op, stats, n,
                                                        blocks);
      case rt::INTERFACE:
        return refill_blocks_of<rt::Analytic<rt::INTERFACE>>(op, stats, n,
                                                             blocks);
    }
  } else if (medium == 1) {
    switch (code) {
      case 6: return refill_blocks_of<rt::Strat<6>>(op, stats, n, blocks);
      case 4: return refill_blocks_of<rt::Strat<4>>(op, stats, n, blocks);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
