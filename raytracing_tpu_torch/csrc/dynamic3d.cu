// dynamic3d_step and dynamic3d_step_grid: the resumable 3-D dynamic
// integrator for op1/op2/op6/op8 (kinematics plus the two launch tangents,
// det Q, KMAH and the focus locator), one step loop (dynamic3d.cuh::
// run_dyn3) instantiated on two media (fused3d.cuh nag_h).
//
// Replaces raytracing_tpu/kernels/dynamic3d.py::_make_dyn_kernel3
// (dynamic3d.py:318, launched at :546 by dynamic3d_trace_final) and
// ::_make_dyn_tile_kernel3 (:408, with _tile_nag3_h :355, launched at
// engine/tiled3.py:233 with dynamic=True by grid3_trace_dynamic_tiled),
// which share the step _dyn_step_body3 (:158):
// * dynamic3d_step: the analytic fields of _field3_fn_h (:76) — fisheye,
//   vert, interface — rt_dynamic3d_step (row 15 of the kernel table in
//   PERF.md);
// * dynamic3d_step_grid: a C1Grid3Medium's tri-Hermite per-cell table with
//   the patch's exact Hessian, rt_dynamic3d_step_grid (row 14d).  The TPU
//   kernel shares a Morton-sorted block's cell window in VMEM, refreshed
//   between segments, with an excess flag and a replay ladder; here every
//   ray reads its own cell's 256-byte row of the whole table, one launch a
//   trace, as fused3d_step_grid does.
// The Pallas factories' compile-time arguments (field, op) are template
// parameters here.
//
// Both kernels read and write the 25 state planes of JAX's resume layout
// (DYN3_TILE_STATE, engine/tiled3.py:555-566: pos, u, dpa, dua, dpb, dub,
// tt, dsim, active, sgn, kmah, mind, minstep) with a global step offset, so
// k steps then n - k equal n steps and the caustic bookkeeping runs on the
// global, 1-based step; the JAX analytic kernel takes (pos, u, e1, e2)
// instead, which is the launch state with dpa = dpb = 0, dua = e1, dub = e2,
// active 1, sgn 0, kmah 0, mind FLT_MAX, minstep 0.
//
// One thread per ray, the state (25 values), n, grad n and the Hessian (10)
// in registers across every step; state read and written once as coalesced
// planes (97 bytes in and out a ray).  A step is several hundred FP32
// operations (chip_smoke.py counts them from the plain version) against no
// memory traffic on the analytic fields, so dynamic3d_step is bound by its
// operations; a grid step adds one 256-byte row read, served by L1/L2 where
// a fan's rays share cells (chip_smoke.py prints the operations bound and
// the row-read HBM estimate).  A thread leaves its step loop as soon as its
// ray is frozen (box exit or the step limit): a frozen ray's state never
// changes again.
//
// What the design does about its bound (FP32 issue): the loop's nineteen
// quotients a step (op6) take a multiply, two FMAs and two compares each
// from their five denominators' reciprocals, one guard branch a group
// (dynamic3d.cuh, common.cuh div_all), where an IEEE division issues ~10
// instructions with a branch and a convergence barrier; the grid's row is
// blended as it is read (fused3d.cuh Grid3::nag_h); and the kernel runs as
// many blocks an SM as it can without spilling (Dyn3Blocks below).
#include "common.cuh"
#include "dynamic3d.cuh"

namespace rt3 {

// the 25 state planes: contiguous float32 vectors of length n, DACTIVE3 bool
enum DSlot3 {
  DX3 = 0, DY3, DZ3, DUX3, DUY3, DUZ3, DPAX3, DPAY3, DPAZ3, DUAX3, DUAY3,
  DUAZ3, DPBX3, DPBY3, DPBZ3, DUBX3, DUBY3, DUBZ3, DTT3, DDSIM3, DACTIVE3,
  DSGN3, DKMAH3, DMIND3, DMINSTEP3, NDSLOTS3
};

struct Dyn3Args {
  void* in[NDSLOTS3];
  void* out[NDSLOTS3];
  int n, steps;
  float ds, limit, offset;
  float box[6];
};

// Blocks of 128 threads an SM, the most at which ptxas spills nothing: four
// (128 registers, 16 warps) on the analytic fields, whose op2/op6 loops
// took up to 141 registers unbounded, three blocks; three on the grid,
// whose op6 and op8 loops spill 12 and 28 bytes at 128 registers (147-167
// unbounded).  Measured on the H100 (PERF.md §6): four blocks ran
// the analytic dyn3_op6 3.5 % faster than three, the grid's 1.4 % slower.
template <class Medium>
struct Dyn3Blocks {
  static constexpr int value = 4;
};
template <>
struct Dyn3Blocks<Grid3> {
  static constexpr int value = 3;
};

template <class Medium, int OP>
__global__ void __launch_bounds__(rt::kThreads, Dyn3Blocks<Medium>::value)
    dynamic3d_kernel(Dyn3Args a, Medium m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  auto ld = [&](int slot) { return static_cast<const float*>(a.in[slot])[r]; };
  auto ld3 = [&](int slot) -> V3 {
    return {ld(slot), ld(slot + 1), ld(slot + 2)};
  };
  Dyn3 s;
  s.pos = ld3(DX3);
  s.u = ld3(DUX3);
  s.dpa = ld3(DPAX3);
  s.dua = ld3(DUAX3);
  s.dpb = ld3(DPBX3);
  s.dub = ld3(DUBX3);
  s.tt = ld(DTT3);
  s.dsim = ld(DDSIM3);
  s.active = static_cast<const bool*>(a.in[DACTIVE3])[r];
  s.sgn = ld(DSGN3);
  s.kmah = ld(DKMAH3);
  s.mind = ld(DMIND3);
  s.minstep = ld(DMINSTEP3);
  float box[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) box[k] = a.box[k];
  run_dyn3<Medium, OP>(s, a.steps, a.ds, a.limit, a.offset, box, m);
  auto st = [&](int slot, float v) { static_cast<float*>(a.out[slot])[r] = v; };
  auto st3 = [&](int slot, const V3& v) {
    st(slot, v.x);
    st(slot + 1, v.y);
    st(slot + 2, v.z);
  };
  st3(DX3, s.pos);
  st3(DUX3, s.u);
  st3(DPAX3, s.dpa);
  st3(DUAX3, s.dua);
  st3(DPBX3, s.dpb);
  st3(DUBX3, s.dub);
  st(DTT3, s.tt);
  st(DDSIM3, s.dsim);
  static_cast<bool*>(a.out[DACTIVE3])[r] = s.active;
  st(DSGN3, s.sgn);
  st(DKMAH3, s.kmah);
  st(DMIND3, s.mind);
  st(DMINSTEP3, s.minstep);
}

template <class Medium, int OP>
static int launch_dyn3_op(const Dyn3Args& a, const Medium& m, cudaStream_t s) {
  const int blocks = (a.n + rt::kThreads - 1) / rt::kThreads;
  dynamic3d_kernel<Medium, OP><<<blocks, rt::kThreads, 0, s>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

template <class Medium>
static int launch_dyn3(int op, const Dyn3Args& a, const Medium& m,
                       cudaStream_t s) {
  switch (op) {
    case 1: return launch_dyn3_op<Medium, 1>(a, m, s);
    case 2: return launch_dyn3_op<Medium, 2>(a, m, s);
    case 6: return launch_dyn3_op<Medium, 6>(a, m, s);
    case 8: return launch_dyn3_op<Medium, 8>(a, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

static Dyn3Args dyn3_args(void* const* in, void* const* out, int n, int steps,
                          float ds, float limit, float offset, float bx0,
                          float bx1, float by0, float by1, float bz0,
                          float bz1) {
  Dyn3Args a;
  for (int k = 0; k < NDSLOTS3; ++k) {
    a.in[k] = in[k];
    a.out[k] = out[k];
  }
  a.n = n;
  a.steps = steps;
  a.ds = ds;
  a.limit = limit;
  a.offset = offset;
  a.box[0] = bx0;
  a.box[1] = bx1;
  a.box[2] = by0;
  a.box[3] = by1;
  a.box[4] = bz0;
  a.box[5] = bz1;
  return a;
}

}  // namespace rt3

#define RT_DYN3_PARAMS                                                       \
  int op, void *const *in, void *const *out, int n, int steps, float ds,     \
      float limit, float offset, float bx0, float bx1, float by0, float by1, \
      float bz0, float bz1
#define RT_DYN3_ARGS                                                         \
  rt3::dyn3_args(in, out, n, steps, ds, limit, offset, bx0, bx1, by0, by1, \
                 bz0, bz1)

// dynamic3d_step: the analytic 3-D fields (row 15 of the kernel table)
extern "C" int rt_dynamic3d_step(int field, RT_DYN3_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt3::Dyn3Args a = RT_DYN3_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case rt3::FISHEYE3:
      return rt3::launch_dyn3(op, a, rt3::Analytic3<rt3::FISHEYE3>{}, s);
    case rt3::VERT3:
      return rt3::launch_dyn3(op, a, rt3::Analytic3<rt3::VERT3>{}, s);
    case rt3::INTERFACE3:
      return rt3::launch_dyn3(op, a, rt3::Analytic3<rt3::INTERFACE3>{}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic3d_step_grid: a C1Grid3Medium's per-cell table, (cells, 64) floats;
// nx, ny, nz count nodes (row 14d)
extern "C" int rt_dynamic3d_step_grid(RT_DYN3_PARAMS, const void* table,
                                      float x0, float y0, float z0,
                                      float inv_hx, float inv_hy,
                                      float inv_hz, int nx, int ny, int nz,
                                      void* stream) {
  if (n <= 0) return 0;
  if (!rt3::grid3_fits(nx, ny, nz))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt3::Dyn3Args a = RT_DYN3_ARGS;
  const rt3::Grid3 m{static_cast<const float*>(table), x0, y0, z0, inv_hx,
                     inv_hy, inv_hz, nx, ny, nz};
  return rt3::launch_dyn3(op, a, m, static_cast<cudaStream_t>(stream));
}
