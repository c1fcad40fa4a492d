// fused3d_step and fused3d_step_grid: the resumable fused 3-D integrator for
// op1/op2/op6/op8, one step loop (fused3d.cuh::run3) instantiated on two
// media.
//
// Replaces raytracing_tpu/kernels/fused3d.py::_make_kernel3 (fused3d.py:191,
// launched at :478 by fused3d_trace_final) and ::_make_tile_kernel3 (:370,
// launched at engine/tiled3.py:233 by grid3_trace_tiled), which share the
// step _step_body3 (:93):
// * fused3d_step: the analytic fields of _field3_fn (:45) — fisheye, vert,
//   interface — rt_fused3d_step (row 13 of the kernel table in PERF.md);
// * fused3d_step_grid: a C1Grid3Medium's tri-Hermite per-cell table
//   (_tile_nag3 :223, _tile_cell_locate3 :265), rt_fused3d_step_grid (row
//   14k).  The TPU kernel shares a Morton-sorted block's 5x5x5-cell window
//   in VMEM, refreshed between segments, with a drift-placed window and an
//   exact excess flag that replays a segment whose rays escaped it.  Here
//   there is no window: every ray reads its own cell's 256-byte row of the
//   whole table (16 float4 loads), one launch a trace, no sort, no replay.
// The Pallas factories' compile-time arguments (field, op) are template
// parameters here.
//
// What it computes is the TPU kernels' step: the unit tangent (ux, uy, uz)
// turned by the rotation-vector Heun with polynomial rotations (op2/op6) or
// renormalised after the trapezoidal momentum impulse (op1/op8),
// Kahan-compensated positions, traveltime and dist_sim, and the strict
// 6-face box exit that freezes a ray.  The kernel always runs in resume
// form: the 12 state planes (rt3::Slot3) are read and written once a launch,
// with a global step offset, so chained launches equal one launch.
//
// One thread per ray, the carry (16 floats) in registers across every step;
// state read and written once as coalesced planes (45 bytes in and out a
// ray), the ragged edge masked.  A step on an analytic field is 77-217 FP32
// operations (counted from the plain version), so fused3d_step is bound by
// its operations.  A grid step adds one 256-byte row read and the
// tri-Hermite blend, 643 operations in all (op6); the benchmark's 71^3-node
// table is 87.8 MB, beyond the 50 MB L2.  Where a fan's rays share cells,
// the rows stay cached; where rays spread over the grid, a row read may
// come from HBM, up to 256 bytes a live ray-step (chip_smoke.py prints the
// operations bound and that HBM estimate; PERF.md has the times).  A thread leaves its step loop as soon as
// its ray is frozen (box exit or the step limit): results are unchanged, a
// frozen ray's state never changes.
#include "common.cuh"
#include "fused3d.cuh"

namespace rt3 {

// the 12 state planes: contiguous float32 vectors of length n, ACTIVE3 bool
enum Slot3 { X3 = 0, Y3, Z3, CX3, CY3, CZ3, UX3, UY3, UZ3, TT3, DSIM3, ACTIVE3,
             NSLOTS3 };

struct Fused3Args {
  void* in[NSLOTS3];
  void* out[NSLOTS3];
  int n, steps;
  float ds, limit, offset;
  float box[6];
};

template <class Medium, int OP>
__global__ void __launch_bounds__(rt::kThreads)
    fused3d_kernel(Fused3Args a, Medium m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  auto ld = [&](int slot) { return static_cast<const float*>(a.in[slot])[r]; };
  Ray3 s;
  s.x = ld(X3);
  s.y = ld(Y3);
  s.z = ld(Z3);
  s.cx = ld(CX3);
  s.cy = ld(CY3);
  s.cz = ld(CZ3);
  s.ux = ld(UX3);
  s.uy = ld(UY3);
  s.uz = ld(UZ3);
  s.tt = ld(TT3);
  s.dsim = ld(DSIM3);
  s.active = static_cast<const bool*>(a.in[ACTIVE3])[r];
  float box[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) box[k] = a.box[k];
  run3<Medium, OP>(s, a.steps, a.ds, a.limit, a.offset, box, m);
  auto st = [&](int slot, float v) { static_cast<float*>(a.out[slot])[r] = v; };
  st(X3, s.x);
  st(Y3, s.y);
  st(Z3, s.z);
  st(CX3, s.cx);
  st(CY3, s.cy);
  st(CZ3, s.cz);
  st(UX3, s.ux);
  st(UY3, s.uy);
  st(UZ3, s.uz);
  st(TT3, s.tt);
  st(DSIM3, s.dsim);
  static_cast<bool*>(a.out[ACTIVE3])[r] = s.active;
}

template <class Medium, int OP>
static int launch3_op(const Fused3Args& a, const Medium& m, cudaStream_t s) {
  const int blocks = (a.n + rt::kThreads - 1) / rt::kThreads;
  fused3d_kernel<Medium, OP><<<blocks, rt::kThreads, 0, s>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

template <class Medium>
static int launch3(int op, const Fused3Args& a, const Medium& m,
                   cudaStream_t s) {
  switch (op) {
    case 1: return launch3_op<Medium, 1>(a, m, s);
    case 2: return launch3_op<Medium, 2>(a, m, s);
    case 6: return launch3_op<Medium, 6>(a, m, s);
    case 8: return launch3_op<Medium, 8>(a, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

static Fused3Args fused3_args(void* const* in, void* const* out, int n,
                              int steps, float ds, float limit, float offset,
                              float bx0, float bx1, float by0, float by1,
                              float bz0, float bz1) {
  Fused3Args a;
  for (int k = 0; k < NSLOTS3; ++k) {
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

#define RT_FUSED3_PARAMS                                                     \
  int op, void *const *in, void *const *out, int n, int steps, float ds,     \
      float limit, float offset, float bx0, float bx1, float by0, float by1, \
      float bz0, float bz1
#define RT_FUSED3_ARGS                                                    \
  rt3::fused3_args(in, out, n, steps, ds, limit, offset, bx0, bx1, by0, \
                   by1, bz0, bz1)

// fused3d_step: the analytic 3-D fields (row 13 of the kernel table)
extern "C" int rt_fused3d_step(int field, RT_FUSED3_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt3::Fused3Args a = RT_FUSED3_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case rt3::FISHEYE3:
      return rt3::launch3(op, a, rt3::Analytic3<rt3::FISHEYE3>{}, s);
    case rt3::VERT3:
      return rt3::launch3(op, a, rt3::Analytic3<rt3::VERT3>{}, s);
    case rt3::INTERFACE3:
      return rt3::launch3(op, a, rt3::Analytic3<rt3::INTERFACE3>{}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fused3d_step_grid: a C1Grid3Medium's per-cell table, (cells, 64) floats;
// nx, ny, nz count nodes (row 14k)
extern "C" int rt_fused3d_step_grid(RT_FUSED3_PARAMS, const void* table,
                                    float x0, float y0, float z0,
                                    float inv_hx, float inv_hy, float inv_hz,
                                    int nx, int ny, int nz, void* stream) {
  if (n <= 0) return 0;
  if (nx < 2 || ny < 2 || nz < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt3::Fused3Args a = RT_FUSED3_ARGS;
  const rt3::Grid3 m{static_cast<const float*>(table), x0, y0, z0, inv_hx,
                     inv_hy, inv_hz, nx, ny, nz};
  return rt3::launch3(op, a, m, static_cast<cudaStream_t>(stream));
}
