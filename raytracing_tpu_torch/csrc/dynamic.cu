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
// Bit parity with the plain version (kernels/dynamic.py::dynamic_step_plain)
// needs: -fmad=false; the sign of q three-valued (0 at 0, as jnp.sign); Kahan
// on the positions, the position tangent, the RK2 angle tangent and the
// traveltime (common.cuh kahan), none on dth for op1/op8 (recomputed each
// step) nor on dsim; rsqrtf for the momentum normalization.
#include "media.cuh"

namespace rt {

// the 18 state planes, in JAX's resume order
enum DSlot {
  DX = 0, DY, DCX, DCY, DUX, DUY, DTT, DDSIM, DACTIVE, DDPX, DDPY, DDTH, DSGN,
  DKMAH, DKDX, DKDY, DKDT, DKTT, NDSLOTS
};

struct DynPlanes {
  void* p[NDSLOTS];
};

struct DynArgs {
  DynPlanes in, out;
  int n, steps;
  float ds, limit, offset;
  float box[4];
};

__device__ __forceinline__ float dld(const DynPlanes& s, int slot, int i) {
  return static_cast<const float*>(s.p[slot])[i];
}
__device__ __forceinline__ void dst(const DynPlanes& s, int slot, int i,
                                    float v) {
  static_cast<float*>(s.p[slot])[i] = v;
}

// jnp.sign: -1, 0 or 1
__device__ __forceinline__ float sign3(float v) {
  return static_cast<float>(v > 0.0f) - static_cast<float>(v < 0.0f);
}

template <class Medium, int OP>
__global__ void __launch_bounds__(kThreads)
    dynamic_kernel(DynArgs a, Medium medium) {
  constexpr bool kSecond = OP == 6 || OP == 8;
  constexpr bool kRk2 = OP == 2 || OP == 6;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;

  float x = dld(a.in, DX, r), y = dld(a.in, DY, r);
  float cx = dld(a.in, DCX, r), cy = dld(a.in, DCY, r);
  float ux = dld(a.in, DUX, r), uy = dld(a.in, DUY, r);
  float tt = dld(a.in, DTT, r), dsim = dld(a.in, DDSIM, r);
  bool active = static_cast<const bool*>(a.in.p[DACTIVE])[r];
  float dpx = dld(a.in, DDPX, r), dpy = dld(a.in, DDPY, r);
  float dth = dld(a.in, DDTH, r);
  float sgn = dld(a.in, DSGN, r), kmah = dld(a.in, DKMAH, r);
  float kdx = dld(a.in, DKDX, r), kdy = dld(a.in, DKDY, r);
  float kdt = dld(a.in, DKDT, r), ktt = dld(a.in, DKTT, r);
  const float ds = a.ds;
  float f[9];
  medium.nag_h(x, y, f);

  for (int i = 0; i < a.steps; ++i) {
    // frozen rays never change again: stop stepping (dynamic.py:520-531)
    if (!active || !((float)i + a.offset < a.limit)) break;

    // tangent of the carried state at the step's start
    const float dn = f[HGNX] * dpx + f[HGNY] * dpy;
    const float dgx = f[HXX] * dpx + f[HXY] * dpy;
    const float dgy = f[HYX] * dpx + f[HYY] * dpy;
    const float dux = -dth * uy;     // du = dth * u_perp
    const float duy = dth * ux;

    // -- position advance and its tangent -------------------------------
    float ddx, ddy, ddpx, ddpy;
    if (kSecond) {
      const float gdotu = f[HGX] * ux + f[HGY] * uy;
      const float inv_n = 1.0f / f[HN];
      const float half_fac = ds * ds * 0.5f * inv_n;
      const float txx = f[HGX] - gdotu * ux;
      const float txy = f[HGY] - gdotu * uy;
      ddx = ux * ds + txx * half_fac;
      ddy = uy * ds + txy * half_fac;
      const float dgdotu = dgx * ux + dgy * uy + f[HGX] * dux + f[HGY] * duy;
      const float dtx = dgx - dgdotu * ux - gdotu * dux;
      const float dty = dgy - dgdotu * uy - gdotu * duy;
      ddpx = dux * ds + (dtx - txx * dn * inv_n) * half_fac;
      ddpy = duy * ds + (dty - txy * dn * inv_n) * half_fac;
    } else {
      ddx = ux * ds;
      ddy = uy * ds;
      ddpx = dux * ds;
      ddpy = duy * ds;
    }
    float nx2, ny2, cx2, cy2, dpx2, dpy2, kdx2, kdy2;
    kahan(x, cx, ddx, nx2, cx2);
    kahan(y, cy, ddy, ny2, cy2);
    kahan(dpx, kdx, ddpx, dpx2, kdx2);
    kahan(dpy, kdy, ddpy, dpy2, kdy2);

    float f2[9];
    medium.nag_h(nx2, ny2, f2);
    const float dn2 = f2[HGNX] * dpx2 + f2[HGNY] * dpy2;
    const float dgx2 = f2[HXX] * dpx2 + f2[HXY] * dpy2;
    const float dgy2 = f2[HYX] * dpx2 + f2[HYY] * dpy2;

    // -- angle update and its tangent -----------------------------------
    float nux, nuy, ndth, kdt2 = kdt;
    if (kRk2) {
      const float inv_n = 1.0f / f[HN];
      const float inv_n2 = 1.0f / f2[HN];
      const float cross1 = ux * f[HGY] - uy * f[HGX];
      const float k1 = ds * cross1 * inv_n;
      float ux1, uy1;
      rot(ux, uy, k1, ux1, uy1);
      const float cross2 = ux1 * f2[HGY] - uy1 * f2[HGX];
      const float k2 = ds * cross2 * inv_n2;
      rot(ux, uy, (k1 + k2) * 0.5f, nux, nuy);
      // du x g = -dth (u.g); u x dg elementwise
      const float dcross1 =
          -dth * (ux * f[HGX] + uy * f[HGY]) + ux * dgy - uy * dgx;
      const float dk1 = ds * (dcross1 - cross1 * dn * inv_n) * inv_n;
      const float dth1 = dth + dk1;
      const float dcross2 =
          -dth1 * (ux1 * f2[HGX] + uy1 * f2[HGY]) + ux1 * dgy2 - uy1 * dgx2;
      const float dk2 = ds * (dcross2 - cross2 * dn2 * inv_n2) * inv_n2;
      kahan(dth, kdt, (dk1 + dk2) * 0.5f, ndth, kdt2);
    } else {
      const float half = ds * 0.5f;
      const float sx = f[HN] * ux + (f[HGX] + f2[HGX]) * half;
      const float sy = f[HN] * uy + (f[HGY] + f2[HGY]) * half;
      const float inv = rsqrtf(sx * sx + sy * sy);
      nux = sx * inv;
      nuy = sy * inv;
      const float dsx = dn * ux + f[HN] * dux + (dgx + dgx2) * half;
      const float dsy = dn * uy + f[HN] * duy + (dgy + dgy2) * half;
      // recomputed fresh each step, not accumulated: no compensation
      ndth = (dsx * (-nuy) + dsy * nux) * inv;
    }

    float ntt, ktt2;
    if (kSecond) {
      const float dist = sqrtf(ddx * ddx + ddy * ddy);
      kahan(tt, ktt, dist * (f[HN] + f2[HN]) * 0.5f, ntt, ktt2);
      dsim = dsim + dist;
    } else {
      kahan(tt, ktt, ds * (f[HN] + f2[HN]) * 0.5f, ntt, ktt2);
      dsim = dsim + ds;
    }

    // -- caustic bookkeeping: a sign transition of q --------------------
    const float s_new = sign3(dpx2 * (-nuy) + dpy2 * nux);
    if (sgn != 0.0f && s_new != 0.0f && s_new != sgn) kmah = kmah + 1.0f;
    if (s_new != 0.0f) sgn = s_new;

    x = nx2;
    y = ny2;
    cx = cx2;
    cy = cy2;
    ux = nux;
    uy = nuy;
    tt = ntt;
    ktt = ktt2;
    dpx = dpx2;
    dpy = dpy2;
    dth = ndth;
    kdx = kdx2;
    kdy = kdy2;
    kdt = kdt2;
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = f2[k];
    // strict box exit (RT_bench.py:878): the exiting step is kept
    if (outside(x, y, a.box)) active = false;
  }

  dst(a.out, DX, r, x);
  dst(a.out, DY, r, y);
  dst(a.out, DCX, r, cx);
  dst(a.out, DCY, r, cy);
  dst(a.out, DUX, r, ux);
  dst(a.out, DUY, r, uy);
  dst(a.out, DTT, r, tt);
  dst(a.out, DDSIM, r, dsim);
  static_cast<bool*>(a.out.p[DACTIVE])[r] = active;
  dst(a.out, DDPX, r, dpx);
  dst(a.out, DDPY, r, dpy);
  dst(a.out, DDTH, r, dth);
  dst(a.out, DSGN, r, sgn);
  dst(a.out, DKMAH, r, kmah);
  dst(a.out, DKDX, r, kdx);
  dst(a.out, DKDY, r, kdy);
  dst(a.out, DKDT, r, kdt);
  dst(a.out, DKTT, r, ktt);
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
