// The fused integrator's step loop for op1/2/3/4/6/7/8/12, templated on the
// medium (media.cuh, or a generated custom medium) and the op: its
// arguments, the kernel, its launchers and the C parameter list of every
// fused entry point.  fused.cu instantiates it on the analytic, stratified,
// grid and node-table media; kernels/custom.py generates one translation
// unit a (custom medium, op) that includes this header and instantiates the
// one loop it needs.  What the loop computes, and what bounds it, is
// described at the top of fused.cu.
#pragma once

#include "media.cuh"

namespace rt {

struct FusedArgs {
  Planes in, out;
  int n, steps, stats;
  float ds, limit, offset, curv_tol;
  float box[4];
  // per-ray step size and step limit (fused_sweep_grid), or null
  const float* ds_ray;
  const float* limit_ray;
};

template <class Medium, int OP>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(FusedArgs a, Medium medium) {
  constexpr bool kSecond = OP == 6 || OP == 7 || OP == 8;
  constexpr bool kCurv = OP == 3 || OP == 4;
  constexpr bool kRk2 = OP == 2 || OP == 3 || OP == 6;
  constexpr bool kWindow = OP == 7;
  constexpr bool kRk4 = OP == 12;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;

  float x = ld(a.in, X, r), y = ld(a.in, Y, r);
  float ux = ld(a.in, UX, r), uy = ld(a.in, UY, r);
  float cx = ld(a.in, CX, r), cy = ld(a.in, CY, r);
  float tt = ld(a.in, TT, r), dsim = ld(a.in, DSIM, r);
  bool active = static_cast<const bool*>(a.in.p[ACTIVE])[r];
  float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (a.stats) {
    cnt = ld(a.in, CNT, r);
    mean = ld(a.in, MEAN, r);
    m2 = ld(a.in, M2, r);
  }
  float wax = 0.0f, way = 0.0f, wbx = 0.0f, wby = 0.0f;
  if (kWindow) {
    wax = ld(a.in, WAX, r);
    way = ld(a.in, WAY, r);
    wbx = ld(a.in, WBX, r);
    wby = ld(a.in, WBY, r);
  }
  const float ds = a.ds_ray ? a.ds_ray[r] : a.ds;
  const float limit = a.limit_ray ? a.limit_ray[r] : a.limit;
  float n, gx, gy;
  medium.nag(x, y, n, gx, gy);

  for (int i = 0; i < a.steps; ++i) {
    // frozen rays never change again: stop stepping (fused.py:585-592)
    if (!active || !((float)i + a.offset < limit)) break;

    // -- position advance ------------------------------------------------
    float ddx, ddy;
    bool significant = true;
    float rk4_ux = 0.0f, rk4_uy = 0.0f;
    if (kRk4) {
      // joint RK4 (ops/registry.py op12), intermediate tangents by rotation
      const float h = ds;
      const float k1t = (ux * gy - uy * gx) / n;
      float u1x, u1y, u2x, u2y, u3x, u3y, nb, gbx, gby, nc, gcx, gcy, nd, gdx,
          gdy;
      rot(ux, uy, 0.5f * h * k1t, u1x, u1y);
      medium.nag(x + 0.5f * h * ux, y + 0.5f * h * uy, nb, gbx, gby);
      const float k2t = (u1x * gby - u1y * gbx) / nb;
      rot(ux, uy, 0.5f * h * k2t, u2x, u2y);
      medium.nag(x + 0.5f * h * u1x, y + 0.5f * h * u1y, nc, gcx, gcy);
      const float k3t = (u2x * gcy - u2y * gcx) / nc;
      rot(ux, uy, h * k3t, u3x, u3y);
      medium.nag(x + h * u2x, y + h * u2y, nd, gdx, gdy);
      const float k4t = (u3x * gdy - u3y * gdx) / nd;
      const float h6 = h / 6.0f;
      ddx = h6 * (ux + 2.0f * u1x + 2.0f * u2x + u3x);
      ddy = h6 * (uy + 2.0f * u1y + 2.0f * u2y + u3y);
      const float dth = h6 * (k1t + 2.0f * k2t + 2.0f * k3t + k4t);
      rot(ux, uy, dth, rk4_ux, rk4_uy);
    } else if (kSecond) {
      // r += u ds + (grad - (grad.u) u) ds^2 / 2n
      const float gdotu = gx * ux + gy * uy;
      const float half_fac = ds * ds * 0.5f / n;
      ddx = ux * ds + (gx - gdotu * ux) * half_fac;
      ddy = uy * ds + (gy - gdotu * uy) * half_fac;
    } else if (kCurv) {
      const float gdotu = gx * ux + gy * uy;
      significant = arc_advance(ux, uy, gx, gy, gx - gdotu * ux,
                                gy - gdotu * uy, n, ds, a.curv_tol, ddx, ddy);
    } else {
      ddx = ux * ds;
      ddy = uy * ds;
    }
    float nx2, ny2, cx2, cy2;
    kahan(x, cx, ddx, nx2, cx2);
    kahan(y, cy, ddy, ny2, cy2);

    float n2, gx2, gy2;
    medium.nag(nx2, ny2, n2, gx2, gy2);

    // -- angle update ----------------------------------------------------
    float nux, nuy;
    if (kRk4) {
      nux = rk4_ux;
      nuy = rk4_uy;
    } else if (kWindow) {
      // MxSA backward difference with the order ramp on the global step
      const float step_f = (float)i + a.offset + 1.0f;
      const bool is1 = step_f == 1.0f, is2 = step_f == 2.0f;
      const float ca = is1 ? 0.0f : (is2 ? 0.0f : -2.0f);
      const float cb = is1 ? 0.0f : (is2 ? 1.0f : 9.0f);
      const float cc = is1 ? -1.0f : (is2 ? -4.0f : -18.0f);
      const float cd = is1 ? 1.0f : (is2 ? 3.0f : 11.0f);
      const float vx = ca * wax + cb * wbx + cc * x + cd * nx2;
      const float vy = ca * way + cb * wby + cc * y + cd * ny2;
      const float inv = rsqrtf(vx * vx + vy * vy);
      nux = vx * inv;
      nuy = vy * inv;
    } else if (kRk2) {
      // tfinal_2o: rotate the tangent by the k1/k2 increments
      const float k1 = ds * (ux * gy - uy * gx) / n;
      float ux1, uy1;
      rot(ux, uy, k1, ux1, uy1);
      const float k2 = ds * (ux1 * gy2 - uy1 * gx2) / n2;
      rot(ux, uy, (k1 + k2) * 0.5f, nux, nuy);
    } else {
      // theta_cost_t: normalized momentum + trapezoid impulse
      const float half = ds * 0.5f;
      const float sx = n * ux + (gx + gx2) * half;
      const float sy = n * uy + (gy + gy2) * half;
      const float inv = rsqrtf(sx * sx + sy * sy);
      nux = sx * inv;
      nuy = sy * inv;
    }
    if (kCurv && !significant) {
      // negligible curvature keeps the old angle (RT_bench.py:538-541)
      nux = ux;
      nuy = uy;
    }

    if (kSecond || kCurv || kRk4) {
      const float dist = sqrtf(ddx * ddx + ddy * ddy);
      tt = tt + dist * (n + n2) * 0.5f;
      dsim = dsim + dist;
    } else {
      tt = tt + ds * (n + n2) * 0.5f;
      dsim = dsim + ds;
    }
    if (a.stats) {
      // Welford over the post-step m_x = n2 * nux (engine/trace.py body)
      const float mx2 = n2 * nux;
      cnt = cnt + 1.0f;
      const float delta = mx2 - mean;
      mean = mean + delta / cnt;
      m2 = m2 + delta * (mx2 - mean);
    }
    if (kWindow) {
      wax = wbx;
      way = wby;
      wbx = x;
      wby = y;
    }
    x = nx2;
    y = ny2;
    cx = cx2;
    cy = cy2;
    ux = nux;
    uy = nuy;
    n = n2;
    gx = gx2;
    gy = gy2;
    // strict box exit (RT_bench.py:878): the exiting step is kept
    if (outside(x, y, a.box)) active = false;
  }

  st(a.out, X, r, x);
  st(a.out, Y, r, y);
  st(a.out, UX, r, ux);
  st(a.out, UY, r, uy);
  st(a.out, CX, r, cx);
  st(a.out, CY, r, cy);
  st(a.out, TT, r, tt);
  st(a.out, DSIM, r, dsim);
  static_cast<bool*>(a.out.p[ACTIVE])[r] = active;
  if (a.stats) {
    st(a.out, CNT, r, cnt);
    st(a.out, MEAN, r, mean);
    st(a.out, M2, r, m2);
  }
  if (kWindow) {
    st(a.out, WAX, r, wax);
    st(a.out, WAY, r, way);
    st(a.out, WBX, r, wbx);
    st(a.out, WBY, r, wby);
  }
}

// one instantiation: the loop of OP on Medium (a generated custom-medium
// library instantiates only the op it was built for)
template <class Medium, int OP>
static int launch_fused_op(const FusedArgs& a, const Medium& m,
                           cudaStream_t s) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  fused_kernel<Medium, OP><<<blocks, kThreads, 0, s>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

// every op of the family on Medium, chosen at run time
template <class Medium>
static int launch_fused(int op, const FusedArgs& a, const Medium& m,
                        cudaStream_t s) {
  switch (op) {
    case 1: return launch_fused_op<Medium, 1>(a, m, s);
    case 2: return launch_fused_op<Medium, 2>(a, m, s);
    case 3: return launch_fused_op<Medium, 3>(a, m, s);
    case 4: return launch_fused_op<Medium, 4>(a, m, s);
    case 6: return launch_fused_op<Medium, 6>(a, m, s);
    case 7: return launch_fused_op<Medium, 7>(a, m, s);
    case 8: return launch_fused_op<Medium, 8>(a, m, s);
    case 12: return launch_fused_op<Medium, 12>(a, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

static FusedArgs fused_args(int stats, void* const* in, void* const* out,
                            int n, int steps, float ds, float limit,
                            float offset, float limx_i, float limx_s,
                            float limy_i, float limy_s, float curv_tol) {
  FusedArgs a;
  for (int k = 0; k < NSLOTS; ++k) {
    a.in.p[k] = in[k];
    a.out.p[k] = out[k];
  }
  a.n = n;
  a.steps = steps;
  a.stats = stats;
  a.ds = ds;
  a.limit = limit;
  a.offset = offset;
  a.curv_tol = curv_tol;
  a.box[0] = limx_i;
  a.box[1] = limx_s;
  a.box[2] = limy_i;
  a.box[3] = limy_s;
  a.ds_ray = nullptr;
  a.limit_ray = nullptr;
  return a;
}

}  // namespace rt

#define RT_FUSED_PARAMS                                                     \
  int op, int stats, void *const *in, void *const *out, int n, int steps,   \
      float ds, float limit, float offset, float limx_i, float limx_s,      \
      float limy_i, float limy_s, float curv_tol
#define RT_FUSED_ARGS                                                        \
  rt::fused_args(stats, in, out, n, steps, ds, limit, offset, limx_i, limx_s, \
                 limy_i, limy_s, curv_tol)

