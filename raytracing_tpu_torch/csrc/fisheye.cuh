// The loop of fisheye_op1 (fisheye.cu): op1 on the analytic Maxwell
// fisheye, one ray's whole run, __host__ __device__ so that the CPU tests
// build it with g++ (the CUDA qualifiers stubbed, -ffp-contract=off) and
// hold it to kernels/fisheye.py::fisheye_op1_plain to the bit.
//
// A step (fisheye.py:33-80): first-order Kahan-compensated positions, the
// field at the new position, the trig-free tangent normalize(n u + (grad
// n0 + grad n1) ds/2), the trapezoid traveltime.  Four steps an iteration
// take the fast path (the field's reciprocal by rcp_fast, the
// normalization by rsqrt_fast: common.cuh) and test their guards once;
// where any fails, the four steps run again with the IEEE reciprocal and
// rsqrtf from the same carry.  The last steps (3 of the headline's 4587)
// run one at a time.
#pragma once

#include "media.cuh"

namespace rt {

// one ray's carry: position and its Kahan carries, tangent, n and grad n at
// the position, traveltime
struct Fish {
  float x, y, cx, cy, ux, uy, n, gx, gy, tt;
};

// one step.  HALF_TT: the traveltime increment as half * (n + n2) (one
// product) instead of ds * (n + n2) * 0.5f; halving is exact, so the two
// round alike wherever ds * (n + n2) is normal and ds / 2 exact, which
// fisheye_op1_run checks for a ray once (tt_by_half).  FAST: the fast
// path, its guards ANDed into ok.
template <bool FAST, bool HALF_TT>
RT_HD void fish_advance(Fish& s, float ds, float half, bool& ok) {
  const Analytic<FISHEYE> medium{};
  float nx, ny, ncx, ncy;
  kahan(s.x, s.cx, s.ux * ds, nx, ncx);
  kahan(s.y, s.cy, s.uy * ds, ny, ncy);
  float n2, gx2, gy2;
  if (FAST) {
    medium.nag_fast(nx, ny, n2, gx2, gy2, ok);
  } else {
    medium.nag(nx, ny, n2, gx2, gy2);
  }
  // theta_cost_t, trig-free: new tangent = normalized momentum + impulse
  const float sx = s.n * s.ux + (s.gx + gx2) * half;
  const float sy = s.n * s.uy + (s.gy + gy2) * half;
  const float v = sx * sx + sy * sy;
  const float inv = FAST ? rsqrt_fast(v, ok) : rsqrt_f(v);
  s.ux = sx * inv;
  s.uy = sy * inv;
  // optical path: a first-order step moves exactly ds
  s.tt = s.tt + (HALF_TT ? half * (s.n + n2) : ds * (s.n + n2) * 0.5f);
  s.x = nx;
  s.y = ny;
  s.cx = ncx;
  s.cy = ncy;
  s.n = n2;
  s.gx = gx2;
  s.gy = gy2;
}

// K steps on the fast path, their guards tested once; where any fails, the
// K steps again with the IEEE operations from the same carry
template <int K, bool HALF_TT>
RT_HD void fish_steps_k(Fish& s, float ds, float half) {
  Fish t = s;
  bool ok = true;
#pragma unroll
  for (int k = 0; k < K; ++k) fish_advance<true, HALF_TT>(t, ds, half, ok);
  if (!ok) {
    t = s;
#pragma unroll
    for (int k = 0; k < K; ++k) fish_advance<false, HALF_TT>(t, ds, half, ok);
  }
  s = t;
}

// four steps an iteration, one test of their guards, then the rest one by
// one
template <bool HALF_TT>
RT_HD void fish_steps(Fish& s, int steps, float ds, float half) {
  int i = 0;
  for (; i + 4 <= steps; i += 4) fish_steps_k<4, HALF_TT>(s, ds, half);
  for (; i < steps; ++i) fish_steps_k<1, HALF_TT>(s, ds, half);
}

// Whether half * (n + n2) rounds as ds * (n + n2) * 0.5f on every step of
// a ray from (x, y) heading (ux, uy): ds in [2^-60, 2^60] (so ds / 2 is
// exact), and the ray stays where |x|, |y| <= 2^30, so that n >= 2^-62 and
// ds (n + n2) lies in [2^-122, 2^61], a normal number.  A step moves the
// position by u ds (|u| <= |ux| + |uy| on the first step, 1 + an ulp after
// it), so |x0| + |y0| + (|ux| + |uy| + 2) |ds| steps bounds it; NaN or inf
// anywhere fails the test.
RT_HD bool tt_by_half(float x, float y, float ux, float uy, float ds,
                      int steps) {
  const float ads = fabsf(ds);
  const float reach = fabsf(x) + fabsf(y) +
                      (fabsf(ux) + fabsf(uy) + 2.0f) * ads * (float)steps;
  return ads >= 0x1p-60f && ads <= 0x1p60f && reach <= 0x1p30f;
}

// `steps` op1 steps of one ray from (x, y) heading (ux, uy): the final
// position and traveltime
RT_HD void fisheye_op1_run(float x, float y, float ux, float uy, int steps,
                           float ds, float& out_x, float& out_y,
                           float& out_tt) {
  Fish s{x, y, 0.0f, 0.0f, ux, uy, 0.0f, 0.0f, 0.0f, 0.0f};
  Analytic<FISHEYE>{}.nag(x, y, s.n, s.gx, s.gy);
  const float half = ds * 0.5f;
  if (tt_by_half(x, y, ux, uy, ds, steps)) {
    fish_steps<true>(s, steps, ds, half);
  } else {
    fish_steps<false>(s, steps, ds, half);
  }
  out_x = s.x;
  out_y = s.y;
  out_tt = s.tt;
}

}  // namespace rt
