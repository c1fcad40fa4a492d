// The golden/Newton momentum-cost integrator's step loop for op5, op9,
// op10, op11, op10n and op11n, templated on the medium (media.cuh, or a
// generated custom medium) and the variant (stepper, solver, iso): the
// second-order dual numbers, the cost, the Newton polish, the arguments,
// the kernel, its launchers and the C parameter list of every golden entry
// point.  golden.cu instantiates it on the analytic, stratified and grid
// media; kernels/custom.py generates one translation unit a (custom medium,
// variant) that includes this header and instantiates the one loop it
// needs.  What the loop computes, and what bounds it, is described at the
// top of golden.cu.
#pragma once

#include "media.cuh"

namespace rt {

// -- second-order dual numbers ----------------------------------------------
struct Dual2 {
  float v, d1, d2;
};
__device__ __forceinline__ Dual2 operator+(Dual2 a, Dual2 b) {
  return {a.v + b.v, a.d1 + b.d1, a.d2 + b.d2};
}
__device__ __forceinline__ Dual2 operator-(Dual2 a, Dual2 b) {
  return {a.v - b.v, a.d1 - b.d1, a.d2 - b.d2};
}
__device__ __forceinline__ Dual2 operator*(Dual2 a, Dual2 b) {
  return {a.v * b.v, a.d1 * b.v + a.v * b.d1,
          a.d2 * b.v + 2.0f * a.d1 * b.d1 + a.v * b.d2};
}
__device__ __forceinline__ Dual2 operator*(Dual2 a, float b) {
  return {a.v * b, a.d1 * b, a.d2 * b};
}
__device__ __forceinline__ Dual2 operator*(float a, Dual2 b) { return b * a; }
__device__ __forceinline__ Dual2 operator-(float a, Dual2 b) {
  return {a - b.v, -b.d1, -b.d2};
}
__device__ __forceinline__ Dual2 operator-(Dual2 a, float b) {
  return {a.v - b, a.d1, a.d2};
}
// f = s^-1/2: f' = -f/(2s), f'' = 3f/(4s^2)
__device__ __forceinline__ Dual2 rsqrt2(Dual2 s) {
  const float f = rsqrtf(s.v);
  const float inv = 1.0f / s.v;
  const float f1 = -0.5f * f * inv;
  const float f2 = 0.75f * f * inv * inv;
  return {f, f1 * s.d1, f2 * s.d1 * s.d1 + f1 * s.d2};
}
__device__ __forceinline__ float rsqrt2(float s) { return rsqrtf(s); }

// -- the momentum cost (golden.py:274-304) -----------------------------------
template <bool ISO>
struct Cost {
  float n2, kx, ky, gamma, hx, hy, n2g2;
  template <typename T>
  __device__ __forceinline__ T operator()(const T& ct, const T& st) const {
    if (ISO) {
      const T rx = n2 * ct - kx;
      const T ry = n2 * st - ky;
      return rx * rx + ry * ry;
    } else {
      const T gs = gamma * st;
      const T s2 = gs * gs + ct * ct;
      const T inv = rsqrt2(s2);
      const T cf = s2 * inv;
      const T rx = n2 * ct * inv - kx - cf * hx;
      const T ry = n2g2 * st * inv - ky - cf * hy;
      return rx * rx + ry * ry;
    }
  }
};

__device__ __forceinline__ float clipf(float v, float b) {
  return fminf(fmaxf(v, -b), b);
}

// Newton on d(cost)/d(delta), delta measured from the seed (mc, ms)
template <bool ISO>
__device__ __forceinline__ void newton_polish(const Cost<ISO>& cost, float mc,
                                              float ms, float t0, int n_steps,
                                              float clip_b, float& t_new,
                                              float& tc, float& ts) {
  float dlt = 0.0f;
  for (int k = 0; k < n_steps; ++k) {
    const Dual2 dd = {dlt, 1.0f, 0.0f};
    Dual2 sd, cd;
    rot_small(dd, sd, cd);
    const Dual2 f = cost(mc * cd - ms * sd, mc * sd + ms * cd);
    const float ad2 = fabsf(f.d2);
    const float safe = ad2 < 1e-12f ? 1e-12f : ad2;
    dlt = dlt - clipf(f.d1 / safe, clip_b);
  }
  dlt = clipf(dlt, clip_b);
  float sd, cd;
  rot_small(dlt, sd, cd);
  t_new = t0 + dlt;
  tc = mc * cd - ms * sd;
  ts = mc * sd + ms * cd;
}

__device__ __forceinline__ float asin_small(float s) {
  const float s2 = s * s;
  return s * (1.0f + s2 * (kSixth + s2 * (float)(3.0 / 40.0)));
}

struct GoldenArgs {
  Planes in, out;
  const float* scal;  // [ds, gamma, limit, offset, (cos, sin) x iters, d x iters]
  int n, steps, stats, iters, polish;
  float curv_tol;
  float box[4];
  float cos_c0, sin_c0, cos_d0, sin_d0, cos_m, sin_m, l_final;
};

constexpr float kDeltaG = (float)(3.141592653589793 / 2.0);  // config.DELTA_G

template <class Medium, bool CURV, bool NEWTON, bool ISO>
__global__ void __launch_bounds__(kThreads)
    golden_kernel(GoldenArgs a, Medium medium) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const float ds = a.scal[0], gamma = a.scal[1], limit = a.scal[2],
              offset = a.scal[3];
  const float g2 = gamma * gamma;
  const float inv_g2 = 1.0f / g2;

  float x = ld(a.in, X, r), y = ld(a.in, Y, r);
  float ux = ld(a.in, UX, r), uy = ld(a.in, UY, r);
  float cx = ld(a.in, CX, r), cy = ld(a.in, CY, r);
  float ang = ld(a.in, ANG, r);
  float tt = ld(a.in, TT, r), dsim = ld(a.in, DSIM, r);
  bool active = static_cast<const bool*>(a.in.p[ACTIVE])[r];
  float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (a.stats) {
    cnt = ld(a.in, CNT, r);
    mean = ld(a.in, MEAN, r);
    m2 = ld(a.in, M2, r);
  }
  float n, gx, gy;
  medium.nag(x, y, n, gx, gy);

  for (int i = 0; i < a.steps; ++i) {
    if (!active || !((float)i + offset < limit)) break;

    // ---- position advance ---------------------------------------------
    const float gdotu = gx * ux + gy * uy;
    const float txx = gx - gdotu * ux;
    const float txy = gy - gdotu * uy;
    float ddx, ddy;
    bool significant = true;
    if (!CURV) {
      const float half_fac = ds * ds * 0.5f / n;
      ddx = ux * ds + txx * half_fac;
      ddy = uy * ds + txy * half_fac;
    } else {
      significant = arc_advance(ux, uy, gx, gy, txx, txy, n, ds, a.curv_tol,
                                ddx, ddy);
    }
    float nx2, ny2, cx2, cy2;
    kahan(x, cx, ddx, nx2, cx2);
    kahan(y, cy, ddy, ny2, cy2);
    float n2, gx2, gy2;
    medium.nag(nx2, ny2, n2, gx2, gy2);

    // ---- minimize the momentum cost -----------------------------------
    const float gu = gamma * uy;
    const float coef_i = ISO ? 1.0f : sqrtf(gu * gu + ux * ux);
    const float half_ds = ds * 0.5f;
    Cost<ISO> cost;
    cost.n2 = n2;
    cost.gamma = gamma;
    if (ISO) {
      cost.kx = n * ux + (gx + gx2) * half_ds;
      cost.ky = n * uy + (gy + gy2) * half_ds;
      cost.hx = cost.hy = cost.n2g2 = 0.0f;
    } else {
      const float inv_i = rsqrtf(gu * gu + ux * ux);
      const float mi_x = n * ux * inv_i;
      const float mi_y = n * g2 * uy * inv_i;
      cost.kx = mi_x + coef_i * gx * half_ds;
      cost.ky = mi_y + coef_i * gy * half_ds;
      cost.hx = gx2 * half_ds;
      cost.hy = gy2 * half_ds;
      cost.n2g2 = n2 * g2;
    }
    // closed-form minimizer (iso, exact) / ray-intersection seed (aniso)
    float mc, ms;
    {
      const float kyg = ISO ? cost.ky : cost.ky * inv_g2;
      const float inv_k = rsqrtf(cost.kx * cost.kx + kyg * kyg);
      mc = cost.kx * inv_k;
      ms = kyg * inv_k;
    }
    float t_new, tc = 0.0f, ts = 0.0f;
    if (NEWTON) {
      const float t0 = ang + asin_small(ux * ms - uy * mc);
      newton_polish(cost, mc, ms, t0, 3, 0.3f, t_new, tc, ts);
    } else if (a.iters == 0) {
      t_new = ang + asin_small(ux * ms - uy * mc);
      if (ISO || a.polish == 0) {
        tc = mc;
        ts = ms;
      } else {
        newton_polish(cost, mc, ms, t_new, a.polish, 0.15f, t_new, tc, ts);
      }
    } else {
      // transcendental-free golden bracket (golden.py:361-414)
      float a_ang = ang - kDeltaG, b_ang = ang + kDeltaG;
      float pc = ux * a.cos_c0 - uy * a.sin_c0;
      float ps = ux * a.sin_c0 + uy * a.cos_c0;
      float qc = ux * a.cos_d0 - uy * a.sin_d0;
      float qs = ux * a.sin_d0 + uy * a.cos_d0;
      float fc = cost(pc, ps), fd = cost(qc, qs);
      for (int k = 0; k < a.iters; ++k) {
        const float cth = a.scal[4 + 2 * k];
        const float sth = a.scal[5 + 2 * k];
        const bool left = fc < fd;
        const float sth_s = left ? -sth : sth;
        const float base_c = left ? qc : pc;
        const float base_s = left ? qs : ps;
        const float fresh_c = base_c * cth - base_s * sth_s;
        const float fresh_s = base_c * sth_s + base_s * cth;
        const float ff = cost(fresh_c, fresh_s);
        const float pc2 = left ? fresh_c : qc, ps2 = left ? fresh_s : qs;
        const float qc2 = left ? pc : fresh_c, qs2 = left ? ps : fresh_s;
        const float fc2 = left ? ff : fd, fd2 = left ? fc : ff;
        const float dk = a.scal[4 + 2 * a.iters + k];
        a_ang = left ? a_ang : a_ang + dk;
        b_ang = left ? b_ang - dk : b_ang;
        pc = pc2;
        ps = ps2;
        qc = qc2;
        qs = qs2;
        fc = fc2;
        fd = fd2;
      }
      t_new = (a_ang + b_ang) * 0.5f;
      if (a.polish) {
        const float mmc = pc * a.cos_m - ps * a.sin_m;
        const float mms = pc * a.sin_m + ps * a.cos_m;
        newton_polish(cost, mmc, mms, t_new, a.polish, a.l_final, t_new, tc,
                      ts);
      }
    }
    const float nang = significant ? t_new : ang;
    float nux, nuy;
    if (NEWTON || a.polish || a.iters == 0) {
      // tangent by rotation, renormalized against ulp drift
      const float inv_nrm = rsqrtf(tc * tc + ts * ts);
      nux = significant ? tc * inv_nrm : ux;
      nuy = significant ? ts * inv_nrm : uy;
    } else {
      // parity mode: the tangent re-derived from the angle each step
      nux = cosf(nang);
      nuy = sinf(nang);
    }

    const float dist = sqrtf(ddx * ddx + ddy * ddy);
    const float gnu = gamma * nuy;
    const float cf_new = ISO ? 1.0f : sqrtf(gnu * gnu + nux * nux);
    tt = tt + dist * (coef_i * n + cf_new * n2) * 0.5f;
    dsim = dsim + dist;
    if (a.stats) {
      // Welford over the post-step m_x = n ct / cf (golden.py:218-228)
      const float mx2 = ISO ? n2 * nux : n2 * nux / cf_new;
      cnt = cnt + 1.0f;
      const float delta = mx2 - mean;
      mean = mean + delta / cnt;
      m2 = m2 + delta * (mx2 - mean);
    }
    x = nx2;
    y = ny2;
    cx = cx2;
    cy = cy2;
    ang = nang;
    ux = nux;
    uy = nuy;
    n = n2;
    gx = gx2;
    gy = gy2;
    if (outside(x, y, a.box)) active = false;
  }

  st(a.out, X, r, x);
  st(a.out, Y, r, y);
  st(a.out, UX, r, ux);
  st(a.out, UY, r, uy);
  st(a.out, CX, r, cx);
  st(a.out, CY, r, cy);
  st(a.out, ANG, r, ang);
  st(a.out, TT, r, tt);
  st(a.out, DSIM, r, dsim);
  static_cast<bool*>(a.out.p[ACTIVE])[r] = active;
  if (a.stats) {
    st(a.out, CNT, r, cnt);
    st(a.out, MEAN, r, mean);
    st(a.out, M2, r, m2);
  }
}

// one instantiation: the loop of (CURV, NEWTON, ISO) on Medium (a generated
// custom-medium library instantiates only the variant it was built for)
template <class Medium, bool CURV, bool NEWTON, bool ISO>
static int launch_golden_variant(const GoldenArgs& a, const Medium& m,
                                 cudaStream_t s) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  golden_kernel<Medium, CURV, NEWTON, ISO><<<blocks, kThreads, 0, s>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

// every variant of the family on Medium, chosen at run time
template <class Medium>
static int launch_golden(int curv, int newton, int iso, const GoldenArgs& a,
                         const Medium& m, cudaStream_t s) {
  const int code = (curv ? 4 : 0) | (newton ? 2 : 0) | (iso ? 1 : 0);
  switch (code) {
    case 0: return launch_golden_variant<Medium, false, false, false>(a, m, s);
    case 1: return launch_golden_variant<Medium, false, false, true>(a, m, s);
    case 2: return launch_golden_variant<Medium, false, true, false>(a, m, s);
    case 4: return launch_golden_variant<Medium, true, false, false>(a, m, s);
    case 5: return launch_golden_variant<Medium, true, false, true>(a, m, s);
    case 6: return launch_golden_variant<Medium, true, true, false>(a, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);  // no iso Newton op
  }
}

static GoldenArgs golden_args(int stats, void* const* in, void* const* out,
                              int n, int steps, const void* scal, int iters,
                              int polish, float limx_i, float limx_s,
                              float limy_i, float limy_s, float curv_tol,
                              float cos_c0, float sin_c0, float cos_d0,
                              float sin_d0, float cos_m, float sin_m,
                              float l_final) {
  GoldenArgs a;
  for (int k = 0; k < NSLOTS; ++k) {
    a.in.p[k] = in[k];
    a.out.p[k] = out[k];
  }
  a.scal = static_cast<const float*>(scal);
  a.n = n;
  a.steps = steps;
  a.stats = stats;
  a.iters = iters;
  a.polish = polish;
  a.curv_tol = curv_tol;
  a.box[0] = limx_i;
  a.box[1] = limx_s;
  a.box[2] = limy_i;
  a.box[3] = limy_s;
  a.cos_c0 = cos_c0;
  a.sin_c0 = sin_c0;
  a.cos_d0 = cos_d0;
  a.sin_d0 = sin_d0;
  a.cos_m = cos_m;
  a.sin_m = sin_m;
  a.l_final = l_final;
  return a;
}

}  // namespace rt

#define RT_GOLDEN_PARAMS                                                      \
  int curv, int newton, int iso, int stats, void *const *in,                 \
      void *const *out, int n, int steps, const void *scal, int iters,       \
      int polish, float limx_i, float limx_s, float limy_i, float limy_s,    \
      float curv_tol, float cos_c0, float sin_c0, float cos_d0,              \
      float sin_d0, float cos_m, float sin_m, float l_final
#define RT_GOLDEN_ARGS                                                        \
  rt::golden_args(stats, in, out, n, steps, scal, iters, polish, limx_i,     \
                  limx_s, limy_i, limy_s, curv_tol, cos_c0, sin_c0, cos_d0,  \
                  sin_d0, cos_m, sin_m, l_final)

