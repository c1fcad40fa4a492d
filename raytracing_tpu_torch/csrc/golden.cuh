// The golden/Newton momentum-cost integrator's step loop for op5, op9,
// op10, op11, op10n and op11n, templated on the medium (media.cuh, or a
// generated custom medium) and the variant (stepper, solver, iso): the
// second-order dual numbers, the cost, the Newton polish, one ray's work on
// its carry, the two kernels that schedule it, their launchers and the C
// parameter list of every golden entry point.  golden.cu instantiates it on
// the analytic, stratified and grid media; kernels/custom.py generates one
// translation unit a (custom medium, variant) that includes this header and
// instantiates the one loop it needs.  What the loop computes, and what
// bounds it, is described at the top of golden.cu.
//
// One ray's work is __host__ __device__ functions on its carry (Gold):
// load_gold, gold_step (one step) and store_gold; run_gold is the whole
// loop of one ray.  They also build for the host with g++ (the CUDA
// qualifiers stubbed, -ffp-contract=off), where the CPU tests hold them to
// the plain version (kernels/golden.py::golden_step_plain) to the bit.
//
// A step takes its reciprocals, square roots, reciprocal square roots and
// quotients on their fast paths (common.cuh: rcp_fast, sqrt_fast,
// rsqrt_fast, div_fast_pos), tests their guards once, and where any fails
// takes the step again with the IEEE operations from the same carry
// (GoldMode; the grid keeps the IEEE operations), so every result keeps the
// IEEE operation's bits.  The
// anisotropy factor sqrt(gamma^2 uy^2 + ux^2) of the tangent and its
// reciprocal square root are carried (Gold::cf, rcf): the step that makes
// a tangent computes both from one MUFU.RSQ (sqrt_rsqrt_m), and the next
// step reads them.  Newton's first iteration, at delta = 0, skips the
// rotation of the seed (newton_polish).
//
// Two kernels schedule the step, as the fused loop's two do (fused.cuh):
// golden_kernel runs one ray a thread (the analytic fisheye, whose fans are
// one ray repeated, and the grid); golden_kernel_refill is the persistent
// refill loop (refill.cuh) for the media whose fans put rays of very
// different lifetimes in one warp (GoldRefills).  Each lane carries its own
// ray's step count, so a ray taken late runs exactly the steps it runs
// alone.
#pragma once

#include "refill.cuh"

namespace rt {

// -- second-order dual numbers ----------------------------------------------
struct Dual2 {
  float v, d1, d2;
};
RT_HD Dual2 operator+(Dual2 a, Dual2 b) {
  return {a.v + b.v, a.d1 + b.d1, a.d2 + b.d2};
}
RT_HD Dual2 operator-(Dual2 a, Dual2 b) {
  return {a.v - b.v, a.d1 - b.d1, a.d2 - b.d2};
}
RT_HD Dual2 operator*(Dual2 a, Dual2 b) {
  return {a.v * b.v, a.d1 * b.v + a.v * b.d1,
          a.d2 * b.v + 2.0f * a.d1 * b.d1 + a.v * b.d2};
}
RT_HD Dual2 operator*(Dual2 a, float b) {
  return {a.v * b, a.d1 * b, a.d2 * b};
}
RT_HD Dual2 operator*(float a, Dual2 b) { return b * a; }
RT_HD Dual2 operator-(float a, Dual2 b) {
  return {a - b.v, -b.d1, -b.d2};
}
RT_HD Dual2 operator-(Dual2 a, float b) {
  return {a.v - b, a.d1, a.d2};
}
// f = s^-1/2: f' = -f/(2s), f'' = 3f/(4s^2); rsqrtf and 1 / s in MODE
template <int MODE>
RT_HD Dual2 rsqrt2(Dual2 s, bool& ok) {
  const float f = rsqrt_m<MODE>(s.v, ok);
  const float inv = recip_m<MODE>(s.v, ok);
  const float f1 = -0.5f * f * inv;
  const float f2 = 0.75f * f * inv * inv;
  return {f, f1 * s.d1, f2 * s.d1 * s.d1 + f1 * s.d2};
}
template <int MODE>
RT_HD float rsqrt2(float s, bool& ok) {
  return rsqrt_m<MODE>(s, ok);
}

// -- the momentum cost (golden.py:274-304) -----------------------------------
template <bool ISO, int MODE>
struct Cost {
  float n2, kx, ky, gamma, hx, hy, n2g2;
  template <typename T>
  RT_HD T operator()(const T& ct, const T& st, bool& ok) const {
    if (ISO) {
      const T rx = n2 * ct - kx;
      const T ry = n2 * st - ky;
      return rx * rx + ry * ry;
    } else {
      const T gs = gamma * st;
      const T s2 = gs * gs + ct * ct;
      const T inv = rsqrt2<MODE>(s2, ok);
      const T cf = s2 * inv;
      const T rx = n2 * ct * inv - kx - cf * hx;
      const T ry = n2g2 * st * inv - ky - cf * hy;
      return rx * rx + ry * ry;
    }
  }
};

RT_HD float clipf(float v, float b) { return fminf(fmaxf(v, -b), b); }

// one Newton step on delta from the cost's derivatives f there
template <int MODE>
RT_HD float newton_update(float dlt, const Dual2& f, float clip_b,
                          bool& ok) {
  const float ad2 = fabsf(f.d2);
  const float safe = ad2 < 1e-12f ? 1e-12f : ad2;
  return dlt - clipf(div_pos_m<MODE>(f.d1, safe, ok), clip_b);
}

// Newton on d(cost)/d(delta), delta measured from the seed (mc, ms).  The
// first iteration evaluates the cost at delta = 0, where the small-angle
// rotation of the dual {0, 1, 0} is sd = {0, 1, 0}, cd = {1, -0, -1}: the
// rotated seed is ct = {mc, -ms, -mc}, st = {ms, mc, -ms}, exactly, up to
// the signs of zeros where mc or ms is 0.  Those signs reach no nonzero
// value (the cost divides by, and takes the root of, only s2.v, a sum of
// squares), and a zero f.d1 gives delta = 0 - (+-0) = +0 either way, so
// the polish keeps its bits.
template <bool ISO, int MODE>
RT_HD void newton_polish(const Cost<ISO, MODE>& cost, float mc, float ms,
                         float t0, int n_steps, float clip_b, float& t_new,
                         float& tc, float& ts, bool& ok) {
  float dlt = 0.0f;
  if (n_steps > 0) {
    const Dual2 ct = {mc, -ms, -mc}, st = {ms, mc, -ms};
    dlt = newton_update<MODE>(0.0f, cost(ct, st, ok), clip_b, ok);
  }
  for (int k = 1; k < n_steps; ++k) {
    const Dual2 dd = {dlt, 1.0f, 0.0f};
    Dual2 sd, cd;
    rot_small(dd, sd, cd);
    dlt = newton_update<MODE>(
        dlt, cost(mc * cd - ms * sd, mc * sd + ms * cd, ok), clip_b, ok);
  }
  dlt = clipf(dlt, clip_b);
  float sd, cd;
  rot_small(dlt, sd, cd);
  t_new = t0 + dlt;
  tc = mc * cd - ms * sd;
  ts = mc * sd + ms * cd;
}

RT_HD float asin_small(float s) {
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
  // the refill kernel's ray counter (one int, 0 at launch), or null
  int* next;
};

constexpr float kDeltaG = (float)(3.141592653589793 / 2.0);  // config.DELTA_G

// The launch's constants from the scalar bundle, and what the step derives
// from them (ds^2 / 2, the plain version's dsds_half, hoisted)
struct GoldConst {
  float ds, gamma, limit, offset, g2, inv_g2, half_ds, dsds_half;
};

RT_HD GoldConst gold_const(const GoldenArgs& a) {
  GoldConst k;
  k.ds = a.scal[0];
  k.gamma = a.scal[1];
  k.limit = a.scal[2];
  k.offset = a.scal[3];
  k.g2 = k.gamma * k.gamma;
  k.inv_g2 = 1.0f / k.g2;
  k.half_ds = k.ds * 0.5f;
  k.dsds_half = k.ds * k.ds * 0.5f;
  return k;
}

// One ray's carry: the state planes, n and grad n at (x, y), and the
// anisotropy factor cf = sqrt(gamma^2 uy^2 + ux^2) of (ux, uy) with rcf =
// rsqrtf of the same sum (1 for op5/op9)
struct Gold {
  float x, y, ux, uy, cx, cy, ang, tt, dsim;
  float cnt, mean, m2;  // the Welford tracker (stats)
  float n, gx, gy;
  float cf, rcf;
  bool active;
};

template <class Medium, bool ISO>
RT_HD void load_gold(const GoldenArgs& a, const GoldConst& k,
                     const Medium& medium, int r, Gold& s) {
  s.x = ld(a.in, X, r);
  s.y = ld(a.in, Y, r);
  s.ux = ld(a.in, UX, r);
  s.uy = ld(a.in, UY, r);
  s.cx = ld(a.in, CX, r);
  s.cy = ld(a.in, CY, r);
  s.ang = ld(a.in, ANG, r);
  s.tt = ld(a.in, TT, r);
  s.dsim = ld(a.in, DSIM, r);
  s.active = static_cast<const bool*>(a.in.p[ACTIVE])[r];
  s.cnt = s.mean = s.m2 = 0.0f;
  if (a.stats) {
    s.cnt = ld(a.in, CNT, r);
    s.mean = ld(a.in, MEAN, r);
    s.m2 = ld(a.in, M2, r);
  }
  medium.nag(s.x, s.y, s.n, s.gx, s.gy);
  s.cf = s.rcf = 1.0f;
  if (!ISO) {
    bool ok = true;
    const float gu = k.gamma * s.uy;
    s.cf = sqrt_rsqrt_m<STEP_LOCAL>(gu * gu + s.ux * s.ux, s.rcf, ok);
  }
}

RT_HD void store_gold(const GoldenArgs& a, int r, const Gold& s) {
  st(a.out, X, r, s.x);
  st(a.out, Y, r, s.y);
  st(a.out, UX, r, s.ux);
  st(a.out, UY, r, s.uy);
  st(a.out, CX, r, s.cx);
  st(a.out, CY, r, s.cy);
  st(a.out, ANG, r, s.ang);
  st(a.out, TT, r, s.tt);
  st(a.out, DSIM, r, s.dsim);
  static_cast<bool*>(a.out.p[ACTIVE])[r] = s.active;
  if (a.stats) {
    st(a.out, CNT, r, s.cnt);
    st(a.out, MEAN, r, s.mean);
    st(a.out, M2, r, s.m2);
  }
}

// one step (golden.py:230-455) on the carry, its guarded operations in
// MODE (their guards ANDed into ok); stats is a.stats
template <class Medium, bool CURV, bool NEWTON, bool ISO, int MODE>
RT_HD void gold_advance(const GoldenArgs& a, const GoldConst& k,
                        const Medium& medium, Gold& s, bool stats, bool& ok) {
  const float ux = s.ux, uy = s.uy, n = s.n, gx = s.gx, gy = s.gy;

  // ---- position advance -----------------------------------------------
  const float gdotu = gx * ux + gy * uy;
  const float txx = gx - gdotu * ux;
  const float txy = gy - gdotu * uy;
  float ddx, ddy;
  bool significant = true;
  if (!CURV) {
    const float half_fac = div_pos_m<MODE>(k.dsds_half, n, ok);
    ddx = ux * k.ds + txx * half_fac;
    ddy = uy * k.ds + txy * half_fac;
  } else {
    significant = arc_advance_m<MODE>(ux, uy, gx, gy, txx, txy, n, k.ds,
                                      a.curv_tol, ddx, ddy, ok);
  }
  float nx2, ny2, cx2, cy2;
  kahan(s.x, s.cx, ddx, nx2, cx2);
  kahan(s.y, s.cy, ddy, ny2, cy2);
  float n2, gx2, gy2;
  medium.nag(nx2, ny2, n2, gx2, gy2);

  // ---- minimize the momentum cost -------------------------------------
  const float coef_i = s.cf;
  Cost<ISO, MODE> cost;
  cost.n2 = n2;
  cost.gamma = k.gamma;
  if (ISO) {
    cost.kx = n * ux + (gx + gx2) * k.half_ds;
    cost.ky = n * uy + (gy + gy2) * k.half_ds;
    cost.hx = cost.hy = cost.n2g2 = 0.0f;
  } else {
    const float inv_i = s.rcf;
    const float mi_x = n * ux * inv_i;
    const float mi_y = n * k.g2 * uy * inv_i;
    cost.kx = mi_x + coef_i * gx * k.half_ds;
    cost.ky = mi_y + coef_i * gy * k.half_ds;
    cost.hx = gx2 * k.half_ds;
    cost.hy = gy2 * k.half_ds;
    cost.n2g2 = n2 * k.g2;
  }
  // closed-form minimizer (iso, exact) / ray-intersection seed (aniso)
  float mc, ms;
  {
    const float kyg = ISO ? cost.ky : cost.ky * k.inv_g2;
    const float inv_k = rsqrt_m<MODE>(cost.kx * cost.kx + kyg * kyg, ok);
    mc = cost.kx * inv_k;
    ms = kyg * inv_k;
  }
  float t_new, tc = 0.0f, ts = 0.0f;
  if (NEWTON) {
    const float t0 = s.ang + asin_small(ux * ms - uy * mc);
    newton_polish(cost, mc, ms, t0, 3, 0.3f, t_new, tc, ts, ok);
  } else if (a.iters == 0) {
    t_new = s.ang + asin_small(ux * ms - uy * mc);
    if (ISO || a.polish == 0) {
      tc = mc;
      ts = ms;
    } else {
      newton_polish(cost, mc, ms, t_new, a.polish, 0.15f, t_new, tc, ts, ok);
    }
  } else {
    // transcendental-free golden bracket (golden.py:361-414)
    float a_ang = s.ang - kDeltaG, b_ang = s.ang + kDeltaG;
    float pc = ux * a.cos_c0 - uy * a.sin_c0;
    float ps = ux * a.sin_c0 + uy * a.cos_c0;
    float qc = ux * a.cos_d0 - uy * a.sin_d0;
    float qs = ux * a.sin_d0 + uy * a.cos_d0;
    float fc = cost(pc, ps, ok), fd = cost(qc, qs, ok);
    for (int j = 0; j < a.iters; ++j) {
      const float cth = a.scal[4 + 2 * j];
      const float sth = a.scal[5 + 2 * j];
      const bool left = fc < fd;
      const float sth_s = left ? -sth : sth;
      const float base_c = left ? qc : pc;
      const float base_s = left ? qs : ps;
      const float fresh_c = base_c * cth - base_s * sth_s;
      const float fresh_s = base_c * sth_s + base_s * cth;
      const float ff = cost(fresh_c, fresh_s, ok);
      const float pc2 = left ? fresh_c : qc, ps2 = left ? fresh_s : qs;
      const float qc2 = left ? pc : fresh_c, qs2 = left ? ps : fresh_s;
      const float fc2 = left ? ff : fd, fd2 = left ? fc : ff;
      const float dk = a.scal[4 + 2 * a.iters + j];
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
                    ts, ok);
    }
  }
  const float nang = significant ? t_new : s.ang;
  float nux, nuy;
  if (NEWTON || a.polish || a.iters == 0) {
    // tangent by rotation, renormalized against ulp drift
    const float inv_nrm = rsqrt_m<MODE>(tc * tc + ts * ts, ok);
    nux = significant ? tc * inv_nrm : ux;
    nuy = significant ? ts * inv_nrm : uy;
  } else {
    // parity mode: the tangent re-derived from the angle each step
    nux = cosf(nang);
    nuy = sinf(nang);
  }

  const float dist = sqrt_m<MODE>(ddx * ddx + ddy * ddy, ok);
  float cf_new = 1.0f, rcf_new = 1.0f;
  if (!ISO) {
    const float gnu = k.gamma * nuy;
    cf_new = sqrt_rsqrt_m<MODE>(gnu * gnu + nux * nux, rcf_new, ok);
  }
  s.tt = s.tt + dist * (coef_i * n + cf_new * n2) * 0.5f;
  s.dsim = s.dsim + dist;
  if (stats) {
    // Welford over the post-step m_x = n ct / cf (golden.py:218-228)
    const float mx2 = ISO ? n2 * nux : div_pos_m<MODE>(n2 * nux, cf_new, ok);
    s.cnt = s.cnt + 1.0f;
    const float delta = mx2 - s.mean;
    s.mean = s.mean + div_pos_m<MODE>(delta, s.cnt, ok);
    s.m2 = s.m2 + delta * (mx2 - s.mean);
  }
  s.x = nx2;
  s.y = ny2;
  s.cx = cx2;
  s.cy = cy2;
  s.ang = nang;
  s.ux = nux;
  s.uy = nuy;
  s.n = n2;
  s.gx = gx2;
  s.gy = gy2;
  s.cf = cf_new;
  s.rcf = rcf_new;
}

// The form of the step's guarded operations on Medium (common.cuh
// StepMode): STEP_FAST, the step on the fast paths with their guards ANDed
// into one flag, tested once, and where it fails the step again in
// STEP_IEEE from the same carry: the same bits either way.  It beat
// STEP_LOCAL (each operation with its own IEEE fallback, a branch each) by
// 4-7 % on the aniso and golden_strat_op11 runs.  The grid keeps the IEEE
// operations: its op5 step (tiled_grid_op5) ran 2-6 % slower on the fast
// paths, whose guards cost more than the curvature arc's three operations
// save (PERF.md section 6).
template <class Medium>
struct GoldMode {
  static constexpr int value = STEP_FAST;
};
template <int CH>
struct GoldMode<Grid<CH>> {
  static constexpr int value = STEP_IEEE;
};

// one step and the strict box exit (RT_bench.py:878; the exiting step is
// kept)
template <class Medium, bool CURV, bool NEWTON, bool ISO>
RT_HD void gold_step(const GoldenArgs& a, const GoldConst& k,
                     const Medium& medium, Gold& s, bool stats) {
  constexpr int kMode = GoldMode<Medium>::value;
  bool ok = true;
  if constexpr (kMode == STEP_FAST) {
    Gold t = s;
    gold_advance<Medium, CURV, NEWTON, ISO, STEP_FAST>(a, k, medium, t,
                                                       stats, ok);
    if (!ok) {
      t = s;
      gold_advance<Medium, CURV, NEWTON, ISO, STEP_IEEE>(a, k, medium, t,
                                                         stats, ok);
    }
    s = t;
  } else {
    gold_advance<Medium, CURV, NEWTON, ISO, kMode>(a, k, medium, s, stats,
                                                   ok);
  }
  if (outside(s.x, s.y, a.box)) s.active = false;
}

// ray r's a.steps steps, up to the step limit (step_budget: the limit is
// the launch's, the same for every ray): a thread leaves the loop as soon
// as the ray is frozen, since its state never changes again
template <class Medium, bool CURV, bool NEWTON, bool ISO>
RT_HD void run_gold(const GoldenArgs& a, const Medium& medium, int r) {
  const GoldConst k = gold_const(a);
  Gold s;
  load_gold<Medium, ISO>(a, k, medium, r, s);
  const int stop = step_budget(a.steps, k.offset, k.limit);
  const bool stats = a.stats != 0;
  for (int i = 0; i < stop && s.active; ++i)
    gold_step<Medium, CURV, NEWTON, ISO>(a, k, medium, s, stats);
  store_gold(a, r, s);
}

// The media whose launches take the refill loop: every medium but the
// analytic fisheye and the grid.  The aniso op11 fan and golden_strat_op11's
// (the scenario's angles resized to 2^20 rays) give a warp 0.677 and 0.675
// of its lane-steps on live rays one ray a thread (bench/lifetimes.py
// --candidates); the fisheye's fan, which the grid's runs share, is one ray
// repeated, where the refill adds its vote a step and wins nothing.
template <class Medium>
struct GoldRefills {
  static constexpr bool value = true;
};
template <>
struct GoldRefills<Analytic<FISHEYE>> {
  static constexpr bool value = false;
};
template <int CH>
struct GoldRefills<Grid<CH>> {
  static constexpr bool value = false;
};

#ifdef __CUDACC__

template <class Medium, bool CURV, bool NEWTON, bool ISO>
__global__ void __launch_bounds__(kThreads)
    golden_kernel(GoldenArgs a, Medium medium) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  run_gold<Medium, CURV, NEWTON, ISO>(a, medium, r);
}

// The persistent refill loop (fused.cuh's fused_kernel_refill, on the
// golden carry): a lane whose ray froze stores it and takes the next from
// the warp's reserve or, through one leader's atomicAdd, from the counter;
// while every lane's ray is live the warp steps with one vote a step.
template <class Medium, bool CURV, bool NEWTON, bool ISO>
__global__ void __launch_bounds__(kThreads)
    golden_kernel_refill(GoldenArgs a, Medium medium) {
  const GoldConst k = gold_const(a);
  const int stop = step_budget(a.steps, k.offset, k.limit);
  const bool stats = a.stats != 0;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // rays [0, taken) are each thread's first, by its global index
  const long long taken = (long long)gridDim.x * blockDim.x;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool has = r < a.n;
  int i = 0;
  Gold s;
  if (has) load_gold<Medium, ISO>(a, k, medium, r, s);
  unsigned warp = 0xffffffffu;
  Reserve w{0, 0};
  for (;;) {
    // live: the ray is neither at its step budget nor out of the box
    bool live = has && i < stop && s.active;
    if (has && !live) {
      store_gold(a, r, s);
      has = false;
    }
    const unsigned need = __ballot_sync(warp, !has);
    if (need != 0u) {
      const int kk = __popc(need), rank = __popc(need & below);
      const int more = refill_more(w, kk, kRefillChunk);
      int base = 0;
      if (more != 0) {
        const int leader = __ffs(need) - 1;
        if (lane == leader) base = atomicAdd(a.next, more);
        base = __shfl_sync(warp, base, leader);
      }
      const long long next = refill_next(w, kk, rank, more, taken, base);
      if (!has && next < a.n) {
        r = static_cast<int>(next);
        has = true;
        i = 0;
        load_gold<Medium, ISO>(a, k, medium, r, s);
        live = 0 < stop && s.active;
      }
      warp = __ballot_sync(warp, has);
      if (!has) return;
    }
    const bool all = __all_sync(warp, live);
    if (live) {
      do {
        gold_step<Medium, CURV, NEWTON, ISO>(a, k, medium, s, stats);
        ++i;
      } while (all && __all_sync(warp, i < stop && s.active));
    }
  }
}

// the refill kernel's grid for n rays on the current device (refill.cuh)
template <class Medium, bool CURV, bool NEWTON, bool ISO>
static int golden_refill_grid(int n, int* blocks) {
  static int per_sm[kMaxDevices];
  return persistent_grid(golden_kernel_refill<Medium, CURV, NEWTON, ISO>,
                         per_sm, n, blocks);
}

// one instantiation: the loop of (CURV, NEWTON, ISO) on Medium (a generated
// custom-medium library instantiates only the variant it was built for)
template <class Medium, bool CURV, bool NEWTON, bool ISO>
static int launch_golden_variant(const GoldenArgs& a, const Medium& m,
                                 cudaStream_t s) {
  if constexpr (GoldRefills<Medium>::value) {
    if (a.next == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // the ray counter starts each launch at 0, on the launch's stream
    const cudaError_t e = cudaMemsetAsync(a.next, 0, sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    int blocks = 0;
    const int err = golden_refill_grid<Medium, CURV, NEWTON, ISO>(a.n,
                                                                  &blocks);
    if (err != 0) return err;
    golden_kernel_refill<Medium, CURV, NEWTON, ISO><<<blocks, kThreads, 0,
                                                      s>>>(a, m);
  } else {
    const int blocks = (a.n + kThreads - 1) / kThreads;
    golden_kernel<Medium, CURV, NEWTON, ISO><<<blocks, kThreads, 0, s>>>(a,
                                                                         m);
  }
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

// the refill grid launch_golden would give a variant on Medium for n rays
// (0 where Medium runs one ray a thread)
template <class Medium>
static int golden_refill_blocks(int curv, int newton, int iso, int n,
                                int* blocks) {
  *blocks = 0;
  if constexpr (GoldRefills<Medium>::value) {
    const int code = (curv ? 4 : 0) | (newton ? 2 : 0) | (iso ? 1 : 0);
    switch (code) {
      case 0: return golden_refill_grid<Medium, false, false, false>(n, blocks);
      case 1: return golden_refill_grid<Medium, false, false, true>(n, blocks);
      case 2: return golden_refill_grid<Medium, false, true, false>(n, blocks);
      case 4: return golden_refill_grid<Medium, true, false, false>(n, blocks);
      case 5: return golden_refill_grid<Medium, true, false, true>(n, blocks);
      case 6: return golden_refill_grid<Medium, true, true, false>(n, blocks);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return 0;
}

#endif  // __CUDACC__

static GoldenArgs golden_args(int stats, void* const* in, void* const* out,
                              int n, int steps, const void* scal, int iters,
                              int polish, float limx_i, float limx_s,
                              float limy_i, float limy_s, float curv_tol,
                              float cos_c0, float sin_c0, float cos_d0,
                              float sin_d0, float cos_m, float sin_m,
                              float l_final, void* next) {
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
  a.next = static_cast<int*>(next);
  return a;
}

}  // namespace rt

// next: the refill loop's ray counter (one int on the card, which the
// launch zeroes; unused, and may be null, where the medium runs one ray a
// thread)
#define RT_GOLDEN_PARAMS                                                      \
  int curv, int newton, int iso, int stats, void *const *in,                 \
      void *const *out, int n, int steps, const void *scal, int iters,       \
      int polish, float limx_i, float limx_s, float limy_i, float limy_s,    \
      float curv_tol, float cos_c0, float sin_c0, float cos_d0,              \
      float sin_d0, float cos_m, float sin_m, float l_final, void *next
#define RT_GOLDEN_ARGS                                                        \
  rt::golden_args(stats, in, out, n, steps, scal, iters, polish, limx_i,     \
                  limx_s, limy_i, limy_s, curv_tol, cos_c0, sin_c0, cos_d0,  \
                  sin_d0, cos_m, sin_m, l_final, next)
