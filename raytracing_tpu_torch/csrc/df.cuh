// The df32 step: op12 RK4 in double-word float32 (value = hi + lo) on the
// 8-plane state (xh, xl, yh, yl, uxh, uxl, uyh, uyl), its error-free
// transformations and its five media: the analytic fisheye and
// vert_heterogeneous angle rates (DfAnalytic) and the split-word tables of
// engine/df_grid.py (DfGrid, DfC1, DfProfile).  df.cu instantiates the loop
// run_df in the kernels df_step, df_step_grid, df_step_c1 and
// df_step_profile; what they replace, and what bounds them, is described at
// the top of df.cu.
//
// Every function here is __host__ __device__ (RT_HD) and includes no CUDA
// header, so the whole per-ray loop also compiles for the host with g++ and
// the CUDA qualifiers stubbed (-ffp-contract=off), and the CPU tests
// (tests/test_torch_df_host.py) hold it against the plain PyTorch version
// (raytracing_tpu_torch/kernels/df.py::df_step_plain) to the bit.
//
// Bit parity with the plain version and the error-free transformations
// themselves need: no contraction of a product into an add (-fmad=false on
// the card, -ffp-contract=off on the host: every two_sum, every Horner step
// and the cross terms of df_mul keep their separate roundings), no
// reassociation (no --use_fast_math), IEEE division for the reciprocal, the
// JAX package's order of every operation, float32 constants as JAX rounds
// its Python floats, and products with the constant 1/6 split as JAX folds
// them (in float64, where the split is exact: high word the constant
// itself, low word 0).
//
// Every fused operation is explicit.  The first is the error of an exact
// product, fmaf(a, b, -a * b) (two_prod).  The plain version computes that
// error with Dekker's split (17 operations); the card's FFMA rounds a * b -
// p once, and the error is a float32 number wherever the product neither
// overflows nor has an error below the smallest subnormal, so the two are
// the same bits there (tests/test_torch_df_host.py maps the domain: every
// |a|, |b| in [2^-50, 2^50] is inside it, and the df path's magnitudes,
// positions O(1), low words ~1e-8 and rates O(1-100), are far from its
// edges).  On the host, glibc's fmaf is correctly rounded like the card's.
//
// The second is the FMA form (template flag F, a medium's kFma: true for
// the analytic fields and the profile, false for the two grids).  Where F,
// each low-word sum of products is one fmaf in JAX's order of terms (the
// cross terms of df_mul, the residual of df_recip, the analytic rates' low
// words, the step's rx, ry, pe and the angle's low word): JAX's (p + a b)
// + c d becomes fmaf(c, d, fmaf(a, b, p)), and the plain version rounds it
// alike with utils/fma.py::fma32.  A product by a power of two is exact, so
// fusing it changes no bit; the kernel fuses it where it falls and the
// plain version keeps its two operations.  What F leaves in JAX's
// roundings: two_prod_const (JAX rounds a * b there, and an exact product
// would move the angle's low word by up to its own size) and the step's
// float32-only terms (the stage corrections, the small-angle polynomials,
// the rotation, the midpoints), whose rounding lands in the high word.
// Where F is false every expression is the JAX package's, term for term.
#pragma once

#include <math.h>
#include <stddef.h>

#ifndef RT_HD
#define RT_HD __host__ __device__ __forceinline__
#endif

namespace rt {
namespace df {

// the analytic fields, as kernels/df.py DF_FIELDS indexes them
enum DfField { DF_FISHEYE = 0, DF_VERT = 1 };

constexpr float kSplit = 4097.0f;  // 2^12 + 1, the Dekker split of float32
constexpr float kSixth = (float)(1.0 / 6.0);
constexpr float kTwelfth = (float)(1.0 / 12.0);
constexpr float kTwentieth = (float)0.05;
constexpr float kSixthHi = (float)(1.0 / 6.0);
constexpr float kSixthLo = (float)(1.0 / 6.0 - (double)(float)(1.0 / 6.0));

struct DF {
  float h, l;
};

// -- error-free transformations (raytracing_tpu/kernels/df.py:42-69) --------
RT_HD DF two_sum(float a, float b) {
  const float s = a + b;
  const float bv = s - a;
  return {s, (a - (s - bv)) + (b - bv)};
}

RT_HD DF fast_two_sum(float a, float b) {
  const float s = a + b;
  return {s, b - (s - a)};
}

RT_HD void split(float a, float& hi, float& lo) {
  const float c = a * kSplit;
  hi = c - (c - a);
  lo = a - hi;
}

// a * b = p + e exactly: one product and one fused multiply-add, the same
// bits as Dekker's split chain of the plain version (see the top)
RT_HD DF two_prod(float a, float b) {
  const float p = a * b;
  return {p, fmaf(a, b, -p)};
}

// two_prod with b a constant the JAX package splits in Python's float64:
// there its high word is b and its low word 0.0 (kernels/df.py
// two_prod_const).  Not exact: ah * b is a rounded float32 product, JAX's
// rounding, so it keeps Dekker's chain operation for operation.
RT_HD DF two_prod_const(float a, float b) {
  const float p = a * b;
  float ah, al;
  split(a, ah, al);
  return {p, (((ah * b - p) + ah * 0.0f) + al * b) + al * 0.0f};
}

RT_HD DF df_add_f(float xh, float xl, float y) {
  const DF s = two_sum(xh, y);
  return fast_two_sum(s.h, s.l + xl);
}

// (a + b), (a * b) for two df numbers (engine/df_grid.py:47-56)
RT_HD DF df_add(float ah, float al, float bh, float bl) {
  const DF s = two_sum(ah, bh);
  return fast_two_sum(s.h, (s.l + al) + bl);
}

template <bool F>
RT_HD DF df_mul(float ah, float al, float bh, float bl) {
  const DF p = two_prod(ah, bh);
  if constexpr (F) return fast_two_sum(p.h, fmaf(al, bh, fmaf(ah, bl, p.l)));
  return fast_two_sum(p.h, (p.l + ah * bl) + al * bh);
}

RT_HD DF df_add(DF a, DF b) { return df_add(a.h, a.l, b.h, b.l); }
template <bool F>
RT_HD DF df_mul(DF a, DF b) { return df_mul<F>(a.h, a.l, b.h, b.l); }

RT_HD float sin_poly(float d) {
  const float d2 = d * d;
  return d * (1.0f - d2 * kSixth * (1.0f - d2 * kTwentieth));
}

RT_HD float cosm1_poly(float d) {
  const float d2 = d * d;
  return -d2 * 0.5f * (1.0f - d2 * kTwelfth);
}

// turn the df tangent by the df angle (dh + dl) (df.py:82-100)
RT_HD void apply_rotation(float& uxh, float& uxl, float& uyh, float& uyl,
                          float dh, float dl) {
  const float dth = dh;
  const float dth2 = dth * dth;
  const float s_corr = -dth * dth2 * kSixth * (1.0f - dth2 * kTwentieth);
  const DF sh = df_add_f(dth, dl, s_corr);
  const float cm = cosm1_poly(dth) - dth * dl;
  const float s = sh.h + sh.l;
  const float dux = uxh * cm - uyh * s + uxl * cm - uyl * s;
  const float duy = uyh * cm + uxh * s + uyl * cm + uxl * s;
  const DF nx = df_add_f(uxh, uxl, dux);
  const DF ny = df_add_f(uyh, uyl, duy);
  uxh = nx.h;
  uxl = nx.l;
  uyh = ny.h;
  uyl = ny.l;
}

// 1/(dh + dl): one Newton refinement of the IEEE quotient (df.py:106-111)
template <bool F>
RT_HD DF df_recip(float dh, float dl) {
  const float n0 = 1.0f / dh;
  const DF t = two_prod(dh, n0);
  float resid;
  if constexpr (F) resid = fmaf(-dl, n0, (1.0f - t.h) - t.l);
  else resid = ((1.0f - t.h) - t.l) - dl * n0;
  return {n0, n0 * resid};
}

// -- the analytic angle rates (df.py:199-232) --------------------------------
// in the FMA form; kernels/df.py df_k_fisheye and df_k_vert with fused
template <int FIELD>
struct DfAnalytic {
  static constexpr bool kFma = true;

  RT_HD DF k(float pxh, float pxl, float pyh, float pyl, float vxh, float vxl,
             float vyh, float vyl) const {
    if (FIELD == DF_FISHEYE) {
      // k = -2 n (v_x y - v_y x), n = 1/(1 + r^2) Newton-refined
      const DF a = two_prod(vxh, pyh);
      const float al = a.l + fmaf(vxl, pyh, vxh * pyl);
      const DF b = two_prod(vyh, pxh);
      const float bl = b.l + fmaf(vyl, pxh, vyh * pxl);
      const DF c = two_sum(a.h, -b.h);
      const float cl = c.l + (al - bl);
      const DF xx = two_prod(pxh, pxh);
      const float xxl = fmaf(2.0f * pxh, pxl, xx.l);
      const DF yy = two_prod(pyh, pyh);
      const float yyl = fmaf(2.0f * pyh, pyl, yy.l);
      const DF s = two_sum(xx.h, yy.h);
      const DF d = two_sum(1.0f, s.h);
      const float dl = d.l + s.l + xxl + yyl;
      const DF n = df_recip<kFma>(d.h, dl);
      const DF kk = two_prod(-2.0f * n.h, c.h);
      return {kk.h, fmaf(-2.0f, fmaf(n.h, cl, n.l * c.h), kk.l)};
    } else {
      // vert_heterogeneous: n = 1/(18 + 2y), k = -2 n u_x
      const DF d = two_sum(18.0f, 2.0f * pyh);
      const float dl = fmaf(2.0f, pyl, d.l);
      const DF n = df_recip<kFma>(d.h, dl);
      const DF kk = two_prod(-2.0f * n.h, vxh);
      return {kk.h, fmaf(-2.0f, fmaf(n.h, vxl, n.l * vxh), kk.l)};
    }
  }
};

// -- the split-word tables (engine/df_grid.py:137-391) ----------------------
// df grid coordinate f = (p - origin) / h, clamped like FITPACK: the cell
// index i (float), the in-cell df offset (uh, ul); fl = 0 outside the grid
struct Coord {
  float i, uh, ul;
};

template <bool F>
RT_HD Coord cell_coord(float ph, float pl, float oh, float ol, float ihh,
                       float ihl, int n) {
  const DF t = df_add(ph, pl, -oh, -ol);
  const DF f = df_mul<F>(t.h, t.l, ihh, ihl);
  const float lim = (float)(n - 1);
  const bool out = (f.h < 0.0f) | (f.h > lim);
  const float fh = fminf(fmaxf(f.h, 0.0f), lim);
  const float fl = out ? 0.0f : f.l;
  const float i = fminf(floorf(fh), (float)(n - 2));
  // fh - i is exact (Sterbenz: fh in [i, i+1]); the lo word rides along
  return {i, fh - i, fl};
}

// W floats of a row: 16-byte loads through the read-only path on the card
template <int W>
RT_HD void load_row(const float* __restrict__ p, float* c) {
#ifdef __CUDA_ARCH__
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const float4 v = __ldg(q + j);
    c[4 * j] = v.x;
    c[4 * j + 1] = v.y;
    c[4 * j + 2] = v.z;
    c[4 * j + 3] = v.w;
  }
#else
  for (int j = 0; j < W; ++j) c[j] = p[j];
#endif
}

// cubic df Horner, sum c[k] u^k; c = (h0, l0, h1, l1, h2, l2, h3, l3)
template <bool F>
RT_HD DF horner4(const float* c, float uh, float ul) {
  DF r = {c[6], c[7]};
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    r = df_mul<F>(r.h, r.l, uh, ul);
    r = df_add(r.h, r.l, c[2 * k], c[2 * k + 1]);
  }
  return r;
}

// bicubic df Horner, sum C[a, b] v^a u^b, C row-major, 16 (hi, lo) pairs
RT_HD DF tensor_horner(const float* C, float uh, float ul, float vh,
                       float vl) {
  DF rows[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) rows[a] = horner4<false>(C + 8 * a, uh, ul);
  DF r = rows[3];
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    r = df_mul<false>(r.h, r.l, vh, vl);
    r = df_add(r, rows[a]);
  }
  return r;
}

// the bicubic of one 32-float block of a cell row
RT_HD DF cell_horner(const float* __restrict__ row, float uh, float ul,
                     float vh, float vl) {
  float c[32];
  load_row<32>(row, c);
  return tensor_horner(c, uh, ul, vh, vl);
}

// the rate (u x grad n)/n of a table medium's df (n, gx, gy) (:376-391)
template <bool F>
RT_HD DF rate(DF n, DF gx, DF gy, float vxh, float vxl, float vyh,
              float vyl) {
  const DF a = df_mul<F>(vxh, vxl, gy.h, gy.l);
  const DF b = df_mul<F>(vyh, vyl, gx.h, gx.l);
  const DF c = df_add(a.h, a.l, -b.h, -b.l);
  const DF r = df_recip<F>(n.h, n.l);
  return df_mul<F>(c, r);
}

// DfGridMedium: nodes (ny*nx, 2) = Z's (hi, lo) a node; cells (ncells, 64) =
// cx's 16 (hi, lo) pairs, then cy's (df_grid.py:183-224)
struct DfGrid {
  static constexpr bool kFma = false;

  const float* __restrict__ nodes;
  const float* __restrict__ cells;
  float x0h, x0l, y0h, y0l, ihxh, ihxl, ihyh, ihyl;
  int nx, ny;

  RT_HD DF node(int i) const {
#ifdef __CUDA_ARCH__
    const float2 v = __ldg(reinterpret_cast<const float2*>(nodes) + i);
    return {v.x, v.y};
#else
    return {nodes[2 * i], nodes[2 * i + 1]};
#endif
  }

  RT_HD DF k(float pxh, float pxl, float pyh, float pyl, float vxh, float vxl,
             float vyh, float vyl) const {
    const Coord cx = cell_coord<kFma>(pxh, pxl, x0h, x0l, ihxh, ihxl, nx);
    const Coord cy = cell_coord<kFma>(pyh, pyl, y0h, y0l, ihyh, ihyl, ny);
    const int ixi = (int)cx.i;
    const int iyi = (int)cy.i;
    const int flat = iyi * nx + ixi;
    const DF z00 = node(flat), z01 = node(flat + 1);
    const DF z10 = node(flat + nx), z11 = node(flat + nx + 1);
    // bilinear in df: (1-v)((1-u) z00 + u z01) + v((1-u) z10 + u z11)
    const DF u = {cx.uh, cx.ul}, v = {cy.uh, cy.ul};
    const DF cu = df_add(1.0f, 0.0f, -cx.uh, -cx.ul);
    const DF cv = df_add(1.0f, 0.0f, -cy.uh, -cy.ul);
    const DF lo = df_add(df_mul<kFma>(cu, z00), df_mul<kFma>(u, z01));
    const DF hi = df_add(df_mul<kFma>(cu, z10), df_mul<kFma>(u, z11));
    const DF n = df_add(df_mul<kFma>(cv, lo), df_mul<kFma>(v, hi));
    const float* row = cells + (size_t)(iyi * (nx - 1) + ixi) * 64;
    const DF gx = cell_horner(row, cx.uh, cx.ul, cy.uh, cy.ul);
    const DF gy = cell_horner(row + 32, cx.uh, cx.ul, cy.uh, cy.ul);
    return rate<kFma>(n, gx, gy, vxh, vxl, vyh, vyl);
  }
};

// DfC1Medium: cells (ncells, 96) = C, Cu, Cv, each 16 (hi, lo) pairs
// (df_grid.py:299-316)
struct DfC1 {
  static constexpr bool kFma = false;

  const float* __restrict__ cells;
  float x0h, x0l, y0h, y0l, ihxh, ihxl, ihyh, ihyl;
  int nx, ny;

  RT_HD DF k(float pxh, float pxl, float pyh, float pyl, float vxh, float vxl,
             float vyh, float vyl) const {
    const Coord cx = cell_coord<kFma>(pxh, pxl, x0h, x0l, ihxh, ihxl, nx);
    const Coord cy = cell_coord<kFma>(pyh, pyl, y0h, y0l, ihyh, ihyl, ny);
    const float* row =
        cells + (size_t)((int)cy.i * (nx - 1) + (int)cx.i) * 96;
    const DF n = cell_horner(row, cx.uh, cx.ul, cy.uh, cy.ul);
    const DF gx = cell_horner(row + 32, cx.uh, cx.ul, cy.uh, cy.ul);
    const DF gy = cell_horner(row + 64, cx.uh, cx.ul, cy.uh, cy.ul);
    return rate<kFma>(n, gx, gy, vxh, vxl, vyh, vyl);
  }
};

// DfC1Profile: cells (ny-1, 16) = C's 4 (hi, lo) pairs, then Cv's; gx = 0
// (df_grid.py:361-373); in the FMA form
struct DfProfile {
  static constexpr bool kFma = true;

  const float* __restrict__ cells;
  float y0h, y0l, ihyh, ihyl;
  int ny;

  RT_HD DF k(float pxh, float pxl, float pyh, float pyl, float vxh, float vxl,
             float vyh, float vyl) const {
    const Coord cy = cell_coord<kFma>(pyh, pyl, y0h, y0l, ihyh, ihyl, ny);
    float c[16];
    load_row<16>(cells + (size_t)(int)cy.i * 16, c);
    const DF n = horner4<kFma>(c, cy.uh, cy.ul);
    const DF gy = horner4<kFma>(c + 8, cy.uh, cy.ul);
    const DF zero = {0.0f, 0.0f};
    return rate<kFma>(n, zero, gy, vxh, vxl, vyh, vyl);
  }
};

// -- the step (df.py:114-186) ------------------------------------------------
// in the FMA form where F (the medium's kFma)
template <bool F, class Medium>
RT_HD void rk4_step(const Medium& m, float ds, float h2, float h6, float* s) {
  const float xh = s[0], xl = s[1], yh = s[2], yl = s[3];
  const float uxh = s[4], uxl = s[5], uyh = s[6], uyl = s[7];
  const float ux = uxh, uy = uyh;
  // the stage tangent's correction, and the df midpoint position
  auto corr = [&](float a, float& cx, float& cy) {
    const float sn = sin_poly(a), cm = cosm1_poly(a);
    cx = ux * cm - uy * sn;
    cy = uy * cm + ux * sn;
  };
  auto midpoint = [&](float hc, float vx, float vy, float* mp) {
    const DF px = two_prod(hc, vx);
    const DF py = two_prod(hc, vy);
    const DF mx = df_add_f(xh, xl + px.l, px.h);
    const DF my = df_add_f(yh, yl + py.l, py.h);
    mp[0] = mx.h;
    mp[1] = mx.l;
    mp[2] = my.h;
    mp[3] = my.l;
  };
  float mp[4], c1x, c1y, c2x, c2y, c3x, c3y;
  const DF k1 = m.k(xh, xl, yh, yl, uxh, uxl, uyh, uyl);
  corr(h2 * (k1.h + k1.l), c1x, c1y);
  midpoint(h2, ux, uy, mp);
  const DF k2 = m.k(mp[0], mp[1], mp[2], mp[3], uxh, uxl + c1x, uyh,
                    uyl + c1y);
  corr(h2 * (k2.h + k2.l), c2x, c2y);
  midpoint(h2, ux + c1x, uy + c1y, mp);
  const DF k3 = m.k(mp[0], mp[1], mp[2], mp[3], uxh, uxl + c2x, uyh,
                    uyl + c2y);
  corr(ds * (k3.h + k3.l), c3x, c3y);
  midpoint(ds, ux + c2x, uy + c2y, mp);
  const DF k4 = m.k(mp[0], mp[1], mp[2], mp[3], uxh, uxl + c3x, uyh,
                    uyl + c3y);

  // position: h u + h/6 (2 c1 + 2 c2 + c3), df-accumulated
  const DF px = two_prod(ds, uxh);
  const DF py = two_prod(ds, uyh);
  float rx, ry;
  if constexpr (F) {
    rx = fmaf(ds, uxl, h6 * (fmaf(2.0f, c2x, 2.0f * c1x) + c3x)) + px.l;
    ry = fmaf(ds, uyl, h6 * (fmaf(2.0f, c2y, 2.0f * c1y) + c3y)) + py.l;
  } else {
    rx = h6 * (2.0f * c1x + 2.0f * c2x + c3x) + ds * uxl + px.l;
    ry = h6 * (2.0f * c1y + 2.0f * c2y + c3y) + ds * uyl + py.l;
  }
  const DF nx = df_add_f(xh, xl + rx, px.h);
  const DF ny = df_add_f(yh, yl + ry, py.h);

  // dth = ds (k1 + 2 k2 + 2 k3 + k4) / 6, all in df
  const DF ks = two_sum(k1.h, k4.h);
  const DF ks2 = two_sum(2.0f * k2.h, 2.0f * k3.h);
  const DF ksum = two_sum(ks.h, ks2.h);
  DF dth;
  if constexpr (F) {
    const float ksum_l = ksum.l + ks.l + ks2.l +
                         (fmaf(2.0f, k3.l, fmaf(2.0f, k2.l, k1.l)) + k4.l);
    const DF p = two_prod(ds, ksum.h);
    const float pe = fmaf(ds, ksum_l, p.l);
    const DF a = two_prod_const(p.h, kSixthHi);
    dth = fast_two_sum(a.h, fmaf(pe, kSixthHi, fmaf(p.h, kSixthLo, a.l)));
  } else {
    const float ksum_l = ksum.l + ks.l + ks2.l +
                         (k1.l + 2.0f * k2.l + 2.0f * k3.l + k4.l);
    const DF p = two_prod(ds, ksum.h);
    const float pe = p.l + ds * ksum_l;
    const DF a = two_prod_const(p.h, kSixthHi);
    dth = fast_two_sum(a.h, a.l + p.h * kSixthLo + pe * kSixthHi);
  }
  float nuxh = uxh, nuxl = uxl, nuyh = uyh, nuyl = uyl;
  apply_rotation(nuxh, nuxl, nuyh, nuyl, dth.h, dth.l);
  s[0] = nx.h;
  s[1] = nx.l;
  s[2] = ny.h;
  s[3] = ny.l;
  s[4] = nuxh;
  s[5] = nuxl;
  s[6] = nuyh;
  s[7] = nuyl;
}

// ``steps`` df RK4 steps of one ray's 8-plane state ``s``, in place
template <class Medium, bool F = Medium::kFma>
RT_HD void run_df(const Medium& m, float ds, int steps, float* s) {
  const float h2 = ds * 0.5f;
  const float h6 = ds * kSixth;
  for (int i = 0; i < steps; ++i) rk4_step<F>(m, ds, h2, h6, s);
}

}  // namespace df
}  // namespace rt
