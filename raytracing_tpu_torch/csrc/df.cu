// df_step, df_step_grid, df_step_c1 and df_step_profile: the df32 tier,
// op12 RK4 in double-word float32 (value = hi + lo), one step loop
// instantiated on five media.
//
// Replaces raytracing_tpu/kernels/df.py::_df_rk4_kernel in both its forms,
// launched at df.py:275 (_df_core: the launch state in, four position
// planes out) and df.py:314 (_df_core_segmented: the full 8-plane state in
// and out), as one kernel that always reads and writes the 8-plane state
// (xh, xl, yh, yl, uxh, uxl, uyh, uyl): a chain of launches equals one
// launch to the bit.  The same loop also runs the JAX package's jnp-level
// tracer of the split-word sampled media, engine/df_grid.py::
// _df_grid_segment (df_grid.py:394), on its three evaluators:
// * df_step: the analytic fisheye and vert_heterogeneous angle rates
//   (df.py:199-232), rows 9 and 10 of the kernel table in PERF.md;
// * df_step_grid: DfGridMedium, bilinear n from the Z nodes and bicubic
//   cx/cy cells (df_grid.py:183 _make_df_nag), row 9g;
// * df_step_c1: DfC1Medium, three tensor Horners of one spline
//   (df_grid.py:299 _make_df_c1_nag), row 9c;
// * df_step_profile: DfC1Profile, two cubic Horners of a 1-D spline
//   (df_grid.py:361 _make_df_profile_nag), row 9p;
// the table media share the rate (u x grad n)/n of _make_df_k (:376-391).
//
// One thread per ray; the eight state planes live in registers for every
// step and are read and written once a launch (64 bytes a ray).  A step is
// ~800 FP32 operations on the analytic fields and ~4,000-6,000 on the
// tables (four angle-rate evaluations, each a few dozen error-free
// products), against one table row an evaluation (64-384 bytes, read
// through L1/L2), so the kernel is bound by FP32 issue.  The TPU's Mosaic
// compile bound that made JAX chain 512-step segments does not apply:
// segments here serve resume only.  The tables are read as each ray's own
// cell row of the whole table, hi and lo words interleaved a coefficient
// (engine/df_grid.py kernel_tables), in 16-byte loads.
//
// Bit parity with the plain version (kernels/df.py::df_step_plain) and the
// error-free transformations themselves need: -fmad=false (Dekker's
// two_prod and every two_sum are exact only if no product is fused into an
// add; kernels/build.py), no reassociation (no --use_fast_math), IEEE
// division for the reciprocal, the JAX package's order of every operation,
// float32 constants as JAX rounds its Python floats, and products with the
// constant 1/6 split as JAX folds them (in float64, where the split is
// exact: high word the constant itself, low word 0).
#include "media.cuh"

namespace rt {
namespace df {

constexpr float kSplit = 4097.0f;  // 2^12 + 1, the Dekker split of float32
constexpr float kTwentieth = (float)0.05;
constexpr float kSixthHi = (float)(1.0 / 6.0);
constexpr float kSixthLo = (float)(1.0 / 6.0 - (double)(float)(1.0 / 6.0));

struct DF {
  float h, l;
};

// -- error-free transformations (raytracing_tpu/kernels/df.py:42-69) --------
__device__ __forceinline__ DF two_sum(float a, float b) {
  const float s = a + b;
  const float bv = s - a;
  return {s, (a - (s - bv)) + (b - bv)};
}

__device__ __forceinline__ DF fast_two_sum(float a, float b) {
  const float s = a + b;
  return {s, b - (s - a)};
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = a * kSplit;
  hi = c - (c - a);
  lo = a - hi;
}

__device__ __forceinline__ DF two_prod(float a, float b) {
  const float p = a * b;
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  return {p, (((ah * bh - p) + ah * bl) + al * bh) + al * bl};
}

// two_prod with b a constant the JAX package splits in Python's float64:
// there its high word is b and its low word 0.0 (kernels/df.py
// two_prod_const)
__device__ __forceinline__ DF two_prod_const(float a, float b) {
  const float p = a * b;
  float ah, al;
  split(a, ah, al);
  return {p, (((ah * b - p) + ah * 0.0f) + al * b) + al * 0.0f};
}

__device__ __forceinline__ DF df_add_f(float xh, float xl, float y) {
  const DF s = two_sum(xh, y);
  return fast_two_sum(s.h, s.l + xl);
}

// (a + b), (a * b) for two df numbers (engine/df_grid.py:47-56)
__device__ __forceinline__ DF df_add(float ah, float al, float bh, float bl) {
  const DF s = two_sum(ah, bh);
  return fast_two_sum(s.h, (s.l + al) + bl);
}

__device__ __forceinline__ DF df_mul(float ah, float al, float bh, float bl) {
  const DF p = two_prod(ah, bh);
  return fast_two_sum(p.h, (p.l + ah * bl) + al * bh);
}

__device__ __forceinline__ DF df_add(DF a, DF b) {
  return df_add(a.h, a.l, b.h, b.l);
}
__device__ __forceinline__ DF df_mul(DF a, DF b) {
  return df_mul(a.h, a.l, b.h, b.l);
}

__device__ __forceinline__ float sin_poly(float d) {
  const float d2 = d * d;
  return d * (1.0f - d2 * kSixth * (1.0f - d2 * kTwentieth));
}

__device__ __forceinline__ float cosm1_poly(float d) {
  const float d2 = d * d;
  return -d2 * 0.5f * (1.0f - d2 * kTwelfth);
}

// turn the df tangent by the df angle (dh + dl) (df.py:82-100)
__device__ __forceinline__ void apply_rotation(float& uxh, float& uxl,
                                               float& uyh, float& uyl,
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
__device__ __forceinline__ DF df_recip(float dh, float dl) {
  const float n0 = 1.0f / dh;
  const DF t = two_prod(dh, n0);
  const float resid = ((1.0f - t.h) - t.l) - dl * n0;
  return {n0, n0 * resid};
}

// -- the analytic angle rates (df.py:199-232) --------------------------------
template <int FIELD>
struct DfAnalytic {
  __device__ __forceinline__ DF k(float pxh, float pxl, float pyh, float pyl,
                                  float vxh, float vxl, float vyh,
                                  float vyl) const {
    if (FIELD == FISHEYE) {
      // k = -2 n (v_x y - v_y x), n = 1/(1 + r^2) Newton-refined
      const DF a = two_prod(vxh, pyh);
      const float al = a.l + (vxh * pyl + vxl * pyh);
      const DF b = two_prod(vyh, pxh);
      const float bl = b.l + (vyh * pxl + vyl * pxh);
      const DF c = two_sum(a.h, -b.h);
      const float cl = c.l + (al - bl);
      const DF xx = two_prod(pxh, pxh);
      const float xxl = xx.l + 2.0f * pxh * pxl;
      const DF yy = two_prod(pyh, pyh);
      const float yyl = yy.l + 2.0f * pyh * pyl;
      const DF s = two_sum(xx.h, yy.h);
      const DF d = two_sum(1.0f, s.h);
      const float dl = d.l + s.l + xxl + yyl;
      const DF n = df_recip(d.h, dl);
      const DF kk = two_prod(-2.0f * n.h, c.h);
      return {kk.h, kk.l + (-2.0f) * (n.l * c.h + n.h * cl)};
    } else {
      // vert_heterogeneous: n = 1/(18 + 2y), k = -2 n u_x
      const DF d = two_sum(18.0f, 2.0f * pyh);
      const float dl = d.l + 2.0f * pyl;
      const DF n = df_recip(d.h, dl);
      const DF kk = two_prod(-2.0f * n.h, vxh);
      return {kk.h, kk.l + (-2.0f) * (n.l * vxh + n.h * vxl)};
    }
  }
};

// -- the split-word tables (engine/df_grid.py:137-391) ----------------------
// df grid coordinate f = (p - origin) / h, clamped like FITPACK: the cell
// index i (float), the in-cell df offset (uh, ul); fl = 0 outside the grid
struct Coord {
  float i, uh, ul;
};

__device__ __forceinline__ Coord cell_coord(float ph, float pl, float oh,
                                            float ol, float ihh, float ihl,
                                            int n) {
  const DF t = df_add(ph, pl, -oh, -ol);
  const DF f = df_mul(t.h, t.l, ihh, ihl);
  const float lim = (float)(n - 1);
  const bool out = (f.h < 0.0f) | (f.h > lim);
  const float fh = fminf(fmaxf(f.h, 0.0f), lim);
  const float fl = out ? 0.0f : f.l;
  const float i = fminf(floorf(fh), (float)(n - 2));
  // fh - i is exact (Sterbenz: fh in [i, i+1]); the lo word rides along
  return {i, fh - i, fl};
}

// W floats of a row, in 16-byte loads through the read-only path
template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float* c) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const float4 v = __ldg(q + j);
    c[4 * j] = v.x;
    c[4 * j + 1] = v.y;
    c[4 * j + 2] = v.z;
    c[4 * j + 3] = v.w;
  }
}

// cubic df Horner, sum c[k] u^k; c = (h0, l0, h1, l1, h2, l2, h3, l3)
__device__ __forceinline__ DF horner4(const float* c, float uh, float ul) {
  DF r = {c[6], c[7]};
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    r = df_mul(r.h, r.l, uh, ul);
    r = df_add(r.h, r.l, c[2 * k], c[2 * k + 1]);
  }
  return r;
}

// bicubic df Horner, sum C[a, b] v^a u^b, C row-major, 16 (hi, lo) pairs
__device__ __forceinline__ DF tensor_horner(const float* C, float uh,
                                            float ul, float vh, float vl) {
  DF rows[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) rows[a] = horner4(C + 8 * a, uh, ul);
  DF r = rows[3];
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    r = df_mul(r.h, r.l, vh, vl);
    r = df_add(r, rows[a]);
  }
  return r;
}

// the bicubic of one 32-float block of a cell row
__device__ __forceinline__ DF cell_horner(const float* __restrict__ row,
                                          float uh, float ul, float vh,
                                          float vl) {
  float c[32];
  load_row<32>(row, c);
  return tensor_horner(c, uh, ul, vh, vl);
}

// the rate (u x grad n)/n of a table medium's df (n, gx, gy) (:376-391)
__device__ __forceinline__ DF rate(DF n, DF gx, DF gy, float vxh, float vxl,
                                   float vyh, float vyl) {
  const DF a = df_mul(vxh, vxl, gy.h, gy.l);
  const DF b = df_mul(vyh, vyl, gx.h, gx.l);
  const DF c = df_add(a.h, a.l, -b.h, -b.l);
  const DF r = df_recip(n.h, n.l);
  return df_mul(c, r);
}

// DfGridMedium: nodes (ny*nx, 2) = Z's (hi, lo) a node; cells (ncells, 64) =
// cx's 16 (hi, lo) pairs, then cy's (df_grid.py:183-224)
struct DfGrid {
  const float* __restrict__ nodes;
  const float* __restrict__ cells;
  float x0h, x0l, y0h, y0l, ihxh, ihxl, ihyh, ihyl;
  int nx, ny;

  __device__ __forceinline__ DF node(int i) const {
    const float2 v = __ldg(reinterpret_cast<const float2*>(nodes) + i);
    return {v.x, v.y};
  }

  __device__ __forceinline__ DF k(float pxh, float pxl, float pyh, float pyl,
                                  float vxh, float vxl, float vyh,
                                  float vyl) const {
    const Coord cx = cell_coord(pxh, pxl, x0h, x0l, ihxh, ihxl, nx);
    const Coord cy = cell_coord(pyh, pyl, y0h, y0l, ihyh, ihyl, ny);
    const int ixi = (int)cx.i;
    const int iyi = (int)cy.i;
    const int flat = iyi * nx + ixi;
    const DF z00 = node(flat), z01 = node(flat + 1);
    const DF z10 = node(flat + nx), z11 = node(flat + nx + 1);
    // bilinear in df: (1-v)((1-u) z00 + u z01) + v((1-u) z10 + u z11)
    const DF u = {cx.uh, cx.ul}, v = {cy.uh, cy.ul};
    const DF cu = df_add(1.0f, 0.0f, -cx.uh, -cx.ul);
    const DF cv = df_add(1.0f, 0.0f, -cy.uh, -cy.ul);
    const DF lo = df_add(df_mul(cu, z00), df_mul(u, z01));
    const DF hi = df_add(df_mul(cu, z10), df_mul(u, z11));
    const DF n = df_add(df_mul(cv, lo), df_mul(v, hi));
    const float* row = cells + (size_t)(iyi * (nx - 1) + ixi) * 64;
    const DF gx = cell_horner(row, cx.uh, cx.ul, cy.uh, cy.ul);
    const DF gy = cell_horner(row + 32, cx.uh, cx.ul, cy.uh, cy.ul);
    return rate(n, gx, gy, vxh, vxl, vyh, vyl);
  }
};

// DfC1Medium: cells (ncells, 96) = C, Cu, Cv, each 16 (hi, lo) pairs
// (df_grid.py:299-316)
struct DfC1 {
  const float* __restrict__ cells;
  float x0h, x0l, y0h, y0l, ihxh, ihxl, ihyh, ihyl;
  int nx, ny;

  __device__ __forceinline__ DF k(float pxh, float pxl, float pyh, float pyl,
                                  float vxh, float vxl, float vyh,
                                  float vyl) const {
    const Coord cx = cell_coord(pxh, pxl, x0h, x0l, ihxh, ihxl, nx);
    const Coord cy = cell_coord(pyh, pyl, y0h, y0l, ihyh, ihyl, ny);
    const float* row =
        cells + (size_t)((int)cy.i * (nx - 1) + (int)cx.i) * 96;
    const DF n = cell_horner(row, cx.uh, cx.ul, cy.uh, cy.ul);
    const DF gx = cell_horner(row + 32, cx.uh, cx.ul, cy.uh, cy.ul);
    const DF gy = cell_horner(row + 64, cx.uh, cx.ul, cy.uh, cy.ul);
    return rate(n, gx, gy, vxh, vxl, vyh, vyl);
  }
};

// DfC1Profile: cells (ny-1, 16) = C's 4 (hi, lo) pairs, then Cv's; gx = 0
// (df_grid.py:361-373)
struct DfProfile {
  const float* __restrict__ cells;
  float y0h, y0l, ihyh, ihyl;
  int ny;

  __device__ __forceinline__ DF k(float pxh, float pxl, float pyh, float pyl,
                                  float vxh, float vxl, float vyh,
                                  float vyl) const {
    const Coord cy = cell_coord(pyh, pyl, y0h, y0l, ihyh, ihyl, ny);
    float c[16];
    load_row<16>(cells + (size_t)(int)cy.i * 16, c);
    const DF n = horner4(c, cy.uh, cy.ul);
    const DF gy = horner4(c + 8, cy.uh, cy.ul);
    const DF zero = {0.0f, 0.0f};
    return rate(n, zero, gy, vxh, vxl, vyh, vyl);
  }
};

// -- the step (df.py:114-186) -------------------------------------------------
struct DfArgs {
  const float* in[8];
  float* out[8];
  int n, steps;
  float ds;
};

template <class Medium>
__device__ __forceinline__ void rk4_step(const Medium& m, float ds, float h2,
                                         float h6, float* s) {
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
  const float rx = h6 * (2.0f * c1x + 2.0f * c2x + c3x) + ds * uxl + px.l;
  const float ry = h6 * (2.0f * c1y + 2.0f * c2y + c3y) + ds * uyl + py.l;
  const DF nx = df_add_f(xh, xl + rx, px.h);
  const DF ny = df_add_f(yh, yl + ry, py.h);

  // dth = ds (k1 + 2 k2 + 2 k3 + k4) / 6, all in df
  const DF ks = two_sum(k1.h, k4.h);
  const DF ks2 = two_sum(2.0f * k2.h, 2.0f * k3.h);
  const DF ksum = two_sum(ks.h, ks2.h);
  const float ksum_l = ksum.l + ks.l + ks2.l +
                       (k1.l + 2.0f * k2.l + 2.0f * k3.l + k4.l);
  const DF p = two_prod(ds, ksum.h);
  const float pe = p.l + ds * ksum_l;
  const DF a = two_prod_const(p.h, kSixthHi);
  const DF dth = fast_two_sum(a.h, a.l + p.h * kSixthLo + pe * kSixthHi);
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

template <class Medium>
__global__ void __launch_bounds__(kThreads) df_kernel(DfArgs a, Medium m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = a.in[j][r];
  const float ds = a.ds;
  const float h2 = ds * 0.5f;
  const float h6 = ds * kSixth;
  for (int i = 0; i < a.steps; ++i) rk4_step(m, ds, h2, h6, s);
#pragma unroll
  for (int j = 0; j < 8; ++j) a.out[j][r] = s[j];
}

template <class Medium>
static int launch(const DfArgs& a, const Medium& m, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  df_kernel<Medium><<<blocks, kThreads, 0, stream>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

static DfArgs args(void* const* in, void* const* out, int n, int steps,
                   float ds) {
  DfArgs a;
  for (int j = 0; j < 8; ++j) {
    a.in[j] = static_cast<const float*>(in[j]);
    a.out[j] = static_cast<float*>(out[j]);
  }
  a.n = n;
  a.steps = steps;
  a.ds = ds;
  return a;
}

}  // namespace df
}  // namespace rt

#define RT_DF_PARAMS \
  void *const *in, void *const *out, int n, int steps, float ds
#define RT_DF_GEOMETRY                                                      \
  float x0h, float x0l, float y0h, float y0l, float ihxh, float ihxl,       \
      float ihyh, float ihyl, int nx, int ny

// df_step: field 0 = fisheye, 1 = vert_heterogeneous (kernels/df.py
// DF_FIELDS); rows 9 and 10
extern "C" int rt_df_step(int field, RT_DF_PARAMS, void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfArgs a = rt::df::args(in, out, n, steps, ds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field) {
    case 0:
      return rt::df::launch(a, rt::df::DfAnalytic<rt::FISHEYE>{}, s);
    case 1:
      return rt::df::launch(a, rt::df::DfAnalytic<rt::VERT>{}, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// df_step_grid: DfGridMedium's packed node and cell tables; row 9g
extern "C" int rt_df_step_grid(RT_DF_PARAMS, const void* nodes,
                               const void* cells, RT_DF_GEOMETRY,
                               void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfGrid m{static_cast<const float*>(nodes),
                         static_cast<const float*>(cells),
                         x0h, x0l, y0h, y0l, ihxh, ihxl, ihyh, ihyl, nx, ny};
  return rt::df::launch(rt::df::args(in, out, n, steps, ds), m,
                        static_cast<cudaStream_t>(stream));
}

// df_step_c1: DfC1Medium's packed cell table; row 9c
extern "C" int rt_df_step_c1(RT_DF_PARAMS, const void* cells, RT_DF_GEOMETRY,
                             void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfC1 m{static_cast<const float*>(cells), x0h, x0l, y0h, y0l,
                       ihxh, ihxl, ihyh, ihyl, nx, ny};
  return rt::df::launch(rt::df::args(in, out, n, steps, ds), m,
                        static_cast<cudaStream_t>(stream));
}

// df_step_profile: DfC1Profile's packed cell table; row 9p
extern "C" int rt_df_step_profile(RT_DF_PARAMS, const void* cells, float y0h,
                                  float y0l, float ihyh, float ihyl, int ny,
                                  void* stream) {
  if (n <= 0) return 0;
  const rt::df::DfProfile m{static_cast<const float*>(cells), y0h, y0l, ihyh,
                            ihyl, ny};
  return rt::df::launch(rt::df::args(in, out, n, steps, ds), m,
                        static_cast<cudaStream_t>(stream));
}
