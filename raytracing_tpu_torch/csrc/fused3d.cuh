// The fused 3-D step loop for op1/op2/op6/op8, templated on the medium and
// the op, and its two media: the analytic 3-D fields (Analytic3<FIELD>) and
// a C1Grid3Medium's per-cell table (Grid3).  fused3d.cu instantiates it in
// the kernels fused3d_step and fused3d_step_grid; what they compute, and
// what bounds them, is described at the top of fused3d.cu.  Each medium
// also has nag_h, n with its gradient and Hessian, which the 3-D dynamic
// loop (dynamic3d.cuh) reads.
//
// Every function here is __host__ __device__ (RT_HD) and includes no CUDA
// header (common.cuh includes one only under nvcc), so the whole per-ray
// loop (run3) also compiles for the host with g++ and the CUDA qualifiers
// stubbed (-ffp-contract=off), and the CPU tests hold it against the plain
// PyTorch version (raytracing_tpu_torch/kernels/fused3d.py::
// fused3d_step_plain) to the bit.
//
// Every expression keeps the order of operations of JAX's _step_body3
// (raytracing_tpu/kernels/fused3d.py:93-188) and of the plain version: the
// Python constants 1/6, 0.05, 1/12 and 1/30 of _rot_coeffs round to float32
// as JAX folds them; (ds * ds) * 0.5 and ds * 0.5 are float32 products; the
// impulse normalizes by 1 / sqrtf (IEEE square root, one rounded division)
// where JAX writes lax.rsqrt.  Built with -fmad=false, so nothing contracts
// into an FMA by itself; the Kahan lines use __fadd_rn/__fsub_rn on the
// card.  On the analytic fields the step fuses each product that feeds a
// sum into it by an explicit fmaf (Fma3), and the plain version rounds the
// same fused operations with utils/fma.py::fma32.
#pragma once

#include <math.h>

#include "common.cuh"

#ifdef __CUDA_ARCH__
#define RT3_ADD(a, b) __fadd_rn(a, b)
#define RT3_SUB(a, b) __fsub_rn(a, b)
#else
#define RT3_ADD(a, b) ((a) + (b))
#define RT3_SUB(a, b) ((a) - (b))
#endif

namespace rt3 {

// -- analytic 3-D fields (fused3d.py::_field3_fn, :45-65) -------------------
// the codes of rt::Field (media.cuh) and kernels/fused.py FIELD_CODES
enum Field3 { FISHEYE3 = 0, VERT3 = 1, INTERFACE3 = 2 };

constexpr float kSqrt2 = (float)1.4142135623730951;
constexpr float kSqrt2m1 = (float)(1.4142135623730951 - 1.0);
constexpr float kThck = (float)0.005;   // config.THCK_PARAM
constexpr float kThck2 = (float)(0.005 * 0.005);

// n, grad n and the symmetric Hessian at one point: what nag_h gives the
// dynamic loop (raytracing_tpu/kernels/dynamic3d.py's eval_h contract)
struct H3 {
  float n, gx, gy, gz, hxx, hxy, hxz, hyy, hyz, hzz;
};

template <int FIELD>
struct Analytic3 {
  // n and grad n.  FAST: the reciprocal by its fast path (the fisheye's
  // and the interface's denominators are at least 1, vert's by rcp_fast),
  // its guard ANDed into ok; else the IEEE division.  Both give the same
  // bits where ok holds.
  template <bool FAST>
  RT_HD void field(float x, float y, float z, float& n, float& gx, float& gy,
                   float& gz, bool& ok) const {
    if (FIELD == FISHEYE3) {
      const float d = 1.0f + x * x + y * y + z * z;
      n = FAST ? rt::rcp_fast_ge1(d, ok) : 1.0f / d;
      const float c = -2.0f * n * n;
      gx = c * x;
      gy = c * y;
      gz = c * z;
    } else if (FIELD == VERT3) {
      const float d = 18.0f + 2.0f * y;
      n = FAST ? rt::rcp_fast(d, ok) : 1.0f / d;
      gx = 0.0f;
      gy = -2.0f * n * n;
      gz = 0.0f;
    } else {
      // the literal logistic of the TPU kernel (fused3d.py:60): expf
      // overflows to inf below y ~ -0.44, where 1 / (1 + inf) is +0; an
      // infinite e takes 1 / 1 and selects +0 instead, the same bits
      // without the reciprocal's slow path (media.cuh Analytic::field)
      const float e = expf(-y / kThck);
      const bool big = e == INFINITY;
      const float d = big ? 1.0f : 1.0f + e;
      const float q = FAST ? rt::rcp_fast_ge1(d, ok) : 1.0f / d;
      const float sig = big ? 0.0f : q;
      n = kSqrt2 - kSqrt2m1 * sig;
      gx = 0.0f;
      gy = -kSqrt2m1 * sig * (1.0f - sig) / kThck;
      gz = 0.0f;
    }
  }

  // closed-form Hessians (kernels/dynamic3d.py::_field3_fn_h, :76-111);
  // the interface's logistic is the overflow-safe two-branch form of
  // media/fields.py::_sigmoid, both branches exponentiating -|t|
  RT_HD void nag_h(float x, float y, float z, H3& h) const {
    h.gx = h.gz = h.hxx = h.hxy = h.hxz = h.hyz = h.hzz = 0.0f;
    if (FIELD == FISHEYE3) {
      const float n = 1.0f / (1.0f + x * x + y * y + z * z);
      const float n2 = n * n;
      const float c = -2.0f * n2;
      const float n3_8 = 8.0f * n2 * n;
      h.n = n;
      h.gx = c * x;
      h.gy = c * y;
      h.gz = c * z;
      h.hxx = c + n3_8 * x * x;
      h.hxy = n3_8 * x * y;
      h.hxz = n3_8 * x * z;
      h.hyy = c + n3_8 * y * y;
      h.hyz = n3_8 * y * z;
      h.hzz = c + n3_8 * z * z;
    } else if (FIELD == VERT3) {
      const float n = 1.0f / (18.0f + 2.0f * y);
      const float n2 = n * n;
      h.n = n;
      h.gy = -2.0f * n2;
      h.hyy = 8.0f * n2 * n;
    } else {
      const float t = y / kThck;
      const bool pos = t >= 0.0f;
      const float e = expf(pos ? -t : t);
      const float sig = pos ? 1.0f / (1.0f + e) : e / (1.0f + e);
      const float d = sig * (1.0f - sig);
      h.n = kSqrt2 - kSqrt2m1 * sig;
      h.gy = -kSqrt2m1 * d / kThck;
      h.hyy = -kSqrt2m1 * d * (1.0f - 2.0f * sig) / kThck2;
    }
  }
};

// -- the tri-Hermite per-cell table (fused3d.py::_tile_nag3, :223-262) -------
// Hermite basis (h00, h10, h01, h11) at t and its derivative
// (media/hermite.py::hermite_basis, media/c1.py::hermite_dbasis)
struct Basis3 {
  float h0, g0, h1, g1;
};
RT_HD Basis3 hermite_basis3(float t) {
  const float t2 = t * t;
  const float t3 = t2 * t;
  return {2.0f * t3 - 3.0f * t2 + 1.0f, t3 - 2.0f * t2 + t,
          -2.0f * t3 + 3.0f * t2, t3 - t2};
}
RT_HD Basis3 hermite_dbasis3(float t) {
  const float t2 = t * t;
  return {6.0f * t2 - 6.0f * t, 3.0f * t2 - 4.0f * t + 1.0f,
          -6.0f * t2 + 6.0f * t, 3.0f * t2 - 2.0f * t};
}
// and its second derivative (media/c1.py::hermite_d2basis)
RT_HD Basis3 hermite_d2basis3(float t) {
  return {12.0f * t - 6.0f, 6.0f * t - 4.0f, -12.0f * t + 6.0f,
          6.0f * t - 2.0f};
}
// c0*h0 + c1*g0 + c2*h1 + c3*g1 (media/c1.py::_hermite1)
RT_HD float herm1(float c0, float c1, float c2, float c3, const Basis3& b) {
  return c0 * b.h0 + c1 * b.g0 + c2 * b.h1 + c3 * b.g1;
}

// jnp.clip(v, 0, hi) = min(max(v, 0), hi)
RT_HD float clamp3(float v, float hi) { return fminf(fmaxf(v, 0.0f), hi); }

// row quad j (floats 4j .. 4j + 3) of a cell row: one float4 load through
// the read-only cache on the card
RT_HD void quad(const float* row, int j, float* o) {
#ifdef __CUDA_ARCH__
  const float4 w = __ldg(reinterpret_cast<const float4*>(row) + j);
  o[0] = w.x;
  o[1] = w.y;
  o[2] = w.z;
  o[3] = w.w;
#else
  for (int k = 0; k < 4; ++k) o[k] = row[4 * j + k];
#endif
}

// One patch channel of the w-collapse of _tile_cell_locate3 (:322-328):
// its four corners (00, +x, +y, +xy) from the row channel's values at
// w = 0 (lo) and w = 1 (hi) and those of its d/dw channel (dlo, dhi), with
// the 1-D basis b in w
RT_HD void wcollapse(const float* lo, const float* hi, const float* dlo,
                     const float* dhi, const Basis3& b, float* q) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = lo[k] * b.h0 + dlo[k] * b.g0 + hi[k] * b.h1 + dhi[k] * b.g1;
}

// The v-collapses of one cell row that a blend reads (media/c1.py::_vblend
// of the w-collapsed patch q_w with the v basis b_v: each corner column
// pair blended in v into cubic-in-u Hermite data (p0, m0, p1, m1)):
// col[c] for the w basis wb[kw[c]] and the v basis *vb[c], from the row
// consumed as it arrives, with no copy of its 64 floats.  The w-collapse of
// media/grid3.py (wcollapse, its patch channels f, f_v, f_u, f_vu from row
// channels 0, 2, 1, 3 and their d/dw channels 4..7: media/grid3._CH2D)
// feeds _vblend's halves: f and f_v give a collapse's h0 and h1, f_u and
// f_vu its g0 and g1.  So each half reads its two row channels' eight
// quads, collapses them in w with every basis of wb, and blends them in v
// at once; then the other half.  Every product and sum is the one
// wcollapse, _vblend and herm1 form, in their order.
template <int NW, int NC>
RT_HD void row_cols(const float* row, const Basis3 (&wb)[NW],
                    const int (&kw)[NC], const Basis3* const (&vb)[NC],
                    Basis3 (&col)[NC]) {
  float o[NC][2][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // patch channels 2 half and 2 half + 1 are row channels chs[0..1]; a
    // row channel's quads 2 ch, 2 ch + 1 hold its corners at w = 0 and 1,
    // quads 2 ch + 8, 2 ch + 9 its d/dw channel's
    const int chs[2] = {half, half + 2};
    float q[2][NW][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float lo[4], hi[4], dlo[4], dhi[4];
      quad(row, 2 * chs[j], lo);
      quad(row, 2 * chs[j] + 1, hi);
      quad(row, 2 * chs[j] + 8, dlo);
      quad(row, 2 * chs[j] + 9, dhi);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        wcollapse(lo, hi, dlo, dhi, wb[w], q[j][w]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* a = q[0][kw[c]];
      const float* b = q[1][kw[c]];
      o[c][half][0] = herm1(a[0], b[0], a[2], b[2], *vb[c]);
      o[c][half][1] = herm1(a[1], b[1], a[3], b[3], *vb[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
    col[c] = {o[c][0][0], o[c][1][0], o[c][0][1], o[c][1][1]};
}

// A C1Grid3Medium's per-cell table (engine/tiled3.py::cells64): one row of
// 64 floats a cell, the cell (ix, iy, iz) at row (iz*(ny-1) + iy)*(nx-1) +
// ix; nx, ny, nz count nodes.  Each evaluation locates the cell by JAX's
// float32 clip/floor/min sequence (fused3d.py:284-293), forms the row index
// in 32-bit integers (no window, so no float32 index; a table of 2^31 rows
// would hold 550 GB, and the entry points refuse one), reads the row (16
// float4 loads through the read-only cache on the card) as it blends.
// Queries outside the grid read the edge cell.
struct Grid3 {
  const float* t;
  float x0, y0, z0, inv_hx, inv_hy, inv_hz;
  int nx, ny, nz;

  // the row of the cell of (x, y, z) and the in-cell offsets
  RT_HD const float* locate(float x, float y, float z, float& ux, float& uy,
                            float& uz) const {
    const float fx = clamp3((x - x0) * inv_hx, (float)(nx - 1));
    const float fy = clamp3((y - y0) * inv_hy, (float)(ny - 1));
    const float fz = clamp3((z - z0) * inv_hz, (float)(nz - 1));
    const float ix = fminf(floorf(fx), (float)(nx - 2));
    const float iy = fminf(floorf(fy), (float)(ny - 2));
    const float iz = fminf(floorf(fz), (float)(nz - 2));
    ux = fx - ix;
    uy = fy - iy;
    uz = fz - iz;
    const int c = (static_cast<int>(iz) * (ny - 1) + static_cast<int>(iy)) *
                      (nx - 1) +
                  static_cast<int>(ix);
    return t + static_cast<long long>(c) * 64;
  }

  // media/grid3.py::blend3: the value w-collapse gives n, gx and gy
  // (media/c1.py::c1_blend), the derivative w-collapse's value gz; the row
  // is read as it is blended (row_cols)
  RT_HD void nag(float x, float y, float z, float& n, float& gx, float& gy,
                 float& gz) const {
    float ux, uy, uz;
    const float* row = locate(x, y, z, ux, uy, uz);
    const Basis3 hv = hermite_basis3(uy), dv = hermite_dbasis3(uy);
    const Basis3 wb[2] = {hermite_basis3(uz), hermite_dbasis3(uz)};
    // col (value in w and v), col_dv (value in w, d/dv), col_dw (d/dw,
    // value in v)
    constexpr int kW[3] = {0, 0, 1};
    const Basis3* vb[3] = {&hv, &dv, &hv};
    Basis3 cols[3];
    row_cols(row, wb, kW, vb, cols);
    const Basis3 &col = cols[0], &col_dv = cols[1], &col_dw = cols[2];
    const Basis3 hu = hermite_basis3(ux), du = hermite_dbasis3(ux);
    n = herm1(col.h0, col.g0, col.h1, col.g1, hu);
    gx = herm1(col.h0, col.g0, col.h1, col.g1, du) * inv_hx;
    gy = herm1(col_dv.h0, col_dv.g0, col_dv.h1, col_dv.g1, hu) * inv_hy;
    gz = herm1(col_dw.h0, col_dw.g0, col_dw.h1, col_dw.g1, hu) * inv_hz;
  }

  // media/grid3.py::blend3_h (kernels/dynamic3d.py::_tile_nag3_h,
  // :386-397): the value w-collapse through the 2-D Hessian blend
  // (media/c1.py::c1_blend_h) gives n, gx, gy, hxx, hxy, hyy; the
  // derivative collapse through the full gradient blend gz, hxz, hyz
  // (times inv_hz); the second-derivative collapse's value hzz.  The row is
  // read as it is blended (row_cols).
  RT_HD void nag_h(float x, float y, float z, H3& h) const {
    float ux, uy, uz;
    const float* row = locate(x, y, z, ux, uy, uz);
    const Basis3 hv = hermite_basis3(uy), dv = hermite_dbasis3(uy),
                 ddv = hermite_d2basis3(uy);
    const Basis3 wb[3] = {hermite_basis3(uz), hermite_dbasis3(uz),
                          hermite_d2basis3(uz)};
    // by (w basis, v basis): col (value, value), col_dv, col_ddv, cw (d/dw,
    // value), cw_dv, cww (d2/dw2, value)
    constexpr int kW[6] = {0, 0, 0, 1, 1, 2};
    const Basis3* vb[6] = {&hv, &dv, &ddv, &hv, &dv, &hv};
    Basis3 cols[6];
    row_cols(row, wb, kW, vb, cols);
    const Basis3 &col = cols[0], &col_dv = cols[1], &col_ddv = cols[2],
                 &cw = cols[3], &cw_dv = cols[4], &cww = cols[5];
    const Basis3 hu = hermite_basis3(ux), du = hermite_dbasis3(ux),
                 ddu = hermite_d2basis3(ux);
    h.n = herm1(col.h0, col.g0, col.h1, col.g1, hu);
    h.gx = herm1(col.h0, col.g0, col.h1, col.g1, du) * inv_hx;
    h.gy = herm1(col_dv.h0, col_dv.g0, col_dv.h1, col_dv.g1, hu) * inv_hy;
    h.hxx = herm1(col.h0, col.g0, col.h1, col.g1, ddu) * (inv_hx * inv_hx);
    h.hxy = herm1(col_dv.h0, col_dv.g0, col_dv.h1, col_dv.g1, du) *
            (inv_hx * inv_hy);
    h.hyy = herm1(col_ddv.h0, col_ddv.g0, col_ddv.h1, col_ddv.g1, hu) *
            (inv_hy * inv_hy);
    h.gz = herm1(cw.h0, cw.g0, cw.h1, cw.g1, hu) * inv_hz;
    h.hxz = herm1(cw.h0, cw.g0, cw.h1, cw.g1, du) * inv_hx * inv_hz;
    h.hyz = herm1(cw_dv.h0, cw_dv.g0, cw_dv.h1, cw_dv.g1, hu) * inv_hy * inv_hz;
    h.hzz = herm1(cww.h0, cww.g0, cww.h1, cww.g1, hu) * (inv_hz * inv_hz);
  }
};

// Whether a Grid3 of nx * ny * nz nodes can be read: at least 2 nodes an
// axis, and fewer than 2^31 cells (Grid3::locate's 32-bit row index)
RT_HD bool grid3_fits(int nx, int ny, int nz) {
  return nx >= 2 && ny >= 2 && nz >= 2 &&
         static_cast<long long>(nx - 1) * (ny - 1) * (nz - 1) < (1LL << 31);
}

// -- the step (fused3d.py::_rot_coeffs :68, _rodrigues3 :79) ----------------
constexpr float kSixth3 = (float)(1.0 / 6.0);
constexpr float kTwelfth3 = (float)(1.0 / 12.0);
constexpr float kThirtieth3 = (float)(1.0 / 30.0);

// rotate unit u by the rotation vector r, cos/sinc/vers as polynomials in
// the squared angle (cos from vers, so the three stay consistent); F: each
// product that feeds a sum fused into it (Fma3)
template <bool F>
RT_HD void rodrigues3(float ux, float uy, float uz, float rx, float ry,
                      float rz, float& ox, float& oy, float& oz) {
  using rt::mad;
  const float a2 = mad<F>(rz, rz, mad<F>(ry, ry, rx * rx));
  const float sinc =
      mad<F>(-(a2 * kSixth3), mad<F>(-a2, 0.05f, 1.0f), 1.0f);
  const float vers =
      0.5f * mad<F>(-(a2 * kTwelfth3), mad<F>(-a2, kThirtieth3, 1.0f), 1.0f);
  const float cs = mad<F>(-a2, vers, 1.0f);
  const float cx = mad<F>(ry, uz, -(rz * uy));
  const float cy = mad<F>(rz, ux, -(rx * uz));
  const float cz = mad<F>(rx, uy, -(ry * ux));
  const float rdotu = mad<F>(rz, uz, mad<F>(ry, uy, rx * ux));
  ox = mad<F>(rx * rdotu, vers, mad<F>(cx, sinc, ux * cs));
  oy = mad<F>(ry * rdotu, vers, mad<F>(cy, sinc, uy * cs));
  oz = mad<F>(rz * rdotu, vers, mad<F>(cz, sinc, uz * cs));
}

// Kahan-compensated position update: t = dd - c; nx = x + t; c' = (nx - x) - t
RT_HD void kahan3(float x, float c, float dd, float& nx, float& nc) {
  const float t = RT3_SUB(dd, c);
  nx = RT3_ADD(x, t);
  nc = RT3_SUB(RT3_SUB(nx, x), t);
}

// The 12 state values of one ray (the planes of rt::Slot3 in fused3d.cu).
struct Ray3 {
  float x, y, z, cx, cy, cz, ux, uy, uz, tt, dsim;
  bool active;
};

// One ray's carry across steps: its state, n and grad n at its position,
// and 1 / n where n is in recip_pos's range (the ops of Quick3::kRecip)
struct Carry3 {
  Ray3 s;
  float n, gx, gy, gz, rny;
};

// Every op's step divides or takes a square root: op2 and op6 by n and the
// next n (1 / n), op6 and op8 ds^2 / 2n, op6 and op8 take the chord's
// length, op1 and op8 normalize the impulse by 1 / sqrtf, and the analytic
// fields take a reciprocal.  Each of these has a fast form: 1 / n carried
// from the last step's n2 and the quotient from it (common.cuh's recip_pos
// and div_fast_pos), sqrt_fast, 1 / sqrtf as sqrt_fast then rcp_fast, the
// fields' rcp_fast, each correctly rounded where its guard holds, with no
// branch.  A step takes them in one of two ways (common.cuh StepMode),
// either way with the IEEE operations' bits:
// * FAST3 (WholeStep3: the grid3 table): every guard ANDed into one flag,
//   tested once a step; where it fails, the step again in IEEE3 (the plain
//   version's operations one by one) from the same carry.  One test a step,
//   but the carry stays live through the step (128 registers, 4 blocks an
//   SM): on the grid3 table's tilted fan, 2.5 % faster than LOCAL3 (PERF.md
//   section 6).
// * LOCAL3 (the analytic fields): each guarded operation takes its IEEE
//   form at once where its own guard fails, so no carry is kept for a
//   rerun (44-48 registers against 56): 3.7 % faster on the fisheye.
// The guards hold on every step of the 3-D main path's fans: n lies in
// [2^-16, 2^16] on every 3-D field (the fisheye and the grid (0, 1], vert
// about 1/18, the interface [1, 1.42]); a step's squared chord (about ds^2,
// 4e-6 or more at the 3-D fans' steps) and the impulse's |n u + ...|^2
// (about n^2) lie in [2^-100, 2^126].  No small numerator is divided: the
// 3-D step multiplies by 1 / n, where the 2-D step divides (fused.cuh
// Quick).
enum Mode3 { IEEE3 = rt::STEP_IEEE, FAST3 = rt::STEP_FAST,
             LOCAL3 = rt::STEP_LOCAL };
using rt::guarded;

template <class Medium>
struct WholeStep3 {
  static constexpr bool value = false;
};
template <>
struct WholeStep3<Grid3> {
  static constexpr bool value = true;
};

// The analytic fields' step in its FMA form: every product that feeds a
// sum in step3 and rodrigues3 fused into it (rt::mad<true>, one FFMA), in
// the order written there, which the plain version repeats with
// utils/fma.py::fma32; the grid3 table keeps JAX's roundings
// (rt::mad<false>), term for term (its plain version is held to JAX's
// tiled kernel and the scan tier's evaluator).  The fields themselves keep
// JAX's roundings.
template <class Medium>
struct Fma3 {
  static constexpr bool value = false;
};
template <int FIELD>
struct Fma3<Analytic3<FIELD>> {
  static constexpr bool value = true;
};

// n and grad n at (x, y, z) in MODE: the grid3 table divides nothing; an
// analytic field's reciprocal by its fast path
template <int MODE, class Medium>
RT_HD void eval3(const Medium& m, float x, float y, float z, float& n,
                 float& gx, float& gy, float& gz, bool& ok) {
  m.nag(x, y, z, n, gx, gy, gz);
}
template <int MODE, int FIELD>
RT_HD void eval3(const Analytic3<FIELD>& m, float x, float y, float z,
                 float& n, float& gx, float& gy, float& gz, bool& ok) {
  if (MODE == IEEE3) {
    m.template field<false>(x, y, z, n, gx, gy, gz, ok);
    return;
  }
  bool g = true;
  m.template field<true>(x, y, z, n, gx, gy, gz, g);
  if (MODE == LOCAL3 && !g) m.template field<false>(x, y, z, n, gx, gy, gz, g);
  ok = ok & g;
}

template <int OP>
struct Quick3 {
  // the ops that divide by n: op2 and op6 (1 / n), op6 and op8 (ds^2 / 2n)
  static constexpr bool kRecip = OP == 2 || OP == 6 || OP == 8;
};

template <class Medium, int OP>
RT_HD void load3(const Medium& m, Carry3& c) {
  bool ok = true;
  eval3<LOCAL3>(m, c.s.x, c.s.y, c.s.z, c.n, c.gx, c.gy, c.gz, ok);
  c.rny = Quick3<OP>::kRecip ? rt::recip_pos(c.n).y : 0.0f;
}

// One step of OP (_step_body3) from the carry, its guarded operations in
// MODE (Mode3), their guards ANDed into ok; on the analytic fields in the
// FMA form (Fma3)
template <class Medium, int OP, int MODE>
RT_HD void step3(Carry3& c, float ds, float dsds_half, float half,
                    const Medium& m, bool& ok) {
  using rt::mad;
  constexpr bool kSecond = OP == 6 || OP == 8;
  constexpr bool kRk2 = OP == 2 || OP == 6;
  constexpr bool F = Fma3<Medium>::value;
  Ray3& s = c.s;
  const float ux = s.ux, uy = s.uy, uz = s.uz;
  const float n = c.n, gx = c.gx, gy = c.gy, gz = c.gz;
  // the carried reciprocal of n, its guard tested where it is used
  const rt::Recip rn{n, c.rny, rt::pos_range(n)};

  // -- position advance (ops/steppers.py in vector form) -----------------
  // g . u and grad n less its part along u, shared by the position advance
  // and the rotation
  const float gdotu = mad<F>(gz, uz, mad<F>(gy, uy, gx * ux));
  const float tx = mad<F>(-gdotu, ux, gx);
  const float ty = mad<F>(-gdotu, uy, gy);
  const float tz = mad<F>(-gdotu, uz, gz);
  float ddx, ddy, ddz;
  if (kSecond) {
    const float half_fac = guarded<MODE>(
        [&](bool& g) { return rt::div_fast_pos(dsds_half, rn, g); },
        [&] { return dsds_half / n; }, ok);
    ddx = mad<F>(tx, half_fac, ux * ds);
    ddy = mad<F>(ty, half_fac, uy * ds);
    ddz = mad<F>(tz, half_fac, uz * ds);
  } else {
    ddx = ux * ds;
    ddy = uy * ds;
    ddz = uz * ds;
  }
  float nx2, ny2, nz2, cx2, cy2, cz2;
  kahan3(s.x, s.cx, ddx, nx2, cx2);
  kahan3(s.y, s.cy, ddy, ny2, cy2);
  kahan3(s.z, s.cz, ddz, nz2, cz2);
  float n2, gx2, gy2, gz2;
  eval3<MODE>(m, nx2, ny2, nz2, n2, gx2, gy2, gz2, ok);
  // the next step's reciprocal of n (its y read only where its ok holds)
  rt::Recip rn2{};
  if (Quick3<OP>::kRecip) rn2 = rt::recip_pos(n2);

  // -- tangent update ----------------------------------------------------
  float nux, nuy, nuz;
  if (kRk2) {
    // rotation-vector Heun (engine/trace3d.py), polynomial rotations
    const float inv_n = guarded<MODE>(
        [&](bool& g) { g = g & rn.ok; return rn.y; },
        [&] { return 1.0f / n; }, ok);
    const float k1x = ds * tx * inv_n;
    const float k1y = ds * ty * inv_n;
    const float k1z = ds * tz * inv_n;
    const float r1x = mad<F>(uy, k1z, -(uz * k1y));
    const float r1y = mad<F>(uz, k1x, -(ux * k1z));
    const float r1z = mad<F>(ux, k1y, -(uy * k1x));
    float umx, umy, umz;
    rodrigues3<F>(ux, uy, uz, r1x, r1y, r1z, umx, umy, umz);
    const float inv_n2 = guarded<MODE>(
        [&](bool& g) { g = g & rn2.ok; return rn2.y; },
        [&] { return 1.0f / n2; }, ok);
    const float gdotm = mad<F>(gz2, umz, mad<F>(gy2, umy, gx2 * umx));
    const float k2x = ds * mad<F>(-gdotm, umx, gx2) * inv_n2;
    const float k2y = ds * mad<F>(-gdotm, umy, gy2) * inv_n2;
    const float k2z = ds * mad<F>(-gdotm, umz, gz2) * inv_n2;
    const float rx = (r1x + mad<F>(umy, k2z, -(umz * k2y))) * 0.5f;
    const float ry = (r1y + mad<F>(umz, k2x, -(umx * k2z))) * 0.5f;
    const float rz = (r1z + mad<F>(umx, k2y, -(umy * k2x))) * 0.5f;
    rodrigues3<F>(ux, uy, uz, rx, ry, rz, nux, nuy, nuz);
  } else {
    // trapezoidal impulse on p = n u
    const float sx = mad<F>(gx + gx2, half, n * ux);
    const float sy = mad<F>(gy + gy2, half, n * uy);
    const float sz = mad<F>(gz + gz2, half, n * uz);
    const float ssq = mad<F>(sz, sz, mad<F>(sy, sy, sx * sx));
    const float inv = guarded<MODE>(
        [&](bool& g) { return rt::rcp_fast(rt::sqrt_fast(ssq, g), g); },
        [&] { return 1.0f / sqrtf(ssq); }, ok);
    nux = sx * inv;
    nuy = sy * inv;
    nuz = sz * inv;
  }

  if (kSecond) {
    const float d2 = mad<F>(ddz, ddz, mad<F>(ddy, ddy, ddx * ddx));
    const float dist = guarded<MODE>(
        [&](bool& g) { return rt::sqrt_fast(d2, g); },
        [&] { return sqrtf(d2); }, ok);
    s.tt = mad<F>(dist * (n + n2), 0.5f, s.tt);
    s.dsim = s.dsim + dist;
  } else {
    s.tt = mad<F>(ds * (n + n2), 0.5f, s.tt);
    s.dsim = s.dsim + ds;
  }
  s.x = nx2;
  s.y = ny2;
  s.z = nz2;
  s.cx = cx2;
  s.cy = cy2;
  s.cz = cz2;
  s.ux = nux;
  s.uy = nuy;
  s.uz = nuz;
  c.n = n2;
  c.gx = gx2;
  c.gy = gy2;
  c.gz = gz2;
  c.rny = rn2.y;
}

// ``steps`` steps of OP on one ray from global step ``offset``: _step_body3
// with a frozen ray (box exit or the step limit) leaving the loop, since its
// state never changes again; the loop runs to the ray's step budget
// (common.cuh step_budget: the steps before its limit), so it tests no
// limit a step.  n and grad are evaluated at the start, as
// _make_tile_kernel3 does (:417), so chained launches equal one.  Each step
// takes its guarded operations' fast forms, with the IEEE step from the
// same carry (WholeStep3) or each operation's IEEE form (Mode3) where a
// guard fails.  box = (x0, x1, y0, y1, z0, z1).
template <class Medium, int OP>
RT_HD void run3(Ray3& s, int steps, float ds, float limit, float offset,
                const float* box, const Medium& m) {
  Carry3 c;
  c.s = s;
  const int stop = rt::step_budget(steps, offset, limit);
  if (!s.active || stop == 0) return;
  load3<Medium, OP>(m, c);
  const float dsds_half = ds * ds * 0.5f;
  const float half = ds * 0.5f;
  for (int i = 0; i < stop && c.s.active; ++i) {
    bool ok = true;
    if constexpr (WholeStep3<Medium>::value) {
      Carry3 t = c;
      step3<Medium, OP, FAST3>(t, ds, dsds_half, half, m, ok);
      if (!ok) {
        t = c;
        step3<Medium, OP, IEEE3>(t, ds, dsds_half, half, m, ok);
      }
      c = t;
    } else {
      step3<Medium, OP, LOCAL3>(c, ds, dsds_half, half, m, ok);
    }
    // strict 6-face exit: the exiting step is kept
    const Ray3& r = c.s;
    if ((r.x > box[1]) | (r.x < box[0]) | (r.y > box[3]) | (r.y < box[2]) |
        (r.z > box[5]) | (r.z < box[4]))
      c.s.active = false;
  }
  s = c.s;
}

}  // namespace rt3
