// The fused 3-D step loop for op1/op2/op6/op8, templated on the medium and
// the op, and its two media: the analytic 3-D fields (Analytic3<FIELD>) and
// a C1Grid3Medium's per-cell table (Grid3).  fused3d.cu instantiates it in
// the kernels fused3d_step and fused3d_step_grid; what they compute, and
// what bounds them, is described at the top of fused3d.cu.  Each medium
// also has nag_h, n with its gradient and Hessian, which the 3-D dynamic
// loop (dynamic3d.cuh) reads.
//
// Every function here is __host__ __device__ (RT_HD) and includes no CUDA
// header, so the whole per-ray loop (run3) also compiles for the host with
// g++ and the CUDA qualifiers stubbed (-ffp-contract=off), and the CPU tests
// hold it against the plain PyTorch version
// (raytracing_tpu_torch/kernels/fused3d.py::fused3d_step_plain) to the bit.
//
// Every expression keeps the order of operations of JAX's _step_body3
// (raytracing_tpu/kernels/fused3d.py:93-188) and of the plain version: the
// Python constants 1/6, 0.05, 1/12 and 1/30 of _rot_coeffs round to float32
// as JAX folds them; (ds * ds) * 0.5 and ds * 0.5 are float32 products; the
// impulse normalizes by 1 / sqrtf (IEEE square root, one rounded division)
// where JAX writes lax.rsqrt.  Built with -fmad=false, so nothing contracts
// into an FMA; the Kahan lines use __fadd_rn/__fsub_rn on the card.
#pragma once

#include <math.h>

#ifndef RT_HD
#define RT_HD __host__ __device__ __forceinline__
#endif

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
  RT_HD void nag(float x, float y, float z, float& n, float& gx, float& gy,
                 float& gz) const {
    if (FIELD == FISHEYE3) {
      n = 1.0f / (1.0f + x * x + y * y + z * z);
      const float c = -2.0f * n * n;
      gx = c * x;
      gy = c * y;
      gz = c * z;
    } else if (FIELD == VERT3) {
      n = 1.0f / (18.0f + 2.0f * y);
      gx = 0.0f;
      gy = -2.0f * n * n;
      gz = 0.0f;
    } else {
      // the literal logistic of the TPU kernel (fused3d.py:60): expf
      // overflows to inf below y ~ -0.44, giving sig = 0 exactly
      const float sig = 1.0f / (1.0f + expf(-y / kThck));
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

// media/c1.py::_vblend on patch data q: each corner column pair blended in v
// with the basis b into cubic-in-u Hermite data (p0, m0, p1, m1)
RT_HD Basis3 vblend3(const float q[4][4], const Basis3& b) {
  const float* f = q[0];
  const float* fv = q[1];
  const float* fu = q[2];
  const float* fw = q[3];
  return {herm1(f[0], fv[0], f[2], fv[2], b),
          herm1(fu[0], fw[0], fu[2], fw[2], b),
          herm1(f[1], fv[1], f[3], fv[3], b),
          herm1(fu[1], fw[1], fu[3], fw[3], b)};
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

// The whole w-collapse: the 2-D C1 patch data q[ch2d][corner] (channels f,
// f_v, f_u, f_vu) from the cell row v[ch * 8 + corner3]
RT_HD void wblend(const float* v, const Basis3& b, float q[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int ch = c == 1 ? 2 : (c == 2 ? 1 : c);   // media/grid3._CH2D
    wcollapse(v + ch * 8, v + ch * 8 + 4, v + (ch + 4) * 8,
              v + (ch + 4) * 8 + 4, b, q[c]);
  }
}

// A C1Grid3Medium's per-cell table (engine/tiled3.py::cells64): one row of
// 64 floats a cell, the cell (ix, iy, iz) at row (iz*(ny-1) + iy)*(nx-1) +
// ix; nx, ny, nz count nodes.  Each evaluation locates the cell by JAX's
// float32 clip/floor/min sequence (fused3d.py:284-293), forms the global row
// index in 64-bit integers (no window, so no float32 index), reads the row
// (16 float4 loads through the read-only cache on the card) and blends.
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
    const long long c =
        (static_cast<long long>(iz) * (ny - 1) + static_cast<long long>(iy)) *
            (nx - 1) +
        static_cast<long long>(ix);
    return t + c * 64;
  }

  // the cell of (x, y, z): its 64 floats into v, the in-cell offsets
  RT_HD void cell(float x, float y, float z, float* v, float& ux, float& uy,
                  float& uz) const {
    const float* row = locate(x, y, z, ux, uy, uz);
#pragma unroll
    for (int k = 0; k < 16; ++k) quad(row, k, v + 4 * k);
  }

  RT_HD void nag(float x, float y, float z, float& n, float& gx, float& gy,
                 float& gz) const {
    float v[64], ux, uy, uz;
    cell(x, y, z, v, ux, uy, uz);
    // media/grid3.py::blend3: the value w-collapse gives n, gx and gy
    // (media/c1.py::c1_blend), the derivative w-collapse's value gz
    const Basis3 hv = hermite_basis3(uy), dv = hermite_dbasis3(uy);
    const Basis3 hu = hermite_basis3(ux), du = hermite_dbasis3(ux);
    float q[4][4];
    wblend(v, hermite_basis3(uz), q);
    const Basis3 col = vblend3(q, hv);
    n = herm1(col.h0, col.g0, col.h1, col.g1, hu);
    gx = herm1(col.h0, col.g0, col.h1, col.g1, du) * inv_hx;
    const Basis3 col_dv = vblend3(q, dv);
    gy = herm1(col_dv.h0, col_dv.g0, col_dv.h1, col_dv.g1, hu) * inv_hy;
    wblend(v, hermite_dbasis3(uz), q);
    const Basis3 col_dw = vblend3(q, hv);
    gz = herm1(col_dw.h0, col_dw.g0, col_dw.h1, col_dw.g1, hu) * inv_hz;
  }

  // media/grid3.py::blend3_h (kernels/dynamic3d.py::_tile_nag3_h,
  // :386-397): the value w-collapse through the 2-D Hessian blend
  // (media/c1.py::c1_blend_h) gives n, gx, gy, hxx, hxy, hyy; the
  // derivative collapse through the full gradient blend gz, hxz, hyz
  // (times inv_hz); the second-derivative collapse's value hzz.  The row is
  // consumed as it arrives, with no copy of its 64 floats: the two patch
  // channels of one half of vblend3 (f and f_v give its h0 and h1, f_u and
  // f_vu its g0 and g1) are read, collapsed in w with all three bases and
  // blended in v at once, then the other two; every product and sum is the
  // one wblend, vblend3 and herm1 form, in their order.
  RT_HD void nag_h(float x, float y, float z, H3& h) const {
    float ux, uy, uz;
    const float* row = locate(x, y, z, ux, uy, uz);
    const Basis3 hv = hermite_basis3(uy), dv = hermite_dbasis3(uy),
                 ddv = hermite_d2basis3(uy);
    const Basis3 wb[3] = {hermite_basis3(uz), hermite_dbasis3(uz),
                          hermite_d2basis3(uz)};
    // the v-collapses vblend3(q_w, b_v) that the blend reads, by
    // (w basis, v basis): col (value, value), col_dv, col_ddv, cw (d/dw,
    // value), cw_dv, cww (d2/dw2, value); their (h0, h1), then (g0, g1)
    constexpr int kW[6] = {0, 0, 0, 1, 1, 2};
    const Basis3* vb[6] = {&hv, &dv, &ddv, &hv, &dv, &hv};
    float o[6][2][2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // patch channels 2 half and 2 half + 1 are row channels chs[0..1]
      // (media/grid3._CH2D); a row channel's quads 2 ch, 2 ch + 1 hold its
      // corners at w = 0 and 1, quads 2 ch + 8, 2 ch + 9 its d/dw channel's
      const int chs[2] = {half, half + 2};
      float q[2][3][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float lo[4], hi[4], dlo[4], dhi[4];
        quad(row, 2 * chs[j], lo);
        quad(row, 2 * chs[j] + 1, hi);
        quad(row, 2 * chs[j] + 8, dlo);
        quad(row, 2 * chs[j] + 9, dhi);
#pragma unroll
        for (int w = 0; w < 3; ++w)
          wcollapse(lo, hi, dlo, dhi, wb[w], q[j][w]);
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float* a = q[0][kW[c]];
        const float* b = q[1][kW[c]];
        o[c][half][0] = herm1(a[0], b[0], a[2], b[2], *vb[c]);
        o[c][half][1] = herm1(a[1], b[1], a[3], b[3], *vb[c]);
      }
    }
    auto col_of = [&](int c) -> Basis3 {
      return {o[c][0][0], o[c][1][0], o[c][0][1], o[c][1][1]};
    };
    const Basis3 col = col_of(0), col_dv = col_of(1), col_ddv = col_of(2),
                 cw = col_of(3), cw_dv = col_of(4), cww = col_of(5);
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

// -- the step (fused3d.py::_rot_coeffs :68, _rodrigues3 :79) ----------------
constexpr float kSixth3 = (float)(1.0 / 6.0);
constexpr float kTwelfth3 = (float)(1.0 / 12.0);
constexpr float kThirtieth3 = (float)(1.0 / 30.0);

// rotate unit u by the rotation vector r, cos/sinc/vers as polynomials in
// the squared angle (cos from vers, so the three stay consistent)
RT_HD void rodrigues3(float ux, float uy, float uz, float rx, float ry,
                      float rz, float& ox, float& oy, float& oz) {
  const float a2 = rx * rx + ry * ry + rz * rz;
  const float sinc = 1.0f - a2 * kSixth3 * (1.0f - a2 * 0.05f);
  const float vers = 0.5f * (1.0f - a2 * kTwelfth3 * (1.0f - a2 * kThirtieth3));
  const float cs = 1.0f - a2 * vers;
  const float cx = ry * uz - rz * uy;
  const float cy = rz * ux - rx * uz;
  const float cz = rx * uy - ry * ux;
  const float rdotu = rx * ux + ry * uy + rz * uz;
  ox = ux * cs + cx * sinc + rx * rdotu * vers;
  oy = uy * cs + cy * sinc + ry * rdotu * vers;
  oz = uz * cs + cz * sinc + rz * rdotu * vers;
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

// ``steps`` steps of OP on one ray from global step ``offset``: _step_body3
// with a frozen ray (box exit or the step limit) leaving the loop, since its
// state never changes again.  n and grad are evaluated at the start, as
// _make_tile_kernel3 does (:417), so chained launches equal one.
// box = (x0, x1, y0, y1, z0, z1).
template <class Medium, int OP>
RT_HD void run3(Ray3& s, int steps, float ds, float limit, float offset,
                const float* box, const Medium& m) {
  constexpr bool kSecond = OP == 6 || OP == 8;
  constexpr bool kRk2 = OP == 2 || OP == 6;
  float x = s.x, y = s.y, z = s.z, cx = s.cx, cy = s.cy, cz = s.cz;
  float ux = s.ux, uy = s.uy, uz = s.uz, tt = s.tt, dsim = s.dsim;
  bool active = s.active;
  float n, gx, gy, gz;
  m.nag(x, y, z, n, gx, gy, gz);
  const float dsds_half = ds * ds * 0.5f;
  const float half = ds * 0.5f;

  for (int i = 0; i < steps; ++i) {
    if (!active || !((float)i + offset < limit)) break;

    // -- position advance (ops/steppers.py in vector form) ---------------
    // g . u, shared by the position advance and the rotation
    const float gdotu = gx * ux + gy * uy + gz * uz;
    float ddx, ddy, ddz;
    if (kSecond) {
      const float half_fac = dsds_half / n;
      ddx = ux * ds + (gx - gdotu * ux) * half_fac;
      ddy = uy * ds + (gy - gdotu * uy) * half_fac;
      ddz = uz * ds + (gz - gdotu * uz) * half_fac;
    } else {
      ddx = ux * ds;
      ddy = uy * ds;
      ddz = uz * ds;
    }
    float nx2, ny2, nz2, cx2, cy2, cz2;
    kahan3(x, cx, ddx, nx2, cx2);
    kahan3(y, cy, ddy, ny2, cy2);
    kahan3(z, cz, ddz, nz2, cz2);
    float n2, gx2, gy2, gz2;
    m.nag(nx2, ny2, nz2, n2, gx2, gy2, gz2);

    // -- tangent update ----------------------------------------------------
    float nux, nuy, nuz;
    if (kRk2) {
      // rotation-vector Heun (engine/trace3d.py), polynomial rotations
      const float inv_n = 1.0f / n;
      const float k1x = ds * (gx - gdotu * ux) * inv_n;
      const float k1y = ds * (gy - gdotu * uy) * inv_n;
      const float k1z = ds * (gz - gdotu * uz) * inv_n;
      const float r1x = uy * k1z - uz * k1y;
      const float r1y = uz * k1x - ux * k1z;
      const float r1z = ux * k1y - uy * k1x;
      float umx, umy, umz;
      rodrigues3(ux, uy, uz, r1x, r1y, r1z, umx, umy, umz);
      const float inv_n2 = 1.0f / n2;
      const float gdotm = gx2 * umx + gy2 * umy + gz2 * umz;
      const float k2x = ds * (gx2 - gdotm * umx) * inv_n2;
      const float k2y = ds * (gy2 - gdotm * umy) * inv_n2;
      const float k2z = ds * (gz2 - gdotm * umz) * inv_n2;
      const float rx = (r1x + (umy * k2z - umz * k2y)) * 0.5f;
      const float ry = (r1y + (umz * k2x - umx * k2z)) * 0.5f;
      const float rz = (r1z + (umx * k2y - umy * k2x)) * 0.5f;
      rodrigues3(ux, uy, uz, rx, ry, rz, nux, nuy, nuz);
    } else {
      // trapezoidal impulse on p = n u
      const float sx = n * ux + (gx + gx2) * half;
      const float sy = n * uy + (gy + gy2) * half;
      const float sz = n * uz + (gz + gz2) * half;
      const float inv = 1.0f / sqrtf(sx * sx + sy * sy + sz * sz);
      nux = sx * inv;
      nuy = sy * inv;
      nuz = sz * inv;
    }

    if (kSecond) {
      const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
      tt = tt + dist * (n + n2) * 0.5f;
      dsim = dsim + dist;
    } else {
      tt = tt + ds * (n + n2) * 0.5f;
      dsim = dsim + ds;
    }
    x = nx2;
    y = ny2;
    z = nz2;
    cx = cx2;
    cy = cy2;
    cz = cz2;
    ux = nux;
    uy = nuy;
    uz = nuz;
    n = n2;
    gx = gx2;
    gy = gy2;
    gz = gz2;
    // strict 6-face exit: the exiting step is kept
    if ((x > box[1]) | (x < box[0]) | (y > box[3]) | (y < box[2]) |
        (z > box[5]) | (z < box[4]))
      active = false;
  }
  s.x = x;
  s.y = y;
  s.z = z;
  s.cx = cx;
  s.cy = cy;
  s.cz = cz;
  s.ux = ux;
  s.uy = uy;
  s.uz = uz;
  s.tt = tt;
  s.dsim = dsim;
  s.active = active;
}

}  // namespace rt3
