// The media the step kernels evaluate: each type has one
// nag(x, y, n, gx, gy) giving n and its gradient at (x, y), and the step
// loops of fused.cuh and golden.cuh are templates on the type.  Every
// function is __host__ __device__ (RT_HD, common.cuh): a table row loads
// through __ldg on the card and plainly on the host, so the media also
// build with g++ for the CPU tests of fused.cuh.  The
// analytic, stratified and per-cell grid types also have
// nag_h(x, y, f[9]): the dynamic kernels' (dynamic.cu) nine channels
// (n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy) — gn the n channel's own
// gradient, h the gradient's Jacobian
// (raytracing_tpu/kernels/dynamic.py: _field_fn_h :78, _strat_nag_h :121,
// _tile_nag_h :177, _tile_nag_c1_h :290).
//
// * Analytic<FIELD>: the closed-form fields
//   (raytracing_tpu/kernels/fused.py::_field_fn, fused.py:44-62).
// * Strat<CH>: a 1-D stratified table
//   (raytracing_tpu/kernels/fused.py::_strat_nag, fused.py:65-105), one row
//   a cell: CH = 6 for the parity form (Zy[i], Zy[i+1], cy[i, 0..3]) or 4
//   for the C1 form (cn[i, 0..3]), each row padded to 8 floats so that one
//   32-byte sector holds a cell.  The TPU kernel's 128-lane chunks and
//   chunk selects exist only for tpu.dynamic_gather; here the row is read
//   directly, through the read-only cache.
// * Grid<CELL_CH>: a 2-D per-cell table in the _cells36 layout
//   (raytracing_tpu/engine/segmented.py:449-467): one row a cell, the 4
//   corners (00, +x, +y, +xy) of channel ch at ch*4 + corner, 36 floats for
//   the parity Hermite form (fused.py::_hermite_blend, :108-148) or 16 for
//   the C1 form (media/c1.py::c1_blend).  It replaces the TPU's
//   block-shared cell window (fused.py::_tile_nag, :205): every ray reads
//   its own cell's row from global memory (144 or 64 bytes, float4 loads);
//   the parity fisheye table (37.5 MB) fits in the H100's 50 MB L2.
// * Nodes: the parity Hermite grid's node table itself
//   (media/hermite.py::HermiteGridMedium.nodes, (ny*nx, 9) float32, one row
//   a node).  It replaces the TPU supercell kernel's per-ray 4x4 node block
//   (fused.py::_supercell_nag, :151-202; gathered per ray before every
//   segment of at most 48 steps and resolved by 24 selects a channel): each
//   evaluation reads the cell's four corner rows straight from the table
//   (36 bytes each, scalar loads: a node row is not 16-byte aligned) and
//   applies the same hermite_blend to the same corner values as Grid<36>,
//   so the two agree to the bit.  The node table is a quarter of the
//   per-cell table's bytes and needs no per-call rebuild.
//
// Every expression keeps the JAX kernels' order of operations, and the
// cell index follows the same float32 path (clip, floor, min), so the
// kernels agree to the bit with their plain PyTorch versions
// (raytracing_tpu_torch/kernels/fused.py: field_fn, strat_nag_plain,
// tile_nag_plain, nodes_nag_plain; kernels/dynamic.py: field_fn_h,
// strat_nag_h, tile_nag_h) under -fmad=false.
#pragma once

#include "common.cuh"

namespace rt {

// -- analytic fields (raytracing_tpu/kernels/fused.py:44-62) ----------------
enum Field { FISHEYE = 0, VERT = 1, INTERFACE = 2 };

constexpr float kSqrt2 = (float)1.4142135623730951;
constexpr float kSqrt2m1 = (float)(1.4142135623730951 - 1.0);
constexpr float kThck = (float)0.005;   // config.THCK_PARAM
constexpr float kThck2 = (float)(0.005 * 0.005);

// the dynamic kernels' field channels at one point
enum H9 { HN = 0, HGX, HGY, HGNX, HGNY, HXX, HXY, HYX, HYY };

template <int FIELD>
struct Analytic {
  RT_HD void nag(float x, float y, float& n, float& gx, float& gy) const {
    if (FIELD == FISHEYE) {
      n = 1.0f / (1.0f + x * x + y * y);
      const float c = -2.0f * n * n;
      gx = c * x;
      gy = c * y;
    } else if (FIELD == VERT) {
      n = 1.0f / (18.0f + 2.0f * y);
      gx = 0.0f;
      gy = -2.0f * n * n;
    } else {
      // literal logistic as in the TPU kernel (fused.py:58): expf overflows
      // to inf for y < ~-0.44, where 1 / (1 + inf) is +0 exactly, the right
      // value.  That division's divisor would send it down the IEEE
      // division's slow path (FCHK), so an infinite e divides 1 by 1 and
      // selects +0 instead: the same bits, without the detour.
      const float e = expf(-y / kThck);
      const bool big = e == INFINITY;
      const float q = 1.0f / (big ? 1.0f : 1.0f + e);
      const float sig = big ? 0.0f : q;
      n = kSqrt2 - kSqrt2m1 * sig;
      gx = 0.0f;
      gy = -kSqrt2m1 * sig * (1.0f - sig) / kThck;
    }
  }

  // closed-form Hessians (dynamic.py:78-118); the interface's logistic is
  // the overflow-safe two-branch form of media/fields.py::_sigmoid, both
  // branches exponentiating -|t|
  RT_HD void nag_h(float x, float y, float* f) const {
    if (FIELD == FISHEYE) {
      const float n = 1.0f / (1.0f + x * x + y * y);
      const float n2 = n * n;
      const float c = -2.0f * n2;
      const float n3_8 = 8.0f * n2 * n;
      f[HN] = n;
      f[HGX] = f[HGNX] = c * x;
      f[HGY] = f[HGNY] = c * y;
      f[HXX] = c + n3_8 * x * x;
      f[HXY] = f[HYX] = n3_8 * x * y;
      f[HYY] = c + n3_8 * y * y;
      return;
    }
    float n, gy, hyy;
    if (FIELD == VERT) {
      n = 1.0f / (18.0f + 2.0f * y);
      const float n2 = n * n;
      gy = -2.0f * n2;
      hyy = 8.0f * n2 * n;
    } else {
      const float t = y / kThck;
      const bool pos = t >= 0.0f;
      const float e = expf(pos ? -t : t);
      const float sig = pos ? 1.0f / (1.0f + e) : e / (1.0f + e);
      n = kSqrt2 - kSqrt2m1 * sig;
      const float d = sig * (1.0f - sig);
      gy = -kSqrt2m1 * d / kThck;
      hyy = -kSqrt2m1 * d * (1.0f - 2.0f * sig) / kThck2;
    }
    f[HN] = n;
    f[HGX] = f[HGNX] = f[HXX] = f[HXY] = f[HYX] = 0.0f;
    f[HGY] = f[HGNY] = gy;
    f[HYY] = hyy;
  }
};

// A sampled medium's table on the card and its geometry; x0, inv_hx and nx
// are unused by the 1-D tables.
struct Table {
  const float* __restrict__ t;
  float x0, y0, inv_hx, inv_hy;
  int nx, ny;
};

// The table arguments of a C entry point, and the Table they make
#define RT_TABLE_PARAMS                                                       \
  const void *table, float x0, float y0, float inv_hx, float inv_hy, int nx, \
      int ny
#define RT_TABLE                                                           \
  rt::Table {                                                              \
    static_cast<const float*>(table), x0, y0, inv_hx, inv_hy, nx, ny       \
  }

// jnp.clip(v, lo, hi) = min(max(v, lo), hi)
RT_HD float clampf(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// the k-th float4 of a table row through the read-only cache (a plain load
// on the host)
RT_HD float4 ldg4(const float* p, int k) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const float4*>(p) + k);
#else
  return float4{p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]};
#endif
}
RT_HD float ldg1(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// -- 1-D stratified tables (fused.py:65-105) ---------------------------------
template <int CH>
struct Strat {
  static_assert(CH == 6 || CH == 4, "parity (6) or C1 (4) channels");
  Table m;
  RT_HD void nag(float x, float y, float& n, float& gx, float& gy) const {
    const float fy = clampf((y - m.y0) * m.inv_hy, (float)(m.ny - 1));
    const float iy = fminf(floorf(fy), (float)(m.ny - 2));
    const float uy = fy - iy;
    const float* row = m.t + static_cast<long long>(iy) * 8;
    const float4 a = ldg4(row, 0);
    if (CH == 4) {
      // consistent C1 cubic: n and dn/dy from the same coefficients
      const float c0 = a.x, c1 = a.y, c2 = a.z, c3 = a.w;
      n = c0 + uy * (c1 + uy * (c2 + uy * c3));
      gy = (c1 + uy * (2.0f * c2 + uy * 3.0f * c3)) * m.inv_hy;
    } else {
      const float4 b = ldg4(row, 1);
      const float zlo = a.x, zhi = a.y, c0 = a.z, c1 = a.w, c2 = b.x,
                  c3 = b.y;
      n = (1.0f - uy) * zlo + uy * zhi;
      gy = c0 + uy * (c1 + uy * (c2 + uy * c3));
    }
    gx = 0.0f;
  }

  // the 9 channels (dynamic.py:121-174): C1 gives the cubic's second
  // derivative and gn == g; parity the bilinear n's own slope and the
  // derivative of the cubic gy
  RT_HD void nag_h(float x, float y, float* f) const {
    const float fy = clampf((y - m.y0) * m.inv_hy, (float)(m.ny - 1));
    const float iy = fminf(floorf(fy), (float)(m.ny - 2));
    const float uy = fy - iy;
    const float* row = m.t + static_cast<long long>(iy) * 8;
    const float4 a = ldg4(row, 0);
    f[HGX] = f[HGNX] = f[HXX] = f[HXY] = f[HYX] = 0.0f;
    if (CH == 4) {
      const float c0 = a.x, c1 = a.y, c2 = a.z, c3 = a.w;
      f[HN] = c0 + uy * (c1 + uy * (c2 + uy * c3));
      f[HGY] = f[HGNY] = (c1 + uy * (2.0f * c2 + uy * 3.0f * c3)) * m.inv_hy;
      f[HYY] = (2.0f * c2 + 6.0f * c3 * uy) * (m.inv_hy * m.inv_hy);
    } else {
      const float4 b = ldg4(row, 1);
      const float zlo = a.x, zhi = a.y, c0 = a.z, c1 = a.w, c2 = b.x,
                  c3 = b.y;
      f[HN] = (1.0f - uy) * zlo + uy * zhi;
      f[HGY] = c0 + uy * (c1 + uy * (c2 + uy * c3));
      f[HYY] = (c1 + uy * (2.0f * c2 + uy * 3.0f * c3)) * m.inv_hy;
      f[HGNY] = (zhi - zlo) * m.inv_hy;
    }
  }
};

// -- 2-D grid blends ---------------------------------------------------------
// corners(ch) gives channel ch's 4 corner values (00, +x, +y, +xy) as one
// float4 (x, y, z, w).

// A per-cell row of the _cells36 layout: channel ch is the row's ch-th float4
struct CellCorners {
  const float* c;
  RT_HD float4 operator()(int ch) const {
    return ldg4(c, ch);
  }
};

// Four node rows of the (ny*nx, 9) node table: channel ch is column ch of each
struct NodeCorners {
  const float *c00, *c01, *c10, *c11;
  RT_HD float4 operator()(int ch) const {
    return make_float4(ldg1(c00 + ch), ldg1(c01 + ch), ldg1(c10 + ch),
                       ldg1(c11 + ch));
  }
};

// bilinear n (channel 0) + bicubic Hermite gradients (channels 1-8):
// raytracing_tpu/kernels/fused.py::_hermite_blend (:108-148)
template <class Corners>
RT_HD void hermite_blend(const Corners& corners, float u, float v, float& n,
                         float& gx, float& gy) {
  const float4 z = corners(0);
  n = (1.0f - v) * ((1.0f - u) * z.x + u * z.y) +
      v * ((1.0f - u) * z.z + u * z.w);
  const float v2 = v * v;
  const float v3 = v2 * v;
  const float hv0 = 2.0f * v3 - 3.0f * v2 + 1.0f;
  const float gv0 = v3 - 2.0f * v2 + v;
  const float hv1 = -2.0f * v3 + 3.0f * v2;
  const float gv1 = v3 - v2;
  const float u2 = u * u;
  const float u3 = u2 * u;
  const float hu0 = 2.0f * u3 - 3.0f * u2 + 1.0f;
  const float gu0 = u3 - 2.0f * u2 + u;
  const float hu1 = -2.0f * u3 + 3.0f * u2;
  const float gu1 = u3 - u2;
  float g[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ch0 = 1 + 4 * k;
    const float4 f = corners(ch0), fv = corners(ch0 + 1),
                 fu = corners(ch0 + 2), fw = corners(ch0 + 3);
    g[k] = (f.x * hv0 + fv.x * gv0 + f.z * hv1 + fv.z * gv1) * hu0 +
           (f.y * hv0 + fv.y * gv0 + f.w * hv1 + fv.w * gv1) * hu1 +
           (fu.x * hv0 + fw.x * gv0 + fu.z * hv1 + fw.z * gv1) * gu0 +
           (fu.y * hv0 + fw.y * gv0 + fu.w * hv1 + fw.w * gv1) * gu1;
  }
  gx = g[0];
  gy = g[1];
}

// Hermite basis (h00, h10, h01, h11) and its derivative at t
// (media/hermite.py::hermite_basis, media/c1.py::hermite_dbasis)
struct Basis {
  float h0, g0, h1, g1;
};
RT_HD Basis hermite_basis(float t) {
  const float t2 = t * t;
  const float t3 = t2 * t;
  return {2.0f * t3 - 3.0f * t2 + 1.0f, t3 - 2.0f * t2 + t,
          -2.0f * t3 + 3.0f * t2, t3 - t2};
}
RT_HD Basis hermite_dbasis(float t) {
  const float t2 = t * t;
  return {6.0f * t2 - 6.0f * t, 3.0f * t2 - 4.0f * t + 1.0f,
          -6.0f * t2 + 6.0f * t, 3.0f * t2 - 2.0f * t};
}
// c0*h0 + c1*g0 + c2*h1 + c3*g1 (media/c1.py::_hermite1)
RT_HD float hermite1(float c0, float c1, float c2, float c3, const Basis& b) {
  return c0 * b.h0 + c1 * b.g0 + c2 * b.h1 + c3 * b.g1;
}

RT_HD Basis hermite_d2basis(float t) {
  return {12.0f * t - 6.0f, 6.0f * t - 4.0f, -12.0f * t + 6.0f,
          6.0f * t - 2.0f};
}

// n and grad n of one bicubic patch: media/c1.py::c1_blend
RT_HD void c1_blend(const float* c, float u, float v, float inv_hx,
                    float inv_hy, float& n, float& gx, float& gy) {
  const float4 f = ldg4(c, 0), fv = ldg4(c, 1), fu = ldg4(c, 2),
               fw = ldg4(c, 3);
  const Basis hv = hermite_basis(v), dv = hermite_dbasis(v);
  const Basis hu = hermite_basis(u), du = hermite_dbasis(u);
  // v-blend each corner column pair into cubic-in-u Hermite data
  // (p0, m0, p1, m1)
  const Basis col = {hermite1(f.x, fv.x, f.z, fv.z, hv),
                     hermite1(fu.x, fw.x, fu.z, fw.z, hv),
                     hermite1(f.y, fv.y, f.w, fv.w, hv),
                     hermite1(fu.y, fw.y, fu.w, fw.w, hv)};
  const Basis col_dv = {hermite1(f.x, fv.x, f.z, fv.z, dv),
                        hermite1(fu.x, fw.x, fu.z, fw.z, dv),
                        hermite1(f.y, fv.y, f.w, fv.w, dv),
                        hermite1(fu.y, fw.y, fu.w, fw.w, dv)};
  n = hermite1(col.h0, col.g0, col.h1, col.g1, hu);
  const float gu = hermite1(col.h0, col.g0, col.h1, col.g1, du);
  const float gv = hermite1(col_dv.h0, col_dv.g0, col_dv.h1, col_dv.g1, hu);
  gx = gu * inv_hx;
  gy = gv * inv_hy;
}

// c1_blend plus the patch's symmetric Hessian: media/c1.py::c1_blend_h, the
// 9 channels of dynamic.py::_tile_nag_c1_h (gn == g, hyx == hxy)
RT_HD void c1_blend_h(const float* c, float u, float v, float inv_hx,
                      float inv_hy, float* h) {
  const float4 f = ldg4(c, 0), fv = ldg4(c, 1), fu = ldg4(c, 2),
               fw = ldg4(c, 3);
  const Basis hv = hermite_basis(v), dv = hermite_dbasis(v),
              ddv = hermite_d2basis(v);
  const Basis hu = hermite_basis(u), du = hermite_dbasis(u),
              ddu = hermite_d2basis(u);
  auto vblend = [&](const Basis& b) -> Basis {
    return {hermite1(f.x, fv.x, f.z, fv.z, b),
            hermite1(fu.x, fw.x, fu.z, fw.z, b),
            hermite1(f.y, fv.y, f.w, fv.w, b),
            hermite1(fu.y, fw.y, fu.w, fw.w, b)};
  };
  const Basis col = vblend(hv), col_dv = vblend(dv), col_ddv = vblend(ddv);
  h[HN] = hermite1(col.h0, col.g0, col.h1, col.g1, hu);
  h[HGX] = h[HGNX] = hermite1(col.h0, col.g0, col.h1, col.g1, du) * inv_hx;
  h[HGY] = h[HGNY] =
      hermite1(col_dv.h0, col_dv.g0, col_dv.h1, col_dv.g1, hu) * inv_hy;
  h[HXX] = hermite1(col.h0, col.g0, col.h1, col.g1, ddu) * (inv_hx * inv_hx);
  h[HXY] = h[HYX] = hermite1(col_dv.h0, col_dv.g0, col_dv.h1, col_dv.g1, du) *
                    (inv_hx * inv_hy);
  h[HYY] = hermite1(col_ddv.h0, col_ddv.g0, col_ddv.h1, col_ddv.g1, hu) *
           (inv_hy * inv_hy);
}

// the parity cell's 9 channels (dynamic.py::_tile_nag_h, :177-287): the
// bilinear n and its own gradient, the two independent bicubic gradients
// and their full 2x2 Jacobian (hxy != hyx in general)
RT_HD void hermite_blend_h(const float* c, float u, float v, float inv_hx,
                           float inv_hy, float* h) {
  const float4 z = ldg4(c, 0);
  h[HN] = (1.0f - v) * ((1.0f - u) * z.x + u * z.y) +
          v * ((1.0f - u) * z.z + u * z.w);
  h[HGNX] = ((1.0f - v) * (z.y - z.x) + v * (z.w - z.z)) * inv_hx;
  h[HGNY] = ((1.0f - u) * (z.z - z.x) + u * (z.w - z.y)) * inv_hy;
  const Basis hv = hermite_basis(v), dv = hermite_dbasis(v);
  const Basis hu = hermite_basis(u), du = hermite_dbasis(u);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ch0 = 1 + 4 * k;
    const float4 f = ldg4(c, ch0), fv = ldg4(c, ch0 + 1),
                 fu = ldg4(c, ch0 + 2), fw = ldg4(c, ch0 + 3);
    // the corner columns blended along v (value, then d/dv), then across u
    const float c0 = f.x * hv.h0 + fv.x * hv.g0 + f.z * hv.h1 + fv.z * hv.g1;
    const float c1 = f.y * hv.h0 + fv.y * hv.g0 + f.w * hv.h1 + fv.w * hv.g1;
    const float c2 = fu.x * hv.h0 + fw.x * hv.g0 + fu.z * hv.h1 + fw.z * hv.g1;
    const float c3 = fu.y * hv.h0 + fw.y * hv.g0 + fu.w * hv.h1 + fw.w * hv.g1;
    const float e0 = f.x * dv.h0 + fv.x * dv.g0 + f.z * dv.h1 + fv.z * dv.g1;
    const float e1 = f.y * dv.h0 + fv.y * dv.g0 + f.w * dv.h1 + fv.w * dv.g1;
    const float e2 = fu.x * dv.h0 + fw.x * dv.g0 + fu.z * dv.h1 + fw.z * dv.g1;
    const float e3 = fu.y * dv.h0 + fw.y * dv.g0 + fu.w * dv.h1 + fw.w * dv.g1;
    const float val = c0 * hu.h0 + c1 * hu.h1 + c2 * hu.g0 + c3 * hu.g1;
    const float d_u = c0 * du.h0 + c1 * du.h1 + c2 * du.g0 + c3 * du.g1;
    const float d_v = e0 * hu.h0 + e1 * hu.h1 + e2 * hu.g0 + e3 * hu.g1;
    h[HGX + k] = val;                       // gx, gy
    h[HXX + 2 * k] = d_u * inv_hx;          // hxx, hyx
    h[HXY + 2 * k] = d_v * inv_hy;          // hxy, hyy
  }
}

// -- 2-D grid (engine/segmented.py::_cells, fused.py::_tile_nag) -------------
// The cell of (x, y) on a table's nodes, by JAX's float32 clip/floor/min
// sequence: the in-cell offsets (u, v) and the row index iy * stride + ix
// (stride nx - 1 for a per-cell table, nx for the node table), in 64 bits:
// a user grid may hold more than 2^31 floats.
RT_HD long long locate2(const Table& m, float x, float y, int stride, float& u,
                        float& v) {
  const float fx = clampf((x - m.x0) * m.inv_hx, (float)(m.nx - 1));
  const float fy = clampf((y - m.y0) * m.inv_hy, (float)(m.ny - 1));
  const float ix = fminf(floorf(fx), (float)(m.nx - 2));
  const float iy = fminf(floorf(fy), (float)(m.ny - 2));
  u = fx - ix;
  v = fy - iy;
  return static_cast<long long>(iy) * stride + static_cast<long long>(ix);
}

template <int CELL_CH>
struct Grid {
  static_assert(CELL_CH == 36 || CELL_CH == 16, "parity (36) or C1 (16)");
  Table m;
  RT_HD void nag(float x, float y, float& n, float& gx, float& gy) const {
    float u, v;
    const float* c = m.t + locate2(m, x, y, m.nx - 1, u, v) * CELL_CH;
    if (CELL_CH == 16) {
      c1_blend(c, u, v, m.inv_hx, m.inv_hy, n, gx, gy);
    } else {
      hermite_blend(CellCorners{c}, u, v, n, gx, gy);
    }
  }
  // the same cell lookup, then the 9 channels of the dynamic kernels
  RT_HD void nag_h(float x, float y, float* f) const {
    float u, v;
    const float* c = m.t + locate2(m, x, y, m.nx - 1, u, v) * CELL_CH;
    if (CELL_CH == 16) {
      c1_blend_h(c, u, v, m.inv_hx, m.inv_hy, f);
    } else {
      hermite_blend_h(c, u, v, m.inv_hx, m.inv_hy, f);
    }
  }
};

// -- the parity Hermite node table (media/hermite.py, fused.py::_supercell_nag)
struct Nodes {
  Table m;   // t: the (ny*nx, 9) node table
  RT_HD void nag(float x, float y, float& n, float& gx, float& gy) const {
    float u, v;
    const float* c00 = m.t + locate2(m, x, y, m.nx, u, v) * 9;
    const float* c10 = c00 + static_cast<long long>(m.nx) * 9;
    hermite_blend(NodeCorners{c00, c00 + 9, c10, c10 + 9}, u, v, n, gx, gy);
  }
};

}  // namespace rt
