// The media the step kernels evaluate: each type has one
// nag(x, y, n, gx, gy) giving n and its gradient at (x, y), and the step
// loops of fused.cuh and golden.cuh are templates on the type.  Every
// function is __host__ __device__ (RT_HD, common.cuh): a table row loads
// through __ldg on the card and plainly on the host, so the media also
// build with g++ for the CPU tests of fused.cuh.  The stratified and
// per-cell grid types also have nag_h(x, y, f[9]), the analytic fields
// field_h<FAST>(x, y, f[9], ok): the dynamic kernels' (dynamic.cu) nine
// channels
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
// tile_nag_plain, nodes_nag_plain; kernels/dynamic.py: strat_nag_h,
// tile_nag_h) under -fmad=false.  Three exceptions fuse each product into
// its sum by an explicit fmaf (fma_rn) where JAX rounds the two apart: the
// parity grid's hermite_blend (Grid<36>, Nodes), the analytic fields'
// dynamic channels (Analytic::field_h) and both grids' dynamic blends
// (Grid::nag_h: hermite_blend_h, c1_blend_h, in JAX's order of terms);
// their plain versions (kernels/fused.py::hermite_blend,
// kernels/dynamic.py::field_fn_h and tile_nag_h with fma.mads(True))
// round the same fused operations with utils/fma.py::fma32, so each pair
// stays bit-equal, and JAX is held to the port's tolerances there
// (ROADMAP.md section 3).
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
  // n and grad n.  FAST: each 1 / (...) by its fast path, its guard ANDed
  // into ok (common.cuh), so that a step can test it with its other
  // guards; else the IEEE division.  Both give the same bits where ok
  // holds.
  template <bool FAST>
  RT_HD void field(float x, float y, float& n, float& gx, float& gy,
                   bool& ok) const {
    if (FIELD == FISHEYE) {
      const float d = 1.0f + x * x + y * y;
      n = FAST ? rcp_fast_ge1(d, ok) : 1.0f / d;
      const float c = -2.0f * n * n;
      gx = c * x;
      gy = c * y;
    } else if (FIELD == VERT) {
      const float d = 18.0f + 2.0f * y;
      n = FAST ? rcp_fast(d, ok) : 1.0f / d;
      gx = 0.0f;
      gy = -2.0f * n * n;
    } else {
      // literal logistic as in the TPU kernel (fused.py:58): expf overflows
      // to inf for y < ~-0.44, where 1 / (1 + inf) is +0 exactly, the right
      // value.  That reciprocal's argument would send it down the slow
      // path, so an infinite e takes 1 / 1 and selects +0 instead: the same
      // bits, without the detour.
      const float e = expf(-y / kThck);
      const bool big = e == INFINITY;
      const float d = big ? 1.0f : 1.0f + e;
      const float q = FAST ? rcp_fast_ge1(d, ok) : 1.0f / d;
      const float sig = big ? 0.0f : q;
      n = kSqrt2 - kSqrt2m1 * sig;
      gx = 0.0f;
      gy = -kSqrt2m1 * sig * (1.0f - sig) / kThck;
    }
  }

  RT_HD void nag_fast(float x, float y, float& n, float& gx, float& gy,
                      bool& ok) const {
    field<true>(x, y, n, gx, gy, ok);
  }

  // the same to the bit on every input: where a guard fails, the field
  // again with the IEEE division
  RT_HD void nag(float x, float y, float& n, float& gx, float& gy) const {
    bool ok = true;
    field<true>(x, y, n, gx, gy, ok);
    if (!ok) field<false>(x, y, n, gx, gy, ok);
  }

  // The dynamic kernels' 9 channels, the closed-form Hessians of
  // dynamic.py:78-118, in the FMA form of the analytic dynamic step
  // (dynamic.cuh DynFma): each product that feeds a sum fused into it
  // (fma_rn): the fisheye's 1 + x^2 + y^2 as fma(y, y, fma(x, x, 1)) and c +
  // n3_8 x x as fma(n3_8 x, x, c), vert's 18 + 2 y as fma(2, y, 18), the
  // interface's sqrt2 - (sqrt2 - 1) sig and 1 - 2 sig as fmas.  The
  // interface's logistic is the overflow-safe two-branch form of
  // media/fields.py::_sigmoid, both branches exponentiating -|t|, e / (1 +
  // e) with e = 1 where t >= 0.  FAST: each reciprocal by its fast path
  // (the fisheye's denominator is at least 1, vert's by rcp_fast, the
  // interface's quotient by div_fast_pos), its guard ANDed into ok; else
  // the IEEE divisions.  Both give the same bits where ok holds.  The plain
  // version is kernels/dynamic.py::field_fn_h with fma.mads(True).
  template <bool FAST>
  RT_HD void field_h(float x, float y, float* f, bool& ok) const {
    if (FIELD == FISHEYE) {
      const float d = fma_rn(y, y, fma_rn(x, x, 1.0f));
      const float n = FAST ? rcp_fast_ge1(d, ok) : 1.0f / d;
      const float n2 = n * n;
      const float c = -2.0f * n2;
      const float n3_8 = 8.0f * n2 * n;
      const float n3_8x = n3_8 * x;
      f[HN] = n;
      f[HGX] = f[HGNX] = c * x;
      f[HGY] = f[HGNY] = c * y;
      f[HXX] = fma_rn(n3_8x, x, c);
      f[HXY] = f[HYX] = n3_8x * y;
      f[HYY] = fma_rn(n3_8 * y, y, c);
      return;
    }
    float n, gy, hyy;
    if (FIELD == VERT) {
      const float d = fma_rn(2.0f, y, 18.0f);
      n = FAST ? rcp_fast(d, ok) : 1.0f / d;
      const float n2 = n * n;
      gy = -2.0f * n2;
      hyy = 8.0f * n2 * n;
    } else {
      const float t = y / kThck;
      const bool pos = t >= 0.0f;
      const float e = expf(pos ? -t : t);
      const float num = pos ? 1.0f : e;
      const float d1 = 1.0f + e;
      float sig;
      if (FAST) {
        // where 1 + e rounds to 1 (e below 2^-24, where div_fast_pos's
        // range ends at 2^-100), the quotient is num itself
        bool g = true;
        const float q = div_fast_pos(num, recip_pos(d1), g);
        sig = d1 == 1.0f ? num : q;
        ok = ok & (g | (d1 == 1.0f));
      } else {
        sig = num / d1;
      }
      n = fma_rn(-kSqrt2m1, sig, kSqrt2);
      const float a = -kSqrt2m1 * (sig * (1.0f - sig));
      gy = a / kThck;
      hyy = a * fma_rn(-2.0f, sig, 1.0f) / kThck2;
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

// c0 b0 + c1 b1 + c2 b2 + c3 b3, summed left to right with each product
// fused into its sum: fma(c3, b3, fma(c2, b2, fma(c1, b1, c0 * b0)))
RT_HD float dot4_fma(float c0, float c1, float c2, float c3, float b0,
                     float b1, float b2, float b3) {
  return fma_rn(c3, b3, fma_rn(c2, b2, fma_rn(c1, b1, c0 * b0)));
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

// The cubic Hermite basis (h0, g0, h1, g1) at t in FMA form, t2 = t * t:
// h0 = fma(fma(2, t, -3), t2, 1), g0 = fma(t2, t - 2, t),
// h1 = t2 * fma(-2, t, 3), g1 = t2 * (t - 1)
RT_HD Basis hermite_basis_fma(float t) {
  const float t2 = t * t;
  return {fma_rn(fma_rn(2.0f, t, -3.0f), t2, 1.0f), fma_rn(t2, t - 2.0f, t),
          t2 * fma_rn(-2.0f, t, 3.0f), t2 * (t - 1.0f)};
}

// bilinear n (channel 0) + bicubic Hermite gradients (channels 1-8) of
// raytracing_tpu/kernels/fused.py::_hermite_blend (:108-148), each product
// that feeds a sum fused into it (fma_rn): n as two lerps along u and one
// along v, r0 = fma(u, z01 - z00, z00), r1 = fma(u, z11 - z10, z10),
// n = fma(v, r1 - r0, r0); the bases by hermite_basis_fma; each gradient
// channel's four corner columns blended along v and the four results
// across u by dot4_fma, in the terms' order of _hermite_blend.  The plain
// version (kernels/fused.py::hermite_blend) performs the same operations
// with fma32, so the two agree to the bit; JAX's blend rounds every
// product and sum on its own, which this one is held to within the port's
// tolerances only (ROADMAP.md section 3).
template <class Corners>
RT_HD void hermite_blend(const Corners& corners, float u, float v, float& n,
                         float& gx, float& gy) {
  const float4 z = corners(0);
  const float r0 = fma_rn(u, z.y - z.x, z.x);
  const float r1 = fma_rn(u, z.w - z.z, z.z);
  n = fma_rn(v, r1 - r0, r0);
  const Basis hv = hermite_basis_fma(v), hu = hermite_basis_fma(u);
  float g[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ch0 = 1 + 4 * k;
    const float4 f = corners(ch0), fv = corners(ch0 + 1),
                 fu = corners(ch0 + 2), fw = corners(ch0 + 3);
    const float c00 = dot4_fma(f.x, fv.x, f.z, fv.z, hv.h0, hv.g0, hv.h1,
                               hv.g1);
    const float c01 = dot4_fma(f.y, fv.y, f.w, fv.w, hv.h0, hv.g0, hv.h1,
                               hv.g1);
    const float d00 = dot4_fma(fu.x, fw.x, fu.z, fw.z, hv.h0, hv.g0, hv.h1,
                               hv.g1);
    const float d01 = dot4_fma(fu.y, fw.y, fu.w, fw.w, hv.h0, hv.g0, hv.h1,
                               hv.g1);
    g[k] = dot4_fma(c00, c01, d00, d01, hu.h0, hu.h1, hu.g0, hu.g1);
  }
  gx = g[0];
  gy = g[1];
}

// c0*h0 + c1*g0 + c2*h1 + c3*g1 (media/c1.py::_hermite1)
RT_HD float hermite1(float c0, float c1, float c2, float c3, const Basis& b) {
  return c0 * b.h0 + c1 * b.g0 + c2 * b.h1 + c3 * b.g1;
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

// -- the dynamic grid kernel's blends (Grid::nag_h) -------------------------
// Each product that feeds a sum is fused into it (fma_rn, one FFMA: dynamic.cuh
// DynFma), in JAX's order of terms (dynamic.py::_tile_nag_h, _tile_nag_c1_h,
// media/c1.py::c1_blend_h): with every fma(a, b, c) taken as a b + c rounded
// twice, each expression below is JAX's, since (-a) b + c is c - a b and a
// sum's operands commute.  The plain version (kernels/dynamic.py::tile_nag_h)
// is written once in that form: with fma.mads(True) it rounds as these do
// (utils/fma.py::fma32), with fma.mads(False) as JAX does.

// hermite_basis, hermite_dbasis and hermite_d2basis as JAX writes them, t2 =
// t t, t3 = t2 t, s = 3 t2: (fma(2, t3, -s) + 1, fma(-2, t2, t3) + t,
// fma(-2, t3, s), t3 - t2), (fma(6, t2, -6 t), fma(-4, t, s) + 1,
// fma(-6, t2, 6 t), fma(-2, t, s)), (fma(12, t, -6), fma(6, t, -4),
// fma(-12, t, 6), fma(6, t, -2)).  hermite_basis_fma's Horner form is no
// shorter, and its unfused form is not JAX's.
RT_HD Basis hermite_basis_h(float t) {
  const float t2 = t * t, t3 = t2 * t, s = 3.0f * t2;
  return {fma_rn(2.0f, t3, -s) + 1.0f, fma_rn(-2.0f, t2, t3) + t,
          fma_rn(-2.0f, t3, s), t3 - t2};
}
RT_HD Basis hermite_dbasis_h(float t) {
  const float t2 = t * t, s = 3.0f * t2, t6 = 6.0f * t;
  return {fma_rn(6.0f, t2, -t6), fma_rn(-4.0f, t, s) + 1.0f,
          fma_rn(-6.0f, t2, t6), fma_rn(-2.0f, t, s)};
}
RT_HD Basis hermite_d2basis_h(float t) {
  return {fma_rn(12.0f, t, -6.0f), fma_rn(6.0f, t, -4.0f),
          fma_rn(-12.0f, t, 6.0f), fma_rn(6.0f, t, -2.0f)};
}

// c1_blend plus the patch's symmetric Hessian: media/c1.py::c1_blend_h, the
// 9 channels of dynamic.py::_tile_nag_c1_h (gn == g, hyx == hxy).  The
// corner columns blended along v (value, d/dv, d2/dv2), each blend
// c0 h0 + c1 g0 + c2 h1 + c3 g1 (media/c1.py::_hermite1) by dot4_fma, then
// across u; the u-blends of one column set are taken before the next set
// is formed, so that fewer of the twelve v-blends are live at once.
RT_HD void c1_blend_h(const float* c, float u, float v, float inv_hx,
                      float inv_hy, float* h) {
  const float4 f = ldg4(c, 0), fv = ldg4(c, 1), fu = ldg4(c, 2),
               fw = ldg4(c, 3);
  const Basis hu = hermite_basis_h(u), du = hermite_dbasis_h(u),
              ddu = hermite_d2basis_h(u);
  auto vblend = [&](const Basis& b) -> Basis {
    return {dot4_fma(f.x, fv.x, f.z, fv.z, b.h0, b.g0, b.h1, b.g1),
            dot4_fma(fu.x, fw.x, fu.z, fw.z, b.h0, b.g0, b.h1, b.g1),
            dot4_fma(f.y, fv.y, f.w, fv.w, b.h0, b.g0, b.h1, b.g1),
            dot4_fma(fu.y, fw.y, fu.w, fw.w, b.h0, b.g0, b.h1, b.g1)};
  };
  auto ublend = [](const Basis& col, const Basis& b) {
    return dot4_fma(col.h0, col.g0, col.h1, col.g1, b.h0, b.g0, b.h1, b.g1);
  };
  const Basis col = vblend(hermite_basis_h(v));
  h[HN] = ublend(col, hu);
  h[HGX] = h[HGNX] = ublend(col, du) * inv_hx;
  h[HXX] = ublend(col, ddu) * (inv_hx * inv_hx);
  const Basis col_dv = vblend(hermite_dbasis_h(v));
  h[HGY] = h[HGNY] = ublend(col_dv, hu) * inv_hy;
  h[HXY] = h[HYX] = ublend(col_dv, du) * (inv_hx * inv_hy);
  h[HYY] = ublend(vblend(hermite_d2basis_h(v)), hu) * (inv_hy * inv_hy);
}

// the parity cell's 9 channels (dynamic.py::_tile_nag_h, :177-287): the
// bilinear n and its own gradient, the two independent bicubic gradients
// and their full 2x2 Jacobian (hxy != hyx in general).  n as JAX writes
// it, (1 - v) r0 + v r1 with r0 = (1 - u) z00 + u z01 and r1 likewise, as
// fma(v, r1, (1 - v) r0); each gradient channel's corner columns blended
// along v (value, then d/dv) and across u by dot4_fma in _tile_nag_h's
// order.
RT_HD void hermite_blend_h(const float* c, float u, float v, float inv_hx,
                           float inv_hy, float* h) {
  const float4 z = ldg4(c, 0);
  const float mu = 1.0f - u, mv = 1.0f - v;
  h[HN] = fma_rn(v, fma_rn(u, z.w, mu * z.z), mv * fma_rn(u, z.y, mu * z.x));
  h[HGNX] = fma_rn(v, z.w - z.z, mv * (z.y - z.x)) * inv_hx;
  h[HGNY] = fma_rn(u, z.w - z.y, mu * (z.z - z.x)) * inv_hy;
  const Basis hv = hermite_basis_h(v), dv = hermite_dbasis_h(v);
  const Basis hu = hermite_basis_h(u), du = hermite_dbasis_h(u);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ch0 = 1 + 4 * k;
    const float4 f = ldg4(c, ch0), fv = ldg4(c, ch0 + 1),
                 fu = ldg4(c, ch0 + 2), fw = ldg4(c, ch0 + 3);
    // the corner columns blended along v (value, then d/dv), then across u
    auto vblend = [&](const Basis& b, float* col) {
      col[0] = dot4_fma(f.x, fv.x, f.z, fv.z, b.h0, b.g0, b.h1, b.g1);
      col[1] = dot4_fma(f.y, fv.y, f.w, fv.w, b.h0, b.g0, b.h1, b.g1);
      col[2] = dot4_fma(fu.x, fw.x, fu.z, fw.z, b.h0, b.g0, b.h1, b.g1);
      col[3] = dot4_fma(fu.y, fw.y, fu.w, fw.w, b.h0, b.g0, b.h1, b.g1);
    };
    auto ublend = [](const float* col, const Basis& b) {
      return dot4_fma(col[0], col[1], col[2], col[3], b.h0, b.h1, b.g0, b.g1);
    };
    float cv[4], ev[4];
    vblend(hv, cv);
    vblend(dv, ev);
    h[HGX + k] = ublend(cv, hu);                 // gx, gy
    h[HXX + 2 * k] = ublend(cv, du) * inv_hx;    // hxx, hyx
    h[HXY + 2 * k] = ublend(ev, hu) * inv_hy;    // hxy, hyy
  }
}

// -- 2-D grid (engine/segmented.py::_cells, fused.py::_tile_nag) -------------
// The cell of (x, y) on a table's nodes, by JAX's float32 clip/floor/min
// sequence: the in-cell offsets (u, v) and the row index iy * stride + ix
// (stride nx - 1 for a per-cell table, nx for the node table) in 32 bits;
// the callers widen it as they scale it by the row's floats (one wide
// multiply-add), so a table may hold more than 2^31 floats, but fewer than
// 2^31 rows (table2_fits, which the entry points check).
RT_HD int locate2(const Table& m, float x, float y, int stride, float& u,
                  float& v) {
  const float fx = clampf((x - m.x0) * m.inv_hx, (float)(m.nx - 1));
  const float fy = clampf((y - m.y0) * m.inv_hy, (float)(m.ny - 1));
  const float ix = fminf(floorf(fx), (float)(m.nx - 2));
  const float iy = fminf(floorf(fy), (float)(m.ny - 2));
  u = fx - ix;
  v = fy - iy;
  return static_cast<int>(iy) * stride + static_cast<int>(ix);
}

// whether locate2's 32-bit row index can address every row of a table of
// nx * ny nodes (the node table's nx * ny rows; a per-cell table has fewer)
RT_HD bool table2_fits(int nx, int ny) {
  return static_cast<long long>(nx) * ny < (1LL << 31);
}

template <int CELL_CH>
struct Grid {
  static_assert(CELL_CH == 36 || CELL_CH == 16, "parity (36) or C1 (16)");
  Table m;
  RT_HD void nag(float x, float y, float& n, float& gx, float& gy) const {
    float u, v;
    const int cell = locate2(m, x, y, m.nx - 1, u, v);
    const float* c = m.t + static_cast<long long>(cell) * CELL_CH;
    if (CELL_CH == 16) {
      c1_blend(c, u, v, m.inv_hx, m.inv_hy, n, gx, gy);
    } else {
      hermite_blend(CellCorners{c}, u, v, n, gx, gy);
    }
  }
  // the same cell lookup, then the 9 channels of the dynamic kernels
  RT_HD void nag_h(float x, float y, float* f) const {
    float u, v;
    const int cell = locate2(m, x, y, m.nx - 1, u, v);
    const float* c = m.t + static_cast<long long>(cell) * CELL_CH;
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
    const int node = locate2(m, x, y, m.nx, u, v);
    const float* c00 = m.t + static_cast<long long>(node) * 9;
    const float* c10 = c00 + static_cast<long long>(m.nx) * 9;
    hermite_blend(NodeCorners{c00, c00 + 9, c10, c10 + 9}, u, v, n, gx, gy);
  }
};

}  // namespace rt
