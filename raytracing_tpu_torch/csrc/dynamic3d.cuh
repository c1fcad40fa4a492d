// The 3-D dynamic step loop for op1/op2/op6/op8: the fused 3-D kinematic
// step plus the two launch tangents (d pos, d u) along the two transverse
// launch angles, the frame-free det Q = (dpa x dpb) . u, its KMAH sign count
// and the min |det Q| focus locator, templated on the medium (the nag_h of
// fused3d.cuh's Analytic3<FIELD> and Grid3) and the op.  dynamic3d.cu
// instantiates it in the kernels dynamic3d_step and dynamic3d_step_grid;
// what they compute, and what bounds them, is described at the top of
// dynamic3d.cu.
//
// Every function is __host__ __device__ (RT_HD) and includes no CUDA header,
// so the loop also compiles for the host with g++ and the CUDA qualifiers
// stubbed (-ffp-contract=off), and the CPU tests hold it against the plain
// PyTorch version (raytracing_tpu_torch/kernels/dynamic3d.py::
// dynamic3d_step_plain) to the bit.
//
// Every expression keeps the order of operations of JAX's _dyn_step_body3
// (raytracing_tpu/kernels/dynamic3d.py:158-313) and of the plain version:
// no Kahan compensation (JAX adds pos + D plainly, :210); the divisions by
// 60 and 360 of _rot_dcoeffs are IEEE divisions (the plain version divides
// exactly too); 1 / sqrtf where JAX writes lax.rsqrt (:263); 2n * n as
// (2n) * n; the primal values both tangents read are computed once a step;
// the sign of det Q is 0 at 0, as jnp.sign.  Built with -fmad=false.
#pragma once

#include "fused3d.cuh"

namespace rt3 {

constexpr float kDsinc0 = (float)(-1.0 / 6.0);
constexpr float kDvers0 = (float)(-1.0 / 24.0);

struct V3 {
  float x, y, z;
};

RT_HD V3 cross3(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
RT_HD float dot3(const V3& a, const V3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
RT_HD V3 add3(const V3& a, const V3& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
// the symmetric Hessian of h times v
RT_HD V3 hdot3(const H3& h, const V3& v) {
  return {h.hxx * v.x + h.hxy * v.y + h.hxz * v.z,
          h.hxy * v.x + h.hyy * v.y + h.hyz * v.z,
          h.hxz * v.x + h.hyz * v.y + h.hzz * v.z};
}

// What the polynomial rotation of u by r (_rodrigues3v, :131) and its
// differential (_drodrigues3, :141) share: the coefficients of
// fused3d.py::_rot_coeffs and their termwise d/da2 (_rot_dcoeffs, :114)
struct Rot3 {
  V3 u, r, c;   // c = r x u
  float cs, sinc, vers, dcos, dsinc, dvers, rdotu;
};

RT_HD Rot3 rot3(const V3& u, const V3& r) {
  Rot3 p;
  p.u = u;
  p.r = r;
  const float a2 = dot3(r, r);
  p.sinc = 1.0f - a2 * kSixth3 * (1.0f - a2 * 0.05f);
  p.vers = 0.5f * (1.0f - a2 * kTwelfth3 * (1.0f - a2 * kThirtieth3));
  p.cs = 1.0f - a2 * p.vers;
  p.dsinc = kDsinc0 + a2 / 60.0f;
  p.dvers = kDvers0 + a2 / 360.0f;
  p.dcos = -(p.vers + a2 * p.dvers);
  p.c = cross3(r, u);
  p.rdotu = dot3(r, u);
  return p;
}

// u rotated by r
RT_HD V3 rodrigues3v(const Rot3& p) {
  return {p.u.x * p.cs + p.c.x * p.sinc + p.r.x * p.rdotu * p.vers,
          p.u.y * p.cs + p.c.y * p.sinc + p.r.y * p.rdotu * p.vers,
          p.u.z * p.cs + p.c.z * p.sinc + p.r.z * p.rdotu * p.vers};
}

// one component of the differential
RT_HD float drod1(const Rot3& p, float u, float du, float r, float dr,
                  float c, float dc, float drdotu, float da2) {
  return du * p.cs + dc * p.sinc + dr * p.rdotu * p.vers +
         r * drdotu * p.vers +
         da2 * (u * p.dcos + c * p.dsinc + r * p.rdotu * p.dvers);
}

// the differential of the rotation in (u, r) along (du, dr)
RT_HD V3 drodrigues3(const Rot3& p, const V3& du, const V3& dr) {
  const float da2 = 2.0f * dot3(p.r, dr);
  const V3 dc = add3(cross3(dr, p.u), cross3(p.r, du));
  const float drdotu = dot3(dr, p.u) + dot3(p.r, du);
  return {drod1(p, p.u.x, du.x, p.r.x, dr.x, p.c.x, dc.x, drdotu, da2),
          drod1(p, p.u.y, du.y, p.r.y, dr.y, p.c.y, dc.y, drdotu, da2),
          drod1(p, p.u.z, du.z, p.r.z, dr.z, p.c.z, dc.z, drdotu, da2)};
}

// The 25 state values of one ray (the planes of rt3::DSlot3 in
// dynamic3d.cu, JAX's DYN3_TILE_STATE order).
struct Dyn3 {
  V3 pos, u, dpa, dua, dpb, dub;
  float tt, dsim;
  bool active;
  float sgn, kmah, mind, minstep;
};

// The primal of one step that both tangents read.
struct Prim3 {
  V3 u, g, t, k1, um, g2, t2v, k2, u2;
  H3 h, h2;
  Rot3 rot1, rot;
  float n, n2, gu, gum, two_n, two_nn, inv_n, inv_n2, inv;
};

// (dp2, du2) from (dp, du): the step's directional derivative (:215-268)
template <int OP>
RT_HD void advance3(const Prim3& p, float ds, float half, V3& dp, V3& du) {
  constexpr bool kSecond = OP == 6 || OP == 8;
  constexpr bool kRk2 = OP == 2 || OP == 6;
  const V3& u = p.u;
  const float dn = dot3(p.g, dp);
  const V3 dg = hdot3(p.h, dp);
  const float dgu = dot3(dg, u) + dot3(p.g, du);
  const V3 dt = {dg.x - dgu * u.x - p.gu * du.x,
                 dg.y - dgu * u.y - p.gu * du.y,
                 dg.z - dgu * u.z - p.gu * du.z};
  V3 dp2;
  if (kSecond) {
    dp2 = {dp.x + (du.x * ds + (dt.x / p.two_n - p.t.x * dn / p.two_nn) * ds *
                                   ds),
           dp.y + (du.y * ds + (dt.y / p.two_n - p.t.y * dn / p.two_nn) * ds *
                                   ds),
           dp.z + (du.z * ds + (dt.z / p.two_n - p.t.z * dn / p.two_nn) * ds *
                                   ds)};
  } else {
    dp2 = {dp.x + du.x * ds, dp.y + du.y * ds, dp.z + du.z * ds};
  }
  const float dn2 = dot3(p.g2, dp2);
  const V3 dg2 = hdot3(p.h2, dp2);
  V3 du2;
  if (kRk2) {
    const float in = p.inv_n;
    const V3 dk1 = {ds * (dt.x * in - p.t.x * dn * in * in),
                    ds * (dt.y * in - p.t.y * dn * in * in),
                    ds * (dt.z * in - p.t.z * dn * in * in)};
    const V3 dr1 = add3(cross3(du, p.k1), cross3(u, dk1));
    const V3 dum = drodrigues3(p.rot1, du, dr1);
    const float dgum = dot3(dg2, p.um) + dot3(p.g2, dum);
    const V3 dt2 = {dg2.x - dgum * p.um.x - p.gum * dum.x,
                    dg2.y - dgum * p.um.y - p.gum * dum.y,
                    dg2.z - dgum * p.um.z - p.gum * dum.z};
    const float i2 = p.inv_n2;
    const V3 dk2 = {ds * (dt2.x * i2 - p.t2v.x * dn2 * i2 * i2),
                    ds * (dt2.y * i2 - p.t2v.y * dn2 * i2 * i2),
                    ds * (dt2.z * i2 - p.t2v.z * dn2 * i2 * i2)};
    const V3 dr2 = add3(cross3(dum, p.k2), cross3(p.um, dk2));
    const V3 drho = {(dr1.x + dr2.x) * 0.5f, (dr1.y + dr2.y) * 0.5f,
                     (dr1.z + dr2.z) * 0.5f};
    du2 = drodrigues3(p.rot, du, drho);
  } else {
    const V3 dsv = {dn * u.x + p.n * du.x + (dg.x + dg2.x) * half,
                    dn * u.y + p.n * du.y + (dg.y + dg2.y) * half,
                    dn * u.z + p.n * du.z + (dg.z + dg2.z) * half};
    const float proj = dot3(dsv, p.u2);
    du2 = {(dsv.x - proj * p.u2.x) * p.inv, (dsv.y - proj * p.u2.y) * p.inv,
           (dsv.z - proj * p.u2.z) * p.inv};
  }
  dp = dp2;
  du = du2;
}

// -1, 0 or 1, as jnp.sign
RT_HD float sign3f(float v) {
  return static_cast<float>(v > 0.0f) - static_cast<float>(v < 0.0f);
}

// ``steps`` steps of OP on one ray from global step ``offset``:
// _dyn_step_body3 with the ray leaving the loop once it is frozen (box exit
// or the step limit).  That changes nothing: every value the body carries,
// the focus locator's included, changes only under active && in_limit, and
// the global step only grows, so a frozen ray's state stays as it is (the
// resume checks of tests/test_torch_dynamic_kernel3.py and chip_smoke.py
// hold k + (n - k) launches to one).  n, grad n and the Hessian are
// evaluated at the start, as _make_dyn_tile_kernel3 does (:471), so chained
// launches equal one.  box = (x0, x1, y0, y1, z0, z1).
template <class Medium, int OP>
RT_HD void run_dyn3(Dyn3& s, int steps, float ds, float limit, float offset,
                    const float* box, const Medium& m) {
  constexpr bool kSecond = OP == 6 || OP == 8;
  constexpr bool kRk2 = OP == 2 || OP == 6;
  H3 h;
  m.nag_h(s.pos.x, s.pos.y, s.pos.z, h);
  const float dsds_half = ds * ds * 0.5f;
  const float half = ds * 0.5f;

  for (int i = 0; i < steps; ++i) {
    const float gi = (float)i + offset;
    if (!s.active || !(gi < limit)) break;
    const float gstep = gi + 1.0f;

    // -- the primal step ---------------------------------------------------
    Prim3 p;
    p.u = s.u;
    p.h = h;
    p.n = h.n;
    p.g = {h.gx, h.gy, h.gz};
    const V3& u = p.u;
    p.gu = dot3(p.g, u);
    p.t = {p.g.x - p.gu * u.x, p.g.y - p.gu * u.y, p.g.z - p.gu * u.z};
    V3 D;
    if (kSecond) {
      const float half_fac = dsds_half / p.n;
      D = {u.x * ds + p.t.x * half_fac, u.y * ds + p.t.y * half_fac,
           u.z * ds + p.t.z * half_fac};
    } else {
      D = {u.x * ds, u.y * ds, u.z * ds};
    }
    const V3 pos2 = add3(s.pos, D);
    m.nag_h(pos2.x, pos2.y, pos2.z, p.h2);
    p.n2 = p.h2.n;
    p.g2 = {p.h2.gx, p.h2.gy, p.h2.gz};
    p.two_n = 2.0f * p.n;
    p.two_nn = p.two_n * p.n;
    if (kRk2) {
      p.inv_n = 1.0f / p.n;
      p.k1 = {ds * p.t.x * p.inv_n, ds * p.t.y * p.inv_n,
              ds * p.t.z * p.inv_n};
      p.rot1 = rot3(u, cross3(u, p.k1));
      p.um = rodrigues3v(p.rot1);
      p.inv_n2 = 1.0f / p.n2;
      p.gum = dot3(p.g2, p.um);
      p.t2v = {p.g2.x - p.gum * p.um.x, p.g2.y - p.gum * p.um.y,
               p.g2.z - p.gum * p.um.z};
      p.k2 = {ds * p.t2v.x * p.inv_n2, ds * p.t2v.y * p.inv_n2,
              ds * p.t2v.z * p.inv_n2};
      const V3 r2 = cross3(p.um, p.k2);
      const V3& r1 = p.rot1.r;
      p.rot = rot3(u, {(r1.x + r2.x) * 0.5f, (r1.y + r2.y) * 0.5f,
                       (r1.z + r2.z) * 0.5f});
      p.u2 = rodrigues3v(p.rot);
    } else {
      const V3 sv = {p.n * u.x + (p.g.x + p.g2.x) * half,
                     p.n * u.y + (p.g.y + p.g2.y) * half,
                     p.n * u.z + (p.g.z + p.g2.z) * half};
      p.inv = 1.0f / sqrtf(dot3(sv, sv));
      p.u2 = {sv.x * p.inv, sv.y * p.inv, sv.z * p.inv};
    }

    // -- both launch tangents ------------------------------------------------
    advance3<OP>(p, ds, half, s.dpa, s.dua);
    advance3<OP>(p, ds, half, s.dpb, s.dub);

    if (kSecond) {
      const float dist = sqrtf(dot3(D, D));
      s.tt = s.tt + dist * (p.n + p.n2) * 0.5f;
      s.dsim = s.dsim + dist;
    } else {
      s.tt = s.tt + ds * (p.n + p.n2) * 0.5f;
      s.dsim = s.dsim + ds;
    }

    // -- caustic bookkeeping on the global, 1-based step -------------------
    const float det = dot3(cross3(s.dpa, s.dpb), p.u2);
    const float s_new = sign3f(det);
    if (s.sgn != 0.0f && s_new != 0.0f && s_new != s.sgn)
      s.kmah = s.kmah + 1.0f;
    if (s_new != 0.0f) s.sgn = s_new;
    if (gstep > 4.0f && fabsf(det) < s.mind) {
      s.mind = fabsf(det);
      s.minstep = gstep;
    }
    s.pos = pos2;
    s.u = p.u2;
    h = p.h2;
    // strict 6-face exit: the exiting step is kept
    if ((pos2.x > box[1]) | (pos2.x < box[0]) | (pos2.y > box[3]) |
        (pos2.y < box[2]) | (pos2.z > box[5]) | (pos2.z < box[4]))
      s.active = false;
  }
}

}  // namespace rt3
