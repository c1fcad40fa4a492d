"""df32 evaluation of sampled 3-D (tri-Hermite grid3) media.

Port of ``raytracing_tpu/engine/df_grid3.py``: ``_df_scale`` and
``_df_scale_df`` (df_grid3.py:53, :59), ``_df_hermite_bases`` (:65),
``DfC1Medium3`` and ``df_c1_medium3_from_samples`` (:104-151),
``_make_df_nag3`` (:154), ``_regroup``, ``_b_val``, ``_b_d1``, ``_b_d2``
(:237-263), ``_hess3`` (:266), the evaluation under ``_df_nag3_eval``
(:320) and ``DfEvalMedium3`` / ``df_eval_medium3_from_samples``
(:357-398).

The split-word story of ``engine/df_grid.py`` (float64 tables split into
hi/lo float32 words, every evaluation in double-word arithmetic) on the
3-D 8-channel Hermite node layout of ``media/grid3.py``.  The node
pipeline is ``media/grid3.nodes3_f64``, the one the float32
``C1Grid3Medium`` comes from, so the two cannot drift apart.

* :class:`DfC1Medium3` + :func:`df_c1_medium3_from_samples`: the hi/lo
  node tables and a df (n, grad n) evaluator whose value is the float64
  tricubic to ~1e-13 relative.
* :class:`DfEvalMedium3` / :func:`df_eval_medium3_from_samples`: an
  ordinary float32 ``n_and_grad3`` medium whose every evaluation is the
  correctly rounded float32 of the float64 interpolant, for ``trace3d``,
  ``trace_dynamic3`` and ``find_eigenrays3(dtype=torch.float32)``.
  Positions enter with a zero lo word.

The evaluation is JAX's sequential z -> y -> x contraction in df
arithmetic with the Hermite bases evaluated in df, written as whole-tensor
operations: one gather of the 8 corner rows into an (R, 8, 8) tensor, and
every collapse's terms added in JAX's order, so the words equal JAX's run
op for op.  A scan-tier medium (no kernel): its purpose is accuracy, not
throughput.

JAX gives the facade's ``n_and_grad3`` a ``custom_jvp`` whose tangent is
dn = g . dp and dg = H dp with the plain float32 Hessian :func:`_hess3`.
The port's dynamic tier takes tangents from
``engine/dynamic3d.py::_medium_lin3``, whose ``DfEvalMedium3`` branch
contracts the same Hessian, so no autodiff runs through the df contraction.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raytracing_tpu_torch.engine.df_grid import (
    _upload, df_add, df_mul, split64, split_scalar)
from raytracing_tpu_torch.kernels.df import fast_two_sum, two_prod
from raytracing_tpu_torch.media.c1 import hermite_d2basis, hermite_dbasis
from raytracing_tpu_torch.media.grid3 import check_uniform_grid3, nodes3_f64
from raytracing_tpu_torch.media.hermite import hermite_basis


def _f32(v, like) -> torch.Tensor:
    """Float32 constants on ``like``'s device, as JAX's ``jnp.float32(v)``."""
    return torch.as_tensor(np.asarray(v, np.float32), device=like.device)


def _df_scale(ah, al, c):
    """(a * c) for a df number and exact float32 scalars ``c`` (a tensor
    that broadcasts against ``ah``)."""
    ph, pe = two_prod(ah, c)
    return fast_two_sum(ph, pe + al * c)


def _df_scale_df(ah, al, ch, cl):
    """(a * c) for a df number and df scalars (hi, lo float32 tensors)."""
    ph, pe = two_prod(ah, ch)
    return fast_two_sum(ph, pe + al * ch + ah * cl)


#: ``_df_hermite_bases``' eight polynomials h00, h10, h01, h11, g00, g10,
#: g01, g11 as JAX's ``lin`` sums them: a first term (t^3 or t^2) and a
#: second (t^2 or t) for all, a third (1 or t) for h00, h10 and g10
_LIN_A = (2.0, 1.0, -2.0, 1.0, 6.0, 3.0, -6.0, 3.0)
_LIN_B = (-3.0, -2.0, 3.0, -1.0, -6.0, -4.0, 6.0, -2.0)
_LIN_C = (0, 1, 5)


def _df_hermite_bases(th, tl):
    """Value and derivative Hermite bases of df coordinates ``t`` (any
    shape S): ``(B, D)``, each (hi, lo) of shape S + (2, 2) indexed [k][d]
    (channel bit k: 0 value, 1 tangent; corner d), B the value bases h
    and D their derivatives g, all in double-word arithmetic."""
    t2 = df_mul(th, tl, th, tl)
    t3 = df_mul(*t2, th, tl)
    t = (th, tl)
    one = (torch.ones_like(th), torch.zeros_like(th))

    def terms(*parts):
        return tuple(torch.stack([p[w] for p in parts], dim=-1)
                     for w in (0, 1))

    a = terms(*(t3,) * 4, *(t2,) * 4)
    b = terms(*(t2,) * 4, *(t,) * 4)
    c = terms(one, t, one)
    acc = df_add(*_df_scale(*a, _f32(_LIN_A, th)),
                 *_df_scale(*b, _f32(_LIN_B, th)))
    idx = torch.tensor(_LIN_C, device=th.device)
    third = df_add(acc[0][..., idx], acc[1][..., idx],
                   *_df_scale(*c, _f32((1.0, 1.0, 1.0), th)))
    acc = tuple(w.index_copy(-1, idx, u) for w, u in zip(acc, third))
    shape = th.shape + (2, 2)
    # [k][d]: h00, h01 / h10, h11 and g00, g01 / g10, g11
    order_b = torch.tensor((0, 2, 1, 3), device=th.device)
    order_d = order_b + 4
    return (tuple(w[..., order_b].reshape(shape) for w in acc),
            tuple(w[..., order_d].reshape(shape) for w in acc))


@dataclasses.dataclass(frozen=True, eq=False)
class DfC1Medium3:
    """3-D tri-Hermite medium with hi/lo split node tables.

    ``Nh``/``Nl`` are the (nz*ny*nx, 8) Hermite node table of one
    tensor-product not-a-knot tricubic spline (``media/grid3.nodes3_f64``)
    split float64 -> hi + lo float32; channel ``kx + 2 ky + 4 kz``.
    Evaluation reconstructs the float64 interpolant and its exact gradient
    to ~1e-13 relative in double-word float32.
    """

    Nh: Any          # (nz*ny*nx, 8) hi words
    Nl: Any          # lo words
    x0h: float
    x0l: float
    y0h: float
    y0l: float
    z0h: float
    z0l: float
    ihxh: float
    ihxl: float
    ihyh: float
    ihyl: float
    ihzh: float
    ihzl: float
    nx: int
    ny: int
    nz: int

    def nag(self):
        return _make_df_nag3(self)

    def to(self, device):
        """This medium with both word tables on ``device``."""
        return dataclasses.replace(self, Nh=self.Nh.to(device),
                                   Nl=self.Nl.to(device))


def df_c1_medium3_from_samples(F, x, y, z, *, device="cuda") -> DfC1Medium3:
    """Split-word tri-Hermite tables from user-measured 3-D samples
    ``F[iz, iy, ix]`` on the uniform grid of ``x``/``y``/``z``: the df32
    twin of ``media/grid3.c1_medium3_from_samples`` (the same validation
    and float64 node pipeline, split hi/lo instead of cast), on
    ``device``."""
    F, x, y, z, hx, hy, hz = check_uniform_grid3(F, x, y, z)
    Nh, Nl = split64(nodes3_f64(F).reshape(-1, 8))
    words = {}
    for name, v in (("x0", float(x[0])), ("y0", float(y[0])),
                    ("z0", float(z[0])), ("ihx", 1.0 / hx),
                    ("ihy", 1.0 / hy), ("ihz", 1.0 / hz)):
        words[name + "h"], words[name + "l"] = split_scalar(v)
    return DfC1Medium3(Nh=_upload(Nh, device), Nl=_upload(Nl, device),
                       nx=len(x), ny=len(y), nz=len(z), **words)


def _corners(med, cx, cy, cz):
    """Flat row indices (R, 8) of the cells' 8 corners, corner dx + 2 dy +
    4 dz, from the cell indices (float32)."""
    flat = ((cz.long() * med.ny + cy.long()) * med.nx + cx.long())
    sy, sz = med.nx, med.nx * med.ny
    off = torch.tensor([dz * sz + dy * sy + dx for dz in (0, 1)
                        for dy in (0, 1) for dx in (0, 1)],
                       device=flat.device)
    return flat[..., None] + off


def _cell(med, pxh, pxl, pyh, pyl, pzh, pzl):
    """Cell indices and df in-cell offsets of the three axes at once:
    ``engine/df_grid.py::_df_cell_coord`` (clamped like FITPACK) on the
    stacked (..., 3) coordinates, with each axis' constants."""
    ph = torch.stack([pxh, pyh, pzh], -1)
    pl = torch.stack([pxl, pyl, pzl], -1)
    th, tl = df_add(ph, pl, _f32((-med.x0h, -med.y0h, -med.z0h), ph),
                    _f32((-med.x0l, -med.y0l, -med.z0l), ph))
    fh, fl = df_mul(th, tl, _f32((med.ihxh, med.ihyh, med.ihzh), ph),
                    _f32((med.ihxl, med.ihyl, med.ihzl), ph))
    lim = _f32((med.nx - 1, med.ny - 1, med.nz - 1), ph)
    out = (fh < 0.0) | (fh > lim)
    fh = torch.minimum(torch.maximum(fh, torch.zeros_like(fh)), lim)
    fl = torch.where(out, 0.0, fl)
    i = torch.minimum(torch.floor(fh), lim - 1.0)
    # fh - i is exact (Sterbenz: fh in [i, i+1]); the lo word rides along
    return i, fh - i, fl


def _df_sum(terms):
    """Sum df terms (hi, lo) along the leading axis in order: the first
    taken as it is, each next one df-added."""
    acc = (terms[0][0], terms[1][0])
    for j in range(1, terms[0].shape[0]):
        acc = df_add(*acc, terms[0][j], terms[1][j])
    return acc


def _collapse(vals, weights, pairs, pick):
    """One axis' collapse: for each (d, k) of ``pairs`` in order, the df
    product of ``pick(vals, d, k)`` and ``weights[..., k, d]`` (one
    stacked product), df-summed in that order.  ``weights`` (hi, lo)
    broadcast against the picked values."""
    v = [torch.stack([pick(w, d, k) for d, k in pairs]) for w in vals]
    c = [torch.stack([w[..., k, d] for d, k in pairs]) for w in weights]
    return _df_sum(df_mul(*v, *c))


_PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _make_df_nag3(med: DfC1Medium3):
    """df (n, gx, gy, gz) evaluator of the split tri-Hermite tables.

    Sequential z -> y -> x contraction; each axis' collapse uses the df
    value basis except the differentiated axis, which uses the df
    derivative basis and is scaled by that axis' df 1/h.
    """

    def nag(pxh, pxl, pyh, pyl, pzh, pzl):
        i, uh, ul = _cell(med, pxh, pxl, pyh, pyl, pzh, pzl)
        rows = _corners(med, *i.unbind(-1))
        r = rows.shape
        # (..., dz, dy, dx, kz, ky, kx)
        nodes = tuple(t[rows].reshape(r[:-1] + (2,) * 6)
                      for t in (med.Nh, med.Nl))
        B, D = _df_hermite_bases(uh, ul)
        axis = lambda basis, a: tuple(w[..., a, :, :] for w in basis)
        (Bx, By, Bz), (Dx, Dy, Dz) = ([axis(b, a) for a in range(3)]
                                      for b in (B, D))

        def over(*bases):
            """Bases stacked on a new axis after the batch: (..., m, 2, 2)."""
            return tuple(torch.stack([b[w] for b in bases], -3)
                         for w in (0, 1))

        # z: (dz, kz) summed; the value and derivative bases at once,
        # out (..., 2, dy, dx, ky, kx)
        wz = tuple(w[..., None, None, None, None, :, :]
                   for w in over(Bz, Dz))
        zc = _collapse(tuple(v[..., None, :, :, :, :, :, :] for v in nodes),
                       wz, _PAIRS,
                       lambda v, d, k: v[..., d, :, :, k, :, :])
        # y: (dy, ky) summed for (zc_v, By), (zc_v, Dy), (zc_d, By),
        # out (..., 3, dx, kx)
        pick_y = torch.tensor((0, 0, 1), device=rows.device)
        wy = tuple(w[..., None, None, :, :] for w in over(By, Dy, By))
        yc = _collapse(tuple(v.index_select(-5, pick_y) for v in zc), wy,
                       _PAIRS, lambda v, d, k: v[..., d, :, k, :])
        # x: (dx, kx) summed for n (yc_vv, Bx), gx (yc_vv, Dx), gy (yc_vd,
        # Bx), gz (yc_dv, Bx), out (..., 4)
        pick_x = torch.tensor((0, 0, 1, 2), device=rows.device)
        xc = _collapse(tuple(v.index_select(-3, pick_x) for v in yc),
                       over(Bx, Dx, Bx, Bx), _PAIRS,
                       lambda v, d, k: v[..., d, k])
        gh, gl = _df_scale_df(xc[0][..., 1:], xc[1][..., 1:],
                              _f32((med.ihxh, med.ihyh, med.ihzh), pxh),
                              _f32((med.ihxl, med.ihyl, med.ihzl), pxh))
        return ((xc[0][..., 0], xc[1][..., 0]), (gh[..., 0], gl[..., 0]),
                (gh[..., 1], gl[..., 1]), (gh[..., 2], gl[..., 2]))

    return nag


def _regroup(basis):
    """(h00, h10, h01, h11) -> b[k][d]: channel bit k, corner d."""
    h00, h10, h01, h11 = basis
    return ((h00, h01), (h10, h11))


def _b_val(t):
    """The canonical Hermite bases (``media/hermite.hermite_basis``, the
    primal tiers' definition) regrouped."""
    return _regroup(hermite_basis(t))


def _b_d1(t):
    return _regroup(hermite_dbasis(t))


def _b_d2(t):
    return _regroup(hermite_d2basis(t))


def _kd(b):
    """A regrouped basis as one (..., k, d) tensor."""
    return torch.stack([torch.stack(list(bk), -1) for bk in b], -2)


def _hess3(med: DfC1Medium3, x, y, z):
    """Plain float32 Hessian (hxx, hxy, hxz, hyy, hyz, hzz) of the
    tri-Hermite interpolant at float32 points.

    Tangent grade only: the dynamic tier's paraxial tangents are first
    derivatives of the ray map, so float32 rounding here perturbs them at
    O(eps) relative.  It reads the hi node words (the correctly rounded
    float32 of the float64 table) and selects cells as the df contraction
    does (:func:`_cell`), so primal and tangent never straddle a cell
    boundary differently.  Each of the six contractions forms JAX's 64
    terms ``node * ((wz * wy) * wx)`` and adds them in JAX's order
    (corner dz, dy, dx, then channel kz, ky, kx).
    """
    zero = torch.zeros_like(x)
    i, u, _ = _cell(med, x, zero, y, zero, z, zero)
    ux, uy, uz = u.unbind(-1)
    rows = _corners(med, *i.unbind(-1))
    nodes = med.Nh[rows].reshape(rows.shape[:-1] + (64,))

    bases = (_b_val, _b_d1, _b_d2)
    bx, dx, d2x = (_kd(f(ux)) for f in bases)
    by, dy, d2y = (_kd(f(uy)) for f in bases)
    bz, dz, d2z = (_kd(f(uz)) for f in bases)
    # the six contractions' bases on an axis before (k, d)
    wx = torch.stack([d2x, dx, dx, bx, bx, bx], -3)
    wy = torch.stack([by, dy, by, d2y, dy, by], -3)
    wz = torch.stack([bz, bz, dz, bz, dz, d2z], -3)
    # (..., 6, dz, dy, dx, kz, ky, kx) from w[..., k, d]
    z_ = wz.permute(*range(wz.dim() - 2), -1, -2)[..., :, None, None, :,
                                                  None, None]
    y_ = wy.permute(*range(wy.dim() - 2), -1, -2)[..., None, :, None, None,
                                                  :, None]
    x_ = wx.permute(*range(wx.dim() - 2), -1, -2)[..., None, None, :, None,
                                                  None, :]
    w = ((z_ * y_) * x_).reshape(wx.shape[:-2] + (64,))
    terms = nodes[..., None, :] * w
    acc = terms[..., 0]
    for j in range(1, 64):
        acc = acc + terms[..., j]
    ih = _f32((med.ihxh, med.ihyh, med.ihzh), x)
    ihx, ihy, ihz = ih[0], ih[1], ih[2]
    scale = torch.stack([ihx * ihx, ihx * ihy, ihx * ihz, ihy * ihy,
                         ihy * ihz, ihz * ihz])
    return (acc * scale).unbind(-1)


def _df_nag3_eval(med: DfC1Medium3, x, y, z):
    """(n, gx, gy, gz) by the df contraction at float32 points, each
    rounded once to float32."""
    zero = torch.zeros_like(x)
    (nh, nl), (gxh, gxl), (gyh, gyl), (gzh, gzl) = _make_df_nag3(med)(
        x, zero, y, zero, z, zero)
    return nh + nl, gxh + gxl, gyh + gyl, gzh + gzl


@dataclasses.dataclass(frozen=True, eq=False)
class DfEvalMedium3:
    """An ordinary float32 ``n_and_grad3`` medium evaluated through df32
    tables: the split-word tri-Hermite contraction at float32 query points,
    rounded once, so (n, grad n) are the correctly rounded float32 of the
    float64 interpolant on any backend.  A scan-tier medium for
    ``trace3d``, ``trace_dynamic3`` and ``find_eigenrays3`` at float32 (no
    kernel reads it: build the float32 ``C1Grid3Medium`` of the same
    samples for the kernels)."""

    med: DfC1Medium3

    @property
    def dtype(self):
        return torch.float32

    def to(self, device):
        return DfEvalMedium3(med=self.med.to(device))

    def _points(self, *coords):
        dev = self.med.Nh.device
        return [torch.as_tensor(c, device=dev).to(torch.float32)
                for c in coords]

    def n_and_grad3(self, x, y, z):
        n, gx, gy, gz = _df_nag3_eval(self.med, *self._points(x, y, z))
        return n, (gx, gy, gz)

    def hess3(self, x, y, z):
        """The closed-form float32 Hessian (:func:`_hess3`) at the points."""
        return _hess3(self.med, *self._points(x, y, z))

    def n3(self, x, y, z):
        return self.n_and_grad3(x, y, z)[0]


def df_eval_medium3_from_samples(F, x, y, z, *,
                                 device="cuda") -> DfEvalMedium3:
    """Float32 3-D medium whose evaluations are float64 grade, from
    user-measured ``F[iz, iy, ix]`` on the uniform grid of ``x``/``y``/``z``
    (the validation and node pipeline of ``c1_medium3_from_samples``, the
    nodes kept split-word), its tables on ``device``."""
    return DfEvalMedium3(med=df_c1_medium3_from_samples(F, x, y, z,
                                                        device=device))
