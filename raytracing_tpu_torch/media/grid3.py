"""Sampled 3-D grid media: tri-Hermite per-node tables (C1 family).

Port of ``raytracing_tpu/media/grid3.py``: ``_CH2D`` (grid3.py:42),
``_axis_tangents`` (:45), ``check_uniform_grid3`` (:61), ``C1Grid3Medium``
(:82) with its gather evaluator ``n_and_grad3`` (:122-153),
``nodes3_f64`` (:159) and ``c1_medium3_from_samples`` (:176); and the
blend of both evaluators, :func:`blend3` (JAX writes it twice, in one
order: grid3.py:141-153 and kernels/fused3d.py:322-328).  The builders
are host numpy/scipy, as the 2-D builders are; the node table becomes a
tensor on ``device``.

One tensor-product not-a-knot tricubic spline S is fitted to the samples;
n = S and grad n = the exact gradient of S.  Per NODE the 8 channels

    (f, f_u, f_v, f_uv, f_w, f_uw, f_vw, f_uvw)        u = x, v = y, w = z

in cell-normalized units (channel bit k set = one derivative along axis k
of (u, v, w)).  Inside a cell the spline is the tricubic polynomial of the
2x2x2 corner nodes' 64 Hermite values.  The scan tier gathers the 8
corner nodes (:meth:`C1Grid3Medium.n_and_grad3`); the fused 3-D kernel
reads the same 64 values from one per-cell row (``engine/tiled3.py::
cells64``) and blends them in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raytracing_tpu_torch.media.c1 import _hermite1, _vblend, hermite_dbasis
from raytracing_tpu_torch.media.hermite import hermite_basis
from raytracing_tpu_torch.media.spline import (
    TableMedium, _check_axis, _promoted, _upload)

#: 2-D c1_blend channel (f, f_v, f_u, f_vu) -> this module's channel index
#: for the w = 0 plane (add 4 for the +w-derivative partner channel)
_CH2D = (0, 2, 1, 3)


def _axis_tangents(F: np.ndarray, axis: int) -> np.ndarray:
    """Nodal derivatives of the not-a-knot cubic spline along ``axis``, in
    index units (grid pitch 1): directly the cell-normalized Hermite
    tangent.  Vectorized over every other axis."""
    from scipy.interpolate import CubicSpline

    Fm = np.moveaxis(np.asarray(F, np.float64), axis, 0)
    t = np.arange(Fm.shape[0], dtype=np.float64)
    d = CubicSpline(t, Fm, bc_type="not-a-knot")(t, 1)
    return np.moveaxis(d, 0, axis)


def blend3(val, ux, uy, uz, inv_hx, inv_hy, inv_hz):
    """(n, gx, gy, gz) of one tricubic patch from its 64 Hermite values,
    ``val(ch, corner)`` (channel as in the module docstring, corner
    dx + 2*dy + 4*dz).

    The w (z) axis collapses first — each of the four xy corners blends its
    z-pair of (value, w-tangent) channel pairs into 2-D Hermite data, once
    with the value basis and once with the derivative basis — then the 2-D
    C1 blend of media/c1.c1_blend finishes: n, gx and gy from the value
    collapse, gz the value of the derivative collapse.  Each collapse, and
    each basis, is computed once.  One definition serves the scan tier's
    corner gather and the fused 3-D kernel's row read
    (kernels/fused3d.py::tile_nag3_plain), which therefore agree to the bit;
    csrc/fused3d.cuh (``Grid3::nag``) keeps its order.
    """
    def wblend(basis):
        q = tuple(
            tuple(_hermite1((val(b, k), val(b + 4, k), val(b, k + 4),
                             val(b + 4, k + 4)), basis) for k in range(4))
            for b in _CH2D)
        return q.__getitem__

    hv, dv = hermite_basis(uy), hermite_dbasis(uy)
    hu, du = hermite_basis(ux), hermite_dbasis(ux)
    q = wblend(hermite_basis(uz))
    col = _vblend(q, hv)
    n = _hermite1(col, hu)
    gx = _hermite1(col, du) * inv_hx
    gy = _hermite1(_vblend(q, dv), hu) * inv_hy
    gz = _hermite1(_vblend(wblend(hermite_dbasis(uz)), hv), hu) * inv_hz
    return n, gx, gy, gz


def check_uniform_grid3(F, x, y, z):
    """Validate user 3-D samples; returns (F, x, y, z, hx, hy, hz) as f64.

    ``F`` is indexed ``[iz, iy, ix]``, the 3-D extension of the 2-D
    convention Z[iy, ix] (media/spline.check_uniform_grid).
    """
    F = np.asarray(F, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    if F.shape != (len(z), len(y), len(x)):
        raise ValueError(f"F shape {F.shape} != (len(z), len(y), len(x)) = "
                         f"({len(z)}, {len(y)}, {len(x)})")
    if min(len(x), len(y), len(z)) < 4:
        raise ValueError("tricubic fitting needs at least a 4x4x4 grid")
    return (F, x, y, z, _check_axis("x", x), _check_axis("y", y),
            _check_axis("z", z))


@dataclasses.dataclass(frozen=True, eq=False)
class C1Grid3Medium(TableMedium):
    """3-D sampled medium with grad n == the exact gradient of n.

    ``nodes`` is (nz*ny*nx, 8): the Hermite node data of one tensor-product
    not-a-knot tricubic spline of the samples, channels as in the module
    docstring.  Queries clamp to the grid range (the FITPACK convention of
    every sampled medium).  ``n_min`` and ``g_max`` are JAX's diagnostics
    (nodal minimum of n, nodal maximum of |grad n|); nothing reads them.
    """

    nodes: Any       # (nz*ny*nx, 8)
    x0: float
    y0: float
    z0: float
    inv_hx: float
    inv_hy: float
    inv_hz: float
    nx: int
    ny: int
    nz: int
    n_min: float = 1.0
    g_max: float = 0.0

    def _cell(self, x, y, z):
        fx = torch.clamp((x - self.x0) * self.inv_hx, 0.0, float(self.nx - 1))
        fy = torch.clamp((y - self.y0) * self.inv_hy, 0.0, float(self.ny - 1))
        fz = torch.clamp((z - self.z0) * self.inv_hz, 0.0, float(self.nz - 1))
        ix = torch.clamp(torch.floor(fx).long(), 0, self.nx - 2)
        iy = torch.clamp(torch.floor(fy).long(), 0, self.ny - 2)
        iz = torch.clamp(torch.floor(fz).long(), 0, self.nz - 2)
        return ix, iy, iz, fx - ix, fy - iy, fz - iz

    def n_and_grad3(self, x, y, z):
        """Gather-based evaluation (scan tier): 8 corner nodes x 8
        channels, blended by :func:`blend3`."""
        ix, iy, iz, ux, uy, uz = self._cell(x, y, z)
        nodes = _promoted(self.nodes, x)
        flat = (iz * self.ny + iy) * self.nx + ix
        sy, sz = self.nx, self.nx * self.ny
        # corner index dx + 2*dy + 4*dz
        cs = [nodes[flat + dz * sz + dy * sy + dx]
              for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        n, gx, gy, gz = blend3(lambda ch, k: cs[k][..., ch], ux, uy, uz,
                               self.inv_hx, self.inv_hy, self.inv_hz)
        return n, (gx, gy, gz)

    def n3(self, x, y, z):
        return self.n_and_grad3(x, y, z)[0]


def nodes3_f64(F: np.ndarray) -> np.ndarray:
    """Float64 Hermite node table (nz, ny, nx, 8) of validated samples:
    channel index kx + 2*ky + 4*kz, bit k = one derivative along that
    axis (the tensor-product tangent pipeline of grid3.py:159)."""
    fu = _axis_tangents(F, 2)
    fv = _axis_tangents(F, 1)
    fw = _axis_tangents(F, 0)
    fuv = _axis_tangents(fu, 1)
    fuw = _axis_tangents(fu, 0)
    fvw = _axis_tangents(fv, 0)
    fuvw = _axis_tangents(fuv, 0)
    return np.stack([F, fu, fv, fuv, fw, fuw, fvw, fuvw], axis=-1)


def c1_medium3_from_samples(F, x, y, z, *, device="cuda",
                            dtype=torch.float32) -> C1Grid3Medium:
    """Tri-Hermite 3-D medium from user-measured index samples.

    ``F`` is (nz, ny, nx) refractive-index values on the uniform grid
    spanned by the coordinate vectors ``x``/``y``/``z``: the 3-D
    counterpart of :func:`media.c1.c1_medium_from_samples`, traceable by
    :func:`engine.trace3d.trace3d` and :func:`engine.fast.fast_trace3`.
    """
    F, x, y, z, hx, hy, hz = check_uniform_grid3(F, x, y, z)
    nodes = nodes3_f64(F)
    fu, fv, fw = nodes[..., 1], nodes[..., 2], nodes[..., 4]
    inv_hx, inv_hy, inv_hz = 1.0 / hx, 1.0 / hy, 1.0 / hz
    g_nodes = np.sqrt((fu * inv_hx) ** 2 + (fv * inv_hy) ** 2
                      + (fw * inv_hz) ** 2)
    nz_, ny_, nx_ = F.shape
    return C1Grid3Medium(
        nodes=_upload(nodes.reshape(nz_ * ny_ * nx_, 8), dtype, device),
        x0=float(x[0]), y0=float(y[0]), z0=float(z[0]),
        inv_hx=float(inv_hx), inv_hy=float(inv_hy), inv_hz=float(inv_hz),
        nx=nx_, ny=ny_, nz=nz_,
        n_min=float(max(F.min(), 1e-6)), g_max=float(g_nodes.max()))
