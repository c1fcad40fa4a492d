"""Hermite node form of the 2-D grid medium: the kernels' layout.

Port of ``raytracing_tpu/media/hermite.py``: ``_node_data`` (hermite.py:35),
``HermiteGridMedium`` (:77) with its gather-based ``n_and_grad``,
``hermite_basis`` (:135), ``_hermite2d`` (:143) and ``build_hermite_medium``
(:196).

A C1 piecewise-bicubic spline is determined inside each cell by the values
and normalized derivatives ``(f, df/dv, df/du, d2f/dvdu)`` at its four
corner nodes (the cubic Hermite form).  Packed channel layout, one row per
node, ``(ny*nx, 9)``:

    0: Z            (sampled n; bilinear interpolation needs values only)
    1-4: dn/dx spline  f, f_v, f_u, f_vu   (v = normalized y, u = x)
    5-8: dn/dy spline  f, f_v, f_u, f_vu

``kappa_cell_bound`` and the ``n_min``/``g_max``/``kappa_max`` fields size
the TPU tier's window margins; the port has no windows, so the fields are
carried across from a JAX medium (:mod:`raytracing_tpu_torch.interop`) and
nothing reads them, and the builder leaves them at their defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raytracing_tpu_torch.media.spline import (
    GridMedium, TableMedium, _upload, cell_index)


def _node_data(cells: np.ndarray) -> np.ndarray:
    """(ncy, ncx, 4, 4) power-basis cells -> (ncy+1, ncx+1, 4) node data.

    Node (I, J) takes (f, f_v, f_u, f_vu) from the adjacent cell
    (min(I, ncy-1), min(J, ncx-1)) at in-cell offsets (I - ciy, J - cix)
    in {0, 1}; C1 continuity of the source spline makes the choice of
    adjacent cell immaterial.  Host numpy, summed by ``np.einsum`` in the
    JAX package's order, so the node data equal JAX's to the bit.
    """
    ncy, ncx = cells.shape[:2]
    out = np.empty((ncy + 1, ncx + 1, 4), cells.dtype)

    def powers(t):
        return (np.array([1.0, t, t * t, t ** 3], cells.dtype),
                np.array([0.0, 1.0, 2.0 * t, 3.0 * t * t], cells.dtype))

    p0, d0 = powers(0.0)
    p1, d1 = powers(1.0)
    # interior + bottom/left edge nodes from their own cell at offset 0
    out[:ncy, :ncx, 0] = np.einsum("yxab,a,b->yx", cells, p0, p0)
    out[:ncy, :ncx, 1] = np.einsum("yxab,a,b->yx", cells, d0, p0)
    out[:ncy, :ncx, 2] = np.einsum("yxab,a,b->yx", cells, p0, d0)
    out[:ncy, :ncx, 3] = np.einsum("yxab,a,b->yx", cells, d0, d0)
    # top row from the last cell row at v = 1
    out[ncy, :ncx, 0] = np.einsum("xab,a,b->x", cells[-1], p1, p0)
    out[ncy, :ncx, 1] = np.einsum("xab,a,b->x", cells[-1], d1, p0)
    out[ncy, :ncx, 2] = np.einsum("xab,a,b->x", cells[-1], p1, d0)
    out[ncy, :ncx, 3] = np.einsum("xab,a,b->x", cells[-1], d1, d0)
    # right column at u = 1
    out[:ncy, ncx, 0] = np.einsum("yab,a,b->y", cells[:, -1], p0, p1)
    out[:ncy, ncx, 1] = np.einsum("yab,a,b->y", cells[:, -1], d0, p1)
    out[:ncy, ncx, 2] = np.einsum("yab,a,b->y", cells[:, -1], p0, d1)
    out[:ncy, ncx, 3] = np.einsum("yab,a,b->y", cells[:, -1], d0, d1)
    # far corner at (1, 1)
    c = cells[-1, -1]
    out[ncy, ncx, 0] = np.einsum("ab,a,b->", c, p1, p1)
    out[ncy, ncx, 1] = np.einsum("ab,a,b->", c, d1, p1)
    out[ncy, ncx, 2] = np.einsum("ab,a,b->", c, p1, d1)
    out[ncy, ncx, 3] = np.einsum("ab,a,b->", c, d1, d1)
    return out


def corner_rows(nodes, ix, iy, nx):
    """The four corner node rows (00, +x, +y, +xy) of cells (ix, iy)."""
    flat = iy * nx + ix
    return nodes[flat], nodes[flat + 1], nodes[flat + nx], nodes[flat + nx + 1]


@dataclasses.dataclass(frozen=True, eq=False)
class HermiteGridMedium(TableMedium):
    """2-D grid medium in packed Hermite node form.

    Evaluates identically to the source :class:`GridMedium` (same spline,
    another representation).  ``nodes`` is (ny*nx, 9), channels as in the
    module docstring.
    """

    nodes: Any       # (ny*nx, 9)
    x0: float
    y0: float
    inv_hx: float
    inv_hy: float
    nx: int
    ny: int
    #: TPU window-sizing bounds (see the module docstring); unread here
    n_min: float = 1.0
    g_max: float = 0.0
    kappa_max: float = 0.0

    def n_and_grad(self, x, y):
        """Gather-based evaluation (the scan tier's)."""
        ix, iy, ux, uy = cell_index(x, y, self.x0, self.y0, self.inv_hx,
                                    self.inv_hy, self.nx, self.ny)
        nodes = self.nodes.to(torch.promote_types(self.nodes.dtype, x.dtype))
        c00, c01, c10, c11 = corner_rows(nodes, ix, iy, self.nx)
        n = ((1 - uy) * ((1 - ux) * c00[..., 0] + ux * c01[..., 0])
             + uy * ((1 - ux) * c10[..., 0] + ux * c11[..., 0]))
        gx = _hermite2d(c00[..., 1:5], c01[..., 1:5], c10[..., 1:5],
                        c11[..., 1:5], uy, ux)
        gy = _hermite2d(c00[..., 5:9], c01[..., 5:9], c10[..., 5:9],
                        c11[..., 5:9], uy, ux)
        return n, (gx, gy)


def hermite_basis(t):
    """(h00, h10, h01, h11) at t — value/derivative blending weights."""
    t2 = t * t
    t3 = t2 * t
    return (2 * t3 - 3 * t2 + 1, t3 - 2 * t2 + t,
            -2 * t3 + 3 * t2, t3 - t2)


def _hermite2d(c00, c01, c10, c11, v, u):
    """Bicubic Hermite from 4-corner (f, f_v, f_u, f_vu) stacks."""
    hv0, gv0, hv1, gv1 = hermite_basis(v)
    hu0, gu0, hu1, gu1 = hermite_basis(u)

    def corner(c, hv, gv, hu, gu):
        return (c[..., 0] * hv * hu + c[..., 1] * gv * hu
                + c[..., 2] * hv * gu + c[..., 3] * gv * gu)

    return (corner(c00, hv0, gv0, hu0, gu0) + corner(c01, hv0, gv0, hu1, gu1)
            + corner(c10, hv1, gv1, hu0, gu0) + corner(c11, hv1, gv1, hu1, gu1))


def build_hermite_medium(gm: GridMedium,
                         dtype=torch.float32) -> HermiteGridMedium:
    """Convert a GridMedium's per-cell tables to packed Hermite node form:
    built in float64 on the host, uploaded to the medium's own device."""
    ny, nx = gm.ny, gm.nx

    def host(t):
        return t.double().cpu().numpy()

    nodes = np.empty((ny, nx, 9), np.float64)
    nodes[..., 0] = host(gm.Z)
    nodes[..., 1:5] = _node_data(host(gm.cx).reshape(ny - 1, nx - 1, 4, 4))
    nodes[..., 5:9] = _node_data(host(gm.cy).reshape(ny - 1, nx - 1, 4, 4))
    return HermiteGridMedium(
        nodes=_upload(nodes.reshape(ny * nx, 9), dtype, gm.Z.device),
        x0=gm.x0, y0=gm.y0, inv_hx=gm.inv_hx, inv_hy=gm.inv_hy, nx=nx, ny=ny)
