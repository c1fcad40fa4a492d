"""Consistent-gradient ("C1") sampled media: n and grad n from ONE spline.

Port of ``raytracing_tpu/media/c1.py``: ``hermite_dbasis`` (c1.py:49),
``hermite_d2basis`` (:56), ``_hermite1`` (:62), ``c1_blend`` (:68),
``c1_blend_h`` (:101), ``C1GridMedium`` (:138), ``C1StratifiedMedium``
(:188), ``_n_spline_cells`` (:289, native or scipy by ``backend``),
``c1_medium_from_samples`` (:305), ``build_c1_medium`` (:331),
``compact_c1_stratified`` (:338), ``c1_stratified_from_samples`` (:377) and
``build_c1_stratified`` (:394).

The reference's sampled pipeline takes n bilinearly from Z but grad n from
independently fitted bicubic splines of ``np.gradient(Z)``
(RT_bench.py:455-458), so grad n is not the derivative of the n the
integrator consumes.  These media fit ONE not-a-knot bicubic spline S to
the samples and evaluate n = S and grad n = the exact derivative of S: 16
numbers a cell instead of the parity form's 36.  They diverge from
reference parity on purpose (docs/PARITY.md in the JAX package).

Layout: per-NODE Hermite data of S, ``(f, f_v, f_u, f_vu)`` in
cell-normalized units, 4 channels a node.  ``c1_blend_h`` adds the patch's
Hessian for the dynamic grid kernel (``kernels/dynamic.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.media import grid as _grid
from raytracing_tpu_torch.media.hermite import (
    _node_data, corner_rows, hermite_basis)
from raytracing_tpu_torch.media.spline import (
    TableMedium, _check_profile, _promoted, _spline_to_cells, _upload,
    cell_index, check_uniform_grid, cubic_cells_1d, resolve_backend,
    stratified_window)


def hermite_dbasis(t):
    """Derivatives (h00', h10', h01', h11') of the Hermite basis at t."""
    t2 = t * t
    return (6.0 * t2 - 6.0 * t, 3.0 * t2 - 4.0 * t + 1.0,
            -6.0 * t2 + 6.0 * t, 3.0 * t2 - 2.0 * t)


def hermite_d2basis(t):
    """Second derivatives (h00'', h10'', h01'', h11'') of the basis at t."""
    return (12.0 * t - 6.0, 6.0 * t - 4.0,
            -12.0 * t + 6.0, 6.0 * t - 2.0)


def _hermite1(c, h):
    """Blend one corner-column stack c = (c0, c1) pairs with basis h."""
    h0, g0, h1, g1 = h
    return c[0] * h0 + c[1] * g0 + c[2] * h1 + c[3] * g1


def c1_blend(corners, u, v, inv_hx, inv_hy):
    """(n, gx, gy) of the C1 spline from a 4-channel corner accessor.

    ``corners(ch) -> (c00, c01, c10, c11)`` fetches channel ``ch``'s 2x2
    corner node values (c01 = +x neighbour, c10 = +y).  One definition
    serves the scan tier's medium and the grid kernel's plain version; the
    CUDA kernel (``c1_blend`` in csrc/media.cuh) keeps its order of
    operations.
    """
    hv, dv = hermite_basis(v), hermite_dbasis(v)
    hu, du = hermite_basis(u), hermite_dbasis(u)
    col = _vblend(corners, hv)
    n = _hermite1(col, hu)
    gu = _hermite1(col, du)
    gv = _hermite1(_vblend(corners, dv), hu)
    return n, gu * inv_hx, gv * inv_hy


def _vblend(corners, basis):
    """v-blend each corner COLUMN pair of the 4-channel patch into
    cubic-in-u Hermite data (p0, m0, p1, m1): p0/p1 = S at the u = 0/1
    edges, m0/m1 = dS/du there (functions of v)."""
    f, fv, fu, fw = (corners(ch) for ch in range(4))
    return (_hermite1((f[0], fv[0], f[2], fv[2]), basis),
            _hermite1((fu[0], fw[0], fu[2], fw[2]), basis),
            _hermite1((f[1], fv[1], f[3], fv[3]), basis),
            _hermite1((fu[1], fw[1], fu[3], fw[3]), basis))


def c1_blend_h(corners, u, v, inv_hx, inv_hy):
    """(n, gx, gy, hxx, hxy, hyy): :func:`c1_blend` plus the Hessian of the
    same bicubic patch, symmetric by construction (c1.py:101-134).  The
    dynamic grid kernel's plain version (``kernels/dynamic.py``) calls it
    with float32-exact ``inv_hx``/``inv_hy``, so the products
    ``inv_hx * inv_hy`` round as the CUDA kernel's do."""
    hv, dv, ddv = hermite_basis(v), hermite_dbasis(v), hermite_d2basis(v)
    hu, du, ddu = hermite_basis(u), hermite_dbasis(u), hermite_d2basis(u)
    col = _vblend(corners, hv)
    col_dv = _vblend(corners, dv)
    n = _hermite1(col, hu)
    gx = _hermite1(col, du) * inv_hx
    gy = _hermite1(col_dv, hu) * inv_hy
    hxx = _hermite1(col, ddu) * (inv_hx * inv_hx)
    hxy = _hermite1(col_dv, du) * (inv_hx * inv_hy)
    hyy = _hermite1(_vblend(corners, ddv), hu) * (inv_hy * inv_hy)
    return n, gx, gy, hxx, hxy, hyy


@dataclasses.dataclass(frozen=True, eq=False)
class C1GridMedium(TableMedium):
    """2-D sampled medium with grad n == the exact gradient of n.

    ``nodes`` is (ny*nx, 4): the Hermite node data ``(f, f_v, f_u, f_vu)``
    of one not-a-knot bicubic spline of the samples.
    """

    nodes: Any       # (ny*nx, 4)
    x0: float
    y0: float
    inv_hx: float
    inv_hy: float
    nx: int
    ny: int
    #: TPU window-sizing bounds, as HermiteGridMedium's; unread here
    n_min: float = 1.0
    g_max: float = 0.0
    kappa_max: float = 0.0

    def n_and_grad(self, x, y):
        """Gather-based evaluation (the scan tier's)."""
        ix, iy, ux, uy = cell_index(x, y, self.x0, self.y0, self.inv_hx,
                                    self.inv_hy, self.nx, self.ny)
        c = corner_rows(_promoted(self.nodes, x), ix, iy, self.nx)

        def corners(ch):
            return tuple(r[..., ch] for r in c)

        n, gx, gy = c1_blend(corners, ux, uy, self.inv_hx, self.inv_hy)
        return n, (gx, gy)


@dataclasses.dataclass(frozen=True, eq=False)
class C1StratifiedMedium(TableMedium):
    """1-D consistent medium for x-independent fields (interface, vert).

    ``cn`` is (ny-1, 4): per-cell power coefficients (normalized offset) of
    one not-a-knot cubic spline of the y-samples; n is the spline, dn/dy
    its exact derivative.
    """

    cn: Any          # (ny-1, 4)
    y0: float
    inv_hy: float
    ny: int

    def n_and_grad(self, x, y):
        fy = torch.clamp((y - self.y0) * self.inv_hy, 0.0, float(self.ny - 1))
        iy = torch.clamp(torch.floor(fy).long(), 0, self.ny - 2)
        uy = fy - iy
        c = _promoted(self.cn, y)[iy]
        n = c[..., 0] + uy * (c[..., 1] + uy * (c[..., 2] + uy * c[..., 3]))
        gy = (c[..., 1] + uy * (2.0 * c[..., 2] + uy * 3.0 * c[..., 3])
              ) * self.inv_hy
        return n, (torch.zeros_like(gy), gy)


def _n_spline_cells(Z, y, x, backend: str = "auto"):
    """Per-cell (ncy, ncx, 4, 4) power coefficients of the not-a-knot
    bicubic interpolant of Z itself (float64; the native library or
    FITPACK, ``backend``)."""
    if resolve_backend(backend) == "native":
        from raytracing_tpu_torch import native
        return native.bicubic_cells(Z)
    from scipy.interpolate import RectBivariateSpline

    return _spline_to_cells(RectBivariateSpline(y, x, Z, kx=3, ky=3), y, x)


def c1_medium_from_samples(Z, x, y, *, device="cuda", dtype=torch.float32,
                           backend: str = "auto") -> C1GridMedium:
    """Consistent-gradient 2-D medium from user index samples (uniform
    grids, >= 4x4, as spline.grid_medium_from_samples)."""
    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)
    nodes = _node_data(_n_spline_cells(Z, y, x, backend))
    ny, nx = nodes.shape[:2]
    return C1GridMedium(
        nodes=_upload(nodes.reshape(ny * nx, 4), dtype, device),
        x0=float(x[0]), y0=float(y[0]), inv_hx=float(1.0 / hx),
        inv_hy=float(1.0 / hy), nx=nx, ny=ny)


def build_c1_medium(field: str, box, delta: float = config.DELTA, *,
                    device="cuda", dtype=torch.float32,
                    backend: str = "auto") -> C1GridMedium:
    """Sample ``field`` on the reference's padded grid, build a C1 medium."""
    x, y, Z = _grid.gen_grid(field, box, delta)
    return c1_medium_from_samples(Z, x, y, device=device, dtype=dtype,
                                  backend=backend)


def compact_c1_stratified(medium: C1StratifiedMedium, margin: int = 2,
                          y_range: tuple[float, float] | None = None
                          ) -> C1StratifiedMedium:
    """Trim a C1 stratified table to its reachable, nontrivial window: the
    C1 twin of :func:`media.spline.compact_stratified`, with the cells'
    constant terms in the place of the node values."""
    cn = medium.cn.detach().cpu().double().numpy()
    win = stratified_window(cn[:, 0], cn[:, 1:], medium.y0, medium.inv_hy,
                            margin, y_range)
    if win is None:
        return medium
    lo, hi = win
    return C1StratifiedMedium(
        cn=medium.cn[lo:hi + 1],
        y0=float(medium.y0 + lo * (1.0 / medium.inv_hy)),
        inv_hy=medium.inv_hy, ny=hi - lo + 2)


def c1_stratified_from_samples(samples, y, *, device="cuda",
                               dtype=torch.float32) -> C1StratifiedMedium:
    """1-D consistent-gradient medium from a user-measured profile: one
    not-a-knot cubic of the (ny,) ``samples`` serves n and dn/dy."""
    samples, y, hy = _check_profile(samples, y)
    return C1StratifiedMedium(
        cn=_upload(cubic_cells_1d(samples), dtype, device),
        y0=float(y[0]), inv_hy=float(1.0 / hy), ny=len(y))


def build_c1_stratified(field: str, box, delta: float = config.DELTA, *,
                        device="cuda", dtype=torch.float32
                        ) -> C1StratifiedMedium:
    """1-D consistent medium for the x-independent fields."""
    if field == "fisheye":
        raise ValueError("fisheye varies in x; use build_c1_medium")
    x, y, Z = _grid.gen_grid(field, box, delta)
    return c1_stratified_from_samples(Z[:, 0], y, device=device, dtype=dtype)

