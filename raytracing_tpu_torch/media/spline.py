"""Sampled spline media with scipy RectBivariateSpline parity.

Port of ``raytracing_tpu/media/spline.py``: ``_spline_to_cells`` (spline.py:42),
``GridMedium`` (:59), ``StratifiedGridMedium`` (:114), ``cubic_cells_1d``
(:144), the checks ``_check_axis``/``check_uniform_grid``/``_check_profile``
(:163-205), ``stratified_medium_from_samples`` (:207),
``build_stratified_medium`` (:229), ``compact_stratified`` (:244),
``_gradient_tables_f64`` (:294-320), ``build_grid_medium`` (:322) and
``grid_medium_from_samples`` (:340).

The reference evaluates its media through FITPACK: a bilinear
RectBivariateSpline for n and bicubic ones for each gradient component
(RT_bench.py:455-458).  Each fitted spline is converted once on the host
into per-cell polynomial coefficient tables (within a cell the spline *is*
a bicubic, so sampling it on a 4x4 interior stencil and solving the tensor
Vandermonde system recovers it exactly); evaluation is then a cell lookup
plus a tensor Horner.  FITPACK clamps out-of-range queries to the grid
boundary (fpbisp.f), and so do these evaluators.

The tables are built in float64 numpy, by the port's C++ library
(``raytracing_tpu_torch/native``) where g++ builds it and by scipy
otherwise, as the JAX package's ``backend="auto"`` chooses; the 2-D
builders' ``backend=`` forces either.  They go to ``device`` once, at
build, in ``dtype``; :meth:`to` moves a medium.  ``n_and_grad`` takes
tensors on the medium's device and computes in the promoted dtype of the
table and the coordinates, as the JAX media do.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.media import grid as _grid

#: normalized in-cell sample offsets for the exact-fit stencil; strictly
#: interior so every sample unambiguously belongs to its cell.
_STENCIL = np.array([1.0, 3.0, 5.0, 7.0]) / 8.0
#: inverse of the 4x4 Vandermonde at the stencil (u^a for a in 0..3).
_VINV = np.linalg.inv(np.vander(_STENCIL, 4, increasing=True))


class TableMedium:
    """What every sampled medium shares: its tensors move together."""

    def to(self, device):
        """This medium with every table on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


def _upload(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
        device=device, dtype=dtype)


def _promoted(table, x):
    return table.to(torch.promote_types(table.dtype, x.dtype))


def _spline_to_cells(spl, y, x):
    """Per-cell coefficients C[iy, ix, a, b]: S = sum C u_y^a u_x^b.

    u_* are cell-normalized offsets in [0, 1).  ``spl`` is a fitted
    scipy RectBivariateSpline over (y, x).
    """
    hy, hx = y[1] - y[0], x[1] - x[0]
    ncy, ncx = len(y) - 1, len(x) - 1
    ys = (y[:-1, None] + _STENCIL[None, :] * hy).ravel()   # (ncy*4,)
    xs = (x[:-1, None] + _STENCIL[None, :] * hx).ravel()   # (ncx*4,)
    vals = spl(ys, xs, grid=True).reshape(ncy, 4, ncx, 4)
    # Solve V C V^T = S for each cell: C = Vinv S Vinv^T.
    c = np.einsum("pa,iajb,qb->ipjq", _VINV, vals, _VINV)
    return np.ascontiguousarray(np.transpose(c, (0, 2, 1, 3)))  # (ncy,ncx,4,4)


def cell_index(x, y, x0, y0, inv_hx, inv_hy, nx, ny):
    """Clamped cell index (ix, iy) as int64 and in-cell offsets (u, v).

    FITPACK clamps queries to the grid range (fpbisp.f); so do we.
    """
    fx = torch.clamp((x - x0) * inv_hx, 0.0, float(nx - 1))
    fy = torch.clamp((y - y0) * inv_hy, 0.0, float(ny - 1))
    ix = torch.clamp(torch.floor(fx).long(), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).long(), 0, ny - 2)
    return ix, iy, fx - ix, fy - iy


@dataclasses.dataclass(frozen=True, eq=False)
class GridMedium(TableMedium):
    """Grid-sampled medium: bilinear n + bicubic gradient.

    Mirrors the reference's ``(z, grd)`` spline pair (RT_bench.py:435-464,
    141-156) as flat coefficient tables.
    """

    Z: Any            # (ny, nx) index samples, bilinear-interpolated for n
    cx: Any           # (ncy*ncx, 16) bicubic cells of dn/dx
    cy: Any           # (ncy*ncx, 16) bicubic cells of dn/dy
    x0: float
    y0: float
    inv_hx: float
    inv_hy: float
    nx: int
    ny: int

    def n_and_grad(self, x, y):
        ix, iy, ux, uy = cell_index(x, y, self.x0, self.y0, self.inv_hx,
                                    self.inv_hy, self.nx, self.ny)
        Z = _promoted(self.Z, x)
        # bilinear n from Z (== RectBivariateSpline kx=ky=1, RT_bench.py:455)
        z00 = Z[iy, ix]
        z01 = Z[iy, ix + 1]
        z10 = Z[iy + 1, ix]
        z11 = Z[iy + 1, ix + 1]
        n = ((1 - uy) * ((1 - ux) * z00 + ux * z01)
             + uy * ((1 - ux) * z10 + ux * z11))

        # bicubic gradient components (RT_bench.py:456-458)
        flat = iy * (self.nx - 1) + ix
        px = torch.stack([torch.ones_like(ux), ux, ux * ux, ux * ux * ux], -1)
        py = torch.stack([torch.ones_like(uy), uy, uy * uy, uy * uy * uy], -1)
        shape = flat.shape + (4, 4)
        gx = torch.einsum("...ab,...a,...b->...",
                          _promoted(self.cx, x)[flat].reshape(shape), py, px)
        gy = torch.einsum("...ab,...a,...b->...",
                          _promoted(self.cy, x)[flat].reshape(shape), py, px)
        return n, (gx, gy)


@dataclasses.dataclass(frozen=True, eq=False)
class StratifiedGridMedium(TableMedium):
    """1-D grid medium for x-independent fields (interface, vert).

    The tensor-product spline of an x-constant field *is* its 1-D
    y-spline, so a (ny,) value table + (ny-1, 4) cubic cells reproduce the
    reference's 2-D medium with one 1-D lookup per evaluation.
    """

    Zy: Any          # (ny,) index samples along y
    cy: Any          # (ny-1, 4) cubic cells of dn/dy (normalized offsets)
    y0: float
    inv_hy: float
    ny: int

    def n_and_grad(self, x, y):
        fy = torch.clamp((y - self.y0) * self.inv_hy, 0.0, float(self.ny - 1))
        iy = torch.clamp(torch.floor(fy).long(), 0, self.ny - 2)
        uy = fy - iy
        Zy = _promoted(self.Zy, y)
        n = (1 - uy) * Zy[iy] + uy * Zy[iy + 1]
        c = _promoted(self.cy, y)[iy]
        gy = c[..., 0] + uy * (c[..., 1] + uy * (c[..., 2] + uy * c[..., 3]))
        return n, (torch.zeros_like(gy), gy)


def resolve_backend(backend: str) -> str:
    """"auto" -> "native" where the C++ library builds, else "scipy"."""
    if backend not in ("auto", "native", "scipy"):
        raise ValueError(f"backend must be 'auto', 'native' or 'scipy', "
                         f"got {backend!r}")
    if backend == "auto":
        from raytracing_tpu_torch import native
        return "native" if native.available() else "scipy"
    return backend


def cubic_cells_1d(vals: np.ndarray) -> np.ndarray:
    """(ny,) f64 samples -> (ny-1, 4) not-a-knot cubic cells.

    Power-basis coefficients in the normalized in-cell offset: the same fit
    as the 2-D pipeline's y-direction (native builder when present; an
    x-constant bicubic's y-coefficients ARE the 1-D spline's).
    """
    from raytracing_tpu_torch import native

    vals = np.asarray(vals, np.float64)
    if native.available():
        return native.bicubic_cells(np.stack([vals] * 4, -1))[:, 0, :, 0]
    from scipy.interpolate import CubicSpline

    spl = CubicSpline(np.arange(len(vals)), vals, bc_type="not-a-knot")
    return np.stack([spl.c[3], spl.c[2], spl.c[1], spl.c[0]], axis=-1)


def _check_axis(name: str, v: np.ndarray) -> float:
    """Validate one coordinate vector: uniform AND ascending; returns h.

    A descending axis would invert the (y0, inv_h) cell map and every box
    derived from the endpoints, so it is rejected.
    """
    h = float(v[1] - v[0])
    if h <= 0.0:
        raise ValueError(f"{name} grid must be ascending (got pitch {h}); "
                         "flip the axis and the sample rows")
    if not np.allclose(np.diff(v), h, rtol=1e-6, atol=1e-12):
        raise ValueError(f"{name} grid must be uniformly spaced")
    return h


def check_uniform_grid(Z, x, y):
    """Validate user 2-D samples; returns (Z, x, y, hx, hy) as float64."""
    Z = np.asarray(Z, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if Z.shape != (len(y), len(x)):
        raise ValueError(f"Z shape {Z.shape} != (len(y), len(x)) = "
                         f"({len(y)}, {len(x)})")
    if len(x) < 4 or len(y) < 4:
        raise ValueError("bicubic fitting needs at least a 4x4 grid")
    return Z, x, y, _check_axis("x", x), _check_axis("y", y)


def _check_profile(samples, y):
    samples = np.asarray(samples, np.float64)
    y = np.asarray(y, np.float64)
    if samples.ndim != 1 or samples.shape != y.shape:
        raise ValueError(f"samples shape {samples.shape} != y shape "
                         f"{y.shape} (want matching 1-D profiles)")
    if len(y) < 4:
        raise ValueError("cubic fitting needs at least 4 profile samples")
    return samples, y, _check_axis("y", y)


def stratified_medium_from_samples(samples, y, *, device="cuda",
                                   dtype=torch.float32,
                                   gradient_spacing: float | None = None
                                   ) -> StratifiedGridMedium:
    """1-D parity-pipeline medium from a user-measured profile.

    ``samples`` is (ny,) refractive-index values on the uniform coordinate
    vector ``y``.  Evaluation follows the reference pipeline restricted to
    an x-independent field (RT_bench.py:435-464: np.gradient for dn/dy, a
    not-a-knot cubic fit of it, linear interpolation for n).
    """
    samples, y, hy = _check_profile(samples, y)
    gs = float(gradient_spacing if gradient_spacing is not None else hy)
    dndy = np.gradient(samples, gs, edge_order=2)
    return StratifiedGridMedium(
        Zy=_upload(samples, dtype, device),
        cy=_upload(cubic_cells_1d(dndy), dtype, device),
        y0=float(y[0]), inv_hy=float(1.0 / hy), ny=len(y))


def build_stratified_medium(field: str, box, delta: float = config.DELTA, *,
                            device="cuda", dtype=torch.float32
                            ) -> StratifiedGridMedium:
    """1-D sampled medium for the x-independent fields, on the padded grid
    pitch and with the np.gradient edge handling of the 2-D pipeline
    (RT_bench.py:450), along a single column."""
    if field == "fisheye":
        raise ValueError("fisheye varies in x; use build_grid_medium")
    x, y, Z = _grid.gen_grid(field, box, delta)
    return stratified_medium_from_samples(Z[:, 0], y, device=device,
                                          dtype=dtype, gradient_spacing=delta)


def stratified_window(Zy, c, y0, inv_hy, margin, y_range, value_of=None):
    """The (lo, hi) cell window :func:`compact_stratified` keeps, or None.

    ``Zy`` are the node values (the parity form's samples; for the C1 form
    each cell's constant term) and ``c`` the (cells, k) coefficients whose
    nonzero rows mark the varying window.  Shared by both families.
    """
    hy = 1.0 / inv_hy
    lo, hi = 0, len(c) - 1   # cell window
    eps = float(np.finfo(np.float32).eps)
    tol_c = eps * float(np.abs(c).max() or 1.0)
    tol_z = eps * float(Zy.max() - Zy.min() or 1.0)
    nz_c = np.nonzero(np.abs(c).max(1) > tol_c)[0]
    nz_lo = np.nonzero(np.abs(Zy - Zy[0]) > tol_z)[0]
    nz_hi = np.nonzero(np.abs(Zy - Zy[-1]) > tol_z)[0]
    if len(nz_c) and len(nz_lo) and len(nz_hi):
        lo = max(lo, int(min(nz_c.min(), nz_lo.min() - 1)) - margin)
        hi = min(hi, int(max(nz_c.max(), nz_hi.max() + 1)) + margin)
    if y_range is not None:
        y_lo, y_hi = y_range
        lo = max(lo, int(np.floor((y_lo - y0) / hy)) - margin)
        hi = min(hi, int(np.ceil((y_hi - y0) / hy)) + margin)
    lo = max(lo, 0)
    hi = min(hi, len(c) - 1)
    if (lo <= 0 and hi >= len(c) - 1) or hi < lo:
        return None
    return lo, hi


def compact_stratified(medium: StratifiedGridMedium, margin: int = 2,
                       y_range: tuple[float, float] | None = None
                       ) -> StratifiedGridMedium:
    """Trim a stratified table to its reachable, nontrivial window.

    Two trims compose: **constancy** (outside the sigmoid's transition the
    sampled n is constant and the gradient cells are zero to float32
    resolution) and **reachability** (``y_range``: a boxed ray never
    queries beyond the box plus a step).  Exact for every reachable query.
    Returns ``medium`` unchanged when nothing can be trimmed.  The small
    1-D table is read back to the host to find the window; the trimmed
    medium is a slice of the device tables (nothing is uploaded).
    """
    win = stratified_window(medium.Zy.detach().cpu().double().numpy(),
                            medium.cy.detach().cpu().double().numpy(),
                            medium.y0, medium.inv_hy, margin, y_range)
    if win is None:
        return medium
    lo, hi = win
    return StratifiedGridMedium(
        Zy=medium.Zy[lo:hi + 2], cy=medium.cy[lo:hi + 1],
        y0=float(medium.y0 + lo * (1.0 / medium.inv_hy)),
        inv_hy=medium.inv_hy, ny=hi - lo + 2)


def gradient_tables_f64(Z, x, y, gs: float, backend: str = "auto"):
    """(cx, cy) per-cell bicubic tables of np.gradient(Z) in float64, by
    the native library or by FITPACK (``backend``, :func:`resolve_backend`).
    """
    if resolve_backend(backend) == "native":
        from raytracing_tpu_torch import native
        dndx, dndy = native.gradient2(Z, gs)
        return (native.bicubic_cells(dndx).reshape(-1, 16),
                native.bicubic_cells(dndy).reshape(-1, 16))
    from scipy.interpolate import RectBivariateSpline

    dndx, dndy = _grid.gradient_grids(Z, gs)
    sx = RectBivariateSpline(y, x, dndx, kx=3, ky=3)
    sy = RectBivariateSpline(y, x, dndy, kx=3, ky=3)
    cx = _spline_to_cells(sx, y, x).reshape(-1, 16)
    cy = _spline_to_cells(sy, y, x).reshape(-1, 16)
    return cx, cy


def build_grid_medium(field: str, box, delta: float = config.DELTA, *,
                      device="cuda", dtype=torch.float32,
                      backend: str = "auto") -> GridMedium:
    """Sample ``field`` on the padded grid and build its tables: the
    reference pipeline genZ -> np.gradient -> bicubic fit
    (RT_bench.py:1587-1588), with the fit converted to per-cell
    polynomials."""
    x, y, Z = _grid.gen_grid(field, box, delta)
    # the reference differentiates with the NOMINAL pitch regardless of the
    # per-axis linspace spacing (np.gradient(Z, DELTA), RT_bench.py:450)
    return grid_medium_from_samples(Z, x, y, device=device, dtype=dtype,
                                    backend=backend, gradient_spacing=delta)


def grid_medium_from_samples(Z, x, y, *, device="cuda", dtype=torch.float32,
                             backend: str = "auto",
                             gradient_spacing: float | None = None
                             ) -> GridMedium:
    """A 2-D grid medium from user-measured index samples.

    ``Z`` is (ny, nx) refractive-index values on the uniform grid spanned
    by ``x`` (nx,) and ``y`` (ny,).  The result evaluates like the
    reference pipeline applied to those samples: np.gradient
    (edge_order=2), bicubic not-a-knot splines of each component, bilinear
    n (RT_bench.py:435-464).  ``gradient_spacing`` is the step fed to
    np.gradient: the reference uses the nominal DELTA; user grids default
    to their mean pitch.  ``backend``: "native" (the C++ library), "scipy"
    (FITPACK) or "auto" (native where g++ builds it).
    """
    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)
    gs = float(gradient_spacing if gradient_spacing is not None
               else 0.5 * (hx + hy))
    cx, cy = gradient_tables_f64(Z, x, y, gs, backend)
    return GridMedium(
        Z=_upload(Z, dtype, device), cx=_upload(cx, dtype, device),
        cy=_upload(cy, dtype, device),
        x0=float(x[0]), y0=float(y[0]),
        inv_hx=float(1.0 / hx), inv_hy=float(1.0 / hy),
        nx=len(x), ny=len(y))
