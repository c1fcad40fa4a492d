"""df32 tracing on the sampled media: split-word tables, double-word evaluation.

Port of ``raytracing_tpu/engine/df_grid.py``: the double-word helpers
``_df_add``, ``_df_mul``, ``_split64``, ``_split_scalar`` (df_grid.py:47-70);
the three split-word media and their builders, ``DfGridMedium`` (:73-134),
``DfC1Medium`` (:228-297) and ``DfC1Profile`` (:320-358); their df
evaluators ``_df_cell_coord``, ``_df_horner4``, ``_df_tensor_horner``,
``_make_df_nag``, ``_make_df_c1_nag``, ``_make_df_profile_nag`` and the
angle rate ``_make_df_k`` (:137-391); ``df_grid_trace`` (:399); and the
scan-tier facade ``DfEvalProfile`` / ``df_eval_profile_medium``
(:436-488).

The tables are built in float64 on the host (the native library or
FITPACK, ``media/spline.py::resolve_backend``, as the port's other media)
and split into (hi, lo) float32 words; every
evaluation runs in double-word float32, so the medium the df RK4
integrates is the float64 spline to ~1e-14.  The step is
``kernels/df.py``'s: JAX runs it here at the jnp level in ``fori_loop``
segments; the port runs the same CUDA step loop as the analytic tier,
instantiated on each medium (``df_step_grid``, ``df_step_c1``,
``df_step_profile``), one launch a segment.  Each ray reads its own cell's
row of the whole table (no window), its hi and lo words packed side by
side (:attr:`kernel_tables`).

``DfEvalProfile`` is no kernel medium: it is an ordinary float32
``n_and_grad`` whose values are the correctly rounded float32 of the
float64 interpolant, for the scan tiers (``trace``, ``trace_dynamic``,
``find_eigenrays``), which take it through ``torch.func.jvp`` as they take
a ``CustomMedium``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, ClassVar

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.kernels import df as kdf
from raytracing_tpu_torch.kernels.df import (
    DfState, df_positions, df_recip, fast_two_sum, run_segments, two_prod,
    two_sum)
from raytracing_tpu_torch.media import grid as _grid
from raytracing_tpu_torch.media.c1 import _n_spline_cells
from raytracing_tpu_torch.media.spline import (
    _check_profile, check_uniform_grid, cubic_cells_1d, gradient_tables_f64)


# -- double-word helpers beyond kernels/df.py's (df_grid.py:47-70) -----------
def df_add(ah, al, bh, bl):
    """(a + b) for two df numbers."""
    sh, se = two_sum(ah, bh)
    return fast_two_sum(sh, se + al + bl)


def df_mul(ah, al, bh, bl):
    """(a * b) for two df numbers (low-order cross term dropped)."""
    ph, pe = two_prod(ah, bh)
    return fast_two_sum(ph, pe + ah * bl + al * bh)


def split64(a):
    """float64 array -> (hi, lo) float32 words with hi + lo == a to f64."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def split_scalar(v: float):
    hi = np.float32(v)
    return float(hi), float(np.float32(v - float(hi)))


def _interleave(*pairs) -> torch.Tensor:
    """(rows, 2 k) float32: each (hi, lo) table pair side by side a
    coefficient (h0, l0, h1, l1, ...), the pairs one after another."""
    parts = [torch.stack([h, lo], dim=-1).reshape(h.shape[0], -1)
             for h, lo in pairs]
    return torch.cat(parts, dim=-1).contiguous()


class _DfTables:
    """What the split-word media share: their tensors move together, the
    kernel reads them packed, and a step's state must meet them on one
    device."""

    def to(self, device):
        """This medium with every table on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    def check_device(self, device) -> None:
        for f in dataclasses.fields(self):
            t = getattr(self, f.name)
            if torch.is_tensor(t) and (t.device != device
                                       or t.dtype != torch.float32):
                raise ValueError(
                    f"{type(self).__name__}.{f.name}: need float32 on "
                    f"{device}, got {t.dtype} on {t.device}; move the "
                    "medium with .to(device)")

    def df_k(self):
        return _make_df_k(self)


@dataclasses.dataclass(frozen=True, eq=False)
class DfGridMedium(_DfTables):
    """2-D sampled medium with hi/lo split tables: bilinear n from the
    samples, bicubic dn/dx and dn/dy cells of np.gradient (parity)."""

    KERNEL: ClassVar = kdf.KERNEL_GRID

    Zh: Any          # (ny*nx,) bilinear n samples, hi words
    Zl: Any          # lo words
    cxh: Any         # (ncells, 16) bicubic dn/dx cells, hi
    cxl: Any
    cyh: Any         # (ncells, 16) bicubic dn/dy cells, hi
    cyl: Any
    x0h: float
    x0l: float
    y0h: float
    y0l: float
    ihxh: float      # 1/hx hi/lo
    ihxl: float
    ihyh: float
    ihyl: float
    nx: int
    ny: int

    @functools.cached_property
    def kernel_tables(self):
        """(nodes (ny*nx, 2), cells (ncells, 64)) as ``df_step_grid`` reads
        them: Z's words a node; cx then cy a cell, words interleaved."""
        return (_interleave((self.Zh[:, None], self.Zl[:, None])),
                _interleave((self.cxh, self.cxl), (self.cyh, self.cyl)))

    def kernel_args(self):
        nodes, cells = self.kernel_tables
        return (nodes.data_ptr(), cells.data_ptr(), self.x0h, self.x0l,
                self.y0h, self.y0l, self.ihxh, self.ihxl, self.ihyh,
                self.ihyl, self.nx, self.ny)

    def nag(self):
        return _make_df_nag(self)


def _upload(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def df_grid_medium_from_samples(Z, x, y, *,
                                gradient_spacing: float | None = None,
                                device="cuda") -> DfGridMedium:
    """Parity-pipeline hi/lo split tables from user-measured samples: the
    host pipeline of ``spline.grid_medium_from_samples`` (np.gradient, a
    not-a-knot bicubic fit) kept in float64 and split into double words.
    ``gradient_spacing`` defaults to the mean pitch."""
    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)
    gs = float(gradient_spacing if gradient_spacing is not None
               else 0.5 * (hx + hy))
    cx, cy = gradient_tables_f64(Z, x, y, gs)
    Zh, Zl = split64(Z.reshape(-1))
    cxh, cxl = split64(cx)
    cyh, cyl = split64(cy)
    x0h, x0l = split_scalar(float(x[0]))
    y0h, y0l = split_scalar(float(y[0]))
    ihxh, ihxl = split_scalar(1.0 / hx)
    ihyh, ihyl = split_scalar(1.0 / hy)
    return DfGridMedium(
        Zh=_upload(Zh, device), Zl=_upload(Zl, device),
        cxh=_upload(cxh, device), cxl=_upload(cxl, device),
        cyh=_upload(cyh, device), cyl=_upload(cyl, device),
        x0h=x0h, x0l=x0l, y0h=y0h, y0l=y0l,
        ihxh=ihxh, ihxl=ihxl, ihyh=ihyh, ihyl=ihyl, nx=len(x), ny=len(y))


def build_df_grid_medium(field: str, box, delta: float = config.DELTA, *,
                         device="cuda") -> DfGridMedium:
    """Sample ``field`` and build hi/lo split tables, as
    ``spline.build_grid_medium``: the same grid, np.gradient at the
    reference's nominal DELTA, the same not-a-knot fit."""
    x, y, Z = _grid.gen_grid(field, box, delta)
    return df_grid_medium_from_samples(Z, x, y, gradient_spacing=delta,
                                       device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class DfC1Medium(_DfTables):
    """2-D C1 (consistent-gradient) medium with hi/lo split tables: the
    per-cell power-basis tables of one spline of the samples and its exact
    derivative tables, pre-scaled by 1/hx and 1/hy in float64."""

    KERNEL: ClassVar = kdf.KERNEL_C1

    Ch: Any          # (ncells, 16) n-spline cells, hi words
    Cl: Any
    Cuh: Any         # d/du tables (pre-scaled by 1/hx)
    Cul: Any
    Cvh: Any         # d/dv tables (pre-scaled by 1/hy)
    Cvl: Any
    x0h: float
    x0l: float
    y0h: float
    y0l: float
    ihxh: float
    ihxl: float
    ihyh: float
    ihyl: float
    nx: int
    ny: int

    @functools.cached_property
    def kernel_tables(self):
        """(ncells, 96) as ``df_step_c1`` reads it: C, Cu, Cv a cell."""
        return _interleave((self.Ch, self.Cl), (self.Cuh, self.Cul),
                           (self.Cvh, self.Cvl))

    def kernel_args(self):
        return (self.kernel_tables.data_ptr(), self.x0h, self.x0l, self.y0h,
                self.y0l, self.ihxh, self.ihxl, self.ihyh, self.ihyl,
                self.nx, self.ny)

    def nag(self):
        return _make_df_c1_nag(self)


def df_c1_medium_from_samples(Z, x, y, *, device="cuda") -> DfC1Medium:
    """Consistent-gradient hi/lo split tables from user-measured samples:
    one not-a-knot spline of Z, its exact derivative tables pre-scaled in
    float64, everything split hi/lo."""
    Z, x, y, hx, hy = check_uniform_grid(Z, x, y)
    cells = np.asarray(_n_spline_cells(Z, y, x), np.float64)  # (ncy,ncx,4,4)
    b = np.arange(4, dtype=np.float64)
    cu = np.zeros_like(cells)
    cu[..., :, :3] = cells[..., :, 1:] * b[1:] / hx     # d/du, u-power shift
    cv = np.zeros_like(cells)
    cv[..., :3, :] = cells[..., 1:, :] * b[1:, None] / hy
    Ch, Cl = split64(cells.reshape(-1, 16))
    Cuh, Cul = split64(cu.reshape(-1, 16))
    Cvh, Cvl = split64(cv.reshape(-1, 16))
    x0h, x0l = split_scalar(float(x[0]))
    y0h, y0l = split_scalar(float(y[0]))
    ihxh, ihxl = split_scalar(1.0 / hx)
    ihyh, ihyl = split_scalar(1.0 / hy)
    return DfC1Medium(
        Ch=_upload(Ch, device), Cl=_upload(Cl, device),
        Cuh=_upload(Cuh, device), Cul=_upload(Cul, device),
        Cvh=_upload(Cvh, device), Cvl=_upload(Cvl, device),
        x0h=x0h, x0l=x0l, y0h=y0h, y0l=y0l,
        ihxh=ihxh, ihxl=ihxl, ihyh=ihyh, ihyl=ihyl, nx=len(x), ny=len(y))


def build_df_c1_medium(field: str, box, delta: float = config.DELTA, *,
                       device="cuda") -> DfC1Medium:
    """Sample ``field``, fit the C1 spline, split everything hi/lo."""
    x, y, Z = _grid.gen_grid(field, box, delta)
    return df_c1_medium_from_samples(Z, x, y, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class DfC1Profile(_DfTables):
    """1-D consistent-gradient profile with hi/lo split cells: per-cell
    power coefficients of one not-a-knot cubic of the samples and its exact
    derivative cells pre-scaled by 1/hy in float64."""

    KERNEL: ClassVar = kdf.KERNEL_PROFILE

    Ch: Any          # (ny-1, 4) n-spline cells, hi words
    Cl: Any
    Cvh: Any         # d/dy cells (pre-scaled by 1/hy)
    Cvl: Any
    y0h: float
    y0l: float
    ihyh: float
    ihyl: float
    ny: int

    @functools.cached_property
    def kernel_tables(self):
        """(ny-1, 16) as ``df_step_profile`` reads it: C, then Cv a cell."""
        return _interleave((self.Ch, self.Cl), (self.Cvh, self.Cvl))

    def kernel_args(self):
        return (self.kernel_tables.data_ptr(), self.y0h, self.y0l, self.ihyh,
                self.ihyl, self.ny)

    def nag(self):
        return _make_df_profile_nag(self)


def df_c1_profile_from_samples(samples, y, *, device="cuda") -> DfC1Profile:
    """Split-word C1 profile tables from user-measured (samples, y)."""
    samples, y, hy = _check_profile(samples, y)
    cn = np.asarray(cubic_cells_1d(samples), np.float64)      # (ny-1, 4)
    b = np.arange(4, dtype=np.float64)
    cv = np.zeros_like(cn)
    cv[:, :3] = cn[:, 1:] * b[1:] / hy
    Ch, Cl = split64(cn)
    Cvh, Cvl = split64(cv)
    y0h, y0l = split_scalar(float(y[0]))
    ihyh, ihyl = split_scalar(1.0 / hy)
    return DfC1Profile(Ch=_upload(Ch, device), Cl=_upload(Cl, device),
                       Cvh=_upload(Cvh, device), Cvl=_upload(Cvl, device),
                       y0h=y0h, y0l=y0l, ihyh=ihyh, ihyl=ihyl, ny=len(y))


# -- the df evaluators (df_grid.py:137-391) ----------------------------------
def _df_cell_coord(ph, pl, o_h, o_l, ih_h, ih_l, n):
    """df grid coordinate f = (p - origin) / h, clamped like FITPACK:
    (cell index i as float32, df in-cell offset (uh, ul)).  The constants
    are float32 values before any split (a split of Python floats would
    run in float64 and zero the error word)."""
    th, tl = df_add(ph, pl, kdf._f32(-o_h), kdf._f32(-o_l))
    fh, fl = df_mul(th, tl, kdf._f32(ih_h), kdf._f32(ih_l))
    lim = float(n - 1)
    out = (fh < 0.0) | (fh > lim)
    fh = torch.clamp(fh, 0.0, lim)
    fl = torch.where(out, 0.0, fl)
    i = torch.clamp(torch.floor(fh), max=float(n - 2))
    # fh - i is exact (Sterbenz: fh in [i, i+1]); the lo word rides along
    return i, fh - i, fl


def _df_horner4(c_h, c_l, uh, ul):
    """Cubic df Horner: sum c[k] u^k, coefficients (..., 4) hi/lo."""
    rh, rl = c_h[..., 3], c_l[..., 3]
    for k in (2, 1, 0):
        rh, rl = df_mul(rh, rl, uh, ul)
        rh, rl = df_add(rh, rl, c_h[..., k], c_l[..., k])
    return rh, rl


def _df_tensor_horner(C_h, C_l, uh, ul, vh, vl):
    """Bicubic df Horner: sum C[a, b] v^a u^b, C (..., 16) row-major."""
    rows = [_df_horner4(C_h[..., 4 * a:4 * a + 4], C_l[..., 4 * a:4 * a + 4],
                        uh, ul) for a in range(4)]
    rh, rl = rows[3]
    for a in (2, 1, 0):
        rh, rl = df_mul(rh, rl, vh, vl)
        rh, rl = df_add(rh, rl, *rows[a])
    return rh, rl


def _cell_rows(table, index, blocks, coeffs):
    """Each ray's row of a packed kernel table, as (hi, lo) words of shape
    (..., blocks, coeffs): the table's blocks (one a spline) evaluate in
    one torch call an operation, each element with the kernel's own
    arithmetic."""
    rows = table[index].reshape(*index.shape, blocks, coeffs, 2)
    return rows[..., 0], rows[..., 1]


def _per_block(*words):
    """In-cell offsets broadcast over a row's blocks."""
    return tuple(w[..., None] for w in words)


def _make_df_nag(med: DfGridMedium):
    """df (n, gx, gy): bilinear Z and the bicubic cx/cy cells."""
    nodes, cells = med.kernel_tables

    def nag(pxh, pxl, pyh, pyl):
        ix, uxh, uxl = _df_cell_coord(pxh, pxl, med.x0h, med.x0l,
                                      med.ihxh, med.ihxl, med.nx)
        iy, uyh, uyl = _df_cell_coord(pyh, pyl, med.y0h, med.y0l,
                                      med.ihyh, med.ihyl, med.ny)
        ixi = ix.long()
        iyi = iy.long()
        flat = iyi * med.nx + ixi

        def zc(off):
            z = nodes[flat + off]
            return z[..., 0], z[..., 1]

        z00h, z00l = zc(0)
        z01h, z01l = zc(1)
        z10h, z10l = zc(med.nx)
        z11h, z11l = zc(med.nx + 1)
        # bilinear in df: n = (1-v)((1-u) z00 + u z01) + v((1-u) z10 + u z11)
        cu_h, cu_l = df_add(1.0, 0.0, -uxh, -uxl)
        cv_h, cv_l = df_add(1.0, 0.0, -uyh, -uyl)

        def lerp(ah, al, bh, bl):
            th, tl = df_mul(cu_h, cu_l, ah, al)
            sh, sl = df_mul(uxh, uxl, bh, bl)
            return df_add(th, tl, sh, sl)

        lo_h, lo_l = lerp(z00h, z00l, z01h, z01l)
        hi_h, hi_l = lerp(z10h, z10l, z11h, z11l)
        t1h, t1l = df_mul(cv_h, cv_l, lo_h, lo_l)
        t2h, t2l = df_mul(uyh, uyl, hi_h, hi_l)
        nh, nl = df_add(t1h, t1l, t2h, t2l)

        # gx and gy: the cx and cy bicubics of the cell's row
        gh, gl = _df_tensor_horner(
            *_cell_rows(cells, iyi * (med.nx - 1) + ixi, 2, 16),
            *_per_block(uxh, uxl, uyh, uyl))
        return (nh, nl), (gh[..., 0], gl[..., 0]), (gh[..., 1], gl[..., 1])

    return nag


def _make_df_c1_nag(med: DfC1Medium):
    """df (n, gx, gy): three tensor Horners of one spline (its C, Cu and
    Cv blocks)."""
    cells = med.kernel_tables

    def nag(pxh, pxl, pyh, pyl):
        ix, uxh, uxl = _df_cell_coord(pxh, pxl, med.x0h, med.x0l,
                                      med.ihxh, med.ihxl, med.nx)
        iy, uyh, uyl = _df_cell_coord(pyh, pyl, med.y0h, med.y0l,
                                      med.ihyh, med.ihyl, med.ny)
        cflat = iy.long() * (med.nx - 1) + ix.long()
        h, lo = _df_tensor_horner(*_cell_rows(cells, cflat, 3, 16),
                                  *_per_block(uxh, uxl, uyh, uyl))
        return ((h[..., 0], lo[..., 0]), (h[..., 1], lo[..., 1]),
                (h[..., 2], lo[..., 2]))

    return nag


def _make_df_profile_nag(med: DfC1Profile):
    """df (n, gx, gy): two cubic df Horners of one 1-D spline (its C and
    Cv blocks); gx = 0."""
    cells = med.kernel_tables

    def nag(pxh, pxl, pyh, pyl):
        iy, uyh, uyl = _df_cell_coord(pyh, pyl, med.y0h, med.y0l,
                                      med.ihyh, med.ihyl, med.ny)
        h, lo = _df_horner4(*_cell_rows(cells, iy.long(), 2, 4),
                            *_per_block(uyh, uyl))
        zero = torch.zeros_like(uyh)
        return (h[..., 0], lo[..., 0]), (zero, zero), (h[..., 1], lo[..., 1])

    return nag


def _make_df_k(med):
    """df angle rate k = (u x grad n)/n from the split tables."""
    nag = med.nag()

    def df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl):
        (nh, nl), (gxh, gxl), (gyh, gyl) = nag(pxh, pxl, pyh, pyl)
        ah, al = df_mul(vxh, vxl, gyh, gyl)
        bh, bl = df_mul(vyh, vyl, gxh, gxl)
        ch, cl = df_add(ah, al, -bh, -bl)
        rh, rl = df_recip(nh, nl)
        return df_mul(ch, cl, rh, rl)

    return df_k


def _split_words(a, device):
    """(hi, lo) float32 words of float64 ``a`` on ``device``: a tensor is
    split there (the bits of :func:`split64`), numpy on the host."""
    if torch.is_tensor(a):
        a = a.to(device=device, dtype=torch.float64)
        hi = a.float()
        return hi, (a - hi.double()).float()
    return tuple(torch.as_tensor(w, device=device) for w in split64(a))


def split_state(pos0, theta0, *, device) -> DfState:
    """The launch state of ``df_grid_trace`` (df_grid.py:413-420): the
    float64 position and (cos, sin) of the float64 launch angle, each split
    into hi/lo words; tensors stay on the device."""
    if torch.is_tensor(theta0):
        theta64 = theta0.to(device=device, dtype=torch.float64)
        trig = (torch.cos(theta64), torch.sin(theta64))
    else:
        theta64 = np.asarray(theta0, np.float64)
        trig = (np.cos(theta64), np.sin(theta64))
    if not torch.is_tensor(pos0):
        pos0 = np.asarray(pos0, np.float64)
    return DfState(*(w for a in (pos0[:, 0], pos0[:, 1], *trig)
                     for w in _split_words(a, device)))


def df_grid_trace(pos0, theta0, delta_s, medium, *, steps: int,
                  segment: int | None = 512, device="cuda") -> torch.Tensor:
    """Double-word RK4 through a split-word medium (df_grid.py:399):
    float64 (R, 2) final positions, hi + lo recombined.

    ``medium`` is a :class:`DfGridMedium`, :class:`DfC1Medium` or
    :class:`DfC1Profile` whose tables lie on ``device`` (build it there or
    move it with ``medium.to``).  On the card each segment of at most
    ``segment`` steps is one launch of the medium's kernel; on the CPU the
    plain version runs.  No boundary mask or traveltime: the accuracy tier.
    """
    if not isinstance(medium, (DfGridMedium, DfC1Medium, DfC1Profile)):
        raise ValueError("df_grid_trace needs a DfGridMedium, DfC1Medium or "
                         f"DfC1Profile, got {type(medium).__name__}")
    st = split_state(pos0, theta0, device=device)
    return df_positions(run_segments(st, medium, delta_s, steps, segment))


# -- the df32-evaluated profile behind the plain n_and_grad surface ----------
@dataclasses.dataclass(frozen=True, eq=False)
class DfEvalProfile:
    """An ordinary float32 ``n_and_grad`` medium evaluated through df32
    tables: the split-word profile at float32 query points (zero low
    words), rounded once, so (n, gy) are the correctly rounded float32 of
    the float64 interpolant on any backend.  A scan-tier medium
    (``trace``, ``trace_dynamic``, ``find_eigenrays``), not a kernel one."""

    prof: DfC1Profile

    @property
    def dtype(self):
        return torch.float32

    def to(self, device):
        return DfEvalProfile(prof=self.prof.to(device))

    def n_and_grad(self, x, y):
        nag = self.prof.nag()
        dev = self.prof.Ch.device
        x = torch.as_tensor(x, device=dev).to(torch.float32)
        y = torch.as_tensor(y, device=dev).to(torch.float32)
        zero = torch.zeros_like(y)
        (nh, nl), (gxh, _), (gyh, gyl) = nag(x, zero, y, zero)
        # hi + lo collapses to the correctly rounded float32 of the float64
        # value (the pair is normalized; adding lo folds the half-ulp cases)
        return nh + nl, (gxh, gyh + gyl)

    def n(self, x, y):
        return self.n_and_grad(x, y)[0]


def df_eval_profile_medium(samples, y, *, device="cuda") -> DfEvalProfile:
    """float32 scan-tier medium whose evaluations are float64-grade, from
    user-measured (samples, y): the not-a-knot cubic and the validation of
    ``c1_stratified_from_samples``, the cells kept split-word."""
    return DfEvalProfile(prof=df_c1_profile_from_samples(samples, y,
                                                         device=device))
