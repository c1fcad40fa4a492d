"""Fused integrators op1/2/3/4/6/7/8/12 on analytic and sampled media.

Port of ``raytracing_tpu/kernels/fused.py``: ``FUSED_FIELDS``/``FUSED_OPS``
(fused.py:38-39), the analytic ``_field_fn`` (:44), the stratified-table
evaluator ``_strat_nag`` (:65), ``_hermite_blend`` (:108), the per-cell
grid evaluator ``_tile_nag`` (:205) without its window, ``strat_tables``
(:286), the step of ``_make_kernel`` (:336) in its resume form,
``FusedFinal`` (:713), ``fused_trace_final`` (:769) and
``fused_trace_final_strat`` (:847); the supercell evaluator
``_supercell_nag`` (:151) on the whole node table, and the per-block scalar
rows of ``_make_kernel(per_block_scal=True)`` (:365-370, :401-407) as
per-ray arrays; and the resume state layout of ``engine/segmented.py``
(``_initial_comps`` :66, ``_final_from_state`` :99), whose launchers
(segmented.py:165, :778, :968, :1581) chain the same kernel.

The medium is an argument of the step, as JAX's ``nag`` injection
(``_make_kernel(strat=, tile=, custom=)``, fused.py:336-340): ``field`` is
an analytic field name, a :class:`StratTables`, a :class:`GridTables`, a
:class:`NodeTables` or a traced ``CustomMedium``
(``kernels/custom.py::CustomField``), and :func:`nag_fn` gives its plain
evaluator.  One step loop, ``csrc/fused.cuh``, is instantiated on the four
media (``csrc/media.cuh``) in ``csrc/fused.cu``, as kernels with their own
launch counts: ``fused_step`` (analytic), ``fused_step_strat``,
``fused_step_grid`` and ``fused_step_nodes``, and ``fused_sweep_grid``, the
grid loop with a step size and a step limit per ray (the DELTA_S candidate
sweep); and on a custom medium in a library generated for it
(``fused_step_custom``; ``fused_trace_final_custom``, fused.py:809).
:func:`fused_step_plain` is their plain PyTorch version, and
:func:`fused_step` / :func:`fused_sweep_grid` the wrappers that dispatch on
the device of the state tensors: a CPU state runs the plain version, a CUDA
state launches the kernel or raises.  ``fused_step`` on the interface
field and ``fused_step_strat`` launch the persistent refill loop of
``csrc/fused.cuh`` (a lane whose ray froze takes the next ray), on a ray
counter the wrapper allocates for each call; :func:`refill_grid`
gives its grid.  The fisheye and vert fields run one ray a thread.

What the TPU kernel carried only for Mosaic is gone: no zeros buffer, the
active mask is a bool, the scalars are arguments, and the state is plain
(R,) vectors (no (R/128, 128) lanes, no padding to a block).
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.config import THCK_PARAM, gold_tol
from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels.custom import (
    KERNEL_FUSED as KERNEL_CUSTOM, CustomField, custom_nag_plain, library_for,
    trace_custom)
from raytracing_tpu_torch.utils import fma

FUSED_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
FUSED_OPS = ("op1", "op2", "op3", "op4", "op6", "op7", "op8", "op12")
#: field name -> the ``rt::Field`` code of csrc/media.cuh
FIELD_CODES = {"fisheye": 0, "vert_heterogeneous": 1, "interface": 2}

KERNEL = build.KernelInfo(
    name="fused_step", source="raytracing_tpu_torch/csrc/fused.cu",
    replaces="raytracing_tpu/kernels/fused.py:336")
KERNEL_STRAT = build.KernelInfo(
    name="fused_step_strat", source="raytracing_tpu_torch/csrc/fused.cu",
    replaces="raytracing_tpu/kernels/fused.py:65")
KERNEL_GRID = build.KernelInfo(
    name="fused_step_grid", source="raytracing_tpu_torch/csrc/fused.cu",
    replaces="raytracing_tpu/kernels/fused.py:205")
KERNEL_NODES = build.KernelInfo(
    name="fused_step_nodes", source="raytracing_tpu_torch/csrc/fused.cu",
    replaces="raytracing_tpu/kernels/fused.py:151")
KERNEL_SWEEP_GRID = build.KernelInfo(
    name="fused_sweep_grid", source="raytracing_tpu_torch/csrc/fused.cu",
    replaces="raytracing_tpu/engine/segmented.py:968")
#: the family's kernels by medium: analytic, stratified, grid, node table
KERNELS = (KERNEL, KERNEL_STRAT, KERNEL_GRID, KERNEL_NODES)
#: the entry-point suffixes (see :func:`kernel_of`) that take the ray
#: counter of csrc/fused.cuh's persistent refill loop
REFILL_SUFFIXES = ("", "_strat")

_SQRT2 = 1.4142135623730951
#: curvature-negligibility threshold of the float32 kernels
CURV_TOL = gold_tol(np.float32)


def div_exact(a, b):
    """a / b rounded once, for a Python float on either side.

    PyTorch computes ``tensor / scalar`` as a product with the scalar's
    reciprocal and ``scalar / tensor`` as the scalar times a reciprocal,
    each off by up to an ulp from the division the kernels perform; a
    one-element tensor operand keeps it a true division.
    """
    if not torch.is_tensor(a):
        a = torch.full((1,), a, dtype=b.dtype, device=b.device)
    elif not torch.is_tensor(b):
        b = torch.full((1,), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def field_fn(field: str):
    """n and its gradient as the kernels evaluate them (fused.py:44-62).

    The interface uses the literal logistic, as the TPU kernel does; its
    exp overflows to inf below y ~ -0.44 and gives the exact limit.
    """
    if field == "fisheye":
        def f(x, y):
            n = 1.0 / (1.0 + x * x + y * y)
            c = -2.0 * n * n
            return n, c * x, c * y
    elif field == "vert_heterogeneous":
        def f(x, y):
            n = 1.0 / (18.0 + 2.0 * y)
            return n, torch.zeros_like(x), -2.0 * n * n
    elif field == "interface":
        def f(x, y):
            sig = 1.0 / (1.0 + torch.exp(div_exact(-y, THCK_PARAM)))
            n = _SQRT2 - (_SQRT2 - 1.0) * sig
            return (n, torch.zeros_like(x),
                    div_exact(-(_SQRT2 - 1.0) * sig * (1.0 - sig), THCK_PARAM))
    else:
        raise ValueError(f"kernels support fields {FUSED_FIELDS}, got {field!r}")
    return f


class StratTables(NamedTuple):
    """A 1-D stratified medium laid out for the kernels (``Strat`` in
    csrc/media.cuh; fused.py:286 ``strat_tables`` without its lane chunks).

    One row a cell, padded to 8 float32 (one 32-byte sector): ``ch`` = 6
    for the parity form (Zy[i], Zy[i+1], cy[i, 0..3]), 4 for the C1 form
    (cn[i, 0..3]).
    """

    table: Any       # (ny - 1, 8) float32
    ch: int
    y0: float
    inv_hy: float
    ny: int


class GridTables(NamedTuple):
    """A 2-D grid medium laid out for the kernels (``Grid`` in
    csrc/media.cuh): the per-cell rows of ``engine/segmented.py::_cells36``,
    ``cell_ch`` = 36 (parity Hermite form) or 16 (C1 form) float32 a cell."""

    table: Any       # ((ny - 1) * (nx - 1), cell_ch) float32
    cell_ch: int
    x0: float
    y0: float
    inv_hx: float
    inv_hy: float
    nx: int
    ny: int


class NodeTables(NamedTuple):
    """The parity Hermite grid's node table as the kernels read it
    (``Nodes`` in csrc/media.cuh): ``HermiteGridMedium.nodes``, one row of
    9 float32 channels a node (media/hermite.py's layout)."""

    table: Any       # (ny * nx, 9) float32
    x0: float
    y0: float
    inv_hx: float
    inv_hy: float
    nx: int
    ny: int


def strat_tables(medium, dtype=torch.float32) -> StratTables:
    """Pack a stratified medium (parity or C1) into :class:`StratTables`, on
    the medium's device.  The ONE definition the fused, golden and dynamic
    wrappers share; the kernels read float32, the dynamic scan tier's
    closed-form channels (engine/dynamic.py) the working ``dtype``."""
    if hasattr(medium, "cn"):            # C1StratifiedMedium
        cells, ch = medium.cn.to(dtype), 4
    else:
        zy = medium.Zy.to(dtype)
        cells = torch.cat([zy[:-1, None], zy[1:, None], medium.cy.to(dtype)],
                          1)
        ch = 6
    table = cells.new_zeros((medium.ny - 1, 8))
    table[:, :ch] = cells
    return StratTables(table=table, ch=ch, y0=float(medium.y0),
                       inv_hy=float(medium.inv_hy), ny=int(medium.ny))


def strat_nag_plain(t: StratTables):
    """n/grad from the stratified rows (fused.py:65-105 ``_strat_nag``), the
    kernel's order of operations: parity n = (1-uy) zlo + uy zhi and a cubic
    dn/dy; C1 n the cubic and dn/dy its derivative times inv_hy."""
    def nag(x, y):
        fy = torch.clamp((y - t.y0) * t.inv_hy, 0.0, float(t.ny - 1))
        iy = torch.clamp(torch.floor(fy), max=float(t.ny - 2))
        uy = fy - iy
        row = t.table[iy.long()]
        if t.ch == 4:
            c0, c1, c2, c3 = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
            n = c0 + uy * (c1 + uy * (c2 + uy * c3))
            gy = (c1 + uy * (2.0 * c2 + uy * 3.0 * c3)) * t.inv_hy
            return n, torch.zeros_like(x), gy
        zlo, zhi, c0, c1, c2, c3 = (row[..., k] for k in range(6))
        n = (1.0 - uy) * zlo + uy * zhi
        gy = c0 + uy * (c1 + uy * (c2 + uy * c3))
        return n, torch.zeros_like(x), gy

    return nag


def hermite_basis_fma(t):
    """The cubic Hermite basis (h0, g0, h1, g1) at ``t`` in csrc/media.cuh's
    FMA form (``hermite_basis_fma``), t2 = t * t: h0 = fma(fma(2, t, -3),
    t2, 1), g0 = fma(t2, t - 2, t), h1 = t2 * fma(-2, t, 3), g1 = t2 * (t -
    1)."""
    fma32 = fma.fma32
    t2 = t * t
    return (fma32(fma32(2.0, t, -3.0), t2, 1.0), fma32(t2, t - 2.0, t),
            t2 * fma32(-2.0, t, 3.0), t2 * (t - 1.0))


def dot4_fma(c, b):
    """c0 b0 + c1 b1 + c2 b2 + c3 b3 summed left to right, each product fused
    into its sum (csrc/media.cuh ``dot4_fma``)."""
    fma32 = fma.fma32
    return fma32(c[3], b[3], fma32(c[2], b[2], fma32(c[1], b[1],
                                                     c[0] * b[0])))


def hermite_blend(corners, u, v):
    """Bilinear n (channel 0) + bicubic Hermite gradients (channels 1-8) of
    JAX's ``_hermite_blend`` (fused.py:108-148), each product that feeds a
    sum fused into it as csrc/media.cuh's ``hermite_blend`` fuses it, by
    :func:`raytracing_tpu_torch.utils.fma.fma32`: n as two lerps along u
    and one along v; the bases by :func:`hermite_basis_fma`; each gradient
    channel's corner columns blended along v and the results across u by
    :func:`dot4_fma`.  The kernels' bits, not JAX's, which rounds each
    product and sum on its own (ROADMAP.md section 3).  Blends of the same
    form run as one stacked call (the two lerps along u, the v and u
    bases, the eight v-blends, the two u-blends): the same operations on
    every element, in a quarter of the torch calls.

    ``corners(ch) -> (c00, c01, c10, c11)`` fetches a channel's 2x2 corner
    node values (c01 = +x neighbour, c10 = +y).
    """
    fma32 = fma.fma32
    z00, z01, z10, z11 = corners(0)
    lo, hi = torch.stack((z00, z10)), torch.stack((z01, z11))
    r = fma32(u, hi - lo, lo)
    n = fma32(v, r[1] - r[0], r[0])
    h0, g0, h1, g1 = hermite_basis_fma(torch.stack((v, u)))
    hv = (h0[0], g0[0], h1[0], g1[0])
    hu = (h0[1], h1[1], g0[1], g1[1])
    # the v-blends c00, c01, d00, d01 of channels 1-4 then 5-8, each of the
    # corner column (value, d/dv) pairs (f, f_v) and (f_u, f_vu) at x = 0
    # and x = 1: terms (a[k], b[k], a[k + 2], b[k + 2])
    cols = []
    for ch0 in (1, 5):
        f, fv, fu, fw = (corners(ch0 + k) for k in range(4))
        cols += [(a[k], b[k], a[k + 2], b[k + 2])
                 for a, b in ((f, fv), (fu, fw)) for k in (0, 1)]
    inner = dot4_fma(tuple(torch.stack(t) for t in zip(*cols)), hv)
    per_channel = inner.unflatten(0, (2, 4))
    g = dot4_fma(tuple(per_channel[:, j] for j in range(4)), hu)
    return n, g[0], g[1]


def tile_nag_plain(g: GridTables):
    """n/grad from the per-cell rows: a direct gather of the ray's cell
    (the TPU's ``_tile_nag`` reads the same row through its window) blended
    by :func:`hermite_blend` (36 floats) or ``media.c1.c1_blend`` (16)."""
    from raytracing_tpu_torch.engine.segmented import _cells
    from raytracing_tpu_torch.media.c1 import c1_blend

    def nag(x, y):
        ix, iy, u, v = _cells(x, y, g)
        row = g.table[iy.long() * (g.nx - 1) + ix.long()]

        def corners(ch):
            return tuple(row[..., ch * 4 + c] for c in range(4))

        if g.cell_ch == 16:
            return c1_blend(corners, u, v, g.inv_hx, g.inv_hy)
        return hermite_blend(corners, u, v)

    return nag


def nodes_nag_plain(t: NodeTables):
    """n/grad from the node table (fused.py:151-202 ``_supercell_nag``):
    the cell's four corner node rows gathered directly, blended by
    :func:`hermite_blend` — the same corner values in the same order as
    :func:`tile_nag_plain` reads from the per-cell rows."""
    from raytracing_tpu_torch.engine.segmented import _cells

    def nag(x, y):
        ix, iy, u, v = _cells(x, y, t)
        node = iy.long() * t.nx + ix.long()
        rows = (t.table[node], t.table[node + 1], t.table[node + t.nx],
                t.table[node + t.nx + 1])

        def corners(ch):
            return tuple(r[..., ch] for r in rows)

        return hermite_blend(corners, u, v)

    return nag


def nag_fn(field):
    """The plain evaluator (x, y) -> (n, gx, gy) of a step's medium."""
    if isinstance(field, CustomField):
        return custom_nag_plain(field)
    if isinstance(field, StratTables):
        return strat_nag_plain(field)
    if isinstance(field, GridTables):
        return tile_nag_plain(field)
    if isinstance(field, NodeTables):
        return nodes_nag_plain(field)
    return field_fn(field)


class ResumeState(NamedTuple):
    """Full resumable state of the fused and golden kernels, (R,) each.

    Float32 vectors except ``active`` (bool: never left the box).  ``ang``
    is the golden kernels' angle (None for fused ops); the Welford fields
    are None without stats, the window fields None except for op7 (p_{-2}
    = (wax, way), p_{-1} = (wbx, wby)).  The field order is the slot order
    of ``rt::Slot`` in csrc/common.cuh.
    """

    x: Any
    y: Any
    ux: Any
    uy: Any
    cx: Any
    cy: Any
    tt: Any
    dsim: Any
    active: Any
    ang: Any = None
    mom_count: Any = None
    mom_mean: Any = None
    mom_m2: Any = None
    wax: Any = None
    way: Any = None
    wbx: Any = None
    wby: Any = None


class FusedFinal(NamedTuple):
    """Final-state bundle of a fused kernel run (all tensors length R)."""

    pos: Any          # (R, 2) final positions
    tangent: Any      # (R, 2) final unit tangent (cos/sin of the exit angle)
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool: never left the box
    mom_count: Any = None  # Welford m_x stats (with_stats=True only)
    mom_mean: Any = None
    mom_m2: Any = None


def _vectors(pos0, theta0, device):
    pos0 = torch.as_tensor(pos0, dtype=torch.float32, device=device)
    theta0 = torch.as_tensor(theta0, dtype=torch.float32, device=device)
    if pos0.dim() != 2 or pos0.shape[1] != 2 or theta0.shape != pos0.shape[:1]:
        raise ValueError(f"pos0 must be (R, 2) and theta0 (R,), got "
                         f"{tuple(pos0.shape)} and {tuple(theta0.shape)}")
    return pos0[:, 0].contiguous(), pos0[:, 1].contiguous(), theta0.contiguous()


def initial_state(op: str, pos0, theta0, *, field, with_stats: bool,
                  device) -> ResumeState:
    """Launch state of a fused run (segmented.py:66 ``_initial_comps``);
    ``field`` is the step's medium (see :func:`fused_step`)."""
    x, y, th = _vectors(pos0, theta0, device)
    zeros = torch.zeros_like(x)
    ux, uy = torch.cos(th), torch.sin(th)
    st = ResumeState(x=x, y=y, ux=ux, uy=uy, cx=zeros, cy=zeros.clone(),
                     tt=zeros.clone(), dsim=zeros.clone(),
                     active=torch.ones_like(x, dtype=torch.bool))
    if with_stats:
        n0 = nag_fn(field)(x, y)[0]
        st = st._replace(mom_count=torch.ones_like(x), mom_mean=n0 * ux,
                         mom_m2=zeros.clone())
    if op == "op7":
        # p_{-2} = p_{-1} = p_0 (fused.py:620)
        st = st._replace(wax=x.clone(), way=y.clone(), wbx=x.clone(),
                         wby=y.clone())
    return st


def final_from_state(st: ResumeState) -> FusedFinal:
    """FusedFinal from a resume state (segmented.py:99)."""
    if st.ang is not None:
        tangent = torch.stack([torch.cos(st.ang), torch.sin(st.ang)], dim=-1)
    else:
        tangent = torch.stack([st.ux, st.uy], dim=-1)
    return FusedFinal(pos=torch.stack([st.x, st.y], dim=-1), tangent=tangent,
                      traveltime=st.tt, dist_sim=st.dsim, active=st.active,
                      mom_count=st.mom_count, mom_mean=st.mom_mean,
                      mom_m2=st.mom_m2)


def rot_small(d):
    """(sin d, cos d) by degree-5/4 small-angle polynomials (golden.py:101,
    fused.py:453): below f32 roundoff for the per-step increments."""
    d2 = d * d
    sd = d * (1.0 - d2 * (1.0 / 6.0) * (1.0 - d2 * 0.05))
    cd = 1.0 - d2 * 0.5 * (1.0 - d2 * (1.0 / 12.0))
    return sd, cd


def _rot(ax, ay, d, mad=fma.mads(False)):
    """Rotate (ax, ay) by the small angle d, by :func:`rot_small`'s
    polynomials, each product that feeds a sum by ``mad``
    (``utils/fma.py::mads``; JAX's roundings by default), as csrc/common.cuh
    ``rotate`` writes it."""
    d2 = d * d
    inner = mad((d2, d2), (0.05, 1.0 / 12.0), (1.0, 1.0), sub=True)
    s, c = mad((d2 * (1.0 / 6.0), d2 * 0.5), inner, (1.0, 1.0), sub=True)
    s = d * s
    bx, = mad((ax,), (c,), (ay * s,), neg_c=True)
    by, = mad((ay,), (c,), (ax * s,))
    return bx, by


def arc_advance(ux, uy, gx, gy, txx, txy, n, ds):
    """Position increment on the circle of curvature (RT_bench.py:335-365)
    and the mask of significant curvature (>= CURV_TOL), below which the
    increment is the straight u ds; (txx, txy) is grad n less its part
    along u.  ``arc_advance`` of csrc/common.cuh."""
    one = torch.ones_like(n)
    curv = torch.sqrt(txx * txx + txy * txy) / n
    significant = curv >= CURV_TOL
    safe = torch.where(significant, curv, one)
    d = curv * ds
    sgn = torch.where(gx * uy - gy * ux > 0, -one, one)
    sh, ch = rot_small(sgn * d * 0.5)
    coefc = 2.0 * sh * sgn / safe
    ddx = torch.where(significant, (ux * ch - uy * sh) * coefc, ux * ds)
    ddy = torch.where(significant, (ux * sh + uy * ch) * coefc, uy * ds)
    return ddx, ddy, significant


def _kahan(x, c, dd):
    dx = dd - c
    nx = x + dx
    return nx, (nx - x) - dx


def _outside(x, y, box):
    limx_i, limx_s, limy_i, limy_s = box
    return (x > limx_s) | (x < limx_i) | (y > limy_s) | (y < limy_i)


def fused_step_plain(st: ResumeState, *, field, op: str, steps: int,
                     delta_s, step_limit, offset: float,
                     box) -> ResumeState:
    """Plain PyTorch version of the ``fused_step`` kernels (all media) and
    of ``fused_sweep_grid``.

    The same step (fused.py:430-608) on every ray at once, with a frozen
    ray's state kept by selects instead of leaving the loop.  ``delta_s``
    and ``step_limit`` are Python numbers or (R,) float32 tensors, one
    value a ray (the sweep); every expression that folds the step size
    rounds as the kernel's does in either form.
    """
    nag = nag_fn(field)
    second = op in ("op6", "op7", "op8")
    curvature = op in ("op3", "op4")
    rk2 = op in ("op2", "op3", "op6")
    window = op == "op7"
    rk4 = op == "op12"
    stats = st.mom_count is not None
    if torch.is_tensor(delta_s):
        ds = delta_s
        dsds_half = ds * ds * 0.5
    else:
        ds32 = np.float32(delta_s)
        ds = float(ds32)
        dsds_half = float(ds32 * ds32 * np.float32(0.5))   # (ds*ds)*0.5 in f32
    x, y, ux, uy, cx, cy, tt, dsim, active = st[:9]
    cnt, mean, m2 = st.mom_count, st.mom_mean, st.mom_m2
    wax, way, wbx, wby = st.wax, st.way, st.wbx, st.wby
    n, gx, gy = nag(x, y)

    for i in range(steps):
        keep = active & (float(np.float32(i) + np.float32(offset)) < step_limit)
        significant = None
        if rk4:
            h = ds
            k1t = (ux * gy - uy * gx) / n
            u1x, u1y = _rot(ux, uy, 0.5 * h * k1t)
            nb, gbx, gby = nag(x + 0.5 * h * ux, y + 0.5 * h * uy)
            k2t = (u1x * gby - u1y * gbx) / nb
            u2x, u2y = _rot(ux, uy, 0.5 * h * k2t)
            nc, gcx, gcy = nag(x + 0.5 * h * u1x, y + 0.5 * h * u1y)
            k3t = (u2x * gcy - u2y * gcx) / nc
            u3x, u3y = _rot(ux, uy, h * k3t)
            nd, gdx, gdy = nag(x + h * u2x, y + h * u2y)
            k4t = (u3x * gdy - u3y * gdx) / nd
            h6 = (div_exact(h, 6.0) if torch.is_tensor(h)
                  else float(np.float32(h) / np.float32(6.0)))
            ddx = h6 * (ux + 2 * u1x + 2 * u2x + u3x)
            ddy = h6 * (uy + 2 * u1y + 2 * u2y + u3y)
            dth = h6 * (k1t + 2 * k2t + 2 * k3t + k4t)
            rk4_ux, rk4_uy = _rot(ux, uy, dth)
        elif second:
            gdotu = gx * ux + gy * uy
            half_fac = div_exact(dsds_half, n)
            ddx = ux * ds + (gx - gdotu * ux) * half_fac
            ddy = uy * ds + (gy - gdotu * uy) * half_fac
        elif curvature:
            gdotu = gx * ux + gy * uy
            ddx, ddy, significant = arc_advance(
                ux, uy, gx, gy, gx - gdotu * ux, gy - gdotu * uy, n, ds)
        else:
            ddx = ux * ds
            ddy = uy * ds
        nx2, cx2 = _kahan(x, cx, ddx)
        ny2, cy2 = _kahan(y, cy, ddy)
        n2, gx2, gy2 = nag(nx2, ny2)

        if rk4:
            nux, nuy = rk4_ux, rk4_uy
        elif window:
            step_no = i + offset + 1
            ca, cb, cc, cd = {1: (0.0, 0.0, -1.0, 1.0),
                              2: (0.0, 1.0, -4.0, 3.0)}.get(
                                  step_no, (-2.0, 9.0, -18.0, 11.0))
            vx = ca * wax + cb * wbx + cc * x + cd * nx2
            vy = ca * way + cb * wby + cc * y + cd * ny2
            inv = torch.rsqrt(vx * vx + vy * vy)
            nux, nuy = vx * inv, vy * inv
        elif rk2:
            k1 = ds * (ux * gy - uy * gx) / n
            ux1, uy1 = _rot(ux, uy, k1)
            k2 = ds * (ux1 * gy2 - uy1 * gx2) / n2
            nux, nuy = _rot(ux, uy, (k1 + k2) * 0.5)
        else:
            half = ds * 0.5
            sx = n * ux + (gx + gx2) * half
            sy = n * uy + (gy + gy2) * half
            inv = torch.rsqrt(sx * sx + sy * sy)
            nux, nuy = sx * inv, sy * inv
        if significant is not None:
            nux = torch.where(significant, nux, ux)
            nuy = torch.where(significant, nuy, uy)

        if second or curvature or rk4:
            dist = torch.sqrt(ddx * ddx + ddy * ddy)
            ntt = tt + dist * (n + n2) * 0.5
            ndsim = dsim + dist
        else:
            ntt = tt + ds * (n + n2) * 0.5
            ndsim = dsim + ds

        def sel(new, old):
            return torch.where(keep, new, old)

        if stats:
            mx2 = n2 * nux
            cnt2 = cnt + 1.0
            delta = mx2 - mean
            mean2 = mean + delta / cnt2
            m22 = m2 + delta * (mx2 - mean2)
            cnt, mean, m2 = sel(cnt2, cnt), sel(mean2, mean), sel(m22, m2)
        if window:
            wax, way, wbx, wby = (sel(wbx, wax), sel(wby, way), sel(x, wbx),
                                  sel(y, wby))
        active = active & ~(keep & _outside(nx2, ny2, box))
        x, y, cx, cy = sel(nx2, x), sel(ny2, y), sel(cx2, cx), sel(cy2, cy)
        ux, uy, n, gx, gy = (sel(nux, ux), sel(nuy, uy), sel(n2, n),
                             sel(gx2, gx), sel(gy2, gy))
        tt, dsim = sel(ntt, tt), sel(ndsim, dsim)

    return ResumeState(x=x, y=y, ux=ux, uy=uy, cx=cx, cy=cy, tt=tt, dsim=dsim,
                       active=active, mom_count=cnt, mom_mean=mean, mom_m2=m2,
                       wax=wax, way=way, wbx=wbx, wby=wby)


def check_state(st: ResumeState, *, needs_ang: bool, window: bool) -> None:
    """Device, dtype, shape and contiguity checks of a resume state."""
    dev = st.x.device
    r = st.x.shape[0]
    required = {"x", "y", "ux", "uy", "cx", "cy", "tt", "dsim", "active"}
    if needs_ang:
        required.add("ang")
    if window:
        required |= {"wax", "way", "wbx", "wby"}
    stats = {"mom_count", "mom_mean", "mom_m2"}
    present = {k for k, v in st._asdict().items() if v is not None}
    if not required <= present:
        raise ValueError(f"resume state lacks {sorted(required - present)}")
    if present & stats and not stats <= present:
        raise ValueError("resume state needs all of mom_count/mom_mean/mom_m2")
    for name, t in st._asdict().items():
        if t is None:
            continue
        want = torch.bool if name == "active" else torch.float32
        if t.dtype != want or t.shape != (r,) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"state.{name}: need a contiguous ({r},) {want} tensor on "
                f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def check_medium(field, device) -> None:
    """A sampled medium's table must lie, as contiguous float32, on the
    state's device: a medium held on the CPU never meets a CUDA state (move
    it once with ``medium.to(device)``).  A field name or a
    :class:`~raytracing_tpu_torch.kernels.custom.CustomField` has no table."""
    if isinstance(field, (str, CustomField)):
        return
    if not isinstance(field, (StratTables, GridTables, NodeTables)):
        raise ValueError("a step's medium is a field name, StratTables, "
                         "GridTables, NodeTables or CustomField, got "
                         f"{type(field).__name__}")
    t = field.table
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"medium table: need contiguous float32 on {device}, "
                         f"got {t.dtype} on {t.device}; move the medium with "
                         ".to(device)")


def kernel_of(field, kernels, custom=None):
    """(KernelInfo, entry-point suffix, leading ints, table arguments) of a
    step's medium; ``kernels`` are the (analytic, strat, grid[, nodes])
    KernelInfos of a family and ``custom`` its CustomField kernel (None
    where the family has none), the table arguments those of
    csrc/media.cuh RT_TABLE_PARAMS.  A CustomField's entry point takes no
    leading int: its library holds one loop."""
    if isinstance(field, CustomField):
        if custom is None:
            raise ValueError("this kernel family has no CustomMedium form")
        return custom, "_custom", (), ()
    if isinstance(field, StratTables):
        return kernels[1], "_strat", (field.ch,), (
            field.table.data_ptr(), 0.0, field.y0, 0.0, field.inv_hy, 0,
            field.ny)
    if isinstance(field, GridTables):
        return kernels[2], "_grid", (field.cell_ch,), (
            field.table.data_ptr(), field.x0, field.y0, field.inv_hx,
            field.inv_hy, field.nx, field.ny)
    if isinstance(field, NodeTables):
        return kernels[3], "_nodes", (9,), (
            field.table.data_ptr(), field.x0, field.y0, field.inv_hx,
            field.inv_hy, field.nx, field.ny)
    return kernels[0], "", (FIELD_CODES[field],), ()


def fused_step(st: ResumeState, *, field, op: str, steps: int, delta_s,
               step_limit, offset=0.0, box) -> ResumeState:
    """Advance a resume state ``steps`` steps: the kernels' wrapper.

    ``field`` is the medium: an analytic field name (kernel ``fused_step``),
    a :class:`StratTables` (``fused_step_strat``), a :class:`GridTables`
    (``fused_step_grid``), a :class:`NodeTables` (``fused_step_nodes``) or
    a traced ``CustomMedium``, :class:`CustomField` (``fused_step_custom``,
    from the field's own library, built on first use).
    ``offset`` is the number of steps applied
    before this launch (global step numbering: op7's order ramp and
    ``step_limit`` read it), so a run of k steps then n - k steps with
    offset k equals one run of n.  A CPU state runs
    :func:`fused_step_plain`; a CUDA state launches the kernel.
    """
    if isinstance(field, str) and field not in FUSED_FIELDS:
        raise ValueError(f"fused kernel supports fields {FUSED_FIELDS}, got {field!r}")
    if op not in FUSED_OPS:
        raise ValueError(f"fused kernel supports ops {FUSED_OPS}, got {op!r}")
    check_state(st, needs_ang=False, window=op == "op7")
    check_medium(field, st.x.device)
    box = tuple(float(v) for v in box)
    if st.x.device.type == "cpu":
        return fused_step_plain(st, field=field, op=op, steps=int(steps),
                                delta_s=delta_s, step_limit=float(step_limit),
                                offset=float(offset), box=box)
    if st.x.device.type != "cuda":
        raise ValueError(f"fused_step runs on cpu or cuda, not {st.x.device}")
    kernel, suffix, lead, table = kernel_of(field, KERNELS, KERNEL_CUSTOM)
    fn, name = (library_for(field, "fused", op) if suffix == "_custom" else
                (getattr(build.library(), "rt_fused_step" + suffix),
                 "rt_fused_step" + suffix))
    out = ResumeState(*(None if t is None else torch.empty_like(t) for t in st))
    with torch.cuda.device(st.x.device):
        # the refill loop's ray counter (the launch zeroes it on its stream)
        counter = (torch.empty(1, dtype=torch.int32, device=st.x.device)
                   if suffix in REFILL_SUFFIXES else None)
        err = fn(*lead, int(op[2:]), int(st.mom_count is not None),
                 build.pointer_array(st), build.pointer_array(out),
                 st.x.shape[0], int(steps), float(delta_s), float(step_limit),
                 float(offset), *box, CURV_TOL, *table,
                 *(() if counter is None else (counter.data_ptr(),)),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, name)
    kernel.launches += 1
    return out


def refill_grid(field, op: str, n: int, stats: bool = False) -> int:
    """Blocks of 128 threads that the refill loop of ``fused_step`` (an
    analytic field name) or ``fused_step_strat`` (a :class:`StratTables`)
    launches for ``n`` rays of ``op``, with or without the Welford ``stats``,
    on the current CUDA device: as many as every SM holds at once, never
    more than the rays fill; 0 for the fisheye and vert fields, which run
    one ray a thread."""
    if isinstance(field, StratTables):
        medium, code = 1, field.ch
    elif isinstance(field, str) and field in FUSED_FIELDS:
        medium, code = 0, FIELD_CODES[field]
    else:
        raise ValueError("the refill loop runs on the analytic fields and "
                         f"StratTables, not {type(field).__name__}")
    if op not in FUSED_OPS:
        raise ValueError(f"fused kernel supports ops {FUSED_OPS}, got {op!r}")
    blocks = ctypes.c_int(0)
    build.check(build.library().rt_fused_refill_blocks(
        medium, code, int(op[2:]), int(bool(stats)), int(n),
        ctypes.addressof(blocks)), "rt_fused_refill_blocks")
    return blocks.value


def fused_sweep_grid(st: ResumeState, delta_s, step_limit, *,
                     field: GridTables, op: str, steps: int,
                     box) -> ResumeState:
    """Advance every ray ``steps`` steps, ray r at its own step size
    ``delta_s[r]`` and frozen after its own ``step_limit[r]`` steps: the
    ``fused_sweep_grid`` kernel's wrapper (engine/segmented.py:968, one
    DELTA_S candidate a ray).

    ``delta_s`` and ``step_limit`` are contiguous (R,) float32 tensors on
    the state's device; ``field`` is a :class:`GridTables`.  A CPU state
    runs :func:`fused_step_plain` with the per-ray tensors; a CUDA state
    launches the kernel or raises.
    """
    if not isinstance(field, GridTables):
        raise ValueError("fused_sweep_grid runs on GridTables, got "
                         f"{type(field).__name__}")
    if op not in FUSED_OPS:
        raise ValueError(f"fused kernel supports ops {FUSED_OPS}, got {op!r}")
    check_state(st, needs_ang=False, window=op == "op7")
    check_medium(field, st.x.device)
    for name, t in (("delta_s", delta_s), ("step_limit", step_limit)):
        if (not torch.is_tensor(t) or t.dtype != torch.float32
                or t.shape != st.x.shape or t.device != st.x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {tuple(st.x.shape)} "
                             f"float32 tensor on {st.x.device}")
    box = tuple(float(v) for v in box)
    if st.x.device.type == "cpu":
        return fused_step_plain(st, field=field, op=op, steps=int(steps),
                                delta_s=delta_s, step_limit=step_limit,
                                offset=0.0, box=box)
    if st.x.device.type != "cuda":
        raise ValueError(f"fused_sweep_grid runs on cpu or cuda, not {st.x.device}")
    out = ResumeState(*(None if t is None else torch.empty_like(t) for t in st))
    _, _, lead, table = kernel_of(field, KERNELS)
    lib = build.library()
    with torch.cuda.device(st.x.device):
        err = lib.rt_fused_sweep_grid(
            *lead, int(op[2:]), int(st.mom_count is not None),
            build.pointer_array(st), build.pointer_array(out), st.x.shape[0],
            int(steps), 0.0, 0.0, 0.0, *box, CURV_TOL, delta_s.data_ptr(),
            step_limit.data_ptr(), *table,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "rt_fused_sweep_grid")
    KERNEL_SWEEP_GRID.launches += 1
    return out


def fused_trace_final(pos0, theta0, delta_s, *, field, op: str,
                      steps: int, box, device="cuda", step_limit=None,
                      with_stats: bool = False) -> FusedFinal:
    """Run ``steps`` fused integration steps; return a :class:`FusedFinal`.

    ``field`` is the step's medium (see :func:`fused_step`).
    ``step_limit`` (default ``steps``) freezes every ray after that many
    steps; ``with_stats`` adds the Welford tracker of m_x = n u_x for
    on-device conservation oracles (RT_bench.py:957-958).
    """
    st = initial_state(op, pos0, theta0, field=field, with_stats=with_stats,
                       device=device)
    st = fused_step(st, field=field, op=op, steps=steps, delta_s=delta_s,
                    step_limit=steps if step_limit is None else step_limit,
                    offset=0.0, box=box)
    return final_from_state(st)


def fused_trace_final_custom(pos0, theta0, delta_s, *, medium, op: str,
                             steps: int, box, device="cuda", step_limit=None,
                             with_stats: bool = False) -> FusedFinal:
    """Fused integration through a user-defined ``CustomMedium``
    (fused.py:809): the medium traced once (``kernels/custom.py``) and read
    by the ``fused_step_custom`` kernel, its library built on first use.
    Same contract as :func:`fused_trace_final`."""
    return fused_trace_final(pos0, theta0, delta_s, field=trace_custom(medium),
                             op=op, steps=steps, box=box, device=device,
                             step_limit=step_limit, with_stats=with_stats)


def fused_trace_final_strat(pos0, theta0, delta_s, medium, *, op: str,
                            steps: int, box, device="cuda", step_limit=None,
                            with_stats: bool = False) -> FusedFinal:
    """Fused integration through a sampled stratified medium (parity or C1;
    fused.py:847): the reference's FITPACK pair (RT_bench.py:435-464)
    collapsed to 1-D tables, read by the ``fused_step_strat`` kernel."""
    return fused_trace_final(pos0, theta0, delta_s, field=strat_tables(medium),
                             op=op, steps=steps, box=box, device=device,
                             step_limit=step_limit, with_stats=with_stats)
