"""The dynamic kernels: kinematics plus the paraxial tangent, on every medium.

Port of ``raytracing_tpu/kernels/dynamic.py``: ``DYN_FUSED_FIELDS`` /
``DYN_FUSED_OPS`` (dynamic.py:71-73), the Hessian evaluators ``_field_fn_h``
(:78-118), ``_strat_nag_h`` (:121-174), ``_tile_nag_h`` (:177-287) and
``_tile_nag_c1_h`` (:290-344) as :func:`field_fn_h`, :func:`strat_nag_h`,
:func:`tile_nag_h` (both grid families, without the TPU window), the step
loop of ``_make_dynamic_kernel`` (:347-586) in its resume form, ``DynFinal``
(:589), ``dynamic_trace_final`` (:609) and ``dynamic_trace_final_strat``
(:680); and the 18-plane resume state of
``engine/segmented.py::grid_trace_dynamic_tiled`` (:1844-1850), which all
three kernels here read and write.

Beside the kinematic state, a ray carries d(state)/d(theta0): the position
tangent (dpx, dpy), the angle tangent dth (the unit tangent's derivative is
dth times u_perp), the running sign of the spreading q = dpos . u_perp and
the KMAH caustic count; the tangent accumulators are Kahan-compensated
(kdx, kdy, kdt) as are the positions (cx, cy) and the traveltime (ktt).
The field is evaluated once a step, after the move, with its derivatives
in one 9-channel layout ``(n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy)``:
``gn`` is the n channel's own gradient, which differs from the ray
equation's gradient on the parity tables, and the Hessian rows are
independent (the parity 2-D table fits gx and gy as separate bicubics).

One CUDA step loop (``csrc/dynamic.cu``) serves three media as three
kernels with their own launch counts: ``dynamic_step`` (analytic fields),
``dynamic_step_strat`` (stratified tables: the persistent refill loop, on
a ray counter the wrapper allocates for each call; :func:`refill_grid`
gives its grid) and ``dynamic_step_grid`` (2-D per-cell tables).  :func:`dynamic_step_plain` is their plain PyTorch
version and :func:`dynamic_step` the wrapper: a CPU state runs the plain
version, a CUDA state launches the kernel or raises.  Only the smooth ops
op1/op2/op6/op8: a golden op's tangent is zero almost everywhere.  On the
analytic fields and the 2-D grids the kernel and its plain version fuse
each product that feeds a sum into it, in the step and in the medium's
channels (:func:`field_fn_h`, :func:`tile_nag_h` with
``utils/fma.py::mads(True)``), so they no longer follow JAX's step
operation for operation; both stay within JAX's bars (ROADMAP.md section
3).  The grid case is checked to the bit on the CPU against the g++ build
of ``csrc/dynamic.cuh`` (tests/test_torch_dynamic_host.py) and on the card
by chip_smoke.py's ``[dynamic-vs-plain]``.  The 1-D tables keep JAX's
roundings, and the float64 scan tier reads the channels in JAX's order
(:func:`field_fn_h`, :func:`tile_nag_h` by default).
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.config import THCK_PARAM
from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels.fused import (
    GridTables, StratTables, _kahan, _outside, _rot, _vectors, check_medium,
    div_exact, kernel_of, strat_tables)
from raytracing_tpu_torch.media.fields import _sigmoid
from raytracing_tpu_torch.utils import fma

#: analytic fields with inlined Hessians
DYN_FUSED_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
#: smooth fused ops whose hand tangent is implemented
DYN_FUSED_OPS = ("op1", "op2", "op6", "op8")

KERNEL = build.KernelInfo(
    name="dynamic_step", source="raytracing_tpu_torch/csrc/dynamic.cu",
    replaces="raytracing_tpu/kernels/dynamic.py:646")
KERNEL_STRAT = build.KernelInfo(
    name="dynamic_step_strat", source="raytracing_tpu_torch/csrc/dynamic.cu",
    replaces="raytracing_tpu/kernels/dynamic.py:722")
KERNEL_GRID = build.KernelInfo(
    name="dynamic_step_grid", source="raytracing_tpu_torch/csrc/dynamic.cu",
    replaces="raytracing_tpu/engine/segmented.py:1702")
#: the family's kernels by medium: analytic, stratified, grid
KERNELS = (KERNEL, KERNEL_STRAT, KERNEL_GRID)

_SQRT2 = 1.4142135623730951


def _scal(v, dtype) -> float:
    """A Python constant as the kernel holds it: float32-rounded for float32
    tables (so the plain version's products round as the kernel's do),
    unchanged for float64 ones."""
    return float(np.float32(v)) if dtype == torch.float32 else float(v)


def field_fn_h(field: str, mad=fma.mads(False)):
    """n, its gradient and Hessian of an analytic field, closed form
    (dynamic.py:78-118), in the 9-channel layout, each product that feeds a
    sum by ``mad`` (``utils/fma.py::mads``): JAX's roundings by default,
    csrc/media.cuh ``Analytic::field_h``'s FMA form with ``fma.mads(True)``
    (the fisheye's 1 + x^2 + y^2 and c + 8 n^3 x x, vert's 18 + 2 y, the
    interface's sqrt2 - (sqrt2 - 1) sig and 1 - 2 sig).  The interface uses
    the overflow-safe two-branch logistic of ``media/fields.py``, not the
    kinematic kernels' literal one."""
    if field == "fisheye":
        def f(x, y):
            s, = mad((x,), (x,), (1.0,))
            s, = mad((y,), (y,), (s,))
            n = 1.0 / s
            n2 = n * n
            c = -2.0 * n2
            n3_8 = 8.0 * n2 * n
            n3_8x = n3_8 * x
            gx, gy = c * x, c * y
            hxx, hyy = mad((n3_8x, n3_8 * y), (x, y), (c, c))
            hxy = n3_8x * y
            return n, gx, gy, gx, gy, hxx, hxy, hxy, hyy
    elif field == "vert_heterogeneous":
        def f(x, y):
            n = 1.0 / mad((2.0,), (y,), (18.0,))[0]
            zero = torch.zeros_like(x)
            n2 = n * n
            gy = -2.0 * n2
            return n, zero, gy, zero, gy, zero, zero, zero, 8.0 * n2 * n
    elif field == "interface":
        def f(x, y):
            sig = _sigmoid(div_exact(y, THCK_PARAM))
            n, = mad((-(_SQRT2 - 1.0),), (sig,), (_SQRT2,))
            zero = torch.zeros_like(x)
            a = -(_SQRT2 - 1.0) * (sig * (1.0 - sig))
            gy = div_exact(a, THCK_PARAM)
            hyy = div_exact(a * mad((-2.0,), (sig,), (1.0,))[0],
                            THCK_PARAM * THCK_PARAM)
            return n, zero, gy, zero, gy, zero, zero, zero, hyy
    else:
        raise ValueError(f"dynamic kernel supports fields {DYN_FUSED_FIELDS},"
                         f" got {field!r}")
    return f


def _in(v, lo, hi, hi_open=False):
    """lo <= |v| <= hi (< hi where ``hi_open``), False for NaN."""
    a = v.abs()
    return (a >= lo) & ((a < hi) if hi_open else (a <= hi))


def field_guard(field: str, x, y):
    """Where ``dynamic_step``'s fast reciprocal of an analytic field at (x,
    y) holds its guard (csrc/media.cuh ``Analytic::field_h``; common.cuh
    ``rcp_fast_ge1``, ``rcp_fast``, ``div_fast_pos``): a model of the
    kernel's guard, which reports no path of its own
    (tests/test_torch_cuda.py holds the two together beyond it)."""
    f32 = fma.fma32
    if field == "fisheye":
        return f32(y, y, f32(x, x, 1.0)) < 2.0 ** 126
    if field == "vert_heterogeneous":
        return _in(f32(2.0, y, 18.0), 2.0 ** -126, 2.0 ** 126, True)
    t = div_exact(y, THCK_PARAM)
    e = torch.exp(torch.where(t >= 0, -t, t))
    return (t >= 0) | (1.0 + e == 1.0) | _in(e, 2.0 ** -100, 2.0 ** 100)


def strat_nag_h(t: StratTables):
    """The 9 channels from the stratified rows (dynamic.py:121-174): the C1
    cubic gives n, dn/dy and d2n/dy2 (gn == g); the parity rows give the
    bilinear n, its own slope gny = (zhi - zlo) inv_hy, the cubic gy and
    its derivative.  ``inv_hy`` squared rounds as the kernel's float32
    product does."""
    ihy = _scal(t.inv_hy, t.table.dtype)
    ihy2 = _scal(ihy * ihy, t.table.dtype)

    def nag(x, y):
        fy = torch.clamp((y - t.y0) * t.inv_hy, 0.0, float(t.ny - 1))
        iy = torch.clamp(torch.floor(fy), max=float(t.ny - 2))
        uy = fy - iy
        row = t.table[iy.long()]
        zero = torch.zeros_like(x)
        if t.ch == 4:
            c0, c1, c2, c3 = (row[..., k] for k in range(4))
            n = c0 + uy * (c1 + uy * (c2 + uy * c3))
            gy = (c1 + uy * (2.0 * c2 + uy * 3.0 * c3)) * ihy
            hyy = (2.0 * c2 + 6.0 * c3 * uy) * ihy2
            return n, zero, gy, zero, gy, zero, zero, zero, hyy
        zlo, zhi, c0, c1, c2, c3 = (row[..., k] for k in range(6))
        n = (1.0 - uy) * zlo + uy * zhi
        gy = c0 + uy * (c1 + uy * (c2 + uy * c3))
        hyy = (c1 + uy * (2.0 * c2 + uy * 3.0 * c3)) * ihy
        gny = (zhi - zlo) * ihy
        return n, zero, gy, zero, gny, zero, zero, zero, hyy

    return nag


def _bases(t, mad, second=False):
    """The Hermite basis (h0, g0, h1, g1) at ``t``, its derivative and,
    where ``second``, its second derivative, as JAX writes them
    (media/hermite.py::hermite_basis, media/c1.py::hermite_dbasis,
    hermite_d2basis), each product that feeds a sum by ``mad``
    (csrc/media.cuh ``hermite_basis_h``, ``hermite_dbasis_h``,
    ``hermite_d2basis_h`` where fused), with t2 = t t, t3 = t2 t, s = 3
    t2."""
    t2 = t * t
    t3 = t2 * t
    s = 3.0 * t2
    t6 = 6.0 * t
    h0, d0 = mad((2.0, 6.0), (t3, t2), (s, t6), neg_c=True)
    g0, h1, d1, d2, d3 = mad((2.0, 2.0, 4.0, 6.0, 2.0), (t2, t3, t, t2, t),
                             (t3, s, s, t6, s), sub=True)
    out = ((h0 + 1.0, g0 + t, h1, t3 - t2), (d0, d1 + 1.0, d2, d3))
    if second:
        e0, e1, e3 = mad((12.0, 6.0, 6.0), (t, t, t), (6.0, 4.0, 2.0),
                         neg_c=True)
        e2, = mad((12.0,), (t,), (6.0,), sub=True)
        out += ((e0, e1, e2, e3),)
    return out


def _dot4(mad, c, w):
    """c[0] w[0] + c[1] w[1] + c[2] w[2] + c[3] w[3] summed left to right,
    each product after the first by ``mad`` (csrc/media.cuh ``dot4_fma``
    where fused); c[k] and w[k] are tuples of like terms, one sum each, as
    a tuple."""
    acc = tuple(a * b for a, b in zip(c[0], w[0]))
    for k in (1, 2, 3):
        acc = mad(c[k], w[k], acc)
    return acc


def tile_nag_h(g: GridTables, mad=fma.mads(False)):
    """The 9 channels from the per-cell rows of a 2-D grid, read directly
    (the TPU reads the same row through its window): the parity form
    (dynamic.py:177-287) gives the bilinear n and its own gradient, the two
    independent bicubic gradients and their full 2x2 Jacobian; the C1 form
    (:290-344) the patch's n, gradient and symmetric Hessian (as
    ``media.c1.c1_blend_h``).  Each product that feeds a sum by ``mad``
    (``utils/fma.py::mads``): JAX's roundings by default, term for term, the
    dynamic grid kernel's FMA form with ``fma.mads(True)`` (csrc/media.cuh
    ``hermite_blend_h``, ``c1_blend_h``).  Like blends run as one stacked
    call there: the bases at v and u, the v-blends, the u-blends."""
    from raytracing_tpu_torch.engine.segmented import _cells

    ihx, ihy = _scal(g.inv_hx, g.table.dtype), _scal(g.inv_hy, g.table.dtype)
    ihxx, ihxy, ihyy = (_scal(a * b, g.table.dtype)
                        for a, b in ((ihx, ihx), (ihx, ihy), (ihy, ihy)))

    def nag(x, y):
        ix, iy, u, v = _cells(x, y, g)
        row = g.table[iy.long() * (g.nx - 1) + ix.long()]

        def corners(ch):
            return tuple(row[..., ch * 4 + c] for c in range(4))

        def columns(ch0):
            """The corner column terms of the v-blends of channels ch0 to
            ch0 + 3 (f, f_v, f_u, f_vu): at x = 0 and 1, value then slope."""
            f, fv, fu, fw = (corners(ch0 + k) for k in range(4))
            return [(f[0], fv[0], f[2], fv[2]), (f[1], fv[1], f[3], fv[3]),
                    (fu[0], fw[0], fu[2], fw[2]), (fu[1], fw[1], fu[3], fw[3])]

        bases = _bases(torch.stack((v, u)), mad, second=g.cell_ch == 16)
        at_v = [tuple(w[0] for w in b) for b in bases]
        at_u = [tuple(w[1] for w in b) for b in bases]

        def vblend(cols, weights):
            """Each column set's four v-blends with each basis of
            ``weights``, stacked: column set-major, then basis, then
            column."""
            terms = [(col, w) for cs in cols for w in weights for col in cs]
            return _dot4(mad, tuple(zip(*(t[0] for t in terms))),
                         tuple(zip(*(t[1] for t in terms))))

        if g.cell_ch == 16:
            hv, dv, ddv = at_v
            hu, du, ddu = at_u
            c = vblend([columns(0)], [hv, dv, ddv])
            # each in media/c1.py::_vblend's order: p0, m0, p1, m1
            col, col_dv, col_ddv = ((c[j], c[j + 2], c[j + 1], c[j + 3])
                                    for j in (0, 4, 8))
            pairs = ((col, hu), (col, du), (col_dv, hu), (col, ddu),
                     (col_dv, du), (col_ddv, hu))
            n, gu, gv, huu, huv, hvv = _dot4(
                mad, tuple(zip(*(c for c, _ in pairs))),
                tuple(zip(*(w for _, w in pairs))))
            gx, gy = gu * ihx, gv * ihy
            return (n, gx, gy, gx, gy, huu * ihxx, huv * ihxy, huv * ihxy,
                    hvv * ihyy)
        z00, z01, z10, z11 = corners(0)
        mu, mv = 1.0 - u, 1.0 - v
        r0, r1 = mad((u, u), (z01, z11), (mu * z00, mu * z10))
        n, gnx, gny = mad((v, v, u), (r1, z11 - z10, z11 - z01),
                          (mv * r0, mv * (z01 - z00), mu * (z10 - z00)))
        hv, dv = at_v
        hu, du = at_u
        c = vblend([columns(1), columns(5)], [hv, dv])
        # per channel: the value blends cv then the slope blends ev
        cv = [c[0:4], c[8:12]]
        ev = [c[4:8], c[12:16]]

        def across(w):
            return (w[0], w[2], w[1], w[3])
        pairs = [(blend[k], across(w)) for k in (0, 1)
                 for blend, w in ((cv, hu), (cv, du), (ev, hu))]
        gx, gx_u, gx_v, gy, gy_u, gy_v = _dot4(
            mad, tuple(zip(*(b for b, _ in pairs))),
            tuple(zip(*(w for _, w in pairs))))
        return (n, gx, gy, gnx * ihx, gny * ihy, gx_u * ihx, gx_v * ihy,
                gy_u * ihx, gy_v * ihy)

    return nag


def nag_h_fn(field):
    """The plain 9-channel evaluator (x, y) -> channels of a step's medium,
    an analytic field's and a 2-D grid's in their kernel's FMA form."""
    if isinstance(field, StratTables):
        return strat_nag_h(field)
    if isinstance(field, GridTables):
        return tile_nag_h(field, fma.mads(True))
    return field_fn_h(field, fma.mads(True))


class DynState(NamedTuple):
    """Resumable state of the dynamic kernels, (R,) each: the 18 planes of
    JAX's resume layout (segmented.py:1844-1850), float32 except ``active``
    (bool: never left the box).  The field order is ``rt::DSlot`` in
    csrc/dynamic.cu."""

    x: Any
    y: Any
    cx: Any       # Kahan compensation of x
    cy: Any
    ux: Any       # unit tangent
    uy: Any
    tt: Any
    dsim: Any
    active: Any
    dpx: Any      # d(pos)/d(theta0)
    dpy: Any
    dth: Any      # d(angle)/d(theta0)
    sgn: Any      # running sign of q: -1, 0 (not yet set) or 1
    kmah: Any     # caustic count, float
    kdx: Any      # Kahan compensations of dpx, dpy, dth, tt
    kdy: Any
    kdt: Any
    ktt: Any


class DynFinal(NamedTuple):
    """Final kinematic + paraxial state of a dynamic kernel run."""

    pos: Any          # (R, 2)
    tangent: Any      # (R, 2) unit tangent (cos/sin of the exit angle)
    n: Any            # (R,)   index at the final position
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool
    q: Any            # (R,)   transverse spreading dpos . u_perp
    dtheta: Any       # (R,)   d(angle)/d(theta0)
    kmah: Any         # (R,) int32 caustic count

    def amplitude(self, n0):
        from raytracing_tpu_torch.engine.dynamic import spreading_amplitude
        return spreading_amplitude(self.q, self.n, n0)


def initial_dyn_state(pos0, theta0, *, device) -> DynState:
    """Launch state from (pos0, theta0): the source point fixed (dpos = 0),
    dth = 1, every compensation and the caustic bookkeeping 0."""
    x, y, th = _vectors(pos0, theta0, device)
    zero = torch.zeros_like(x)
    return DynState(x=x, y=y, cx=zero, cy=zero.clone(), ux=torch.cos(th),
                    uy=torch.sin(th), tt=zero.clone(), dsim=zero.clone(),
                    active=torch.ones_like(x, dtype=torch.bool),
                    dpx=zero.clone(), dpy=zero.clone(),
                    dth=torch.ones_like(x), sgn=zero.clone(),
                    kmah=zero.clone(), kdx=zero.clone(), kdy=zero.clone(),
                    kdt=zero.clone(), ktt=zero.clone())


def final_from_dyn_state(st: DynState, n) -> DynFinal:
    """DynFinal from a state and the index ``n`` at its positions; q is the
    carried tangent contracted with the exit normal (dynamic.py:663-675)."""
    return DynFinal(pos=torch.stack([st.x, st.y], dim=-1),
                    tangent=torch.stack([st.ux, st.uy], dim=-1), n=n,
                    traveltime=st.tt, dist_sim=st.dsim, active=st.active,
                    q=st.dpx * (-st.uy) + st.dpy * st.ux, dtheta=st.dth,
                    kmah=st.kmah.to(torch.int32))


def dynamic_step_plain(st: DynState, *, field, op: str, steps: int,
                       delta_s, step_limit, offset: float, box,
                       guards=None) -> DynState:
    """Plain PyTorch version of the three dynamic kernels.

    The step of ``_make_dynamic_kernel`` (dynamic.py:421-540) on every ray
    at once, a frozen ray kept by selects; the kernels' order of
    operations, one torch call each, so that on the card the two agree to
    the bit.  On an analytic field (a field name) and a 2-D grid
    (GridTables) the step and the channels are in the kernel's FMA form
    (csrc/dynamic.cuh ``DynFma``): each product that feeds a sum rounded
    once with it by ``utils/fma.py::fma32``, like terms of a step stacked
    into one call (``utils/fma.py::mads``); the 1-D tables keep JAX's
    roundings.  The analytic fields' kernel takes its reciprocals and
    square root by fast paths that give the IEEE operations' bits, so this
    version divides and takes square roots as IEEE operations.  The sign
    of q is three-valued (0 at 0), as ``jnp.sign``.

    ``guards``, a float64 tensor of 2 on the state's device, if given:
    each step adds to ``guards[0]`` the rays it moves where a fast path's
    guard fails (the analytic fields' kernel then takes that operation's
    IEEE form; the sampled media's has none), to ``guards[1]`` the rays it
    moves.
    """
    analytic = isinstance(field, str)
    mad = fma.mads(analytic or isinstance(field, GridTables))
    nag = nag_h_fn(field)
    second = op in ("op6", "op8")
    rk2 = op in ("op2", "op6")
    ds32 = np.float32(delta_s)
    ds = float(ds32)
    dsds_half = float(ds32 * ds32 * np.float32(0.5))
    half = float(ds32 * np.float32(0.5))
    (x, y, cx, cy, ux, uy, tt, dsim, active, dpx, dpy, dth, sgn, kmah,
     kdx, kdy, kdt, ktt) = st
    f = nag(x, y)

    for i in range(steps):
        keep = active & (float(np.float32(i) + np.float32(offset))
                         < step_limit)
        n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy = f
        dn, dgx, dgy = mad((gny, hxy, hyy), (dpy, dpy, dpy),
                           (gnx * dpx, hxx * dpx, hyx * dpx))
        dux = -dth * uy
        duy = dth * ux
        if second or rk2:
            gdotu, = mad((gy,), (uy,), (gx * ux,))

        # position advance and its tangent
        if second:
            inv_n = 1.0 / n
            half_fac = dsds_half * inv_n
            txx, txy = mad((gdotu, gdotu), (ux, uy), (gx, gy), sub=True)
            ddx, ddy = mad((txx, txy), (half_fac, half_fac),
                           (ux * ds, uy * ds))
            dgdotu, = mad((dgy,), (uy,), (dgx * ux,))
            dgdotu, = mad((gx,), (dux,), (dgdotu,))
            dgdotu, = mad((gy,), (duy,), (dgdotu,))
            dtx, dty = mad((dgdotu, dgdotu), (ux, uy), (dgx, dgy), sub=True)
            dtx, dty = mad((gdotu, gdotu), (dux, duy), (dtx, dty), sub=True)
            ex, ey = mad((txx * dn, txy * dn), (inv_n, inv_n), (dtx, dty),
                         sub=True)
            ddpx, ddpy = mad((ex, ey), (half_fac, half_fac),
                             (dux * ds, duy * ds))
        else:
            ddx = ux * ds
            ddy = uy * ds
            ddpx = dux * ds
            ddpy = duy * ds
        nx2, cx2 = _kahan(x, cx, ddx)
        ny2, cy2 = _kahan(y, cy, ddy)
        dpx2, kdx2 = _kahan(dpx, kdx, ddpx)
        dpy2, kdy2 = _kahan(dpy, kdy, ddpy)

        f2 = nag(nx2, ny2)
        n2, gx2, gy2, gnx2, gny2, hxx2, hxy2, hyx2, hyy2 = f2
        dn2, dgx2, dgy2 = mad((gny2, hxy2, hyy2), (dpy2, dpy2, dpy2),
                              (gnx2 * dpx2, hxx2 * dpx2, hyx2 * dpx2))

        # angle update and its tangent
        if rk2:
            inv_n = 1.0 / n
            inv_n2 = 1.0 / n2
            cross1, = mad((ux,), (gy,), (uy * gx,), neg_c=True)
            k1 = ds * cross1 * inv_n
            ux1, uy1 = _rot(ux, uy, k1, mad)
            cross2, = mad((ux1,), (gy2,), (uy1 * gx2,), neg_c=True)
            k2 = ds * cross2 * inv_n2
            nux, nuy = _rot(ux, uy, (k1 + k2) * 0.5, mad)
            dcross1, = mad((ux,), (dgy,), (-dth * gdotu,))
            dcross1, = mad((uy,), (dgx,), (dcross1,), sub=True)
            dk1 = (ds * mad((cross1 * dn,), (inv_n,), (dcross1,), sub=True)[0]
                   * inv_n)
            dth1 = dth + dk1
            gdotm, = mad((uy1,), (gy2,), (ux1 * gx2,))
            dcross2, = mad((ux1,), (dgy2,), (-dth1 * gdotm,))
            dcross2, = mad((uy1,), (dgx2,), (dcross2,), sub=True)
            dk2 = (ds * mad((cross2 * dn2,), (inv_n2,), (dcross2,),
                            sub=True)[0] * inv_n2)
            ndth, kdt2 = _kahan(dth, kdt, (dk1 + dk2) * 0.5)
        else:
            sx, sy = mad((gx + gx2, gy + gy2), (half, half), (n * ux, n * uy))
            inv = torch.rsqrt(mad((sy,), (sy,), (sx * sx,))[0])
            nux = sx * inv
            nuy = sy * inv
            dsx, dsy = mad((n, n), (dux, duy), (dn * ux, dn * uy))
            dsx, dsy = mad((dgx + dgx2, dgy + dgy2), (half, half), (dsx, dsy))
            # recomputed fresh each step, not accumulated: no compensation
            ndth = mad((dsy,), (nux,), (dsx * (-nuy),))[0] * inv
            kdt2 = kdt

        if second:
            chord, = mad((ddy,), (ddy,), (ddx * ddx,))
            dist = torch.sqrt(chord)
            ntt, ktt2 = _kahan(tt, ktt, dist * (n + n2) * 0.5)
            ndsim = dsim + dist
        else:
            ntt, ktt2 = _kahan(tt, ktt, ds * (n + n2) * 0.5)
            ndsim = dsim + ds

        if guards is not None:
            # the fast paths of the analytic fields' kernel (the sampled
            # media's takes the IEEE operations)
            ok = torch.ones_like(keep)
            if analytic:
                ok = field_guard(field, nx2, ny2)
                if second or rk2:
                    ok = ok & _in(n2, 2.0 ** -126, 2.0 ** 126, True)
                if second:
                    ok = ok & _in(chord, 2.0 ** -100, 2.0 ** 126)
            guards[0] += (keep & ~ok).sum()
            guards[1] += keep.sum()

        # caustic bookkeeping: a sign transition of q
        q2, = mad((dpy2,), (nux,), (dpx2 * (-nuy),))
        s_new = (q2 > 0).float() - (q2 < 0).float()
        flip = keep & (sgn != 0.0) & (s_new != 0.0) & (s_new != sgn)
        kmah = kmah + torch.where(flip, 1.0, 0.0)
        sgn = torch.where(keep & (s_new != 0.0), s_new, sgn)

        def sel(new, old):
            return torch.where(keep, new, old)

        active = active & ~(keep & _outside(nx2, ny2, box))
        x, y, cx, cy = sel(nx2, x), sel(ny2, y), sel(cx2, cx), sel(cy2, cy)
        ux, uy = sel(nux, ux), sel(nuy, uy)
        f = tuple(sel(a, b) for a, b in zip(f2, f))
        tt, dsim, ktt = sel(ntt, tt), sel(ndsim, dsim), sel(ktt2, ktt)
        dpx, dpy, dth = sel(dpx2, dpx), sel(dpy2, dpy), sel(ndth, dth)
        kdx, kdy, kdt = sel(kdx2, kdx), sel(kdy2, kdy), sel(kdt2, kdt)

    return DynState(x=x, y=y, cx=cx, cy=cy, ux=ux, uy=uy, tt=tt, dsim=dsim,
                    active=active, dpx=dpx, dpy=dpy, dth=dth, sgn=sgn,
                    kmah=kmah, kdx=kdx, kdy=kdy, kdt=kdt, ktt=ktt)


def _check_op(op: str) -> None:
    if op not in DYN_FUSED_OPS:
        raise ValueError(
            f"dynamic kernel supports ops {DYN_FUSED_OPS} (the golden ops' "
            f"tangent is zero a.e. — engine/dynamic.py), got {op!r}")


def check_dyn_state(st: DynState) -> None:
    """Device, dtype, shape and contiguity checks of a dynamic state."""
    dev, r = st.x.device, st.x.shape[0]
    for name, t in st._asdict().items():
        want = torch.bool if name == "active" else torch.float32
        if (not torch.is_tensor(t) or t.dtype != want or t.shape != (r,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"state.{name}: need a contiguous ({r},) {want} "
                             f"tensor on {dev}")


def dynamic_step(st: DynState, *, field, op: str, steps: int, delta_s,
                 step_limit, offset=0.0, box) -> DynState:
    """Advance a dynamic state ``steps`` steps: the kernels' wrapper.

    ``field`` is the medium: an analytic field name (kernel
    ``dynamic_step``), a :class:`StratTables` (``dynamic_step_strat``) or a
    :class:`GridTables` (``dynamic_step_grid``).  ``offset`` is the number
    of steps applied before this launch (``step_limit`` reads the global
    step number), so k steps then n - k with offset k equal n steps.  A CPU
    state runs :func:`dynamic_step_plain`; a CUDA state launches the
    kernel.
    """
    if isinstance(field, str) and field not in DYN_FUSED_FIELDS:
        raise ValueError(f"dynamic kernel supports fields {DYN_FUSED_FIELDS},"
                         f" got {field!r}")
    if not isinstance(field, (str, StratTables, GridTables)):
        raise ValueError("a dynamic step's medium is a field name, "
                         f"StratTables or GridTables, got "
                         f"{type(field).__name__}")
    _check_op(op)
    check_dyn_state(st)
    check_medium(field, st.x.device)
    box = tuple(float(v) for v in box)
    if st.x.device.type == "cpu":
        return dynamic_step_plain(st, field=field, op=op, steps=int(steps),
                                  delta_s=delta_s,
                                  step_limit=float(step_limit),
                                  offset=float(offset), box=box)
    if st.x.device.type != "cuda":
        raise ValueError(f"dynamic_step runs on cpu or cuda, not {st.x.device}")
    out = DynState(*(torch.empty_like(t) for t in st))
    kernel, suffix, lead, table = kernel_of(field, KERNELS)
    lib = build.library()
    with torch.cuda.device(st.x.device):
        # the refill loop's ray counter (the launch zeroes it on its stream)
        counter = (torch.empty(1, dtype=torch.int32, device=st.x.device)
                   if suffix == "_strat" else None)
        err = getattr(lib, "rt_dynamic_step" + suffix)(
            *lead, int(op[2:]), build.pointer_array(st),
            build.pointer_array(out), st.x.shape[0], int(steps),
            float(delta_s), float(step_limit), float(offset), *box, *table,
            *(() if counter is None else (counter.data_ptr(),)),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "rt_dynamic_step" + suffix)
    kernel.launches += 1
    return out


def refill_grid(field: StratTables, op: str, n: int) -> int:
    """Blocks of 128 threads that the refill loop of ``dynamic_step_strat``
    launches for ``n`` rays of ``op`` on the current CUDA device: as many
    as every SM holds at once, never more than the rays fill."""
    if not isinstance(field, StratTables):
        raise ValueError("the dynamic refill loop runs on StratTables, not "
                         f"{type(field).__name__}")
    _check_op(op)
    blocks = ctypes.c_int(0)
    build.check(build.library().rt_dynamic_refill_blocks(
        field.ch, int(op[2:]), int(n), ctypes.addressof(blocks)),
        "rt_dynamic_refill_blocks")
    return blocks.value


def _trace_final(pos0, theta0, delta_s, field, op, steps, box, device,
                 step_limit) -> DynFinal:
    _check_op(op)
    st = initial_dyn_state(pos0, theta0, device=device)
    st = dynamic_step(st, field=field, op=op, steps=steps, delta_s=delta_s,
                      step_limit=steps if step_limit is None else step_limit,
                      offset=0.0, box=box)
    # the kernel carries n = nag(x, y) of the current position; the plain
    # evaluator gives the same value at the final one
    return final_from_dyn_state(st, nag_h_fn(field)(st.x, st.y)[0])


def dynamic_trace_final(pos0, theta0, delta_s, *, field: str, op: str,
                        steps: int, box, device="cuda",
                        step_limit=None) -> DynFinal:
    """Fused dynamic trace on an analytic field (dynamic.py:609): the
    kinematics and the paraxial tangent in one launch of ``dynamic_step``.
    ``step_limit`` (default ``steps``) freezes every ray after that many
    steps."""
    if field not in DYN_FUSED_FIELDS:
        raise ValueError(f"dynamic kernel supports fields {DYN_FUSED_FIELDS},"
                         f" got {field!r}")
    return _trace_final(pos0, theta0, delta_s, field, op, steps, box, device,
                        step_limit)


def dynamic_trace_final_strat(pos0, theta0, delta_s, medium, *, op: str,
                              steps: int, box, device="cuda",
                              step_limit=None) -> DynFinal:
    """Fused dynamic trace through a stratified medium, parity or C1
    (dynamic.py:680), held on ``device``: one launch of
    ``dynamic_step_strat`` on its 1-D cell tables."""
    return _trace_final(pos0, theta0, delta_s, strat_tables(medium), op,
                        steps, box, device, step_limit)
