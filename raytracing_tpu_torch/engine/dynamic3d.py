"""3-D dynamic ray tracing (scan tier): the 2x2 paraxial Jacobian, exactly.

Port of ``raytracing_tpu/engine/dynamic3d.py``: ``DYN3_COLS``,
``DYN3_FULL_COLS`` and ``CROSS3_COLS`` (dynamic3d.py:45-63),
``Crossing3Fan``, ``Crossing3Pick`` and ``Dynamic3Result`` (:66-101),
``spreading_amplitude3`` (:104), ``transmission_loss3_db`` (:111),
``_transverse_frame`` (:118), the scan of ``_build_dynamic3_fn``
(:129-347) in its four modes (history, metrics, cross_fan, cross_pick),
``trace_dynamic3`` (:350), ``trace_crossings_fan3`` (:398) and
``trace_crossings_pick3`` (:420).  ``jax.lax.scan`` becomes a Python loop
over steps whose carry is the state of all rays, on ``device`` at
``dtype`` (float64 on the card too); ``jit=`` is gone, as in
``engine/trace3d.py``.

A point source's neighbourhood is two-parameter, so the spreading is the
2x2 Jacobian ``Q_ij = e_i . d(pos)/d(alpha_j)`` in a transverse frame
(e1, e2) carried by Gram-Schmidt transport; ``det Q`` is the ray-tube area
per unit solid angle (|det Q| -> s^2 near the source), a sign change of it
a caustic (KMAH), and the smallest |det Q| past the source regime locates
a point focus.  The amplitude is ``sqrt(n0 / (n |det Q|))``, spherical
spreading: TL(s) = 20 log10 s in a homogeneous medium.

The two tangents are the exact directional derivatives of the discrete
step map of ``engine/trace3d.py::_step3`` along the two launch angles, as
JAX's ``jax.jvp`` gives them.  Here they are written out by hand
(:func:`_step3_tangents`): the position steppers, the impulse
normalization and the exact Rodrigues rotation differentiated term by
term, with the medium's n, gradient and their derivatives along each
tangent from :func:`_medium_lin3`: the closed-form Hessians of the
analytic fields (``kernels/dynamic3d.py::field3_fn_h``) and of the
tri-Hermite patch (``media/grid3.py::blend3_h``; its df32 facade's
``engine/df_grid3.py::_hess3``), the 2-D channel
evaluators of ``engine/dynamic.py::_medium_jvp`` under ``Stratified3D``,
and ``torch.func.jvp`` of ``n_and_grad3`` for any other medium
(``Custom3D``).  PyTorch's forward-mode autodiff through the whole step
costs 70-170 µs an operation on the card (PERF.md §6, PR 4); the hand
tangent runs the step's operations once each.  The launch tangent alone
comes from ``torch.func.jvp`` of the launch chart, once a trace.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.engine.dynamic import _medium_jvp, _ordinary, _sel
from raytracing_tpu_torch.engine.trace import _torch_dtype
from raytracing_tpu_torch.engine.trace3d import (
    METHODS3, _eval3, _normalize, _sum3, canonical3)

#: history row layout of :func:`trace_dynamic3` (mode="history")
DYN3_COLS = ("x", "y", "z", "traveltime", "n", "detq", "kmah")
#: extended layout (``full_history=True``): + the unit tangent and the raw
#: position tangents d(pos)/d(alpha), d(pos)/d(beta)
DYN3_FULL_COLS = DYN3_COLS + ("ux", "uy", "uz",
                              "dpax", "dpay", "dpaz",
                              "dpbx", "dpby", "dpbz")
#: crossing-record layout (mode="cross_pick"): the state at a range-plane
#: crossing, linearly interpolated between the bracketing steps; ``kmah``
#: is the pre-crossing count
CROSS3_COLS = ("y", "z", "traveltime", "n", "detq", "kmah",
               "ux", "uy", "uz", "dpax", "dpay", "dpaz",
               "dpbx", "dpby", "dpbz")


class Crossing3Fan(NamedTuple):
    """Fan landing records: (y, z) per (ray, range, crossing ordinal)."""

    depths: Any       # (R, NR, max_ord, 2); nan where not recorded
    counts: Any       # (R, NR) int32 total crossings (may exceed max_ord)


class Crossing3Pick(NamedTuple):
    """Per-ray target-crossing state rows (:data:`CROSS3_COLS`)."""

    state: Any        # (R, 15)
    found: Any        # (R,) bool: the ray crossed its range at least once


class Dynamic3Result(NamedTuple):
    pos: Any          # (R, 3)
    unitv: Any        # (R, 3)
    n: Any            # (R,)
    traveltime: Any   # (R,)
    dist_real: Any    # (R,)
    dist_sim: Any     # (R,) sum of per-step |D|
    exit_step: Any    # (R,) int32
    Q: Any            # (R, 2, 2) paraxial Jacobian in the transported frame
    detq: Any         # (R,) det Q
    kmah: Any         # (R,) int32: sign changes of det Q
    min_absdet: Any   # (R,) smallest |det Q| seen after the source regime
    min_absdet_step: Any  # (R,) int32 step of that minimum (focus locator)
    n0: Any           # (R,)
    history: Any      # (max_size, R, 7 or 16) DYN3_(FULL_)COLS rows, or None

    def amplitude(self):
        return spreading_amplitude3(self.detq, self.n, self.n0)

    def transmission_loss_db(self):
        return transmission_loss3_db(self.detq, self.n, self.n0)


def spreading_amplitude3(detq, n, n0):
    """Point-source amplitude ``sqrt(n0 / (n |det Q|))`` (3-D tube); |det Q|
    is clamped to the dtype's smallest normal at a focus."""
    d = torch.abs(detq)
    return torch.sqrt(n0 / (n * torch.clamp(d, min=torch.finfo(d.dtype).tiny)))


def transmission_loss3_db(detq, n, n0):
    """``10 log10(n |det Q| / n0)``: 20 log10 s in a homogeneous medium."""
    d = torch.abs(detq)
    return 10.0 * torch.log10(
        n * torch.clamp(d, min=torch.finfo(d.dtype).tiny) / n0)


def _transverse_frame(u):
    """A stable orthonormal (e1, e2) transverse to ``u`` (R, 3): the seed is
    the unit axis least aligned with u (the first such axis on a tie)."""
    seed = torch.nn.functional.one_hot(torch.argmin(torch.abs(u), dim=-1),
                                       3).to(u.dtype)
    e1 = _normalize(torch.linalg.cross(seed, u, dim=-1))
    return e1, torch.linalg.cross(u, e1, dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _medium_lin3(medium, dtype):
    """``f(pos) -> (n, g, lin)`` with ``lin(dpos) -> (dn, dg)``: n and grad n
    at ``pos`` (R, 3) and their directional derivatives along dpos, what
    ``jax.jvp`` of ``medium.n_and_grad3`` gives the JAX scan; ``dpos`` is
    (K, R, 3), K directions at once.

    The analytic fields and grid3 media contract a closed-form Hessian
    (a coordinate clamped at the grid's edge has zero derivative, as the
    jvp of the clamp gives), and so does the df32 facade
    ``DfEvalMedium3``, unmasked, as JAX's ``custom_jvp`` rule gives
    (``engine/df_grid3.py::_hess3``); a user's field (``Custom3D``, or the
    ``CustomMedium`` under a ``Stratified3D``) its derivatives by
    reverse-mode autograd on its elementwise definition (:func:`_autograd`,
    ~40x faster than nested ``torch.func.jvp`` calls); a ``Stratified3D``
    of any other 2-D medium reads that medium's channels
    (``engine/dynamic.py::_medium_jvp``); any other medium goes through
    ``torch.func.jvp``.
    """
    from raytracing_tpu_torch.engine.df_grid3 import DfEvalMedium3
    from raytracing_tpu_torch.kernels.dynamic3d import field3_fn_h, hdot
    from raytracing_tpu_torch.media.fields3d import (
        Analytic3D, Custom3D, Stratified3D)
    from raytracing_tpu_torch.media.grid3 import C1Grid3Medium
    from raytracing_tpu_torch.media.medium import CustomMedium

    def hess_lin(g, h, mask=None):
        def lin(d):
            if mask is not None:
                d = d * mask
            dn = _sum3(g * d)[..., 0]
            return dn, torch.stack(hdot(h, d.unbind(-1)), dim=-1)
        return lin

    if isinstance(medium, Analytic3D):
        fh = field3_fn_h(medium.field)

        def f(pos):
            n, g = _eval3(medium, pos)
            return n, g, hess_lin(g, fh(*pos.unbind(-1))[4:])
        return f
    if isinstance(medium, C1Grid3Medium):
        def inside(v, origin, inv_h, nodes):
            raw = (v - origin) * inv_h
            return ((raw >= 0.0) & (raw <= float(nodes - 1))).to(v.dtype)

        def f(pos):
            x, y, z = pos.unbind(-1)
            n, g, h = medium.n_grad_hess3(x, y, z)
            mask = torch.stack([
                inside(x, medium.x0, medium.inv_hx, medium.nx),
                inside(y, medium.y0, medium.inv_hy, medium.ny),
                inside(z, medium.z0, medium.inv_hz, medium.nz)], dim=-1)
            g = torch.stack(g, dim=-1)
            return n, g, hess_lin(g, h, mask)
        return f
    if isinstance(medium, DfEvalMedium3):
        # JAX's custom_jvp rule (df_grid3.py:331-354): the df gradient and
        # the closed-form float32 Hessian, no autodiff through the df
        # contraction
        def f(pos):
            x, y, z = pos.unbind(-1)
            n, g = medium.n_and_grad3(x, y, z)
            g = torch.stack(g, dim=-1)
            return n, g, hess_lin(g, medium.hess3(x, y, z))
        return f
    if isinstance(medium, Custom3D):
        def f(pos):
            n, gn, g, rows = _autograd(medium.n_fn, medium.grad_fn,
                                       pos.unbind(-1))
            return n, torch.stack(g, dim=-1), _rows_lin(gn, rows)
        return f
    if isinstance(medium, Stratified3D) and isinstance(medium.base,
                                                       CustomMedium):
        base = medium.base

        def f(pos):
            n, gn, g, rows = _autograd(base.n_fn, base.grad_fn,
                                       pos[..., :2].unbind(-1))
            zero = torch.zeros_like(n)
            lin2 = _rows_lin(gn, rows)

            def lin(d):
                dn, dg = lin2(d[..., :2])
                return dn, torch.stack([torch.zeros_like(dn), dg[..., 1],
                                        torch.zeros_like(dn)], dim=-1)
            return n, torch.stack([zero, g[1], zero], dim=-1), lin
        return f
    if isinstance(medium, Stratified3D):
        jvp2 = _medium_jvp(medium.base, dtype)

        def f(pos):
            n, g = _eval3(medium, pos)

            def lin(d):
                p = pos.expand_as(d).contiguous()
                out = jvp2(p[..., 0], p[..., 1], d[..., 0], d[..., 1])
                zero = torch.zeros_like(out[3])
                return out[3], torch.stack([zero, out[5], zero], dim=-1)
            return n, g, lin
        return f

    def flat(x, y, z):
        n, g = medium.n_and_grad3(x, y, z)
        return (n, *g)

    def f(pos):
        n, g = _eval3(medium, pos)

        def lin(d):
            p = pos.expand_as(d).contiguous()
            _, t = torch.func.jvp(flat, tuple(p.unbind(-1)),
                                  tuple(d.unbind(-1)))
            return t[0], torch.stack(t[1:], dim=-1)
        return n, g, lin
    return f


def _autograd(n_fn, grad_fn, coords):
    """(n, grad n, g, J) of a user's elementwise field at ``coords`` by
    reverse-mode autograd: ``g`` is ``grad_fn``'s gradient where there is
    one, else grad n; ``J[i][j]`` = dg_i/dx_j.  What ``jax.jvp`` of the
    field's ``n_and_grad`` differentiates: n through ``n_fn``, g through
    ``grad_fn`` or the autodiff gradient."""
    with torch.enable_grad():
        xs = [c.detach().requires_grad_() for c in coords]

        def grad(out, create):
            if not (torch.is_tensor(out) and out.requires_grad):
                return [torch.zeros_like(xs[0]) for _ in xs]
            got = torch.autograd.grad(out.sum(), xs, create_graph=create,
                                      retain_graph=True, allow_unused=True)
            return [torch.zeros_like(xs[0]) if t is None else t for t in got]

        n = n_fn(*xs)
        gn = grad(n, True)
        g = list(grad_fn(*xs)) if grad_fn is not None else gn
        g = [gi if torch.is_tensor(gi) else torch.full_like(xs[0], gi)
             for gi in g]
        rows = [grad(gi, False) for gi in g]
    n = torch.broadcast_to(n, xs[0].shape) if torch.is_tensor(n) else \
        torch.full_like(xs[0], n)
    return (n.detach(), [t.detach() for t in gn], [t.detach() for t in g],
            [[t.detach() for t in r] for r in rows])


def _rows_lin(gn, rows):
    """``lin(d) -> (dn, dg)`` from grad n and the Jacobian rows of g."""
    def lin(d):
        dc = d.unbind(-1)
        dn = sum(a * b for a, b in zip(gn, dc))
        return dn, torch.stack([sum(a * b for a, b in zip(r, dc))
                                for r in rows], dim=-1)
    return lin


def _rodrigues_lin(u, rho, tiny):
    """``engine/trace3d.py::_rodrigues(u, rho)`` (the same operations) and
    its differential ``lin(du, drho)``: the exact rotation's sinc/versine
    forms with the floor ``tiny`` differentiated term by term."""
    a2 = _sum3(rho * rho)
    a = torch.sqrt(a2 + tiny)
    ca, sa = torch.cos(a), torch.sin(a)
    sinc = sa / a
    den = a2 + tiny
    vers = (1.0 - ca) / den
    c = _cross(rho, u)
    rdotu = _sum3(rho * u)
    out = u * ca + c * sinc + rho * rdotu * vers

    def lin(du, drho):
        da2 = 2.0 * _sum3(rho * drho)
        da = da2 / (2.0 * a)
        dsinc = (ca * da - sinc * da) / a
        dvers = (sa * da - vers * da2) / den
        dc = _cross(drho, u) + _cross(rho, du)
        drdotu = _sum3(drho * u) + _sum3(rho * du)
        return (du * ca - u * (sa * da) + dc * sinc + c * dsinc
                + drho * rdotu * vers + rho * drdotu * vers
                + rho * rdotu * dvers)
    return out, lin


def _step3_tangents(order: int, solver: str, pt, tans, lin_at, ds, tiny):
    """One step of ``engine/trace3d.py::_step3`` on ``pt`` = (pos, unitv, n,
    grad) and its directional derivative along each tangent of ``tans``,
    (dpos, du, dn, dg) each: returns (the new point, the new tangents).
    The primal performs ``_step3``'s operations in its order."""
    pos, u, n, g = pt
    nn = n[..., None]
    gdotu = _sum3(g * u)
    t = g - gdotu * u
    if order == 1:
        pos2 = pos + u * ds
    else:
        tq = t * (ds * ds)
        den = 2.0 * nn
        pos2 = pos + u * ds + tq / den
    n2, g2, lin2 = lin_at(pos2)
    n2n = n2[..., None]
    if solver == "impulse":
        p = nn * u + ds * (g + g2) / 2.0
        nrm = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        u2 = p / nrm
    else:
        k1 = ds * t / nn
        rho1 = _cross(u, k1)
        um, rot1 = _rodrigues_lin(u, rho1, tiny)
        gum = _sum3(g2 * um)
        t2 = g2 - gum * um
        k2 = ds * t2 / n2n
        u2, rot = _rodrigues_lin(u, (rho1 + _cross(um, k2)) / 2.0, tiny)

    # both tangents at once, stacked on a leading axis
    dpos, du, dn, dg = (torch.stack(c) for c in zip(*tans))
    dnn = dn[..., None]
    dt = dg - (_sum3(dg * u) + _sum3(g * du)) * u - gdotu * du
    if order == 1:
        dpos2 = dpos + du * ds
    else:
        dpos2 = (dpos + du * ds + dt * (ds * ds) / den
                 - tq * (2.0 * dnn) / (den * den))
    dn2, dg2 = lin2(dpos2)
    if solver == "impulse":
        dp = dnn * u + nn * du + ds * (dg + dg2) / 2.0
        du2 = (dp - u2 * _sum3(u2 * dp)) / nrm
    else:
        dk1 = ds * dt / nn - ds * t * dnn / (nn * nn)
        drho1 = _cross(du, k1) + _cross(u, dk1)
        dum = rot1(du, drho1)
        dt2 = dg2 - (_sum3(dg2 * um) + _sum3(g2 * dum)) * um - gum * dum
        dk2 = ds * dt2 / n2n - ds * t2 * dn2[..., None] / (n2n * n2n)
        drho = (drho1 + _cross(dum, k2) + _cross(um, dk2)) / 2.0
        du2 = rot(du, drho)
    return (pos2, u2, n2, g2), list(zip(dpos2, du2, dn2, dg2))


def _q_of(tans, frame):
    """(R, 2, 2) Q: rows the frame vectors e_i, columns the launch angles."""
    e1c, e2c = frame
    cols = [torch.stack([torch.sum(t[0] * e1c, -1), torch.sum(t[0] * e2c, -1)],
                        -1) for t in tans]
    return torch.stack(cols, -1)


def _det2(Q):
    return Q[..., 0, 0] * Q[..., 1, 1] - Q[..., 0, 1] * Q[..., 1, 0]


def _run(method, pos0, dir0, medium, ds, step_limit, *, max_size, box, mode,
         dtype, full_history=False, max_ord=8, aux=None):
    """The scan of dynamic3d.py:143-347 as a loop over steps."""
    order, solver = METHODS3[method]
    history = mode == "history"
    cross_fan = mode == "cross_fan"
    cross_pick = mode == "cross_pick"
    npdt = np.float64 if dtype == torch.float64 else np.float32
    tiny = float(npdt(np.finfo(npdt).tiny ** 0.45))
    lin_at = _medium_lin3(medium, dtype)

    u0 = _normalize(dir0)
    e1, e2 = _transverse_frame(u0)
    zeros = torch.zeros_like(pos0[..., 0])
    ones = torch.ones_like(zeros)

    # the two-angle launch chart: u0 turned toward e1 by a, e2 by b; at
    # (0, 0) its derivatives are the launch tangents.  The source is fixed:
    # d(pos), dn and dg start at 0
    def chart(a, b):
        return _normalize(u0 + a[..., None] * e1 + b[..., None] * e2)

    u_l, du_a = torch.func.jvp(lambda a: chart(a, zeros), (zeros,), (ones,))
    _, du_b = torch.func.jvp(lambda b: chart(zeros, b), (zeros,), (ones,))
    if not bool((torch.linalg.vector_norm(du_a, dim=-1) > 0.5).all()):
        raise RuntimeError(
            "torch.func.jvp returned no launch tangent with grad mode "
            f"{torch.is_grad_enabled()} and inference mode "
            f"{torch.is_inference_mode_enabled()}: the dynamic tier cannot "
            "run in this autograd mode")
    n_src, g0, _ = lin_at(pos0)
    pt0 = (pos0, u_l, n_src, g0)
    t1 = (torch.zeros_like(pos0), du_a, zeros, torch.zeros_like(pos0))
    t2 = (torch.zeros_like(pos0), du_b, zeros, torch.zeros_like(pos0))

    pt, ta, tb = pt0, t1, t2
    tt, dreal, dsim = zeros, zeros, zeros
    active = torch.ones_like(zeros, dtype=torch.bool)
    exit_step = torch.full_like(zeros, min(max_size - 1, step_limit),
                                dtype=torch.int32)
    e1c, e2c = e1, e2
    sgn = torch.zeros_like(zeros, dtype=torch.int8)
    kmah = torch.zeros_like(zeros, dtype=torch.int32)
    mind = torch.full_like(zeros, float("inf"))
    minstep = torch.zeros_like(zeros, dtype=torch.int32)
    if cross_fan:
        ranges = aux
        cnt = torch.zeros(zeros.shape + ranges.shape, dtype=torch.int32,
                          device=zeros.device)
        rec = torch.full(zeros.shape + ranges.shape + (max_ord, 2),
                         float("nan"), dtype=dtype, device=zeros.device)
        ords = torch.arange(max_ord, dtype=torch.int32, device=zeros.device)
    elif cross_pick:
        xr, ordk = aux
        cnt = torch.zeros_like(zeros, dtype=torch.int32)
        rec = torch.zeros(zeros.shape + (len(CROSS3_COLS),), dtype=dtype,
                          device=zeros.device)
    rows = []

    for i in range(1, max_size):
        frame0 = (e1c, e2c)
        pt_a, (ta_n, tb_n) = _step3_tangents(order, solver, pt, (ta, tb),
                                             lin_at, ds, tiny)
        pos2, _, n2, _ = pt_a
        dist = torch.linalg.vector_norm(pos2 - pt[0], dim=-1)
        tt_n = tt + dist * (pt[2] + n2) / 2.0

        pt2 = _sel(active, pt_a, pt)
        ta2 = _sel(active, ta_n, ta)
        tb2 = _sel(active, tb_n, tb)
        tt2 = torch.where(active, tt_n, tt)
        dreal2 = torch.where(active, dreal + ds, dreal)
        dsim2 = torch.where(active, dsim + dist, dsim)

        # Gram-Schmidt transport of the transverse frame (smooth: the sign
        # of det Q cannot flip from a frame jump)
        un = pt2[1]
        e1n = _normalize(e1c - _sum3(e1c * un) * un)
        e2n = _cross(un, e1n)
        e1c = torch.where(active[..., None], e1n, e1c)
        e2c = torch.where(active[..., None], e2n, e2c)

        det = _det2(_q_of((ta2, tb2), (e1c, e2c)))
        s_new = torch.sign(det).to(torch.int8)
        flip = active & (sgn != 0) & (s_new != 0) & (s_new != sgn)
        kmah2 = kmah + flip.to(torch.int32)
        sgn2 = torch.where(active & (s_new != 0), s_new, sgn)
        # focus locator: min |det| once past the source regime (|det| grows
        # ~s^2 from 0)
        better = active & (torch.abs(det) < mind) if i > 4 else None
        if better is not None:
            mind = torch.where(better, torch.abs(det), mind)
            minstep = torch.where(better, i, minstep).to(torch.int32)

        x, y, z = pt2[0][..., 0], pt2[0][..., 1], pt2[0][..., 2]
        if box is None:
            out = torch.zeros_like(active)
        else:
            out = active & ((x < box[0]) | (x > box[1]) | (y < box[2])
                            | (y > box[3]) | (z < box[4]) | (z > box[5]))
        exit2 = torch.where(out, i, exit_step).to(torch.int32)
        active2 = active & ~out & (i < step_limit)

        # range-plane crossing records: pre-step x (pt) vs post-select x
        # (pt2): frozen rays have x0 == x1 and never hit
        if cross_fan:
            x0 = pt[0][..., 0]
            d0 = x0[:, None] - ranges[None, :]
            d1 = x[:, None] - ranges[None, :]
            hit = (d0 < 0) != (d1 < 0)
            frac = torch.where(hit, d0 / torch.where(
                hit, (x0 - x)[:, None], 1.0), 0.0)
            y0, z0 = pt[0][..., 1], pt[0][..., 2]
            yz = torch.stack([y0[:, None] + frac * (y - y0)[:, None],
                              z0[:, None] + frac * (z - z0)[:, None]], -1)
            oh = hit[:, :, None] & (cnt[:, :, None] == ords)
            cnt = cnt + hit.to(torch.int32)
            rec = torch.where(oh[..., None], yz[:, :, None, :], rec)
        elif cross_pick:
            x0 = pt[0][..., 0]
            d0, d1 = x0 - xr, x - xr
            hit = (d0 < 0) != (d1 < 0)
            frac = torch.where(hit, d0 / torch.where(hit, x0 - x, 1.0), 0.0)
            # pre-step det Q in the pre-step frame (the lerp partner)
            det0 = _det2(_q_of((ta, tb), frame0))

            def lerp(a, b):
                return a + frac * (b - a)

            row = torch.stack(
                [lerp(pt[0][..., 1], y), lerp(pt[0][..., 2], z),
                 lerp(tt, tt2), lerp(pt[2], pt2[2]), lerp(det0, det),
                 kmah.to(dtype)]                          # pre-crossing
                + [lerp(pt[1][..., k], pt2[1][..., k]) for k in range(3)]
                + [lerp(ta[0][..., k], ta2[0][..., k]) for k in range(3)]
                + [lerp(tb[0][..., k], tb2[0][..., k]) for k in range(3)],
                dim=-1)
            # the LAST crossing with ordinal <= ordk (the eigenray solver's
            # fall-back semantics)
            take = hit & (cnt <= ordk)
            cnt = cnt + hit.to(torch.int32)
            rec = torch.where(take[:, None], row, rec)

        if history:
            cols = [x, y, z, tt2, pt2[2], det, kmah2.to(dtype)]
            if full_history:
                cols += [pt2[1][..., k] for k in range(3)]
                cols += [ta2[0][..., k] for k in range(3)]
                cols += [tb2[0][..., k] for k in range(3)]
            rows.append(torch.stack(cols, -1))
        pt, ta, tb, tt, dreal, dsim = pt2, ta2, tb2, tt2, dreal2, dsim2
        active, exit_step, sgn, kmah = active2, exit2, sgn2, kmah2
        # a frozen ray never changes again, so once every ray is frozen the
        # remaining steps change nothing but the history's rows (checked
        # every 64 steps: each check waits for the device)
        if not history and i % 64 == 0 and not bool(active.any()):
            break

    if cross_fan:
        return Crossing3Fan(depths=rec, counts=cnt)
    if cross_pick:
        return Crossing3Pick(state=rec, found=cnt > 0)
    Qf = _q_of((ta, tb), (e1c, e2c))
    hist = None
    if history:
        cols0 = [pos0[..., 0], pos0[..., 1], pos0[..., 2], zeros, n_src,
                 zeros, zeros]
        if full_history:
            cols0 += [u_l[..., k] for k in range(3)]
            cols0 += [t1[0][..., k] for k in range(3)]
            cols0 += [t2[0][..., k] for k in range(3)]
        hist = torch.stack([torch.stack(cols0, -1)] + rows, dim=0)
    return Dynamic3Result(pos=pt[0], unitv=pt[1], n=pt[2], traveltime=tt,
                          dist_real=dreal, dist_sim=dsim, exit_step=exit_step,
                          Q=Qf, detq=_det2(Qf), kmah=kmah, min_absdet=mind,
                          min_absdet_step=minstep, n0=n_src, history=hist)


def _args3(method, pos0, dir0, delta_s, steps, box, step_limit, dtype,
           device):
    """Validated launch arguments on ``device``: (method, dtype, pos0, dir0,
    ds, max_size, step_limit, box).  The step rounds to the working dtype,
    as JAX's traced scalar does."""
    method = canonical3(method)
    dtype = _torch_dtype(dtype)

    def vec(a):
        if torch.is_tensor(a):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pos0, dir0 = vec(pos0), vec(dir0)
    if pos0.dim() != 2 or pos0.shape[-1] != 3 or dir0.shape != pos0.shape:
        raise ValueError(f"pos0/dir0 must both be (rays, 3), got "
                         f"{tuple(pos0.shape)} / {tuple(dir0.shape)}")
    max_size = int(steps) + 1
    step_limit = max_size - 1 if step_limit is None else int(step_limit)
    box_t = tuple(float(b) for b in box) if box is not None else None
    if box_t is not None and len(box_t) != 6:
        raise ValueError(f"box must be 6 floats (x0,x1,y0,y1,z0,z1), "
                         f"got {box!r}")
    ds = torch.tensor(delta_s, dtype=dtype, device=pos0.device)
    return method, dtype, pos0, dir0, ds, max_size, step_limit, box_t


def _traced(fn, *args, aux=None, **kw):
    """Run the scan with inference mode off, on ordinary copies of any
    inference tensors (``torch.func.jvp`` may record no tangent inside
    ``torch.inference_mode()``: engine/dynamic.py)."""
    with torch.inference_mode(False):
        return fn(*(_ordinary(a) for a in args), aux=_ordinary(aux), **kw)


def trace_dynamic3(method: str, medium, *, pos0, dir0, delta_s: float,
                   steps: int, box=None, mode: str = "history",
                   dtype=torch.float64, step_limit: int | None = None,
                   full_history: bool = False,
                   device="cuda") -> Dynamic3Result:
    """Trace 3-D rays AND their 2x2 paraxial Jacobians on ``device``.

    Launch interface of :func:`engine.trace3d.trace3d`; the result adds
    ``Q`` / ``det Q`` (tube area per solid angle), the KMAH count (det sign
    changes), a focus locator (the minimum |det Q| and its step) and the
    spherical-spreading amplitude and TL.  ``dtype`` is a torch or numpy
    float dtype; a sampled medium's table must lie on ``device``.
    """
    if mode not in ("history", "metrics"):
        raise ValueError(f"mode must be 'history' or 'metrics', got {mode!r}")
    method, dtype, p0, d0, ds, max_size, step_limit, box_t = _args3(
        method, pos0, dir0, delta_s, steps, box, step_limit, dtype, device)
    return _traced(_run, method, p0, d0, medium, ds, step_limit,
                   max_size=max_size, box=box_t, mode=mode, dtype=dtype,
                   full_history=bool(full_history))


def trace_crossings_fan3(method: str, medium, *, pos0, dir0,
                         delta_s: float, steps: int, ranges,
                         max_ord: int = 8, box=None, dtype=torch.float64,
                         step_limit: int | None = None,
                         device="cuda") -> Crossing3Fan:
    """3-D dynamic fan trace recording range-plane crossings as it goes:
    every fan ray's (y, z) landing at every receiver range ``x ==
    ranges[k]``, per crossing ordinal up to ``max_ord`` (more are counted,
    not recorded), linearly interpolated between the bracketing steps; the
    eigenray seed scan reads (R, NR, max_ord, 2), never a history."""
    method, dtype, p0, d0, ds, max_size, step_limit, box_t = _args3(
        method, pos0, dir0, delta_s, steps, box, step_limit, dtype, device)
    return _traced(_run, method, p0, d0, medium, ds, step_limit,
                   max_size=max_size, box=box_t, mode="cross_fan",
                   dtype=dtype, max_ord=int(max_ord),
                   aux=torch.as_tensor(np.asarray(ranges), dtype=dtype,
                                       device=p0.device))


def trace_crossings_pick3(method: str, medium, *, pos0, dir0,
                          delta_s: float, steps: int, xr, ordk, box=None,
                          dtype=torch.float64,
                          step_limit: int | None = None,
                          device="cuda") -> Crossing3Pick:
    """3-D dynamic trace recording each ray's own target crossing: ray
    ``r`` brings home the interpolated :data:`CROSS3_COLS` state at its
    ``ordk[r]``-th crossing of ``x == xr[r]``, or its last crossing where it
    has fewer.  The Gauss-Newton polish's view."""
    method, dtype, p0, d0, ds, max_size, step_limit, box_t = _args3(
        method, pos0, dir0, delta_s, steps, box, step_limit, dtype, device)
    return _traced(_run, method, p0, d0, medium, ds, step_limit,
                   max_size=max_size, box=box_t, mode="cross_pick",
                   dtype=dtype,
                   aux=(torch.as_tensor(np.asarray(xr), dtype=dtype,
                                        device=p0.device),
                        torch.as_tensor(np.asarray(ordk, np.int32),
                                        device=p0.device)))
