"""Dynamic ray tracing (scan tier): paraxial spreading, caustics, amplitudes.

Port of ``raytracing_tpu/engine/dynamic.py``: ``DYN_COLS`` (dynamic.py:59),
``HAND_TANGENT`` (:64), ``DynamicResult`` (:67), ``spreading_amplitude``
(:92), ``transmission_loss_db`` (:107), ``CrossingFan`` (:119),
``CROSS_COLS`` (:136), ``CrossingPick`` (:139), ``_build_dynamic_fn``
(:154-474) in its four modes, ``trace_dynamic`` (:477),
``trace_crossings_fan`` (:529) and ``trace_crossings_pick`` (:560).

The paraxial system is the directional derivative of the discrete step map
with respect to the launch angle: ``torch.func.jvp`` of the op's step
(``ops/registry.build_op``) carries it exactly, the tangent of the
integrator itself.  The step is wrapped as a function of a tuple of tensors
(the position, angle, unit tangent, n, grad n, anisotropy factor and, for
op7, the position window), the form ``torch.func.jvp`` takes.  op6 (the
eigenray op) gets the hand-written step with Kahan carries on its primal
and tangent accumulators instead (``HAND_TANGENT``), the same map.

Quantities per ray: ``q`` the transverse spreading (dpos . u_perp; q ~ s
near the source, a zero of q is a caustic), ``kmah`` the number of sign
transitions of q, ``dtheta`` d(angle)/d(theta0).  The 2-D point-source
amplitude is ``sqrt(n0 / (n |q|))``, unit at unit arc length in a
homogeneous medium; isotropic media only (for gamma != 1 q and kmah stay
geometric).  A golden op's tangent is zero almost everywhere: use op1-op4,
op6-op8, op12 or op10n/op11n.

Python loops replace ``jax.lax.scan`` and every mode runs on ``device`` at
``dtype``; float64 runs on the card as well as on the CPU.  ``box`` is a
run-time argument, never a cache key.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.media.fields import anisotropy
from raytracing_tpu_torch.engine.trace import _torch_dtype
from raytracing_tpu_torch.ops import angles as A
from raytracing_tpu_torch.ops.registry import RayPoint, build_op, canonical

#: history row layout of :func:`trace_dynamic` (mode="history")
DYN_COLS = ("x", "y", "traveltime", "angle", "q", "kmah", "n")

#: use the compensated hand-written step and tangent for op6; False gives
#: every op the plain ``torch.func.jvp`` tangent (read when a run starts)
HAND_TANGENT = True

#: column order of CrossingPick.state
CROSS_COLS = ("y", "traveltime", "angle", "q", "kmah", "n")

# the carried point as a tuple of tensors (RayPoint's fields, window last)
_POS, _ANG, _U, _N, _G, _COEF, _WIN = range(7)


class DynamicResult(NamedTuple):
    """Kinematic + paraxial state after a dynamic trace."""

    pos: Any          # (R, 2) final positions
    angle: Any        # (R,)   final angles
    n: Any            # (R,)   isotropic index at the final position
    traveltime: Any   # (R,)   optical path (trapezoid of coef*n)
    dist_sim: Any     # (R,)   accumulated Euclidean distance
    dist_real: Any    # (R,)   accumulated expected arc length
    exit_step: Any    # (R,)   int32 last written step
    q: Any            # (R,)   transverse spreading d(pos_perp)/d(theta0)
    dtheta: Any       # (R,)   paraxial slope d(angle)/d(theta0)
    kmah: Any         # (R,)   int32 caustic count (sign changes of q)
    n0: Any           # (R,)   index at the source (amplitude reference)
    history: Any      # (max_size, R, 7) DYN_COLS rows, or None

    def amplitude(self):
        """Point-source pressure amplitude at the final position."""
        return spreading_amplitude(self.q, self.n, self.n0)

    def transmission_loss_db(self):
        """-20 log10 of :meth:`amplitude` (dB re unit arc length)."""
        return transmission_loss_db(self.q, self.n, self.n0)


def spreading_amplitude(q, n, n0):
    """2-D point-source amplitude ``sqrt(n0 / (n |q|))``; at a caustic
    (q == 0) |q| is clamped to the dtype's smallest normal, so the value
    stays finite."""
    q = torch.abs(q)
    return torch.sqrt(n0 / (n * torch.clamp(q, min=torch.finfo(q.dtype).tiny)))


def transmission_loss_db(q, n, n0):
    """Transmission loss ``10 log10(n |q| / n0)`` dB re unit arc length."""
    q = torch.abs(q)
    return 10.0 * torch.log10(
        n * torch.clamp(q, min=torch.finfo(q.dtype).tiny) / n0)


def _perp(angle):
    """Unit normal to the ray direction: e_perp = (-sin, cos)."""
    return torch.stack([-torch.sin(angle), torch.cos(angle)], dim=-1)


class CrossingFan(NamedTuple):
    """Range-line crossings of a whole fan, recorded during the trace.

    ``depths[r, j, k]`` is the depth of fan ray ``r``'s k-th crossing of the
    range line ``x == ranges[j]`` (nan where it crosses fewer than k+1
    times); ``counts`` the total crossings (which may exceed ``max_ord``).
    """

    depths: Any   # (R, NR, max_ord)
    counts: Any   # (R, NR) int32


class CrossingPick(NamedTuple):
    """Per-ray state at its own target crossing: ray ``r`` records the
    interpolated state (CROSS_COLS; kmah from the pre-crossing step) at its
    ``min(ordk[r], count - 1)``-th crossing of ``x == xr[r]``."""

    state: Any    # (R, 6) CROSS_COLS; zero rows where found is False
    found: Any    # (R,) bool: at least one crossing


def _sel(keep, new, old):
    """Per-ray select over tuples of tensors of leading shape (R,)."""
    def one(a, b):
        return torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return tuple(one(a, b) for a, b in zip(new, old))


def _kadd(old, inc, comp):
    """Kahan step on a true (unrounded-sum) increment: (sum, compensation)."""
    y = inc - comp
    t = old + y
    return t, (t - old) - y


def _medium_jvp(medium, dtype):
    """``f(x, y, dx, dy) -> (n, gx, gy, dn, dgx, dgy)``: n and grad n at
    (x, y) and their directional derivatives along (dx, dy).

    What ``jax.jvp(medium.n_and_grad)`` gives the JAX hand step.  For the
    analytic fields and the stratified and 2-D grid tables it is read from
    the closed-form 9 channels of the dynamic kernels' evaluators
    (``kernels/dynamic.py``) at the working dtype, with the derivative of a
    coordinate clamped at the table's edge set to zero, as the jvp of the
    clamp gives: PyTorch's forward-mode autodiff through a table lookup
    cost 7-12 ms a step on the CPU (an op mixing a dual and a plain operand
    runs the zero tangent through Python reference kernels), the channels
    ~1 ms.  Any other medium (``CustomMedium``) goes through
    ``torch.func.jvp``.
    """
    from raytracing_tpu_torch.engine.fast import GRID_MEDIA, STRAT_MEDIA
    from raytracing_tpu_torch.kernels import dynamic as kd
    from raytracing_tpu_torch.media.medium import AnalyticMedium

    def inside(v, origin, inv_h, nodes):
        raw = (v - origin) * inv_h
        return ((raw >= 0.0) & (raw <= float(nodes - 1))).to(v.dtype)

    if isinstance(medium, AnalyticMedium):
        nag = kd.field_fn_h(medium.field)
        mask = None
    elif isinstance(medium, STRAT_MEDIA):
        from raytracing_tpu_torch.kernels.fused import strat_tables
        t = strat_tables(medium, dtype)
        nag = kd.strat_nag_h(t)

        def mask(x, y):
            return torch.ones_like(x), inside(y, t.y0, t.inv_hy, t.ny)
    elif isinstance(medium, GRID_MEDIA):
        from raytracing_tpu_torch.engine.segmented import grid_tables
        from raytracing_tpu_torch.media.hermite import build_hermite_medium
        from raytracing_tpu_torch.media.spline import GridMedium
        if isinstance(medium, GridMedium):
            # the same spline in node form, at the working precision
            medium = build_hermite_medium(medium, dtype=dtype)
        g = grid_tables(medium, dtype)
        nag = kd.tile_nag_h(g)

        def mask(x, y):
            return (inside(x, g.x0, g.inv_hx, g.nx),
                    inside(y, g.y0, g.inv_hy, g.ny))
    else:
        def nag3(x, y):
            n, (gx, gy) = medium.n_and_grad(x, y)
            return n, gx, gy

        def f(x, y, dx, dy):
            return sum(torch.func.jvp(nag3, (x, y), (dx, dy)), ())
        return f

    def f(x, y, dx, dy):
        n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy = nag(x, y)
        if mask is not None:
            mx, my = mask(x, y)
            dx, dy = dx * mx, dy * my
        return (n, gx, gy, gnx * dx + gny * dy, hxx * dx + hxy * dy,
                hyx * dx + hyy * dy)
    return f


def _build_dynamic_fn(op_name: str, max_size: int, mode: str, dtype,
                      max_ord: int = 0):
    """The dynamic scan: primal step + exact tangent (dynamic.py:154-474).

    ``mode``: "history" / "metrics", or the two crossing-recording modes
    "cross_fan" / "cross_pick" (:class:`CrossingFan` /
    :class:`CrossingPick`), whose extra operands ride in ``aux`` (the
    receiver ranges, or the per-ray (xr, ordk) targets).  Returns ``run``.
    """
    op = build_op(op_name, dtype)
    history = mode == "history"
    cross_fan = mode == "cross_fan"
    cross_pick = mode == "cross_pick"
    hand = HAND_TANGENT and op_name == "op6"
    windowed = op.uses_window

    def _run(pos0, theta0, medium, gamma, delta_s, step_limit, box, aux):
        limx_i, limx_s, limy_i, limy_s = box
        r = theta0.shape[0]
        nag_jvp = _medium_jvp(medium, dtype) if hand else None

        def nag3(x, y):
            n, (gx, gy) = medium.n_and_grad(x, y)
            return n, gx, gy

        def launch(th):
            unitv = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)
            n0, gx, gy = nag3(pos0[..., 0], pos0[..., 1])
            # pos0 is a constant of the map: its tangent is zero, the
            # source point is held fixed
            return (pos0, th, unitv, n0, torch.stack([gx, gy], dim=-1),
                    anisotropy(th, gamma))

        # d(launch)/d(theta0): the point-source paraxial basis
        pt0, dpt0 = torch.func.jvp(launch, (theta0,),
                                   (torch.ones_like(theta0),))
        if not bool((dpt0[_ANG] == 1).all()):
            raise RuntimeError(
                "torch.func.jvp returned no launch tangent (d theta / d "
                "theta0 != 1) with grad mode "
                f"{torch.is_grad_enabled()} and inference mode "
                f"{torch.is_inference_mode_enabled()}: the dynamic tier "
                "cannot run in this autograd mode")
        if windowed:
            pt0 += (pos0[:, None, :].expand(r, 4, 2).clone(),)
            dpt0 += (torch.zeros_like(pt0[_WIN]),)
        n_src = pt0[_N]

        def step_fn(i):
            def f(*p):
                pt = RayPoint(pos=p[_POS], angle=p[_ANG], unitv=p[_U],
                              n=p[_N], grad=p[_G], coef=p[_COEF],
                              window=p[_WIN] if windowed else None)
                res = op(pt, i, medium, gamma, delta_s)
                out = (res.pos, res.angle,
                       torch.stack([torch.cos(res.angle),
                                    torch.sin(res.angle)], dim=-1),
                       res.n, res.grad, anisotropy(res.angle, gamma))
                if windowed:
                    out += (A.push_window(pt.window, res.pos),)
                return out
            return f

        def hand_step(pt, dpt, comps):
            """op6's step AND tangent with compensated carries
            (dynamic.py:240-322): the second-order Taylor position and the
            RK2 angle, Kahan on position, angle and both tangents; field
            values and their derivatives along dpos at each point from
            :func:`_medium_jvp`.  Isotropic by construction."""
            cpp, cpa, cdp, cda, ctt = comps
            ds = delta_s
            a = pt[_ANG]
            ux, uy = pt[_U][..., 0], pt[_U][..., 1]
            dpx, dpy = dpt[_POS][..., 0], dpt[_POS][..., 1]
            da = dpt[_ANG]
            dux, duy = -da * uy, da * ux
            n, gx, gy, dn, dgx, dgy = nag_jvp(pt[_POS][..., 0],
                                              pt[_POS][..., 1], dpx, dpy)

            gdotu = gx * ux + gy * uy
            tx = gx - gdotu * ux
            ty = gy - gdotu * uy
            dgdotu = dgx * ux + dgy * uy + gx * dux + gy * duy
            dtx = dgx - dgdotu * ux - gdotu * dux
            dty = dgy - dgdotu * uy - gdotu * duy
            inv_n = 1.0 / n
            half = ds * ds * 0.5 * inv_n
            dd = torch.stack([ux * ds + tx * half, uy * ds + ty * half], -1)
            ddp = torch.stack([dux * ds + (dtx - tx * dn * inv_n) * half,
                               duy * ds + (dty - ty * dn * inv_n) * half], -1)
            pos_c, cpp_n = _kadd(pt[_POS], dd, cpp)
            dpos_c, cdp_n = _kadd(dpt[_POS], ddp, cdp)

            n2, gx2, gy2, dn2, dgx2, dgy2 = nag_jvp(
                pos_c[..., 0], pos_c[..., 1], dpos_c[..., 0], dpos_c[..., 1])

            ca, sa = ux, uy
            c1 = ca * gy - sa * gx
            k1 = ds * c1 * inv_n
            dc1 = da * (-sa * gy - ca * gx) + ca * dgy - sa * dgx
            dk1 = ds * (dc1 - c1 * dn * inv_n) * inv_n
            a1 = a + k1
            ca1, sa1 = torch.cos(a1), torch.sin(a1)
            inv_n2 = 1.0 / n2
            c2 = ca1 * gy2 - sa1 * gx2
            k2 = ds * c2 * inv_n2
            dc2 = ((da + dk1) * (-sa1 * gy2 - ca1 * gx2)
                   + ca1 * dgy2 - sa1 * dgx2)
            dk2 = ds * (dc2 - c2 * dn2 * inv_n2) * inv_n2
            ang_c, cpa_n = _kadd(a, (k1 + k2) * 0.5, cpa)
            dang_c, cda_n = _kadd(da, (dk1 + dk2) * 0.5, cda)

            unitv_n = torch.stack([torch.cos(ang_c), torch.sin(ang_c)], -1)
            uperp = torch.stack([-unitv_n[..., 1], unitv_n[..., 0]], -1)
            pt_n = (pos_c, ang_c, unitv_n, n2, torch.stack([gx2, gy2], -1),
                    anisotropy(ang_c, gamma))
            dpt_n = (dpos_c, dang_c, dang_c[..., None] * uperp, dn2,
                     torch.stack([dgx2, dgy2], -1), dpt[_COEF])
            return pt_n, dpt_n, (cpp_n, cpa_n, cdp_n, cda_n, ctt)

        pt, dpt = pt0, dpt0
        zeros = torch.zeros_like(theta0)
        tt, dsim, dreal = zeros, zeros, zeros
        active = torch.ones_like(theta0, dtype=torch.bool)
        exit_step = torch.full_like(theta0, min(max_size - 1, step_limit),
                                    dtype=torch.int32)
        sgn = torch.zeros_like(theta0, dtype=torch.int8)
        kmah = torch.zeros_like(theta0, dtype=torch.int32)
        comps = (torch.zeros_like(pt0[_POS]), zeros,
                 torch.zeros_like(pt0[_POS]), zeros, zeros)
        if cross_fan:
            ranges = aux
            cnt = torch.zeros(theta0.shape + ranges.shape, dtype=torch.int32,
                              device=theta0.device)
            rec = torch.full(theta0.shape + ranges.shape + (max_ord,),
                             float("nan"), dtype=theta0.dtype,
                             device=theta0.device)
            ords = torch.arange(max_ord, dtype=torch.int32,
                                device=theta0.device)
        elif cross_pick:
            xr, ordk = aux
            cnt = torch.zeros_like(theta0, dtype=torch.int32)
            rec = torch.zeros(theta0.shape + (6,), dtype=theta0.dtype,
                              device=theta0.device)
        rows = []

        for i in range(1, max_size):
            if hand:
                pt_n, dpt_n, comps_n = hand_step(pt, dpt, comps)
            else:
                pt_n, dpt_n = torch.func.jvp(step_fn(i), pt, dpt)
                comps_n = comps

            # traveltime's increment is formed before the carry addition: a
            # true increment, so Kahan applies in both modes
            dist = torch.linalg.vector_norm(pt_n[_POS] - pt[_POS], dim=-1)
            tt_inc = dist * (pt[_COEF] * pt[_N]
                             + pt_n[_COEF] * pt_n[_N]) / 2.0
            tt_n, ctt_n = _kadd(tt, tt_inc, comps_n[4])
            comps_n = comps_n[:4] + (ctt_n,)

            pt2 = _sel(active, pt_n, pt)
            dpt2 = _sel(active, dpt_n, dpt)
            tt2 = torch.where(active, tt_n, tt)
            comps2 = _sel(active, comps_n, comps)
            dsim2 = torch.where(active, dsim + dist, dsim)
            dreal2 = torch.where(active, dreal + delta_s, dreal)

            q = torch.sum(dpt2[_POS] * _perp(pt2[_ANG]), dim=-1)
            s_new = torch.sign(q).to(torch.int8)
            flip = active & (sgn != 0) & (s_new != 0) & (s_new != sgn)
            kmah2 = kmah + flip.to(torch.int32)
            sgn2 = torch.where(active & (s_new != 0), s_new, sgn)

            x, y = pt2[_POS][..., 0], pt2[_POS][..., 1]
            out = (x > limx_s) | (x < limx_i) | (y > limy_s) | (y < limy_i)
            exit2 = torch.where(active & out, i, exit_step).to(torch.int32)
            active2 = active & ~out & (i < step_limit)

            # crossing records: frozen rays self-exclude (pt2 == pt); the
            # predicate is a sign TRANSITION, so a step landing exactly on
            # the range line counts once (dynamic.py:366-376)
            if cross_fan:
                x0, x1 = pt[_POS][..., 0], x
                d0 = x0[:, None] - ranges[None, :]
                d1 = x1[:, None] - ranges[None, :]
                hit = (d0 < 0) != (d1 < 0)
                frac = torch.where(hit, d0 / torch.where(
                    hit, (x0 - x1)[:, None], 1.0), 0.0)
                y0 = pt[_POS][..., 1]
                ycross = y0[:, None] + frac * (y - y0)[:, None]
                oh = hit[:, :, None] & (cnt[:, :, None] == ords)
                cnt = cnt + hit.to(torch.int32)
                rec = torch.where(oh, ycross[:, :, None], rec)
            elif cross_pick:
                x0, x1 = pt[_POS][..., 0], x
                d0, d1 = x0 - xr, x1 - xr
                hit = (d0 < 0) != (d1 < 0)
                frac = torch.where(hit, d0 / torch.where(hit, x0 - x1, 1.0),
                                   0.0)
                q0 = torch.sum(dpt[_POS] * _perp(pt[_ANG]), dim=-1)

                def lerp(a, b):
                    return a + frac * (b - a)

                row = torch.stack([
                    lerp(pt[_POS][..., 1], y), lerp(tt, tt2),
                    lerp(pt[_ANG], pt2[_ANG]), lerp(q0, q),
                    kmah.to(theta0.dtype),        # pre-crossing step
                    lerp(pt[_N], pt2[_N])], dim=-1)
                # the LAST crossing with ordinal <= ordk is min(ordk,
                # count - 1): the host _pick_crossings fallback
                take = hit & (cnt <= ordk)
                cnt = cnt + hit.to(torch.int32)
                rec = torch.where(take[:, None], row, rec)

            if history:
                # rows freeze after exit (the parity engine writes zeros)
                rows.append(torch.stack([x, y, tt2, pt2[_ANG], q,
                                         kmah2.to(theta0.dtype), pt2[_N]],
                                        dim=-1))
            pt, dpt, tt, dsim, dreal = pt2, dpt2, tt2, dsim2, dreal2
            active, exit_step, sgn, kmah, comps = (active2, exit2, sgn2,
                                                   kmah2, comps2)
            # a frozen ray never changes again, so once every ray is frozen
            # the remaining steps change nothing but the history's rows
            # (checked every 64 steps: each check waits for the device)
            if not history and i % 64 == 0 and not bool(active.any()):
                break

        if cross_fan:
            return CrossingFan(depths=rec, counts=cnt)
        if cross_pick:
            return CrossingPick(state=rec, found=cnt > 0)
        qf = torch.sum(dpt[_POS] * _perp(pt[_ANG]), dim=-1)
        hist = None
        if history:
            row0 = torch.stack([pt0[_POS][..., 0], pt0[_POS][..., 1], zeros,
                                pt0[_ANG], zeros, zeros, pt0[_N]], dim=-1)
            hist = torch.stack([row0] + rows, dim=0)
        return DynamicResult(pos=pt[_POS], angle=pt[_ANG], n=pt[_N],
                             traveltime=tt, dist_sim=dsim, dist_real=dreal,
                             exit_step=exit_step, q=qf, dtheta=dpt[_ANG],
                             kmah=kmah, n0=n_src, history=hist)

    def run(pos0, theta0, medium, gamma, delta_s, step_limit, box, aux=None):
        # torch.func.jvp may record no tangent inside torch.inference_mode()
        # (torch 2.11 on the card counted KMAH 0 on every ray there): the
        # trace runs with inference mode off, on ordinary copies of any
        # inference tensors it is handed
        with torch.inference_mode(False):
            return _run(_ordinary(pos0), _ordinary(theta0), medium, gamma,
                        delta_s, step_limit, box, _ordinary(aux))

    return run


def _ordinary(a):
    """``a`` (a tensor, a tuple of them or None) with every inference
    tensor replaced by an ordinary copy, made outside inference mode."""
    if isinstance(a, tuple):
        return tuple(_ordinary(t) for t in a)
    return a.clone() if torch.is_tensor(a) and a.is_inference() else a


def _launch_args(scen, delta_s, dtype, device, pos0, theta0, step_limit,
                 max_size, divisor, n_turns):
    """(dtype, max_size, step_limit, pos0, theta0, gamma, delta_s, box) on
    ``device``: the scalars round to the working dtype, as the JAX tier's
    traced scalars do."""
    dtype = _torch_dtype(dtype)
    if max_size is None:
        max_size = scen.max_size(delta_s, divisor, n_turns)
    if step_limit is None:
        step_limit = max_size - 1
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def vec(a, default):
        a = default if a is None else a
        if torch.is_tensor(a):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (dtype, int(max_size), int(step_limit), vec(pos0, scen.pos0),
            vec(theta0, scen.theta0), float(np_dtype.type(scen.gamma)),
            float(np_dtype.type(delta_s)),
            tuple(float(np_dtype.type(b)) for b in scen.box))


def trace_dynamic(op_name: str, scen: config.ScenarioConfig, medium, *,
                  delta_s: float, device="cuda", divisor: int | None = None,
                  n_turns: int = config.N_TURNS, mode: str = "history",
                  dtype=torch.float32, pos0=None, theta0=None,
                  step_limit: int | None = None,
                  max_size: int | None = None) -> DynamicResult:
    """Trace rays AND their paraxial neighborhoods (spreading/caustics).

    Same launch interface as :func:`engine.trace.trace`; the result adds
    ``q``, ``dtheta`` and ``kmah``, from which :func:`spreading_amplitude`
    and :func:`transmission_loss_db` give the point-source field along each
    ray.  Runs on ``device`` at ``dtype`` (torch or numpy dtype).
    """
    op_name = canonical(op_name)
    if mode not in ("history", "metrics"):
        raise ValueError(f"mode must be 'history' or 'metrics', got {mode!r}")
    dtype, max_size, step_limit, p0, t0, gamma, ds, box = _launch_args(
        scen, delta_s, dtype, device, pos0, theta0, step_limit, max_size,
        divisor, n_turns)
    run = _build_dynamic_fn(op_name, max_size, mode, dtype)
    return run(p0, t0, medium, gamma, ds, step_limit, box)


def trace_crossings_fan(op_name: str, scen: config.ScenarioConfig, medium,
                        *, delta_s: float, ranges, max_ord: int = 8,
                        device="cuda", divisor: int | None = None,
                        n_turns: int = config.N_TURNS, dtype=torch.float32,
                        pos0=None, theta0=None,
                        step_limit: int | None = None,
                        max_size: int | None = None) -> CrossingFan:
    """Dynamic fan trace that records range-line crossings as it goes: every
    fan ray's landing depths at every range in ``ranges``, per crossing
    ordinal up to ``max_ord`` (more are counted, not recorded), without the
    (steps, R, 7) history.  The eigenray bracket scan's input."""
    op_name = canonical(op_name)
    dtype, max_size, step_limit, p0, t0, gamma, ds, box = _launch_args(
        scen, delta_s, dtype, device, pos0, theta0, step_limit, max_size,
        divisor, n_turns)
    run = _build_dynamic_fn(op_name, max_size, "cross_fan", dtype,
                            int(max_ord))
    return run(p0, t0, medium, gamma, ds, step_limit, box,
               aux=torch.as_tensor(np.asarray(ranges), dtype=dtype,
                                   device=device))


def trace_crossings_pick(op_name: str, scen: config.ScenarioConfig, medium,
                         *, delta_s: float, xr, ordk, device="cuda",
                         divisor: int | None = None,
                         n_turns: int = config.N_TURNS, dtype=torch.float32,
                         pos0=None, theta0=None,
                         step_limit: int | None = None,
                         max_size: int | None = None) -> CrossingPick:
    """Dynamic trace recording each ray's own target crossing: candidate
    ray ``r`` brings home the interpolated state (:data:`CROSS_COLS`) at its
    ``ordk[r]``-th crossing of ``x == xr[r]``, or its last crossing where it
    has fewer (``engine.eigenray._pick_crossings``'s semantics).  The Newton
    polish's view."""
    op_name = canonical(op_name)
    dtype, max_size, step_limit, p0, t0, gamma, ds, box = _launch_args(
        scen, delta_s, dtype, device, pos0, theta0, step_limit, max_size,
        divisor, n_turns)
    run = _build_dynamic_fn(op_name, max_size, "cross_pick", dtype)
    return run(p0, t0, medium, gamma, ds, step_limit, box,
               aux=(torch.as_tensor(np.asarray(xr), dtype=dtype,
                                    device=device),
                    torch.as_tensor(np.asarray(ordk, np.int32),
                                    device=device)))
