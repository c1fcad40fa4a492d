"""Fused golden-section / Newton step kernels: op5, op9 (isotropic) and
op10, op11, op10n, op11n (anisotropic momentum).

Port of ``raytracing_tpu/kernels/golden.py``: ``GOLDEN_OPS`` (golden.py:51),
``GOLD_POLISH``/``GOLD_COARSE_ITERS``/``GOLD_SEED_ITERS`` (:65-82),
``golden_schedule`` (:85), ``_rot_small`` (:101, shared as
``fused.rot_small``), ``_asin_small`` (:114),
``_golden_offsets`` (:123), the step of ``_make_kernel`` (:138) in its
resume form, ``init_mom_x`` (:532), ``golden_scalars`` (:548),
``GoldenFinal`` (:564) and ``golden_trace_final`` (:581).

Every step minimizes the momentum-impulse cost (RT_bench.py:573-600,
676-764) by one of three schedules:

* the production default (``iters == 0``): the closed-form minimizer (iso,
  exact) or seed (aniso) plus ``polish`` Newton steps clipped to 0.15;
* the ``newton`` solver of op10n/op11n: the seed plus 3 Newton steps
  clipped to 0.3;
* the golden bracket (``iters > 0``), probes advanced by constant
  rotations; with ``polish=0`` it is the reference-parity mode.

The medium is an argument of the step, as in JAX (golden.py:162, the strat
injection :520-527, the tile injection :491-518 and the custom one
:620-651): ``field`` is an analytic field name, a ``StratTables``, a
``GridTables`` (kernels/fused.py) or a traced ``CustomMedium``
(``kernels/custom.py::CustomField``).  The step loop of ``csrc/golden.cuh``
is instantiated on the three media in ``csrc/golden.cu`` as three kernels
with their own launch counts (``golden_step``, ``golden_step_strat``,
``golden_step_grid``), and on a custom medium in a library generated for it
(``golden_step_custom``);
:func:`golden_step_plain` is their plain PyTorch version and
:func:`golden_step` the wrapper that dispatches on the device of the
state.  Both take the cost's first and
second derivatives from :class:`Dual2`, the counterpart of the nested
``jax.jvp`` at golden.py:306-328.  Every medium but the analytic fisheye
and the grid launches the persistent refill loop of ``csrc/golden.cuh``
(a lane whose ray froze takes the next ray), on a ray counter the wrapper
allocates for each call; :func:`refill_grid` gives its grid.
"""
from __future__ import annotations

import ctypes
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.config import DELTA_G, GOLD_RATIO, golden_iters
from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels.custom import (
    KERNEL_GOLDEN as KERNEL_CUSTOM, library_for, trace_custom)
from raytracing_tpu_torch.kernels.fused import (
    CURV_TOL, FIELD_CODES, FUSED_FIELDS, GridTables, NodeTables, ResumeState,
    StratTables, _kahan, _outside, _vectors, arc_advance, check_medium,
    check_state, div_exact, kernel_of, nag_fn, rot_small, strat_tables)
from raytracing_tpu_torch.media.medium import CustomMedium

GOLDEN_OPS = {"op5": ("curv", "golden"), "op9": ("t2", "golden"),
              "op10": ("curv", "golden"), "op11": ("t2", "golden"),
              "op10n": ("curv", "newton"), "op11n": ("t2", "newton")}
#: Newton polish steps after the seed or bracket (golden.py:65)
GOLD_POLISH: int = 2
#: bracket iterations of the coarse bracket + polish schedule (golden.py:71)
GOLD_COARSE_ITERS: int = 12
#: ``iters == 0`` selects the closed-form schedule (golden.py:82)
GOLD_SEED_ITERS: int = 0

KERNEL = build.KernelInfo(
    name="golden_step", source="raytracing_tpu_torch/csrc/golden.cu",
    replaces="raytracing_tpu/kernels/golden.py:138")
KERNEL_STRAT = build.KernelInfo(
    name="golden_step_strat", source="raytracing_tpu_torch/csrc/golden.cu",
    replaces="raytracing_tpu/kernels/golden.py:520")
KERNEL_GRID = build.KernelInfo(
    name="golden_step_grid", source="raytracing_tpu_torch/csrc/golden.cu",
    replaces="raytracing_tpu/kernels/golden.py:491")
#: the family's kernels by medium: analytic, stratified, grid
KERNELS = (KERNEL, KERNEL_STRAT, KERNEL_GRID)


def golden_schedule(polish: int | None = None, iters: int | None = None):
    """Resolve the (bracket iterations, polish steps) pair (golden.py:85)."""
    if polish is None:
        polish = GOLD_POLISH
    if iters is None:
        iters = GOLD_SEED_ITERS if polish else golden_iters(np.float32)
    return int(iters), int(polish)


def _golden_offsets(iters: int):
    """(c0_off, d0_off, deltas) of the bracket schedule (golden.py:123)."""
    r = GOLD_RATIO
    L0 = 2.0 * DELTA_G
    c0 = DELTA_G - L0 * r
    d0 = -DELTA_G + L0 * r
    deltas = [L0 * r ** (k + 2) for k in range(iters)]
    return c0, d0, deltas


def bracket_constants(iters: int):
    """The bracket's fixed rotations: (cos c0, sin c0, cos d0, sin d0,
    cos m, sin m, L_final), with m the final midpoint's offset from probe c
    (golden.py:172-179)."""
    c0, d0, _ = _golden_offsets(iters)
    l_final = 2.0 * DELTA_G * GOLD_RATIO ** iters
    mid = (GOLD_RATIO - 0.5) * l_final
    vals = (math.cos(c0), math.sin(c0), math.cos(d0), math.sin(d0),
            math.cos(mid), math.sin(mid), l_final)
    return tuple(float(np.float32(v)) for v in vals)


def golden_scalars(delta_s, gamma, step_limit, offset, iters: int, *,
                   device) -> torch.Tensor:
    """The scalar bundle [ds, gamma, limit, offset, (cos d_k, sin d_k) x
    iters, d_k x iters] as a float32 tensor on ``device`` (golden.py:548)."""
    _, _, deltas = _golden_offsets(iters)
    rot = np.empty(2 * iters, np.float32)
    rot[0::2] = np.cos(deltas)
    rot[1::2] = np.sin(deltas)
    head = np.array([delta_s, gamma, step_limit, offset], np.float32)
    vals = np.concatenate([head, rot, np.asarray(deltas, np.float32)])
    return torch.as_tensor(vals, device=device)


def init_mom_x(op: str, n0, theta0, gamma):
    """First Welford sample of m_x, as the kernel's tracker takes it
    (golden.py:532): n cos t for op5/op9, n cos t / cf otherwise."""
    ct, st = torch.cos(theta0), torch.sin(theta0)
    if op in ("op5", "op9"):
        return n0 * ct
    gs = gamma * st
    cf = torch.sqrt(gs * gs + ct * ct)
    return n0 * ct / cf


class GoldenFinal(NamedTuple):
    """Final-state bundle of a golden kernel run (all tensors length R)."""

    pos: Any          # (R, 2)
    angle: Any        # (R,) final angle
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool: never left the box
    mom_count: Any = None  # Welford m_x stats (with_stats=True only)
    mom_mean: Any = None
    mom_m2: Any = None


def initial_state(op: str, pos0, theta0, gamma, *, field,
                  with_stats: bool, device) -> ResumeState:
    """Launch state of a golden run (segmented.py:66 ``_initial_comps``,
    with the tangent carried beside the angle); ``field`` is the step's
    medium."""
    x, y, th = _vectors(pos0, theta0, device)
    zeros = torch.zeros_like(x)
    st = ResumeState(x=x, y=y, ux=torch.cos(th), uy=torch.sin(th), cx=zeros,
                     cy=zeros.clone(), tt=zeros.clone(), dsim=zeros.clone(),
                     active=torch.ones_like(x, dtype=torch.bool), ang=th)
    if with_stats:
        n0 = nag_fn(field)(x, y)[0]
        st = st._replace(mom_count=torch.ones_like(x),
                         mom_mean=init_mom_x(op, n0, th,
                                             float(np.float32(gamma))),
                         mom_m2=zeros.clone())
    return st


class Dual2:
    """Second-order dual number {v, d1, d2} over tensors: the value and the
    first two derivatives along one direction, which nested forward-mode
    jvp carries.  Only the operations of the momentum cost are defined."""

    __slots__ = ("v", "d1", "d2")

    def __init__(self, v, d1, d2):
        self.v, self.d1, self.d2 = v, d1, d2

    def __add__(self, o):
        if isinstance(o, Dual2):
            return Dual2(self.v + o.v, self.d1 + o.d1, self.d2 + o.d2)
        return Dual2(self.v + o, self.d1, self.d2)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Dual2):
            return Dual2(self.v - o.v, self.d1 - o.d1, self.d2 - o.d2)
        return Dual2(self.v - o, self.d1, self.d2)

    def __rsub__(self, o):
        return Dual2(o - self.v, -self.d1, -self.d2)

    def __mul__(self, o):
        if isinstance(o, Dual2):
            return Dual2(self.v * o.v, self.d1 * o.v + self.v * o.d1,
                         self.d2 * o.v + 2.0 * self.d1 * o.d1 + self.v * o.d2)
        return Dual2(self.v * o, self.d1 * o, self.d2 * o)

    __rmul__ = __mul__

    def rsqrt(self):
        f = torch.rsqrt(self.v)
        inv = 1.0 / self.v
        f1 = -0.5 * f * inv
        f2 = 0.75 * f * inv * inv
        return Dual2(f, f1 * self.d1, f2 * self.d1 * self.d1 + f1 * self.d2)


def _rsqrt(s):
    return s.rsqrt() if isinstance(s, Dual2) else torch.rsqrt(s)


def _asin_small(s):
    """asin by its odd series for |s| <~ 0.15 (golden.py:114)."""
    s2 = s * s
    return s * (1.0 + s2 * ((1.0 / 6.0) + s2 * (3.0 / 40.0)))


def _newton_polish(cost_uv, mc, ms, t0, n_steps: int, clip_b: float,
                   guard=None):
    """Newton on d(cost)/d(delta), delta from the seed (mc, ms)."""
    dlt = torch.zeros_like(t0)
    one, zero = torch.ones_like(t0), torch.zeros_like(t0)
    for _ in range(n_steps):
        sd, cd = rot_small(Dual2(dlt, one, zero))
        f = cost_uv(mc * cd - ms * sd, mc * sd + ms * cd)
        ad2 = torch.abs(f.d2)
        safe = torch.where(ad2 < 1e-12, torch.full_like(ad2, 1e-12), ad2)
        if guard is not None:
            guard(lambda: _div_ok(f.d1, safe))
        dlt = dlt - torch.clamp(f.d1 / safe, -clip_b, clip_b)
    dlt = torch.clamp(dlt, -clip_b, clip_b)
    sd, cd = rot_small(dlt)
    return t0 + dlt, mc * cd - ms * sd, mc * sd + ms * cd


# Where the kernels' fast paths hold their guards (csrc/common.cuh): a
# model of them, since the kernel reports no path of its own.  Each is
# False for NaN, as the guard is.
def _div_ok(a, b):
    """div_pos_m's fast path: div_fast_pos from recip_pos(b)."""
    aa = a.abs() if torch.is_tensor(a) else abs(a)
    return ((b >= 2.0 ** -16) & (b <= 2.0 ** 16) & (aa <= 2.0 ** 100)
            & ((aa >= 2.0 ** -100) | (aa == 0.0)))


def _sqrt_ok(v):
    """sqrt_m's and sqrt_rsqrt_m's fast path."""
    return (v >= 2.0 ** -100) & (v <= 2.0 ** 126)


def _rsqrt_ok(v):
    return v >= 2.0 ** -126


def _rcp_ok(v):
    a = v.abs()
    return (a >= 2.0 ** -126) & (a < 2.0 ** 126)


def golden_step_plain(st: ResumeState, scal: torch.Tensor, *, field,
                      op: str, steps: int, box, iters: int,
                      polish: int, guards=None) -> ResumeState:
    """Plain PyTorch version of the ``golden_step`` kernels (golden.py:230-455)
    on every ray at once; frozen rays are kept by selects.

    ``guards``, a float64 tensor of 2 on the state's device, if given: each
    step adds to ``guards[0]`` the rays it moves where any of the kernels'
    fast paths (csrc/golden.cuh: the reciprocals, square roots, reciprocal
    square roots and quotients) fails its guard, so that the kernel takes
    that operation's IEEE form, and to ``guards[1]`` the rays it moves: a
    model of the kernels' guards, which report no path of their own.  The
    grid's kernel takes the IEEE operations throughout: none fails there."""
    nag = nag_fn(field)
    stepper, solver = GOLDEN_OPS[op]
    iso = op in ("op5", "op9")
    sv = scal.cpu().numpy()
    ds32, gamma32, limit, offset = sv[:4]
    ds, gamma = float(ds32), float(gamma32)
    dsds_half = float(ds32 * ds32 * np.float32(0.5))
    g2 = float(gamma32 * gamma32)
    inv_g2 = float(np.float32(1.0) / np.float32(g2))
    cos_c0, sin_c0, cos_d0, sin_d0, cos_m, sin_m, l_final = \
        bracket_constants(iters)
    stats = st.mom_count is not None
    x, y, ux, uy, cx, cy, tt, dsim, active, ang = st[:10]
    cnt, mean, m2 = st.mom_count, st.mom_mean, st.mom_m2
    n, gx, gy = nag(x, y)
    one = torch.ones_like(x)

    for i in range(steps):
        keep = active & (float(np.float32(i) + offset) < float(limit))
        bad = []
        guard = None if guards is None or isinstance(field, GridTables) \
            else (lambda ok: bad.append(~ok()))
        gdotu = gx * ux + gy * uy
        txx = gx - gdotu * ux
        txy = gy - gdotu * uy
        if stepper == "t2":
            half_fac = div_exact(dsds_half, n)
            if guard:
                guard(lambda: _div_ok(dsds_half, n))
            ddx = ux * ds + txx * half_fac
            ddy = uy * ds + txy * half_fac
            significant = torch.ones_like(active)
        else:
            ddx, ddy, significant = arc_advance(ux, uy, gx, gy, txx, txy, n,
                                                ds)
            if guard:
                guard(lambda: _arc_ok(ux, uy, gx, gy, txx, txy, n, ds))
        nx2, cx2 = _kahan(x, cx, ddx)
        ny2, cy2 = _kahan(y, cy, ddy)
        n2, gx2, gy2 = nag(nx2, ny2)

        gu = gamma * uy
        coef_i = one if iso else torch.sqrt(gu * gu + ux * ux)
        half_ds = ds * 0.5
        if iso:
            kx = n * ux + (gx + gx2) * half_ds
            ky = n * uy + (gy + gy2) * half_ds

            def cost_uv(ct, st_):
                rx = n2 * ct - kx
                ry = n2 * st_ - ky
                return rx * rx + ry * ry
        else:
            inv_i = torch.rsqrt(gu * gu + ux * ux)
            kx = n * ux * inv_i + coef_i * gx * half_ds
            ky = n * g2 * uy * inv_i + coef_i * gy * half_ds
            hx = gx2 * half_ds
            hy = gy2 * half_ds
            n2g2 = n2 * g2

            def cost_uv(ct, st_):
                gs = gamma * st_
                s2 = gs * gs + ct * ct
                if guard:
                    v = s2.v if isinstance(s2, Dual2) else s2
                    guard(lambda: _rsqrt_ok(v) & (_rcp_ok(v) if isinstance(
                        s2, Dual2) else True))
                inv = _rsqrt(s2)
                cf = s2 * inv
                rx = n2 * ct * inv - kx - cf * hx
                ry = n2g2 * st_ * inv - ky - cf * hy
                return rx * rx + ry * ry

        kyg = ky if iso else ky * inv_g2
        kk = kx * kx + kyg * kyg
        inv_k = torch.rsqrt(kk)
        if guard:
            guard(lambda: _rsqrt_ok(kk))
        mc, ms = kx * inv_k, kyg * inv_k
        tc = ts = None
        if solver == "newton":
            t0 = ang + _asin_small(ux * ms - uy * mc)
            t_new, tc, ts = _newton_polish(cost_uv, mc, ms, t0, 3, 0.3, guard)
        elif iters == 0:
            t_new = ang + _asin_small(ux * ms - uy * mc)
            if iso or not polish:
                tc, ts = mc, ms
            else:
                t_new, tc, ts = _newton_polish(cost_uv, mc, ms, t_new,
                                               polish, 0.15, guard)
        else:
            a_ang = ang - DELTA_G
            b_ang = ang + DELTA_G
            pc = ux * cos_c0 - uy * sin_c0
            ps = ux * sin_c0 + uy * cos_c0
            qc = ux * cos_d0 - uy * sin_d0
            qs = ux * sin_d0 + uy * cos_d0
            fc, fd = cost_uv(pc, ps), cost_uv(qc, qs)
            for k in range(iters):
                cth, sth = float(sv[4 + 2 * k]), float(sv[5 + 2 * k])
                dk = float(sv[4 + 2 * iters + k])
                left = fc < fd
                sth_s = torch.where(left, -sth * one, sth * one)
                base_c = torch.where(left, qc, pc)
                base_s = torch.where(left, qs, ps)
                fresh_c = base_c * cth - base_s * sth_s
                fresh_s = base_c * sth_s + base_s * cth
                ff = cost_uv(fresh_c, fresh_s)
                pc, ps, qc, qs = (torch.where(left, fresh_c, qc),
                                  torch.where(left, fresh_s, qs),
                                  torch.where(left, pc, fresh_c),
                                  torch.where(left, ps, fresh_s))
                fc, fd = torch.where(left, ff, fd), torch.where(left, fc, ff)
                a_ang = torch.where(left, a_ang, a_ang + dk)
                b_ang = torch.where(left, b_ang - dk, b_ang)
            t_new = (a_ang + b_ang) * 0.5
            if polish:
                mmc = pc * cos_m - ps * sin_m
                mms = pc * sin_m + ps * cos_m
                t_new, tc, ts = _newton_polish(cost_uv, mmc, mms, t_new,
                                               polish, l_final, guard)
        nang = torch.where(significant, t_new, ang)
        if tc is not None:
            nrm = tc * tc + ts * ts
            inv_nrm = torch.rsqrt(nrm)
            if guard:
                guard(lambda: _rsqrt_ok(nrm))
            nux = torch.where(significant, tc * inv_nrm, ux)
            nuy = torch.where(significant, ts * inv_nrm, uy)
        else:
            nux, nuy = torch.cos(nang), torch.sin(nang)

        dd = ddx * ddx + ddy * ddy
        dist = torch.sqrt(dd)
        gnu = gamma * nuy
        cf2 = gnu * gnu + nux * nux
        cf_new = one if iso else torch.sqrt(cf2)
        if guard:
            guard(lambda: _sqrt_ok(dd) & (True if iso else _sqrt_ok(cf2)))
        ntt = tt + dist * (coef_i * n + cf_new * n2) * 0.5
        ndsim = dsim + dist

        def sel(new, old):
            return torch.where(keep, new, old)

        if stats:
            mx2 = n2 * nux if iso else n2 * nux / cf_new
            cnt2 = cnt + 1.0
            delta = mx2 - mean
            mean2 = mean + delta / cnt2
            m22 = m2 + delta * (mx2 - mean2)
            if guard:
                guard(lambda: _div_ok(delta, cnt2) & (
                    True if iso else _div_ok(n2 * nux, cf_new)))
            cnt, mean, m2 = sel(cnt2, cnt), sel(mean2, mean), sel(m22, m2)
        if guards is not None:
            failed = torch.zeros_like(keep)
            for b in bad:
                failed = failed | b
            guards[0] += (keep & failed).sum()
            guards[1] += keep.sum()
        active = active & ~(keep & _outside(nx2, ny2, box))
        x, y, cx, cy = sel(nx2, x), sel(ny2, y), sel(cx2, cx), sel(cy2, cy)
        ang, ux, uy = sel(nang, ang), sel(nux, ux), sel(nuy, uy)
        n, gx, gy = sel(n2, n), sel(gx2, gx), sel(gy2, gy)
        tt, dsim = sel(ntt, tt), sel(ndsim, dsim)

    return ResumeState(x=x, y=y, ux=ux, uy=uy, cx=cx, cy=cy, tt=tt, dsim=dsim,
                       active=active, ang=ang, mom_count=cnt, mom_mean=mean,
                       mom_m2=m2)


def _arc_ok(ux, uy, gx, gy, txx, txy, n, ds):
    """The guards of arc_advance_m's fast paths (csrc/common.cuh): the
    curvature's square root (a zero sum of squares on the fast path too)
    and both quotients, from :func:`arc_advance`'s operands."""
    v = txx * txx + txy * txy
    t = torch.sqrt(v)
    curv = t / n
    one = torch.ones_like(n)
    significant = curv >= CURV_TOL
    sgn = torch.where(gx * uy - gy * ux > 0, -one, one)
    sh, _ = rot_small(sgn * (curv * ds) * 0.5)
    return ((_sqrt_ok(v) | (v == 0.0)) & _div_ok(t, n)
            & _div_ok(2.0 * sh * sgn, torch.where(significant, curv, one)))


def golden_step(st: ResumeState, scal: torch.Tensor, *, field, op: str,
                steps: int, box, gold_iters: int | None = None,
                polish: int | None = None) -> ResumeState:
    """Advance a resume state ``steps`` steps: the kernels' wrapper.

    ``field`` is the medium: an analytic field name (kernel
    ``golden_step``), a ``StratTables`` (``golden_step_strat``), a
    ``GridTables`` (``golden_step_grid``) or a traced ``CustomMedium``,
    ``CustomField`` (``golden_step_custom``, from the field's own library,
    built on first use).  ``scal`` is
    :func:`golden_scalars` on the state's device, built with the bracket
    iterations of the schedule (``golden_schedule(polish, gold_iters)``);
    its ``offset`` entry makes step numbering global, so k steps then
    n - k steps equal n steps.  A CPU state runs :func:`golden_step_plain`;
    a CUDA state launches the kernel or raises.
    """
    if op not in GOLDEN_OPS:
        raise ValueError(f"golden kernel supports {tuple(GOLDEN_OPS)}, got {op!r}")
    if isinstance(field, str) and field not in FUSED_FIELDS:
        raise ValueError(f"golden kernel supports fields {FUSED_FIELDS}, got {field!r}")
    if isinstance(field, NodeTables):
        raise ValueError("the golden kernels read no node table: pass the "
                         "grid's GridTables")
    iters, polish = golden_schedule(polish, gold_iters)
    check_state(st, needs_ang=True, window=False)
    check_medium(field, st.x.device)
    if (scal.dtype != torch.float32 or scal.device != st.x.device
            or scal.shape != (4 + 3 * iters,) or not scal.is_contiguous()):
        raise ValueError(f"scal must be the contiguous float32 bundle of "
                         f"{iters} bracket iterations on {st.x.device}")
    box = tuple(float(v) for v in box)
    if st.x.device.type == "cpu":
        return golden_step_plain(st, scal, field=field, op=op,
                                 steps=int(steps), box=box, iters=iters,
                                 polish=polish)
    if st.x.device.type != "cuda":
        raise ValueError(f"golden_step runs on cpu or cuda, not {st.x.device}")
    kernel, suffix, lead, table = kernel_of(field, KERNELS, KERNEL_CUSTOM)
    fn, name = (library_for(field, "golden", op) if suffix == "_custom" else
                (getattr(build.library(), "rt_golden_step" + suffix),
                 "rt_golden_step" + suffix))
    out = ResumeState(*(None if t is None else torch.empty_like(t) for t in st))
    with torch.cuda.device(st.x.device):
        # the refill loop's ray counter (a launch that refills zeroes it on
        # its stream; one ray a thread leaves it alone)
        counter = torch.empty(1, dtype=torch.int32, device=st.x.device)
        err = fn(*lead, *_variant(op), int(st.mom_count is not None),
                 build.pointer_array(st), build.pointer_array(out),
                 st.x.shape[0], int(steps), scal.data_ptr(), iters, polish,
                 *box, CURV_TOL, *bracket_constants(iters),
                 counter.data_ptr(), *table,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, name)
    kernel.launches += 1
    return out


def _variant(op: str):
    """(curv, newton, iso) of ``op``: the golden.cuh template parameters."""
    stepper, solver = GOLDEN_OPS[op]
    return (int(stepper == "curv"), int(solver == "newton"),
            int(op in ("op5", "op9")))


def refill_grid(field, op: str, n: int) -> int:
    """Blocks of 128 threads that the refill loop of ``golden_step`` (an
    analytic field name), ``golden_step_strat`` (a ``StratTables``) or
    ``golden_step_grid`` (a ``GridTables``) launches for ``n`` rays of
    ``op`` on the current CUDA device: as many as every SM holds at once,
    never more than the rays fill; 0 where the medium runs one ray a thread
    (the fisheye field and the grid)."""
    if op not in GOLDEN_OPS:
        raise ValueError(f"golden kernel supports {tuple(GOLDEN_OPS)}, got {op!r}")
    if isinstance(field, StratTables):
        medium, code = 1, field.ch
    elif isinstance(field, GridTables):
        medium, code = 2, field.cell_ch
    elif isinstance(field, str) and field in FUSED_FIELDS:
        medium, code = 0, FIELD_CODES[field]
    else:
        raise ValueError("the golden refill grid is for the analytic "
                         "fields, StratTables and GridTables, not "
                         f"{type(field).__name__}")
    blocks = ctypes.c_int(0)
    build.check(build.library().rt_golden_refill_blocks(
        medium, code, *_variant(op), int(n), ctypes.addressof(blocks)),
        "rt_golden_refill_blocks")
    return blocks.value


def final_from_state(st: ResumeState) -> GoldenFinal:
    return GoldenFinal(pos=torch.stack([st.x, st.y], dim=-1), angle=st.ang,
                       traveltime=st.tt, dist_sim=st.dsim, active=st.active,
                       mom_count=st.mom_count, mom_mean=st.mom_mean,
                       mom_m2=st.mom_m2)


def golden_trace_final(pos0, theta0, delta_s, gamma, *, field, op: str,
                       steps: int, box, device="cuda", medium=None,
                       with_stats: bool = False, step_limit=None,
                       gold_iters: int | None = None,
                       polish: int | None = None) -> GoldenFinal:
    """Run ``steps`` golden/Newton integration steps (golden.py:581).

    ``field`` is the step's medium (see :func:`golden_step`); ``medium``, a
    stratified medium (parity or C1) or a ``CustomMedium``, replaces it
    with its tables or its traced form, as the JAX wrapper's ``medium=``
    does (golden.py:620-651).  ``gamma`` is the anisotropy ratio
    (op5/op9 fold it to 1);
    ``gold_iters``/``polish`` select the schedule (default: closed-form
    seed + Newton polish; ``polish=0`` the pure f32 reference-parity
    bracket); ``step_limit`` freezes rays after that many steps.
    """
    if op not in GOLDEN_OPS:
        raise ValueError(f"golden kernel supports {tuple(GOLDEN_OPS)}, got {op!r}")
    iters, polish = golden_schedule(polish, gold_iters)
    if medium is not None:
        field = (trace_custom(medium) if isinstance(medium, CustomMedium)
                 else strat_tables(medium))
    st = initial_state(op, pos0, theta0, gamma, field=field,
                       with_stats=with_stats, device=device)
    scal = golden_scalars(delta_s, gamma,
                          steps if step_limit is None else step_limit, 0.0,
                          iters, device=device)
    st = golden_step(st, scal, field=field, op=op, steps=steps, box=box,
                     gold_iters=iters, polish=polish)
    return final_from_state(st)
