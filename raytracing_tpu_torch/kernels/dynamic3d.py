"""The 3-D dynamic kernels: kinematics plus two launch tangents, on the
analytic 3-D fields and on tri-Hermite grid3 media.

Port of ``raytracing_tpu/kernels/dynamic3d.py``: ``DYN3_FUSED_FIELDS`` and
``DYN3_FUSED_OPS`` (dynamic3d.py:69-71), the Hessian evaluator
``_field3_fn_h`` (:76), ``_rot_dcoeffs`` (:114), ``_cross``/``_dot``
(:123-128), ``_rodrigues3v`` (:131), ``_drodrigues3`` (:141), the step
``_dyn_step_body3`` (:158) that ``_make_dyn_kernel3`` (:318) and
``_make_dyn_tile_kernel3`` (:408) share, the grid3 Hessian ``_tile_nag3_h``
(:355) without its window, the 25-value resume layout ``DYN3_TILE_STATE``
(:405), ``Dyn3Final`` (:486) and ``dynamic3d_trace_final`` (:503).

Beside the kinematic state a ray carries d(pos)/d(alpha) and d(u)/d(alpha)
for the two transverse launch angles, ``(dpa, dua)`` and ``(dpb, dub)``,
through the hand-derived directional derivative of the step map; the
paraxial determinant is frame-free, ``det Q = (dpa x dpb) . u``; KMAH counts
its sign changes, and the smallest |det Q| past the source regime and its
1-based global step locate a point focus.  The launch holds the source
fixed (dpa = dpb = 0) with dua, dub the transverse frame of
``engine/dynamic3d.py::_transverse_frame``.  Unlike the kinematic step, the
position advance is not compensated (JAX's body adds ``pos + D`` plainly).

One step loop, ``run_dyn3`` in ``csrc/dynamic3d.cuh``, is instantiated on
the media of ``csrc/fused3d.cuh`` (their ``nag_h``) in ``csrc/dynamic3d.cu``
as two kernels with their own launch counts: ``dynamic3d_step`` (the three
analytic fields) and ``dynamic3d_step_grid`` (a ``C1Grid3Medium``'s
per-cell table, :class:`kernels.fused3d.Grid3Tables`).  Both read and write
the 25-plane :class:`Dyn3State` with a global step offset; n, grad n and
the Hessian are evaluated again from the position at each launch's start,
as the tile kernel does (:471), so chained launches equal one.
:func:`dynamic3d_step_plain` is their plain PyTorch version and
:func:`dynamic3d_step` the wrapper: a CPU state runs the plain version, a
CUDA state launches the kernel or raises.

Written alike on both sides, for bit parity on the card: ``lax.rsqrt``
(:263) is ``1 / sqrt`` (IEEE square root, one rounded division); the
divisions by 60 and 360 of ``_rot_dcoeffs`` are true divisions
(``kernels/fused.py::div_exact`` here, ``/`` there: PyTorch's ``tensor /
scalar`` multiplies by a rounded reciprocal); every Python constant rounds
to float32 as JAX folds it; the primal values that both tangents read (t,
n2, g2, H2, the rotation coefficients, u') are computed once a step; the
sign of det Q is three-valued, 0 at 0, as ``jnp.sign``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.config import THCK_PARAM
from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels.fused import FIELD_CODES, div_exact
from raytracing_tpu_torch.kernels.fused3d import (
    Grid3Tables, _check_medium3, cell_row3, check_state3, initial_state3,
    rot_coeffs)
from raytracing_tpu_torch.media.fields import _sigmoid
from raytracing_tpu_torch.media.grid3 import blend3_h

#: analytic fields with inlined 3-D Hessians
DYN3_FUSED_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
#: smooth vector ops with a hand tangent (all of engine/trace3d.METHODS3)
DYN3_FUSED_OPS = ("op1", "op2", "op6", "op8")

KERNEL = build.KernelInfo(
    name="dynamic3d_step", source="raytracing_tpu_torch/csrc/dynamic3d.cu",
    replaces="raytracing_tpu/kernels/dynamic3d.py:546")
KERNEL_GRID = build.KernelInfo(
    name="dynamic3d_step_grid",
    source="raytracing_tpu_torch/csrc/dynamic3d.cu",
    replaces="raytracing_tpu/engine/tiled3.py:233")
#: the family's kernels: analytic, grid3
KERNELS = (KERNEL, KERNEL_GRID)

_SQRT2 = 1.4142135623730951
#: float32's largest finite value: the kernels' starting min |det Q| (:340)
FLT_MAX = float(np.finfo(np.float32).max)


def field3_fn_h(field: str):
    """n, grad n and the symmetric Hessian of an analytic 3-D field, closed
    form (dynamic3d.py:76-111): ``f(x, y, z) -> (n, gx, gy, gz, hxx, hxy,
    hxz, hyy, hyz, hzz)``.  The interface uses the overflow-safe logistic
    of ``media/fields.py``, as JAX's ``_field3_fn_h`` does (the kinematic
    kernel uses the literal one)."""
    if field == "fisheye":
        def f(x, y, z):
            n = 1.0 / (1.0 + x * x + y * y + z * z)
            n2 = n * n
            c = -2.0 * n2
            n3_8 = 8.0 * n2 * n
            return (n, c * x, c * y, c * z,
                    c + n3_8 * x * x, n3_8 * x * y, n3_8 * x * z,
                    c + n3_8 * y * y, n3_8 * y * z,
                    c + n3_8 * z * z)
    elif field == "vert_heterogeneous":
        def f(x, y, z):
            n = 1.0 / (18.0 + 2.0 * y)
            zero = torch.zeros_like(x)
            n2 = n * n
            return (n, zero, -2.0 * n2, zero,
                    zero, zero, zero, 8.0 * n2 * n, zero, zero)
    elif field == "interface":
        def f(x, y, z):
            sig = _sigmoid(div_exact(y, THCK_PARAM))
            n = _SQRT2 - (_SQRT2 - 1.0) * sig
            zero = torch.zeros_like(x)
            d = sig * (1.0 - sig)
            gy = div_exact(-(_SQRT2 - 1.0) * d, THCK_PARAM)
            hyy = div_exact(-(_SQRT2 - 1.0) * d * (1.0 - 2.0 * sig),
                            THCK_PARAM * THCK_PARAM)
            return (n, zero, gy, zero,
                    zero, zero, zero, hyy, zero, zero)
    else:
        raise ValueError(f"fused 3-D dynamic kernel supports fields "
                         f"{DYN3_FUSED_FIELDS}, got {field!r}")
    return f


def tile_nag3_h_plain(t: Grid3Tables):
    """The grid3 kernel's Hessian evaluator (dynamic3d.py:355-397) on the
    per-cell rows: each query's row read directly by its integer cell index
    (no window) and blended by ``media.grid3.blend3_h``.  The inverse
    pitches are float32-rounded first, so that ``inv_h * inv_h`` rounds as
    the kernel's float32 product does."""
    ihx, ihy, ihz = (float(np.float32(v))
                     for v in (t.inv_hx, t.inv_hy, t.inv_hz))

    def nag(x, y, z):
        row, ux, uy, uz = cell_row3(t, x, y, z)
        return blend3_h(lambda ch, k: row[..., ch * 8 + k], ux, uy, uz,
                        ihx, ihy, ihz)

    return nag


def nag3_h_fn(field):
    """The plain 10-value evaluator of a step's medium: an analytic field
    name or a :class:`Grid3Tables`."""
    if isinstance(field, Grid3Tables):
        return tile_nag3_h_plain(field)
    return field3_fn_h(field)


def rot_dcoeffs(a2, vers):
    """Termwise d/da2 of ``kernels.fused3d.rot_coeffs`` (dynamic3d.py:114):
    (dcos, dsinc, dvers), given ``vers`` of the same a2 (JAX's body computes
    it again, to the same value); 60 and 360 divide exactly."""
    dsinc = -1.0 / 6.0 + div_exact(a2, 60.0)
    dvers = -1.0 / 24.0 + div_exact(a2, 360.0)
    return -(vers + a2 * dvers), dsinc, dvers


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _add3(a, b):
    return tuple(p + q for p, q in zip(a, b))


class _Rot(NamedTuple):
    """What the polynomial rotation of ``u`` by ``r`` and its differential
    share: (_rodrigues3v :131 and _drodrigues3 :141 compute these alike)."""

    u: tuple
    r: tuple
    cos: Any
    sinc: Any
    vers: Any
    dcos: Any
    dsinc: Any
    dvers: Any
    c: tuple       # r x u
    rdotu: Any


def _rot(u, r) -> _Rot:
    a2 = dot(r, r)
    cos, sinc, vers = rot_coeffs(a2)
    dcos, dsinc, dvers = rot_dcoeffs(a2, vers)
    return _Rot(u, r, cos, sinc, vers, dcos, dsinc, dvers, cross(r, u),
                dot(r, u))


def rodrigues3v(p: _Rot):
    """u rotated by r (dynamic3d.py:131)."""
    return tuple(p.u[i] * p.cos + p.c[i] * p.sinc + p.r[i] * p.rdotu * p.vers
                 for i in range(3))


def drodrigues3(p: _Rot, du, dr):
    """The differential of the polynomial rotation in (u, r) along
    (du, dr) (dynamic3d.py:141-155)."""
    u, r = p.u, p.r
    da2 = 2.0 * dot(r, dr)
    dc = _add3(cross(dr, u), cross(r, du))
    drdotu = dot(dr, u) + dot(r, du)
    return tuple(
        du[i] * p.cos + dc[i] * p.sinc
        + dr[i] * p.rdotu * p.vers + r[i] * drdotu * p.vers
        + da2 * (u[i] * p.dcos + p.c[i] * p.dsinc + r[i] * p.rdotu * p.dvers)
        for i in range(3))


def hdot(h, v):
    """The symmetric Hessian (hxx, hxy, hxz, hyy, hyz, hzz) times v."""
    hxx, hxy, hxz, hyy, hyz, hzz = h
    return (hxx * v[0] + hxy * v[1] + hxz * v[2],
            hxy * v[0] + hyy * v[1] + hyz * v[2],
            hxz * v[0] + hyz * v[1] + hzz * v[2])


class Dyn3State(NamedTuple):
    """Resumable state of the 3-D dynamic kernels, (R,) each: the 25 values
    of JAX's ``DYN3_TILE_STATE`` layout (engine/tiled3.py:555-566), float32
    except ``active`` (bool: never left the box).  The order of
    ``rt3::DSlot3`` in csrc/dynamic3d.cu."""

    x: Any
    y: Any
    z: Any
    ux: Any       # unit tangent
    uy: Any
    uz: Any
    dpax: Any     # d(pos)/d(alpha)
    dpay: Any
    dpaz: Any
    duax: Any     # d(u)/d(alpha)
    duay: Any
    duaz: Any
    dpbx: Any     # d(pos)/d(beta)
    dpby: Any
    dpbz: Any
    dubx: Any     # d(u)/d(beta)
    duby: Any
    dubz: Any
    tt: Any
    dsim: Any
    active: Any
    sgn: Any      # running sign of det Q: -1, 0 (not yet set) or 1
    kmah: Any     # sign changes of det Q, float
    mind: Any     # min |det Q| past the source regime (FLT_MAX before)
    minstep: Any  # its 1-based global step, float (0 before)


class Dyn3Final(NamedTuple):
    """Final-state bundle of a 3-D dynamic kernel run (tensors length R)."""

    pos: Any          # (R, 3)
    tangent: Any      # (R, 3)
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool
    detq: Any         # (R,) paraxial det Q (frame-free triple product)
    kmah: Any         # (R,) int32
    n: Any            # (R,)
    min_absdet: Any   # (R,)
    min_absdet_step: Any  # (R,) int32


def initial_dyn3_state(pos0, dir0, *, device) -> Dyn3State:
    """Launch state (engine/tiled3.py:555-566): float32 positions, the
    direction normalized in float32, the source fixed (dpa = dpb = 0),
    dua/dub the transverse frame of the normalized direction, every ray
    active, no sign yet, min |det Q| at FLT_MAX."""
    from raytracing_tpu_torch.engine.dynamic3d import _transverse_frame
    k = initial_state3(pos0, dir0, device=device)
    u = torch.stack([k.ux, k.uy, k.uz], dim=-1)
    e1, e2 = _transverse_frame(u)
    zero = torch.zeros_like(k.x)

    def z():
        return zero.clone()

    return Dyn3State(
        x=k.x, y=k.y, z=k.z, ux=k.ux, uy=k.uy, uz=k.uz,
        dpax=z(), dpay=z(), dpaz=z(),
        duax=e1[:, 0].contiguous(), duay=e1[:, 1].contiguous(),
        duaz=e1[:, 2].contiguous(),
        dpbx=z(), dpby=z(), dpbz=z(),
        dubx=e2[:, 0].contiguous(), duby=e2[:, 1].contiguous(),
        dubz=e2[:, 2].contiguous(),
        tt=z(), dsim=z(), active=k.active, sgn=z(), kmah=z(),
        mind=torch.full_like(zero, FLT_MAX), minstep=z())


def detq3(st: Dyn3State):
    """The frame-free det Q = (dpa x dpb) . u of a state."""
    return dot(cross((st.dpax, st.dpay, st.dpaz), (st.dpbx, st.dpby, st.dpbz)),
               (st.ux, st.uy, st.uz))


def final_from_dyn3_state(st: Dyn3State, n) -> Dyn3Final:
    """Dyn3Final from a state and the index ``n`` at its positions."""
    return Dyn3Final(pos=torch.stack([st.x, st.y, st.z], dim=-1),
                     tangent=torch.stack([st.ux, st.uy, st.uz], dim=-1),
                     traveltime=st.tt, dist_sim=st.dsim, active=st.active,
                     detq=detq3(st), kmah=st.kmah.to(torch.int32), n=n,
                     min_absdet=st.mind,
                     min_absdet_step=st.minstep.to(torch.int32))


class _Consts(NamedTuple):
    """The launch's scalars as the kernel holds them (float32-rounded)."""

    second: bool
    rk2: bool
    ds: float
    dsds_half: float     # (ds * ds) * 0.5
    half: float          # ds * 0.5
    limit: float
    box: tuple


def _consts(op, delta_s, step_limit, box) -> _Consts:
    ds32 = np.float32(delta_s)
    return _Consts(second=op in ("op6", "op8"), rk2=op in ("op2", "op6"),
                   ds=float(ds32),
                   dsds_half=float(ds32 * ds32 * np.float32(0.5)),
                   half=float(ds32 * np.float32(0.5)),
                   limit=float(np.float32(step_limit)),
                   box=tuple(float(v) for v in box))


def _step(st: Dyn3State, f, gi, nagh, c: _Consts):
    """One step of ``_dyn_step_body3`` (dynamic3d.py:199-313) on every ray:
    ``f`` the 10 values of ``nagh`` at the current positions, ``gi`` the
    float32 global step index before this step (a Python float or a 0-d
    tensor).  Returns (state, f) after it; a ray that is frozen (left the
    box, or past the step limit) keeps its state."""
    ds = c.ds
    pos = (st.x, st.y, st.z)
    u = (st.ux, st.uy, st.uz)
    n, g, h = f[0], f[1:4], f[4:]
    active = st.active
    keep = active & (gi < c.limit)
    gstep = gi + 1.0

    # -- the primal step, shared by both tangents --------------------------
    gu = dot(g, u)
    t = tuple(g[k] - gu * u[k] for k in range(3))
    if c.second:
        half_fac = div_exact(c.dsds_half, n)
        D = tuple(u[k] * ds + t[k] * half_fac for k in range(3))
    else:
        D = tuple(u[k] * ds for k in range(3))
    pos2 = tuple(pos[k] + D[k] for k in range(3))
    f2 = nagh(*pos2)
    n2, g2, h2 = f2[0], f2[1:4], f2[4:]
    two_n = 2.0 * n
    two_nn = two_n * n
    if c.rk2:
        inv_n = 1.0 / n
        k1 = tuple(ds * t[k] * inv_n for k in range(3))
        rot1 = _rot(u, cross(u, k1))
        um = rodrigues3v(rot1)
        inv_n2 = 1.0 / n2
        gum = dot(g2, um)
        t2v = tuple(g2[k] - gum * um[k] for k in range(3))
        k2 = tuple(ds * t2v[k] * inv_n2 for k in range(3))
        r2 = cross(um, k2)
        rot = _rot(u, tuple((rot1.r[k] + r2[k]) * 0.5 for k in range(3)))
        u2 = rodrigues3v(rot)
    else:
        s = tuple(n * u[k] + (g[k] + g2[k]) * c.half for k in range(3))
        inv = 1.0 / torch.sqrt(dot(s, s))
        u2 = tuple(s[k] * inv for k in range(3))

    def advance(dp, du):
        """(dp2, du2): the step's directional derivative (:242-268)."""
        dn = dot(g, dp)
        dg = hdot(h, dp)
        dgu = dot(dg, u) + dot(g, du)
        dt = tuple(dg[k] - dgu * u[k] - gu * du[k] for k in range(3))
        if c.second:
            dD = tuple(du[k] * ds + (dt[k] / two_n - t[k] * dn / two_nn)
                       * ds * ds for k in range(3))
        else:
            dD = tuple(du[k] * ds for k in range(3))
        dp2 = tuple(dp[k] + dD[k] for k in range(3))
        dn2 = dot(g2, dp2)
        dg2 = hdot(h2, dp2)
        if c.rk2:
            dk1 = tuple(ds * (dt[k] * inv_n - t[k] * dn * inv_n * inv_n)
                        for k in range(3))
            dr1 = _add3(cross(du, k1), cross(u, dk1))
            dum = drodrigues3(rot1, du, dr1)
            dgum = dot(dg2, um) + dot(g2, dum)
            dt2 = tuple(dg2[k] - dgum * um[k] - gum * dum[k]
                        for k in range(3))
            dk2 = tuple(ds * (dt2[k] * inv_n2
                              - t2v[k] * dn2 * inv_n2 * inv_n2)
                        for k in range(3))
            dr2 = _add3(cross(dum, k2), cross(um, dk2))
            drho = tuple((dr1[k] + dr2[k]) * 0.5 for k in range(3))
            du2 = drodrigues3(rot, du, drho)
        else:
            dsv = tuple(dn * u[k] + n * du[k] + (dg[k] + dg2[k]) * c.half
                        for k in range(3))
            proj = dot(dsv, u2)
            du2 = tuple((dsv[k] - proj * u2[k]) * inv for k in range(3))
        return dp2, du2

    dpa2, dua2 = advance((st.dpax, st.dpay, st.dpaz),
                         (st.duax, st.duay, st.duaz))
    dpb2, dub2 = advance((st.dpbx, st.dpby, st.dpbz),
                         (st.dubx, st.duby, st.dubz))

    if c.second:
        dist = torch.sqrt(dot(D, D))
        ntt = st.tt + dist * (n + n2) * 0.5
        ndsim = st.dsim + dist
    else:
        ntt = st.tt + ds * (n + n2) * 0.5
        ndsim = st.dsim + ds

    # -- caustic bookkeeping on the global, 1-based step --------------------
    det = dot(cross(dpa2, dpb2), u2)
    s_new = (det > 0).float() - (det < 0).float()
    flip = active & (st.sgn != 0.0) & (s_new != 0.0) & (s_new != st.sgn)
    kmah2 = st.kmah + torch.where(flip, 1.0, 0.0)
    sgn2 = torch.where(active & (s_new != 0.0), s_new, st.sgn)
    # past the source regime (|det| grows ~s^2 from 0), inside the limit
    better = keep & (gstep > 4.0) & (torch.abs(det) < st.mind)
    mind2 = torch.where(better, torch.abs(det), st.mind)
    minstep2 = torch.where(better, gstep, st.minstep)

    lx0, lx1, ly0, ly1, lz0, lz1 = c.box
    outb = ((pos2[0] > lx1) | (pos2[0] < lx0) | (pos2[1] > ly1)
            | (pos2[1] < ly0) | (pos2[2] > lz1) | (pos2[2] < lz0))

    def sel(new, old):
        return torch.where(keep, new, old)

    new = Dyn3State(
        *(sel(a, b) for a, b in zip(pos2 + u2 + dpa2 + dua2 + dpb2 + dub2
                                    + (ntt, ndsim), st[:20])),
        active=active & ~(keep & outb), sgn=sel(sgn2, st.sgn),
        kmah=sel(kmah2, st.kmah), mind=mind2, minstep=minstep2)
    return new, tuple(sel(a, b) for a, b in zip(f2, f))


def dynamic3d_step_plain(st: Dyn3State, *, field, op: str, steps: int,
                         delta_s, step_limit, offset: float,
                         box) -> Dyn3State:
    """Plain PyTorch version of ``dynamic3d_step`` and
    ``dynamic3d_step_grid``.

    ``_dyn_step_body3`` (dynamic3d.py:158-313) on every ray at once, one
    torch call an operation in the kernels' order, with a frozen ray's state
    kept by selects.  ``offset`` is the global step count before this
    launch: the step limit, the past-source guard and the focus locator's
    step labels read it.  The steps from the step limit on change nothing
    and are not run.
    """
    nagh = nag3_h_fn(field)
    c = _consts(op, delta_s, step_limit, box)
    f = nagh(st.x, st.y, st.z)
    off = np.float32(offset)
    for i in range(int(steps)):
        gi = float(np.float32(i) + off)
        if not gi < c.limit:
            break
        st, f = _step(st, f, gi, nagh, c)
    return st


def dynamic3d_plain_step(st: Dyn3State, gi, *, field, op: str, delta_s,
                         step_limit, box) -> Dyn3State:
    """One plain step from global step index ``gi`` (a float32 0-d tensor
    or a Python float), n, grad n and the Hessian evaluated at the state's
    positions: the form ``bench/replay.py`` captures in a CUDA graph (equal
    to a step of :func:`dynamic3d_step_plain`, whose carried values are the
    same evaluations)."""
    nagh = nag3_h_fn(field)
    return _step(st, nagh(st.x, st.y, st.z), gi, nagh,
                 _consts(op, delta_s, step_limit, box))[0]


def _check_op3(op: str) -> None:
    if op not in DYN3_FUSED_OPS:
        raise ValueError(f"fused 3-D dynamic kernel supports ops "
                         f"{DYN3_FUSED_OPS}, got {op!r}")


def dynamic3d_step(st: Dyn3State, *, field, op: str, steps: int, delta_s,
                   step_limit, offset=0.0, box) -> Dyn3State:
    """Advance a 3-D dynamic state ``steps`` steps: the kernels' wrapper.

    ``field`` is an analytic field name (kernel ``dynamic3d_step``) or a
    :class:`Grid3Tables` (``dynamic3d_step_grid``); ``box`` the 6 faces
    (x0, x1, y0, y1, z0, z1).  ``offset`` is the number of steps applied
    before this launch, so k steps then n - k with offset k equal n steps.
    A CPU state runs :func:`dynamic3d_step_plain`; a CUDA state launches
    the kernel.
    """
    _check_op3(op)
    box = tuple(float(v) for v in box)
    if len(box) != 6:
        raise ValueError(f"box must be 6 floats, got {box!r}")
    check_state3(st)
    _check_medium3(field, st.x.device)
    if st.x.device.type == "cpu":
        return dynamic3d_step_plain(st, field=field, op=op, steps=int(steps),
                                    delta_s=delta_s,
                                    step_limit=float(step_limit),
                                    offset=float(offset), box=box)
    if st.x.device.type != "cuda":
        raise ValueError(f"dynamic3d_step runs on cpu or cuda, not "
                         f"{st.x.device}")
    out = Dyn3State(*(torch.empty_like(t) for t in st))
    lib = build.library()
    args = (int(op[2:]), build.pointer_array(st), build.pointer_array(out),
            st.x.shape[0], int(steps), float(np.float32(delta_s)),
            float(step_limit), float(offset), *box)
    with torch.cuda.device(st.x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if isinstance(field, Grid3Tables):
            kernel, name = KERNEL_GRID, "rt_dynamic3d_step_grid"
            err = lib.rt_dynamic3d_step_grid(
                *args, field.table.data_ptr(), field.x0, field.y0, field.z0,
                field.inv_hx, field.inv_hy, field.inv_hz, field.nx, field.ny,
                field.nz, stream)
        else:
            kernel, name = KERNEL, "rt_dynamic3d_step"
            err = lib.rt_dynamic3d_step(FIELD_CODES[field], *args, stream)
    build.check(err, name)
    kernel.launches += 1
    return out


def dynamic3d_trace_final(pos0, dir0, delta_s, *, field: str, op: str,
                          steps: int, box, step_limit=None,
                          device="cuda") -> Dyn3Final:
    """Run ``steps`` fused 3-D dynamic steps on an analytic field
    (dynamic3d.py:503): one launch of ``dynamic3d_step`` from the
    point-source launch state.  ``step_limit`` (default ``steps``) freezes
    every ray after that many steps.  ``n`` is the field at the final
    positions, which the TPU kernel carries.  JAX's ``block_rays`` and
    ``interpret`` are gone: a thread is one ray."""
    if field not in DYN3_FUSED_FIELDS:
        raise ValueError(f"fused 3-D dynamic kernel supports fields "
                         f"{DYN3_FUSED_FIELDS}, got {field!r}")
    st = initial_dyn3_state(pos0, dir0, device=device)
    st = dynamic3d_step(st, field=field, op=op, steps=steps, delta_s=delta_s,
                        step_limit=steps if step_limit is None else step_limit,
                        offset=0.0, box=box)
    return final_from_dyn3_state(st, field3_fn_h(field)(st.x, st.y, st.z)[0])
