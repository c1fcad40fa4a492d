"""The df32 tier: double-word float32 RK4, f64-grade trajectories in f32.

Port of ``raytracing_tpu/kernels/df.py``: the error-free transformations
``_two_sum``, ``_fast_two_sum``, ``_two_prod`` (Dekker split 4097),
``_df_add_f``, the small-angle polynomials, ``_apply_rotation``,
``_df_recip`` and ``make_df_rk4_body`` (df.py:42-186); ``DF_FIELDS`` and
the closed-form angle rates of ``_df_rk4_kernel`` (:199-235); the kernel
itself in both its forms (:275, launch state in; :314, the full 8-plane
state in and out, chained in segments) as one kernel that always takes and
returns the 8-plane state; and ``df_trace`` / ``df_fisheye_trace``
(:342-374).

Positions and the unit tangent ride as (hi, lo) float32 pairs; a step is
the RK4 of op12 with every position increment and the angle increment
accumulated through two_prod / two_sum chains, the tangent turned by a
correction term (never renormalized).  Medium evaluations return the
angle rate k = (u x grad n)/n as a (hi, lo) pair: the analytic fisheye and
vert rates here, the split-word sampled media of ``engine/df_grid.py``
through the same step (each carries its kernel as ``KERNEL``).

One CUDA step loop (``csrc/df.cuh``, launched from ``csrc/df.cu``) serves
the five media as four kernels with their own launch counts: ``df_step``
(the two analytic fields), ``df_step_grid``, ``df_step_c1`` and
``df_step_profile`` (the split-word tables).  :func:`df_step_plain` is
their plain PyTorch version and :func:`df_step` the wrapper: a CPU state
runs the plain version, a CUDA state launches the kernel or raises.

Bit parity with the kernel rests on the JAX package's own rounding: every
non-dyadic constant is a float32 value (0-d float32 tensors below, the
same float32 literals in the kernel), a product with a Python constant
splits that constant as JAX folds it in float64 (:func:`two_prod_const`),
nothing is reassociated, and reciprocals are IEEE divisions.  The kernels'
exact product is one FMA, ``fmaf(a, b, -a * b)``, the same bits as
:func:`two_prod`'s Dekker chain wherever the product's error is a float32
number, which holds on the df path (tests/test_torch_df_host.py maps the
domain).  The kernel on the analytic fields and the profile also runs the
FMA form (:func:`fma_form`): each low-word sum of products rounded once,
in JAX's order of terms; the plain version in that form rounds each with
``utils/fma.py::fma32``, the terms of a step stacked into one call
(``mads``).  With ``jax_roundings`` every operation is JAX's, one torch
call each (``test_rk4_body_equals_jax_op_for_op`` holds that form to JAX's
eager body to the bit); the grid media's kernels keep it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.utils import fma

#: analytic fields with a closed-form df angle rate
DF_FIELDS = ("fisheye", "vert_heterogeneous")

_SPLIT = 4097.0  # 2^12 + 1: the Dekker split constant for float32


def _f32(v) -> torch.Tensor:
    """A constant as the float32 value JAX rounds a Python float to."""
    return torch.tensor(np.float32(v))


_SIXTH = _f32(1.0 / 6.0)
_TWELFTH = _f32(1.0 / 12.0)
_TWENTIETH = _f32(0.05)
_SIXTH_HI = _f32(np.float32(1.0 / 6.0))
_SIXTH_LO = _f32(1.0 / 6.0 - np.float64(np.float32(1.0 / 6.0)))

KERNEL = build.KernelInfo(
    name="df_step", source="raytracing_tpu_torch/csrc/df.cu",
    replaces="raytracing_tpu/kernels/df.py:275")
KERNEL_GRID = build.KernelInfo(
    name="df_step_grid", source="raytracing_tpu_torch/csrc/df.cu",
    replaces="raytracing_tpu/engine/df_grid.py:183")
KERNEL_C1 = build.KernelInfo(
    name="df_step_c1", source="raytracing_tpu_torch/csrc/df.cu",
    replaces="raytracing_tpu/engine/df_grid.py:299")
KERNEL_PROFILE = build.KernelInfo(
    name="df_step_profile", source="raytracing_tpu_torch/csrc/df.cu",
    replaces="raytracing_tpu/engine/df_grid.py:361")
#: the family's kernels: analytic, then the parity, C1 and profile tables
KERNELS = (KERNEL, KERNEL_GRID, KERNEL_C1, KERNEL_PROFILE)


# -- error-free transformations (df.py:42-69) --------------------------------
def two_sum(a, b):
    """Knuth: a + b = s + e exactly."""
    s = a + b
    bv = s - a
    return s, (a - (s - bv)) + (b - bv)


def fast_two_sum(a, b):
    """a + b = s + e exactly, for |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker: a * b = p + e exactly (no fused multiply-add; the kernels
    compute the same e as one FMA, ``csrc/df.cuh``)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def two_prod_const(a, b):
    """:func:`two_prod` with ``b`` a float32-valued Python constant, as JAX
    traces it: the split of ``b`` runs in Python's float64, where it is
    exact, so ``b``'s high word is ``b`` itself and its low word 0.0."""
    p = a * b
    ah, al = _split(a)
    e = ((ah * b - p) + ah * 0.0 + al * b) + al * 0.0
    return p, e


def df_add_f(xh, xl, y):
    """(xh + xl) + y, renormalized."""
    s, e = two_sum(xh, y)
    return fast_two_sum(s, e + xl)


def sin_poly(d):
    d2 = d * d
    return d * (1.0 - d2 * _SIXTH * (1.0 - d2 * _TWENTIETH))


def cosm1_poly(d):
    d2 = d * d
    return -d2 * 0.5 * (1.0 - d2 * _TWELFTH)


def apply_rotation(uxh, uxl, uyh, uyl, dth_h, dth_l):
    """Turn the df tangent by the df angle (dth_h + dth_l) (df.py:82-100):
    sin carries the angle's low word, the increment is df-added to the
    tangent as a correction."""
    dth = dth_h
    dth2 = dth * dth
    s_corr = -dth * dth2 * _SIXTH * (1.0 - dth2 * _TWENTIETH)
    sh_, sl_ = df_add_f(dth, dth_l, s_corr)
    cm = cosm1_poly(dth) - dth * dth_l
    s = sh_ + sl_
    dux = uxh * cm - uyh * s + uxl * cm - uyl * s
    duy = uyh * cm + uxh * s + uyl * cm + uxl * s
    nxh, nxl = df_add_f(uxh, uxl, dux)
    nyh, nyl = df_add_f(uyh, uyl, duy)
    return nxh, nxl, nyh, nyl


def df_recip(dh, dl, fused=False):
    """1/(dh + dl) as df: one Newton refinement of the IEEE quotient; the
    residual's - dl n0 rounded with its sum where ``fused`` (the FMA
    form)."""
    n0 = torch.reciprocal(dh)
    th, tl = two_prod(dh, n0)
    resid, = fma.mads(fused)((dl,), (n0,), ((1.0 - th) - tl,), sub=True)
    return n0, n0 * resid


def make_df_rk4_body(df_k, ds, fused=False):
    """One double-word RK4 step on the 8-tuple (xh, xl, yh, yl, uxh, uxl,
    uyh, uyl) (df.py:114-186); ``df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh,
    vyl) -> (kh, kl)`` is the df angle rate, ``ds`` a 0-d float32 tensor.
    ``fused``: the step's low-word sums of products (rx, ry, pe, the
    angle's low word) in the FMA form, csrc/df.cuh ``rk4_step<true>``."""
    mad = fma.mads(fused)
    dsf, lo6, hi6 = float(ds), float(_SIXTH_LO), float(_SIXTH_HI)
    h2 = ds * 0.5
    h6 = ds * _SIXTH

    def body(carry):
        xh, xl, yh, yl, uxh, uxl, uyh, uyl = carry
        ux, uy = uxh, uyh

        def corr(a):
            s, cm = sin_poly(a), cosm1_poly(a)
            return ux * cm - uy * s, uy * cm + ux * s

        def midpoint(hc, vx, vy):
            pxh, pxe = two_prod(hc, vx)
            pyh, pye = two_prod(hc, vy)
            mxh, mxl = df_add_f(xh, xl + pxe, pxh)
            myh, myl = df_add_f(yh, yl + pye, pyh)
            return mxh, mxl, myh, myl

        k1h, k1l = df_k(xh, xl, yh, yl, uxh, uxl, uyh, uyl)
        c1x, c1y = corr(h2 * (k1h + k1l))
        m = midpoint(h2, ux, uy)
        k2h, k2l = df_k(*m, uxh, uxl + c1x, uyh, uyl + c1y)
        c2x, c2y = corr(h2 * (k2h + k2l))
        m = midpoint(h2, ux + c1x, uy + c1y)
        k3h, k3l = df_k(*m, uxh, uxl + c2x, uyh, uyl + c2y)
        c3x, c3y = corr(ds * (k3h + k3l))
        m = midpoint(ds, ux + c2x, uy + c2y)
        k4h, k4l = df_k(*m, uxh, uxl + c3x, uyh, uyl + c3y)

        # position: h u + h/6 (2 c1 + 2 c2 + c3), df-accumulated
        px, pex = two_prod(ds, uxh)
        py, pey = two_prod(ds, uyh)
        sx = h6 * (2.0 * c1x + 2.0 * c2x + c3x)
        sy = h6 * (2.0 * c1y + 2.0 * c2y + c3y)

        # dth = ds (k1 + 2 k2 + 2 k3 + k4) / 6, all in df
        ksh, kse = two_sum(k1h, k4h)
        ksh2, kse2 = two_sum(2.0 * k2h, 2.0 * k3h)
        ksum_h, se_ = two_sum(ksh, ksh2)
        ksum_l = se_ + kse + kse2 + (k1l + 2.0 * k2l + 2.0 * k3l + k4l)
        ph, pe = two_prod(ds, ksum_h)
        ah, al = two_prod_const(ph, _SIXTH_HI)
        # rx = sx + ds uxl (+ pex), pe + ds ksum_l, al + ph lo6 (+ pe hi6)
        rx, ry, pe, tl = mad((dsf, dsf, dsf, ph), (uxl, uyl, ksum_l, lo6),
                             (sx, sy, pe, al))
        tl, = mad((pe,), (hi6,), (tl,))
        xh, xl = df_add_f(xh, xl + (rx + pex), px)
        yh, yl = df_add_f(yh, yl + (ry + pey), py)
        dth_h, dth_l = fast_two_sum(ah, tl)
        uxh, uxl, uyh, uyl = apply_rotation(uxh, uxl, uyh, uyl, dth_h, dth_l)
        return xh, xl, yh, yl, uxh, uxl, uyh, uyl

    return body


# -- the analytic angle rates (df.py:199-232) --------------------------------
def df_k_fisheye(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl, fused=False):
    """k = -2 n (v_x y - v_y x) on the fisheye, n = 1/(1 + r^2) Newton-
    refined, all in df; the low words' sums of products in the FMA form
    where ``fused``."""
    mad = fma.mads(fused)
    ah, al = two_prod(vxh, pyh)
    bh, bl = two_prod(vyh, pxh)
    xxh, xxl = two_prod(pxh, pxh)
    yyh, yyl = two_prod(pyh, pyh)
    # vxh pyl + vxl pyh, vyh pxl + vyl pxh, xxl + 2 pxh pxl, yyl + 2 pyh pyl
    sa, sb, xxl, yyl = mad((vxl, vyl, 2.0 * pxh, 2.0 * pyh),
                           (pyh, pxh, pxl, pyl),
                           (vxh * pyl, vyh * pxl, xxl, yyl))
    al = al + sa
    bl = bl + sb
    ch, ce = two_sum(ah, -bh)
    cl = ce + (al - bl)
    sh, se = two_sum(xxh, yyh)
    dh, de = two_sum(1.0, sh)
    dl = de + se + xxl + yyl
    n0, nl = df_recip(dh, dl, fused)
    kh, ke = two_prod(-2.0 * n0, ch)
    t, = mad((n0,), (cl,), (nl * ch,))
    return kh, ke + (-2.0) * t


def df_k_vert(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl, fused=False):
    """k = -2 n u_x on vert_heterogeneous, n = 1/(18 + 2y); the low
    words' sums of products in the FMA form where ``fused``."""
    dh, de = two_sum(18.0, 2.0 * pyh)
    dl = de + 2.0 * pyl
    n0, nl = df_recip(dh, dl, fused)
    kh, ke = two_prod(-2.0 * n0, vxh)
    t, = fma.mads(fused)((n0,), (vxl,), (nl * vxh,))
    return kh, ke + (-2.0) * t


_DF_K = {"fisheye": df_k_fisheye, "vert_heterogeneous": df_k_vert}


# -- the 8-plane state, the step and its wrapper -----------------------------
class DfState(NamedTuple):
    """The df32 state: eight contiguous float32 (R,) planes, JAX's resume
    layout (df.py:326-329)."""

    xh: torch.Tensor
    xl: torch.Tensor
    yh: torch.Tensor
    yl: torch.Tensor
    uxh: torch.Tensor
    uxl: torch.Tensor
    uyh: torch.Tensor
    uyl: torch.Tensor


def initial_df_state(pos0, theta0, *, device) -> DfState:
    """The launch state of the analytic kernel (df.py:266-270): the float32
    position and (cos, sin) of the launch angle as high words (the angle's
    own dtype for the cosine, as JAX), zero low words."""
    pos0 = torch.as_tensor(pos0, device=device)
    theta0 = torch.as_tensor(theta0, device=device)
    if pos0.dim() != 2 or pos0.shape[1] != 2 or theta0.shape != pos0.shape[:1]:
        raise ValueError(f"pos0 must be (R, 2) and theta0 (R,), got "
                         f"{tuple(pos0.shape)} and {tuple(theta0.shape)}")
    xh = pos0[:, 0].to(torch.float32).contiguous()
    yh = pos0[:, 1].to(torch.float32).contiguous()
    uxh = torch.cos(theta0).to(torch.float32).contiguous()
    uyh = torch.sin(theta0).to(torch.float32).contiguous()
    return DfState(xh, torch.zeros_like(xh), yh, torch.zeros_like(xh),
                   uxh, torch.zeros_like(xh), uyh, torch.zeros_like(xh))


def fma_form(medium) -> bool:
    """Whether the df kernel of ``medium`` runs the FMA form (csrc/df.cuh
    ``kFma``): the analytic fields and the profile; the parity and C1
    grids round as JAX."""
    return isinstance(medium, str) or getattr(medium, "FMA", False)


def df_k_of(medium, fused=False):
    """The plain df angle rate of a step's medium: an analytic field name of
    :data:`DF_FIELDS`, or a split-word medium of ``engine/df_grid.py``; in
    the FMA form where ``fused``."""
    if isinstance(medium, str):
        if medium not in DF_FIELDS:
            raise ValueError(f"df kernel supports {DF_FIELDS}, got {medium!r}")
        return functools.partial(_DF_K[medium], fused=fused)
    if getattr(medium, "KERNEL", None) not in KERNELS[1:]:
        raise ValueError("a df step's medium is a field name of "
                         f"{DF_FIELDS} or a split-word df medium, got "
                         f"{type(medium).__name__}")
    return medium.df_k(fused)


def df_step_plain(st: DfState, medium, delta_s, steps: int,
                  jax_roundings=False) -> DfState:
    """Plain PyTorch version of the four df kernels: ``steps`` df RK4 steps
    of every ray, the kernels' operations one torch call each (an FMA's,
    fma32's few), in the kernel's form (:func:`fma_form`); in JAX's
    roundings on any medium where ``jax_roundings``."""
    fused = fma_form(medium) and not jax_roundings
    body = make_df_rk4_body(df_k_of(medium, fused), _f32(delta_s), fused)
    carry = tuple(st)
    for _ in range(int(steps)):
        carry = body(carry)
    return DfState(*carry)


def check_df_state(st: DfState) -> None:
    """Device, dtype, shape and contiguity checks of a df state."""
    dev, r = st.xh.device, st.xh.shape[0]
    for name, t in st._asdict().items():
        if (not torch.is_tensor(t) or t.dtype != torch.float32
                or t.shape != (r,) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"state.{name}: need a contiguous ({r},) "
                             f"float32 tensor on {dev}")


def df_step(st: DfState, medium, delta_s, steps: int) -> DfState:
    """Advance a df state ``steps`` steps: the kernels' wrapper.

    ``medium`` is an analytic field name of :data:`DF_FIELDS` (kernel
    ``df_step``) or a split-word medium of ``engine/df_grid.py`` whose
    tables lie on the state's device (``df_step_grid``, ``df_step_c1``,
    ``df_step_profile``).  The whole state goes in and out, so k steps then
    n - k equal n steps to the bit.  A CPU state runs
    :func:`df_step_plain`; a CUDA state launches the kernel.
    """
    df_k_of(medium)   # validates the medium
    check_df_state(st)
    device = st.xh.device
    if not isinstance(medium, str):
        medium.check_device(device)
    if device.type == "cpu":
        return df_step_plain(st, medium, delta_s, int(steps))
    if device.type != "cuda":
        raise ValueError(f"df_step runs on cpu or cuda, not {device}")
    out = DfState(*(torch.empty_like(t) for t in st))
    lib = build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    common = (build.pointer_array(st), build.pointer_array(out),
              st.xh.shape[0], int(steps), float(np.float32(delta_s)))
    with torch.cuda.device(device):
        if isinstance(medium, str):
            kernel, name = KERNEL, "rt_df_step"
            err = lib.rt_df_step(DF_FIELDS.index(medium), *common, stream)
        else:
            kernel = medium.KERNEL
            name = f"rt_{kernel.name}"
            err = getattr(lib, name)(*common, *medium.kernel_args(), stream)
    build.check(err, name)
    kernel.launches += 1
    return out


def df_positions(st: DfState) -> torch.Tensor:
    """(R, 2) float64 positions, hi + lo recombined (df.py:363-367)."""
    return torch.stack([st.xh.double() + st.xl.double(),
                        st.yh.double() + st.yl.double()], dim=-1)


def run_segments(st: DfState, medium, delta_s, steps: int,
                 segment: int | None) -> DfState:
    """``steps`` steps as launches of at most ``segment`` steps (one launch
    for ``None``); the state rides whole between them, so the result is
    the same to the bit either way."""
    steps = int(steps)
    if segment is not None and int(segment) <= 0:
        raise ValueError(f"segment must be positive, got {segment}")
    seg = max(steps, 1) if segment is None else int(segment)
    for n in [seg] * (steps // seg) + ([steps % seg] if steps % seg else []):
        st = df_step(st, medium, delta_s, n)
    return st


def df_trace(pos0, theta0, delta_s, *, steps: int, field: str = "fisheye",
             segment: int | None = None, device="cuda") -> torch.Tensor:
    """Double-word RK4 integration of op12 on an analytic field
    (df.py:342-367): float64 (R, 2) final positions, hi + lo recombined.

    Any R (no block padding).  ``segment`` chains launches of at most that
    many steps (resume only: the TPU's compile bound does not apply);
    ``None`` is one launch.
    """
    if field not in DF_FIELDS:
        raise ValueError(f"df kernel supports {DF_FIELDS}, got {field!r}")
    st = initial_df_state(pos0, theta0, device=device)
    return df_positions(run_segments(st, field, delta_s, steps, segment))


def df_fisheye_trace(pos0, theta0, delta_s, *, steps: int,
                     device="cuda") -> torch.Tensor:
    """:func:`df_trace` on the fisheye (df.py:371, the JAX alias)."""
    return df_trace(pos0, theta0, delta_s, steps=steps, field="fisheye",
                    device=device)
