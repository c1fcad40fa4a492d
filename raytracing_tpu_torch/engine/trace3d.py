"""3-D ray integration: the vector op matrix (the 3-D scan tier).

Port of ``raytracing_tpu/engine/trace3d.py``: ``TRACE3_COLS`` (:46),
``METHODS3`` (:49), ``Ray3State`` (:58), ``Trace3Result`` with
``horizontal_slowness_cv_pct`` (:75-95), ``canonical3`` (:98),
``_rodrigues`` (:119), ``_step3`` (:141), the scan body of
``_build_trace3_fn`` (:176-246), ``initial_state3`` (:249), ``trace3d``
(:268) and ``bouguer_invariant`` (:305).  ``jax.lax.scan`` becomes a
Python loop over steps whose carry is the state of all rays, on
``device`` at ``dtype``; ``jit=`` is gone, as in the port's 2-D ``trace``.

The reference integrates in the plane; this tier replaces its angle with
the unit tangent ``u`` (3,):

* momentum-impulse (op1/op8 solver): ``u' = normalize(n u + J)`` with the
  trapezoidal impulse ``J = ds (g0 + g1)/2``;
* RK2 (op2/op6 solver): the two-stage update of the Fermat tangent ODE
  ``du/ds = (g - (g.u) u)/n`` composed as rotation vectors, ``u' =
  Rodrigues(u, (rho1 + rho2)/2)``;
* the first- and second-order Taylor position steppers.

Methods ``op1`` (t1 + impulse), ``op2``/AnDF (t1 + RK2), ``op6``/HySA
(t2 + RK2), ``op8`` (t2 + impulse).  The curvature, golden and window
families are planar constructions; :func:`trace3d` rejects them by name.

Oracles: straight lines in homogeneous media; fisheye closure and
planarity; the Bouguer invariant ``n |r x u|`` (:func:`bouguer_invariant`);
horizontal-slowness conservation in stratified media (``stats=True``,
:meth:`Trace3Result.horizontal_slowness_cv_pct`).

The Rodrigues rotation here is exact (``sin``, ``cos``, ``sqrt`` with the
floor ``finfo(dtype).tiny ** 0.45`` in the state's dtype, as JAX); the
fused 3-D kernel (``kernels/fused3d.py``) uses JAX's polynomial form
instead, by design.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.engine.trace import _torch_dtype

#: history row layout of :func:`trace3d` (mode="history")
TRACE3_COLS = ("x", "y", "z", "traveltime", "n", "ux", "uy", "uz")

#: 3-D method matrix: name -> (stepper order, angle solver)
METHODS3 = {
    "op1": (1, "impulse"),
    "op2": (1, "rk2"),
    "op6": (2, "rk2"),
    "op8": (2, "impulse"),
}
_ALIASES3 = {"AnDF": "op2", "HySA": "op6"}


class Ray3State(NamedTuple):
    """State of a 3-D ray batch; leading shape (R,)."""

    pos: Any          # (R, 3)
    unitv: Any        # (R, 3) unit tangent
    n: Any            # (R,)
    grad: Any         # (R, 3)
    traveltime: Any   # (R,) optical path
    dist_sim: Any     # (R,)
    dist_real: Any    # (R,)
    active: Any       # (R,) bool
    exit_step: Any    # (R,) int32
    slow_count: Any   # (R,) Welford count over (p_x, p_z) samples, or None
    slow_mean: Any    # (R, 2) running mean of horizontal slowness, or None
    slow_m2: Any      # (R, 2) running squared deviations, or None


class Trace3Result(NamedTuple):
    final: Ray3State
    exit_step: Any
    dist_real: Any
    dist_sim: Any
    history: Any      # (max_size, R, 8) TRACE3_COLS rows, or None

    def horizontal_slowness_cv_pct(self):
        """Per-ray CV (%) of (p_x, p_z) from the Welford tracker, as a
        numpy (R, 2) array; rays launched with a ~zero component report
        nan there (no relative spread exists)."""
        st = self.final
        if st.slow_count is None:
            raise ValueError("trace3d ran without stats=True")
        var = (st.slow_m2 / st.slow_count[..., None]).cpu().numpy()
        mean = st.slow_mean.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(np.abs(mean) > 1e-12,
                            100.0 * np.sqrt(var) / np.abs(mean), np.nan)


def canonical3(name: str) -> str:
    name = _ALIASES3.get(name, name)
    if name not in METHODS3:
        raise ValueError(
            f"3-D tracing supports {sorted(METHODS3)} (+ aliases "
            f"{sorted(_ALIASES3)}); got {name!r}.  The curvature, golden "
            f"and window families are planar constructions (signed 2-D "
            f"turning circles / scalar searches) with no 3-D lift.")
    return name


def _eval3(medium, pos):
    n, (gx, gy, gz) = medium.n_and_grad3(pos[..., 0], pos[..., 1],
                                         pos[..., 2])
    return n, torch.stack([gx, gy, gz], dim=-1)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _sum3(a):
    return torch.sum(a, dim=-1, keepdim=True)


def _rodrigues(u, rho):
    """Rotate ``u`` by the rotation vector ``rho`` (axis * angle), exactly:
    |u| is preserved and a zero vector is the identity.  The sinc/versine
    forms keep the map smooth through rho == 0; the floor squares to a
    normal number."""
    a2 = _sum3(rho * rho)
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[u.dtype]
    tiny = float(npdt(np.finfo(npdt).tiny ** 0.45))
    a = torch.sqrt(a2 + tiny)
    sinc = torch.sin(a) / a
    vers = (1.0 - torch.cos(a)) / (a2 + tiny)
    return (u * torch.cos(a) + torch.linalg.cross(rho, u, dim=-1) * sinc
            + rho * _sum3(rho * u) * vers)


def _step3(order: int, solver: str, pt, medium, ds):
    """One 3-D integration step; ``pt`` = (pos, unitv, n, grad); ``ds`` a
    0-d tensor of the state's dtype."""
    pos, u, n, g = pt
    if order == 1:
        pos2 = pos + u * ds                      # first_order_taylor
    else:
        gdotu = _sum3(g * u)
        pos2 = (pos + u * ds                     # second_order_taylor
                + (g - gdotu * u) * (ds * ds) / (2.0 * n[..., None]))
    n2, g2 = _eval3(medium, pos2)

    if solver == "impulse":
        # trapezoidal momentum impulse, direction of p = n u
        p = n[..., None] * u + ds * (g + g2) / 2.0
        u2 = _normalize(p)
    else:
        # two-stage RK2 composed as rotation vectors:
        # rho_i = u_i x k_i, u' = Rodrigues(u, (rho1 + rho2)/2)
        k1 = ds * (g - _sum3(g * u) * u) / n[..., None]
        rho1 = torch.linalg.cross(u, k1, dim=-1)
        um = _rodrigues(u, rho1)
        k2 = ds * (g2 - _sum3(g2 * um) * um) / n2[..., None]
        u2 = _rodrigues(u, (rho1 + torch.linalg.cross(um, k2, dim=-1)) / 2.0)
    return pos2, u2, n2, g2


def _row(st: Ray3State):
    return torch.stack([st.pos[..., 0], st.pos[..., 1], st.pos[..., 2],
                        st.traveltime, st.n, st.unitv[..., 0],
                        st.unitv[..., 1], st.unitv[..., 2]], dim=-1)


def _run3(method: str, st0: Ray3State, medium, ds, *, max_size: int,
          step_limit: int, box, history: bool) -> Trace3Result:
    """The scan body of trace3d.py:183-244, as a loop over steps."""
    order, solver = METHODS3[method]
    st = st0._replace(exit_step=torch.clamp(st0.exit_step, max=step_limit))
    rows = [_row(st0)] if history else None
    with_stats = st.slow_count is not None
    for i in range(1, max_size):
        pos2, u2, n2, g2 = _step3(order, solver,
                                  (st.pos, st.unitv, st.n, st.grad),
                                  medium, ds)
        dist = torch.linalg.vector_norm(pos2 - st.pos, dim=-1)
        tt2 = st.traveltime + dist * (st.n + n2) / 2.0
        cnt = mean = m2 = None
        if with_stats:
            p_hor = n2[..., None] * u2[..., [0, 2]]
            cnt = st.slow_count + 1.0
            delta = p_hor - st.slow_mean
            mean = st.slow_mean + delta / cnt[..., None]
            m2 = st.slow_m2 + delta * (p_hor - mean)
        new = Ray3State(
            pos=pos2, unitv=u2, n=n2, grad=g2, traveltime=tt2,
            dist_sim=st.dist_sim + dist, dist_real=st.dist_real + ds,
            active=st.active, exit_step=st.exit_step,
            slow_count=cnt, slow_mean=mean, slow_m2=m2)

        def sel(a, b):
            if a is None:
                return None
            m = st.active.reshape(st.active.shape + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)

        st2 = Ray3State(*(sel(a, b) for a, b in zip(new, st)))
        if box is None:
            out = torch.zeros_like(st.active)
        else:
            x, y, z = st2.pos[..., 0], st2.pos[..., 1], st2.pos[..., 2]
            out = ((x < box[0]) | (x > box[1]) | (y < box[2])
                   | (y > box[3]) | (z < box[4]) | (z > box[5]))
        exit2 = torch.where(st.active & out,
                            torch.full_like(st.exit_step, i), st.exit_step)
        st = st2._replace(active=st.active & ~out & (i < step_limit),
                          exit_step=exit2)
        if history:
            rows.append(_row(st))
    hist = torch.stack(rows, dim=0) if history else None
    return Trace3Result(final=st, exit_step=st.exit_step,
                        dist_real=st.dist_real, dist_sim=st.dist_sim,
                        history=hist)


def initial_state3(pos0, dir0, medium, *, with_stats: bool,
                   max_size: int) -> Ray3State:
    """Launch state from (R, 3) tensors ``pos0`` and ``dir0`` (normalized
    here)."""
    u0 = _normalize(dir0)
    n0, g0 = _eval3(medium, pos0)
    zeros = torch.zeros_like(n0)
    p_hor0 = n0[..., None] * u0[..., [0, 2]] if with_stats else None
    return Ray3State(
        pos=pos0, unitv=u0, n=n0, grad=g0, traveltime=zeros,
        dist_sim=zeros, dist_real=zeros,
        active=torch.ones_like(n0, dtype=torch.bool),
        exit_step=torch.full(n0.shape, max_size - 1, dtype=torch.int32,
                             device=n0.device),
        slow_count=torch.ones_like(n0) if with_stats else None,
        slow_mean=p_hor0,
        slow_m2=torch.zeros_like(p_hor0) if with_stats else None)


def trace3d(method: str, medium, *, pos0, dir0, delta_s: float, steps: int,
            box=None, mode: str = "history", dtype=torch.float32,
            stats: bool = False, step_limit: int | None = None,
            device="cuda") -> Trace3Result:
    """Trace a batch of 3-D rays through ``medium`` on ``device``.

    ``pos0``/``dir0`` are (R, 3) launch points and directions (normalized
    internally); ``box`` is (x0, x1, y0, y1, z0, z1) or None for an
    unbounded domain; ``stats=True`` tracks Welford statistics of the
    horizontal slowness vector (the 3-D conservation oracle for stratified
    media).  ``dtype`` is a torch or numpy float dtype.  A sampled
    medium's table must lie on ``device``.
    """
    method = canonical3(method)
    dtype = _torch_dtype(dtype)
    if mode not in ("history", "metrics"):
        raise ValueError(f"mode must be 'history' or 'metrics', got {mode!r}")
    pos0 = torch.as_tensor(np.asarray(pos0), dtype=dtype, device=device)
    dir0 = torch.as_tensor(np.asarray(dir0), dtype=dtype, device=device)
    if pos0.dim() != 2 or pos0.shape[-1] != 3 or dir0.shape != pos0.shape:
        raise ValueError(f"pos0/dir0 must both be (rays, 3), got "
                         f"{tuple(pos0.shape)} / {tuple(dir0.shape)}")
    max_size = int(steps) + 1
    if step_limit is None:
        step_limit = max_size - 1
    box_t = tuple(float(b) for b in box) if box is not None else None
    if box_t is not None and len(box_t) != 6:
        raise ValueError(f"box must be 6 floats (x0,x1,y0,y1,z0,z1), "
                         f"got {box!r}")
    st0 = initial_state3(pos0, dir0, medium, with_stats=bool(stats),
                         max_size=max_size)
    # the step rounds to the working dtype, as JAX's traced scalar does
    ds = torch.tensor(delta_s, dtype=dtype, device=pos0.device)
    return _run3(method, st0, medium, ds, max_size=max_size,
                 step_limit=int(step_limit), box=box_t,
                 history=mode == "history")


def bouguer_invariant(result: Trace3Result):
    """``n |r x u|`` along each history row (numpy): exactly conserved by
    the true dynamics in any spherically symmetric medium (the optical
    Bouguer theorem), so its drift measures pure integrator error."""
    if result.history is None:
        raise ValueError("bouguer_invariant needs mode='history'")
    h = result.history.detach().cpu().numpy()
    r = h[..., 0:3]
    u = h[..., 5:8]
    n = h[..., 4]
    return n * np.linalg.norm(np.cross(r, u), axis=-1)
