"""The integrator core: a loop over steps on batch tensors (the scan tier).

Port of ``raytracing_tpu/engine/trace.py``: ``TraceResult`` (trace.py:37),
``initial_state`` (:61), ``_outside`` (:85), the step body of
``_build_trace_fn`` (:93-179) and ``trace`` (:182) — the replacement for the
reference's ``trazar`` (RT_bench.py:766-948).  ``jax.lax.scan`` becomes a
Python loop whose carry is the state of all rays; the data-dependent
boundary exit (RT_bench.py:878-879) is an active mask, and a finished ray's
remaining history rows stay zero (RT_bench.py:800-805).

This is the parity tier: it runs at float32 and float64, on the CPU and on
the card, and the kernels of ``raytracing_tpu_torch.kernels`` are checked
against the JAX package through it.  Two output modes:

* ``history`` — per-step trajectory rows (the reference's ``s_ray``/
  ``n_ray``); memory scales as rays x steps.
* ``metrics`` — final state plus Welford momentum statistics only.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.engine.state import RayState, where_state
from raytracing_tpu_torch.media.fields import anisotropy
from raytracing_tpu_torch.ops import angles as A
from raytracing_tpu_torch.ops.momentum import moments
from raytracing_tpu_torch.ops.registry import RayPoint, build_op, canonical


class TraceResult(NamedTuple):
    """Everything ``trazar`` returned, restructured for batch access."""

    final: RayState     # state after the last step
    exit_step: Any      # (R,) int32 — d_ray[2]
    dist_real: Any      # (R,) — d_ray[0]
    dist_sim: Any       # (R,) — d_ray[1]
    history: Any        # (max_size, R, 6) [x, y, mx, my, traveltime, angle] or None
    n_hist: Any         # (max_size, R) coef*n per row, or None

    def reference_layout(self):
        """Return (s_ray, n_ray) in the reference's (max_size, 6, R) layout."""
        if self.history is None:
            raise ValueError("trace ran in metrics mode; no history stored")
        return (self.history.permute(0, 2, 1).cpu().numpy(),
                self.n_hist.cpu().numpy())


def initial_state(pos0, theta0, medium, gamma, *, with_window: bool,
                  with_momentum_stats: bool, max_size: int) -> RayState:
    """Initial conditions for a ray batch (RT_bench.py:809-826)."""
    unitv = torch.stack([torch.cos(theta0), torch.sin(theta0)], dim=-1)
    n0, (gx, gy) = medium.n_and_grad(pos0[..., 0], pos0[..., 1])
    grad0 = torch.stack([gx, gy], dim=-1)
    coef0 = anisotropy(theta0, gamma)
    m0 = moments(theta0, n0, unitv, gamma)
    zeros = torch.zeros_like(theta0)
    r = theta0.shape[0]
    return RayState(
        pos=pos0, angle=theta0, unitv=unitv, n=n0, grad=grad0, coef=coef0,
        n_eff=coef0 * n0, m=m0, traveltime=zeros, dist_sim=zeros,
        dist_real=zeros,
        active=torch.ones(r, dtype=torch.bool, device=theta0.device),
        exit_step=torch.full((r,), max_size - 1, dtype=torch.int32,
                             device=theta0.device),
        window=(pos0[:, None, :].expand(r, 4, 2).clone()
                if with_window else None),
        mom_count=torch.ones_like(theta0) if with_momentum_stats else None,
        mom_mean=m0[..., 0] if with_momentum_stats else None,
        mom_m2=zeros if with_momentum_stats else None,
    )


def _outside(pos, box):
    """Strict boundary test (RT_bench.py:878)."""
    limx_i, limx_s, limy_i, limy_s = box
    x, y = pos[..., 0], pos[..., 1]
    return (x > limx_s) | (x < limx_i) | (y > limy_s) | (y < limy_i)


def _row(st: RayState):
    return torch.stack([st.pos[..., 0], st.pos[..., 1], st.m[..., 0],
                        st.m[..., 1], st.traveltime, st.angle], dim=-1)


def run_steps(op, st0: RayState, medium, gamma, delta_s, *, max_size: int,
              step_limit: int, box, history: bool,
              step_offset: int = 0) -> TraceResult:
    """Step ``max_size - 1`` times from ``st0`` (the body of trace.py:100-175).

    The steps are numbered ``step_offset + 1`` .. ``step_offset + max_size -
    1``: a chunked run (``engine/streaming.py``) passes the steps done before
    it, so that op7's order ramp and ``exit_step`` see global indices, and
    ``step_limit`` is global too.  History rows are written into one
    preallocated (max_size, R, 6) tensor, so a run holds its rows once.
    """
    stats = st0.mom_count is not None
    # rays that never exit report step_limit as exit_step
    st = st0._replace(exit_step=torch.clamp(st0.exit_step, max=step_limit))
    hist = n_hist = None
    if history:
        row0 = _row(st0)
        hist = row0.new_empty((max_size,) + tuple(row0.shape))
        n_hist = st0.n_eff.new_empty((max_size,) + tuple(st0.n_eff.shape))
        hist[0] = row0
        n_hist[0] = st0.n_eff
    for k, i in enumerate(range(step_offset + 1, step_offset + max_size), 1):
        pt = RayPoint(pos=st.pos, angle=st.angle, unitv=st.unitv, n=st.n,
                      grad=st.grad, coef=st.coef, window=st.window)
        res = op(pt, i, medium, gamma, delta_s)

        # store_update_results (RT_bench.py:783-790, 870-875)
        dist = torch.linalg.vector_norm(st.pos - res.pos, dim=-1)
        unitv_f = torch.stack([torch.cos(res.angle), torch.sin(res.angle)], dim=-1)
        coef_f = anisotropy(res.angle, gamma)
        m_f = moments(res.angle, res.n, unitv_f, gamma)
        n_eff_f = coef_f * res.n
        tt_f = st.traveltime + dist * (st.n_eff + n_eff_f) / 2.0

        cnt = mean = m2 = None
        if stats:
            mx = m_f[..., 0]
            cnt = st.mom_count + 1.0
            delta = mx - st.mom_mean
            mean = st.mom_mean + delta / cnt
            m2 = st.mom_m2 + delta * (mx - mean)

        new = RayState(
            pos=res.pos, angle=res.angle, unitv=unitv_f, n=res.n,
            grad=res.grad, coef=coef_f, n_eff=n_eff_f, m=m_f,
            traveltime=tt_f, dist_sim=st.dist_sim + dist,
            dist_real=st.dist_real + delta_s,
            active=st.active, exit_step=st.exit_step,
            window=(A.push_window(st.window, res.pos)
                    if st.window is not None else None),
            mom_count=cnt, mom_mean=mean, mom_m2=m2,
        )
        st2 = where_state(st.active, new, st)

        out = _outside(st2.pos, box)
        newly_exited = st.active & out
        exit_step = torch.where(newly_exited,
                                torch.full_like(st.exit_step, i), st.exit_step)
        active2 = st.active & ~out & (i < step_limit)
        st2 = st2._replace(active=active2, exit_step=exit_step)

        if history:
            row = _row(st2)
            hist[k] = torch.where(st.active[..., None], row,
                                  torch.zeros_like(row))
            n_hist[k] = torch.where(st.active, st2.n_eff,
                                    torch.zeros_like(st2.n_eff))
        st = st2

    return TraceResult(final=st, exit_step=st.exit_step,
                       dist_real=st.dist_real, dist_sim=st.dist_sim,
                       history=hist, n_hist=n_hist)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def prepare(op_name: str, scen: config.ScenarioConfig, medium, *,
            delta_s: float, device, max_size: int, dtype, pos0, theta0):
    """``(op, st0, gamma, ds)`` of a trace: the op, the launch state on
    ``device`` at ``dtype``, and the step size and gamma rounded to the
    working dtype, as the JAX tier's traced scalars are.  ``pos0``/``theta0``
    None take the scenario's launch fan."""
    pos0 = torch.as_tensor(np.asarray(scen.pos0 if pos0 is None else pos0),
                           dtype=dtype, device=device)
    theta0 = torch.as_tensor(np.asarray(scen.theta0 if theta0 is None
                                        else theta0),
                             dtype=dtype, device=device)
    np_dtype = theta0.cpu().numpy().dtype
    ds = float(np_dtype.type(delta_s))
    gamma = float(np_dtype.type(scen.gamma))
    op = build_op(canonical(op_name), dtype)
    st0 = initial_state(pos0, theta0, medium, gamma,
                        with_window=op.uses_window,
                        with_momentum_stats=scen.is_vert,
                        max_size=int(max_size))
    return op, st0, gamma, ds


def trace(op_name: str, scen: config.ScenarioConfig, medium, *,
          delta_s: float, device="cuda", divisor: int | None = None,
          n_turns: int = config.N_TURNS, mode: str = "history",
          dtype=torch.float32, pos0=None, theta0=None,
          step_limit: int | None = None,
          max_size: int | None = None) -> TraceResult:
    """Trace a batch of rays through ``medium`` with step method ``op_name``.

    Parameters mirror ``trazar`` (RT_bench.py:766) with the scenario,
    medium and op passed explicitly.  ``pos0``/``theta0`` (array-likes)
    override the scenario's launch fan; ``max_size`` + ``step_limit``
    allow padded runs whose effective length is shorter.  Everything runs
    on ``device`` at ``dtype``.
    """
    op_name = canonical(op_name)
    if mode not in ("history", "metrics"):
        raise ValueError(f"mode must be 'history' or 'metrics', got {mode!r}")
    if max_size is None:
        max_size = scen.max_size(delta_s, divisor, n_turns)
    if step_limit is None:
        step_limit = max_size - 1
    op, st0, gamma, ds = prepare(op_name, scen, medium, delta_s=delta_s,
                                 device=device, max_size=int(max_size),
                                 dtype=dtype, pos0=pos0, theta0=theta0)
    return run_steps(op, st0, medium, gamma, ds, max_size=int(max_size),
                     step_limit=int(step_limit), box=tuple(scen.box),
                     history=mode == "history")
