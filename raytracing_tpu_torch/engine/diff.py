"""Differentiable tracing: gradients through the integrator.

Port of ``raytracing_tpu/engine/diff.py``: ``ParametricMedium`` (diff.py:46),
``DiffTrace`` (:83), ``parametric_grid_medium`` (:92),
``parametric_profile_medium`` (:124) and ``trace_diff`` (:148), on torch
autograd.  The reference is a forward simulator only; since every step of
the op matrix (``ops/registry.py::build_op``) is a torch function of its
inputs, a whole trace is a differentiable function of the medium's
parameters, the launch positions and angles, the step size and the
anisotropy gamma, and an inverse problem ("which medium bends rays like
this?") is ordinary gradient descent: ``torch.optim.Adam(med.parameters())``
where JAX uses optax.

* :class:`ParametricMedium` is an ``nn.Module``: ``n = n_fn(params, x, y)``
  with ``params`` its parameter (or a tensor the caller differentiates
  with respect to).  The x/y gradient the steps need is autodiff of
  ``n_fn`` by ``torch.autograd.grad(..., create_graph=True)``, so that
  gradient is itself differentiable in the parameters (JAX takes it by
  forward mode, ``jax.jvp``; the two agree to rounding, and reverse mode
  costs a fraction of ``torch.func.jvp``'s host time a step).
* :func:`trace_diff` runs a fixed number of steps with masked freezing at
  the box, so reverse mode differentiates the whole trace;
  ``remat_segments=k`` recomputes each of k segments in the backward pass
  (``torch.utils.checkpoint``) instead of storing every step's residuals.

Use the scan and kernel tiers for forward tracing (history, streaming,
oracles); use this module when the trace sits inside an optimization loop.
The golden-section ops (op5, op9, op10, op11) are piecewise constant in
their cost, so their parameter gradients are zero almost everywhere; the
smooth ops (op1-op4, op6-op8, op12) and the Newton ops op10n/op11n carry
exact gradients.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raytracing_tpu_torch.media import fields as _fields
from raytracing_tpu_torch.ops.registry import RayPoint, build_op, canonical


def _keep(t):
    return t


class ParametricMedium(torch.nn.Module):
    """Medium ``n = n_fn(params, x, y)`` whose parameters are differentiable.

    ``params`` that already take part in autograd (a tensor that requires
    grad, or one computed from such a tensor) are used as they are, so the
    caller's gradient reaches them; anything else becomes this module's
    ``nn.Parameter``, so ``torch.optim.Adam(medium.parameters())`` fits it.
    ``n_fn`` is elementwise in x and y.  The gradient (dn/dx, dn/dy) is
    autodiff of ``n_fn`` and is differentiable in ``params``.
    """

    def __init__(self, n_fn, params):
        super().__init__()
        self.n_fn = n_fn
        if isinstance(params, torch.nn.Parameter) or not (
                torch.is_tensor(params) and params.requires_grad):
            params = torch.nn.Parameter(torch.as_tensor(params))
        self.params = params

    def n(self, x, y):
        return self.n_fn(self.params, x, y)

    def n_and_grad(self, x, y):
        """n and (dn/dx, dn/dy) at (x, y): the gradient by reverse mode on
        the elementwise ``n_fn`` with ``create_graph=True``, so it is itself
        differentiable in the parameters and in x and y.  A coordinate that
        carries no graph is differentiated as a fresh leaf.  This small
        graph keeps what it saves even inside a checkpointed segment
        (``trace_diff(remat_segments=k)``): taking the gradient reads it at
        once, and a checkpoint would recompute its whole segment so far
        for every such read."""
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                _keep, _keep):
            xx, yy = (c if c.requires_grad else c.detach().requires_grad_()
                      for c in (x, y))
            n = self.n_fn(self.params, xx, yy)
            got = torch.autograd.grad(n.sum(), (xx, yy), create_graph=True,
                                      allow_unused=True)
        return n, tuple(torch.zeros_like(n) if g is None else g for g in got)


class DiffTrace(NamedTuple):
    """Final ray state of :func:`trace_diff` (unpacks like a 4-tuple)."""

    pos: Any          # (r, 2) final positions
    angle: Any        # (r,) final angles
    traveltime: Any   # (r,) optical path (trapezoid of n, RT_bench.py:874)
    active: Any       # (r,) 1.0 while inside the box, 0.0 after exit


def _values(values, device):
    """A tensor that takes part in autograd stays one (moved to
    ``device``); anything else becomes a float64 or float32 tensor there."""
    if torch.is_tensor(values):
        return values.to(device)
    return torch.as_tensor(np.asarray(values), device=device)


def _clip(v, hi):
    """``jnp.clip(v, 0, hi)`` as JAX differentiates it: a maximum, then a
    minimum, whose derivative at a tie is half (``torch.clamp``'s is whole),
    so a ray launched on the grid's edge gets JAX's gradient."""
    return torch.minimum(torch.maximum(v, torch.zeros_like(v)),
                         torch.full_like(v, hi))


def _next(i, n):
    """The node after ``i``, clamped to the last, as JAX's gather clamps an
    index out of range: in float32 the clip bound ``n - 1 - 1e-9`` rounds
    to ``n - 1``, so a point on the far edge has ``i = n - 1`` (and weight
    0 on the node after it)."""
    return torch.clamp(i + 1, max=n - 1)


def _take(values, idx):
    """``values[idx]`` for a 1-D ``values``, by ``index_select``: its
    backward adds into the 144 or so nodes with ``index_add_`` (atomics on
    the card, as JAX's scatter-add), where advanced indexing's backward
    sorts every index first."""
    return torch.index_select(values, 0, idx.reshape(-1)).reshape(idx.shape)


def parametric_grid_medium(values, x0: float, y0: float, hx: float,
                           hy: float, *, device="cuda") -> ParametricMedium:
    """A sampled medium whose node values are the parameters.

    ``values`` is a (ny, nx) array of n samples on a uniform grid with
    origin (x0, y0) and pitch (hx, hy), on ``device``; evaluation is
    bilinear, clamped at the edges, so the gradient of a ``trace_diff``
    loss with respect to ``values`` is the tomography adjoint
    (examples/tomography_torch.py fits 144 node values from crossing-ray
    travel times).  The differentiable counterpart of
    ``grid_medium_from_samples``, whose tables are built on the host.
    """
    values = _values(values, device)
    ny, nx = values.shape
    inv_hx, inv_hy = 1.0 / float(hx), 1.0 / float(hy)

    def n_fn(grid, x, y):
        fx = _clip((x - x0) * inv_hx, nx - 1 - 1e-9)
        fy = _clip((y - y0) * inv_hy, ny - 1 - 1e-9)
        fix, fiy = torch.floor(fx), torch.floor(fy)
        ix, iy = fix.long(), fiy.long()
        ix1, iy1 = _next(ix, nx), _next(iy, ny)
        u, v = fx - fix, fy - fiy
        flat = grid.reshape(-1)
        return (_take(flat, iy * nx + ix) * (1 - u) * (1 - v)
                + _take(flat, iy * nx + ix1) * u * (1 - v)
                + _take(flat, iy1 * nx + ix) * (1 - u) * v
                + _take(flat, iy1 * nx + ix1) * u * v)

    return ParametricMedium(n_fn, values)


def parametric_profile_medium(values, y0: float, hy: float, *,
                              device="cuda") -> ParametricMedium:
    """An x-independent medium whose profile samples are the parameters.

    ``values`` is (ny,) n samples on a uniform y grid, on ``device``;
    evaluation is linear in y, clamped at the edges: the differentiable
    counterpart of ``stratified_medium_from_samples``, for inverse problems
    on measured profiles.
    """
    values = _values(values, device)
    ny = values.shape[0]
    inv_hy = 1.0 / float(hy)

    def n_fn(prof, x, y):
        fy = _clip((y - y0) * inv_hy, ny - 1 - 1e-9)
        fiy = torch.floor(fy)
        iy = fiy.long()
        v = fy - fiy
        return _take(prof, iy) * (1 - v) + _take(prof, _next(iy, ny)) * v

    return ParametricMedium(n_fn, values)


def _scalar(v, dtype):
    """A step size or gamma: a tensor in ``dtype`` (its graph kept), or a
    Python float rounded to ``dtype`` as JAX's ``jnp.asarray(v, dtype)``."""
    if torch.is_tensor(v):
        return v.to(dtype)
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return float(np_dtype(v))


def trace_diff(op_name: str, medium, pos0, theta0, delta_s, *, steps: int,
               box=None, gamma: float = 1.0, remat_segments: int = 1,
               device="cuda") -> DiffTrace:
    """Differentiable fixed-step trace; returns the final ray state.

    ``pos0`` (r, 2) and ``theta0`` (r,) launch the fan on ``device`` at
    ``pos0``'s dtype; all ``steps`` steps run, numbered from 1 (op7's order
    ramp keys on them), and once a ray leaves ``box`` (xi, xs, yi, ys) its
    state freezes by masks, the production engine's semantics
    (RT_bench.py:878-879) with no data-dependent control flow.  Returns
    ``(pos, angle, traveltime, active)``.

    Differentiable in the medium's parameters, ``pos0``, ``theta0``,
    ``delta_s`` and ``gamma`` (tensors that require grad).  Only a Python
    ``1.0`` gamma takes the isotropic path (coef fixed at 1).  Reverse mode
    stores every step's residuals; ``remat_segments=k`` splits the steps
    into k checkpointed segments (``torch.utils.checkpoint``), each
    recomputed in the backward pass, for less memory at one more forward
    pass (``steps`` must divide by k).  A ``ParametricMedium`` keeps each
    step's small gradient graph whole, so the saving is less than JAX's
    k-fold.  Values are identical either way, and gradients too up to the
    order in which the backward pass accumulates sums.
    """
    op = canonical(op_name)
    pos0 = torch.as_tensor(pos0, device=device)
    dtype = pos0.dtype
    theta0 = torch.as_tensor(theta0, device=device).to(dtype)
    step_fn = build_op(op, dtype)
    iso = isinstance(gamma, (int, float)) and gamma == 1.0
    gamma_s = _scalar(gamma, dtype)
    ds = _scalar(delta_s, dtype)

    n0, g0 = medium.n_and_grad(pos0[..., 0], pos0[..., 1])
    unitv0 = torch.stack([torch.cos(theta0), torch.sin(theta0)], dim=-1)
    grad0 = torch.stack([g0[0], g0[1]], dim=-1)
    coef0 = (torch.ones_like(theta0) if iso
             else _fields.anisotropy(theta0, gamma_s))
    # op7's rolling window is carried (and its residuals stored) only when
    # the op reads it
    window0 = (pos0[..., None, :].expand(pos0.shape[:-1] + (4, 2))
               if step_fn.uses_window else None)
    pt0 = RayPoint(pos=pos0, angle=theta0, unitv=unitv0, n=n0, grad=grad0,
                   coef=coef0, window=window0)
    active0 = torch.ones_like(theta0)
    tt0 = torch.zeros_like(theta0)

    def body(carry, i):
        pt, tt, active = carry
        res = step_fn(pt, i, medium, gamma_s, ds)
        n1, grad1 = res.n, res.grad      # ops return the final-point eval
        dist = torch.sqrt(torch.sum((res.pos - pt.pos) ** 2, dim=-1))
        keep = active > 0.5
        pos = torch.where(keep[..., None], res.pos, pt.pos)
        ang = torch.where(keep, res.angle, pt.angle)
        unitv = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        coef = pt.coef if iso else _fields.anisotropy(ang, gamma_s)
        # optical path: trapezoid of the effective index coef * n along the
        # chord (RT_bench.py:784-790, 874)
        tt1 = tt + active * dist * 0.5 * (pt.coef * pt.n + coef * n1)
        window = None
        if pt.window is not None:
            window = torch.where(
                keep[..., None, None],
                torch.cat([pt.window[..., 1:, :], pos[..., None, :]], dim=-2),
                pt.window)
        npt = RayPoint(pos=pos, angle=ang, unitv=unitv,
                       n=torch.where(keep, n1, pt.n),
                       grad=torch.where(keep[..., None], grad1, pt.grad),
                       coef=coef, window=window)
        if box is not None:
            xi, xs, yi, ys = (float(b) for b in box)
            inside = ((pos[..., 0] >= xi) & (pos[..., 0] <= xs)
                      & (pos[..., 1] >= yi) & (pos[..., 1] <= ys))
            active = active * inside.to(dtype)
        return npt, tt1, active

    def run(carry, first, count):
        for i in range(first, first + count):
            carry = body(carry, i)
        return carry

    carry = (pt0, tt0, active0)
    if remat_segments <= 1:
        carry = run(carry, 1, steps)
    else:
        if steps % remat_segments:
            raise ValueError(f"steps {steps} must divide by remat_segments "
                             f"{remat_segments}")
        inner = steps // remat_segments
        for k in range(remat_segments):
            carry = checkpoint(run, carry, 1 + k * inner, inner,
                               use_reentrant=False)
    ptf, ttf, activef = carry
    return DiffTrace(ptf.pos, ptf.angle, ttf, activef)
