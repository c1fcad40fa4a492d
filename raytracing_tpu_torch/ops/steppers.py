"""Position-advancement methods (L1 steppers).

Port of ``raytracing_tpu/ops/steppers.py``: ``first_order_taylor``
(steppers.py:20), ``second_order_taylor`` (:25) and ``curvature_step``
(:35), the reference's three steppers (RT_bench.py:298-365).

Positions are (..., 2) tensors (x, y); the reference's ``if curv <
GOLD_TOL`` / ``if np.cross(...) > 0`` branches (RT_bench.py:354-363) are
``torch.where`` selects.
"""
from __future__ import annotations

import torch


def first_order_taylor(pos, unitv, step):
    """Linear advance r + u*ds (RT_bench.py:300-312)."""
    return pos + unitv * step


def second_order_taylor(pos, unitv, step, n, grad):
    """Taylor advance with transverse-gradient correction (RT_bench.py:314-333).

    r' = r + u*ds + (grad_n - (grad_n . u) u) * ds^2 / (2 n)
    """
    gdotu = torch.sum(grad * unitv, dim=-1, keepdim=True)
    transverse = grad - gdotu * unitv
    return pos + unitv * step + transverse * (step * step) / (2.0 * n[..., None])


def curvature_step(angle, grad, unitv, n, pos, step, tol):
    """Arc step on the circle of curvature (RT_bench.py:335-365).

    kappa = |grad_n - (grad_n . u) u| / n; when kappa < tol the step
    degenerates to first order and the caller keeps the old angle (the
    reference's ``ignore`` flag, RT_bench.py:354-357).

    Returns ``(new_pos, significant)``.  The chord uses the identities
    ``sin(t) - sin(t - d) = 2 cos(t - d/2) sin(d/2)`` (and the cosine
    analogue), free of cancellation when ``kappa * ds`` is tiny.
    """
    gdotu = torch.sum(grad * unitv, dim=-1, keepdim=True)
    transverse = grad - gdotu * unitv
    curv = torch.linalg.vector_norm(transverse, dim=-1) / n
    significant = curv >= tol
    safe_curv = torch.where(significant, curv, torch.ones_like(curv))
    d = curv * step

    # Turn direction from the 2-D cross product grad x u (RT_bench.py:360).
    turn_left = (grad[..., 0] * unitv[..., 1] - grad[..., 1] * unitv[..., 0]) > 0
    sgn = torch.where(turn_left, -torch.ones_like(d), torch.ones_like(d))
    half = sgn * d / 2.0
    sin_half = torch.sin(half)
    coeff = 2.0 * sin_half * sgn / safe_curv
    dx = torch.cos(angle + half) * coeff
    dy = torch.sin(angle + half) * coeff
    arc_pos = pos + torch.stack([dx, dy], dim=-1)

    lin_pos = first_order_taylor(pos, unitv, step)
    new_pos = torch.where(significant[..., None], arc_pos, lin_pos)
    return new_pos, significant
