"""Newton refinement of the anisotropic momentum-impulse angle solve.

Port of ``raytracing_tpu/ops/newton.py::newton_minimize`` (newton.py:31).
The first and second derivatives of the cost come from nested forward-mode
``torch.func.jvp`` — the counterpart of the nested ``jax.jvp`` at
newton.py:40-49.  Newton on d(cost)/d(theta) = 0 seeded at the previous
angle converges quadratically, so three iterations reach roundoff.
"""
from __future__ import annotations

import torch
from torch.func import jvp

#: Newton iterations; quadratic convergence from an O(delta_s) seed.
NEWTON_ITERS = 3
#: trust region: per-iteration step clamp (rad).
MAX_STEP = 0.3


def newton_minimize(cost_fn, theta0, iters: int = NEWTON_ITERS):
    """Elementwise Newton on d(cost)/d(theta) = 0, seeded at ``theta0``.

    The second derivative is floored away from zero (keeping |f''| so a
    maximum repels) and each step is clamped to +/-MAX_STEP.
    """

    def dcost(t):
        return jvp(cost_fn, (t,), (torch.ones_like(t),))[1]

    theta = theta0
    for _ in range(iters):
        d1, d2 = jvp(dcost, (theta,), (torch.ones_like(theta),))
        ad2 = torch.abs(d2)
        safe = torch.where(ad2 < 1e-12, torch.full_like(ad2, 1e-12), ad2)
        step = torch.clamp(d1 / safe, -MAX_STEP, MAX_STEP)
        theta = theta - step
    return theta
