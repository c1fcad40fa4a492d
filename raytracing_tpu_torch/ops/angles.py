"""Angle-determination methods (L1 angle solvers).

Port of ``raytracing_tpu/ops/angles.py``: ``impulse_t`` (angles.py:15),
``theta_cost_t`` (:20), ``tfinal_2o`` (:30), ``finite_diff_1/2/3`` (:42,
:48, :54) and ``push_window`` (:61) — the reference's angle solvers
(RT_bench.py:368-407) and trapezoidal impulse (RT_bench.py:202-214).  The
4-point backward difference works on a (..., 4, 2) rolling window of
positions carried in the ray state.
"""
from __future__ import annotations

import torch


def impulse_t(a, b, step):
    """Trapezoidal impulse integral step*(a + b)/2 (RT_bench.py:202-214)."""
    return step * (a + b) / 2.0


def theta_cost_t(init_n, angle, i_grad, f_grad, step):
    """Closed-form momentum-impulse angle update (RT_bench.py:393-407).

    atan2(n sin t + J_y, n cos t + J_x) with J the trapezoidal impulse.
    """
    num = init_n * torch.sin(angle) + impulse_t(i_grad[..., 1], f_grad[..., 1], step)
    den = init_n * torch.cos(angle) + impulse_t(i_grad[..., 0], f_grad[..., 0], step)
    return torch.atan2(num, den)


def tfinal_2o(angle, step, init_n, final_n, i_grad, f_grad):
    """RK2 on d(theta)/ds (the AnDF update, RT_bench.py:374-391)."""
    k1 = step * (torch.cos(angle) * i_grad[..., 1]
                 - torch.sin(angle) * i_grad[..., 0]) / init_n
    k2 = step * (torch.cos(angle + k1) * f_grad[..., 1]
                 - torch.sin(angle + k1) * f_grad[..., 0]) / final_n
    return angle + (k1 + k2) / 2.0


# -- Backward finite differences over the 4-position window -----------------
# The window w has shape (..., 4, 2) with w[..., 3, :] the newest position.

def finite_diff_1(window):
    """First-order backward difference (priming step 1, RT_bench.py:843-844)."""
    x = window[..., 3, :] - window[..., 2, :]
    return torch.atan2(x[..., 1], x[..., 0])


def finite_diff_2(window):
    """Second-order backward difference (priming step 2, RT_bench.py:856-857)."""
    x = 3.0 * window[..., 3, :] - 4.0 * window[..., 2, :] + window[..., 1, :]
    return torch.atan2(x[..., 1], x[..., 0])


def finite_diff_3(window):
    """Third-order backward difference (the MxSA update, RT_bench.py:370-372)."""
    x = (11.0 * window[..., 3, :] - 18.0 * window[..., 2, :]
         + 9.0 * window[..., 1, :] - 2.0 * window[..., 0, :])
    return torch.atan2(x[..., 1], x[..., 0])


def push_window(window, pos):
    """Append ``pos`` as the newest entry of the rolling window."""
    return torch.cat([window[..., 1:, :], pos[..., None, :]], dim=-2)
