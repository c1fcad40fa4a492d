"""Ray momenta for isotropic and anisotropic media.

Port of ``raytracing_tpu/ops/momentum.py``: ``moment`` (momentum.py:17) and
``moments`` (:27), the reference's ``moment``/``moments``
(RT_bench.py:217-245), with the anisotropy ratio ``gamma`` an explicit
argument.  For gamma == 1 ``moments`` reduces to n * (cos t, sin t).
"""
from __future__ import annotations

import torch

from raytracing_tpu_torch.media.fields import anisotropy


def moment(n, theta, gamma, trig, quad):
    """Directional momentum component (RT_bench.py:217-230).

    ``trig``/``quad`` are the two entries of the reference's ``opt_vec``:
    (cos t, -sin^2 t) for the x component, (sin t, cos^2 t) for y.
    """
    coef = anisotropy(theta, gamma)
    return n * coef * trig * (1.0 + quad * (gamma * gamma - 1.0) / (coef * coef))


def moments(theta, n, unitv, gamma):
    """Momentum vector (m_x, m_y) of a ray (RT_bench.py:232-245)."""
    ux, uy = unitv[..., 0], unitv[..., 1]
    mx = moment(n, theta, gamma, ux, -(uy * uy))
    my = moment(n, theta, gamma, uy, ux * ux)
    return torch.stack([mx, my], dim=-1)
