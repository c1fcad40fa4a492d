"""Refractive-index fields of the four scenarios, with analytic gradients.

Port of ``raytracing_tpu/media/fields.py``: ``_sigmoid`` (fields.py:24),
``interface``/``interface_grad`` (:44, :49), ``fisheye``/``fisheye_grad``
(:57, :62), ``vert_heterogeneous``/``vert_heterogeneous_grad`` (:70, :75),
``anisotropy`` (:83) and ``anisotropy_uv`` (:93).  These mirror the
scenario functions of the reference (RT_bench.py:104-119) and add
closed-form gradients.

Every function is elementwise torch on tensors of any shape and keeps the
input dtype; Python float constants stay weak, so a float32 input computes
in float32 and a float64 input in float64.
"""
from __future__ import annotations

import torch

from raytracing_tpu_torch.config import THCK_PARAM

_SQRT2 = 1.4142135623730951


# -- Sharp interface: sigmoid in y (RT_bench.py:106-108) --------------------
def _sigmoid(t):
    """Overflow-safe logistic 1/(1 + e^-t).

    Both branches exponentiate ``-|t|``, so nothing overflows in float32
    for t < ~ -88; the t >= 0 branch is the reference's expression
    (RT_bench.py:107) verbatim.  ``-|t|`` is taken by a select, not
    ``abs``, so a forward-mode tangent through t == 0 picks a branch
    instead of a zero derivative.
    """
    pos = t >= 0
    e = torch.exp(torch.where(pos, -t, t))
    return torch.where(pos, 1.0 / (1.0 + e), e / (1.0 + e))


def interface(x, y):
    """n = sqrt(2) - (sqrt(2)-1) / (1 + exp(-y/THCK_PARAM))."""
    return _SQRT2 - (_SQRT2 - 1.0) * _sigmoid(y / THCK_PARAM)


def interface_grad(x, y):
    """Closed-form (dn/dx, dn/dy) of :func:`interface`."""
    sig = _sigmoid(y / THCK_PARAM)
    dndy = -(_SQRT2 - 1.0) * sig * (1.0 - sig) / THCK_PARAM
    return torch.zeros_like(dndy), dndy


# -- Maxwell fisheye (RT_bench.py:110-112) ----------------------------------
def fisheye(x, y):
    """n = 1 / (1 + x^2 + y^2)."""
    return 1.0 / (1.0 + x * x + y * y)


def fisheye_grad(x, y):
    """(dn/dx, dn/dy) = -2 n^2 (x, y)."""
    n = fisheye(x, y)
    c = -2.0 * n * n
    return c * x, c * y


# -- Vertically heterogeneous (RT_bench.py:114-116) -------------------------
def vert_heterogeneous(x, y):
    """n = 1 / (18 + 2 y)."""
    return 1.0 / (18.0 + 2.0 * y)


def vert_heterogeneous_grad(x, y):
    """(dn/dx, dn/dy) = (0, -2 n^2)."""
    n = vert_heterogeneous(x, y)
    dndy = -2.0 * n * n
    return torch.zeros_like(dndy), dndy


# -- Anisotropy factor (RT_bench.py:118-119) --------------------------------
def anisotropy(theta, gamma):
    """Elliptical angular factor sqrt((gamma sin t)^2 + cos^2 t).

    Multiplies an isotropic n to make the medium anisotropic; equals 1 for
    gamma == 1 (isotropic media).
    """
    s, c = torch.sin(theta), torch.cos(theta)
    gs = gamma * s
    return torch.sqrt(gs * gs + c * c)


def anisotropy_uv(ux, uy, gamma):
    """:func:`anisotropy` expressed in the unit tangent (cos t, sin t):
    sqrt(g^2 uy^2 + ux^2), no sin/cos round trip."""
    gu = gamma * uy
    return torch.sqrt(gu * gu + ux * ux)


#: field name -> (n(x, y), grad(x, y) -> (dndx, dndy))
FIELDS = {
    "interface": (interface, interface_grad),
    "fisheye": (fisheye, fisheye_grad),
    "vert_heterogeneous": (vert_heterogeneous, vert_heterogeneous_grad),
}
