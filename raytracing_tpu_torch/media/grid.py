# Copy of raytracing_tpu/media/grid.py (numpy only) apart from its import
# line: importing the JAX package's module would import jax.
"""Host-side medium sampling: the reference's grid pipeline, bit-compatible.

Port of ``raytracing_tpu/media/grid.py``: ``NP_FIELDS`` (grid.py:35),
``gen_grid`` (:41) and ``gradient_grids`` (:60) — the reference's ``genZ``
(RT_bench.py:412-433) and the derivative grids of ``interpolacion``
(RT_bench.py:450-452).  Everything here runs on the host in float64 numpy
exactly as the reference does; device code only sees the coefficient tables
built from it (:mod:`raytracing_tpu_torch.media.spline`).
"""
from __future__ import annotations

import numpy as np

from raytracing_tpu_torch import config

_SQRT2 = np.sqrt(2.0)


# numpy twins of media.fields (host-side sampling is float64 whatever the
# working dtype)
def _interface_np(x, y):
    # exp overflows harmlessly to inf deep below the interface (n -> sqrt(2))
    with np.errstate(over="ignore"):
        return _SQRT2 - (_SQRT2 - 1.0) / (1.0 + np.exp(-y / config.THCK_PARAM))


def _fisheye_np(x, y):
    return 1.0 / (1.0 + x * x + y * y)


def _vert_np(x, y):
    return 1.0 / (18.0 + 2.0 * y)


NP_FIELDS = {
    "interface": _interface_np,
    "fisheye": _fisheye_np,
    "vert_heterogeneous": _vert_np,
}


def gen_grid(field: str, box, delta: float = config.DELTA):
    """Sample the index field on the padded scenario grid (RT_bench.py:412-433).

    Pads the domain by +/-3 units and uses the reference's exact point-count
    truncation ``int((span + 6)/delta + 1)``.

    Returns (x, y, Z) with Z[j, i] = f(x[i], y[j]) — y is the leading axis,
    as in the reference's meshgrid sampling (RT_bench.py:430-432).
    """
    xi, xs, yi, ys = box
    qx = int((xs - xi + 6) / delta + 1)
    qy = int((ys - yi + 6) / delta + 1)
    x = np.linspace(xi - 3, xs + 3, qx)
    y = np.linspace(yi - 3, ys + 3, qy)
    X, Y = np.meshgrid(x, y)
    Z = NP_FIELDS[field](X, Y)
    return x, y, Z


def gradient_grids(Z, delta: float = config.DELTA):
    """First-derivative grids via ``np.gradient`` (RT_bench.py:450).

    Returns (dndx, dndy).  The reference's ``GradX`` is the axis-0
    gradient, i.e. d/dy (SURVEY.md 2.5); here names mean what they say.
    """
    dndy, dndx = np.gradient(Z, delta, edge_order=2)
    return dndx, dndy
