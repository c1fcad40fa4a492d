"""3-D media: everything the 3-D integrator needs is ``n_and_grad3``.

Port of ``raytracing_tpu/media/fields3d.py``: the closed forms and their
gradients ``FIELDS3`` (fields3d.py:34-82), ``Analytic3D`` (:85),
``analytic_medium3`` (:98), ``Custom3D`` (:104) and ``Stratified3D``
(:126).  A 3-D medium has one method::

    n, (dndx, dndy, dndz) = medium.n_and_grad3(x, y, z)

* :class:`Analytic3D`   — closed-form fields (the Maxwell fisheye lifts
  verbatim: n = 1/(1 + r^2) is spherically symmetric, and its rays are the
  same circles as in 2-D; vert and interface lift with dn/dx = dn/dz = 0).
* :class:`Custom3D`     — any elementwise torch n(x, y, z); its gradient
  by three forward-mode ``torch.func.jvp``, or a user ``grad_fn``.
* :class:`Stratified3D` — lifts any 2-D x-independent medium of the port
  (the analytic vert field, the measured stratified and C1 profile tables)
  into 3-D: n depends on y only, so the horizontal slowness vector (n u_x,
  n u_z) is an exact invariant.

Every function is elementwise torch and keeps the input dtype, as
:mod:`raytracing_tpu_torch.media.fields`.  The 3-D scan tier
(``engine/trace3d.py``) reads these media; the fused 3-D kernels inline the
analytic fields (``kernels/fused3d.py``, ``csrc/fused3d.cuh``).
"""
from __future__ import annotations

import dataclasses

import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.media.fields import _SQRT2, _sigmoid


def _fisheye3(x, y, z):
    r2 = x * x + y * y + z * z
    return 1.0 / (1.0 + r2)


def _fisheye3_grad(x, y, z):
    r2 = x * x + y * y + z * z
    c = -2.0 / ((1.0 + r2) * (1.0 + r2))
    return c * x, c * y, c * z


def _vert3(x, y, z):
    return 1.0 / (18.0 + 2.0 * y) + 0.0 * x


def _vert3_grad(x, y, z):
    n = 1.0 / (18.0 + 2.0 * y)
    zero = torch.zeros_like(x)
    return zero, -2.0 * n * n, zero


def _interface3(x, y, z):
    return (_SQRT2 - (_SQRT2 - 1.0) * _sigmoid(y / config.THCK_PARAM)
            + 0.0 * x)


def _interface3_grad(x, y, z):
    sig = _sigmoid(y / config.THCK_PARAM)
    zero = torch.zeros_like(x)
    return (zero,
            -(_SQRT2 - 1.0) * sig * (1.0 - sig) / config.THCK_PARAM,
            zero)


#: field name -> (n(x, y, z), grad(x, y, z) -> (dndx, dndy, dndz)); the
#: stratified reference fields lift with dn/dz = 0 (RT_bench.py:104-116)
FIELDS3 = {
    "fisheye": (_fisheye3, _fisheye3_grad),
    "vert_heterogeneous": (_vert3, _vert3_grad),
    "interface": (_interface3, _interface3_grad),
}


@dataclasses.dataclass(frozen=True)
class Analytic3D:
    """Closed-form 3-D medium from :data:`FIELDS3`."""

    field: str

    def n_and_grad3(self, x, y, z):
        n_fn, g_fn = FIELDS3[self.field]
        return n_fn(x, y, z), g_fn(x, y, z)

    def n3(self, x, y, z):
        return FIELDS3[self.field][0](x, y, z)


def analytic_medium3(field: str) -> Analytic3D:
    if field not in FIELDS3:
        raise ValueError(f"unknown 3-D field {field!r}; have {sorted(FIELDS3)}")
    return Analytic3D(field)


@dataclasses.dataclass(frozen=True, eq=False)
class Custom3D:
    """User 3-D medium: any elementwise torch n(x, y, z), its gradient by
    forward-mode autodiff (``torch.func.jvp``, one a direction) or from a
    hand-written ``grad_fn(x, y, z) -> (dndx, dndy, dndz)``."""

    n_fn: object                 # callable (x, y, z) -> n, elementwise
    grad_fn: object = None       # optional (x, y, z) -> (dndx, dndy, dndz)

    def n_and_grad3(self, x, y, z):
        n = self.n_fn(x, y, z)
        if self.grad_fn is not None:
            return n, self.grad_fn(x, y, z)
        ones, zeros = torch.ones_like(x), torch.zeros_like(x)
        _, gx = torch.func.jvp(self.n_fn, (x, y, z), (ones, zeros, zeros))
        _, gy = torch.func.jvp(self.n_fn, (x, y, z), (zeros, ones, zeros))
        _, gz = torch.func.jvp(self.n_fn, (x, y, z), (zeros, zeros, ones))
        return n, (gx, gy, gz)

    def n3(self, x, y, z):
        return self.n_fn(x, y, z)


def _device_of(medium) -> torch.device:
    """The device of a medium's first table (the CPU for a table-less
    medium)."""
    if dataclasses.is_dataclass(medium):
        for f in dataclasses.fields(medium):
            v = getattr(medium, f.name)
            if torch.is_tensor(v):
                return v.device
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True, eq=False)
class Stratified3D:
    """A 2-D x-independent medium lifted to 3-D: n = n(y), horizontal
    isotropy in (x, z).

    Wraps any medium whose ``n_and_grad(x, y)`` ignores x (the analytic
    vert field, the measured 1-D profile tables): in 3-D the whole
    horizontal slowness vector (n u_x, n u_z) is then invariant.

    X-independence is probed at construction (wide-spread float64 x
    samples at a few y values, on the medium's device): wrapping a
    genuinely 2-D medium would silently zero its x-gradient.  Clamping
    media (grid tables) clamp the wide probes to opposite edges, so
    x-variation still shows.
    """

    base: object   # 2-D x-independent medium with n_and_grad(x, y)

    def __post_init__(self):
        dev = _device_of(self.base)
        xs = torch.tensor([-1e3, 0.0, 1e3], dtype=torch.float64, device=dev)
        for yv in (-1.0, 0.0, 1.0):
            n, (gx, _) = self.base.n_and_grad(xs, torch.full_like(xs, yv))
            n = n.detach().cpu().double()
            gx = gx.detach().cpu().double()
            if (float((n - n[0]).abs().max()) > 1e-9 * (1 + abs(float(n[0])))
                    or float(gx.abs().max()) > 1e-12):
                raise ValueError(
                    "Stratified3D needs an x-independent medium "
                    "(n = n(y)); the wrapped medium's n or dn/dx varies "
                    "with x — lift genuinely 2-D media to 3-D with a "
                    "Custom3D(n_fn(x, y, z)) instead")

    def n_and_grad3(self, x, y, z):
        n, (_, gy) = self.base.n_and_grad(x, y)
        zero = torch.zeros_like(n)
        return n, (zero, gy, zero)

    def n3(self, x, y, z):
        n, _ = self.base.n_and_grad(x, y)
        return n
