"""Medium abstraction: everything the integrator needs is ``n_and_grad``.

Port of ``raytracing_tpu/media/medium.py``: ``AnalyticMedium`` (medium.py:30),
``analytic_medium`` (:43) and ``CustomMedium`` (:49-79).  A medium is a small
frozen dataclass with one method::

    n, (dndx, dndy) = medium.n_and_grad(x, y)

``CustomMedium`` runs on the scan tiers (``engine/trace.py``,
``engine/dynamic.py``) and, through ``fast_trace``, in the fused and golden
CUDA kernels: ``kernels/custom.py`` (the port of
``kernels/fused.py::_custom_nag``) traces ``n_fn`` (and ``grad_fn``) into
elementwise operations and emits them into a kernel of the medium's own.
``fast_dynamic`` keeps it on the scan tier (``"dynamic-scan"``), as JAX
does.
"""
from __future__ import annotations

import dataclasses

import torch

from raytracing_tpu_torch.media import fields as _fields


@dataclasses.dataclass(frozen=True)
class AnalyticMedium:
    """Closed-form medium: n and its gradient from :mod:`media.fields`."""

    field: str  # key into fields.FIELDS

    def n_and_grad(self, x, y):
        n_fn, grad_fn = _fields.FIELDS[self.field]
        return n_fn(x, y), grad_fn(x, y)

    def n(self, x, y):
        return _fields.FIELDS[self.field][0](x, y)


def analytic_medium(field: str) -> AnalyticMedium:
    if field not in _fields.FIELDS:
        raise ValueError(f"unknown field {field!r}; have {sorted(_fields.FIELDS)}")
    return AnalyticMedium(field)


@dataclasses.dataclass(frozen=True, eq=False)
class CustomMedium:
    """User-defined medium: any elementwise torch function n(x, y), its
    gradient by forward-mode autodiff (``torch.func.jvp``), or from a
    hand-written ``grad_fn(x, y) -> (dndx, dndy)`` where autodiff through
    the field is ill-conditioned.  A second ``jvp`` (the dynamic tier's
    tangent) gives the Hessian.  The kernels take a field built from the
    operations of ``kernels/custom.py``'s ``RULES`` (forward mode in the
    kernel when there is no ``grad_fn``); ``fast_trace`` raises ValueError,
    before any launch, for any other.  Hashed by identity: the kernels'
    traced form is cached per medium object."""

    n_fn: object                 # callable (x, y) -> n, elementwise
    grad_fn: object = None       # optional callable (x, y) -> (dndx, dndy)

    def n_and_grad(self, x, y):
        n = self.n_fn(x, y)
        if self.grad_fn is not None:
            return n, self.grad_fn(x, y)
        ones = torch.ones_like(x)
        zeros = torch.zeros_like(x)
        _, dndx = torch.func.jvp(self.n_fn, (x, y), (ones, zeros))
        _, dndy = torch.func.jvp(self.n_fn, (x, y), (zeros, ones))
        return n, (dndx, dndy)

    def n(self, x, y):
        return self.n_fn(x, y)
