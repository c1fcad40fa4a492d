"""Medium abstraction: everything the integrator needs is ``n_and_grad``.

Port of ``raytracing_tpu/media/medium.py``: ``AnalyticMedium`` (medium.py:30)
and ``analytic_medium`` (:43).  A medium is a small frozen dataclass with
one method::

    n, (dndx, dndy) = medium.n_and_grad(x, y)

``CustomMedium`` (medium.py:51) is not ported yet: its kernel form
(``kernels/fused.py::_custom_nag``) is off this slice (ROADMAP.md §2 item 4).
"""
from __future__ import annotations

import dataclasses

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
