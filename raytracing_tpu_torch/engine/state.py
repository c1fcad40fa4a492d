"""Batched ray state carried through the integration loop.

Port of ``raytracing_tpu/engine/state.py``: ``RayState`` (state.py:18) and
``where_state`` (:40).  Optional fields (op7's position window, the Welford
momentum tracker) are ``None`` when unused.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class RayState(NamedTuple):
    """State of a ray batch; every tensor has leading shape (R,)."""

    pos: Any          # (R, 2) current position
    angle: Any        # (R,)   current group angle
    unitv: Any        # (R, 2) (cos angle, sin angle)
    n: Any            # (R,)   isotropic index at pos
    grad: Any         # (R, 2) gradient of n at pos
    coef: Any         # (R,)   anisotropy factor at angle
    n_eff: Any        # (R,)   coef * n  (the reference's n_ray entries)
    m: Any            # (R, 2) momenta
    traveltime: Any   # (R,)   accumulated optical path
    dist_sim: Any     # (R,)   accumulated Euclidean distance (d_ray[1])
    dist_real: Any    # (R,)   accumulated expected arc length (d_ray[0])
    active: Any       # (R,)   bool: still integrating
    exit_step: Any    # (R,)   int32: row index of the last written step (d_ray[2])
    window: Any       # (R, 4, 2) rolling position window, or None
    mom_count: Any    # (R,)   Welford sample count, or None
    mom_mean: Any     # (R,)   Welford running mean of m_x, or None
    mom_m2: Any       # (R,)   Welford running sum of squared deviations, or None


def where_state(mask, new: RayState, old: RayState) -> RayState:
    """Per-ray select between two states; ``mask`` has shape (R,)."""

    def sel(a, b):
        if a is None:
            return None
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)

    return RayState(*(sel(a, b) for a, b in zip(new, old)))
