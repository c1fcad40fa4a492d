"""Shared entry points for measured media: one family dispatch, one trim.

Port of ``raytracing_tpu/media/samples.py``: ``medium_from_samples``
(samples.py:23) and ``compact_for_trace`` (:69).
"""
from __future__ import annotations

import numpy as np
import torch

from raytracing_tpu_torch.media.c1 import (
    C1StratifiedMedium, c1_medium_from_samples, c1_stratified_from_samples,
    compact_c1_stratified)
from raytracing_tpu_torch.media.spline import (
    StratifiedGridMedium, compact_stratified, grid_medium_from_samples,
    stratified_medium_from_samples)


def medium_from_samples(samples, x=None, y=None, *, family: str = "parity",
                        device="cuda", dtype=torch.float32):
    """``(medium, default_box, kind)`` from raw measured-index arrays.

    ``samples`` is a (ny,) profile (with coordinate vector ``y``) or a
    (ny, nx) grid (with ``x`` and ``y``); ``family`` picks the
    reference-parity builders (media/spline.py) or the consistent-gradient
    C1 builders (media/c1.py).  ``default_box`` spans the sampled region
    (profiles are x-independent: unbounded in x); ``kind`` is
    ``"profile"`` or ``"grid"``.  Raises ValueError on a bad family or
    rank or a missing axis; the builders validate the axes.
    """
    if family not in ("parity", "c1"):
        raise ValueError(f"family must be 'parity' or 'c1', got {family!r}")
    samples = np.asarray(samples, np.float64)
    if y is None:
        raise ValueError("samples need the 'y' coordinate vector")
    y = np.asarray(y, np.float64)
    kw = dict(device=device, dtype=dtype)
    if samples.ndim == 1:
        medium = (c1_stratified_from_samples(samples, y, **kw)
                  if family == "c1"
                  else stratified_medium_from_samples(samples, y, **kw))
        return medium, (-1e30, 1e30, float(y[0]), float(y[-1])), "profile"
    if samples.ndim == 2:
        if x is None:
            raise ValueError("2-D samples need the 'x' coordinate vector")
        x = np.asarray(x, np.float64)
        medium = (c1_medium_from_samples(samples, x, y, **kw)
                  if family == "c1"
                  else grid_medium_from_samples(samples, x, y, **kw))
        box = (float(x[0]), float(x[-1]), float(y[0]), float(y[-1]))
        return medium, box, "grid"
    raise ValueError(f"samples must be 1-D or 2-D, got {samples.ndim}-D")


def compact_for_trace(medium, box, delta_s):
    """Trim a stratified medium's table to the rays reachable from ``box``.

    The one margin rule: the box's y-extent ± 2·delta_s (a boxed ray's last
    step lands at most ~delta_s outside before the exit mask freezes it).
    A different trim would shift ``y0`` and with it the float32 rounding of
    every cell index, so ``fast_trace`` trims exactly this way.  Other
    media pass through unchanged.
    """
    y_range = (box[2] - 2 * float(delta_s), box[3] + 2 * float(delta_s))
    if isinstance(medium, StratifiedGridMedium):
        return compact_stratified(medium, y_range=y_range)
    if isinstance(medium, C1StratifiedMedium):
        return compact_c1_stratified(medium, y_range=y_range)
    return medium
