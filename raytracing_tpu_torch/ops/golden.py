"""Branchless golden-section minimizer.

Port of ``raytracing_tpu/ops/golden.py::golden_minimize`` (golden.py:23):
the reference's data-dependent ``while |c - d| > GOLD_TOL`` loop
(RT_bench.py:175-199) with a fixed trip count (``config.golden_iters``),
one new cost evaluation per iteration.
"""
from __future__ import annotations

import torch

from raytracing_tpu_torch.config import GOLD_RATIO


def golden_minimize(cost_fn, a, b, iters: int):
    """Minimize ``cost_fn`` on [a, b] with ``iters`` golden-section steps.

    ``a``/``b`` are tensors (batched brackets); ``cost_fn`` must be
    elementwise.  Returns the bracket midpoint, the reference's
    ``(b + a) / 2`` (RT_bench.py:199).
    """
    r = GOLD_RATIO
    c = b - (b - a) * r
    d = a + (b - a) * r
    fc = cost_fn(c)
    fd = cost_fn(d)
    for _ in range(iters):
        left = fc < fd                      # keep [a, d] if True else [c, b]
        a2 = torch.where(left, a, c)
        b2 = torch.where(left, d, b)
        c2 = b2 - (b2 - a2) * r
        d2 = a2 + (b2 - a2) * r
        # r^2 = 1 - r makes exactly one of (c2, d2) a reused point: on a
        # left keep c2 == old c (value fc), on a right keep d2 == old d.
        fresh = torch.where(left, c2, d2)
        ffresh = cost_fn(fresh)
        fc, fd = torch.where(left, ffresh, fd), torch.where(left, fc, ffresh)
        a, b, c, d = a2, b2, c2, d2
    return (a + b) / 2
