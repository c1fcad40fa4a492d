"""fast_trace: one entry point for the kernel tier on analytic media.

Port of ``raytracing_tpu/engine/fast.py``: ``FastResult`` (fast.py:59),
``supports`` (:85) and ``fast_trace`` (:99), restricted to
:class:`AnalyticMedium`.  Fused ops go to ``kernels/fused.py``, golden and
Newton ops to ``kernels/golden.py``, for all four scenarios and any step
count.

Not ported, on purpose: ``SEGMENT_THRESHOLD`` and the segmented route
(fast.py:56, 226-307) and the angle sort (fast.py:275-283).  They bound
Mosaic's compile time and skip frozen TPU blocks; on the card one launch
covers every trace length, and each thread stops stepping once its ray is
frozen, which gives the same results.

Every other medium, and ``precision="high"``, raises NotImplementedError
naming the ROADMAP.md item that ports it; nothing falls back to the scan
tier silently.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.kernels.fused import (
    FUSED_FIELDS, FUSED_OPS, fused_trace_final)
from raytracing_tpu_torch.kernels.golden import GOLDEN_OPS, golden_trace_final
from raytracing_tpu_torch.media.medium import AnalyticMedium
from raytracing_tpu_torch.ops.registry import canonical

#: fields on which p_x is an invariant (x-independent), so stats=True holds
STATS_FIELDS = ("vert_heterogeneous", "interface")


class FastResult(NamedTuple):
    pos: Any         # (R, 2) final positions
    traveltime: Any  # (R,)
    dist_sim: Any    # (R,)
    active: Any      # (R,) bool: still inside the box
    engine: str      # "fused" | "golden"
    mom_count: Any = None   # Welford p_x tracker (stats=True)
    mom_mean: Any = None
    mom_m2: Any = None
    tangent: Any = None     # (R, 2) final unit tangent


def supports(op_name: str, medium) -> bool:
    """True when a kernel covers this (op, medium) pairing."""
    op = canonical(op_name)
    return (isinstance(medium, AnalyticMedium)
            and medium.field in FUSED_FIELDS
            and (op in FUSED_OPS or op in GOLDEN_OPS))


def fast_trace(op_name: str, scen: config.ScenarioConfig, medium, *,
               delta_s, pos0, theta0, device, steps: int | None = None,
               divisor: int | None = None, n_turns: int = config.N_TURNS,
               precision: str = "standard", stats: bool = False
               ) -> FastResult:
    """Metrics-only trace through the kernels, on ``device``.

    ``pos0`` (R, 2) / ``theta0`` (R,) may have any R.  ``steps`` defaults to
    the scenario's ``max_size - 1``.  ``stats=True`` fills the Welford
    tracker of p_x (RT_bench.py:1352-1360); it needs an x-independent field
    (:data:`STATS_FIELDS`), where p_x is an invariant.  The JAX tier offers
    stats on stratified tables only; on the analytic vert and interface
    fields the invariant is the same.
    """
    op = canonical(op_name)
    if precision == "high":
        raise NotImplementedError(
            "precision='high' (the df32 RK4 kernel, kernels/df.py) is not "
            "ported yet: ROADMAP.md §1 item 16 and §2 item 10")
    if precision != "standard":
        raise ValueError(f"precision must be 'standard' or 'high', got {precision!r}")
    if not isinstance(medium, AnalyticMedium):
        raise NotImplementedError(
            f"fast_trace on {type(medium).__name__} is not ported yet: "
            "sampled media are ROADMAP.md §1 items 9-10 (§2 items 5, 7-9), "
            "CustomMedium is §2 item 4")
    if not supports(op, medium):
        raise ValueError(f"no kernel for {op!r} on field {medium.field!r}")
    if stats and medium.field not in STATS_FIELDS:
        raise ValueError(f"stats=True needs an x-independent field "
                         f"{STATS_FIELDS}; p_x is not an invariant on "
                         f"{medium.field!r}")
    if steps is None:
        steps = scen.max_size(float(delta_s), divisor, n_turns) - 1

    box = tuple(scen.box)
    if op in GOLDEN_OPS:
        g = golden_trace_final(pos0, theta0, delta_s, scen.gamma,
                               field=medium.field, op=op, steps=int(steps),
                               box=box, device=device, with_stats=stats)
        tangent = torch.stack([torch.cos(g.angle), torch.sin(g.angle)], dim=-1)
        return FastResult(pos=g.pos, traveltime=g.traveltime,
                          dist_sim=g.dist_sim, active=g.active,
                          engine="golden", mom_count=g.mom_count,
                          mom_mean=g.mom_mean, mom_m2=g.mom_m2,
                          tangent=tangent)
    f = fused_trace_final(pos0, theta0, delta_s, field=medium.field, op=op,
                          steps=int(steps), box=box, device=device,
                          with_stats=stats)
    return FastResult(pos=f.pos, traveltime=f.traveltime, dist_sim=f.dist_sim,
                      active=f.active, engine="fused", mom_count=f.mom_count,
                      mom_mean=f.mom_mean, mom_m2=f.mom_m2, tangent=f.tangent)
