# Verbatim copy of raytracing_tpu/calibrated.py apart from its import line
# (importing raytracing_tpu would import jax).
"""Calibrated DELTA_S tables (RT_bench.py:1408-1460).

Per-algorithm step sizes measured offline by the reference author on a grid
of SIGMA/3; these are the framework's accuracy/cost fixtures (SURVEY.md 2.13).
"""
from __future__ import annotations

from raytracing_tpu_torch.config import SIGMA

#: interface / vert-heterogeneous scenarios: DELTA_S = SIGMA / divisor
#: (RT_bench.py:1413-1430)
INTERFACE_VERT_DIVISOR = {
    "op1": 38.64, "op2": 38.37, "op3": 2.34, "op4": 2.53, "op5": 2.53,
    "op6": 2.55, "op7": 30.05, "op8": 2.74, "op9": 2.74,
}

#: fisheye: number of unit-circle segments, benchmark set — steps matched to
#: the interface scenario's calibrated lengths (RT_bench.py:1431-1450)
FISHEYE_DIVISOR = {
    "op1": 4587, "op2": 4556, "op3": 278, "op4": 300, "op5": 300,
    "op6": 303, "op7": 3567, "op8": 325, "op9": 325,
}

#: fisheye: alternative set calibrated for <= 5 % closure error over N=10
#: turns (RT_bench.py:1444 comment)
FISHEYE_DIVISOR_N10 = {
    "op1": 149, "op2": 169, "op3": 182, "op4": 179, "op5": 179,
    "op6": 182, "op7": 191, "op8": 179, "op9": 179,
}

#: anisotropic scenario (RT_bench.py:1452-1455)
ANISO_DIVISOR = {"op10": 2.53, "op11": 2.74}

# ---------------------------------------------------------------------------
# Self-calibrated divisors for the ANALYTIC media.
#
# The reference's tables above were measured on its SIGMA/3 sampled grid
# (RT_bench.py:1413 "valores medidos sobre la grilla"); reused on the
# analytic fields they are off-provenance — the analytic interface sigmoid
# is sharper than its sampled fit, and the Snell oracle fails at the
# reference step (round-2 BENCH_SUITE "interface": mean 0.444 deg > 0.2).
# These tables were measured ON-CHIP by benchmarks/calibrate_analytic.py
# (2026-08-17) with the same candidate grids and acceptance policies as the
# reference search (RT_bench.py:1296-1406), on the analytic fields, fused
# sweep, 1M-lane batches; grids extended where the reference grid has no
# acceptance crossing (docs/PARITY.md #28).
#
# ``None`` = the op's error FLOORS above the scenario bar on the analytic
# medium at every step (verified across an extended grid; e.g. interface
# op7 bottoms out at mean 0.49 deg vs the 0.2 deg bar near divisor ~29 and
# worsens in both directions).  ``calibrated_analytic`` returns
# (None, None) for such entries; the CALLER decides whether to skip the
# op on this medium or substitute another entry (there is deliberately no
# automatic fallback here — an op that cannot meet the scenario's
# acceptance bar should not silently run at a step calibrated for a
# different op).  calibrated_with_fallback's chain covers only the
# SAMPLED reference tables.

#: interface, analytic sigmoid: DELTA_S = SIGMA / divisor.
#: op6 is pinned at 5.0 rather than its mean-bar acceptance crossing
#: (4.5): the search policy targets only the MEAN Snell bar (< 0.2 deg,
#: RT_bench.py:1296-1406), and at 4.5 the MAX-error bar (< 0.8 deg,
#: RT_bench.py:69, 1329) passed with 1 % margin (0.7922 deg) — one
#: recalibration away from a red headline oracle.  Measured on-chip
#: (benchmarks/snell_margin_probe.py, logs_r4/17): 5.0 gives max
#: 0.6473 deg (19 % margin), mean 0.0871 deg; the probe also reproduced
#: 0.7922 exactly, i.e. the number is deterministic per binary.
ANALYTIC_INTERFACE_DIVISOR = {
    "op1": 67.2, "op2": 67.2, "op3": 3.89, "op4": 3.66, "op5": 3.66,
    "op6": 5.0, "op7": None, "op8": 4.25, "op9": 4.27,
}

#: vert-heterogeneous, analytic linear gradient: DELTA_S = SIGMA / divisor.
#: The gentle analytic gradient conserves momentum at far coarser steps
#: than the sampled fit (divisors well below 1).  op3 (cost-function angle
#: solve) conserves p_x BY CONSTRUCTION here: its CV never crosses the
#: 0.05 % bar anywhere in the candidate grid (f32 scan probe: 1.3e-4 % at
#: divisor 2.0 falling monotonically to 1e-5 % at 0.025 — the CV is pure
#: float noise, shrinking with step count), so the acceptance policy has
#: no crossing to find; recorded at the sweep's coarse edge.
ANALYTIC_VERT_DIVISOR = {
    "op1": 0.89, "op2": 0.89, "op3": 0.025, "op4": 0.06, "op5": 0.06,
    "op6": 0.03, "op7": 0.83, "op8": 0.05, "op9": 0.05,
}

#: fisheye, analytic Maxwell field: unit-circle segments.  Lands within a
#: few % of the reference's own N10 set (FISHEYE_DIVISOR_N10 above) — an
#: independent cross-validation of the sweep machinery, since that set was
#: calibrated by the reference author to the same <=5 % closure policy.
ANALYTIC_FISHEYE_DIVISOR = {
    "op1": 146.0, "op2": 166.0, "op3": 179.0, "op4": 176.0, "op5": 176.0,
    "op6": 179.0, "op7": 188.0, "op8": 176.0, "op9": 176.0,
}

#: anisotropic scenario, analytic medium
ANALYTIC_ANISO_DIVISOR = {"op10": 1.2, "op11": 1.2}

_ANALYTIC_TABLES = {
    "interface": ANALYTIC_INTERFACE_DIVISOR,
    "vert": ANALYTIC_VERT_DIVISOR,
    "fisheye": ANALYTIC_FISHEYE_DIVISOR,
    "aniso": ANALYTIC_ANISO_DIVISOR,
}


def calibrated_analytic(op_name: str, scenario_name: str):
    """(delta_s, divisor) for an op/scenario pair on the ANALYTIC medium.

    Same return convention as :func:`calibrated`.  Raises ``KeyError`` for
    an op the table lacks; returns ``(None, None)`` for an op whose error
    floors above the scenario acceptance bar on the analytic medium
    (table value ``None``) — the caller decides whether to substitute
    (see :func:`calibrated_with_fallback`'s chain) or skip.
    """
    div = _ANALYTIC_TABLES[scenario_name][op_name]
    if div is None:
        return None, None
    if scenario_name == "fisheye":
        import numpy as np
        return 2.0 * np.pi / div, div
    return SIGMA / div, div


def calibrated(op_name: str, scenario_name: str, fisheye_set: str = "bench"):
    """Return (delta_s, fisheye_divisor_or_None) for an op/scenario pair."""
    if scenario_name == "fisheye":
        table = FISHEYE_DIVISOR if fisheye_set == "bench" else FISHEYE_DIVISOR_N10
        div = table[op_name]
        import numpy as np
        return 2.0 * np.pi / div, div
    if scenario_name == "aniso":
        return SIGMA / ANISO_DIVISOR[op_name], None
    return SIGMA / INTERFACE_VERT_DIVISOR[op_name], None


def calibrated_with_fallback(op_name: str, scenario_name: str,
                             fisheye_set: str = "bench"):
    """Calibrated step with the extension-op fallback chain.

    Extension ops borrow their base op's entry (op12 -> op8, opNn -> opN);
    combos the tables lack fall back to the 2nd-order-Taylor entry of the
    scenario (op8, or op11 on the aniso table, which only has op10/op11 —
    RT_bench.py:1452-1455).  This is the ONE resolution policy shared by the
    model zoo, CLI, and serving layer; it never raises for a known scenario.
    """
    base = "op8" if op_name == "op12" else op_name.rstrip("n")
    for candidate in (base, "op8", "op11"):
        try:
            return calibrated(candidate, scenario_name, fisheye_set)
        except KeyError:
            continue
    raise KeyError(f"no calibrated entry resolvable for {op_name!r} on "
                   f"{scenario_name!r}")
