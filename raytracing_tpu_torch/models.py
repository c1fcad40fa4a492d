"""Model zoo: ready-to-trace (scenario, medium) pairings with calibrated steps.

Port of ``raytracing_tpu/models.py``: ``MEDIUM_KINDS`` (models.py:35),
``Model`` with ``delta_s``, ``trace``, ``run`` and ``_resolve`` (:38-88),
``MODEL_NAMES`` (:91) and ``get`` (:96).  The four physics scenarios
(RT_bench.py:104-119, 247-295), each with five medium backends:

* ``analytic``      — closed-form n / grad n (exact; the fastest kernels)
* ``stratified``    — the reference's sampled-spline pipeline collapsed to
  1-D tables for the x-independent fields (``fused_step_strat``,
  ``golden_step_strat``)
* ``grid``          — the full 2-D sampled-spline pipeline
  (``fused_step_grid``, ``golden_step_grid``)
* ``c1``            — the consistent-gradient 2-D medium (media/c1.py): one
  spline serves n and grad n
* ``c1-stratified`` — the 1-D consistent form for x-independent fields

A model lives on one device: its tables are built there, and ``run``
(``engine/fast.py::fast_trace``) and ``trace`` (``engine/trace.py::trace``)
run there::

    model = raytracing_tpu_torch.models.get("interface", medium="stratified")
    res = model.run("HySA")                # the kernels, calibrated step
    res = model.trace("HySA")              # the scan tier

``get`` caches one model a (scenario, medium, dtype, turns, device) and
fills the cache under a lock, so that concurrent callers (the request
threads of ``serve.py``) build a medium's tables once.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.media.medium import analytic_medium

MEDIUM_KINDS = ("analytic", "stratified", "grid", "c1", "c1-stratified")


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    scenario: config.ScenarioConfig
    medium: Any          # AnalyticMedium | StratifiedGridMedium | GridMedium | ...
    medium_kind: str     # one of MEDIUM_KINDS
    device: str = "cuda"

    def delta_s(self, op_name: str) -> tuple[float, float | None]:
        """Calibrated (delta_s, divisor) for ``op_name`` on this scenario.

        Extension ops borrow their base op's entry (op12 -> op8, opNn ->
        opN); combos absent from the table fall back to op8's
        (RT_bench.py:1408-1460).
        """
        from raytracing_tpu_torch.calibrated import calibrated_with_fallback
        from raytracing_tpu_torch.ops.registry import canonical

        return calibrated_with_fallback(canonical(op_name),
                                        self.scenario.name)

    def trace(self, op_name: str, *, delta_s: float | None = None,
              n_turns: int = config.N_TURNS, **kw):
        """Scan-tier trace at the calibrated step, on the model's device."""
        from raytracing_tpu_torch.engine.trace import trace

        ds, divisor = self._resolve(op_name, delta_s)
        return trace(op_name, self.scenario, self.medium, delta_s=ds,
                     divisor=(int(divisor) + 1) if divisor else None,
                     n_turns=n_turns, device=self.device, **kw)

    def run(self, op_name: str, *, delta_s: float | None = None,
            n_turns: int = config.N_TURNS, pos0=None, theta0=None, **kw):
        """Metrics-only trace through the kernels, on the model's device."""
        from raytracing_tpu_torch.engine.fast import fast_trace

        ds, divisor = self._resolve(op_name, delta_s)
        if pos0 is None:
            pos0 = np.asarray(self.scenario.pos0, np.float32)
        if theta0 is None:
            theta0 = np.asarray(self.scenario.theta0, np.float32)
        return fast_trace(op_name, self.scenario, self.medium, delta_s=ds,
                          divisor=(int(divisor) + 1) if divisor else None,
                          n_turns=n_turns, pos0=pos0, theta0=theta0,
                          device=self.device, **kw)

    def _resolve(self, op_name, delta_s):
        if delta_s is not None:
            div = (round(2 * np.pi / delta_s)
                   if self.scenario.is_fisheye else None)
            return float(delta_s), div
        ds, divisor = self.delta_s(op_name)
        return float(ds), (divisor if self.scenario.is_fisheye else None)


MODEL_NAMES = config.SCENARIO_NAMES

_CACHE: dict = {}
_LOCK = threading.Lock()


def get(name: str, medium: str = "analytic", dtype=torch.float32,
        n_turns: int = config.N_TURNS, device="cuda") -> Model:
    """Build (cached) a scenario + medium pairing on ``device``.

    ``medium="grid"`` builds the reference's 2-D sampled-spline tables
    (``fast_trace`` runs them through ``fused_step_grid``);
    ``"stratified"`` is the same sampled medium in its 1-D form for the
    x-independent fields; ``"analytic"`` is exact and the fastest path.
    The fisheye varies in x: its stratified forms raise ValueError, as do
    an unknown scenario or medium.
    """
    if medium not in MEDIUM_KINDS:
        raise ValueError(f"medium must be one of {MEDIUM_KINDS}, got {medium!r}")
    key = (name, medium, str(dtype), n_turns, str(torch.device(device)))
    with _LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
        scen = config.scenario(name, n_turns=n_turns)
        kw = dict(device=device, dtype=dtype)
        if medium == "grid":
            from raytracing_tpu_torch.media.spline import build_grid_medium

            med = build_grid_medium(scen.field, scen.box, **kw)
        elif medium == "stratified":
            from raytracing_tpu_torch.media.spline import (
                build_stratified_medium)

            med = build_stratified_medium(scen.field, scen.box, **kw)
        elif medium == "c1":
            from raytracing_tpu_torch.media.c1 import build_c1_medium

            med = build_c1_medium(scen.field, scen.box, **kw)
        elif medium == "c1-stratified":
            from raytracing_tpu_torch.media.c1 import build_c1_stratified

            med = build_c1_stratified(scen.field, scen.box, **kw)
        else:
            med = analytic_medium(scen.field)
        model = Model(name=scen.name, scenario=scen, medium=med,
                      medium_kind=medium, device=str(torch.device(device)))
        _CACHE[key] = model
        return model
