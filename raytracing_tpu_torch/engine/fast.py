"""fast_trace: one entry point for the kernel tier, analytic and sampled media.

Port of ``raytracing_tpu/engine/fast.py``: ``_as_hermite`` and its LRU
cache (fast.py:31-51), ``FastResult`` (:59), ``supports`` (:85) and
``fast_trace`` (:99), with its routing of the analytic fields, the
stratified tables (compaction and the stats check, :128-139, :309-329), the
2-D grid media (:169-205) and user-defined media (:330-343).

* Analytic fields: fused ops to ``kernels/fused.py``, golden and Newton ops
  to ``kernels/golden.py`` (engines ``"fused"``, ``"golden"``).
* Stratified tables (``StratifiedGridMedium``, ``C1StratifiedMedium``),
  trimmed by ``compact_for_trace`` as JAX trims them: the same kernels on
  the tables (``"fused-strat"``, ``"golden-strat"``; JAX adds ``-seg-skip``
  for its segmented route).
* 2-D grids (``GridMedium`` through its cached Hermite form,
  ``HermiteGridMedium``, ``C1GridMedium``): ``engine/segmented.py::
  grid_trace_tiled`` (``"grid"``; JAX says ``"grid-tiled"``).
* ``CustomMedium``: traced once into the kernels' form
  (``kernels/custom.py``), golden and Newton ops to the golden loop, the
  fused ops to the fused loop, each instantiated on the medium in a library
  of its own (``"golden-custom"``, ``"fused-custom"``), one launch a trace.
  A field outside the emitter's table raises ValueError before any launch.
  ``stats=True`` raises too: JAX's custom branches carry no Welford
  tracker (fast.py:330-343).

``fast_dynamic`` (fast.py:366-472) is the dynamic twin: analytic fields,
stratified tables and 2-D grids go to the three dynamic kernels
(``kernels/dynamic.py``; engines ``"dynamic-kernel"``,
``"dynamic-kernel-strat"``, ``"dynamic-kernel-grid"``, JAX says
``"dynamic-kernel-tiled"`` for the last), every other (op, medium) pair to
the scan tier's ``trace_dynamic`` on the same device (``"dynamic-scan"``),
as JAX routes them.

* Any other 2-D medium (one with ``n_and_grad`` and no kernel, e.g. a
  ``ParametricMedium``) goes to the scan tier, ``engine/trace.py::trace``
  in metrics mode at float32 on ``device`` (``"scan"``), with ``active``
  the box test on the final positions, as JAX routes it (fast.py:237-253);
  ``stats=True`` raises there.  An object that is no medium at all raises
  NotImplementedError.

Not ported, on purpose: ``SEGMENT_THRESHOLD`` and the segmented route
(fast.py:56, 226-307) and the angle sort (fast.py:275-283).  They bound
Mosaic's compile time and skip frozen TPU blocks; on the card one launch
covers every trace length, and each thread stops stepping once its ray is
frozen, which gives the same results.  JAX sends a custom trace longer
than ``SEGMENT_THRESHOLD`` to the scan tier (fast.py:226-231), a Mosaic
compile guard; here it is one launch at every length.

``fast_trace_sharded`` (fast.py:693-804) is the multi-device form over a
``torch.distributed`` mesh (``parallel/mesh.py``): the routing and the
refusals of JAX's, each rank calling the kernels of :func:`fast_trace` on
its rows of the batch; the per-ray results, ``mom_*`` included, come back
as DTensors sharded over the flattened mesh.  Engines ``"fused-sharded"``,
``"golden-sharded"``, ``"fused-strat-sharded"``, ``"golden-strat-sharded"``,
``"fused-custom-sharded"``, ``"golden-custom-sharded"`` and
``"grid-sharded"`` (JAX: ``"grid-tiled-sharded"``).

``fast_trace3`` (fast.py:601-690) is the 3-D twin, metrics only: the
vector ops on the analytic 3-D fields go to ``fused3d_step``
(``"fused3d"``), on a ``C1Grid3Medium`` of at least 5 cells an axis to
``fused3d_step_grid`` through ``engine/tiled3.py::grid3_trace_tiled``
(``"grid3"``; JAX says ``"grid3-tiled"``), every other medium
(``Custom3D``, ``Stratified3D``, a smaller grid) to the 3-D scan tier
``trace3d`` at float32 (``"scan3d"``).  One launch a trace: JAX's
dispersed-batch fallback to the scan tier and its
``_guard_grid3_scan_fallback`` have nothing to catch here.

``fast_dynamic3`` (fast.py:506-595) is the 3-D dynamic twin, metrics
only: the vector ops on the analytic 3-D fields go to ``dynamic3d_step``
(``"dynamic3-kernel"``), on a ``C1Grid3Medium`` of at least 5 cells an
axis to ``dynamic3d_step_grid`` through
``engine/tiled3.py::grid3_trace_dynamic_tiled`` (``"dynamic3-kernel-grid"``;
JAX says ``"dynamic3-kernel-tiled"``), every other medium (``Custom3D``,
``Stratified3D``, a smaller grid) to the 3-D dynamic scan tier
``trace_dynamic3`` at float32 (``"dynamic3-scan"``).  One launch a trace:
JAX's ``try/except`` around the launch and its dispersed-batch fallback
have nothing to catch here.

``precision="high"`` (fast.py:141-162) routes op12 on the analytic fisheye
and vert fields to the df32 kernel (``kernels/df.py``, engine ``"df32"``):
float64 positions from double-word float32 arithmetic, all rays active, no
traveltime or ``dist_sim``; any other op or medium raises JAX's
``ValueError``, and so does ``stats=True`` (no Welford tracker).
"""
from __future__ import annotations

import threading
from typing import Any, NamedTuple

import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.engine.dynamic import trace_dynamic
from raytracing_tpu_torch.engine.dynamic3d import trace_dynamic3
from raytracing_tpu_torch.engine.segmented import (
    grid_trace_dynamic_tiled, grid_trace_tiled)
from raytracing_tpu_torch.engine.tiled3 import (
    grid3_trace_dynamic_tiled, grid3_trace_tiled)
from raytracing_tpu_torch.engine.trace import _outside, trace
from raytracing_tpu_torch.engine.trace3d import canonical3, trace3d
from raytracing_tpu_torch.kernels.df import DF_FIELDS, df_trace
from raytracing_tpu_torch.kernels.dynamic import (
    DYN_FUSED_FIELDS, DYN_FUSED_OPS, DynFinal, dynamic_trace_final,
    dynamic_trace_final_strat)
from raytracing_tpu_torch.kernels.dynamic3d import (
    DYN3_FUSED_FIELDS, DYN3_FUSED_OPS, Dyn3Final, dynamic3d_trace_final)
from raytracing_tpu_torch.kernels.fused import (
    FUSED_FIELDS, FUSED_OPS, _vectors, fused_trace_final,
    fused_trace_final_custom, fused_trace_final_strat)
from raytracing_tpu_torch.kernels.fused3d import (
    FUSED3_FIELDS, FUSED3_OPS, Fused3Final, fused3d_trace_final)
from raytracing_tpu_torch.kernels.golden import GOLDEN_OPS, golden_trace_final
from raytracing_tpu_torch.media.c1 import C1GridMedium, C1StratifiedMedium
from raytracing_tpu_torch.media.fields3d import Analytic3D
from raytracing_tpu_torch.media.grid3 import C1Grid3Medium
from raytracing_tpu_torch.media.hermite import (
    HermiteGridMedium, build_hermite_medium)
from raytracing_tpu_torch.media.medium import AnalyticMedium, CustomMedium
from raytracing_tpu_torch.media.samples import compact_for_trace
from raytracing_tpu_torch.media.spline import GridMedium, StratifiedGridMedium
from raytracing_tpu_torch.ops.registry import canonical

#: fields on which p_x is an invariant (x-independent), so stats=True holds
STATS_FIELDS = ("vert_heterogeneous", "interface")
STRAT_MEDIA = (StratifiedGridMedium, C1StratifiedMedium)
GRID_MEDIA = (GridMedium, HermiteGridMedium, C1GridMedium)

# GridMedium -> HermiteGridMedium conversions, cached by table identity.
# LRU-bounded: an unbounded cache would keep every medium a caller ever
# traced alive on the card.  The lock makes a lookup, and the conversion
# it may need, one step for concurrent callers (serve.py's threads).
_HERMITE_CACHE: dict = {}
_HERMITE_CACHE_MAX = 4
_HERMITE_LOCK = threading.Lock()


def _as_hermite(medium: GridMedium) -> HermiteGridMedium:
    key = id(medium.Z)
    with _HERMITE_LOCK:
        hit = _HERMITE_CACHE.pop(key, None)
        # the cached entry keeps a strong reference to the key object, so an
        # id reuse after garbage collection cannot alias a different medium
        if hit is None or hit[0] is not medium.Z:
            hit = (medium.Z, build_hermite_medium(medium))
        _HERMITE_CACHE[key] = hit  # (re)insert at the recent end
        while len(_HERMITE_CACHE) > _HERMITE_CACHE_MAX:
            _HERMITE_CACHE.pop(next(iter(_HERMITE_CACHE)))
        return hit[1]


class FastResult(NamedTuple):
    pos: Any         # (R, 2) final positions
    traveltime: Any  # (R,)
    dist_sim: Any    # (R,)
    active: Any      # (R,) bool: still inside the box
    engine: str      # "fused" | "golden" | "fused-strat" | "golden-strat" |
    #                  "fused-custom" | "golden-custom" | "grid" | "df32"
    mom_count: Any = None   # Welford p_x tracker (stats=True)
    mom_mean: Any = None
    mom_m2: Any = None
    tangent: Any = None     # (R, 2) final unit tangent


def supports(op_name: str, medium) -> bool:
    """True when a kernel covers this (op, medium) pairing."""
    op = canonical(op_name)
    if not (op in FUSED_OPS or op in GOLDEN_OPS):
        return False
    if isinstance(medium, STRAT_MEDIA + GRID_MEDIA + (CustomMedium,)):
        return True
    return isinstance(medium, AnalyticMedium) and medium.field in FUSED_FIELDS


def fast_trace(op_name: str, scen: config.ScenarioConfig, medium, *,
               delta_s, pos0, theta0, device="cuda",
               steps: int | None = None,
               divisor: int | None = None, n_turns: int = config.N_TURNS,
               precision: str = "standard", stats: bool = False
               ) -> FastResult:
    """Metrics-only trace through the kernels, on ``device``.

    ``pos0`` (R, 2) / ``theta0`` (R,) may have any R.  ``steps`` defaults to
    the scenario's ``max_size - 1``.  A sampled medium's tables must already
    lie on ``device`` (build it there or move it with ``medium.to``); they
    are never uploaded here.  ``stats=True`` fills the Welford tracker of
    p_x (RT_bench.py:1352-1360); it needs an x-independent medium, where p_x
    is an invariant: a stratified table (as in JAX) or an analytic field of
    :data:`STATS_FIELDS`, and raises on 2-D grids.  ``precision="high"``
    runs op12 through the df32 kernel (module docstring).
    """
    op = canonical(op_name)
    if precision == "high":
        return _fast_trace_df(op, scen, medium, delta_s=delta_s, pos0=pos0,
                              theta0=theta0, device=device, steps=steps,
                              divisor=divisor, n_turns=n_turns, stats=stats)
    if precision != "standard":
        raise ValueError(f"precision must be 'standard' or 'high', got {precision!r}")
    # trim stratified tables to their reachable, nontrivial window exactly
    # as JAX does: the trim fixes y0 and so every cell index's rounding
    medium = compact_for_trace(medium, scen.box, delta_s)
    if steps is None:
        steps = scen.max_size(float(delta_s), divisor, n_turns) - 1
    if not (supports(op, medium) or hasattr(medium, "n_and_grad")):
        raise NotImplementedError(
            f"fast_trace has no route for {type(medium).__name__}: it is no "
            "2-D medium (no n_and_grad; ROADMAP.md §3)")
    if not supports(op, medium):
        if stats:
            raise ValueError(f"stats=True has no kernel path for {op!r} on "
                             f"{type(medium).__name__} (scan fallback)")
        res = trace(op, scen, medium, delta_s=float(delta_s), device=device,
                    divisor=divisor, n_turns=n_turns, mode="metrics",
                    dtype=torch.float32, max_size=int(steps) + 1, pos0=pos0,
                    theta0=theta0)
        f = res.final
        # "active" = still inside the box, as the kernels report it; the
        # scan's own flag also counts the end of the step budget
        return FastResult(pos=f.pos, traveltime=f.traveltime,
                          dist_sim=f.dist_sim,
                          active=~_outside(f.pos, tuple(scen.box)),
                          engine="scan", tangent=f.unitv)
    return _kernel_route(op, scen, medium, delta_s=delta_s, pos0=pos0,
                         theta0=theta0, device=device, steps=int(steps),
                         stats=stats)


def _kernel_route(op, scen, medium, *, delta_s, pos0, theta0, device,
                  steps: int, stats: bool) -> FastResult:
    """:func:`fast_trace`'s kernel tier for a supported (op, medium) pair,
    the medium already trimmed by ``compact_for_trace``."""
    strat = isinstance(medium, STRAT_MEDIA)
    grid = isinstance(medium, GRID_MEDIA)
    custom = isinstance(medium, CustomMedium)
    if stats and custom:
        raise ValueError("stats=True has no CustomMedium path: JAX's custom "
                         "kernels carry no Welford tracker (fast.py:330-343)")
    if stats and grid:
        raise ValueError("stats=True needs a stratified (x-independent) "
                         "medium — p_x is only an invariant there; got "
                         f"{type(medium).__name__}")
    if stats and not strat and medium.field not in STATS_FIELDS:
        raise ValueError(f"stats=True needs an x-independent field "
                         f"{STATS_FIELDS}; p_x is not an invariant on "
                         f"{medium.field!r}")
    box = tuple(scen.box)
    if grid:
        if isinstance(medium, GridMedium):
            # the Hermite node form is the same spline in the kernels' layout
            medium = _as_hermite(medium)
        f = grid_trace_tiled(op, pos0, theta0, delta_s, medium,
                             steps=steps, box=box, device=device,
                             gamma=float(scen.gamma))
        return FastResult(pos=f.pos, traveltime=f.traveltime,
                          dist_sim=f.dist_sim, active=f.active, engine="grid",
                          tangent=f.tangent)
    # JAX's order (fast.py:309-355): the tables, the custom media, the
    # analytic fields; golden before fused in each
    kind = "-strat" if strat else "-custom" if custom else ""
    if op in GOLDEN_OPS:
        kw = (dict(field=None, medium=medium) if strat or custom
              else dict(field=medium.field))
        g = golden_trace_final(pos0, theta0, delta_s, scen.gamma, op=op,
                               steps=steps, box=box, device=device,
                               with_stats=stats, **kw)
        tangent = torch.stack([torch.cos(g.angle), torch.sin(g.angle)], dim=-1)
        return FastResult(pos=g.pos, traveltime=g.traveltime,
                          dist_sim=g.dist_sim, active=g.active,
                          engine="golden" + kind,
                          mom_count=g.mom_count, mom_mean=g.mom_mean,
                          mom_m2=g.mom_m2, tangent=tangent)
    if strat:
        f = fused_trace_final_strat(pos0, theta0, delta_s, medium, op=op,
                                    steps=steps, box=box, device=device,
                                    with_stats=stats)
    elif custom:
        f = fused_trace_final_custom(pos0, theta0, delta_s, medium=medium,
                                     op=op, steps=steps, box=box,
                                     device=device)
    else:
        f = fused_trace_final(pos0, theta0, delta_s, field=medium.field,
                              op=op, steps=steps, box=box, device=device,
                              with_stats=stats)
    return FastResult(pos=f.pos, traveltime=f.traveltime, dist_sim=f.dist_sim,
                      active=f.active, engine="fused" + kind,
                      mom_count=f.mom_count, mom_mean=f.mom_mean,
                      mom_m2=f.mom_m2, tangent=f.tangent)


def fast_trace_sharded(op_name: str, scen: config.ScenarioConfig, medium, *,
                       delta_s, pos0, theta0, mesh, steps: int,
                       block_rays: int = 4096, stats: bool = False,
                       device="cuda") -> FastResult:
    """Kernel-tier tracing with the ray batch sharded across ``mesh``
    (fast.py:693-804), a ``DeviceMesh`` from ``parallel.mesh.make_mesh``.

    Every rank passes the whole batch (or a DTensor of it) and traces its
    rows of it with the kernels :func:`fast_trace` launches, on ``device``
    (this rank's card, or the CPU on a CPU mesh); no collective runs inside
    the trace.  The per-ray results, ``mom_*`` included (``stats=True``,
    stratified media only, as in JAX), come back as DTensors of the whole
    batch sharded over the flattened mesh: ``.to_local()`` is this rank's
    rows, ``.full_tensor()`` gathers them.  The batch must divide by the
    device count times ``block_rays``, JAX's kernel block (the kernels here
    have none, but the port refuses exactly the calls JAX refuses).  2-D
    grids go through ``grid_trace_tiled(mesh=)`` (``"grid-sharded"``).  A
    rank that fails makes the call fail on every rank.
    """
    from raytracing_tpu_torch.parallel import mesh as meshlib

    op = canonical(op_name)
    meshlib.check_device(mesh, device)
    if stats and not isinstance(medium, STRAT_MEDIA):
        raise ValueError("stats=True needs a stratified (x-independent) "
                         "medium — p_x is only an invariant there; got "
                         f"{type(medium).__name__}")
    if isinstance(medium, GridMedium):
        medium = _as_hermite(medium)
    if isinstance(medium, (HermiteGridMedium, C1GridMedium)):
        if op not in FUSED_OPS and op not in GOLDEN_OPS:
            raise ValueError(f"2-D grid media cover {FUSED_OPS} and "
                             f"{tuple(GOLDEN_OPS)}, got {op!r}")
        g = grid_trace_tiled(op, pos0, theta0, delta_s, medium,
                             steps=int(steps), box=tuple(scen.box),
                             device=device, gamma=float(scen.gamma),
                             mesh=mesh, block_rays=min(block_rays, 1024))
        return FastResult(pos=g.pos, traveltime=g.traveltime,
                          dist_sim=g.dist_sim, active=g.active,
                          engine="grid-sharded", tangent=g.tangent)
    # only media this function dispatches on: the wider supports() set
    # would trace the wrong field here (fast.py:761-771)
    sharded_ok = (isinstance(medium, STRAT_MEDIA + (CustomMedium,))
                  or (isinstance(medium, AnalyticMedium)
                      and medium.field in FUSED_FIELDS))
    golden = op in GOLDEN_OPS
    if not (sharded_ok and (op in FUSED_OPS or golden)):
        raise ValueError(
            f"fast_trace_sharded covers the fused and golden ops on "
            f"analytic/stratified/custom media and the full op set on "
            f"2-D grid media; got {op!r} on {type(medium).__name__}")
    # one trim, on the whole scenario, before the split (fast.py:758)
    medium = compact_for_trace(medium, scen.box, delta_s)
    f = meshlib.over_batch(
        mesh, device, lambda p, t: _kernel_route(
            op, scen, medium, delta_s=delta_s, pos0=p, theta0=t,
            device=device, steps=int(steps), stats=stats),
        "fast_trace_sharded", pos0, theta0, block_rays=block_rays)
    return f._replace(engine=f.engine + "-sharded")


def _fast_trace_df(op, scen, medium, *, delta_s, pos0, theta0, device,
                   steps, divisor, n_turns, stats) -> FastResult:
    """``precision="high"`` (fast.py:141-162): op12 on an analytic field of
    :data:`DF_FIELDS` through the df32 kernel (``df_step``, engine
    ``"df32"``), one launch; float64 positions, no traveltime, no box."""
    if stats:
        raise ValueError("stats=True has no df32 path: the df32 kernel "
                         "carries no Welford tracker")
    if op != "op12":
        raise ValueError("precision='high' uses the df32 RK4 kernel; "
                         f"pass op12 (got {op!r})")
    if not (isinstance(medium, AnalyticMedium)
            and medium.field in DF_FIELDS):
        raise ValueError(f"df32 kernel supports analytic {DF_FIELDS}")
    if steps is None:
        steps = scen.max_size(float(delta_s), divisor, n_turns) - 1
    x, y, th = _vectors(pos0, theta0, device)
    pos = df_trace(torch.stack([x, y], dim=-1), th, delta_s, steps=int(steps),
                   field=medium.field, device=device)
    return FastResult(pos=pos, traveltime=None, dist_sim=None,
                      active=torch.ones(pos.shape[0], dtype=torch.bool,
                                        device=pos.device),
                      engine="df32")


def fast_dynamic(op_name: str, scen: config.ScenarioConfig, medium, *,
                 delta_s, pos0, theta0, device="cuda",
                 steps: int | None = None, divisor: int | None = None,
                 n_turns: int = config.N_TURNS):
    """Metrics-only DYNAMIC trace on ``device``: returns ``(DynFinal,
    engine)``.

    Routed by (op, medium) before any launch (fast.py:366-472): the smooth
    ops op1/op2/op6/op8 on an analytic field go to ``dynamic_step``
    (``"dynamic-kernel"``), on a stratified table (trimmed by
    ``compact_for_trace``) to ``dynamic_step_strat``
    (``"dynamic-kernel-strat"``), on a 2-D grid (``GridMedium`` through its
    cached Hermite form, ``HermiteGridMedium``, ``C1GridMedium``) to
    ``dynamic_step_grid`` (``"dynamic-kernel-grid"``); golden and Newton
    ops and any other medium (``CustomMedium``) to the scan tier's
    ``trace_dynamic`` in metrics mode at float32 (``"dynamic-scan"``): a
    golden op's tangent is zero almost everywhere, but the scan tier gives
    it as JAX does.  A sampled medium's tables must lie on ``device``.
    """
    op = canonical(op_name)
    medium = compact_for_trace(medium, scen.box, delta_s)
    if steps is None:
        steps = scen.max_size(float(delta_s), divisor, n_turns) - 1
    box = tuple(scen.box)
    kw = dict(steps=int(steps), box=box, device=device)
    if op in DYN_FUSED_OPS:
        if (isinstance(medium, AnalyticMedium)
                and medium.field in DYN_FUSED_FIELDS):
            return (dynamic_trace_final(pos0, theta0, delta_s,
                                        field=medium.field, op=op, **kw),
                    "dynamic-kernel")
        if isinstance(medium, STRAT_MEDIA):
            return (dynamic_trace_final_strat(pos0, theta0, delta_s, medium,
                                              op=op, **kw),
                    "dynamic-kernel-strat")
        if isinstance(medium, GRID_MEDIA):
            if isinstance(medium, GridMedium):
                medium = _as_hermite(medium)
            return (grid_trace_dynamic_tiled(op, pos0, theta0, delta_s,
                                             medium, **kw),
                    "dynamic-kernel-grid")

    d = trace_dynamic(op, scen, medium, delta_s=float(delta_s),
                      mode="metrics", dtype=torch.float32, device=device,
                      pos0=pos0, theta0=theta0, max_size=int(steps) + 1,
                      step_limit=int(steps))
    tangent = torch.stack([torch.cos(d.angle), torch.sin(d.angle)], dim=-1)
    # "active" = still inside the box, as the kernels report it: exit_step
    # alone is ambiguous (a ray exiting at step i == steps also carries
    # exit_step == steps), so test the final (frozen) position
    bx = torch.tensor(box, dtype=torch.float32, device=d.pos.device)
    active = ((d.pos[:, 0] >= bx[0]) & (d.pos[:, 0] <= bx[1])
              & (d.pos[:, 1] >= bx[2]) & (d.pos[:, 1] <= bx[3]))
    return (DynFinal(pos=d.pos, tangent=tangent, n=d.n,
                     traveltime=d.traveltime, dist_sim=d.dist_sim,
                     active=active, q=d.q, dtheta=d.dtheta, kmah=d.kmah),
            "dynamic-scan")


def fast_trace3(method: str, medium, *, pos0, dir0, delta_s, steps: int,
                box, device="cuda"):
    """Metrics-only 3-D trace on ``device``: returns ``(Fused3Final,
    engine)`` with engine ``"fused3d"``, ``"grid3"`` or ``"scan3d"``
    (module docstring).  ``pos0``/``dir0`` are (R, 3), any R; ``box`` the 6
    faces (x0, x1, y0, y1, z0, z1).  ``active`` means "never left the box"
    on every route: on the scan route it is the containment of the final
    position, since the scan tier's own flag also folds in the step budget
    (fast.py:680-686).  JAX's ``block_rays`` and ``interpret`` are gone.
    """
    method = canonical3(method)
    if box is None or len(tuple(box)) != 6:
        raise ValueError(f"fast_trace3 needs a 6-face box, got {box!r}")
    box = tuple(float(b) for b in box)
    if method in FUSED3_OPS:
        if isinstance(medium, Analytic3D) and medium.field in FUSED3_FIELDS:
            return (fused3d_trace_final(pos0, dir0, delta_s,
                                        field=medium.field, op=method,
                                        steps=int(steps), box=box,
                                        device=device),
                    "fused3d")
        if (isinstance(medium, C1Grid3Medium) and medium.nx - 1 >= 5
                and medium.ny - 1 >= 5 and medium.nz - 1 >= 5):
            return (grid3_trace_tiled(method, pos0, dir0, delta_s, medium,
                                      steps=int(steps), box=box,
                                      device=device),
                    "grid3")
    t = trace3d(method, medium, pos0=pos0, dir0=dir0,
                delta_s=float(delta_s), steps=int(steps), box=box,
                mode="metrics", dtype=torch.float32, device=device)
    st = t.final
    return (Fused3Final(pos=st.pos, tangent=st.unitv,
                        traveltime=st.traveltime, dist_sim=st.dist_sim,
                        active=_inside3(st.pos, box)),
            "scan3d")


def _inside3(p, box):
    """Containment of (R, 3) positions in the 6-face box."""
    return ((p[:, 0] >= box[0]) & (p[:, 0] <= box[1])
            & (p[:, 1] >= box[2]) & (p[:, 1] <= box[3])
            & (p[:, 2] >= box[4]) & (p[:, 2] <= box[5]))


def fast_dynamic3(method: str, medium, *, pos0, dir0, delta_s, steps: int,
                  box, device="cuda"):
    """Metrics-only 3-D DYNAMIC trace on ``device``: returns ``(Dyn3Final,
    engine)`` with engine ``"dynamic3-kernel"``, ``"dynamic3-kernel-grid"``
    or ``"dynamic3-scan"`` (module docstring).  ``pos0``/``dir0`` are (R,
    3), any R; ``box`` the 6 faces.  ``active`` means "never left the box"
    on every route: on the scan route it is the containment of the final
    position (fast.py:587-591).  JAX's ``block_rays`` and ``interpret`` are
    gone.
    """
    method = canonical3(method)
    if box is None or len(tuple(box)) != 6:
        raise ValueError(f"fast_dynamic3 needs a 6-face box, got {box!r}")
    box = tuple(float(b) for b in box)
    kw = dict(steps=int(steps), box=box, device=device)
    if method in DYN3_FUSED_OPS:
        if (isinstance(medium, Analytic3D)
                and medium.field in DYN3_FUSED_FIELDS):
            return (dynamic3d_trace_final(pos0, dir0, delta_s,
                                          field=medium.field, op=method,
                                          **kw),
                    "dynamic3-kernel")
        if (isinstance(medium, C1Grid3Medium) and medium.nx - 1 >= 5
                and medium.ny - 1 >= 5 and medium.nz - 1 >= 5):
            return (grid3_trace_dynamic_tiled(method, pos0, dir0, delta_s,
                                              medium, **kw),
                    "dynamic3-kernel-grid")
    d = trace_dynamic3(method, medium, pos0=pos0, dir0=dir0,
                       delta_s=float(delta_s), mode="metrics",
                       dtype=torch.float32, **kw)
    return (Dyn3Final(pos=d.pos, tangent=d.unitv, traveltime=d.traveltime,
                      dist_sim=d.dist_sim, active=_inside3(d.pos, box),
                      detq=d.detq, kmah=d.kmah, n=d.n,
                      min_absdet=d.min_absdet,
                      min_absdet_step=d.min_absdet_step),
            "dynamic3-scan")
