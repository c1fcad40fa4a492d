"""The DELTA_S search: candidate sweeps, acceptance policies, selection.

Port of ``raytracing_tpu/parallel/sweep.py``: ``SweepResult`` (sweep.py:30),
``candidates`` (:41), the acceptance policies ``find_index_*`` (:71-110),
``run_candidates_fused`` (:113), ``_max_sizes`` (:333), ``run_candidates``
(:339), ``fused_sweep_supported`` (:409), ``delta_s_search`` (:436),
``delta_s_search_convergence`` (:528) and ``_richardson_search`` (:587) —
the reference's search mode (RT_bench.py:1296-1406), which fans
``search_delta`` out over a process pool and picks the coarsest step whose
oracle passes.

Two tiers, as in JAX:

* ``run_candidates``, the scan tier: the JAX package vmaps one padded scan
  over the candidates; here the candidate axis is a loop over
  ``engine/trace.run_steps``, each candidate at the padded ``max_size``
  with its own ``step_limit``, so the oracles read the same history rows.
* ``run_candidates_fused``, the kernel tier: analytic, stratified and
  golden candidates launch one at a time, as JAX launches them; the fused
  candidates on a 2-D grid run all at once through ``grid_sweep_tiled``
  (the ``fused_sweep_grid`` kernel, one ray a candidate).

``delta_s_search_convergence3`` (:624) calibrates the 3-D tier's step the
same way, through the port's ``engine/trace3d.py::trace3d``.

Not ported: sharding the candidates over a mesh (``mesh=``, ROADMAP.md §1
item 18) and the padding of the launch fan to a kernel block (``rays``,
``block_rays``): the kernels mask the ragged edge, and the metrics read
only the fan's first rays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.engine import oracles
from raytracing_tpu_torch.engine.trace import (
    _torch_dtype, initial_state, run_steps)
from raytracing_tpu_torch.ops.registry import build_op, canonical

_MESH_TODO = ("sharding a sweep over a device mesh is not ported yet: "
              "ROADMAP.md §1 item 18")


class SweepResult(NamedTuple):
    scenario: str
    op_name: str
    divisors: np.ndarray          # candidate divisors, reference ordering
    delta_s: np.ndarray           # candidate step sizes
    metrics: dict[str, np.ndarray]  # per-candidate acceptance metrics
    index: int | None             # accepted candidate, or None
    divisor: float | None         # rounded selected divisor (RT_bench.py:1379-1383)
    delta_s_selected: float | None
    engine: str = "scan"          # the tier that ran the candidates


def candidates(scen: config.ScenarioConfig):
    """Candidate divisor grid per scenario (RT_bench.py:1302-1312).

    Returns (divisors, delta_s, trace_divisors) — ``trace_divisors`` is what
    sizes the fisheye buffer (the reference passes ``divisors + 1`` into
    ``trazar``, RT_bench.py:1318).

    Reference quirk kept deliberately: the vert/aniso grid uses DELTA_STEP
    (0.01), not the DELTA_STEP_VERT constant defined for it — that constant
    is dead code in the reference (RT_bench.py:95, 1311).
    """
    c = config
    if scen.is_interface:
        divisors = np.arange(c.DELTA_S_DIVISOR_UPPER_LIMIT,
                             c.DELTA_S_DIVISOR_LOWER_LIMIT - c.DELTA_STEP,
                             -c.DELTA_STEP)
        return divisors, c.SIGMA / divisors, None
    if scen.is_fisheye:
        divisors = np.arange(c.DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT,
                             c.DELTA_S_DIVISOR_FISHEYE_LOWER_LIMIT
                             - c.DELTA_STEP_FISHEYE,
                             -c.DELTA_STEP_FISHEYE)
        return divisors, 2.0 * np.pi / divisors, divisors + 1
    divisors = np.arange(c.DELTA_S_DIVISOR_VERT_UPPER_LIMIT,
                         c.DELTA_S_DIVISOR_VERT_LOWER_LIMIT - 2 * c.DELTA_STEP,
                         -c.DELTA_STEP)
    return divisors, c.SIGMA / divisors, None


# -- acceptance policies (host logic, RT_bench.py:1320-1375) ----------------
def find_index_interface(errors, max_errors,
                         max_dev=config.MAX_DEVIATION,
                         max_single=config.MAX_DEVIATION_SINGLE_RAY):
    """Largest step whose mean/max errors pass with all coarser ones passing
    (RT_bench.py:1323-1332)."""
    errors = list(errors)
    max_errors = list(max_errors)
    if not any(e > max_dev for e in errors) or not any(e < max_dev for e in errors):
        return None
    for i in reversed(range(len(errors))):
        if errors[i] < max_dev and max_errors[i] < max_single:
            if (all(e < max_dev for e in errors[:i])
                    and all(e < max_single for e in max_errors[:i])):
                return i
    return None


def find_index_fisheye(errors, max_dev=config.MAX_CLOSURE_ERROR_PCT):
    """Last candidate before closure error crosses the threshold
    (RT_bench.py:1339-1347)."""
    errors = list(errors)
    if not any(e > max_dev for e in errors) or not any(e < max_dev for e in errors):
        return None
    for i, e in enumerate(errors):
        if e > max_dev:
            return i - 1
    return None


def find_index_vert(errors, max_dev=config.MAX_MOMENTUM_CV_PCT):
    """First CV crossing with all previous candidates passing
    (RT_bench.py:1363-1373)."""
    errors = list(errors)
    if not any(e > max_dev for e in errors) or not any(e < max_dev for e in errors):
        return None
    for i in range(len(errors)):
        if i > 1 and errors[i] > max_dev:
            if all(e < max_dev for e in errors[:i - 1]):
                return i - 1
    return None


def _np(t):
    return t.detach().cpu().numpy()


def sweep_fan(scen: config.ScenarioConfig):
    """The kernel sweep's launch fan (sweep.py:177-189) as float32 numpy:
    ``(pos0, theta0, nf)``: the scenario's own fan, or the fisheye's one
    ray.  JAX pads it to a kernel block; the kernels here mask the ragged
    edge and the metrics read the ``nf`` fan rays only."""
    if scen.is_fisheye:
        return (np.array([[1.0, 0.0]], np.float32),
                np.full(1, np.pi / 2.0, np.float32), 1)
    fan = np.asarray(scen.theta0, np.float32)
    return (np.tile(scen.pos0[:1].astype(np.float32), (len(fan), 1)), fan,
            len(fan))


def candidate_metrics(scen: config.ScenarioConfig, fan, nf: int,
                      final) -> dict:
    """One candidate's acceptance metrics from its kernel run's
    ``FusedFinal`` or ``GoldenFinal`` (sweep.py:300-318), in the JAX
    package's float32 numpy arithmetic: fisheye closure from ray 0's
    position, interface Snell errors from the final tangents of the first
    ``nf`` rays (a golden run's from numpy cos/sin of its angle), vert/aniso
    the mean momentum CV of the fan's interior rays (``cv[1:-1]``, the
    reference's convention)."""
    if scen.is_fisheye:
        p = _np(final.pos[0])
        return {"closure_pct": 100.0 * np.linalg.norm(p - [1.0, 0.0])
                / (2.0 * np.pi)}
    if scen.is_interface:
        if hasattr(final, "angle"):
            a = _np(final.angle[:nf])
            tang = np.stack([np.cos(a), np.sin(a)], -1)
        else:
            tang = _np(final.tangent[:nf])
        errs = oracles.snell_errors_from_tangent(tang, fan[:nf])
        return {"mean_err": errs.mean(), "max_err": errs.max()}
    cnt, mean, m2 = (_np(t[:nf]) for t in (final.mom_count, final.mom_mean,
                                            final.mom_m2))
    cv = 100.0 * np.sqrt(m2 / cnt) / mean
    return {"cv_pct": float(np.mean(cv[1:-1]))}


def run_candidates_fused(op_name: str, scen: config.ScenarioConfig,
                         delta_s: np.ndarray, step_limits: np.ndarray,
                         max_steps: int, *, medium=None,
                         checkpoint: str | None = None, chunk: int = 32,
                         device="cuda"):
    """Candidate sweep through the kernels — any scenario (sweep.py:113).

    ``medium``: None for the scenario's analytic field, a stratified
    medium (parity or C1; not the fisheye) or a 2-D grid (the fisheye
    only), held on ``device``.  Stratified tables are trimmed ONCE, with
    the widest candidate step, as JAX trims them (sweep.py:172-173): the
    trim fixes ``y0`` and with it every cell index's rounding, so the
    kernels are called directly and not through ``fast_trace``.

    Each analytic, stratified or golden candidate is one launch of
    ``max_steps`` steps frozen after its own step limit.  Fused candidates
    on a grid are all one launch of ``fused_sweep_grid``
    (:func:`grid_sweep_tiled`); golden ones on a grid one launch each of
    ``golden_step_grid``.  Metrics as :func:`candidate_metrics`.
    ``checkpoint`` persists finished candidate chunks (``SweepCheckpoint``)
    and a rerun resumes from them.
    """
    from raytracing_tpu_torch.engine.fast import GRID_MEDIA, STRAT_MEDIA, _as_hermite
    from raytracing_tpu_torch.engine.segmented import grid_sweep_tiled, grid_tables
    from raytracing_tpu_torch.kernels.fused import fused_trace_final, strat_tables
    from raytracing_tpu_torch.kernels.golden import GOLDEN_OPS, golden_trace_final
    from raytracing_tpu_torch.media.samples import compact_for_trace
    from raytracing_tpu_torch.media.spline import GridMedium
    from raytracing_tpu_torch.utils.checkpoint import SweepCheckpoint

    use_grid = isinstance(medium, GRID_MEDIA)
    if use_grid:
        if not scen.is_fisheye:
            raise ValueError(
                "2-D grid sweeps cover the fisheye scenario; interface/"
                "vert sample exactly to 1-D — pass a StratifiedGridMedium")
        if isinstance(medium, GridMedium):
            medium = _as_hermite(medium)
    # the widest candidate step sets the reachability margin for the batch
    medium = compact_for_trace(medium, scen.box, float(np.max(delta_s)))
    use_strat = isinstance(medium, STRAT_MEDIA)
    use_golden = op_name in GOLDEN_OPS
    box = tuple(scen.box)
    pos0, fan, nf = sweep_fan(scen)
    with_stats = scen.is_vert
    n = len(delta_s)
    out = {k: np.empty(n) for k in (
        ("mean_err", "max_err") if scen.is_interface else
        ("closure_pct",) if scen.is_fisheye else ("cv_pct",))}
    store = None
    if checkpoint is not None:
        store = SweepCheckpoint(checkpoint, meta={
            "op": op_name, "scenario": scen.name, "engine": "fused",
            "candidates": int(n), "chunk": int(chunk)})

    if use_grid and not use_golden:
        # every candidate at once: one ray each, its own step and limit
        final, _ = grid_sweep_tiled(
            op_name, np.tile(np.array([[1.0, 0.0]], np.float32), (n, 1)),
            np.full(n, np.pi / 2.0, np.float32), delta_s, step_limits, medium,
            box=box, device=device)
        out["closure_pct"][:] = (100.0 / (2.0 * np.pi)) * np.linalg.norm(
            _np(final) - [1.0, 0.0], axis=1)
        if store is not None:
            for ci in range(-(-n // chunk)):
                if not store.has_chunk(ci):
                    lo = ci * chunk
                    store.add_chunk(ci, {
                        "closure_pct": out["closure_pct"][lo:lo + chunk]})
        return out

    field = (grid_tables(medium) if use_grid
             else strat_tables(medium) if use_strat else scen.field)
    done_upto = 0
    for i, (ds, lim) in enumerate(zip(delta_s, step_limits)):
        if store is not None:
            ci = i // chunk
            if i % chunk == 0 and store.has_chunk(ci):
                saved = store.chunk(ci)
                m = len(next(iter(saved.values())))
                for k in out:
                    out[k][i:i + m] = saved[k]
                done_upto = i + m
            if i < done_upto:
                continue
        if use_golden:
            # a grid candidate runs its own step count, as grid_trace_tiled
            # runs it (sweep.py:261-266); the others the padded count
            f = golden_trace_final(
                pos0, fan, np.float32(ds), np.float32(scen.gamma),
                field=field, op=op_name,
                steps=int(lim) if use_grid else int(max_steps), box=box,
                device=device, with_stats=with_stats,
                step_limit=np.float32(lim))
        else:
            f = fused_trace_final(
                pos0, fan, np.float32(ds), field=field, op=op_name,
                steps=int(max_steps), box=box, device=device,
                step_limit=np.float32(lim), with_stats=with_stats)
        for k, v in candidate_metrics(scen, fan, nf, f).items():
            out[k][i] = v
        if store is not None and (i + 1) % chunk == 0:
            ci = i // chunk
            if not store.has_chunk(ci):
                lo = ci * chunk
                store.add_chunk(ci, {k: out[k][lo:i + 1] for k in out})
    if store is not None and n % chunk:
        ci = (n - 1) // chunk
        if not store.has_chunk(ci):
            lo = ci * chunk
            store.add_chunk(ci, {k: out[k][lo:] for k in out})
    return out


# -- the sweep itself -------------------------------------------------------
def _max_sizes(scen, delta_s, trace_divisors, n_turns):
    if scen.is_fisheye:
        return (n_turns * trace_divisors).astype(np.int64)
    return np.ceil(scen.s_max / delta_s).astype(np.int64) + 1


def run_candidates(op_name: str, scen: config.ScenarioConfig, medium,
                   delta_s: np.ndarray, step_limits: np.ndarray,
                   max_size: int, *, n_turns: int = config.N_TURNS,
                   dtype=torch.float32, chunk: int | None = None, mesh=None,
                   checkpoint: str | None = None, pos0=None, theta0=None,
                   device="cuda"):
    """The scenario's acceptance metric for every candidate, scan tier.

    Returns a dict of per-candidate arrays: interface -> mean_err/max_err
    (deg, from the history tail); fisheye -> closure_pct; vert/aniso ->
    cv_pct.  Every candidate steps ``max_size - 1`` times, frozen after its
    own step limit, so the padded history rows the oracles read are the
    JAX package's.  ``checkpoint`` names an .npz file: each finished chunk
    of candidates is persisted there, and a rerun resumes at the first
    unfinished chunk.  ``pos0``/``theta0`` override the scenario's fan.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    dt = _torch_dtype(dtype)
    np_dtype = np.dtype(str(dt).removeprefix("torch."))
    op = build_op(op_name, dt)
    gamma = float(np_dtype.type(scen.gamma))
    theta0 = torch.as_tensor(np.asarray(scen.theta0 if theta0 is None
                                        else theta0), dtype=dt, device=device)
    pos0 = torch.as_tensor(np.asarray(scen.pos0 if pos0 is None else pos0),
                           dtype=dt, device=device)
    st0 = initial_state(pos0, theta0, medium, gamma,
                        with_window=op.uses_window,
                        with_momentum_stats=scen.is_vert,
                        max_size=int(max_size))

    def one(ds, lim):
        res = run_steps(op, st0, medium, gamma, float(np_dtype.type(ds)),
                        max_size=int(max_size), step_limit=int(lim),
                        box=tuple(scen.box), history=scen.is_interface)
        if scen.is_interface:
            errs = oracles.snell_errors_deg(res, theta0)
            return {"mean_err": float(errs.mean()), "max_err": float(errs.max())}
        if scen.is_fisheye:
            # the reference reads the last buffer row (RT_bench.py:956);
            # the final carry is that row since fisheye rays never exit
            return {"closure_pct": float(oracles.closure_error_pct(res)[0])}
        cv = oracles.momentum_cv_pct_from_stats(res)
        return {"cv_pct": float(oracles.scenario_average_cv_pct(cv))}

    n = len(delta_s)
    if chunk is None:
        chunk = n if not scen.is_interface else 16
    store = None
    if checkpoint is not None:
        from raytracing_tpu_torch.utils.checkpoint import SweepCheckpoint
        store = SweepCheckpoint(checkpoint, meta={
            "op": op_name, "scenario": scen.name, "dtype": np_dtype.name,
            "candidates": int(n), "chunk": int(chunk)})

    outs = []
    for ci, lo in enumerate(range(0, n, chunk)):
        if store is not None and store.has_chunk(ci):
            outs.append(store.chunk(ci))
            continue
        rows = [one(d, lim) for d, lim in zip(delta_s[lo:lo + chunk],
                                              step_limits[lo:lo + chunk])]
        out = {k: np.array([r[k] for r in rows], np_dtype) for k in rows[0]}
        if store is not None:
            store.add_chunk(ci, out)
        outs.append(out)
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def fused_sweep_supported(op_name: str, scen: config.ScenarioConfig,
                          medium) -> bool:
    """True when the kernel sweep covers this configuration."""
    from raytracing_tpu_torch.engine.fast import GRID_MEDIA, STRAT_MEDIA
    from raytracing_tpu_torch.kernels.fused import FUSED_FIELDS, FUSED_OPS
    from raytracing_tpu_torch.kernels.golden import GOLDEN_OPS
    from raytracing_tpu_torch.media.medium import AnalyticMedium

    if op_name not in FUSED_OPS and op_name not in GOLDEN_OPS:
        return False
    if isinstance(medium, STRAT_MEDIA):
        return not scen.is_fisheye
    if isinstance(medium, GRID_MEDIA):
        # 2-D grid sweeps cover the fisheye only
        return scen.is_fisheye
    # the kernel sweep inlines the SCENARIO's field; an analytic medium with
    # a different field must go through the scan tier, which honors it
    return (isinstance(medium, AnalyticMedium)
            and medium.field == scen.field
            and scen.field in FUSED_FIELDS)


def delta_s_search(op_name: str, scen: config.ScenarioConfig, medium, *,
                   n_turns: int = config.N_TURNS, dtype=torch.float32,
                   chunk: int | None = None, mesh=None,
                   checkpoint: str | None = None, engine: str = "auto",
                   divisors: np.ndarray | None = None,
                   device="cuda") -> SweepResult:
    """Full DELTA_S search: sweep + acceptance + selection.

    Mirrors the reference flow RT_bench.py:1296-1406, returning the selected
    step instead of mutating globals.  ``index`` is None when no candidate
    passes (the reference sys.exit()s, RT_bench.py:1404-1406; the caller
    decides here).

    ``engine``: "scan" runs every candidate through the scan tier, "fused"
    through the kernels (:func:`run_candidates_fused`; a supported op and
    medium only), "auto" the kernels when ``device`` is a CUDA device, the
    dtype float32 and the configuration supported, else the scan tier (as
    the JAX package stays on the scan tier on its CPU backend).  On the
    CPU the "fused" engine runs the kernels' plain versions.

    ``divisors`` overrides the reference candidate grid, descending, in that
    grid's units (fisheye: circle segments; otherwise SIGMA divisors).
    The kernel tier launches the scenario's own fan (:func:`sweep_fan`).
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    op_c = canonical(op_name)
    dt = _torch_dtype(dtype)
    if engine == "auto":
        engine = ("fused" if (torch.device(device).type == "cuda"
                              and dt == torch.float32
                              and fused_sweep_supported(op_c, scen, medium))
                  else "scan")
    if engine not in ("scan", "fused"):
        raise ValueError(f"engine must be scan/fused/auto, got {engine!r}")

    if divisors is None:
        divisors, delta_s, trace_divs = candidates(scen)
    else:
        divisors = np.asarray(divisors, np.float64)
        if scen.is_fisheye:
            delta_s, trace_divs = 2.0 * np.pi / divisors, divisors + 1
        else:
            delta_s, trace_divs = config.SIGMA / divisors, None
    sizes = _max_sizes(scen, delta_s, trace_divs, n_turns)
    max_size = int(sizes.max())
    if engine == "fused":
        if not fused_sweep_supported(op_c, scen, medium):
            raise ValueError(f"fused sweep does not cover {op_c!r} on "
                             f"{type(medium).__name__} ({scen.name})")
        from raytracing_tpu_torch.media.medium import AnalyticMedium
        metrics = run_candidates_fused(
            op_c, scen, delta_s, sizes - 1, max_size - 1,
            medium=None if isinstance(medium, AnalyticMedium) else medium,
            checkpoint=checkpoint, device=device)
    else:
        metrics = run_candidates(op_name, scen, medium, delta_s, sizes - 1,
                                 max_size, n_turns=n_turns, dtype=dt,
                                 chunk=chunk, checkpoint=checkpoint,
                                 device=device)

    if scen.is_interface:
        index = find_index_interface(metrics["mean_err"], metrics["max_err"])
    elif scen.is_fisheye:
        index = find_index_fisheye(metrics["closure_pct"])
    else:
        index = find_index_vert(metrics["cv_pct"])

    if index is None:
        divisor = ds_sel = None
    elif scen.is_fisheye:
        divisor = float(round(divisors[index]))           # RT_bench.py:1379
        ds_sel = 2.0 * math.pi / divisor
    else:
        divisor = float(round(divisors[index], 2))        # RT_bench.py:1383
        ds_sel = config.SIGMA / divisor

    return SweepResult(scenario=scen.name, op_name=op_name,
                       divisors=divisors, delta_s=delta_s, metrics=metrics,
                       index=index, divisor=divisor, delta_s_selected=ds_sel,
                       engine=engine)


def delta_s_search_convergence(op_name: str, medium, *, pos0, theta0,
                               arc_length: float, box, gamma: float = 1.0,
                               candidates: np.ndarray | None = None,
                               tol: float = 1e-4,
                               device="cuda") -> SweepResult:
    """DELTA_S search for user-measured media by Richardson
    self-convergence (sweep.py:528).

    A measured medium has no closed-form truth, so a candidate step passes
    when HALVING it moves no final position by more than ``tol`` over the
    same ``arc_length``.  Candidates are step sizes, descending (coarse ->
    fine, the reference's sweep order); the first passing one is selected.
    Default grid: arc_length / {50, 100, ..., 6400}.  Every trace runs
    through the port's ``fast_trace`` on ``device``.  Returns a SweepResult
    whose ``metrics['halving_err']`` holds the per-candidate displacement
    and ``divisors`` the step counts.
    """
    from raytracing_tpu_torch.engine.fast import fast_trace

    op_c = canonical(op_name)
    if not (np.isfinite(arc_length) and arc_length > 0):
        raise ValueError(f"arc_length must be finite and > 0, "
                         f"got {arc_length}")
    scen = dataclasses.replace(config.scenario("fisheye"), name="samples",
                               gamma=float(gamma),
                               box=tuple(float(v) for v in box))
    if candidates is None:
        counts = 50 * 2 ** np.arange(8)
        candidates = arc_length / counts
    candidates = np.asarray(candidates, np.float64)
    if np.any(np.diff(candidates) >= 0):
        raise ValueError("candidates must descend (coarse -> fine)")
    pos0 = np.asarray(pos0, np.float32)
    theta0 = np.asarray(theta0, np.float32)

    def final_pos(ds: float, steps: int) -> np.ndarray:
        out = fast_trace(op_c, scen, medium, delta_s=np.float32(ds),
                         steps=int(steps), pos0=pos0, theta0=theta0,
                         device=device)
        return _np(out.pos)

    return _richardson_search(final_pos, candidates, arc_length, tol,
                              scenario="samples", op_name=op_c,
                              dtype=np.float32)


def _richardson_search(final_pos, candidates, arc_length, tol, *,
                       scenario: str, op_name: str, dtype) -> SweepResult:
    """Coarse->fine halving loop of the convergence search (sweep.py:587).

    On a halving grid, candidate i's half-step trace IS candidate i+1's
    full-step trace — reuse it and trace only the twin.  The step count must
    match too: rounding can break the identity when arc/ds is not an
    integer.
    """
    errs = []
    index = None
    memo = (None, None, None)   # (dtype ds, steps, pos) of the last half run
    for i, ds in enumerate(candidates):
        steps = max(1, round(arc_length / float(ds)))
        dsf = np.dtype(dtype).type(ds)
        a = (memo[2] if memo[0] == dsf and memo[1] == steps
             else final_pos(float(ds), steps))
        b = final_pos(float(ds) / 2.0, 2 * steps)
        memo = (np.dtype(dtype).type(float(ds) / 2.0), 2 * steps, b)
        errs.append(float(np.linalg.norm(a - b, axis=-1).max()))
        if errs[-1] < tol:
            index = i
            break
    errs += [np.nan] * (len(candidates) - len(errs))

    steps_grid = np.array([max(1, round(arc_length / d))
                           for d in candidates], np.float64)
    return SweepResult(
        scenario=scenario, op_name=op_name, divisors=steps_grid,
        delta_s=candidates, metrics={"halving_err": np.asarray(errs)},
        index=index,
        divisor=float(steps_grid[index]) if index is not None else None,
        delta_s_selected=(float(candidates[index]) if index is not None
                          else None))


def delta_s_search_convergence3(method: str, medium, *, pos0, dir0,
                                arc_length: float, box=None,
                                candidates: np.ndarray | None = None,
                                tol: float = 1e-4, dtype=np.float32,
                                device="cuda") -> SweepResult:
    """Richardson step calibration for the 3-D tier (sweep.py:624).

    The 3-D twin of :func:`delta_s_search_convergence`: a candidate step
    passes when halving it moves no final position by more than ``tol``
    over ``arc_length``.  3-D media have no reference oracle table, so
    self-convergence is the calibration.  Every trace runs through the
    port's ``trace3d`` in metrics mode on ``device`` at ``dtype``; the
    half-step trace of each candidate is reused as the next candidate's
    full-step trace on the default halving grid.
    """
    from raytracing_tpu_torch.engine.trace3d import canonical3, trace3d

    method = canonical3(method)
    if not (np.isfinite(arc_length) and arc_length > 0):
        raise ValueError(f"arc_length must be finite and > 0, "
                         f"got {arc_length}")
    if candidates is None:
        candidates = arc_length / (50 * 2 ** np.arange(8))
    candidates = np.asarray(candidates, np.float64)
    if np.any(np.diff(candidates) >= 0):
        raise ValueError("candidates must descend (coarse -> fine)")
    dtype = np.dtype(dtype)
    pos0 = np.asarray(pos0, dtype)
    dir0 = np.asarray(dir0, dtype)

    def final_pos(ds: float, steps: int) -> np.ndarray:
        out = trace3d(method, medium, pos0=pos0, dir0=dir0, delta_s=ds,
                      steps=int(steps), box=box, mode="metrics",
                      dtype=dtype, device=device)
        return _np(out.final.pos)

    return _richardson_search(final_pos, candidates, arc_length, tol,
                              scenario="custom3d", op_name=method,
                              dtype=dtype)
