"""Segmented traces, and the 2-D grid path: one kernel launch over a grid.

Port of ``raytracing_tpu/engine/segmented.py``: ``_fingerprint``
(segmented.py:39), ``segmented_trace`` (:197) with ``_run_segments``
(:124) as a chain of kernel launches, ``_cells`` (:432), ``_cells36``
(:449), ``grid_sweep_tiled`` (:1011) with ``_tiled_sweep_segments`` (:933)
as one launch, ``grid_trace_tiled`` (:1129), for the fused and the golden
family (:749-760), and ``grid_trace`` (:1618) with ``_grid_run_segments``
(:1556) as one launch, and ``grid_trace_dynamic_tiled`` (:1776-1950, with
``_dyn_tiled_segments_inner`` :1666-1737) as one launch of the
``dynamic_step_grid`` kernel.

On the TPU, ``grid_trace_tiled`` Morton-sorts the rays into blocks that
share a VMEM window of the per-cell table, checks containment with a flag
and replays a round with a larger window when a block escapes it: machinery
that exists because ``tpu.dynamic_gather`` spans one 128-lane vreg.  On the
card every ray reads its own cell's row of the whole table in global memory
(``Grid`` in csrc/media.cuh), so none of it is ported (ROADMAP.md "Not to
port"): no window, sort, containment flag or replay ladder; no
``segment``, ``tile_shape``, ``refreshes_per_round``,
``row_windows``, ``oriented``, ``pack`` or ``interpret``; no
``RuntimeError`` for a dispersed batch.  A trace is one launch of the
``fused_step_grid`` or ``golden_step_grid`` kernel, for any grid of at least
2x2 nodes; ``mesh=`` shards the rays over a ``torch.distributed`` mesh, one
launch a rank on its rows, and keeps ``block_rays`` only as the granule of
JAX's divisibility check.  The same holds for the candidate sweep (one launch of
``fused_sweep_grid``, one ray a candidate, no window classes, so no
candidate ever falls back), for the supercell path, ``grid_trace`` (one
launch of ``fused_step_nodes`` on the node table, no per-ray node blocks),
and for the dynamic grid path, ``grid_trace_dynamic_tiled`` (one launch of
``dynamic_step_grid`` on the same per-cell table).

``segmented_trace`` keeps its segments, because they carry live-ray
compaction and checkpoints: each segment is one launch of the fused or
golden step kernel in its resume form, with the global step offset.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from raytracing_tpu_torch.kernels import dynamic as kd
from raytracing_tpu_torch.kernels import fused as kfu
from raytracing_tpu_torch.kernels import golden as kg
from raytracing_tpu_torch.kernels.fused import (
    FUSED_OPS, FusedFinal, GridTables, NodeTables, fused_trace_final)
from raytracing_tpu_torch.kernels.golden import (
    GOLDEN_OPS, golden_schedule, golden_trace_final)
from raytracing_tpu_torch.media.c1 import C1GridMedium, C1StratifiedMedium
from raytracing_tpu_torch.media.hermite import HermiteGridMedium
from raytracing_tpu_torch.media.spline import StratifiedGridMedium
from raytracing_tpu_torch.utils.checkpoint import TraceCheckpoint


def _fingerprint(*arrays) -> str:
    """sha1 over dtype/shape/bytes of each array (segmented.py:39):
    checkpoint identity of medium tables and launch fans."""
    h = hashlib.sha1()
    for a in arrays:
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def segmented_trace(op: str, pos0, theta0, delta_s, *, steps: int, box,
                    field: str | None = None, medium=None, segment: int = 256,
                    with_stats: bool = False, compact: bool = False,
                    compact_every: int = 4,
                    compact_threshold: float = 0.75,
                    skip_frozen: bool = False,
                    gamma: float = 1.0,
                    checkpoint: str | None = None,
                    checkpoint_every: int = 64,
                    gold_schedule: tuple | None = None,
                    device="cuda") -> FusedFinal:
    """A fused or golden trace as a chain of ``segment``-step launches.

    Each segment is one launch of ``fused_step`` / ``fused_step_strat`` or
    ``golden_step`` / ``golden_step_strat`` with the global step offset, so
    the chain equals one launch of ``steps`` steps bit for bit.  ``field``
    names an analytic field; ``medium`` (a parity or C1 stratified medium,
    held on ``device``) replaces it with its tables.

    ``compact=True`` checks the live fraction every ``compact_every``
    segments and, when it drops below ``compact_threshold``, banks the
    frozen rays' final states and continues on the live rays only; the
    banked states are scattered back at the end.  No padding: the kernels
    mask the ragged edge.  Results are those of one launch.

    ``skip_frozen`` is accepted and changes nothing: on the card a thread
    already leaves its step loop once its ray freezes (csrc/fused.cu), the
    work the TPU kernel's per-block liveness table saved.

    ``gold_schedule=(iters, polish)`` overrides the golden schedule
    (``golden_schedule``).  The golden resume state carries the tangent, so
    every schedule chains bit-identically to one launch (the TPU kernels
    re-derive it from the angle at each segment start and agree with their
    one-shot run only under the bracket schedule ``(16, 0)``).

    ``checkpoint=`` saves the full resume state every ``checkpoint_every``
    segments (``utils.checkpoint.TraceCheckpoint``, with the identity
    fields and horizon guards of segmented.py:290-325); a rerun with the
    same arguments resumes from the last save bit-identically.  A port
    checkpoint holds the port's resume planes (named in its manifest) and
    is not exchangeable with one of the JAX package.  Incompatible with
    ``compact``.
    """
    golden = op in GOLDEN_OPS
    if not golden and op not in FUSED_OPS:
        raise ValueError(f"segmented trace supports ops {FUSED_OPS} and "
                         f"{tuple(GOLDEN_OPS)}, got {op!r}")
    if segment < 1 or compact_every < 1 or checkpoint_every < 1:
        # a zero cadence would make the host loop spin without progress
        raise ValueError("segment, compact_every and checkpoint_every must "
                         f"be >= 1, got {segment}/{compact_every}/"
                         f"{checkpoint_every}")
    use_strat = isinstance(medium, (StratifiedGridMedium, C1StratifiedMedium))
    if not use_strat and field is None:
        raise ValueError("pass field= (analytic) or medium= (stratified)")
    tables = kfu.strat_tables(medium) if use_strat else field
    pos0 = np.asarray(pos0, np.float32)
    theta0 = np.asarray(theta0, np.float32)
    box = tuple(float(v) for v in box)
    if golden:
        iters, polish = gold_schedule or golden_schedule()
        st = kg.initial_state(op, pos0, theta0, gamma, field=tables,
                              with_stats=with_stats, device=device)
    else:
        st = kfu.initial_state(op, pos0, theta0, field=tables,
                               with_stats=with_stats, device=device)
    names = [k for k, v in st._asdict().items() if v is not None]

    def run(state, offset):
        if golden:
            scal = kg.golden_scalars(delta_s, gamma, steps, offset, iters,
                                     device=state.x.device)
            return kg.golden_step(state, scal, field=tables, op=op,
                                  steps=segment, box=box, gold_iters=iters,
                                  polish=polish)
        return kfu.fused_step(state, field=tables, op=op, steps=segment,
                              delta_s=delta_s, step_limit=steps,
                              offset=offset, box=box)

    n_seg_total = -(-steps // segment)
    done_segs = 0
    store = None
    if checkpoint is not None:
        if compact:
            raise ValueError("checkpoint does not compose with compact "
                             "(banked-ray side state is not captured)")
        # identity: everything that must match for the saved state to
        # continue the same trace (segmented.py:290-305); `steps` is
        # progress, not identity; `skip_frozen` is left out, since it
        # cannot change the state here
        store = TraceCheckpoint(checkpoint, meta={
            "op": op, "rays": int(len(theta0)), "delta_s": float(delta_s),
            "segment": int(segment), "state": names,
            "field": field or "stratified", "gamma": float(gamma),
            "box": list(box),
            "medium_sha1": (_fingerprint(tables.table, np.array(
                [tables.y0, tables.inv_hy, tables.ny, tables.ch]))
                if use_strat else None),
            "launch_sha1": _fingerprint(pos0, theta0),
            "gold_schedule": list(gold_schedule) if gold_schedule else None})
        resumed = store.load()
        if resumed is not None:
            arrays, done_steps0, horizon0 = resumed
            if done_steps0 > horizon0:
                # the saved final segment was limit-clamped at horizon0
                if steps != horizon0:
                    raise ValueError(
                        f"checkpoint {checkpoint} holds a COMPLETED "
                        f"{horizon0}-step trace; it cannot resume with "
                        f"steps={steps} — re-trace from scratch")
            elif steps < done_steps0:
                raise ValueError(
                    f"checkpoint {checkpoint} has already integrated "
                    f"{done_steps0} steps; it cannot resume with the "
                    f"shorter horizon steps={steps}")
            st = st._replace(**{k: torch.as_tensor(a, device=st.x.device)
                                for k, a in zip(names, arrays)})
            done_segs = done_steps0 // segment

    orig_idx = torch.arange(len(theta0), device=st.x.device)
    banked = None
    while done_segs < n_seg_total:
        if compact:
            n_run = min(compact_every, n_seg_total - done_segs)
        elif store is not None:
            n_run = min(checkpoint_every, n_seg_total - done_segs)
        else:
            n_run = n_seg_total - done_segs
        for k in range(n_run):
            st = run(st, float((done_segs + k) * segment))
        done_segs += n_run
        if store is not None:
            store.save([getattr(st, k).cpu().numpy() for k in names],
                       done_segs * segment, steps)
        if not compact or done_segs >= n_seg_total:
            continue
        frozen = ~st.active
        if float((~frozen).float().mean()) >= compact_threshold \
                or not bool(frozen.any()):
            continue
        if banked is None:
            banked = st
        # bank the frozen rays' final states under their original slots
        banked = banked._replace(**{
            k: getattr(banked, k).index_copy(0, orig_idx[frozen],
                                             getattr(st, k)[frozen])
            for k in names})
        alive = ~frozen
        orig_idx = orig_idx[alive]
        st = st._replace(**{k: getattr(st, k)[alive] for k in names})
        if orig_idx.numel() == 0:
            break

    if banked is not None and orig_idx.numel():
        st = banked._replace(**{
            k: getattr(banked, k).index_copy(0, orig_idx, getattr(st, k))
            for k in names})
    elif banked is not None:
        st = banked
    return kfu.final_from_state(st)


def _cells(x, y, g: GridTables):
    """Cell index (ix, iy) as floats and in-cell offsets (u, v): the float32
    path the kernels take (segmented.py:432 and fused.py:247-252)."""
    fx = torch.clamp((x - g.x0) * g.inv_hx, 0.0, float(g.nx - 1))
    fy = torch.clamp((y - g.y0) * g.inv_hy, 0.0, float(g.ny - 1))
    ix = torch.clamp(torch.floor(fx), max=float(g.nx - 2))
    iy = torch.clamp(torch.floor(fy), max=float(g.ny - 2))
    return ix, iy, fx - ix, fy - iy


def _cells36(nodes3d):
    """Per-CELL packed node table.

    (ny, nx, CH) nodes -> ((ny-1)*(nx-1), 4*CH) rows: every cell carries
    its own 4 corner nodes x CH channels at channel index ``ch * 4 +
    corner`` with corners (00, +x, +y, +xy).  CH = 9 for the parity
    Hermite form (36 floats a cell), 4 for the C1 form (16).
    """
    ch = nodes3d.shape[-1]
    return torch.stack(
        [nodes3d[:-1, :-1], nodes3d[:-1, 1:],
         nodes3d[1:, :-1], nodes3d[1:, 1:]],
        dim=-1).reshape(-1, 4 * ch).contiguous()


def _check_grid(name: str, medium, kinds) -> None:
    if not isinstance(medium, kinds):
        raise ValueError(f"{name} needs a "
                         f"{' or '.join(k.__name__ for k in kinds)}, got "
                         f"{type(medium).__name__}")
    if medium.nx < 2 or medium.ny < 2:
        raise ValueError(f"a grid needs at least 2x2 nodes, got "
                         f"{medium.ny}x{medium.nx}")


def grid_tables(medium, dtype=torch.float32) -> GridTables:
    """The kernels' :class:`GridTables` of a Hermite or C1 grid medium, built
    on the medium's device from its node table (nothing is uploaded); the
    kernels read float32, the dynamic scan tier's closed-form channels
    (engine/dynamic.py) the working ``dtype``."""
    node_ch = int(medium.nodes.shape[-1])
    nodes3d = medium.nodes.to(dtype).reshape(medium.ny, medium.nx, node_ch)
    return GridTables(table=_cells36(nodes3d), cell_ch=4 * node_ch,
                      x0=float(medium.x0), y0=float(medium.y0),
                      inv_hx=float(medium.inv_hx),
                      inv_hy=float(medium.inv_hy), nx=int(medium.nx),
                      ny=int(medium.ny))


def grid_trace_tiled(op: str, pos0, theta0, delta_s, medium, *, steps: int,
                     box, device="cuda", with_stats: bool = False,
                     gamma: float = 1.0,
                     gold_schedule: tuple | None = None, mesh=None,
                     block_rays: int = 1024) -> FusedFinal:
    """Trace through a 2-D sampled-spline medium in one kernel launch.

    ``medium`` is a :class:`HermiteGridMedium` (parity, 36 floats a cell)
    or a :class:`C1GridMedium` (16), held on ``device``.  Fused ops launch
    ``fused_step_grid``, golden and Newton ops ``golden_step_grid`` with the
    anisotropy ratio ``gamma`` and the schedule ``gold_schedule``
    ((iters, polish), default :func:`golden_schedule`).  Returns a
    :class:`FusedFinal` in the caller's ray order; a golden op's tangent is
    (cos, sin) of its final angle.

    The TPU tier's golden kernels re-derive the direction by exact cos/sin
    at each segment start, which gives their trajectories a ~1e-8-a-step
    sensitivity to the segment cadence (7e-6 over 606 coarse fisheye steps,
    segmented.py:1193-1197); one launch has no cadence, so golden results
    differ from the TPU tier's by that much.

    ``mesh`` (a ``DeviceMesh``, ``parallel/mesh.py``) shards the rows over
    every mesh axis: each rank builds the per-cell table once on its device
    and launches on its rows; the fields come back as DTensors of the whole
    batch.  The batch must divide by the device count times ``block_rays``
    (JAX's check, segmented.py:1258; the kernel has no block otherwise).
    """
    _check_grid("grid_trace_tiled", medium, (HermiteGridMedium, C1GridMedium))
    golden = op in GOLDEN_OPS
    if not golden and op not in FUSED_OPS:
        raise ValueError(f"grid_trace_tiled supports {FUSED_OPS} and "
                         f"{tuple(GOLDEN_OPS)}, got {op!r}")
    if mesh is not None:
        from raytracing_tpu_torch.parallel.mesh import over_batch
        return over_batch(
            mesh, device, lambda p, t: grid_trace_tiled(
                op, p, t, delta_s, medium, steps=steps, box=box,
                device=device, with_stats=with_stats, gamma=gamma,
                gold_schedule=gold_schedule),
            "grid_trace_tiled", pos0, theta0, block_rays=block_rays)
    tables = grid_tables(medium)
    if not golden:
        return fused_trace_final(pos0, theta0, delta_s, field=tables, op=op,
                                 steps=steps, box=box, device=device,
                                 with_stats=with_stats)
    iters, polish = gold_schedule or golden_schedule()
    g = golden_trace_final(pos0, theta0, delta_s, gamma, field=tables, op=op,
                           steps=steps, box=box, device=device,
                           with_stats=with_stats, gold_iters=iters,
                           polish=polish)
    return FusedFinal(
        pos=g.pos, tangent=torch.stack([torch.cos(g.angle),
                                        torch.sin(g.angle)], dim=-1),
        traveltime=g.traveltime, dist_sim=g.dist_sim, active=g.active,
        mom_count=g.mom_count, mom_mean=g.mom_mean, mom_m2=g.mom_m2)


def grid_sweep_tiled(op: str, pos0, theta0, delta_s, step_limits, medium, *,
                     box, device="cuda"):
    """A whole DELTA_S candidate set on a 2-D grid medium, in one launch.

    ``pos0`` (n_cand, 2), ``theta0``, ``delta_s`` and ``step_limits``
    (n_cand,) are per-candidate launch values: candidate i is one ray
    stepping at ``delta_s[i]`` and frozen after ``step_limits[i]`` steps,
    through the ``fused_sweep_grid`` kernel (``medium``, a
    :class:`HermiteGridMedium` or :class:`C1GridMedium`, held on
    ``device``).  Returns ``(final_pos, fallback_idx)`` as the TPU tier
    does, ``final_pos`` an (n_cand, 2) float32 tensor; ``fallback_idx`` is
    always empty: without window classes no candidate is too coarse for
    the kernel.  Golden candidates run one at a time through
    :func:`grid_trace_tiled` instead.
    """
    _check_grid("grid_sweep_tiled", medium, (HermiteGridMedium, C1GridMedium))
    if op not in FUSED_OPS:
        raise ValueError(f"grid_sweep_tiled supports {FUSED_OPS} (golden "
                         "candidates run per-candidate through "
                         f"grid_trace_tiled), got {op!r}")
    limits = torch.as_tensor(np.asarray(step_limits, np.float32),
                             device=device)
    tables = grid_tables(medium)
    st = kfu.initial_state(op, pos0, theta0, field=tables, with_stats=False,
                           device=device)
    st = kfu.fused_sweep_grid(
        st, torch.as_tensor(np.asarray(delta_s, np.float32), device=device),
        limits, field=tables, op=op,
        steps=int(limits.max()) if len(limits) else 0, box=box)
    return torch.stack([st.x, st.y], dim=-1), []


def node_tables(medium: HermiteGridMedium) -> NodeTables:
    """The kernels' :class:`NodeTables` of a parity Hermite grid medium: its
    node table as float32, on the medium's device."""
    return NodeTables(table=medium.nodes.float().contiguous(),
                      x0=float(medium.x0), y0=float(medium.y0),
                      inv_hx=float(medium.inv_hx),
                      inv_hy=float(medium.inv_hy), nx=int(medium.nx),
                      ny=int(medium.ny))


def grid_trace(op: str, pos0, theta0, delta_s, medium, *, steps: int, box,
               device="cuda", with_stats: bool = False) -> FusedFinal:
    """Trace fused ops through a parity Hermite grid medium in one launch
    of the ``fused_step_nodes`` kernel, which reads each cell's corners
    straight from the node table (the TPU tier's supercell path,
    segmented.py:1618).  The same spline, corner values and blend as
    :func:`grid_trace_tiled`, so the two agree to the bit; with no per-ray
    node block there is no ``segment`` and no bound on the step size."""
    _check_grid("grid_trace", medium, (HermiteGridMedium,))
    if op not in FUSED_OPS:
        raise ValueError(f"grid_trace supports {FUSED_OPS}, got {op!r}")
    return fused_trace_final(pos0, theta0, delta_s, field=node_tables(medium),
                             op=op, steps=steps, box=box, device=device,
                             with_stats=with_stats)


def grid_trace_dynamic_tiled(op: str, pos0, theta0, delta_s, medium, *,
                             steps: int, box, device="cuda", mesh=None,
                             block_rays: int = 1024):
    """Dynamic trace through a 2-D sampled-spline medium in one launch of the
    ``dynamic_step_grid`` kernel: the kinematics, the paraxial tangent and
    the KMAH count on the per-cell table of :func:`grid_tables`, with the
    in-cell derivatives of the bilinear n and the full 2x2 Jacobian of the
    two gradient bicubics (parity, 36 floats a cell) or the patch's
    Hessian (C1, 16).

    ``medium`` is a :class:`HermiteGridMedium` or :class:`C1GridMedium`
    held on ``device``, of at least 2x2 nodes; ``op`` one of
    ``kernels.dynamic.DYN_FUSED_OPS``.  The launch state is JAX's 18-plane
    resume state from (pos0, theta0) (segmented.py:1844-1850).  Returns a
    ``DynFinal`` whose ``n`` is ``medium.n`` at the final positions
    (segmented.py:1945).  ``mesh`` shards the rows as in
    :func:`grid_trace_tiled` (JAX's check, segmented.py:1818).
    """
    if op not in kd.DYN_FUSED_OPS:
        raise ValueError(f"dynamic tiled kernel supports {kd.DYN_FUSED_OPS}, "
                         f"got {op!r}")
    _check_grid("grid_trace_dynamic_tiled", medium,
                (HermiteGridMedium, C1GridMedium))
    if mesh is not None:
        from raytracing_tpu_torch.parallel.mesh import over_batch
        return over_batch(
            mesh, device, lambda p, t: grid_trace_dynamic_tiled(
                op, p, t, delta_s, medium, steps=steps, box=box,
                device=device),
            "grid_trace_dynamic_tiled", pos0, theta0, block_rays=block_rays)
    st = kd.initial_dyn_state(pos0, theta0, device=device)
    st = kd.dynamic_step(st, field=grid_tables(medium), op=op, steps=steps,
                         delta_s=delta_s, step_limit=steps, offset=0.0,
                         box=box)
    return kd.final_from_dyn_state(st, medium.n(st.x, st.y))
