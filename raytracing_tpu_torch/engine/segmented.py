"""The 2-D grid path: per-cell tables and one kernel launch over them.

Port of ``raytracing_tpu/engine/segmented.py``: ``_cells`` (segmented.py:432),
``_cells36`` (:449) and ``grid_trace_tiled`` (:1129), for the fused and the
golden family (:749-760).

On the TPU, ``grid_trace_tiled`` Morton-sorts the rays into blocks that
share a VMEM window of the per-cell table, checks containment with a flag
and replays a round with a larger window when a block escapes it: machinery
that exists because ``tpu.dynamic_gather`` spans one 128-lane vreg.  On the
card every ray reads its own cell's row of the whole table in global memory
(``Grid`` in csrc/media.cuh), so none of it is ported (ROADMAP.md "Not to
port"): no window, sort, containment flag or replay ladder; no
``segment``, ``block_rays``, ``tile_shape``, ``refreshes_per_round``,
``row_windows``, ``oriented``, ``pack``, ``mesh`` or ``interpret``; no
``RuntimeError`` for a dispersed batch.  A trace is one launch of the
``fused_step_grid`` or ``golden_step_grid`` kernel, for any grid of at least
2x2 nodes.  The segmented driver (``segmented_trace``, :165) is not ported
yet (ROADMAP.md §2 item 6).
"""
from __future__ import annotations

import torch

from raytracing_tpu_torch.kernels.fused import (
    FUSED_OPS, FusedFinal, GridTables, fused_trace_final)
from raytracing_tpu_torch.kernels.golden import (
    GOLDEN_OPS, golden_schedule, golden_trace_final)
from raytracing_tpu_torch.media.c1 import C1GridMedium
from raytracing_tpu_torch.media.hermite import HermiteGridMedium


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


def grid_tables(medium) -> GridTables:
    """The kernels' :class:`GridTables` of a Hermite or C1 grid medium, built
    on the medium's device from its node table (nothing is uploaded)."""
    node_ch = int(medium.nodes.shape[-1])
    nodes3d = medium.nodes.float().reshape(medium.ny, medium.nx, node_ch)
    return GridTables(table=_cells36(nodes3d), cell_ch=4 * node_ch,
                      x0=float(medium.x0), y0=float(medium.y0),
                      inv_hx=float(medium.inv_hx),
                      inv_hy=float(medium.inv_hy), nx=int(medium.nx),
                      ny=int(medium.ny))


def grid_trace_tiled(op: str, pos0, theta0, delta_s, medium, *, steps: int,
                     box, device, with_stats: bool = False,
                     gamma: float = 1.0,
                     gold_schedule: tuple | None = None) -> FusedFinal:
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
    """
    if not isinstance(medium, (HermiteGridMedium, C1GridMedium)):
        raise ValueError("grid_trace_tiled needs a HermiteGridMedium or "
                         f"C1GridMedium, got {type(medium).__name__}")
    golden = op in GOLDEN_OPS
    if not golden and op not in FUSED_OPS:
        raise ValueError(f"grid_trace_tiled supports {FUSED_OPS} and "
                         f"{tuple(GOLDEN_OPS)}, got {op!r}")
    if medium.nx < 2 or medium.ny < 2:
        raise ValueError(f"a grid needs at least 2x2 nodes, got "
                         f"{medium.ny}x{medium.nx}")
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
