"""The kernel tier for sampled 3-D (tri-Hermite grid3) media, GPU form.

Port of ``raytracing_tpu/engine/tiled3.py``: ``_cells64`` (tiled3.py:102),
the checks of ``_prep_tiled3`` (:307), ``grid3_trace_tiled`` (:346) and its
dynamic twin ``grid3_trace_dynamic_tiled`` (:513).  Every ray reads its own
cell's 64-float row of the whole per-cell table, in the
``fused3d_step_grid`` kernel (``kernels/fused3d.py``) or, with the patch's
Hessian and the two launch tangents, the ``dynamic3d_step_grid`` kernel
(``kernels/dynamic3d.py``), as the 2-D grid kernels do, so a trace is one
launch and the result is in the caller's ray order.

Not ported, on purpose (ROADMAP.md §1, "Not to port"): the Morton sort
(``_morton_key3``, ``_sort_perm3``), the drift-placed block windows and
their refresh (``_window_bases3``, ``_refresh_windows3``, ``_window_ids3``),
the exact excess flag and the replay ladder (``_drive_tiled3``), the window
classes and the segment length (``_SWEEP_TILES3``, ``_default_segment3``)
and the sharded round (``_tiled3_segments_sharded``): they keep a block's
cells in a TPU core's VMEM.  So are the arguments that steer them,
``segment``, ``tile_shape``, ``refreshes_per_round``,
``sort`` and ``interpret``; no batch is too dispersed, and nothing raises
JAX's ``RuntimeError`` for one.  ``mesh=`` shards the rays over a
``torch.distributed`` mesh (``parallel/mesh.py``): each rank builds the
per-cell table once on its device and launches on its rows, and the fields
come back as DTensors of the whole batch; ``block_rays`` is kept only as
the granule of JAX's divisibility check (tiled3.py:330).
"""
from __future__ import annotations

import torch

from raytracing_tpu_torch.engine.trace3d import canonical3
from raytracing_tpu_torch.kernels.dynamic3d import (
    Dyn3Final, dynamic3d_step, final_from_dyn3_state, initial_dyn3_state)
from raytracing_tpu_torch.kernels.fused3d import (
    FUSED3_OPS, Fused3Final, Grid3Tables, final_from_state3,
    fused3d_step, initial_state3)
from raytracing_tpu_torch.media.grid3 import C1Grid3Medium

def cells64(nodes4d):
    """Per-cell packed node table: (nz, ny, nx, 8) -> (ncells, 64) rows.

    Every cell carries its own 8 corner nodes x 8 Hermite channels at flat
    index ``ch * 8 + corner`` with corner = dx + 2*dy + 4*dz; cell
    (ix, iy, iz) is row (iz*(ny-1) + iy)*(nx-1) + ix.
    """
    ch = nodes4d.shape[-1]
    corners = [nodes4d[dz:dz + nodes4d.shape[0] - 1,
                       dy:dy + nodes4d.shape[1] - 1,
                       dx:dx + nodes4d.shape[2] - 1]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(corners, dim=-1).reshape(-1, 8 * ch)


def grid3_tables(medium: C1Grid3Medium) -> Grid3Tables:
    """The kernel's layout of a grid3 medium, on the medium's device: the
    per-cell float32 rows of :func:`cells64` (built anew each call)."""
    nodes4d = medium.nodes.to(torch.float32).reshape(
        medium.nz, medium.ny, medium.nx, 8)
    return Grid3Tables(table=cells64(nodes4d).contiguous(),
                       x0=float(medium.x0), y0=float(medium.y0),
                       z0=float(medium.z0),
                       inv_hx=float(medium.inv_hx),
                       inv_hy=float(medium.inv_hy),
                       inv_hz=float(medium.inv_hz), nx=int(medium.nx),
                       ny=int(medium.ny), nz=int(medium.nz))


def _prep_tiled3(method, medium, *, box, fname):
    """The entry checks of tiled3.py:307-343 that the GPU form keeps: the
    method, the medium's class, the box; returns the canonical op."""
    op = canonical3(method)
    if op not in FUSED3_OPS:
        raise ValueError(f"{fname} supports {FUSED3_OPS}, got {op!r}")
    if not isinstance(medium, C1Grid3Medium):
        raise ValueError(f"{fname} needs a C1Grid3Medium "
                         f"(media/grid3.py), got {type(medium).__name__}")
    if len(box) != 6:
        raise ValueError(f"box must be 6 floats, got {box!r}")
    return op


def grid3_trace_tiled(method: str, pos0, dir0, delta_s, medium, *,
                      steps: int, box, device="cuda",
                      mesh=None, block_rays: int = 1024) -> Fused3Final:
    """Kernel-tier tracing through a sampled tri-Hermite 3-D medium
    (tiled3.py:346): one launch of ``fused3d_step_grid`` on ``device``.

    ``medium`` is a :class:`media.grid3.C1Grid3Medium` whose node table
    lies on ``device``; ``method`` one of the vector ops
    (engine/trace3d.METHODS3); ``box`` the 6 faces.  Returns a
    :class:`kernels.fused3d.Fused3Final` in the caller's ray order.
    ``mesh`` shards the rows (module docstring).
    """
    op = _prep_tiled3(method, medium, box=tuple(box),
                      fname="grid3_trace_tiled")
    if mesh is not None:
        from raytracing_tpu_torch.parallel.mesh import over_batch
        return over_batch(
            mesh, device, lambda p, d: grid3_trace_tiled(
                op, p, d, delta_s, medium, steps=steps, box=box,
                device=device),
            "grid3_trace_tiled", pos0, dir0, block_rays=block_rays)
    st = initial_state3(pos0, dir0, device=device)
    st = fused3d_step(st, field=grid3_tables(medium), op=op,
                      steps=int(steps), delta_s=delta_s,
                      step_limit=int(steps), offset=0.0, box=tuple(box))
    return final_from_state3(st)


def grid3_trace_dynamic_tiled(method: str, pos0, dir0, delta_s, medium, *,
                              steps: int, box, device="cuda",
                              mesh=None, block_rays: int = 1024) -> Dyn3Final:
    """Kernel-tier DYNAMIC tracing through a sampled tri-Hermite 3-D medium
    (tiled3.py:513): one launch of ``dynamic3d_step_grid`` on ``device``,
    both launch tangents with the exact Hessian of the same tricubic patch.

    Point-source launch (dpos = 0, du = the transverse frame of
    engine/dynamic3d._transverse_frame), so ``detq``, ``kmah`` and the
    focus locator match ``trace_dynamic3``'s metrics.  ``n`` at the exit
    point is the medium's own evaluation there (``n_and_grad3``, as JAX,
    :578).  Returns a :class:`kernels.dynamic3d.Dyn3Final` in the caller's
    ray order.  ``mesh`` shards the rows (module docstring).
    """
    op = _prep_tiled3(method, medium, box=tuple(box),
                      fname="grid3_trace_dynamic_tiled")
    if mesh is not None:
        from raytracing_tpu_torch.parallel.mesh import over_batch
        return over_batch(
            mesh, device, lambda p, d: grid3_trace_dynamic_tiled(
                op, p, d, delta_s, medium, steps=steps, box=box,
                device=device),
            "grid3_trace_dynamic_tiled", pos0, dir0, block_rays=block_rays)
    st = initial_dyn3_state(pos0, dir0, device=device)
    st = dynamic3d_step(st, field=grid3_tables(medium), op=op,
                        steps=int(steps), delta_s=delta_s,
                        step_limit=int(steps), offset=0.0, box=tuple(box))
    return final_from_dyn3_state(st, medium.n_and_grad3(st.x, st.y, st.z)[0])
