"""Data-parallel tracing: the ray batch sharded across a device mesh.

Port of ``raytracing_tpu/parallel/distributed.py``: ``ray_batch_sharding``
(distributed.py:23), ``trace_sharded`` (:28), ``ShardedSummary`` (:52) and
``summarize_sharded`` (:59).  The reference scales by submitting
whole-scenario replicas to worker processes (RT_bench.py:1521-1523); the
JAX package shards one batch over every device of a mesh and lets XLA keep
every per-ray computation local.  Here each rank of a ``torch.distributed``
mesh (``parallel/mesh.py``) runs the port's scan tier, ``engine/trace.py::
trace``, on its rows of the batch, and the per-ray results come back as
DTensors sharded over the flattened mesh; ``summarize_sharded`` all-reduces
three scalars, so no rank gathers the batch.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from raytracing_tpu_torch import config
from raytracing_tpu_torch.engine.trace import TraceResult, trace
from raytracing_tpu_torch.parallel import mesh as meshlib


def ray_batch_sharding(mesh) -> meshlib.Sharding:
    """A (R, ...) batch over every device of the mesh: one shard a rank, on
    the flattened mesh (one collective gathers it)."""
    from torch.distributed.tensor import Shard

    return meshlib.Sharding(meshlib.flat_mesh(mesh), (Shard(0),))


def trace_sharded(op_name: str, scen: config.ScenarioConfig, medium, *,
                  delta_s: float, mesh, pos0, theta0,
                  divisor: int | None = None,
                  n_turns: int = config.N_TURNS, mode: str = "metrics",
                  dtype=torch.float32, device="cuda") -> TraceResult:
    """Trace a ray batch sharded across ``mesh``.

    Every rank passes the whole ``pos0``/``theta0`` (or DTensors of them);
    the ray count must divide by the device count.  Each rank traces its
    rows with :func:`engine.trace.trace` on ``device``; every per-ray field
    of the result is a DTensor of the whole batch (the history's ray axis
    is its second), so :func:`summarize_sharded` reduces without gathering
    the batch and ``.full_tensor()`` gathers it.
    """
    meshlib.check_device(mesh, device)
    idx, n_dev = meshlib.flat_index(mesh)
    r = len(theta0)
    if r % n_dev:
        raise ValueError(f"ray count {r} not divisible by {n_dev} devices")
    lo, hi = idx * (r // n_dev), (idx + 1) * (r // n_dev)
    res = meshlib.agree(mesh, lambda: trace(
        op_name, scen, medium, delta_s=delta_s, device=device,
        divisor=divisor, n_turns=n_turns, mode=mode, dtype=dtype,
        pos0=meshlib.local_rows(pos0, lo, hi),
        theta0=meshlib.local_rows(theta0, lo, hi)), "trace_sharded")
    return meshlib.sharded_result(mesh, res, r,
                                  dims={"history": 1, "n_hist": 1})


class ShardedSummary(NamedTuple):
    mean_closure_pct: Any
    total_distance: Any
    rays: int


def summarize_sharded(result) -> ShardedSummary:
    """Batch metrics of a :func:`trace_sharded` result (or a
    ``fast_trace_sharded`` one) with no gather of the batch: each rank sums
    its closures (fisheye, against (1, 0)) and distances, one all-reduce
    adds the sums and counts across ranks, and ``mean_closure_pct`` is
    their quotient.  Every rank returns the same float64 scalars (0-d
    tensors on the rank's device), computed in float64 from the rows."""
    pos = result.final.pos if hasattr(result, "final") else result.pos
    mesh = pos.device_mesh
    local = pos.to_local().double()
    target = torch.tensor([1.0, 0.0], dtype=local.dtype, device=local.device)
    closure = (100.0 * torch.linalg.norm(local - target, dim=-1)
               / (2.0 * torch.pi))
    sums = torch.stack([closure.sum(),
                        result.dist_sim.to_local().double().sum(),
                        torch.tensor(float(local.shape[0]),
                                     dtype=torch.float64,
                                     device=local.device)])
    group = mesh.get_group()
    dev = meshlib.collective_device(group)
    sums_c = sums.to(dev)
    dist.all_reduce(sums_c, group=group)
    sums = sums_c.to(local.device)
    return ShardedSummary(mean_closure_pct=sums[0] / sums[2],
                          total_distance=sums[1], rays=int(pos.shape[0]))
