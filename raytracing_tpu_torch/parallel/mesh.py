"""Device meshes over ``torch.distributed``: the port of
``raytracing_tpu/parallel/mesh.py``.

The reference's only parallelism is OS-process fan-out with pickled spline
objects (RT_bench.py:1317-1318, 1521-1523).  The JAX package runs one
program over a ``jax.sharding.Mesh`` with two logical axes:

* ``"sweep"`` — DELTA_S candidates (the executor.map axis, RT_bench.py:1318)
* ``"rays"``  — the ray batch (data parallelism)

and an optional leading ``"slice"`` axis.  PyTorch's counterpart is one
process per device (SPMD): a :class:`~torch.distributed.device_mesh.
DeviceMesh` with the same dim names replaces the ``Mesh``, and DTensor
placements (``Shard``, ``Replicate``) replace ``NamedSharding`` /
``PartitionSpec``.  Rays are independent, so no collective runs inside a
trace: each rank traces its own rows with the launches the unsharded call
makes, and only results cross ranks — per-ray results as DTensors sharded
over the flattened mesh (:func:`sharded`), what every rank needs whole
(metrics, crossings, scalars) gathered or all-reduced.

Collectives take the process group's own device: NCCL's on the card, the
host's for gloo.  Gloo runs only some collectives on CUDA tensors, so a
gloo group's tensors are staged through the host, explicitly
(:func:`collective_device`); NCCL never takes that route.

A rank's device is ``cuda:LOCAL_RANK`` (modulo the cards it sees, so two
gloo ranks may share one card) or ``"cpu"``.  ``make_mesh`` joins the
process group that is there, makes one from ``torchrun``'s environment, or
else makes a one-rank group of its own (a ``HashStore``, no TCP port), so a
plain script works as JAX's ``make_mesh()`` does.  A mesh spans every rank:
``n_devices`` must equal the world size (JAX takes the first n devices).
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

SWEEP_AXIS = "sweep"
RAYS_AXIS = "rays"
SLICE_AXIS = "slice"


class Sharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dim: the port's
    ``NamedSharding``; ``distribute_tensor(x, *sharding)`` lays ``x`` out."""

    mesh: Any
    placements: tuple


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` modulo the visible cards, or
    the CPU.  A CUDA request without a card raises; it never falls back."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asks for a CUDA device and "
                           "none is visible; pass device='cpu' for a CPU mesh")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _join_world(device_type: str) -> None:
    """Join the process group that is there, or make one: from torchrun's
    environment, else a one-rank group through a store of its own."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(n_devices: int | None = None, sweep: int | None = None,
              slices: int | None = None, *, device="cuda"):
    """Build a (sweep, rays) ``DeviceMesh`` over every rank.

    ``sweep`` fixes the sweep-axis extent; by default the largest divisor of
    the device count not exceeding its square root, so both axes get devices
    (4 ranks give 2 x 2, 8 give 2 x 4).  ``slices`` adds a leading
    ``"slice"`` axis: work sharded over it should be embarrassingly parallel
    (disjoint candidate chunks).  ``n_devices``, when given, must equal the
    world size.  ``device`` is ``"cuda"`` (NCCL by default) or ``"cpu"``
    (gloo); this rank's card is selected first.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = torch.device(device).type
    rank_device(device)
    _join_world(dev_type)
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"n_devices={n_devices} must equal the world size "
                         f"{n}: a mesh spans every rank (start that many "
                         "processes, e.g. torchrun --nproc-per-node)")
    if slices:
        if n % slices:
            raise ValueError(f"slices={slices} does not divide device count "
                             f"{n}")
        n //= slices
    if sweep is None:
        sweep = max(d for d in range(1, math.isqrt(n) + 1) if n % d == 0)
    if n % sweep:
        raise ValueError(f"sweep={sweep} does not divide device count {n}")
    if slices:
        return init_device_mesh(dev_type, (slices, sweep, n // sweep),
                                mesh_dim_names=(SLICE_AXIS, SWEEP_AXIS,
                                                RAYS_AXIS))
    return init_device_mesh(dev_type, (sweep, n // sweep),
                            mesh_dim_names=(SWEEP_AXIS, RAYS_AXIS))


def _placements(mesh, spec: dict) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(spec[name]) if name in spec else Replicate()
                 for name in mesh.mesh_dim_names)


def sweep_sharding(mesh) -> Sharding:
    """Per-candidate arrays: the leading axis over the sweep axis."""
    return Sharding(mesh, _placements(mesh, {SWEEP_AXIS: 0}))


def candidate_ray_sharding(mesh) -> Sharding:
    """(candidate, ray, ...) arrays over both mesh axes."""
    return Sharding(mesh, _placements(mesh, {SWEEP_AXIS: 0, RAYS_AXIS: 1}))


def ray_sharding(mesh) -> Sharding:
    """(ray, ...) batches over the rays axis (replicated on sweep)."""
    return Sharding(mesh, _placements(mesh, {RAYS_AXIS: 0}))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, _placements(mesh, {}))


# -- the rank's rows and the results' layout --------------------------------
def flat_mesh(mesh):
    """The 1-D mesh over the same ranks in the mesh's row-major order: a
    batch sharded over every axis is one shard a rank, and one collective
    gathers it (a multi-dim placement would gather once a dim).  Made once
    a mesh, and kept on it."""
    if mesh.ndim == 1:
        return mesh
    flat = getattr(mesh, "_rays_flat", None)
    if flat is None:
        from torch.distributed.device_mesh import DeviceMesh

        flat = DeviceMesh(mesh.device_type, mesh.mesh.flatten().tolist(),
                          mesh_dim_names=("flat",))
        mesh._rays_flat = flat
    return flat


def flat_index(mesh) -> tuple[int, int]:
    """(this rank's index, rank count) in the mesh's row-major order."""
    ranks = mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank()), len(ranks)


def axis_index(mesh, name: str) -> tuple[int, int]:
    """(this rank's coordinate, extent) along the mesh axis ``name``."""
    dim = mesh.mesh_dim_names.index(name)
    return int(mesh.get_coordinate()[dim]), int(mesh.mesh.shape[dim])


def check_device(mesh, device) -> None:
    """A mesh's device type and the traces' device must agree: a DTensor
    would otherwise move every shard to the mesh's device behind the
    caller's back."""
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device!r} is not on the mesh's device "
                         f"type {mesh.device_type!r}")


def batch_rows(mesh, r: int, block_rays: int = 1) -> tuple[int, int]:
    """[lo, hi) of this rank's rows of an ``r``-row batch split over every
    mesh axis; ``r`` must divide by the device count times ``block_rays``
    (JAX's kernel block), with JAX's message."""
    idx, n_dev = flat_index(mesh)
    if r % (n_dev * block_rays):
        raise ValueError(f"ray count {r} must divide by devices*block "
                         f"({n_dev}*{block_rays})")
    m = r // n_dev
    return idx * m, (idx + 1) * m


def over_batch(mesh, device, fn: Callable, what: str, *batch,
               block_rays: int = 1):
    """``fn`` on this rank's rows of ``batch`` (arrays of the same length,
    given whole on every rank), its NamedTuple result made DTensors of the
    whole batch (:func:`sharded_result`).  A failure on one rank fails the
    call on every rank."""
    check_device(mesh, device)
    r = len(batch[0])
    lo, hi = batch_rows(mesh, r, block_rays)
    out = agree(mesh, lambda: fn(*(local_rows(b, lo, hi) for b in batch)),
                what)
    return sharded_result(mesh, out, r)


def local_rows(x, lo: int, hi: int):
    """Rows [lo, hi) of a batch given whole on every rank (a DTensor is
    gathered first)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x[lo:hi]


def sharded(mesh, local, n: int, dim: int = 0):
    """``local`` (this rank's rows along ``dim``) as a DTensor of ``n`` rows
    sharded over the flattened mesh; None stays None.  No collective."""
    from torch.distributed.tensor import DTensor, Shard

    if local is None:
        return None
    shape = list(local.shape)
    shape[dim] = int(n)
    return DTensor.from_local(local.contiguous(), flat_mesh(mesh),
                              [Shard(dim)], run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def sharded_result(mesh, result, n: int, dims: dict | None = None):
    """A NamedTuple of per-ray tensors with each tensor field made a DTensor
    of ``n`` rows (:func:`sharded`); ``dims`` names fields whose ray axis is
    not the first.  Nested NamedTuples are walked; other fields stay."""
    dims = dims or {}
    out = {}
    for name, v in result._asdict().items():
        if torch.is_tensor(v):
            out[name] = sharded(mesh, v, n, dims.get(name, 0))
        elif isinstance(v, tuple) and hasattr(v, "_asdict"):
            out[name] = sharded_result(mesh, v, n, dims)
        else:
            out[name] = v
    return type(result)(**out)


# -- collectives ------------------------------------------------------------
def collective_device(group=None) -> torch.device:
    """Where a collective's tensors live: the card for NCCL, the host for
    gloo (its CUDA support is partial, so CUDA data is staged explicitly)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree(mesh, fn: Callable, what: str = "a sharded call"):
    """Run ``fn`` on this rank; if it raised on any rank of ``mesh``, raise
    on every rank (the failing rank its own error), so no rank walks on into
    a collective its peers never join."""
    err = None
    try:
        out = fn()
    except Exception as e:  # re-raised below, on every rank
        err = e
    group = flat_mesh(mesh).get_group()
    flag = torch.tensor([0 if err is None else 1], dtype=torch.int32,
                        device=collective_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if err is not None:
        raise err
    if int(flag.item()):
        raise RuntimeError(f"{what} failed on another rank of the mesh")
    return out


def all_gather_list(obj, group) -> list:
    """Every rank's ``obj`` (picklable, so numpy arrays come back to the
    bit), in the group's rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def run_over_rays(mesh, fn: Callable, *per_ray):
    """Split a batch over the mesh's ``"rays"`` axis and gather it back.

    ``per_ray`` are numpy arrays of the same length k; they are padded to a
    multiple of the rays extent by repeating the last row, this rank's part
    goes to ``fn`` (which returns a tuple of numpy arrays, rows first), and
    the parts come back over the rays group, concatenated and cut to k rows:
    every rank returns the whole.  Ranks along the other axes repeat the
    work.  Mesh None: ``fn`` on the whole batch.
    """
    if mesh is None:
        return fn(*per_ray)
    k = len(per_ray[0])
    idx, ext = axis_index(mesh, RAYS_AXIS)
    pad = (-k) % ext
    if pad:
        per_ray = tuple(np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                        for v in per_ray)
    m = (k + pad) // ext
    parts = agree(mesh, lambda: fn(*(v[idx * m:(idx + 1) * m]
                                     for v in per_ray)), "a ray batch")
    gathered = all_gather_list(parts, mesh.get_group(RAYS_AXIS))
    return tuple(np.concatenate([g[j] for g in gathered])[:k]
                 for j in range(len(parts)))
