"""Rank-side helpers of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_distributed.py): a gloo world of CPU processes.

:func:`run_world` starts ``n`` processes with ``torch.multiprocessing``
(spawn), joined through a ``FileStore`` in a temporary directory (no TCP
port, so parallel test workers cannot collide).  Every rank runs the same
list of cases, functions of this module named ``case_*``, each on its own
rank, and sends back what each returned, or its traceback.  The parent
waits at most ``timeout`` seconds and then kills the world and raises with
what the ranks said, so a hung collective fails its tests instead of
running the suite into its time limit.

This module imports torch and the port only, never JAX: the JAX side of
each comparison runs in the parent process, on the gathered results.
"""
from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import torch


def _np(t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _local_np(t):
    return t.to_local().detach().cpu().numpy()


def _rank_main(rank, n, store_path, cases, out_q):
    torch.set_num_threads(1)
    import torch.distributed as dist

    results = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n)
        for name, args in cases:
            try:
                results[name] = ("ok", globals()["case_" + name](*args))
            except Exception:
                results[name] = ("err", traceback.format_exc())
        dist.destroy_process_group()
    except Exception:
        results["__world__"] = ("err", traceback.format_exc())
    out_q.put((rank, results))


def run_world(n: int, cases, tmpdir, timeout: float = 120.0) -> dict:
    """Run ``cases`` ([(name, args)]) on every rank of an ``n``-rank gloo
    world; returns {name: [rank 0's result, rank 1's, ...]} where a result
    is ("ok", value) or ("err", traceback)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    store = os.path.join(str(tmpdir), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, n, store, list(cases), out_q))
             for rank in range(n)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, res = out_q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                if all(not p.is_alive() for p in procs) and out_q.empty():
                    break
                continue
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) < n:
        said = {r: {k: v[1][-2000:] for k, v in res.items() if v[0] == "err"}
                for r, res in got.items()}
        raise RuntimeError(f"the {n}-rank world did not finish within "
                           f"{timeout} s: ranks {sorted(got)} answered; "
                           f"their errors: {said}; exit codes "
                           f"{[p.exitcode for p in procs]}")
    for r, res in got.items():
        if "__world__" in res:
            raise RuntimeError(f"rank {r} failed outside a case:\n"
                               + res["__world__"][1])
    return {name: [got[r][name] for r in range(n)] for name, _ in cases}


@contextlib.contextmanager
def one_rank_mesh(**kw):
    """A one-rank CPU mesh in this process (``make_mesh``'s own group),
    its process group destroyed on the way out."""
    import torch.distributed as dist

    from raytracing_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    try:
        yield make_mesh(device="cpu", **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def result(world: dict, name: str) -> list:
    """Every rank's value of case ``name``; fails with the first rank's
    traceback if any rank raised."""
    for rank, (kind, val) in enumerate(world[name]):
        if kind == "err":
            raise AssertionError(f"case {name} failed on rank {rank}:\n{val}")
    return [val for _, val in world[name]]


def medium(kind_fields, device="cpu"):
    """A port medium from (class name, fields) as the parent exported it
    (``tests/torch_port_helpers.py::medium_fields``)."""
    if kind_fields is None:
        return None
    from raytracing_tpu_torch.interop import medium_from_numpy

    kind, fields = kind_fields
    return medium_from_numpy(kind, fields, device=device)


# -- the cases: each runs on every rank and returns numpy and Python values --
CPU = dict(device="cpu")


def _mesh(**kw):
    from raytracing_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device="cpu", **kw)


def _fields(res, names):
    """The named fields of a result, gathered whole (a collective: every
    rank calls it in the same order) as numpy."""
    return {k: _np(getattr(res, k)) for k in names
            if getattr(res, k) is not None}


def fisheye_batch(r):
    """The fisheye launch point (1, 0) with a narrow fan around pi/2."""
    theta0 = np.pi / 2 + np.linspace(-0.01, 0.01, r)
    return np.stack([np.ones(r), np.zeros(r)], -1), theta0


def case_trace_sharded():
    """trace_sharded on the fisheye at float64 against the one-rank trace,
    with the summary; tests/test_distributed.py's batch."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.parallel.distributed import (
        summarize_sharded, trace_sharded)

    mesh = _mesh()
    scen, med = rtt.scenario("fisheye"), rtt.analytic_medium("fisheye")
    div = 64
    pos0, theta0 = fisheye_batch(64)
    kw = dict(delta_s=2 * np.pi / div, divisor=div + 1, n_turns=1,
              dtype=torch.float64, pos0=pos0, theta0=theta0, **CPU)
    s = trace_sharded("op1", scen, med, mesh=mesh, **kw)
    one = rtt.trace("op1", scen, med, mode="metrics", **kw)
    summ = summarize_sharded(s)
    return {"pos": _np(s.final.pos), "dist_sim": _np(s.dist_sim),
            "exit_step": _np(s.exit_step), "local": _local_np(s.final.pos),
            "placements": str(s.final.pos.placements),
            "one_pos": _np(one.final.pos), "one_dist": _np(one.dist_sim),
            "one_exit": _np(one.exit_step),
            "summary": (float(summ.mean_closure_pct),
                        float(summ.total_distance), summ.rays)}


def case_trace_sharded_indivisible():
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.parallel.distributed import trace_sharded

    pos0, theta0 = fisheye_batch(63)
    try:
        trace_sharded("op1", rtt.scenario("fisheye"),
                      rtt.analytic_medium("fisheye"), delta_s=0.1,
                      mesh=_mesh(), pos0=pos0, theta0=theta0, divisor=10,
                      n_turns=1, **CPU)
    except ValueError as e:
        return str(e)
    return None


def case_helpers():
    """Each sharding helper's layout: this rank's local shape."""
    from torch.distributed.tensor import distribute_tensor

    from raytracing_tpu_torch.parallel import mesh as M
    from raytracing_tpu_torch.parallel.distributed import ray_batch_sharding

    mesh = _mesh()
    out = {"shape": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names}
    for name, x in (("candidate_ray", torch.zeros(4, 16)),
                    ("ray", torch.zeros(16)), ("replicated", torch.zeros(4)),
                    ("sweep", torch.zeros(8)), ("batch", torch.zeros(16, 2))):
        sh = (ray_batch_sharding(mesh) if name == "batch"
              else getattr(M, name + ("_sharding" if name != "replicated"
                                      else ""))(mesh))
        d = distribute_tensor(x, *sh)
        out[name] = (tuple(d.to_local().shape), str(sh.placements))
    return out


def case_slices():
    """The 3-axis (slice, sweep, rays) mesh, candidates over (slice,
    sweep) jointly, and its refusals."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = _mesh(n_devices=4, slices=2)
    d = distribute_tensor(torch.arange(8.0), mesh,
                          [Shard(0), Shard(0), Replicate()])
    out = {"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape),
           "local": d.to_local().numpy()}
    for kw in (dict(n_devices=4, slices=3), dict(n_devices=3),
               dict(sweep=3)):
        try:
            _mesh(**kw)
            out[str(kw)] = None
        except ValueError as e:
            out[str(kw)] = str(e)
    return out


def _fast_pair(op, scen, medium, names, *, block_rays=128, mesh=None, **kw):
    """fast_trace_sharded and the one-rank fast_trace on the same batch."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine.fast import fast_trace_sharded

    s = fast_trace_sharded(op, scen, medium, mesh=mesh or _mesh(),
                           block_rays=block_rays, **kw, **CPU)
    out = {"engine": s.engine, "local": _local_np(s.pos),
           **_fields(s, names)}
    return _one_rank(out, lambda: rtt.fast_trace(op, scen, medium, **kw,
                                                 **CPU), names)


def _one_rank(out, run, names):
    """Rank 0 adds the one-rank call's fields as ``one_*`` (and its engine
    as ``one_engine``); the other ranks skip the repeat of the whole batch,
    the dearest work of these cases."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        one = run()
        out.update({"one_" + k: v for k, v in _fields(one, names).items()})
        if hasattr(one, "engine"):
            out["one_engine"] = one.engine
    return out


FAST_PLANES = ("pos", "traveltime", "dist_sim", "active", "tangent")
STATS_PLANES = FAST_PLANES + ("mom_count", "mom_mean", "mom_m2")


def case_fast_strat(medium_kf, r, steps):
    """The stratified interface table, op6 (tests/test_distributed.py's
    fast_trace_sharded case)."""
    import raytracing_tpu_torch as rtt

    scen = rtt.scenario("interface")
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), r)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    return _fast_pair("op6", scen, medium(medium_kf), STATS_PLANES,
                      delta_s=0.01, steps=steps, pos0=pos0, theta0=theta0,
                      stats=True)


def case_fast_custom(grid_kf, r):
    """A constant CustomMedium (straight rays), then a 2-D grid medium
    through the grid route."""
    import raytracing_tpu_torch as rtt

    scen = rtt.scenario("fisheye")
    const = rtt.CustomMedium(n_fn=lambda x, y: torch.full_like(x, 2.0))
    pos0, theta0 = fisheye_batch(r)
    pos0, theta0 = pos0.astype(np.float32), theta0.astype(np.float32)
    out = {"custom": _fast_pair("op1", scen, const, FAST_PLANES,
                                delta_s=0.01, steps=36, pos0=pos0,
                                theta0=theta0)}
    out["grid"] = _fast_pair("op1", scen, medium(grid_kf), FAST_PLANES,
                             delta_s=0.01, steps=8, pos0=pos0,
                             theta0=theta0)
    return out


def case_diff_grad(r, steps):
    """d(mean |pos|^2)/d(thck) of a trace_diff loss: each rank's share of
    the mean, summed by an autograd-aware all-reduce, against the
    one-process gradient (tests/test_diff.py:219)."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dfn

    from raytracing_tpu_torch.engine.diff import ParametricMedium, trace_diff

    sqrt2 = float(np.sqrt(2.0))
    theta0 = np.linspace(np.pi / 5, np.pi / 2.2, r)
    pos0 = np.tile(np.array([[-2.0, -1.0]]), (r, 1))

    def n_fn(p, x, y):
        return sqrt2 - (sqrt2 - 1.0) / (1.0 + torch.exp(-y / p))

    def loss_sum(thck, p0, t0):
        pos, *_ = trace_diff("op6", ParametricMedium(n_fn, thck),
                             torch.tensor(p0), torch.tensor(t0), 0.02,
                             steps=steps, **CPU)
        return torch.sum(torch.sum(pos ** 2, dim=-1))

    thck = torch.tensor(0.15, dtype=torch.float64, requires_grad=True)
    g_one, = torch.autograd.grad(loss_sum(thck, pos0, theta0) / r, thck)
    n, k = dist.get_world_size(), dist.get_rank()
    m = r // n
    thck = torch.tensor(0.15, dtype=torch.float64, requires_grad=True)
    local = loss_sum(thck, pos0[k * m:(k + 1) * m],
                     theta0[k * m:(k + 1) * m])
    # every rank holds the whole loss; the all-reduce's backward sums the
    # ranks' copies of it, so each rank's gradient is its rays' share N
    # times over, and the shared parameter's gradient is their mean
    loss = dfn.all_reduce(local) / r
    g_rank, = torch.autograd.grad(loss, thck)
    g_mesh = g_rank.detach().clone()
    dist.all_reduce(g_mesh)
    return float(g_one), float(g_mesh / n), float(loss)


def case_fast_fused(r):
    """The analytic fisheye, op6 (tests/test_fast.py:66)."""
    import raytracing_tpu_torch as rtt

    pos0, theta0 = fisheye_batch(r)
    return _fast_pair("op6", rtt.scenario("fisheye"),
                      rtt.analytic_medium("fisheye"), FAST_PLANES,
                      delta_s=2 * np.pi / 64, steps=64,
                      pos0=pos0.astype(np.float32),
                      theta0=theta0.astype(np.float32))


def case_fast_refusals():
    """The batch that does not divide by devices x block, stats off a
    stratified table, an op with no sharded route (tests/test_fast.py:87,
    :435)."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine.fast import fast_trace_sharded

    mesh = _mesh()
    scen, med = rtt.scenario("fisheye"), rtt.analytic_medium("fisheye")
    out = {}
    for name, r, kw in (("batch", 100, {}), ("stats", 512, dict(stats=True)),
                        ("medium", 512, dict(medium=object()))):
        pos0, theta0 = fisheye_batch(r)
        try:
            fast_trace_sharded("op6", scen, kw.pop("medium", med),
                               delta_s=0.1, steps=4, pos0=pos0,
                               theta0=theta0, mesh=mesh, block_rays=128,
                               **kw, **CPU)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def case_fast_golden(strat_kf, r):
    """The golden family: aniso op11 on the analytic vert field, op5 on a
    stratified profile (tests/test_fast.py:391)."""
    import raytracing_tpu_torch as rtt

    scen = rtt.scenario("aniso")
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), r)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (r, 1))
    out = {"aniso": _fast_pair(
        "op11", scen, rtt.analytic_medium("vert_heterogeneous"), FAST_PLANES,
        delta_s=0.02, steps=64, pos0=pos0, theta0=theta0)}
    pos0v, theta0v = profile_batch(r)
    out["strat"] = _fast_pair("op5", rtt.scenario("vert"), medium(strat_kf),
                              FAST_PLANES, delta_s=0.01, steps=64,
                              pos0=pos0v, theta0=theta0v)
    return out


def profile_batch(r):
    """tests/test_fast.py's launch column across a stratified profile."""
    pos0 = np.stack([np.zeros(r), np.linspace(-0.5, 0.5, r)],
                    -1).astype(np.float32)
    return pos0, np.linspace(-0.3, 0.3, r).astype(np.float32)


def case_fast_stats(strat_kf, r):
    """Welford stats ride the sharded kernels (tests/test_fast.py:435)."""
    import raytracing_tpu_torch as rtt

    pos0, theta0 = profile_batch(r)
    return _fast_pair("op6", rtt.scenario("vert"), medium(strat_kf),
                      STATS_PLANES, delta_s=0.01, steps=64, pos0=pos0,
                      theta0=theta0, stats=True)


def case_fast_grid(grid_kf, r, steps):
    """A 2-D grid through fast_trace_sharded (tests/test_fast.py:268,
    tests/test_c1.py:361)."""
    import raytracing_tpu_torch as rtt

    pos0 = np.tile(np.array([1.0, 0.0], np.float32), (r, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.01, 0.01, r)).astype(np.float32)
    return _fast_pair("op6", rtt.scenario("fisheye"), medium(grid_kf),
                      FAST_PLANES, delta_s=0.01, steps=steps, pos0=pos0,
                      theta0=theta0)


case_fast_grid_c1 = case_fast_grid


def case_grid_tiled(grid_kf, r, steps):
    """grid_trace_tiled(mesh=) against the one-rank call
    (tests/test_grid_tiled.py:238), and its dynamic twin."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine.segmented import (
        grid_trace_dynamic_tiled, grid_trace_tiled)

    mesh = _mesh()
    med = medium(grid_kf)
    pos0, theta0 = fisheye_batch(r)
    pos0, theta0 = pos0.astype(np.float32), theta0.astype(np.float32)
    kw = dict(steps=steps, box=tuple(rtt.scenario("fisheye").box), **CPU)
    ds = np.float32(2 * np.pi / 4587)
    out = {}
    for name, fn, planes in (
            ("kin", grid_trace_tiled, FAST_PLANES),
            ("dyn", grid_trace_dynamic_tiled,
             ("pos", "traveltime", "q", "dtheta", "kmah", "active"))):
        s = fn("op6", pos0, theta0, ds, med, mesh=mesh, block_rays=128, **kw)
        out[name] = _one_rank(_fields(s, planes), lambda: fn(
            "op6", pos0, theta0, ds, med, **kw), planes)
    try:
        grid_trace_tiled("op6", pos0[:100], theta0[:100], ds, med,
                         mesh=mesh, block_rays=128, **kw)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _rays_mesh():
    """A 1-D mesh over every rank named "rays", as tests/test_tiled3.py
    builds one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("rays",))


def fan3(r, spread=0.05):
    """tests/test_tiled3.py's fan."""
    th = np.pi / 2 + np.linspace(-spread, spread, r)
    return (np.tile(np.array([1.0, 0.0, 0.0], np.float32), (r, 1)),
            np.stack([np.cos(th), np.sin(th), np.full(r, 0.02)],
                     -1).astype(np.float32))


BOX3 = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)


def case_tiled3(grid3_kf, r, steps):
    """grid3_trace_tiled(mesh=) and grid3_trace_dynamic_tiled(mesh=)
    against the one-rank calls (tests/test_tiled3.py:220,
    tests/test_dynamic_tiled3.py:206)."""
    from raytracing_tpu_torch.engine.tiled3 import (
        grid3_trace_dynamic_tiled, grid3_trace_tiled)

    mesh = _rays_mesh()
    med = medium(grid3_kf)
    pos0, dirs = fan3(r)
    ds = np.float32(2 * np.pi / 600)
    kw = dict(steps=steps, box=BOX3, **CPU)
    out = {}
    for name, fn, planes in (
            ("kin", grid3_trace_tiled,
             ("pos", "tangent", "traveltime", "dist_sim", "active")),
            ("dyn", grid3_trace_dynamic_tiled,
             ("pos", "detq", "kmah", "traveltime", "min_absdet_step",
              "active"))):
        s = fn("op6", pos0, dirs, ds, med, mesh=mesh, block_rays=128, **kw)
        out[name] = _one_rank(_fields(s, planes), lambda: fn(
            "op6", pos0, dirs, ds, med, **kw), planes)
    return out


def case_sweep(n_cand):
    """run_candidates(mesh=) on the fisheye candidates, float64
    (tests/test_sweep.py:91), and delta_s_search with a checkpoint that
    rank 0 alone writes."""
    import os
    import tempfile

    import torch.distributed as dist

    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.parallel import sweep as sw

    scen, med = rtt.scenario("fisheye"), rtt.analytic_medium("fisheye")
    divs = np.arange(60.0, 3.0, -1.0)[:n_cand]
    ds = 2 * np.pi / divs
    sizes = (divs + 1).astype(np.int64)
    kw = dict(n_turns=1, dtype=torch.float64, **CPU)
    mesh = _mesh(sweep=dist.get_world_size())
    s = sw.run_candidates("op1", scen, med, ds, sizes - 1, int(sizes.max()),
                          mesh=mesh, **kw)
    one = (sw.run_candidates("op1", scen, med, ds, sizes - 1,
                             int(sizes.max()), **kw)
           if dist.get_rank() == 0 else None)
    # a ragged chunk (9 candidates) runs whole on every rank
    ragged = sw.run_candidates("op1", scen, med, ds[:9], sizes[:9] - 1,
                               int(sizes[:9].max()), mesh=mesh, **kw)
    # the search: every rank selects the same divisor; rank 0 writes the
    # checkpoint into a directory rank 0 chose
    d = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(d)
    ck = os.path.join(d[0], "sweep.npz")
    search = sw.delta_s_search("op1", scen, med, mesh=_mesh(), chunk=8,
                               checkpoint=ck, divisors=divs, **kw)
    again = sw.delta_s_search("op1", scen, med, mesh=_mesh(), chunk=8,
                              checkpoint=ck, divisors=divs, **kw)
    return {"closure": s["closure_pct"],
            "one": None if one is None else one["closure_pct"],
            "ragged": ragged["closure_pct"],
            "search": (search.index, search.divisor, search.engine),
            "again": (again.index, again.divisor),
            "metrics": search.metrics["closure_pct"],
            "file": os.path.exists(ck)}


EIG_KW = dict(source=(0.0, 0.0), receivers=[(3.0, 0.2), (3.0, -0.3),
                                             (2.5, 0.1)],
              delta_s=0.04, max_size=100, box=(-1.0, 4.0, -1.5, 1.5),
              fan=(-0.5, 0.5, 21))


def case_eigenrays():
    """find_eigenrays(mesh=) against the one-rank solver on the parabolic
    waveguide of tests/test_torch_eigenray.py: the same arrivals on every
    rank, to the bit."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine.eigenray import find_eigenrays

    med = rtt.CustomMedium(lambda x, y: 1.5 - 0.5 * y * y + 0.0 * x,
                           lambda x, y: (0.0 * x, -y))
    import torch.distributed as dist

    s = find_eigenrays("op6", med, mesh=_mesh(), **EIG_KW, **CPU)
    one = (find_eigenrays("op6", med, **EIG_KW, **CPU)
           if dist.get_rank() == 0 else s)
    return {k: (getattr(s, k), getattr(one, k)) for k in s._fields}


def case_example_search(root, workdir, upper, lower):
    """examples/delta_s_search_torch.py's main on a mesh over the world's
    ranks, in ``workdir``, the candidate grid narrowed to [lower, upper]
    in this rank's config."""
    import importlib.util

    import raytracing_tpu_torch.config as tcfg

    tcfg.DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT = float(upper)
    tcfg.DELTA_S_DIVISOR_FISHEYE_LOWER_LIMIT = float(lower)
    spec = importlib.util.spec_from_file_location(
        "delta_s_search_torch",
        os.path.join(root, "examples", "delta_s_search_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.chdir(workdir)
    res = mod.main(["--device", "cpu"])
    return (res.divisor, res.engine,
            os.path.exists(os.path.join(workdir, "fisheye_sweep.npz")))
