"""Ray lifetimes of the interface fans, and what they make of a warp.

    python -m raytracing_tpu_torch.bench.lifetimes [--candidates]

Runs on the CPU.  For the two interface runs of the main path (the
analytic field at SIGMA/5, 7557 steps, and the parity stratified table at
the reference table's op6 step, 3854 steps) it traces the scenario's 42
launch angles with the plain version (``fused_step_plain``) and prints
each ray's lifetime, dist_sim / ds as ``chip_smoke.py`` counts it.  The
main path resizes those angles to :data:`RAYS` rays (``launch_fan``), so a
32-ray warp holds 32 different angles; from the lifetimes it prints:

* the warp efficiency one ray a thread gives (``fused_kernel``;
  :func:`~raytracing_tpu_torch.bench.warp_efficiency`);
* for each of :data:`BLOCKS_PER_SM`, a lockstep model of the refill loop
  (``fused_kernel_refill`` in csrc/fused.cuh) on a persistent grid of that
  many 128-thread blocks on each of an H100's :data:`SMS` SMs: every warp
  runs one
  iteration at a time, lanes whose ray ended take the next rays in warp
  order, and a warp counts until its last lane has left.  It prints the
  warp efficiency, how many fewer warp-steps than one ray a thread, and the
  iterations until the last warp ends.

The model assumes every warp advances at the same rate; on the card the
warps that run short refill sooner, so it is an estimate, not a device
metric.

``--candidates`` prints instead the one-ray-a-thread warp efficiency of the
fans of the kernels the refill loop could serve next, from their plain
versions on the CPU: golden_step on aniso op11 (SIGMA/1.2, the scenario's
angles resized), golden_step_strat on the golden_strat_op11 run (op11 on
the parity vert table trimmed for aniso's box, at the reference table's
step, 4142 steps, the same angles resized), dynamic_step_strat on the vert_strat run (op6, ds
0.0193, 2000 steps from (-2, -2) at angles U[0.05, 1.5], numpy seed 0;
its first 4096 rays, in the order the kernel's warps take them), and a
dispersed fisheye fan (op1 at the headline step, 4586 steps, launch
points and angles uniform, seed 5, 4096 rays), traced on the analytic
fisheye that the grid, node-table and custom media fit; for the two golden
fans, which the golden loop's refill (csrc/golden.cuh) serves, and the
vert_strat fan, which the dynamic loop's refill (csrc/dynamic.cu) serves
(its 4096 lifetimes repeated to 2^20 rays), also the lockstep model at
:data:`GOLDEN_BLOCKS_PER_SM`.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from raytracing_tpu_torch.bench import warp_efficiency

#: the main path's rays
RAYS = 1 << 20
#: the rays traced for each further candidate's fan (``--candidates``)
CANDIDATE_RAYS = 4096
#: the SMs of an H100 SXM
SMS = 132
#: the refill grid's 128-thread blocks an SM that the model runs: the
#: occupancies around what the refill instantiations' 44-52 registers allow
BLOCKS_PER_SM = (8, 12, 16)
#: the same for the golden and dynamic loops' refill (``--candidates``),
#: whose 56-128 registers allow 4-8 blocks an SM
GOLDEN_BLOCKS_PER_SM = (4, 6, 8)


def interface_lifetimes():
    """{kind: (lifetimes of the 42 launch angles, steps)} for the analytic
    interface run and the interface_strat run, on the CPU."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.bench import launch_fan
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.kernels import fused as kfu

    scen = rtt.scenario("interface")
    pos0, theta0 = launch_fan(scen, len(scen.theta0))
    box = tuple(scen.box)
    ds_a = config.SIGMA / 5.0
    ds_s, div = calibrated_with_fallback("op6", "interface")
    strat = kfu.strat_tables(rtt.compact_for_trace(
        rtt.build_stratified_medium("interface", scen.box, device="cpu"),
        scen.box, ds_s))
    runs = {"analytic": ("interface", float(ds_a), scen.max_size(ds_a) - 1),
            "strat": (strat, float(ds_s), scen.max_size(ds_s, div, 1) - 1)}
    out = {}
    for kind, (field, ds, steps) in runs.items():
        st = kfu.initial_state("op6", pos0, theta0, field=field,
                               with_stats=False, device="cpu")
        p = kfu.fused_step_plain(st, field=field, op="op6", steps=steps,
                                 delta_s=ds, step_limit=steps, offset=0.0,
                                 box=box)
        life = np.minimum(np.rint(p.dsim.double().numpy() / ds), steps)
        out[kind] = (life.astype(np.int64), steps)
    return out


def refill_model(life, threads: int):
    """(warp efficiency, warp-steps, iterations) of the lockstep model of
    the refill loop with ``threads`` lanes (a multiple of 32) over rays of
    lifetimes ``life``, taken in index order."""
    n = len(life)
    threads = min(threads, -(-n // 32) * 32)
    rem = np.zeros(threads, np.int64)
    first = min(threads, n)
    rem[:first] = life[:first]
    inloop = np.arange(threads) < n
    taken, warp_steps, iters = threads, 0, 0
    warps = threads // 32
    while inloop.any():
        need = np.nonzero(inloop & (rem == 0))[0]
        if len(need):
            new = taken + np.arange(len(need))
            ok = new < n
            rem[need[ok]] = life[new[ok]]
            inloop[need[~ok]] = False
            taken += len(need)
        warp_steps += int(inloop.reshape(warps, 32).any(1).sum())
        rem[inloop] -= 1
        iters += 1
    return float(life.sum() / (32.0 * warp_steps)), warp_steps, iters


def candidate_efficiencies():
    """{fan: (one-ray-a-thread warp efficiency, lifetimes)} of the refill
    loop's further candidates (module docstring), on the CPU."""
    import math

    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.bench import (HEADLINE_DIVISOR, dispersed_fan,
                                            launch_fan)
    from raytracing_tpu_torch.kernels import dynamic as kd
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg

    out = {}
    aniso = rtt.scenario("aniso")
    ds = config.SIGMA / 1.2
    steps = aniso.max_size(ds) - 1
    pos0, theta0 = launch_fan(aniso, len(aniso.theta0))
    it, pol = kg.golden_schedule()
    st = kg.initial_state("op11", pos0, theta0, aniso.gamma,
                          field=aniso.field, with_stats=False, device="cpu")
    scal = kg.golden_scalars(ds, aniso.gamma, steps, 0.0, it, device="cpu")
    p = kg.golden_step_plain(st, scal, field=aniso.field, op="op11",
                             steps=steps, box=tuple(aniso.box), iters=it,
                             polish=pol)
    life = np.minimum(np.rint(p.dsim.double().numpy() / float(np.float32(
        ds))), steps).astype(np.int64)
    out[f"golden_step aniso op11, {steps} steps (the {len(life)} angles "
        "resized to 2^20)"] = (warp_efficiency(np.resize(life, RAYS)),
                               life)

    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    ds, div = calibrated_with_fallback("op11", "aniso")
    steps = aniso.max_size(ds, div, 1) - 1
    tables = kfu.strat_tables(rtt.compact_for_trace(
        rtt.build_stratified_medium("vert_heterogeneous",
                                    rtt.scenario("vert").box, device="cpu"),
        aniso.box, ds))
    st = kg.initial_state("op11", pos0, theta0, aniso.gamma, field=tables,
                          with_stats=False, device="cpu")
    scal = kg.golden_scalars(float(ds), aniso.gamma, steps, 0.0, it,
                             device="cpu")
    p = kg.golden_step_plain(st, scal, field=tables, op="op11", steps=steps,
                             box=tuple(aniso.box), iters=it, polish=pol)
    life = np.minimum(np.rint(p.dsim.double().numpy() / float(np.float32(
        ds))), steps).astype(np.int64)
    out[f"golden_step_strat golden_strat_op11, {steps} steps (the "
        f"{len(life)} angles resized to 2^20)"] = (
            warp_efficiency(np.resize(life, RAYS)), life)

    vert = rtt.scenario("vert")
    ds = float(np.float32(0.0193))
    th = np.random.default_rng(0).uniform(0.05, 1.5, 1 << 20)[:CANDIDATE_RAYS]
    tables = kfu.strat_tables(rtt.compact_for_trace(
        rtt.build_stratified_medium("vert_heterogeneous", vert.box,
                                    device="cpu"), vert.box, ds))
    st = kd.initial_dyn_state(np.full((CANDIDATE_RAYS, 2), -2.0), th, device="cpu")
    p = kd.dynamic_step_plain(st, field=tables, op="op6", steps=2000,
                              delta_s=ds, step_limit=2000.0, offset=0.0,
                              box=tuple(vert.box))
    life = np.minimum(np.rint(p.dsim.double().numpy() / ds),
                      2000).astype(np.int64)
    out[f"dynamic_step_strat vert_strat op6, 2000 steps (first {CANDIDATE_RAYS} "
        "rays)"] = (warp_efficiency(life), life)

    fish = rtt.scenario("fisheye")
    pos0, theta0 = dispersed_fan(fish.box, CANDIDATE_RAYS, np.random.default_rng(5))
    ds = float(np.float32(2.0 * math.pi / HEADLINE_DIVISOR))
    steps = HEADLINE_DIVISOR - 1
    st = kfu.initial_state("op1", pos0, theta0, field="fisheye",
                           with_stats=False, device="cpu")
    p = kfu.fused_step_plain(st, field="fisheye", op="op1", steps=steps,
                             delta_s=ds, step_limit=steps, offset=0.0,
                             box=tuple(fish.box))
    life = np.minimum(np.rint(p.dsim.double().numpy() / ds),
                      steps).astype(np.int64)
    out[f"grid / nodes / custom, dispersed fisheye fan op1, {steps} steps "
        f"({CANDIDATE_RAYS} rays)"] = (warp_efficiency(life), life)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--candidates", action="store_true",
                    help="the refill loop's further candidates' fans")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    if args.candidates:
        for fan, (eff, life) in candidate_efficiencies().items():
            print(f"{fan}: lifetimes {life.min()}-{life.max()} (mean "
                  f"{life.mean():.1f}), warp efficiency one ray a thread "
                  f"{eff:.3f}", flush=True)
            if fan.startswith(("golden", "dynamic")):
                for b in GOLDEN_BLOCKS_PER_SM:
                    eff, _, iters = refill_model(np.resize(life, RAYS),
                                                 b * 128 * SMS)
                    print(f"  refill, {b} blocks of 128 on {SMS} SMs: warp "
                          f"efficiency {eff:.3f}, {iters} iterations",
                          flush=True)
        return 0
    for kind, (life42, steps) in interface_lifetimes().items():
        life = np.resize(life42, RAYS)
        one = warp_efficiency(life)
        one_steps = int(np.concatenate(
            [life, np.zeros(-len(life) % 32, life.dtype)]).reshape(
                -1, 32).max(1).sum())
        print(f"{kind} op6, {steps} steps: lifetimes {life42.min()}-"
              f"{life42.max()} (mean {life42.mean():.1f}) of the "
              f"{len(life42)} angles {life42.tolist()}", flush=True)
        print(f"  one ray a thread: warp efficiency {one:.3f}, "
              f"{one_steps} warp-steps", flush=True)
        for b in BLOCKS_PER_SM:
            eff, ws, iters = refill_model(life, b * 128 * SMS)
            print(f"  refill, {b} blocks of 128 on {SMS} SMs: warp "
                  f"efficiency {eff:.3f}, {one_steps / ws:.2f}x fewer "
                  f"warp-steps, {iters} iterations", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
