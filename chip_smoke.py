#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, when
either is missing or any check fails.  Phases, one line or more each:

1. environment: torch and CUDA versions, the device, and the card's name
   and power limit from nvidia-smi;
2. build: the three CUDA kernels compiled from raytracing_tpu_torch/csrc;
3. kernel against plain: every kernel against its plain PyTorch version on
   the card, for every (op, field) it serves, at 65,536 rays (each
   scenario's launch fan resized, with jitter from numpy seed 0) at the
   op's calibrated analytic step, capped at 1,000 steps; and resume: k
   then n - k steps against n steps;
4. headline: fisheye op1, 2**20 rays, divisor 4587 (4587 steps) through
   make_fisheye_runner: closure error, ray-steps/s (median of 5 timed runs
   after 2 warm-ups), and the plain version's time at the same shape;
5. scenarios at 2**20 rays through fast_trace: interface op6 Snell errors,
   fisheye op6 ten-turn closure, vert op8 and aniso op11 momentum CV;
6. main shapes: each scenario's fast_trace result (positions, traveltime,
   `active`) against the kernel's plain version on the same inputs at the
   full shape and step count, and the kernel's time there beside the
   plain version's.

Phases 4 and 5 are the main path: every launch count is set to 0 just
before them and read just after, and each kernel must have launched; the
launches phases 3 and 6 make to compare and time a kernel are not counted.
The second-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

RAYS_CHECK = 1 << 16
STEP_CAP = 1000
RAYS_MAIN = 1 << 20
HEADLINE_DIVISOR = 4587

# kernel-against-plain tolerances: the JAX package's own kernel-against-scan
# bars for the same op and field (tests/test_kernels.py:24-27,
# tests/test_fused.py:31-83, tests/test_golden_kernel.py:36-41)
POS_TOL = {"fisheye": 1e-5, "vert_heterogeneous": 1e-5, "interface": 2e-4}
POS_TOL_OP7 = 2e-4
POS_TOL_GOLDEN = 5e-4
TT_REL_TOL = 1e-5
TT_ABS_TOL_GOLDEN = 5e-4
ACTIVE_TOL = 1e-3          # share of rays whose `active` flags may differ
# the scenario whose kernel time the kernels line reports: each kernel's
# longest launch on the main path
TIMED_SHAPE = {"fused_step": "interface", "golden_step": "aniso"}


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps=1):
    """Mean device time (ms) of ``fn`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps, out


def fan(scen, rays, rng=None):
    """The scenario's launch fan resized to ``rays`` (bench.py::_fan), with
    optional uniform jitter of +-1e-3 rad on the launch angles."""
    from raytracing_tpu_torch.bench import launch_fan
    pos0, theta0 = launch_fan(scen, rays)
    if rng is not None:
        theta0 = (theta0 + rng.uniform(-1e-3, 1e-3, rays)).astype(np.float32)
    return pos0, theta0


def calibrated_step(op, scen_name):
    """(delta_s, divisor) at the op's calibrated analytic step, falling back
    to the reference tables (op12 -> op8, opNn -> opN) where the analytic
    table has no entry."""
    from raytracing_tpu_torch.calibrated import (calibrated_analytic,
                                                 calibrated_with_fallback)
    base = "op8" if op == "op12" else op.rstrip("n")
    try:
        ds, div = calibrated_analytic(base, scen_name)
    except KeyError:
        ds = None
    if ds is None:
        ds, div = calibrated_with_fallback(op, scen_name)
    return float(ds), div


class Errors:
    """Largest kernel-against-plain deviations seen for one kernel."""

    def __init__(self):
        self.pos = 0.0

    def compare(self, label, kp, pp, ktt, ptt, kact, pact, pos_tol,
                tt_rel=None, tt_abs=None):
        dpos = float((kp - pp).abs().max())
        dtt_abs = float((ktt - ptt).abs().max())
        dtt_rel = float(((ktt - ptt).abs() / ptt.abs().clamp_min(1e-30)).max())
        nact = int((kact != pact).sum()) if kact is not None else 0
        rays = kp.shape[0]
        self.pos = max(self.pos, dpos)
        ok = (dpos <= pos_tol and nact <= ACTIVE_TOL * rays
              and (tt_rel is None or dtt_rel <= tt_rel)
              and (tt_abs is None or dtt_abs <= tt_abs))
        tt_txt = (f"rel {dtt_rel:.3e} (tol {tt_rel})" if tt_rel is not None
                  else f"abs {dtt_abs:.3e} (tol {tt_abs})")
        print(f"  {label}: |dpos| {dpos:.3e} (tol {pos_tol}) |dtt| {tt_txt} "
              f"active mismatches {nact}/{rays}", flush=True)
        if not ok:
            fail(f"{label}: kernel disagrees with its plain version")


def phase_environment():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs the port on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}", flush=True)
    print(smi.splitlines()[0], flush=True)
    return name, smi.splitlines()[0]


def phase_build():
    from raytracing_tpu_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"[build] {path.name} from {build.CSRC} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_kernel_vs_plain(device, rays=RAYS_CHECK, cap=STEP_CAP):
    """Every kernel against its plain version; returns {kernel: Errors}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.kernels import fisheye as kf
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg

    rng = np.random.default_rng(0)
    errs = {"fisheye_op1": Errors(), "fused_step": Errors(),
            "golden_step": Errors()}
    before = {k.name: k.launches for k in (kf.KERNEL, kfu.KERNEL, kg.KERNEL)}
    scen_of = {"fisheye": "fisheye", "interface": "interface",
               "vert_heterogeneous": "vert"}

    def inputs(scen_name, op):
        scen = rtt.scenario(scen_name)
        ds, div = calibrated_step(op, scen_name)
        steps = min(cap, int(div) if scen.is_fisheye
                    else scen.max_size(ds) - 1)
        pos0, theta0 = fan(scen, rays, rng)
        return scen, ds, steps, pos0, theta0

    print(f"[kernel-vs-plain] {rays} rays, at most {cap} steps", flush=True)
    # fisheye_op1
    scen, ds, steps, pos0, theta0 = inputs("fisheye", "op1")
    x, y, th = kfu._vectors(pos0, theta0, device)
    ux, uy = torch.cos(th), torch.sin(th)
    kx, ky, ktt = kf.fisheye_op1(x, y, ux, uy, ds, steps)
    px, py, ptt = kf.fisheye_op1_plain(x, y, ux, uy, ds, steps)
    errs["fisheye_op1"].compare(
        f"fisheye_op1 {steps} steps", torch.stack([kx, ky], -1),
        torch.stack([px, py], -1), ktt, ptt, None, None, POS_TOL["fisheye"],
        tt_rel=TT_REL_TOL)

    # fused_step: every op on every field, with stats where p_x is invariant
    for op in kfu.FUSED_OPS:
        for field in kfu.FUSED_FIELDS:
            scen, ds, steps, pos0, theta0 = inputs(scen_of[field], op)
            stats = field != "fisheye"
            st = kfu.initial_state(op, pos0, theta0, field=field,
                                   with_stats=stats, device=device)
            kw = dict(field=field, op=op, steps=steps, delta_s=ds,
                      step_limit=steps, offset=0.0, box=tuple(scen.box))
            k = kfu.fused_step(st, **kw)
            p = kfu.fused_step_plain(st, **kw)
            tol = POS_TOL_OP7 if op == "op7" else POS_TOL[field]
            errs["fused_step"].compare(
                f"fused_step {op} {field} {steps} steps",
                torch.stack([k.x, k.y], -1), torch.stack([p.x, p.y], -1),
                k.tt, p.tt, k.active, p.active, tol, tt_rel=TT_REL_TOL)

    # golden_step: every op on every field, default schedule; the bracket
    # parity mode and the coarse bracket + polish on a subset
    cases = [(op, field, None, None) for op in kg.GOLDEN_OPS
             for field in kfu.FUSED_FIELDS]
    cases += [("op5", "vert_heterogeneous", None, 0),
              ("op10", "vert_heterogeneous", None, 0),
              ("op9", "fisheye", None, 0),
              ("op11", "vert_heterogeneous", kg.GOLD_COARSE_ITERS, 2),
              ("op5", "interface", kg.GOLD_COARSE_ITERS, 2)]
    for op, field, iters, polish in cases:
        scen_name = scen_of[field]
        if field == "vert_heterogeneous" and op not in ("op5", "op9"):
            scen_name = "aniso"
        scen, ds, steps, pos0, theta0 = inputs(scen_name, op)
        stats = field != "fisheye"
        it, pol = kg.golden_schedule(polish, iters)
        st = kg.initial_state(op, pos0, theta0, scen.gamma, field=field,
                              with_stats=stats, device=device)
        scal = kg.golden_scalars(ds, scen.gamma, steps, 0.0, it, device=device)
        k = kg.golden_step(st, scal, field=field, op=op, steps=steps,
                           box=scen.box, gold_iters=it, polish=pol)
        p = kg.golden_step_plain(st, scal, field=field, op=op, steps=steps,
                                 box=tuple(scen.box), iters=it, polish=pol)
        errs["golden_step"].compare(
            f"golden_step {op} {field} iters={it} polish={pol} {steps} steps",
            torch.stack([k.x, k.y], -1), torch.stack([p.x, p.y], -1),
            k.tt, p.tt, k.active, p.active, POS_TOL_GOLDEN,
            tt_abs=TT_ABS_TOL_GOLDEN)

    # resume: k steps then n - k steps (offset k) must equal n steps
    for op, field in (("op7", "fisheye"), ("op6", "interface"),
                      ("op12", "vert_heterogeneous")):
        scen, ds, steps, pos0, theta0 = inputs(scen_of[field], op)
        st = kfu.initial_state(op, pos0, theta0, field=field,
                               with_stats=field != "fisheye", device=device)
        kw = dict(field=field, op=op, delta_s=ds, step_limit=steps,
                  box=tuple(scen.box))
        one = kfu.fused_step(st, steps=steps, offset=0.0, **kw)
        cut = steps // 3
        two = kfu.fused_step(kfu.fused_step(st, steps=cut, offset=0.0, **kw),
                             steps=steps - cut, offset=float(cut), **kw)
        resume_check(f"fused_step {op} {field}", one, two)
    for op, iters, polish in (("op11", None, None), ("op10", None, 0),
                              ("op11n", None, None)):
        scen, ds, steps, pos0, theta0 = inputs("aniso", op)
        it, pol = kg.golden_schedule(polish, iters)
        st = kg.initial_state(op, pos0, theta0, scen.gamma,
                              field=scen.field, with_stats=True, device=device)
        cut = steps // 3

        def run(s, n, off):
            scal = kg.golden_scalars(ds, scen.gamma, steps, off, it,
                                     device=device)
            return kg.golden_step(s, scal, field=scen.field, op=op, steps=n,
                                  box=scen.box, gold_iters=it, polish=pol)

        resume_check(f"golden_step {op} iters={it} polish={pol}",
                     run(st, steps, 0.0),
                     run(run(st, cut, 0.0), steps - cut, float(cut)))
    for k in (kf.KERNEL, kfu.KERNEL, kg.KERNEL):
        delta = k.launches - before[k.name]
        print(f"  {k.name}: {delta} launches in this phase", flush=True)
        if delta <= 0:
            fail(f"{k.name} was not launched against its plain version")
    return errs


def resume_check(label, one, two):
    worst = 0.0
    for a, b in zip(one, two):
        if a is None:
            continue
        if a.dtype == torch.bool:
            worst = max(worst, float((a != b).sum()))
        else:
            worst = max(worst, float((a - b).abs().max()))
    print(f"  resume {label}: k + (n-k) vs n max |d| = {worst:.3e}", flush=True)
    if worst != 0.0:
        fail(f"resume {label}: chained launches differ from one launch")


def phase_headline(device, errs, rays=RAYS_MAIN, divisor=HEADLINE_DIVISOR):
    from raytracing_tpu_torch.kernels import fisheye as kf
    from raytracing_tpu_torch.bench.harness import benchmark
    run = kf.make_fisheye_runner(rays, divisor, 1, device=device)
    steps = run.steps
    # 2 warm-ups, then 5 timed runs; the runner ends each run with
    # torch.cuda.synchronize(), so every run starts on an idle card
    times = benchmark(run, rays * steps, trials=5, warmup=2,
                      max_rounds=1).samples
    med = float(np.median(times))
    pos = run()
    closure = float(100.0 * torch.linalg.vector_norm(
        pos[0] - torch.tensor([1.0, 0.0], device=device)) / (2 * math.pi))
    # the plain version at the same shape, same inputs
    x = torch.ones(rays, device=device)
    y = torch.zeros(rays, device=device)
    th = torch.full((rays,), math.pi / 2.0, device=device)
    ds = float(np.float32(2.0 * math.pi / divisor))
    plain_ms, (px, py, _) = cuda_ms(
        lambda: kf.fisheye_op1_plain(x, y, torch.cos(th), torch.sin(th), ds,
                                     steps))
    dpos = float((pos - torch.stack([px, py], -1)).abs().max())
    errs["fisheye_op1"].pos = max(errs["fisheye_op1"].pos, dpos)
    rate = rays * steps / med
    print(f"[headline] fisheye op1 {rays} rays x {steps} steps: "
          f"{med * 1e3:.3f} ms median of {len(times)} "
          f"({rate:.4e} ray-steps/s), closure {closure:.6f} % (bar < 5), "
          f"plain version {plain_ms:.1f} ms, |dpos| vs plain {dpos:.3e}",
          flush=True)
    if not closure < 5.0:
        fail(f"headline closure {closure} % >= 5 %")
    if not dpos <= POS_TOL["fisheye"]:
        fail(f"headline kernel disagrees with its plain version: {dpos}")
    return {"fisheye_op1": (med * 1e3, plain_ms)}


class MainRun(NamedTuple):
    """One scenario run of the main path: its inputs and fast_trace's result."""

    scen: Any
    op: str
    ds: float
    steps: int
    stats: bool
    pos0: Any
    theta0: Any
    res: Any


def phase_scenarios(device, rays=RAYS_MAIN):
    """The four scenarios through fast_trace, each held to its oracle;
    returns {scenario: MainRun}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.engine import oracles

    runs = {}

    def run(name, op, ds, steps, stats):
        scen = rtt.scenario(name)
        pos0, theta0 = fan(scen, rays)
        med = rtt.analytic_medium(scen.field)
        t0 = time.perf_counter()
        res = rtt.fast_trace(op, scen, med, delta_s=ds, pos0=pos0,
                             theta0=theta0, steps=steps, stats=stats,
                             device=device)
        sync()
        secs = time.perf_counter() - t0
        print(f"[scenario] {name} {op} engine={res.engine} {rays} rays x "
              f"{steps} steps in {secs:.3f} s", flush=True)
        runs[name] = MainRun(scen, op, ds, steps, stats, pos0, theta0, res)
        return scen, res

    # interface op6 at SIGMA/5.0: rays exit at different steps
    ds = config.SIGMA / 5.0
    steps = rtt.scenario("interface").max_size(ds) - 1
    scen, res = run("interface", "op6", ds, steps, False)
    errs_deg = oracles.snell_errors_from_tangent(res.tangent, scen.theta0)
    print(f"  interface Snell error mean {errs_deg.mean():.4f} deg (bar < 0.2)"
          f" max {errs_deg.max():.4f} deg (bar < 0.8)", flush=True)
    if not (errs_deg.mean() < 0.2 and errs_deg.max() < 0.8):
        fail("interface Snell oracle")

    # fisheye op6, divisor 179, ten turns (reference step semantics)
    div = 179
    ds = 2.0 * math.pi / div
    steps = rtt.scenario("fisheye").max_size(ds, div + 1, 10) - 1
    scen, res = run("fisheye", "op6", ds, steps, False)
    closure = float(100.0 * torch.linalg.vector_norm(
        res.pos[0] - torch.tensor([1.0, 0.0], device=device)) / (2 * math.pi))
    print(f"  fisheye ten-turn closure {closure:.4f} % (bar < 5)", flush=True)
    if not closure < 5.0:
        fail("fisheye closure oracle")

    # vert op8 at SIGMA/0.05 and aniso op11 at SIGMA/1.2: momentum CV
    for name, op, div in (("vert", "op8", 0.05), ("aniso", "op11", 1.2)):
        ds = config.SIGMA / div
        steps = rtt.scenario(name).max_size(ds) - 1
        scen, res = run(name, op, ds, steps, True)
        nf = len(scen.theta0)
        cv = oracles.momentum_cv_pct_from_welford(
            res.mom_count[:nf], res.mom_mean[:nf], res.mom_m2[:nf])
        avg = float(np.mean(cv[1:-1]))
        print(f"  {name} {op} momentum CV {avg:.6f} % (bar < 0.05)", flush=True)
        if not avg < 0.05:
            fail(f"{name} momentum CV oracle")
    return runs


def phase_main_shapes(device, errs, runs):
    """Each scenario's fast_trace result against the kernel's plain version
    on the same inputs, at the full shape and step count; and the kernel's
    own time there, by direct launches made after the main path's counts
    were read.  Returns {kernel: (ms, plain_ms)} at :data:`TIMED_SHAPE`."""
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg

    times = {}
    print("[main-shapes] fast_trace against the plain version, same inputs",
          flush=True)
    for name, r in runs.items():
        field, box = r.scen.field, tuple(r.scen.box)
        if r.res.engine == "golden":
            kernel = "golden_step"
            it, pol = kg.golden_schedule()
            st = kg.initial_state(r.op, r.pos0, r.theta0, r.scen.gamma,
                                  field=field, with_stats=r.stats,
                                  device=device)
            scal = kg.golden_scalars(r.ds, r.scen.gamma, r.steps, 0.0, it,
                                     device=device)
            k_ms, _ = cuda_ms(lambda: kg.golden_step(
                st, scal, field=field, op=r.op, steps=r.steps, box=box),
                reps=3)
            p_ms, p = cuda_ms(lambda: kg.golden_step_plain(
                st, scal, field=field, op=r.op, steps=r.steps, box=box,
                iters=it, polish=pol))
            tol = dict(pos_tol=POS_TOL_GOLDEN, tt_abs=TT_ABS_TOL_GOLDEN)
        else:
            kernel = "fused_step"
            st = kfu.initial_state(r.op, r.pos0, r.theta0, field=field,
                                   with_stats=r.stats, device=device)
            kw = dict(field=field, op=r.op, steps=r.steps, delta_s=r.ds,
                      step_limit=r.steps, offset=0.0, box=box)
            k_ms, _ = cuda_ms(lambda: kfu.fused_step(st, **kw), reps=3)
            p_ms, p = cuda_ms(lambda: kfu.fused_step_plain(st, **kw))
            tol = dict(pos_tol=POS_TOL_OP7 if r.op == "op7" else POS_TOL[field],
                       tt_rel=TT_REL_TOL)
        rays = r.pos0.shape[0]
        errs[kernel].compare(
            f"{kernel} {name} {r.op} {rays} x {r.steps} steps",
            r.res.pos, torch.stack([p.x, p.y], -1), r.res.traveltime, p.tt,
            r.res.active, p.active, **tol)
        print(f"    kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms", flush=True)
        if TIMED_SHAPE[kernel] == name:
            times[kernel] = (k_ms, p_ms)
    return times


def main():
    name, _ = phase_environment()
    phase_build()
    from raytracing_tpu_torch.kernels import fisheye as kf
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg
    kernels = (kf.KERNEL, kfu.KERNEL, kg.KERNEL)

    errs = phase_kernel_vs_plain("cuda")
    # the main path: counts from zero, read as soon as it has run
    for k in kernels:
        k.launches = 0
    times = phase_headline("cuda", errs)
    runs = phase_scenarios("cuda")
    launches = {k.name: k.launches for k in kernels}
    print(f"[main-path] launches {launches}", flush=True)
    for k in kernels:
        if launches[k.name] <= 0:
            fail(f"{k.name} never launched on the main path")
    times.update(phase_main_shapes("cuda", errs, runs))

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": errs[k.name].pos, "ms": times[k.name][0],
         "plain_ms": times[k.name][1]} for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
