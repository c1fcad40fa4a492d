"""FMA-contraction probe: the CUDA kernels built with ``-fmad=false`` (the
build the package uses) against ``-fmad=true``, at the main path's shapes.

    python -m raytracing_tpu_torch.bench.fma_probe [--reps 5] [--profile PATH]

Needs one CUDA device and nvcc.  Builds the library both ways, then makes
four passes in the order off, on, on, off, so that a drift of the card's
clock shows as a difference between the two passes of one build.  Each pass
prints the card's name, power limit, SM clock, power draw and temperature,
then for every shape the median kernel time of ``--reps`` runs after one
warm-up (CUDA events, one run each) and the largest |delta| of the final
positions against the first ``-fmad=false`` pass.  The kernel wrappers
launch from ``build.library()``; the probe points it at each build in turn.

``--profile PATH`` also traces the main path with torch.profiler (interface
op6 at SIGMA/5.0 and aniso op11 at SIGMA/1.2 through ``fast_trace``, from
numpy launch fans, after one warm-up), writes the Chrome trace to PATH and
prints the device time of each kernel and copy.
"""
from __future__ import annotations

import argparse
import math
import statistics
import subprocess

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.bench import launch_fan
from raytracing_tpu_torch.config import scenario
from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels import fisheye as kf
from raytracing_tpu_torch.kernels import fused as kfu
from raytracing_tpu_torch.kernels import golden as kg

RAYS = 1 << 20
SMI_QUERY = "name,power.limit,clocks.sm,power.draw,temperature.gpu"


def fmad_flags(fmad: bool):
    """The package's nvcc flags with FMA contraction set to ``fmad``."""
    want = f"-fmad={'true' if fmad else 'false'}"
    return tuple(want if f.startswith("-fmad=") else f
                 for f in build.NVCC_FLAGS)


def _fused_case(name, op, ds, steps, device, rays):
    scen = scenario(name)
    st = kfu.initial_state(op, *launch_fan(scen, rays), field=scen.field,
                           with_stats=False, device=device)
    kw = dict(field=scen.field, op=op, steps=steps, delta_s=ds,
              step_limit=steps, offset=0.0, box=tuple(scen.box))

    def run():
        out = kfu.fused_step(st, **kw)
        return torch.stack([out.x, out.y], -1)
    return f"fused {op} {name}, {steps} steps", run


def _golden_case(name, op, ds, steps, device, rays):
    scen = scenario(name)
    st = kg.initial_state(op, *launch_fan(scen, rays), scen.gamma,
                          field=scen.field, with_stats=True, device=device)
    it, _ = kg.golden_schedule()
    scal = kg.golden_scalars(ds, scen.gamma, steps, 0.0, it, device=device)

    def run():
        out = kg.golden_step(st, scal, field=scen.field, op=op, steps=steps,
                             box=scen.box)
        return torch.stack([out.x, out.y], -1)
    return f"golden {op} {name}, {steps} steps", run


def cases(device, rays=RAYS):
    """(label, run) at the main path's shapes; run returns final positions."""
    div = 4587
    ds_h = float(np.float32(2.0 * math.pi / div))
    x = torch.ones(rays, device=device)
    y = torch.zeros(rays, device=device)
    th = torch.full((rays,), math.pi / 2.0, device=device)
    ux, uy = torch.cos(th), torch.sin(th)

    def headline():
        fx, fy, _ = kf.fisheye_op1(x, y, ux, uy, ds_h, div)
        return torch.stack([fx, fy], -1)

    ds_f = 2.0 * math.pi / 179
    steps_f = scenario("fisheye").max_size(ds_f, 180, 10) - 1
    ds_i = config.SIGMA / 5.0
    ds_a = config.SIGMA / 1.2
    return [
        (f"fisheye_op1 headline, {div} steps", headline),
        _fused_case("fisheye", "op6", ds_f, steps_f, device, rays),
        _fused_case("interface", "op6", ds_i,
                    scenario("interface").max_size(ds_i) - 1, device, rays),
        _golden_case("aniso", "op11", ds_a,
                     scenario("aniso").max_size(ds_a) - 1, device, rays),
        _golden_case("fisheye", "op11", ds_f, steps_f, device, rays),
    ]


def time_ms(run, reps):
    """Per-run CUDA-event times (ms) after one warm-up, and the last output."""
    out = run()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def probe(device, reps):
    libs = {}
    for fmad in (False, True):
        libs[fmad] = build.load(build.build(fmad_flags(fmad)))
    shapes = cases(device)
    ref = {}
    for p, fmad in enumerate((False, True, True, False)):
        build.library = lambda lib=libs[fmad]: lib
        print(smi(), flush=True)
        for label, run in shapes:
            times, pos = time_ms(run, reps)
            ref.setdefault(label, pos)
            dev = float((pos - ref[label]).abs().max())
            print(f"pass {p} fmad={fmad} {label}: median "
                  f"{statistics.median(times):.3f} ms runs "
                  f"{[round(t, 3) for t in times]} max|d vs fmad=false| "
                  f"{dev:.3e}", flush=True)


def profile_main_path(device, path):
    from torch.profiler import ProfilerActivity, profile

    import raytracing_tpu_torch as rtt

    def main_path():
        for name, op, div, stats in (("interface", "op6", 5.0, False),
                                     ("aniso", "op11", 1.2, True)):
            scen = rtt.scenario(name)
            pos0, theta0 = launch_fan(scen, RAYS)
            ds = config.SIGMA / div
            rtt.fast_trace(op, scen, rtt.analytic_medium(scen.field),
                           delta_s=ds, pos0=pos0, theta0=theta0,
                           steps=scen.max_size(ds) - 1, stats=stats,
                           device=device)
        torch.cuda.synchronize()

    main_path()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        main_path()
    prof.export_chrome_trace(path)
    # device events only: a host op's row repeats the time of what it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows)
    print(f"main path device time {total / 1e3:.3f} ms", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100.0 * e.self_device_time_total / total:5.1f} % "
              f"x{e.count} {e.key}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", metavar="PATH",
                    help="also trace the main path to this Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fma_probe: needs a CUDA device")
    probe("cuda", args.reps)   # ends on the -fmad=false build
    if args.profile:
        profile_main_path("cuda", args.profile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
