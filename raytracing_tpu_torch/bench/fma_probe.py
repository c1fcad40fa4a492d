"""Build probes of the CUDA kernels at the main paths' shapes, and profiles
of the main paths.

    python -m raytracing_tpu_torch.bench.fma_probe [--reps 5]
        [--parent-csrc DIR] [--profile PATH] [--profile-sampled PATH]
    python -m raytracing_tpu_torch.bench.fma_probe --sass [PATTERN]
        [--parent-csrc DIR]

Needs one CUDA device and nvcc.  By default it compares the build the
package uses (``-fmad=false``) with ``-fmad=true``; with ``--parent-csrc``
it compares instead the kernels built from another checkout's ``csrc``
(e.g. the parent commit's, unpacked by ``git archive``) with this one's,
both with the package's flags, on the analytic, sampled, df32, dynamic
and 3-D entry points they share (SHARED_ENTRIES; a parent built before the
refill loop of ``fused_step`` and ``fused_step_strat`` is called without
its counter).
Either way it makes four passes in the order A, B, B, A, so that a drift
of the card's clock shows as a difference between the two passes of one
build.  Each pass prints the card's name, power limit, SM clock, power
draw and temperature, then for every shape the median kernel time of
``--reps`` runs after one warm-up (CUDA events around one run each; a run
shorter than ``BATCH_BELOW_MS`` is timed as a batch of launches captured
in one CUDA graph, its time a replay's over its count, so that neither
the events' own cost nor the wrapper's host work between launches swamps
it) and the largest
|delta| of the final positions against the first pass.  The kernel
wrappers launch from ``build.library()``; the probe points it at each
build in turn.  The shapes are the analytic main path's (among them the
76-step vert op8 run, timed from a graph), the fused kernels' on sampled
media (:func:`sampled_cases`: interface_strat op6, vert_strat op8,
fisheye_grid op1 and its node table), the df32 tier's (:func:`df_cases`:
the four df kernels at their main shapes, and the two grid kernels on a
dispersed fan) and the dynamic and 3-D tiers' (:func:`dynamic_cases`: the
2-D dynamic kernels at chip_smoke.py's dynamic main shapes, fisheye_grid
op6 on the parity and C1 grids (PERF.md row 8), the fisheye (row 11) and
vert_strat (row 12); the 3-D dynamic kernels on the benchmark's identical
rays ``dyn3_op6`` and the tilted fan, JAX's vert op8 and interface op6
launches (row 15), the 71^3 grid3 table on the identical, tilted and
dispersed fans (row 14d); and fused3d_step_grid on the tilted and
dispersed fans (row 14k)).

``--profile PATH`` also traces the analytic main path with torch.profiler
(interface op6 at SIGMA/5.0 and aniso op11 at SIGMA/1.2 through
``fast_trace``, from numpy launch fans, after one warm-up), writes the
Chrome trace to PATH and prints the device time of each kernel and copy.
``--profile-sampled PATH`` does the same for the sampled main path (the
seven runs of chip_smoke.py's sampled phase through ``fast_trace``, media
built on the card beforehand), and prints the wall time of the traced
window and the share of it in which the card was idle.

``--sass [PATTERN]`` only builds the package's library and reports, for
every kernel whose mangled name contains PATTERN (default ``df_kernel``;
``fused_kernel`` gives every instantiation of the 2-D fused loop, one ray
a thread and the refill loop's ``fused_kernel_refill``; ``dynamic`` the
2-D and 3-D dynamic loops), its registers and spill bytes from ptxas
(``-Xptxas -v``, the build's log), its count of SASS instructions, of FFMA
(fused multiply-add) instructions among them, of F2I, I2F, LDG, MUFU,
FCHK (the IEEE division's range check, whose failure calls the slow
path), CALL and BSSY (a convergence barrier) (``cuobjdump -sass``), the
instructions one iteration of its step loop issues on the usual path
(:func:`loop_path`: the slow branches of divisions and square roots
skipped; the 2-D dynamic loop is unrolled by two, so an iteration is two
steps) and its most frequent opcodes; with ``--parent-csrc`` it reports
the parent's build first;
each FFMA line is written with the instructions before it to
``sass-ffma-<digest>.txt`` beside the library in ``_build/``, so that what
issues it (an exact product, the IEEE division's refinement, or a
contraction) can be read.  Run it in another checkout (e.g. the parent's,
unpacked by ``git archive``) for that checkout's counts.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import math
import re
import shutil
import statistics
import subprocess

import numpy as np
import torch

import time
from pathlib import Path

from raytracing_tpu_torch import config
from raytracing_tpu_torch.bench import (DF_PROFILE_STEPS, DF_VERT_STEPS,
                                        HEADLINE_DIVISOR, df_launch, df_media,
                                        df_state, dispersed_fan, launch_fan)
from raytracing_tpu_torch.config import scenario
from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels import df as kdf
from raytracing_tpu_torch.kernels import fisheye as kf
from raytracing_tpu_torch.kernels import fused as kfu
from raytracing_tpu_torch.kernels import golden as kg

RAYS = 1 << 20
SMI_QUERY = "name,power.limit,clocks.sm,power.draw,temperature.gpu"
#: the entry points the probe's shapes launch, which a parent checkout's
#: library shares
SHARED_ENTRIES = ("rt_fisheye_op1", "rt_fused_step", "rt_golden_step",
                  "rt_fused_step_strat", "rt_fused_step_grid",
                  "rt_fused_step_nodes", "rt_df_step", "rt_df_step_grid",
                  "rt_df_step_c1", "rt_df_step_profile", "rt_dynamic_step",
                  "rt_dynamic_step_strat", "rt_dynamic_step_grid",
                  "rt_fused3d_step_grid", "rt_dynamic3d_step",
                  "rt_dynamic3d_step_grid")
#: a run shorter than this (ms) is timed from a CUDA graph of launches
BATCH_BELOW_MS = 2.0
#: the entry points that take the refill loop's ray counter before the
#: stream; a parent built before the loop takes none
COUNTER_ENTRIES = ("rt_fused_step", "rt_fused_step_strat")
#: the depths of the df32 main path's runs (chip_smoke.py phase 14)
DF_STEPS = {"fisheye": HEADLINE_DIVISOR - 1,
            "vert_heterogeneous": DF_VERT_STEPS,
            "grid": HEADLINE_DIVISOR - 1, "c1": HEADLINE_DIVISOR - 1,
            "profile": DF_PROFILE_STEPS}


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


def sampled_cases(device, rays=RAYS):
    """(label, run) of the fused kernels on sampled media at their main
    shapes: fused_step_strat on the interface_strat run (the parity table,
    the reference table's op6 step, 3854 steps) and on the vert_strat run
    (op8 with the Welford stats, 4142 steps), fused_step_grid on the
    fisheye_grid run (op1, 4586 steps) and fused_step_nodes on the same
    grid's node table (grid_trace's kernel).  The media are built once, on
    ``device``."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine import segmented as seg

    def case(label, name, op, field, stats=False):
        scen = scenario(name)
        ds, div = calibrated_with_fallback(op, name)
        steps = scen.max_size(ds, div, 1) - 1
        st = kfu.initial_state(op, *launch_fan(scen, rays), field=field,
                               with_stats=stats, device=device)
        kw = dict(field=field, op=op, steps=steps, delta_s=float(ds),
                  step_limit=steps, offset=0.0, box=tuple(scen.box))

        def run():
            out = kfu.fused_step(st, **kw)
            return torch.stack([out.x, out.y], -1)
        return f"{label} {op} {name}, {steps} steps", run

    def strat(name, field, op):
        box = scenario(name).box
        ds, _ = calibrated_with_fallback(op, name)
        return kfu.strat_tables(rtt.compact_for_trace(
            rtt.build_stratified_medium(field, box, device=device), box, ds))

    fish = scenario("fisheye")
    grid = fast._as_hermite(rtt.build_grid_medium("fisheye", fish.box,
                                                  device=device))
    return [case("fused_step_strat", "interface", "op6",
                 strat("interface", "interface", "op6")),
            case("fused_step_strat", "vert", "op8",
                 strat("vert", "vert_heterogeneous", "op8"), stats=True),
            case("fused_step_grid", "fisheye", "op1", seg.grid_tables(grid)),
            case("fused_step_nodes", "fisheye", "op1", seg.node_tables(grid))]


def df_cases(device, rays=RAYS):
    """(label, run) of the df32 kernels at the df32 main path's shapes: the
    fisheye, parity grid and C1 grid on the headline's fan with +-1e-3 rad
    of jitter (numpy seed 0) for one turn, vert and the Munk profile; then
    the two grids on a dispersed fan (launch points over the grid, uniform
    angles, seed 5).  The media are built once, on ``device``."""
    import raytracing_tpu_torch as rtt

    media = df_media(device)
    rng = np.random.default_rng(0)

    def case(label, kind, pos0, theta0, ds):
        medium, steps = media.get(kind, kind), DF_STEPS[kind]
        st = df_state(kind, pos0, theta0, device)
        name = medium.KERNEL.name if kind in media else kdf.KERNEL.name

        def run():
            return kdf.df_positions(kdf.df_step(st, medium, ds, steps))
        return f"{name} {label}, {rays} x {steps} steps", run

    labels = {"fisheye": "fisheye jittered fan", "grid": "jittered fan",
              "c1": "jittered fan", "vert_heterogeneous": "vert",
              "profile": "Munk profile"}
    out = [case(label, kind, *df_launch(kind, rays, rng))
           for kind, label in labels.items()]
    pos0, theta0 = dispersed_fan(rtt.scenario("fisheye").box, rays,
                                 np.random.default_rng(5))
    ds = float(np.float32(2.0 * math.pi / HEADLINE_DIVISOR))
    out += [case("dispersed fan", kind, pos0, theta0, ds)
            for kind in ("grid", "c1")]
    return out


def dynamic_cases(device, rays=RAYS):
    """(label, run) of the dynamic and 3-D kernels at their main shapes (the
    module docstring lists them); the media are built once, on ``device``,
    the tables as fast_dynamic and fast_dynamic3 make them."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import (fan3, fan3_dyn, grid3_medium,
                                            jittered, sampled_media)
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine import segmented as seg
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    from raytracing_tpu_torch.kernels import dynamic as kd
    from raytracing_tpu_torch.kernels import dynamic3d as kd3
    from raytracing_tpu_torch.kernels import fused3d as kf3

    media = sampled_media(device)
    fish, vert = scenario("fisheye"), scenario("vert")
    fpos, fth = launch_fan(fish, rays)
    fth = jittered(fth, np.random.default_rng(0))
    fds = float(np.float32(2.0 * math.pi / HEADLINE_DIVISOR))
    vth = np.random.default_rng(0).uniform(0.05, 1.5, rays).astype(
        np.float32)
    vds = float(np.float32(0.0193))

    def case2(label, field, pos0, theta0, ds, steps, box):
        st = kd.initial_dyn_state(pos0, theta0, device=device)
        kw = dict(field=field, op="op6", steps=steps, delta_s=ds,
                  step_limit=steps, offset=0.0, box=tuple(box))

        def run():
            out = kd.dynamic_step(st, **kw)
            return torch.stack([out.x, out.y], -1)
        return f"{label} op6, {steps} steps", run

    def grid(kind):
        med = media[(kind, "fisheye")]
        return seg.grid_tables(fast._as_hermite(med)
                               if kind == "grid" else med)

    vtab = kfu.strat_tables(rtt.compact_for_trace(media[("strat", "vert")],
                                                  vert.box, vds))
    out = [case2("dynamic_step_grid fisheye_grid", grid("grid"), fpos, fth,
                 fds, HEADLINE_DIVISOR - 1, fish.box),
           case2("dynamic_step_grid fisheye_c1_grid", grid("c1_grid"), fpos,
                 fth, fds, HEADLINE_DIVISOR - 1, fish.box),
           case2("dynamic_step fisheye", "fisheye", fpos, fth, fds,
                 HEADLINE_DIVISOR, fish.box),
           case2("dynamic_step_strat vert_strat", vtab,
                 np.full((rays, 2), -2.0, np.float32), vth, vds, 2000,
                 vert.box)]
    g3 = grid3_tables(grid3_medium(device))

    def case3(label, kernel, field, op, fan):
        pos0, dir0, ds, steps, box = fan
        init, step = ((kd3.initial_dyn3_state, kd3.dynamic3d_step)
                      if kernel == "dyn"
                      else (kf3.initial_state3, kf3.fused3d_step))
        st = init(pos0, dir0, device=device)
        kw = dict(field=field, op=op, steps=steps, delta_s=ds,
                  step_limit=steps, offset=0.0, box=box)

        def run():
            o = step(st, **kw)
            return torch.stack([o.x, o.y, o.z], -1)
        return f"{label} {op}, {steps} steps", run

    out += [case3("dynamic3d_step dyn3_op6", "dyn", "fisheye", "op6",
                  fan3_dyn("matrix", rays, 0)),
            case3("dynamic3d_step fisheye tilted", "dyn", "fisheye", "op6",
                  fan3_dyn("tilted", rays, 0)),
            case3("dynamic3d_step vert", "dyn", "vert_heterogeneous", "op8",
                  fan3_dyn("vert", rays, 1)),
            case3("dynamic3d_step interface", "dyn", "interface", "op6",
                  fan3_dyn("interface", rays, 2)),
            case3("dynamic3d_step_grid dyn3_tiled_op6", "dyn", g3, "op6",
                  fan3_dyn("matrix", rays, 0)),
            case3("dynamic3d_step_grid tilted", "dyn", g3, "op6",
                  fan3_dyn("tilted", rays, 0)),
            case3("dynamic3d_step_grid dispersed", "dyn", g3, "op6",
                  fan3_dyn("dispersed", rays, 3)),
            case3("fused3d_step_grid tilted", "fused", g3, "op6",
                  fan3("tilted", rays, 0)),
            case3("fused3d_step_grid dispersed", "fused", g3, "op6",
                  fan3("dispersed", rays, 3))]
    return out


def cases(device, rays=RAYS):
    """(label, run) at the main paths' shapes; run returns final positions."""
    div = HEADLINE_DIVISOR
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
    ds_v = config.SIGMA / 0.05
    ds_a = config.SIGMA / 1.2
    return [
        (f"fisheye_op1 headline, {div} steps", headline),
        _fused_case("fisheye", "op6", ds_f, steps_f, device, rays),
        _fused_case("interface", "op6", ds_i,
                    scenario("interface").max_size(ds_i) - 1, device, rays),
        _fused_case("vert", "op8", ds_v,
                    scenario("vert").max_size(ds_v) - 1, device, rays),
        _golden_case("aniso", "op11", ds_a,
                     scenario("aniso").max_size(ds_a) - 1, device, rays),
        _golden_case("fisheye", "op11", ds_f, steps_f, device, rays),
    ] + sampled_cases(device, rays) + df_cases(device, rays) + \
        dynamic_cases(device, rays)


def time_ms(run, reps):
    """Per-run CUDA-event times (ms) after one warm-up, the last output and
    the batch: a run shorter than BATCH_BELOW_MS is timed again as
    ``batch`` launches captured in one CUDA graph, each time a replay's over
    its count.  Launched one by one, such a run's launches are spaced by
    the wrapper's host work, which the events would time instead; a
    replay issues them back to back."""
    def timed(fn, k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / k, res

    out = run()
    times = []
    for _ in range(reps):
        ms, out = timed(run, 1)
        times.append(ms)
    if statistics.median(times) >= BATCH_BELOW_MS:
        return times, out, 1
    batch = max(2, math.ceil(BATCH_BELOW_MS / statistics.median(times)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                    # warm-up: lazy initialisation off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            last = run()
    graph.replay()
    times = [timed(graph.replay, batch)[0] for _ in range(reps)]
    return times, last.clone(), batch


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class ParentLibrary:
    """A parent checkout's library as the wrappers call it: the entry points
    of COUNTER_ENTRIES are called without the counter that the wrapper
    passes before the stream."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in COUNTER_ENTRIES:
            return fn
        return lambda *args: fn(*args[:-2], args[-1])


def load_parent(path):
    """The parent's library; where it has no refill loop (no
    ``rt_fused_refill_blocks``), its COUNTER_ENTRIES take this checkout's
    arguments less the counter."""
    lib = build.load(path, tuple(n for n in SHARED_ENTRIES
                                 if n not in COUNTER_ENTRIES))
    if hasattr(lib, "rt_fused_refill_blocks"):
        return build.load(path, SHARED_ENTRIES)
    for name in COUNTER_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(build._SIGNATURES[name][:-2]) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return ParentLibrary(lib)


def probe(device, reps, builds):
    """Four passes over the shapes, in the order A, B, B, A of the two
    ``(label, library)`` builds."""
    shapes = cases(device)
    ref = {}
    (la, liba), (lb, libb) = builds
    for p, (label_b, lib) in enumerate(((la, liba), (lb, libb), (lb, libb),
                                        (la, liba))):
        build.library = lambda lib=lib: lib
        print(smi(), flush=True)
        for label, run in shapes:
            times, pos, batch = time_ms(run, reps)
            ref.setdefault(label, pos)
            dev = float((pos - ref[label]).abs().max())
            each = ("" if batch == 1
                    else f" (graphs of {batch} launches)")
            print(f"pass {p} {label_b} {label}: median "
                  f"{statistics.median(times):.3f} ms runs "
                  f"{[round(t, 3) for t in times]}{each} max|d vs {la}| "
                  f"{dev:.3e}", flush=True)


def traced(main_path, path, wall=False):
    """Trace ``main_path`` (after one warm-up) with torch.profiler, write the
    Chrome trace to ``path`` and print the device time of each kernel and
    copy; with ``wall``, also the traced window's wall time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    main_path()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main_path()
        secs = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    # device events only: a host op's row repeats the time of what it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows)
    print(f"main path device time {total / 1e3:.3f} ms", flush=True)
    if wall:
        print(f"main path wall time {secs * 1e3:.3f} ms (host clock, "
              f"synchronized), device idle {100.0 * (1 - total / 1e6 / secs):.1f}"
              " % of it", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100.0 * e.self_device_time_total / total:5.1f} % "
              f"x{e.count} {e.key}", flush=True)


def profile_main_path(device, path):
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

    traced(main_path, path)


def profile_sampled_path(device, path):
    """The sampled main path of chip_smoke.py: its seven runs through
    fast_trace on media built on the card before the trace."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import SAMPLED_RUNS, sampled_media
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback

    media = sampled_media(device)

    def main_path():
        for _, name, kind, op in SAMPLED_RUNS:
            scen = scenario(name)
            ds, div = calibrated_with_fallback(op, name)
            pos0, theta0 = launch_fan(scen, RAYS)
            rtt.fast_trace(op, scen, media[(kind, name)], delta_s=ds,
                           pos0=pos0, theta0=theta0,
                           steps=scen.max_size(ds, div, 1) - 1,
                           stats=name in ("vert", "aniso"), device=device)
        torch.cuda.synchronize()

    traced(main_path, path, wall=True)


def _demangle(names):
    tool = shutil.which("cu++filt") or str(
        Path(build._nvcc()).parent / "cu++filt")
    try:
        out = subprocess.run([tool, *names], capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def _opcode(line):
    """The opcode of one SASS instruction line, without its predicate and
    modifiers."""
    text = re.split(r"/\*[0-9a-f]{4,}\*/", line, maxsplit=1)[1].split()
    return text[text[0].startswith("@")].split(".", 1)[0].rstrip(";")


_TARGET = re.compile(r"0x([0-9a-f]+)")


def loop_path(code):
    """The instructions, by opcode, that one iteration of a kernel's longest
    loop issues on its usual path; None for a kernel without a loop.
    ``code`` is the kernel's (address, instruction) pairs.  The loop runs
    from the target of its longest backward branch to that branch; a
    forward conditional branch over code that calls a subroutine (the slow
    path of an IEEE division or square root, or of a guarded group of
    quotients) is taken, any other is not."""
    back = [(int(m.group(1), 16), addr) for addr, text in code
            if _opcode(text) == "BRA" and (m := _TARGET.search(text))
            and int(m.group(1), 16) < addr]
    if not back:
        return None
    head, tail = max(back, key=lambda b: b[1] - b[0])
    body = [(addr, text) for addr, text in code if head <= addr <= tail]
    at = {addr: k for k, (addr, _) in enumerate(body)}
    path, k = collections.Counter(), 0
    while k < len(body):
        addr, text = body[k]
        op = _opcode(text)
        path[op] += 1
        if addr == tail:
            break
        m = _TARGET.search(text) if op == "BRA" else None
        j = at.get(int(m.group(1), 16)) if m else None
        if j is not None and j > k and (
                not text.split("*/", 1)[1].lstrip().startswith("@")
                or any(_opcode(t) == "CALL" for _, t in body[k + 1:j])):
            k = j
            continue
        k += 1
    return path


def sass_report(pattern: str, csrc=build.CSRC) -> None:
    """Registers, spills, SASS instructions, FFMAs, opcodes and the loop's
    path of each kernel whose mangled name contains ``pattern``, built from
    ``csrc`` (module docstring)."""
    lib = build.build(csrc=csrc)
    digest = build.source_digest(csrc=csrc)
    log = (build.BUILD_DIR / f"ptxas-{digest}.log").read_text()
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "spill" in line):
            usage.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, ops, fn, recent, ffma_lines = {}, {}, None, [], []
    code = collections.defaultdict(list)
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn, recent = m.group(1), []
            counts[fn] = [0, 0]
            ops[fn] = collections.Counter()
            continue
        where = re.search(r"/\*([0-9a-f]{4,})\*/", line)
        if fn is None or not where:
            continue
        op = _opcode(line)
        counts[fn][0] += 1
        ops[fn][op] += 1
        code[fn].append((int(where.group(1), 16), line.split(";", 1)[0]))
        if op == "FFMA" and pattern in fn:
            counts[fn][1] += 1
            ffma_lines.append(f"{fn}\n" + "\n".join(recent[-6:] + [line]))
        recent.append(line.strip())
    names = sorted(n for n in set(counts) | set(usage) if pattern in n)
    print(f"[sass] {lib.name} from {csrc}: {len(names)} kernels matching "
          f"{pattern!r}", flush=True)
    for name, pretty in zip(names, _demangle(names)):
        instr, ffma = counts.get(name, [0, 0])
        top = ", ".join(f"{o} {c}" for o, c in ops.get(
            name, collections.Counter()).most_common(14))
        slow = ops.get(name, collections.Counter())
        named = ("F2I", "I2F", "I2FP", "LDG", "MUFU", "FCHK", "CALL", "BSSY")
        path = loop_path(code.get(name, []))
        loop = "no loop" if path is None else (
            f"loop path {sum(path.values())} instructions an iteration ("
            + ", ".join(f"{o} {path[o]}" for o in named if path[o]) + ")")
        print(f"  {pretty}: {' | '.join(usage.get(name, ['no ptxas line']))}"
              f"; {instr} SASS instructions, {ffma} FFMA, "
              + ", ".join(f"{slow[o]} {o}" for o in named)
              + f"; {loop}; opcodes: {top}", flush=True)
    (build.BUILD_DIR / f"sass-ffma-{digest}.txt").write_text(
        "\n\n".join(ffma_lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent-csrc", metavar="DIR", type=Path,
                    help="compare the kernels built from this csrc instead "
                         "of -fmad=true")
    ap.add_argument("--profile", metavar="PATH",
                    help="also trace the analytic main path to this trace")
    ap.add_argument("--profile-sampled", metavar="PATH",
                    help="also trace the sampled main path to this trace")
    ap.add_argument("--sass", metavar="PATTERN", nargs="?",
                    const="df_kernel",
                    help="only report registers, spills and FFMAs of the "
                         "kernels whose name contains PATTERN")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fma_probe: needs a CUDA device")
    if args.sass:
        if args.parent_csrc is not None:
            sass_report(args.sass, csrc=args.parent_csrc)
        sass_report(args.sass)
        return 0
    own = ("fmad=false", build.load(build.build()))
    if args.parent_csrc is not None:
        other = ("parent", load_parent(build.build(csrc=args.parent_csrc)))
        probe("cuda", args.reps, (other, ("change", own[1])))
    else:
        probe("cuda", args.reps,
              (own, ("fmad=true", build.load(build.build(fmad_flags(True))))))
    build.library = lambda: own[1]
    if args.profile:
        profile_main_path("cuda", args.profile)
    if args.profile_sampled:
        profile_sampled_path("cuda", args.profile_sampled)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
