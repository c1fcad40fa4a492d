"""Build probes of the CUDA kernels at the main paths' shapes, and profiles
of the main paths.

    python -m raytracing_tpu_torch.bench.fma_probe [--reps 5]
        [--parent-csrc DIR] [--cases LABEL[,...]] [--profile PATH]
        [--profile-sampled PATH]
    python -m raytracing_tpu_torch.bench.fma_probe --sass [PATTERN[,...]]
        [--parent-csrc DIR]

Needs one CUDA device and nvcc.  By default it compares the build the
package uses (``-fmad=false``) with ``-fmad=true``; with ``--parent-csrc``
it compares instead the kernels built from another checkout's ``csrc``
(e.g. the parent commit's, unpacked by ``git archive``) with this one's,
both with the package's flags, on the analytic, sampled, df32, dynamic
and 3-D entry points they share (SHARED_ENTRIES; a parent built before the
refill loop of ``fused_step`` and ``fused_step_strat``, or of the golden
loop, is called without its counter: COUNTER_ENTRIES), and on the
generated libraries of rows 2c and 3c (:func:`custom_library`: the
fisheye's op6 loop and vert's golden op11 loop on custom media,
emitted by each checkout's own ``kernels/custom.py`` where the other
checkout has one beside its ``csrc``, and built against that checkout's
headers).
Either way it makes four passes in the order A, B, B, A, so that a drift
of the card's clock shows as a difference between the two passes of one
build.  Each pass prints the card's name, power limit, SM clock, power
draw and temperature, then for every shape the median kernel time of
``--reps`` runs after one warm-up (CUDA events around one run each; a run
shorter than ``BATCH_BELOW_MS`` is timed as a batch of launches captured
in one CUDA graph, its time a replay's over its count, so that neither
the events' own cost nor the wrapper's host work between launches swamps
it) and the largest
|delta| of the final positions against the first pass; ``--cases`` keeps
the shapes whose label contains one of the strings given.  The kernel
wrappers launch from ``build.library()``; the probe points it at each
build in turn.  The shapes are the analytic main path's (among them the
76-step vert op8 run, timed from a graph), row 2c's (:func:`custom_cases`:
``fused_step_custom`` on chip_smoke.py's ``[custom]`` fisheye fan, 2^20 x
4586, and the analytic ``fused_step`` on the same fan), the golden
kernels' beyond the analytic aniso and fisheye op11 runs
(:func:`golden_cases`:
golden_step_strat on the golden_strat_op11 run, row 3s, and
golden_step_custom on aniso op11 through vert's field as a
``CustomMedium``, row 3c, both with the Welford tracker; ``--cases
golden`` keeps rows 3, 3s, 3c and 5g), the fused kernels' on sampled
media (:func:`sampled_cases`: interface_strat op6, vert_strat op8, and
on the parity fisheye grid, labelled ``fisheye_grid``, op1 on its cells
and its node table, tiled_grid_op5's golden run and the search's
candidate sweep), the df32 tier's (:func:`df_cases`:
the four df kernels at their main shapes, and the two grid kernels on a
dispersed fan) and the dynamic and 3-D tiers' (:func:`dynamic_cases`: the
2-D dynamic kernels at chip_smoke.py's dynamic main shapes, fisheye_grid
op6 on the parity and C1 grids (PERF.md row 8), the fisheye (row 11) and
vert_strat (row 12); the 3-D dynamic kernels on the benchmark's identical
rays ``dyn3_op6`` and the tilted fan, JAX's vert op8 and interface op6
launches (row 15), the 71^3 grid3 table on the identical, tilted and
dispersed fans (row 14d); fused3d_step_grid on the tilted and dispersed
fans (row 14k, labelled ``grid3``) and fused3d_step on the tilted fisheye
fan (row 13, ``fisheye3``)).  ``--cases fisheye_grid,grid3`` keeps rows
5, 6, 7, 8 and 14k; ``--cases "dynamic_step fisheye"`` row 11 alone,
``--cases fisheye3`` row 13 alone, ``--cases dynamic_step`` rows 8, 11
and 12.

``--profile PATH`` also traces the analytic main path with torch.profiler
(interface op6 at SIGMA/5.0 and aniso op11 at SIGMA/1.2 through
``fast_trace``, from numpy launch fans, after one warm-up), writes the
Chrome trace to PATH and prints the device time of each kernel and copy.
``--profile-sampled PATH`` does the same for the sampled main path (the
seven runs of chip_smoke.py's sampled phase through ``fast_trace``, media
built on the card beforehand), and prints the wall time of the traced
window and the share of it in which the card was idle.

``--sass [PATTERN[,PATTERN...]]`` only builds the package's library and
the generated ones of rows 2c and 3c (:func:`custom_library`) and
reports, for every
kernel whose mangled name contains a PATTERN (default ``df_kernel``;
``fused_kernel`` gives every instantiation of the 2-D fused loop, one ray
a thread, the refill loop's ``fused_kernel_refill`` and the generated
``fused_kernel<Custom, 6>``; ``fisheye_op1`` the headline's loop;
``dynamic`` the 2-D and 3-D dynamic loops; ``golden_kernel`` the golden
loop one ray a thread and its refill form ``golden_kernel_refill``, the
generated row-3c loop among them), its registers and spill bytes
from ptxas (``-Xptxas -v``, the build's log), its count of SASS
instructions, of FFMA (fused multiply-add) instructions among them, of
F2I, I2F, LDG, MUFU, FCHK (the IEEE division's range check, whose failure
calls the slow path), CALL, BSSY (a convergence barrier) and MOV
(``cuobjdump -sass``), the instructions one iteration of its longest loop
issues on the usual path (:func:`loop_path`: the slow branches of
divisions, square roots and guarded fast paths skipped; the 2-D dynamic
and fused loops run two steps an iteration, the fisheye's four) and of
every loop no other loop holds (:func:`outer_loops`: fused_kernel's loops
with and without the Welford stats, fisheye_op1's for each traveltime
form), and its most frequent opcodes; with ``--parent-csrc`` it reports
the parent's builds first; each FFMA line is written with the
instructions before it to ``sass-ffma-<digest>.txt`` beside the library
in ``_build/``, so that what issues it (an exact product, the IEEE
division's refinement, or a contraction) can be read, and each loop's
path to ``sass-loop-<digest>.txt``; then, for each kernel both builds
hold, whether its SASS listing is the parent's, instruction for
instruction.
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
                                        df_state, dispersed_fan, jittered,
                                        launch_fan, sweep_inputs)
from raytracing_tpu_torch.config import scenario
from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels import custom
from raytracing_tpu_torch.kernels import df as kdf
from raytracing_tpu_torch.kernels import fisheye as kf
from raytracing_tpu_torch.kernels import fused as kfu
from raytracing_tpu_torch.kernels import golden as kg

RAYS = 1 << 20
SMI_QUERY = "name,power.limit,clocks.sm,power.draw,temperature.gpu"
#: the entry points the probe's shapes launch, which a parent checkout's
#: library shares
SHARED_ENTRIES = ("rt_fisheye_op1", "rt_fused_step", "rt_golden_step",
                  "rt_fused_step_strat", "rt_golden_step_strat",
                  "rt_fused_step_grid",
                  "rt_fused_step_nodes", "rt_golden_step_grid",
                  "rt_fused_sweep_grid", "rt_fused3d_step", "rt_df_step",
                  "rt_df_step_grid",
                  "rt_df_step_c1", "rt_df_step_profile", "rt_dynamic_step",
                  "rt_dynamic_step_strat", "rt_dynamic_step_grid",
                  "rt_fused3d_step_grid", "rt_dynamic3d_step",
                  "rt_dynamic3d_step_grid")
#: a run shorter than this (ms) is timed from a CUDA graph of launches
BATCH_BELOW_MS = 2.0
#: (label part, kernel as cu++filt names it, steps an iteration of its
#: loop): the instantiation a shape's run launches, whose loops'
#: instructions a step each pass prints beside the shape's time
#: (:func:`loop_steps`: every outermost loop, the step budget's search
#: among them); the first label part a shape's label contains picks it.
#: A kernel may be a tuple of names, where two builds name the loop apart
#: (the golden loop one ray a thread and in its refill form)
CASE_KERNELS = (
    ("golden_step_strat",
     ("golden_kernel<rt::Strat<(int)6>, (bool)0, (bool)0, (bool)0>",
      "golden_kernel_refill<rt::Strat<(int)6>, (bool)0, (bool)0, (bool)0>"),
     1),
    ("golden_step_custom",
     ("golden_kernel<rt::Custom, (bool)0, (bool)0, (bool)0>",
      "golden_kernel_refill<rt::Custom, (bool)0, (bool)0, (bool)0>"), 1),
    ("golden op11 aniso",
     ("golden_kernel<rt::Analytic<(int)1>, (bool)0, (bool)0, (bool)0>",
      "golden_kernel_refill<rt::Analytic<(int)1>, (bool)0, (bool)0, "
      "(bool)0>"), 1),
    ("fused_step_grid", "fused_kernel<rt::Grid<(int)36>, (int)1>", 1),
    ("fused_sweep_grid",
     ("fused_kernel<rt::Grid<(int)36>, (int)1>",
      "sweep_kernel<(int)36, (int)1>"), 1),
    ("fused_step_nodes", "fused_kernel<rt::Nodes, (int)1>", 1),
    ("golden_step_grid",
     "golden_kernel<rt::Grid<(int)36>, (bool)1, (bool)0, (bool)1>", 1),
    ("dynamic_step_grid fisheye_grid",
     "dynamic_kernel<rt::Grid<(int)36>, (int)6>", 2),
    ("dynamic_step_grid fisheye_c1_grid",
     "dynamic_kernel<rt::Grid<(int)16>, (int)6>", 2),
    ("dynamic_step fisheye", "dynamic_kernel<rt::Analytic<(int)0>, (int)6>",
     2),
    ("dynamic_step_strat vert_strat",
     ("dynamic_kernel<rt::Strat<(int)6>, (int)6>",
      "dynamic_kernel_refill<rt::Strat<(int)6>, (int)6>"), 2),
    ("fused3d_step_grid", "fused3d_kernel<rt3::Grid3, (int)6>", 1),
    ("fused3d_step fisheye3", "fused3d_kernel<rt3::Analytic3<(int)0>, (int)6>",
     1),
    ("df_step fisheye", "df_kernel<rt::df::DfAnalytic<(int)0>>", 1),
    ("df_step vert", "df_kernel<rt::df::DfAnalytic<(int)1>>", 1),
    ("df_step_grid", "df_kernel<rt::df::DfGrid>", 1),
    ("df_step_c1", "df_kernel<rt::df::DfC1>", 1),
    ("df_step_profile", "df_kernel<rt::df::DfProfile>", 1),
)
#: the entry points that take a refill loop's ray counter: {entry: (the
#: entry point whose presence marks a build with that counter, the
#: counter's place among the arguments)}; a parent built before that loop
#: takes none
COUNTER_ENTRIES = {
    "rt_fused_step": ("rt_fused_refill_blocks", -2),
    "rt_fused_step_strat": ("rt_fused_refill_blocks", -2),
    "rt_golden_step": ("rt_golden_refill_blocks", -2),
    "rt_golden_step_strat": ("rt_golden_refill_blocks", -9),
    "rt_golden_step_grid": ("rt_golden_refill_blocks", -9),
    "rt_golden_step_custom": ("rt_golden_refill_blocks", -2),
    "rt_dynamic_step_strat": ("rt_dynamic_refill_blocks", -2),
}
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


def custom_fisheye():
    """Row 2c's medium: the fisheye's ``1 / (1 + x^2 + y^2)`` as a
    ``CustomMedium`` (its gradient by dual numbers), as chip_smoke.py's
    ``[custom]`` phase writes it."""
    import raytracing_tpu_torch as rtt
    return rtt.CustomMedium(lambda x, y: 1.0 / (1.0 + x * x + y * y))


def custom_aniso():
    """Row 3c's medium: vert's ``1 / (18 + 2 y)`` as a ``CustomMedium``, as
    chip_smoke.py's ``[custom]`` phase writes it for the aniso run."""
    import raytracing_tpu_torch as rtt
    return rtt.CustomMedium(lambda x, y: 1.0 / (18.0 + 2.0 * y))


#: the generated libraries the probe builds: {family: (medium, op)}, row
#: 2c's fused op6 loop on the fisheye and row 3c's golden op11 loop on vert
CUSTOM_SPECS = {"fused": (custom_fisheye, "op6"),
                "golden": (custom_aniso, "op11")}


def _generator(csrc):
    """The custom-medium generator (kernels/custom.py) of the checkout whose
    ``csrc`` is given: this one's, or another checkout's own module where
    it has one beside its csrc (its emitted source calls only its own
    headers)."""
    other = Path(csrc).resolve().parent / "kernels" / "custom.py"
    if Path(csrc).resolve() == build.CSRC.resolve() or not other.exists():
        return custom
    import importlib.util
    import sys
    name = "raytracing_tpu_torch_parent_custom"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, other)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def custom_library(csrc=build.CSRC, family="fused"):
    """(library path, its entry point) of the ``family`` loop of
    :data:`CUSTOM_SPECS` (row 2c's or row 3c's), generated by ``csrc``'s
    checkout and built against its headers."""
    gen = _generator(csrc)
    medium, op = CUSTOM_SPECS[family]
    source, entry = gen._unit(gen.trace_custom(medium()), family, op)
    custom.build_units({0: source}, csrc)
    lib = custom._library_path(source, csrc)
    return lib, getattr(build.load(lib, (entry,)), entry)


def custom_libraries(csrc=build.CSRC):
    """{family: (library path, entry point)} of :data:`CUSTOM_SPECS`."""
    return {family: custom_library(csrc, family) for family in CUSTOM_SPECS}


def custom_cases(device, rays=RAYS):
    """(label, run) of row 2c's main shape: ``fused_step_custom`` on the
    ``[custom]`` fisheye fan of chip_smoke.py (the headline's fan with
    +-1e-3 rad of jitter, numpy seed 3, ray 0 at pi/2), op6 for one turn at
    the headline divisor, 2^20 x 4586; then the analytic ``fused_step`` on
    the same fan, whose arithmetic the generated field repeats.  The
    custom kernel launches from ``kfu.library_for``, which :func:`probe`
    points at each build's library in turn."""
    fish = scenario("fisheye")
    ds = 2.0 * math.pi / HEADLINE_DIVISOR
    steps = fish.max_size(ds, HEADLINE_DIVISOR, 1) - 1
    pos0, theta0 = launch_fan(fish, rays)
    theta0 = jittered(theta0, np.random.default_rng(3))
    theta0[0] = np.float32(math.pi / 2.0)
    field = custom.trace_custom(custom_fisheye())
    out = []
    for label, medium in (("fused_step_custom", field),
                          ("fused_step", "fisheye")):
        st = kfu.initial_state("op6", pos0, theta0, field=medium,
                               with_stats=False, device=device)
        kw = dict(field=medium, op="op6", steps=steps, delta_s=ds,
                  step_limit=steps, offset=0.0, box=tuple(fish.box))

        def run(st=st, kw=kw):
            o = kfu.fused_step(st, **kw)
            return torch.stack([o.x, o.y], -1)
        out.append((f"{label} op6 custom fisheye fan, {steps} steps", run))
    return out


def golden_cases(device, rays=RAYS):
    """(label, run) of the golden kernels beyond the analytic ones at their
    main shapes: golden_step_strat on the golden_strat_op11 run (the parity
    vert table trimmed for aniso's box, op11 at the reference table's step,
    SIGMA/2.74, 4142 steps, with the Welford tracker its momentum-CV oracle
    reads) and golden_step_custom on aniso op11 at SIGMA/1.2 through vert's
    ``1 / (18 + 2 y)`` as a ``CustomMedium`` (:func:`custom_aniso`, the
    tracker on), as chip_smoke.py's sampled and ``[custom]`` phases run
    them; the custom kernel launches from ``kg.library_for``, which
    :func:`probe` points at each build's library in turn."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback

    aniso, vert = scenario("aniso"), scenario("vert")
    it, _ = kg.golden_schedule()

    def case(label, field, ds, steps):
        st = kg.initial_state("op11", *launch_fan(aniso, rays), aniso.gamma,
                              field=field, with_stats=True, device=device)
        scal = kg.golden_scalars(ds, aniso.gamma, steps, 0.0, it,
                                 device=device)

        def run():
            out = kg.golden_step(st, scal, field=field, op="op11",
                                 steps=steps, box=aniso.box)
            return torch.stack([out.x, out.y], -1)
        return f"{label} op11 aniso, {steps} steps", run

    ds, div = calibrated_with_fallback("op11", "aniso")
    tables = kfu.strat_tables(rtt.compact_for_trace(
        rtt.build_stratified_medium("vert_heterogeneous", vert.box,
                                    device=device), aniso.box, ds))
    ds_c = config.SIGMA / 1.2
    return [case("golden_step_strat golden_strat_op11", tables, float(ds),
                 aniso.max_size(ds, div, 1) - 1),
            case("golden_step_custom", custom.trace_custom(custom_aniso()),
                 ds_c, aniso.max_size(ds_c) - 1)]


def sampled_cases(device, rays=RAYS):
    """(label, run) of the fused kernels on sampled media at their main
    shapes: fused_step_strat on the interface_strat run (the parity table,
    the reference table's op6 step, 3854 steps) and on the vert_strat run
    (op8 with the Welford stats, 4142 steps); on the parity fisheye grid
    (every label holds ``fisheye_grid``), fused_step_grid on the
    fisheye_grid run (op1, 4586 steps), fused_step_nodes on the same grid's
    node table (grid_trace's kernel), golden_step_grid on the
    tiled_grid_op5 run (op5, 299 steps) and fused_sweep_grid on the fisheye
    search's 300 candidates (op1, one ray each, :func:`sweep_inputs`) and
    on its longest candidate alone (the sweep's serial latency).
    The media are built once, on ``device``."""
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

    def golden(label, name, op, field):
        scen = scenario(name)
        ds, div = calibrated_with_fallback(op, name)
        steps = scen.max_size(ds, div, 1) - 1
        st = kg.initial_state(op, *launch_fan(scen, rays), scen.gamma,
                              field=field, with_stats=False, device=device)
        it, _ = kg.golden_schedule()
        scal = kg.golden_scalars(float(ds), scen.gamma, steps, 0.0, it,
                                 device=device)

        def run():
            out = kg.golden_step(st, scal, field=field, op=op, steps=steps,
                                 box=scen.box)
            return torch.stack([out.x, out.y], -1)
        return f"{label} {op} {name}, {steps} steps", run

    def sweep(label, field, alone=False):
        scen, _, pos0, theta0, ds, lim = sweep_inputs(device)
        if alone:
            i = int(torch.argmax(lim))
            pos0, theta0 = pos0[i:i + 1], theta0[i:i + 1]
            ds, lim = ds[i:i + 1].contiguous(), lim[i:i + 1].contiguous()
        steps = int(lim.max())
        st = kfu.initial_state("op1", pos0, theta0, field=field,
                               with_stats=False, device=device)

        def run():
            out = kfu.fused_sweep_grid(st, ds, lim, field=field, op="op1",
                                       steps=steps, box=tuple(scen.box))
            return torch.stack([out.x, out.y], -1)
        what = ("its longest candidate alone" if alone
                else f"{len(ds)} candidates")
        return (f"{label} op1 fisheye search, {what}, up to {steps} "
                "steps"), run

    def strat(name, field, op):
        box = scenario(name).box
        ds, _ = calibrated_with_fallback(op, name)
        return kfu.strat_tables(rtt.compact_for_trace(
            rtt.build_stratified_medium(field, box, device=device), box, ds))

    fish = scenario("fisheye")
    grid = fast._as_hermite(rtt.build_grid_medium("fisheye", fish.box,
                                                  device=device))
    cells = seg.grid_tables(grid)
    return [case("fused_step_strat", "interface", "op6",
                 strat("interface", "interface", "op6")),
            case("fused_step_strat", "vert", "op8",
                 strat("vert", "vert_heterogeneous", "op8"), stats=True),
            case("fused_step_grid fisheye_grid", "fisheye", "op1", cells),
            case("fused_step_nodes fisheye_grid", "fisheye", "op1",
                 seg.node_tables(grid)),
            golden("golden_step_grid fisheye_grid tiled_grid_op5",
                   "fisheye", "op5", cells),
            sweep("fused_sweep_grid fisheye_grid", cells),
            sweep("fused_sweep_grid fisheye_grid", cells, alone=True)]


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
                                            sampled_media)
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
            case3("fused3d_step_grid grid3 tilted", "fused", g3, "op6",
                  fan3("tilted", rays, 0)),
            case3("fused3d_step_grid grid3 dispersed", "fused", g3, "op6",
                  fan3("dispersed", rays, 3)),
            case3("fused3d_step fisheye3 tilted", "fused", "fisheye", "op6",
                  fan3("tilted", rays, 0))]
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
    ] + golden_cases(device, rays) + custom_cases(device, rays) + \
        sampled_cases(device, rays) + \
        df_cases(device, rays) + dynamic_cases(device, rays)


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


def without_counter(fn, at):
    """``fn`` called with this checkout's arguments less the counter at
    ``at`` (a parent's entry point from before its refill loop)."""
    return lambda *args: fn(*args[:at], *args[at:][1:])


class ParentLibrary:
    """A parent checkout's library as the wrappers call it: the entry points
    in ``dropped`` ({name: counter place}) are called without the counter
    that the wrapper passes."""

    def __init__(self, lib, dropped):
        self._lib, self._dropped = lib, dropped

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        at = self._dropped.get(name)
        return fn if at is None else without_counter(fn, at)


def _dropped(lib):
    """{entry: counter place} of the COUNTER_ENTRIES that the library
    ``lib`` (loaded by path) builds without their counter."""
    return {name: at for name, (mark, at) in COUNTER_ENTRIES.items()
            if not hasattr(lib, mark)}


def load_parent(path):
    """The parent's library; the COUNTER_ENTRIES of a build without their
    refill loop (no marking entry point) take this checkout's arguments
    less the counter."""
    lib = ctypes.CDLL(str(path))
    dropped = _dropped(lib)
    for name in SHARED_ENTRIES:
        fn = getattr(lib, name)
        sig = list(build._SIGNATURES[name])
        if name in dropped:
            del sig[dropped[name]]
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return ParentLibrary(lib, {k: v for k, v in dropped.items()
                               if k in SHARED_ENTRIES})


def load_parent_custom(main, path, entry):
    """A parent's generated library's entry point, called as this
    checkout's: without the counter where the parent's main library
    ``main`` has no refill loop for it."""
    fn = getattr(ctypes.CDLL(str(path)), entry)
    sig = list(build._SIGNATURES[entry])
    at = _dropped(main._lib).get(entry)
    if at is None:
        fn.argtypes, fn.restype = sig, ctypes.c_int
        return fn
    del sig[at]
    fn.argtypes, fn.restype = sig, ctypes.c_int
    wrapped = without_counter(fn, at)
    wrapped.__name__ = entry
    return wrapped


def probe(device, reps, builds, only=None):
    """Four passes over the shapes (those whose label contains one of the
    strings ``only``, where given), in the order A, B, B, A of the two
    ``(label, library, {family: (path, entry point)})`` builds: the main
    library and the generated ones of :data:`CUSTOM_SPECS`."""
    shapes = [(label, run) for label, run in cases(device)
              if not only or any(o in label for o in only)]
    ref = {}
    (la, liba, cua), (lb, libb, cub) = builds
    steps_of = {id(liba): loop_steps([liba, *(p for p, _ in cua.values())]),
                id(libb): loop_steps([libb, *(p for p, _ in cub.values())])}
    for p, (label_b, lib, cu) in enumerate(((la, liba, cua), (lb, libb, cub),
                                            (lb, libb, cub),
                                            (la, liba, cua))):
        build.library = lambda lib=lib: lib
        kfu.library_for = kg.library_for = (
            lambda field, family, op, cu=cu: (cu[family][1],
                                              cu[family][1].__name__))
        print(smi(), flush=True)
        for label, run in shapes:
            times, pos, batch = time_ms(run, reps)
            ref.setdefault(label, pos)
            dev = float((pos - ref[label]).abs().max())
            each = ("" if batch == 1
                    else f" (graphs of {batch} launches)")
            sass = next((steps_of[id(lib)].get(k) for part, k, _ in
                         CASE_KERNELS if part in label), None)
            print(f"pass {p} {label_b} {label}: median "
                  f"{statistics.median(times):.3f} ms runs "
                  f"{[round(t, 3) for t in times]}{each} max|d vs {la}| "
                  f"{dev:.3e}"
                  + ("" if sass is None else f"; SASS a step {sass}"),
                  flush=True)


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


def _back_branches(code):
    return [(int(m.group(1), 16), addr) for addr, text in code
            if _opcode(text) == "BRA" and (m := _TARGET.search(text))
            and int(m.group(1), 16) < addr]


def loop_path(code, lines=None, loop=None):
    """The instructions, by opcode, that one iteration of a kernel's longest
    loop (or of ``loop``, a (head, tail) pair) issues on its usual path;
    None for a kernel without a loop.  ``code`` is the kernel's (address,
    instruction) pairs; ``lines``, a list, receives the path's instructions
    in order.  The loop runs from the target of its longest backward
    branch to that branch; a forward conditional branch over code that
    calls a subroutine (the slow path of an IEEE division or square root,
    or of a guarded group of quotients or of a whole step) is taken, any
    other is not."""
    back = _back_branches(code)
    if not back:
        return None
    head, tail = loop or max(back, key=lambda b: b[1] - b[0])
    body = [(addr, text) for addr, text in code if head <= addr <= tail]
    at = {addr: k for k, (addr, _) in enumerate(body)}
    path, k = collections.Counter(), 0
    while k < len(body):
        addr, text = body[k]
        op = _opcode(text)
        path[op] += 1
        if lines is not None:
            lines.append(text.strip())
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


def _usage(log):
    """ptxas's register and spill lines of each entry in a build log."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "spill" in line):
            usage.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return usage


def outer_loops(code, depth=0):
    """The (head, tail) of each loop of a kernel that ``depth`` other loops
    hold, by address: with depth 0 the loops no other loop holds (in
    fused_kernel, the step loops with and without the Welford stats); with
    depth 1 those one loop holds (in golden_kernel_refill, the step loop
    inside the refill loop)."""
    back = sorted(set(_back_branches(code)))
    return [b for b in back if sum(o != b and o[0] <= b[0] and b[1] <= o[1]
                                   for o in back) == depth]


def ballot_free_loops(code):
    """The (head, tail) of each loop whose body holds no ballot (a
    ``VOTE.ANY``) and that no other such loop holds: in
    ``dynamic_kernel_refill``, the loop of steps run while every lane's ray
    is live (its vote a step is a ``VOTE.ALL``), which the refill loop and
    its votes' divergent paths hold at several depths."""
    back = sorted(set(_back_branches(code)))
    free = [b for b in back
            if not any(b[0] <= a <= b[1] and _opcode(t) == "VOTE"
                       and ".ANY" in t for a, t in code)]
    return [b for b in free if not any(o != b and o[0] <= b[0]
                                       and b[1] <= o[1] for o in free)]


def step_loops(code, pretty):
    """The loops of a kernel whose instructions a step CASE_KERNELS
    reports: the outermost loops (one ray a thread), the loops the refill
    loop holds (``fused_kernel_refill``, ``golden_kernel_refill``), or the
    ballot-free loops of ``dynamic_kernel_refill``."""
    if "dynamic_kernel_refill<" in pretty:
        return ballot_free_loops(code)
    return outer_loops(code, int("_refill<" in pretty))


def _cuobjdump():
    return shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")


def parse_sass(lib):
    """The SASS of a built library by kernel (mangled name): ({name:
    [instructions, FFMA]}, {name: Counter of opcodes}, {name: [(address,
    instruction)]}, [each FFMA with the six instructions before it])."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
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
        if op == "FFMA":
            counts[fn][1] += 1
            ffma_lines.append(
                (fn, f"{fn}\n" + "\n".join(recent[-6:] + [line])))
        recent.append(line.strip())
    return counts, ops, code, ffma_lines


def _names(kernel):
    return kernel if isinstance(kernel, tuple) else (kernel,)


def _launches(pretty, kernel):
    """Whether the demangled ``pretty`` is a launch of ``kernel`` (a name
    of CASE_KERNELS), blanks aside (a demangler may write "> >")."""
    flat = pretty.replace(" ", "")
    return any(f"::{k.replace(' ', '')}(" in flat for k in _names(kernel))


def loop_steps(libs):
    """{kernel of CASE_KERNELS: its outermost loops' instructions a step on
    the usual path (:func:`loop_path`), " | "-joined} for the kernels of
    CASE_KERNELS in the libraries ``libs`` (loaded libraries or paths);
    empty where the SASS cannot be read."""
    out = {}
    for lib in libs:
        path = lib if isinstance(lib, Path) else (
            getattr(lib, "_name", None)
            or getattr(getattr(lib, "_lib", None), "_name", None))
        try:
            _, _, code, _ = parse_sass(path)
        except (OSError, subprocess.CalledProcessError, TypeError):
            continue
        names = list(code)
        for mangled, pretty in zip(names, _demangle(names)):
            for _, kernel, per in CASE_KERNELS:
                if _launches(pretty, kernel):
                    # a refill kernel steps in a loop its refill loop holds
                    loops = [sum(loop_path(code[mangled], None, lp).values())
                             / per for lp in step_loops(code[mangled],
                                                        pretty)]
                    out[kernel] = " | ".join(f"{c:g}" for c in loops)
    return out


def sass_report(pattern: str, csrc=build.CSRC) -> dict:
    """Registers, spills, SASS instructions, FFMAs, opcodes and the loop's
    path of each kernel whose mangled name contains one of the
    comma-separated ``pattern``s, in the library built from ``csrc`` and in
    row 2c's generated library (:func:`custom_library`) built against it
    (module docstring).  Returns {demangled name: its SASS listing}."""
    patterns = pattern.split(",")
    listings = {}
    main_lib = build.build(csrc=csrc)
    digest = build.source_digest(csrc=csrc)
    ffma_lines, loops = [], []
    for lib, log in ((main_lib, build.BUILD_DIR / f"ptxas-{digest}.log"),
                     *((p, p.with_suffix(".log"))
                       for p, _ in custom_libraries(csrc).values())):
        usage = _usage(log.read_text())
        counts, ops, code, ffmas = parse_sass(lib)
        ffma_lines += [text for fn, text in ffmas
                       if any(p in fn for p in patterns)]
        names = sorted(n for n in set(counts) | set(usage)
                       if any(p in n for p in patterns))
        print(f"[sass] {lib.name} from {csrc}: {len(names)} kernels matching "
              f"{pattern!r}", flush=True)
        for name, pretty in zip(names, _demangle(names)):
            listings[pretty] = [text for _, text in code.get(name, [])]
            instr, ffma = counts.get(name, [0, 0])
            top = ", ".join(f"{o} {c}" for o, c in ops.get(
                name, collections.Counter()).most_common(14))
            slow = ops.get(name, collections.Counter())
            named = ("F2I", "I2F", "I2FP", "LDG", "MUFU", "FCHK", "CALL",
                     "BSSY", "MOV")
            lines = []
            path = loop_path(code.get(name, []), lines)
            loop = "no loop" if path is None else (
                f"loop path {sum(path.values())} instructions an iteration ("
                + ", ".join(f"{o} {path[o]}" for o in named if path[o])
                + ")")
            held = (outer_loops(code.get(name, []))
                    + outer_loops(code.get(name, []), 1))
            if "dynamic_kernel_refill<" in pretty:
                held += [b for b in ballot_free_loops(code.get(name, []))
                         if b not in held]
            for head, tail in held:
                more = []
                other = loop_path(code[name], more, (head, tail))
                loop += (f"; loop at {head:#x} {sum(other.values())} ("
                         + ", ".join(f"{o} {other[o]}" for o in named
                                     if other[o]) + ")")
                loops.append(f"{pretty} loop at {head:#x}\n"
                             + "\n".join(more))
            print(f"  {pretty}: "
                  f"{' | '.join(usage.get(name, ['no ptxas line']))}"
                  f"; {instr} SASS instructions, {ffma} FFMA, "
                  + ", ".join(f"{slow[o]} {o}" for o in named)
                  + f"; {loop}; opcodes: {top}", flush=True)
            if path is not None:
                loops.append(f"{pretty}\n" + "\n".join(lines))
    (build.BUILD_DIR / f"sass-ffma-{digest}.txt").write_text(
        "\n\n".join(ffma_lines) + "\n")
    (build.BUILD_DIR / f"sass-loop-{digest}.txt").write_text(
        "\n\n".join(loops) + "\n")
    return listings


def compare_listings(parent, own) -> None:
    """Print, for each kernel both builds hold, whether its SASS listing
    (every instruction with its address) is the parent's."""
    for pretty in sorted(set(parent) & set(own)):
        same = "identical to" if parent[pretty] == own[pretty] else (
            "differs from")
        print(f"[sass] {pretty}: listing {same} the parent's "
              f"({len(parent[pretty])} -> {len(own[pretty])} instructions)",
              flush=True)


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
    ap.add_argument("--cases", metavar="LABEL[,LABEL...]",
                    help="time only the shapes whose label contains one of "
                         "these strings")
    ap.add_argument("--sass", metavar="PATTERN", nargs="?",
                    const="df_kernel",
                    help="only report registers, spills and FFMAs of the "
                         "kernels whose name contains PATTERN")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fma_probe: needs a CUDA device")
    if args.sass:
        parent = (None if args.parent_csrc is None
                  else sass_report(args.sass, csrc=args.parent_csrc))
        own = sass_report(args.sass)
        if parent is not None:
            compare_listings(parent, own)
        return 0
    only = args.cases.split(",") if args.cases else None
    own = ("fmad=false", build.load(build.build()), custom_libraries())
    if args.parent_csrc is not None:
        main_parent = load_parent(build.build(csrc=args.parent_csrc))
        other = ("parent", main_parent, {
            family: (path, load_parent_custom(main_parent, path,
                                              fn.__name__))
            for family, (path, fn) in custom_libraries(
                args.parent_csrc).items()})
        probe("cuda", args.reps, (other, ("change", *own[1:])), only)
    else:
        # the generated libraries are built with the package's flags only
        probe("cuda", args.reps,
              (own, ("fmad=true", build.load(build.build(fmad_flags(True))),
                     own[2])), only)
    build.library = lambda: own[1]
    kfu.library_for = kg.library_for = custom.library_for
    if args.profile:
        profile_main_path("cuda", args.profile)
    if args.profile_sampled:
        profile_sampled_path("cuda", args.profile_sampled)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
