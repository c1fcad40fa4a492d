#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, when
either is missing or any check fails.  Phases, one line or more each:

1. environment: torch and CUDA versions, the device, and the card's name
   and power limit from nvidia-smi;
2. build: the twenty CUDA kernels of the main library compiled from
   raytracing_tpu_torch/csrc (one nvcc a source, all at once); the
   reference's sampled media built on the card (``[media]``); ``[fma32]``
   the card's fmaf (the FFMA of the 2-D grid blends and of the 2-D dynamic
   and analytic 3-D steps) against the plain versions' fma32
   (utils/fma.py) on the card, 2^26 seeded triples and 2^21 constructed
   float64 midpoints, then every operand triple of the 2-D dynamic plain
   version's fma32 calls (every op on each analytic field and on the
   parity and C1 fisheye grids, the grids' blends with the step), the
   analytic 3-D one's and the df32 one's in the FMA form (the analytic
   fields and the Munk profile) (256 rays, 10 steps), no triple
   differing;
3. kernel against plain: every kernel against its plain PyTorch version on
   the card, for every (op, field) it serves, at 65,536 rays (each
   scenario's launch fan resized, with jitter from numpy seed 0) at the
   op's calibrated analytic step, capped at 1,000 steps; and resume: k
   then n - k steps against n steps; then ``[sampled-vs-plain]``: the four
   sampled-media kernels against their plain versions at 65,536 rays, at
   most 1,000 steps, at the op's step from the reference table
   (``calibrated_with_fallback``), every fused op on the parity interface
   and vert tables, the C1 vert table and the parity and C1 fisheye grids,
   every golden op on the parity and C1 vert tables (aniso at gamma 3 for
   op10/op11/op10n/op11n) and the two fisheye grids, with resume checks;
   then ``[refill-vs-plain]``: fused_step and fused_step_strat, whose
   persistent loop refills the lanes of frozen rays, on the interface fan
   (the analytic field at SIGMA/5, 7557 steps; the parity table at the
   reference table's op6 step, 3854 steps) at full depth, 1, 42, 4097 and
   2**20 + 17 rays, op7 with the Welford stats, a step limit of 250 steps
   (below every lifetime) and a resume chain of uneven segments, every
   plane to the bit; each line with the refill grid and the warp
   efficiency one ray a thread would have; then the golden loop's refill
   (golden_step_strat and golden_step) on aniso's op11 fan, the parity
   vert table at the reference table's step (golden_strat_op11, 4142
   steps) and the analytic field at SIGMA/1.2 (1814 steps), at 1, 31,
   4097 and 2**20 + 17 rays for each ray's whole life (450 and 200
   steps), the tracker on, a step limit below most lifetimes and a resume
   chain, every plane to the bit.  Every golden line of phase 3 (and of
   ``[custom-vs-plain]``) requires bit parity on every plane and prints
   the share of ray-steps on which a fast path of the golden step failed
   its guard, as golden_step_plain's model of the guards counts it;
4. headline: fisheye op1, 2**20 rays, divisor 4587 (4587 steps) through
   make_fisheye_runner: closure error, ray-steps/s (median of 5 timed runs
   after 2 warm-ups), and the plain version's time at the same shape;
5. scenarios at 2**20 rays through fast_trace: interface op6 Snell errors,
   fisheye op6 ten-turn closure, vert op8 and aniso op11 momentum CV;
6. sampled: the reference program's own media (the JAX CLI's
   ``--medium auto``: stratified tables for interface, vert and aniso, the
   2-D spline grid for the fisheye) through fast_trace at 2**20 rays at the
   reference table's step, each held to its oracle (``[sampled]``);
7. main shapes: each scenario's and each sampled run's fast_trace result
   (positions, traveltime, `active`) against the kernel's plain version on
   the same inputs at the full shape, and the kernel's time there beside
   the plain version's and its bound; a run of more than 300 steps is
   compared, and its plain version timed, at 300 steps (a direct launch
   of the kernel against the plain version, same inputs), except the two
   interface runs (``FULL_DEPTH``): their direct launch is held to the
   plain version replayed at full depth (7557 and 3854 steps) on every
   plane, and to the fast_trace result, with the refill grid and the warp
   efficiency one ray a thread would have; then which loop fused_step took
   on each side of its choice (the interface's refill loop, the fisheye's
   one ray a thread), and that golden_step took the refill loop on aniso;
8. ``[sweep-vs-plain]``: fused_sweep_grid against its plain version (per-ray
   step sizes and limits, replayed from a CUDA graph) on the reference's
   full fisheye candidate grid (divisor 303 -> 4, ten turns, one ray a
   candidate), parity and C1 grids, op1/op6/op7, to the bit; the op1
   parity sweep's time beside its longest candidate launched alone (the
   sweep's serial-latency figure, every plane equal to its row of the
   sweep) and its roofline bound; ``[nodes-vs-plain]``: fused_step_nodes on the
   parity grid's node table, every fused op with and without the stats, at
   65,536 rays and at most 1,000 steps, to the bit;
9. the search path: ``[search]`` delta_s_search (engine "fused") for
   fisheye op1 on the 2-D grid, interface op6, vert op8 and aniso op11 on
   the stratified tables (the JAX CLI's ``--medium auto``), with the
   selection beside the reference's calibrated divisor; ``[cli]`` the CLI's
   search mode; ``[grid_trace]`` at the headline shape (2**20 rays, fisheye
   op1, 4586 steps); ``[segmented]`` segmented_trace with compaction for
   interface op6 and aniso op11 at 2**20 rays, and a checkpointed run
   interrupted and resumed;
10. the search path's checks: every fused candidate's metric against one
   batched plain run (per-ray step sizes), the golden search's selected
   candidate and its neighbours against golden_step_plain, both replayed
   from CUDA graphs; grid_trace
   against grid_trace_tiled (phase 6's fisheye_grid run) and a direct
   launch of its kernel, that kernel against its plain version at 300
   steps, with the kernel's time; segmented_trace against one launch
   (phase 6's runs) and across the checkpoint, all to the bit;
11. ``[dynamic-vs-plain]``: the three dynamic kernels against
   dynamic_step_plain at 65,536 rays and at most 1,000 steps, op1/op2/op6/
   op8 on the analytic fisheye, vert and interface, the parity and C1 vert
   tables, the parity interface table and the parity and C1 fisheye grids,
   all 18 state planes to the bit, with a resume check a kernel (both
   grid families for dynamic_step_grid); each
   line with the share of ray-steps on which a fast path's guard failed
   (the kernel then takes that operation's IEEE form), as the plain
   version's model of the guards counts them (the kernel does not report
   its path; tests/test_torch_cuda.py checks the model and the kernel's
   IEEE forms on rays beyond each guard); then ``[refill-vs-plain]``:
   dynamic_step_strat, whose persistent loop refills the lanes of frozen
   rays, on phase 12's vert_strat fan (ds 0.0193) on the parity and C1
   tables, op6 and op8, at 1, 31, 4097 and 2**20 + 17 rays for each ray's
   whole life (450 of 2000 steps), a step limit of 120 and a resume chain
   of uneven segments, all 18 planes to the bit against the plain version
   replayed, each line with the refill grid and the warp efficiency one
   ray a thread would have;
12. ``[dynamic]`` the dynamic path at 2**20 rays through fast_dynamic: the
   analytic fisheye op6 for one turn (divisor 4587, the scenario's ray with
   +-1e-3 rad of jitter), the parity vert table op6 (ds 0.0193, 2000 steps,
   from (-2, -2) at U[0.05, 1.5]), the parity and C1 fisheye grids op6
   (4586 steps); then its checks: KMAH 1 after the fisheye's turn on every
   ray (the float64 scan tier, then the kernel), each run against
   trace_dynamic at float64 on 4,096 rays at the JAX package's bars (on
   the sampled media its tangent from torch.func.jvp of the op6 step, not
   from the kernels' channel evaluators; the fisheye's also inside
   torch.inference_mode(), equal to the bit), each run against a direct launch
   of its kernel at the full shape and against dynamic_step_plain
   (replayed from a CUDA graph) at 2**20 rays and at most 300 steps, to
   the bit, and the kernels' times;
13. ``[eigenrays]`` on the card at float64: the aten operations a step of
   the TL map's crossing trace, the Slotnick two-point traveltime, and one
   ``python -m raytracing_tpu_torch.cli --eigenrays`` run (in a process
   of its own, started with phase 20's APART after phase 19, its lines
   printed in phase 20; the TL field map of examples/tl_field_map.py runs
   in phase 20, as its twin);
14. the df32 tier: ``[df32-vs-plain]`` the four df kernels on their five
   media (the analytic fisheye and vert, the reference's parity and C1
   fisheye grids split into hi/lo words, the Munk profile) against
   df_step_plain in the kernel's form (the FMA form on the analytic fields
   and the profile, JAX's roundings on the grids; replayed from a CUDA
   graph, bench/replay.py df_plain) at 65,536 rays, the
   analytic fields at most 1,000 steps (vert 500), the tables 200, all 8
   planes to the bit, with a resume check each; ``[df32]`` the df32 main
   path: fast_trace(precision="high") on the
   fisheye at 2**20 rays for one turn at the headline divisor (median of 5,
   the one-turn error against the circle, the north-star RMS over ten
   prefixes read from resumed segments), the ORACLES ten-turn closure
   (4,096 rays, 45,870 steps), vert at 2**20 rays x 500 steps,
   df_grid_trace on both grids (256 rays for ten turns, 2**20 for one) and
   on the Munk profile (2**20 rays, 1,500 steps); then its checks: vert and
   the profile against the float64 scan tier on 4,096 rays,
   DfEvalProfile.n_and_grad on the card against the CPU on 2**20 depths,
   and each kernel's time at its main shape beside its bound; then the two
   grid kernels on a dispersed fan (2**20 launch points over the grid,
   uniform angles: one run's time, the share of rays on the grid, the
   row-read HBM estimate);
15. user-defined media (kernels/custom.py): ``[custom]`` traces four
   CustomMediums and builds the libraries of the fused and golden loops on
   them (every op on the fisheye field by dual numbers and on the interface
   logistic with a hand grad_fn, aniso op11; one nvcc each, all at once);
   ``[custom-vs-plain]`` both custom kernels against their plain versions
   at 65,536 rays, every fused op and every golden op (and the bracket
   parity and coarse bracket + polish schedules) on both media, at most
   1,000 steps, every plane to the bit, with resume checks; the
   ``[custom]`` main path through fast_trace at 2**20 rays: the fisheye
   for one turn at the headline divisor (closure, and the analytic
   fused_step on the same fan), the interface (Snell), aniso op11 and
   JAX's test field (tests/test_fast.py:143, 1,000 steps; its build is
   timed as a user's first call); then its checks: each run against a
   direct launch of its kernel (aniso's with the Welford tracker, for its
   momentum CV) and against its plain version at 300 steps, every plane to
   the bit, with the kernels' times and bounds;
16. the 3-D kinematic tier (kernels/fused3d.py, engine/tiled3.py): the
   benchmark's 71^3-node sampled fisheye built and uploaded;
   ``[3d-vs-plain]`` both 3-D kernels against fused3d_step_plain at 65,536
   rays and at most 1,000 steps, every op on the three analytic fields and
   on the grid (a tilted and a dispersed fan), all 12 planes to the bit,
   with a resume check each and the share of ray-steps whose fast paths'
   guards failed, as modelled by the plain version; ``[3d]`` the 3-D main path through
   fast_trace3 at 2**20 rays: the fisheye for one turn on a fan of tilted
   planes (closure), vert op8 and interface op6 in a box some rays leave,
   the grid3 fisheye (one turn, against the analytic run), a dispersed
   grid3 fan, and the benchmark's shapes fused3d_op6 and tiled3_grid_op6
   (kernel_matrix.py:191-232); the scan route (Stratified3D: engine
   "scan3d", and trace3d(stats=True)'s horizontal slowness CV at 4,096
   rays, float64), trace3d history at 256 rays, divisor 303 (closure and
   the Bouguer drift, bench.py:574-591), and delta_s_search_convergence3;
   then ``[3d-shapes]``: each run against a direct launch of its kernel
   (every ray to the bit) and that kernel against its plain version at
   min(steps, 300) steps (all 12 planes), with the kernel's time, its bound
   and, for the grid, the row-read HBM estimate (256 bytes a live ray-step
   over 3.35 TB/s: not a bound, since rows the L2 holds cost no HBM read).

17. the 3-D dynamic tier (kernels/dynamic3d.py, engine/dynamic3d.py,
   engine/eigenray3d.py): ``[div_by]`` the division by a shared reciprocal
   that its loop forms its quotients with (csrc/common.cuh) against the
   card's IEEE division, all 2^32 numerators over 60 and over 360 and 2^28
   seeded pairs; the fused step's division by a carried positive
   reciprocal (div_fast_pos), all 2^32 numerators over four values of n
   and 2^28 seeded pairs; the reciprocal, square root and rsqrt fast paths
   (rcp_rn, sqrt_fast, rsqrt_fast) on all 2^32 operands against
   __frcp_rn, __fsqrt_rn and rsqrtf; no operand differing;
   ``[dyn3-vs-plain]`` both 3-D dynamic
   kernels against dynamic3d_step_plain at 65,536 rays and at most 1,000
   steps, every op on the three analytic fields (the fisheye's tilted fan
   through its focus, JAX's vert and interface launches), op1 and op6 on
   the 71^3 grid with a tilted and a dispersed fan, all 25 planes to the
   bit, with a resume check each; ``[dyn3]`` the eighth main path through
   fast_dynamic3 at 2**20 rays: dyn3_op6 and dyn3_tiled_op6
   (kernel_matrix.py:191-244), the tilted fan for one turn on the fisheye
   and on the grid (against each other), vert op8, interface op6 and the
   dispersed grid fan; the scan route on the card at float64 (the
   homogeneous Custom3D's det Q = 25 and TL, the astigmatic waveguide's
   KMAH, the tier's ms a step); then its checks: each run against a direct
   launch of its kernel (every ray to the bit), that kernel against its
   plain version at min(steps, 300) steps (all 25 planes), against
   trace_dynamic3 at float64 on a 4,096-ray head at the JAX tests' depths
   and bars (DYN3_BARS), each kernel's time, plain time (eager, the timed
   runs), bound and for the grid the row-read HBM estimate;
   ``[eigenrays3]`` find_eigenrays3 at float64 on the card: the
   homogeneous arrival, the eddy's out-of-plane arrival, and one
   ``python -m raytracing_tpu_torch.cli --eigenrays3`` run on the Munk
   profile lifted to 3-D (in a process of its own, started with phase
   20's APART after phase 19, its lines printed in phase 20).
18. the modules with no kernel of their own, each phase with its seconds:
   ``[diff]`` trace_diff at benchmarks/diff_probe.py's configuration
   (2**18 rays, 300 op6 steps, float32, remat 4, a 12 x 12 parametric
   grid): forward and forward + backward seconds and peak memory, the
   gradient finite and nonzero only on visited nodes, then float64 checks
   (central differences, remat 1 against 4, the scan trace, the op10n
   and op10 gamma gradients); ``[df3]`` the df32 facade of the 71^3
   samples in trace3d and trace_dynamic3 against float64 on the
   C1Grid3Medium, a float32 find_eigenrays3 solve against float64 (the
   reference solve on the CPU), ms a step; ``[stream]`` stream_history against trace(mode="history") to the
   bit, at 2**18 rays over one turn within 2 chunks' rows of device
   memory, and trace_chunked against trace(mode="metrics"); ``[profiling]``
   device_trace naming fisheye_op1, step_timer against CUDA events.
19. the serving layer (raytracing_tpu_torch/serve.py) on the card: the
   server started on a thread (the kernel library already built), /healthz
   naming the card, /v1/models equal to the JAX server's lists; the
   serving path, posted over HTTP one request after another: /v1/trace on
   the headline (fisheye op1, divisor 4587, one turn) at 2**20 and 2**24
   rays (fisheye_op1), interface op6, aniso op11 and vert op8 at 2**20
   rays at the reference table's step (fused_step, golden_step), aniso
   op11 and vert op8 on the stratified tables (golden_step_strat,
   fused_step_strat), fisheye op1 on the parity and C1 grids for one turn
   (fused_step_grid), fisheye op12 at precision "high" (df_step);
   /v1/trace_samples at 2**20 rays on a posted 501-sample profile with the
   conservation report and on a posted 129 x 129 grid; /v1/calibrate_samples
   on the profile at 65,536 rays; each response equal to the bit to the
   response rebuilt from a direct call of its work on the same inputs, the
   closures and the CV under their bars; the serving overhead of the two
   headline requests (the request's seconds beside the kernel's, by CUDA
   events, median of three after the main path's); the solve endpoints at
   small sizes (/v1/eigenrays at float64 and on_device, fan 64 x 60 steps
   of 0.16; /v1/trace3d_samples on the lifted
   profile, 2**16 rays x 300 steps, and on a posted 31**3 grid;
   /v1/eigenrays3, fan 8 x 8 x 160 steps), each equal to its direct call
   with its seconds; eight requests at once across the endpoints, each
   equal to the same request alone; one hostile payload of each kind of
   tests/test_serve.py answered 400, and /healthz after them.
20. the native spline library, the display path and the example twins:
   ``[native]`` the g++ build of raytracing_tpu_torch/native (its seconds,
   printed after phase 1's build, since phase 2's sampled media are the
   first to use it; the run fails unless it is available), gradient2 and
   bicubic_cells
   against numpy and FITPACK at tests/test_native.py's bars, the table
   builds timed native against scipy (best of 3, in this process before
   any other starts: the interface reference grid, the 511**2 fisheye
   parity grid and its C1 twin, the vert stratified tables,
   grid_medium_from_samples on 511**2 samples),
   fused_step_grid and fused_step_strat on native-built tables against
   their plain versions (65,536 rays, at most 300 steps, every plane to
   the bit, replayed), and the 2**20-ray one-turn fisheye grid run (op1)
   on native tables, its closure under 5 % and its positions within 1e-5
   of the scipy tables' run; ``[viz-cli]`` whether matplotlib is
   installed: with it the CLI's --plot static (figure, momentum plot,
   wavefront report), --plot movie --save-video, the interface and a
   --medium-file profile with --plot static, and the menus from a scripted
   input_fn, each file written and each printed oracle under its bar;
   without it the CLI's vert op8 run and ray_xy, wavefront and
   wavefront_report on a vert trace on the card, no drawing call;
   ``[examples]`` the example twins' main on the card: million_ray,
   delta_s_search, ocean_waveguide and measured_medium in this process
   (one main path), transmission_loss (6 160), tl_field_map (19 12 256),
   eddy_3d (32 2300) and wavefront_movie (--report-only) in processes of
   their own (float64 scan tiers, no kernel); each twin's own asserts, its
   seconds.  The host-bound work that launches no kernel (APART: those
   four twins, phase 13's [eigenrays] and phase 17's [eigenrays3]) starts
   in its processes after the timed table builds, once every timed phase
   before it is done, and runs beside the rest of phase 20 on the host's
   other cores.
21. ``[mesh]``, the sharded path (parallel/mesh.py, parallel/distributed.py),
   run after phase 19 and before phase 20's timed builds, in three
   processes of its own started together, so that no process group is left
   in this one: world size 1, make_mesh()'s own one-rank NCCL group, and
   world size 2, a gloo group of two processes on the one card (NCCL
   refuses two ranks on one GPU).  Each rank runs fast_trace_sharded at
   2**20 rays and full depth on interface_strat op6 with stats
   (fused_step_strat), aniso op11 (golden_step) and the parity fisheye grid
   op1 (fused_step_grid), each kernel launched in the sharded call, every
   plane of the rank's rows equal to fast_trace's on the same batch to the
   bit, the sharded and unsharded calls' ms beside each other;
   summarize_sharded against numpy on the host copy (1e-12); in world 2
   also run_candidates(mesh=make_mesh(2, sweep=2)) on the first 8 fisheye
   candidates against the unsharded metrics and grid3_trace_dynamic_tiled
   (mesh=) at dyn3_tiled_op6's shape, 100 steps, against the call without
   a mesh (dynamic3d_step_grid); the phase's seconds.

The kernel-against-plain phases (3, 7's two interface runs, 8's nodes,
11's ``[dynamic-vs-plain]``, 14's ``[df32-vs-plain]`` and the [df32]
checks, 15's ``[custom-vs-plain]``, 16's ``[3d-vs-plain]``, 17's
``[dyn3-vs-plain]`` and the [dyn3] checks) replay their plain versions'
steps from a CUDA graph (raytracing_tpu_torch/bench/replay.py), equal to
the eager loop to the bit; the other main shapes' plain versions run
eagerly, as their times are reported.

Phases 4-5 are the analytic main path, phase 6 the sampled one, phase 9
the search path, phase 12 the dynamic one, phase 14's ``[df32]`` the df32
one, phase 15's ``[custom]`` the custom one, phase 16's ``[3d]`` the
3-D one, phase 17's ``[dyn3]`` the 3-D dynamic one, phase 19's
requests the serving one and phase 20's grid run and twins theirs: every launch count
is set
to 0 just before each and read just after, and each kernel of that path
must have launched; the launches phases 3, 7, 8, 10, 11, 12's checks,
14's checks, 15's ``[custom-vs-plain]``, 15's checks, 16's
``[3d-vs-plain]`` and ``[3d-shapes]``, 17's ``[dyn3-vs-plain]`` and
``[dyn3]`` checks make to compare
and time a kernel are not counted.  The second-last line is a JSON
object with one entry per kernel (its launches on its main path, largest
|dpos| against the plain version, times, and the bound: the larger of its
FP32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s); the last
line is {"ok": true, "device": {...}}.
"""
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from typing import Any, NamedTuple

#: before numpy and torch are imported: [env] and [done] report the
#: imports' seconds and the whole run's
T_IMPORTS = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from raytracing_tpu_torch.bench import (  # noqa: E402
    DF_PROFILE_STEPS, DF_VERT_STEPS, HEADLINE_DIVISOR, fan3, fan3_dyn,
    grid3_medium, jittered, launch_fan, munk_profile, sweep_inputs)

RAYS_CHECK = 1 << 16
STEP_CAP = 1000
#: the depth at which phases 7, 10 (grid_trace) and 12 hold the main
#: paths' 2**20-ray runs to their plain versions and time those (the
#: kernels' own times stay at the full step count), so that the whole
#: script stays well inside its time limit (PERF.md §6)
MAIN_PLAIN_CAP = 300
#: the main path's runs whose kernel runs the refill loop on rays of mixed
#: lifetimes (fused_step, fused_step_strat): held to the plain version,
#: replayed from a CUDA graph, at full depth on every plane
FULL_DEPTH = ("interface", "interface_strat")
RAYS_MAIN = 1 << 20
# kernel-against-plain tolerances: the JAX package's own kernel-against-scan
# bars for the same op and field (tests/test_kernels.py:24-27,
# tests/test_fused.py:31-83, tests/test_golden_kernel.py:36-41)
POS_TOL = {"fisheye": 1e-5, "vert_heterogeneous": 1e-5, "interface": 2e-4}
POS_TOL_OP7 = 2e-4
POS_TOL_GOLDEN = 5e-4
TT_REL_TOL = 1e-5
TT_ABS_TOL_GOLDEN = 5e-4
ACTIVE_TOL = 1e-3          # share of rays whose `active` flags may differ
# the run whose kernel time the kernels line reports: each kernel's longest
# launch on its main path
TIMED_SHAPE = {"fused_step": "interface", "golden_step": "aniso",
               "fused_step_strat": "interface_strat",
               "golden_step_strat": "golden_strat_op11",
               "fused_step_grid": "fisheye_grid",
               "golden_step_grid": "tiled_grid_op5"}
# the H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W)
PEAK_FP32 = 67e12          # FP32 operations a second, outside tensor cores
PEAK_BYTES = 3.35e12       # HBM bytes a second
# momentum-CV bar (%) of the sampled runs: the reference's 0.05 %
# (RT_bench.py:1310), except golden_strat_op11.  There the JAX package
# itself gives 0.0565 % on the same parity table, step and fan (float32;
# tests/test_torch_strat.py::test_golden_strat_op11_cv_matches_jax): the
# parity form's bilinear n and separately fitted gradient break the
# anisotropic momentum invariant by that much (its C1 twin gives 0.0215 %,
# the analytic field 0.0216 %), so the run is held to 0.06 %
CV_BAR = {"golden_strat_op11": 0.06}


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


#: the rays of the head a plain version runs on to count its operations
HEAD_RAYS = 8
#: the aten operations that are FP32 arithmetic (one per element)
_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt", "exp",
          "floor", "clamp", "clamp_min", "clamp_max", "minimum", "maximum",
          "abs", "cos", "sin", "gt", "lt", "ge", "le", "eq", "ne", "tan",
          "tanh", "atan", "atan2", "log", "log1p", "expm1"}


class _OpCounter(TorchDispatchMode):
    """Counts the elementwise floating-point arithmetic a plain version
    performs on a head of HEAD_RAYS rays: a call with a floating-point
    tensor operand counts the elements it computes a ray (at least 1, so a
    per-step scalar counts once); integer index arithmetic is not counted,
    nor anything while ``paused``."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not self.paused
                and func.overloadpacket.__name__.rstrip("_") in _ARITH
                and any(torch.is_tensor(a) and a.is_floating_point()
                        for a in args)):
            self.n += (max(1, out.numel() // HEAD_RAYS)
                       if torch.is_tensor(out) else 1)
        return out


def ops_per_step(plain, charges=None):
    """FP32 operations a ray-step of a kernel: its plain version, which
    performs the kernel's operations one torch call each (a call may
    compute several elements a ray), run on a head of HEAD_RAYS rays for 1
    and 2 steps (``plain(steps)``) under a counter; selects, gathers and
    copies are not arithmetic and are not counted; each fused multiply-add
    (fma32) is charged what its FFMA does (:func:`fma_charged`).
    ``charges(counter)``, a context manager, may charge some calls what the
    kernel does in their place (:func:`exact_products_charged`)."""
    counts = []
    for k in (1, 2):
        with _OpCounter() as c, fma_charged(c), (
                charges(c) if charges else contextlib.nullcontext()):
            plain(k)
        counts.append(c.n)
    return counts[1] - counts[0]


#: what a fused multiply-add (utils/fma.py::fma32, one FFMA in the kernels)
#: costs: a multiply and an add, 2 operations at a peak that counts an FMA
#: as 2
FMA_OPS = 2


@contextlib.contextmanager
def fma_charged(counter):
    """The plain versions' fma32 calls (the 2-D grid blend's, float64
    operations that round once to float32) charged to ``counter`` at
    FMA_OPS an element a ray, the FFMA that the kernel issues."""
    from unittest import mock

    from raytracing_tpu_torch.utils import fma
    inner = fma.fma32

    def fma32(a, b, c, **negations):
        counter.paused = True
        try:
            out = inner(a, b, c, **negations)
        finally:
            counter.paused = False
        counter.n += FMA_OPS * max(1, out.numel() // HEAD_RAYS)
        return out

    with mock.patch.object(fma, "fma32", fma32):
        yield


#: what the df kernels' exact product costs: p = a * b and its error
#: fmaf(a, b, -p), one FMUL and one FFMA, 3 operations at a peak that
#: counts an FMA as 2 (csrc/df.cuh)
EXACT_PRODUCT_OPS = 3


@contextlib.contextmanager
def exact_products_charged(counter):
    """The df plain versions' exact products (``two_prod``, Dekker's 17
    operations, kept for bit parity with JAX) charged to ``counter`` at
    EXACT_PRODUCT_OPS an element a ray, the work the function needs on this
    card; ``two_prod_const``, which is not exact, keeps its count."""
    from unittest import mock

    from raytracing_tpu_torch.engine import df_grid as dg
    from raytracing_tpu_torch.kernels import df as kdf
    dekker = kdf.two_prod

    def two_prod(a, b):
        counter.paused = True
        try:
            p, e = dekker(a, b)
        finally:
            counter.paused = False
        counter.n += EXACT_PRODUCT_OPS * max(1, p.numel() // HEAD_RAYS)
        return p, e

    with mock.patch.object(kdf, "two_prod", two_prod), \
            mock.patch.object(dg, "two_prod", two_prod):
        yield


def state_bytes(*states):
    """Bytes of every tensor in the given states (each read or written once)."""
    return sum(t.numel() * t.element_size() for st in states for t in st
               if torch.is_tensor(t))


def live_ray_steps(dist_sim, ds, steps):
    """Ray-steps this run's rays integrated before they froze: each ray's
    dist_sim over the step, rounded (a step moves ds, or its chord)."""
    return float(torch.clamp(torch.round(dist_sim.double() / float(ds)),
                             max=steps).sum())


def warp_efficiency(dist_sim, ds, steps):
    """bench.warp_efficiency of the rays' lifetimes: each ray's dist_sim
    over the step, as :func:`live_ray_steps` counts it."""
    from raytracing_tpu_torch import bench
    life = torch.clamp(torch.round(dist_sim.double() / float(ds)), max=steps)
    return bench.warp_efficiency(life.cpu().numpy())


def refill_line(field, op, st, out, ds, steps):
    """The refill loop's grid (fused_step's, or the golden loop's for a
    golden op) and the warp efficiency one ray a thread would give on this
    run, as one line's text."""
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg
    n = st.x.shape[0]
    blocks = (kg.refill_grid(field, op, n) if op in kg.GOLDEN_OPS else
              kfu.refill_grid(field, op, n, stats=st.mom_count is not None))
    return (f"grid {blocks} blocks x 128 for {n} rays "
            f"({n / (blocks * 128):.2f} rays a thread), warp efficiency one "
            f"ray a thread {warp_efficiency(out.dsim - st.dsim, ds, steps):.3f}")


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for
    ``ops`` FP32 operations and ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def fan(scen, rays, rng=None):
    """The scenario's launch fan resized to ``rays`` (bench.py::_fan), with
    optional uniform jitter of +-1e-3 rad on the launch angles."""
    pos0, theta0 = launch_fan(scen, rays)
    return pos0, (theta0 if rng is None else jittered(theta0, rng))


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
          f"count {torch.cuda.device_count()}, imports and CUDA start "
          f"{time.perf_counter() - T_IMPORTS:.1f} s", flush=True)
    print(smi.splitlines()[0], flush=True)
    return name, smi.splitlines()[0]


def phase_build():
    from raytracing_tpu_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"[build] {path.name} from {build.CSRC} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def kernel_infos():
    """The twenty-two kernels' KernelInfos, analytic first, then the
    dynamic three, the four df32 ones, the two custom-medium ones, the two
    3-D ones and the two 3-D dynamic ones."""
    from raytracing_tpu_torch.kernels import custom as kc
    from raytracing_tpu_torch.kernels import dynamic as kd
    from raytracing_tpu_torch.kernels import dynamic3d as kd3
    from raytracing_tpu_torch.kernels import fisheye as kf
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import fused3d as kf3
    from raytracing_tpu_torch.kernels import golden as kg
    from raytracing_tpu_torch.kernels import df as kdf
    return (kf.KERNEL, kfu.KERNEL, kg.KERNEL, kfu.KERNEL_STRAT,
            kg.KERNEL_STRAT, kfu.KERNEL_GRID, kg.KERNEL_GRID,
            kfu.KERNEL_SWEEP_GRID, kfu.KERNEL_NODES) + kd.KERNELS + kdf.KERNELS \
        + (kc.KERNEL_FUSED, kc.KERNEL_GOLDEN) + kf3.KERNELS + kd3.KERNELS


def phase_kernel_vs_plain(device, rays=RAYS_CHECK, cap=STEP_CAP):
    """Every kernel against its plain version; returns {kernel: Errors}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
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
    for n in (steps, steps - 1):      # an even and an odd count
        kx, ky, ktt = kf.fisheye_op1(x, y, ux, uy, ds, n)
        px, py, ptt = kf.fisheye_op1_plain(x, y, ux, uy, ds, n)
        errs["fisheye_op1"].compare(
            f"fisheye_op1 {n} steps", torch.stack([kx, ky], -1),
            torch.stack([px, py], -1), ktt, ptt, None, None,
            POS_TOL["fisheye"], tt_rel=TT_REL_TOL)
        if not all(torch.equal(k, p) for k, p in ((kx, px), (ky, py),
                                                  (ktt, ptt))):
            fail(f"fisheye_op1 {n} steps: x, y or tt differs from the "
                 "plain version's bits")
        print("    x, y and tt equal to the bit", flush=True)

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
            p = replay.fused_plain(st, **kw)
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
        g = torch.zeros(2, dtype=torch.float64, device=device)
        p = replay.golden_plain(st, scal, field=field, op=op, steps=steps,
                                box=tuple(scen.box), iters=it, polish=pol,
                                guards=g)
        exact(errs["golden_step"],
              f"golden_step {op} {field} iters={it} polish={pol} {steps} "
              "steps", k, p)
        guard_line(g)

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
    plain_ms, (px, py, ptt) = cuda_ms(
        lambda: kf.fisheye_op1_plain(x, y, torch.cos(th), torch.sin(th), ds,
                                     steps))
    dpos = float((pos - torch.stack([px, py], -1)).abs().max())
    errs["fisheye_op1"].pos = max(errs["fisheye_op1"].pos, dpos)
    # a comparison launch, not the main path's: its count is taken back
    counted = kf.KERNEL.launches
    kx, ky, ktt = kf.fisheye_op1(x, y, torch.cos(th), torch.sin(th), ds,
                                 steps)
    kf.KERNEL.launches = counted
    if not all(torch.equal(k, p) for k, p in ((kx, px), (ky, py),
                                              (ktt, ptt))):
        fail(f"headline: fisheye_op1's {steps} steps differ from the plain "
             "version's bits (x, y or tt)")
    rate = rays * steps / med
    print(f"[headline] fisheye op1 {rays} rays x {steps} steps: "
          f"{med * 1e3:.3f} ms median of {len(times)} "
          f"({rate:.4e} ray-steps/s), closure {closure:.6f} % (bar < 5), "
          f"plain version {plain_ms:.1f} ms, |dpos| vs plain {dpos:.3e} "
          "(x, y and tt equal to the bit)", flush=True)
    if not closure < 5.0:
        fail(f"headline closure {closure} % >= 5 %")
    if not dpos <= POS_TOL["fisheye"]:
        fail(f"headline kernel disagrees with its plain version: {dpos}")
    # the bound: every ray integrates every step (the fisheye never exits);
    # 4 input and 3 output planes
    ops = ops_per_step(lambda k: kf.fisheye_op1_plain(
        x[:HEAD_RAYS], y[:HEAD_RAYS], torch.cos(th[:HEAD_RAYS]),
        torch.sin(th[:HEAD_RAYS]), ds, k))
    bms, by = bound(ops * rays * steps, 7 * 4 * rays)
    print(f"  fisheye_op1 bound {bms:.3f} ms ({by}: {ops} FP32 ops a "
          f"ray-step)", flush=True)
    return {"fisheye_op1": dict(ms=med * 1e3, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by)}


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


def timed_bound(kernel, plain, st, out, tables, ds, steps):
    """(bound_ms, bound_by, ops a ray-step) of one kernel launch: its
    operations over this run's live ray-steps, its bytes the state planes
    in and out and the medium's table, each once."""
    ops = ops_per_step(plain)
    nbytes = state_bytes(st, out) + (0 if tables is None
                                     else state_bytes([tables.table]))
    bms, by = bound(ops * live_ray_steps(out.dsim, ds, steps), nbytes)
    print(f"    {kernel} bound {bms:.3f} ms ({by}: {ops} FP32 ops a "
          f"ray-step)", flush=True)
    return bms, by


def head(st, n=HEAD_RAYS):
    """The first ``n`` rays of a resume state (for counting operations)."""
    return type(st)(*(None if t is None else t[:n].contiguous() for t in st))


def compare_run(device, errs, times, name, r, field):
    """One main-path run's fast_trace result against the plain version of
    its kernel on the same inputs, and the kernel's time there by direct
    launches (not counted: the path's counts were read before).  A run of
    more than MAIN_PLAIN_CAP steps is compared, and its plain version
    timed, at that depth: the kernel launched directly for MAIN_PLAIN_CAP
    steps (its step limit) against the plain version for as many."""
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg

    box = tuple(r.scen.box)
    tables = None if isinstance(field, str) else field
    suffix = {type(None): "", kfu.StratTables: "_strat",
              kfu.GridTables: "_grid"}[type(tables)]
    depth = min(r.steps, MAIN_PLAIN_CAP)
    if r.op in kg.GOLDEN_OPS:
        kernel = "golden_step" + suffix
        it, pol = kg.golden_schedule()
        st = kg.initial_state(r.op, r.pos0, r.theta0, r.scen.gamma,
                              field=field, with_stats=r.stats, device=device)

        def launch(steps):
            scal = kg.golden_scalars(r.ds, r.scen.gamma, steps, 0.0, it,
                                     device=device)
            return kg.golden_step(st, scal, field=field, op=r.op, steps=steps,
                                  box=box)

        def plain(s, steps):
            scal = kg.golden_scalars(r.ds, r.scen.gamma, depth, 0.0, it,
                                     device=device)
            return kg.golden_step_plain(s, scal, field=field, op=r.op,
                                        steps=steps, box=box, iters=it,
                                        polish=pol)
        tol = dict(pos_tol=POS_TOL_GOLDEN, tt_abs=TT_ABS_TOL_GOLDEN)
    else:
        kernel = "fused_step" + suffix
        st = kfu.initial_state(r.op, r.pos0, r.theta0, field=field,
                               with_stats=r.stats, device=device)
        kw = dict(field=field, op=r.op, delta_s=r.ds, offset=0.0, box=box)

        def launch(steps):
            return kfu.fused_step(st, steps=steps, step_limit=steps, **kw)

        def plain(s, steps):
            return kfu.fused_step_plain(s, steps=steps, step_limit=depth,
                                        **kw)
        interface = r.scen.field == "interface"
        tol = dict(pos_tol=POS_TOL_OP7 if r.op == "op7" or interface
                   else POS_TOL[r.scen.field], tt_rel=TT_REL_TOL)
    k_ms, out = cuda_ms(lambda: launch(r.steps), reps=3)
    if name in FULL_DEPTH:
        # the refill loop at full depth, against the replayed plain version
        # (every plane) and the main path's own result
        from raytracing_tpu_torch.bench import replay
        depth = r.steps
        p_ms, p = cuda_ms(lambda: replay.fused_plain(
            st, steps=depth, step_limit=depth, **kw))
        exact(errs[kernel], f"{kernel} {name} {r.op} {st.x.shape[0]} x "
              f"{depth} steps (full depth, plain replayed)", out, p)
        same_final(f"{kernel} {name}: fast_trace against a direct launch",
                   r.res, kfu.final_from_state(out))
        print(f"    kernel {k_ms:.3f} ms, plain (replayed) {p_ms:.1f} ms; "
              f"{refill_line(field, r.op, st, out, r.ds, r.steps)}",
              flush=True)
        if TIMED_SHAPE[kernel] == name:
            bms, by = timed_bound(kernel, lambda k: plain(head(st), k), st,
                                  out, tables, r.ds, r.steps)
            times[kernel] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                 bound_by=by)
        return
    p_ms, p = cuda_ms(lambda: plain(st, depth))
    if depth == r.steps:
        kpos, ktt, kact = r.res.pos, r.res.traveltime, r.res.active
    else:
        k = launch(depth)
        kpos, ktt, kact = torch.stack([k.x, k.y], -1), k.tt, k.active
    errs[kernel].compare(
        f"{kernel} {name} {r.op} {st.x.shape[0]} x {depth} of {r.steps} "
        "steps", kpos, torch.stack([p.x, p.y], -1), ktt, p.tt, kact,
        p.active, **tol)
    print(f"    kernel {k_ms:.3f} ms ({r.steps} steps), plain {p_ms:.1f} ms "
          f"({depth} steps)", flush=True)
    if TIMED_SHAPE[kernel] == name:
        bms, by = timed_bound(kernel, lambda k: plain(head(st), k), st, out,
                              tables, r.ds, r.steps)
        times[kernel] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                             bound_by=by)


def phase_main_shapes(device, errs, runs):
    """Each scenario's fast_trace result against the kernel's plain version
    on the same inputs, at the full shape and step count; and the kernel's
    own time there, by direct launches made after the main path's counts
    were read.  Returns {kernel: times} at :data:`TIMED_SHAPE`."""
    times = {}
    print("[main-shapes] fast_trace against the plain version, same inputs",
          flush=True)
    for name, r in runs.items():
        compare_run(device, errs, times, name, r, r.scen.field)
    # fused_step's two loops (csrc/fused.cuh, Refills), a run held above on
    # each side: the interface refills, the fisheye's one ray repeated runs
    # one ray a thread
    from raytracing_tpu_torch.kernels import fused as kfu
    for name, refills in (("interface", True), ("fisheye", False)):
        r = runs[name]
        blocks = kfu.refill_grid(r.scen.field, r.op, RAYS_MAIN, stats=r.stats)
        print(f"  fused_step {name} {r.op}: " + (
            f"refill loop, {blocks} blocks x 128" if blocks else
            "one ray a thread"), flush=True)
        if (blocks > 0) != refills:
            fail(f"fused_step {name} took the wrong loop")
    # the golden loop's two (csrc/golden.cuh, GoldRefills): aniso refills
    from raytracing_tpu_torch.kernels import golden as kg
    r = runs["aniso"]
    blocks = kg.refill_grid(r.scen.field, r.op, RAYS_MAIN)
    print(f"  golden_step aniso {r.op}: refill loop, {blocks} blocks x 128",
          flush=True)
    if blocks <= 0:
        fail("golden_step aniso took the wrong loop")
    return times


def build_sampled_media(device):
    """The reference's sampled media on the card, built once
    (``bench.sampled_media``)."""
    from raytracing_tpu_torch.bench import sampled_media
    t0 = time.perf_counter()
    media = sampled_media(device)
    sync()
    g = media[("grid", "fisheye")]
    print(f"[media] built in {time.perf_counter() - t0:.1f} s: interface "
          f"{media[('strat', 'interface')].ny} nodes, vert "
          f"{media[('strat', 'vert')].ny} nodes, fisheye grid {g.ny} x "
          f"{g.nx} nodes", flush=True)
    return media


def kernel_medium(media, kind, scen, ds):
    """The tables a sampled run's kernel reads, made as fast_trace makes
    them: stratified tables trimmed for the box and step, a parity grid
    through its (cached) Hermite form."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine.segmented import grid_tables
    from raytracing_tpu_torch.kernels.fused import strat_tables
    med = media[(kind, scen.name)]
    if kind.endswith("strat"):
        return strat_tables(rtt.compact_for_trace(med, scen.box, ds))
    if kind == "grid":
        med = fast._as_hermite(med)
    return grid_tables(med)


def phase_sampled_kernel_vs_plain(device, media, rays=RAYS_CHECK,
                                  cap=STEP_CAP):
    """The four sampled-media kernels against their plain versions on the
    card; returns {kernel: Errors}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg

    rng = np.random.default_rng(1)
    errs = {k: Errors() for k in ("fused_step_strat", "golden_step_strat",
                                  "fused_step_grid", "golden_step_grid")}
    infos = (kfu.KERNEL_STRAT, kg.KERNEL_STRAT, kfu.KERNEL_GRID,
             kg.KERNEL_GRID)
    before = {k.name: k.launches for k in infos}

    def inputs(scen_name, op, kind):
        scen = rtt.scenario(scen_name)
        ds, div = calibrated_with_fallback(op, scen_name)
        steps = min(cap, scen.max_size(ds, div, 1) - 1)
        pos0, theta0 = fan(scen, rays, rng)
        return (scen, float(ds), steps, pos0, theta0,
                kernel_medium(media, kind, scen, ds))

    print(f"[sampled-vs-plain] {rays} rays, at most {cap} steps, reference "
          "table steps", flush=True)
    fused_media = (("interface", "strat"), ("vert", "strat"),
                   ("vert", "c1_strat"), ("fisheye", "grid"),
                   ("fisheye", "c1_grid"))
    for op in kfu.FUSED_OPS:
        for scen_name, kind in fused_media:
            scen, ds, steps, pos0, theta0, tab = inputs(scen_name, op, kind)
            strat = kind.endswith("strat")
            st = kfu.initial_state(op, pos0, theta0, field=tab,
                                   with_stats=strat, device=device)
            kw = dict(field=tab, op=op, steps=steps, delta_s=ds,
                      step_limit=steps, offset=0.0, box=tuple(scen.box))
            k = kfu.fused_step(st, **kw)
            p = replay.fused_plain(st, **kw)
            tol = (POS_TOL_OP7 if op == "op7" or scen_name == "interface"
                   else POS_TOL[scen.field])
            name = "fused_step_strat" if strat else "fused_step_grid"
            errs[name].compare(
                f"{name} {op} {scen_name} {kind} {steps} steps",
                torch.stack([k.x, k.y], -1), torch.stack([p.x, p.y], -1),
                k.tt, p.tt, k.active, p.active, tol, tt_rel=TT_REL_TOL)

    golden_media = (("strat", None), ("c1_strat", None),
                    ("grid", "fisheye"), ("c1_grid", "fisheye"))
    for op in kg.GOLDEN_OPS:
        for kind, scen_name in golden_media:
            if scen_name is None:   # the vert tables; aniso at gamma 3
                scen_name = "vert" if op in ("op5", "op9") else "aniso"
            scen, ds, steps, pos0, theta0, tab = inputs(scen_name, op, kind)
            strat = kind.endswith("strat")
            it, pol = kg.golden_schedule()
            st = kg.initial_state(op, pos0, theta0, scen.gamma, field=tab,
                                  with_stats=strat, device=device)
            scal = kg.golden_scalars(ds, scen.gamma, steps, 0.0, it,
                                     device=device)
            k = kg.golden_step(st, scal, field=tab, op=op, steps=steps,
                               box=scen.box)
            g = torch.zeros(2, dtype=torch.float64, device=device)
            p = replay.golden_plain(st, scal, field=tab, op=op,
                                    steps=steps, box=tuple(scen.box),
                                    iters=it, polish=pol, guards=g)
            name = "golden_step_strat" if strat else "golden_step_grid"
            exact(errs[name], f"{name} {op} {scen_name} {kind} gamma "
                  f"{scen.gamma} {steps} steps", k, p)
            guard_line(g)

    # resume: k then n - k steps (offset k) equal n steps, one stratified
    # and one grid case of each family
    for op, scen_name, kind in (("op7", "interface", "strat"),
                                ("op6", "fisheye", "c1_grid")):
        scen, ds, steps, pos0, theta0, tab = inputs(scen_name, op, kind)
        st = kfu.initial_state(op, pos0, theta0, field=tab,
                               with_stats=kind.endswith("strat"),
                               device=device)
        kw = dict(field=tab, op=op, delta_s=ds, step_limit=steps,
                  box=tuple(scen.box))
        cut = steps // 3
        resume_check(f"fused_step {op} {scen_name} {kind}",
                     kfu.fused_step(st, steps=steps, offset=0.0, **kw),
                     kfu.fused_step(kfu.fused_step(st, steps=cut, offset=0.0,
                                                   **kw),
                                    steps=steps - cut, offset=float(cut),
                                    **kw))
    for op, scen_name, kind in (("op11", "aniso", "c1_strat"),
                                ("op5", "fisheye", "grid")):
        scen, ds, steps, pos0, theta0, tab = inputs(scen_name, op, kind)
        it, pol = kg.golden_schedule()
        st = kg.initial_state(op, pos0, theta0, scen.gamma, field=tab,
                              with_stats=kind.endswith("strat"),
                              device=device)
        cut = steps // 3

        def run(s, n, off):
            scal = kg.golden_scalars(ds, scen.gamma, steps, off, it,
                                     device=device)
            return kg.golden_step(s, scal, field=tab, op=op, steps=n,
                                  box=scen.box)

        resume_check(f"golden_step {op} {scen_name} {kind}",
                     run(st, steps, 0.0),
                     run(run(st, cut, 0.0), steps - cut, float(cut)))
    for k in infos:
        delta = k.launches - before[k.name]
        print(f"  {k.name}: {delta} launches in this phase", flush=True)
        if delta <= 0:
            fail(f"{k.name} was not launched against its plain version")
    return errs


#: the refill cases' ray counts: one ray, the 42 launch angles once, a
#: ragged 4097, and the main path's 2**20 plus a ragged 17
REFILL_RAYS = (1, 42, 4097, RAYS_MAIN + 17)


def refill_inputs(media, kind, rays, rng):
    """(field, pos0, theta0, ds, steps, box) of the interface fan on the
    analytic field at SIGMA/5 (kind "analytic", 7557 steps) or on the parity
    table at the reference table's op6 step (kind "strat", 3854 steps): the
    main path's two interface runs, resized to ``rays`` with jitter."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    scen = rtt.scenario("interface")
    pos0, theta0 = fan(scen, rays, rng)
    if kind == "analytic":
        ds = config.SIGMA / 5.0
        return "interface", pos0, theta0, ds, scen.max_size(ds) - 1, \
            tuple(scen.box)
    ds, div = calibrated_with_fallback("op6", "interface")
    return (kernel_medium(media, "strat", scen, ds), pos0, theta0, float(ds),
            scen.max_size(ds, div, 1) - 1, tuple(scen.box))


def phase_refill_vs_plain(device, media, errs):
    """The refill loop of fused_step and fused_step_strat against the plain
    version (replayed), every plane to the bit, where refills happen: the
    interface fan at full depth at REFILL_RAYS rays; op7's window and the
    Welford stats across refills; a step limit below most lifetimes; a
    resume chain of uneven segments against one launch.  Each line gives
    the refill grid and the warp efficiency one ray a thread would have."""
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import fused as kfu

    rng = np.random.default_rng(3)
    infos = {"analytic": kfu.KERNEL, "strat": kfu.KERNEL_STRAT}
    before = {k: info.launches for k, info in infos.items()}
    print("[refill-vs-plain] the interface fan, analytic (SIGMA/5) and "
          "parity table (op6 reference step), full depth", flush=True)
    for kind, info in infos.items():
        e = errs[info.name]
        for rays in REFILL_RAYS:
            field, pos0, theta0, ds, steps, box = refill_inputs(
                media, kind, rays, rng)
            st = kfu.initial_state("op6", pos0, theta0, field=field,
                                   with_stats=False, device=device)
            kw = dict(field=field, op="op6", steps=steps, delta_s=ds,
                      step_limit=steps, offset=0.0, box=box)
            k = kfu.fused_step(st, **kw)
            exact(e, f"{info.name} op6 {rays} rays x {steps} steps", k,
                  replay.fused_plain(st, **kw))
            print(f"    {refill_line(field, 'op6', st, k, ds, steps)}",
                  flush=True)
        rays = RAYS_CHECK + 17
        field, pos0, theta0, ds, steps, box = refill_inputs(media, kind, rays,
                                                            rng)
        st = kfu.initial_state("op7", pos0, theta0, field=field,
                               with_stats=True, device=device)
        kw = dict(field=field, op="op7", delta_s=ds, box=box)
        one = kfu.fused_step(st, steps=steps, step_limit=steps, offset=0.0,
                             **kw)
        exact(e, f"{info.name} op7 with stats {rays} rays x {steps} steps",
              one, replay.fused_plain(st, steps=steps, step_limit=steps,
                                      offset=0.0, **kw))
        print(f"    {refill_line(field, 'op7', st, one, ds, steps)}",
              flush=True)
        short = dict(steps=steps, step_limit=250.0, offset=0.0, **kw)
        exact(e, f"{info.name} op7 with stats, step limit 250 of {steps}",
              kfu.fused_step(st, **short), replay.fused_plain(st, **short))
        chain, done, segs = st, 0, []
        for seg in (1, 300, 37, 2000, steps):
            seg = min(seg, steps - done)
            chain = kfu.fused_step(chain, steps=seg, step_limit=steps,
                                   offset=float(done), **kw)
            done += seg
            segs.append(seg)
        resume_check(f"{info.name} op7 with stats, segments {segs}", one,
                     chain)
    for kind, info in infos.items():
        delta = info.launches - before[kind]
        print(f"  {info.name}: {delta} launches in this phase", flush=True)


#: the golden refill cases' ray counts: one ray, aniso's 31 launch angles
#: once, a ragged 4097, and the main path's 2**20 plus a ragged 17
GOLDEN_REFILL_RAYS = (1, 31, 4097, RAYS_MAIN + 17)


def golden_refill_inputs(media, kind, rays):
    """(scenario, field, pos0, theta0, ds, steps, depth) of aniso's op11
    fan resized to ``rays``: on the parity vert table at the reference
    table's step (kind "strat": golden_strat_op11, 4142 steps) or on the
    analytic field at SIGMA/1.2 (kind "analytic", 1814 steps); ``depth``
    is a launch's steps under that step limit by which every ray of the
    fan has left the box (lifetimes 121-395 and 53-173 steps,
    bench/lifetimes.py --candidates)."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    scen = rtt.scenario("aniso")
    pos0, theta0 = fan(scen, rays)
    if kind == "analytic":
        ds = config.SIGMA / 1.2
        return (scen, scen.field, pos0, theta0, float(ds),
                scen.max_size(ds) - 1, 200)
    ds, div = calibrated_with_fallback("op11", "aniso")
    return (scen, kernel_medium(media, "strat", scen, ds), pos0, theta0,
            float(ds), scen.max_size(ds, div, 1) - 1, 450)


def phase_golden_refill_vs_plain(device, media, errs):
    """The golden loop's refill (golden_step_strat, and golden_step on the
    analytic field) against the plain version (replayed), every plane to
    the bit, the Welford tracker carried across refills: aniso's op11 fan
    at GOLDEN_REFILL_RAYS rays, each ray's whole life; a step limit below
    most lifetimes; a resume chain of uneven segments against one launch.
    Each line gives the refill grid, the warp efficiency one ray a thread
    would have and the modelled guard failures."""
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import golden as kg

    infos = {"strat": kg.KERNEL_STRAT, "analytic": kg.KERNEL}
    before = {k: info.launches for k, info in infos.items()}
    it, pol = kg.golden_schedule()
    print("[refill-vs-plain] the golden loop on aniso's op11 fan, parity "
          "table (golden_strat_op11) and analytic (SIGMA/1.2), with the "
          "tracker, each ray's whole life", flush=True)
    for kind, info in infos.items():
        e = errs[info.name]

        def run(st, scen, field, ds, limit, n, off=0.0):
            scal = kg.golden_scalars(ds, scen.gamma, limit, off, it,
                                     device=device)
            return kg.golden_step(st, scal, field=field, op="op11", steps=n,
                                  box=scen.box)

        def plain(st, scen, field, ds, limit, n, guards=None):
            scal = kg.golden_scalars(ds, scen.gamma, limit, 0.0, it,
                                     device=device)
            return replay.golden_plain(st, scal, field=field, op="op11",
                                       steps=n, box=tuple(scen.box),
                                       iters=it, polish=pol, guards=guards)

        for rays in GOLDEN_REFILL_RAYS:
            scen, field, pos0, theta0, ds, steps, depth = \
                golden_refill_inputs(media, kind, rays)
            st = kg.initial_state("op11", pos0, theta0, scen.gamma,
                                  field=field, with_stats=True,
                                  device=device)
            k = run(st, scen, field, ds, steps, depth)
            g = torch.zeros(2, dtype=torch.float64, device=device)
            exact(e, f"{info.name} op11 {rays} rays x {depth} of {steps} "
                  "steps", k, plain(st, scen, field, ds, steps, depth, g))
            if bool(k.active.any()):
                fail(f"{info.name}: a ray outlived {depth} steps")
            print(f"    {refill_line(field, 'op11', st, k, ds, steps)}",
                  flush=True)
            guard_line(g)
        scen, field, pos0, theta0, ds, steps, depth = golden_refill_inputs(
            media, kind, RAYS_CHECK + 17)
        st = kg.initial_state("op11", pos0, theta0, scen.gamma, field=field,
                              with_stats=True, device=device)
        short = 150.0 if kind == "strat" else 80.0
        exact(e, f"{info.name} op11, step limit {short:g} of {steps}",
              run(st, scen, field, ds, short, depth),
              plain(st, scen, field, ds, short, depth))
        one = run(st, scen, field, ds, steps, depth)
        chain, done, segs = st, 0, []
        for seg in (1, 37, 120, depth):
            seg = min(seg, depth - done)
            chain = run(chain, scen, field, ds, steps, seg, float(done))
            done += seg
            segs.append(seg)
        resume_check(f"{info.name} op11 with the tracker, segments {segs}",
                     one, chain)
    for kind, info in infos.items():
        delta = info.launches - before[kind]
        print(f"  {info.name}: {delta} launches in this phase", flush=True)


#: the dynamic refill cases' ray counts: one ray, 31, a ragged 4097, and
#: the main path's 2**20 plus a ragged 17
DYN_REFILL_RAYS = (1, 31, 4097, RAYS_MAIN + 17)
#: the vert_strat run's step and budget, and a launch's steps by which
#: every ray of its fan has left the box (lifetimes 157-405 steps,
#: bench/lifetimes.py --candidates)
DYN_REFILL_DS, DYN_REFILL_STEPS, DYN_REFILL_DEPTH = 0.0193, 2000, 450


def phase_dynamic_refill_vs_plain(device, media, errs):
    """dynamic_step_strat's refill loop (csrc/dynamic.cu
    dynamic_kernel_refill) against dynamic_step_plain (replayed), all 18
    planes to the bit, where refills happen: the dynamic main path's
    vert_strat fan ((-2, -2), angles U[0.05, 1.5]) on the parity and C1
    tables, op6 and op8, at DYN_REFILL_RAYS rays over each ray's whole life;
    a step limit below most lifetimes; a resume chain of uneven segments
    against one launch.  Each line gives the refill grid and the warp
    efficiency one ray a thread would have."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import dynamic as kd

    vert = rtt.scenario("vert")
    ds = float(np.float32(DYN_REFILL_DS))
    box = tuple(vert.box)
    info = kd.KERNEL_STRAT
    e = errs[info.name]
    before = info.launches
    t0 = time.perf_counter()

    def fan_state(rays):
        th = np.random.default_rng(0).uniform(0.05, 1.5, rays).astype(
            np.float32)
        return kd.initial_dyn_state(np.full((rays, 2), -2.0, np.float32), th,
                                    device=device)

    print(f"[refill-vs-plain] dynamic_step_strat on the vert_strat fan, ds "
          f"{ds:g}, {DYN_REFILL_DEPTH} of {DYN_REFILL_STEPS} steps (each "
          "ray's whole life)", flush=True)
    for kind in ("strat", "c1_strat"):
        tables = kernel_medium(media, kind, vert, ds)
        for op in ("op6", "op8"):
            for rays in DYN_REFILL_RAYS:
                st = fan_state(rays)
                kw = dict(field=tables, op=op, steps=DYN_REFILL_DEPTH,
                          delta_s=ds, step_limit=DYN_REFILL_STEPS,
                          offset=0.0, box=box)
                k = kd.dynamic_step(st, **kw)
                e.pos = max(e.pos, dyn_exact(
                    f"dynamic_step_strat {op} {kind} {rays} rays x "
                    f"{DYN_REFILL_DEPTH} of {DYN_REFILL_STEPS} steps", k,
                    replay.dynamic_plain(st, **kw)))
                if bool(k.active.any()):
                    fail(f"dynamic_step_strat: a ray outlived "
                         f"{DYN_REFILL_DEPTH} steps")
                blocks = kd.refill_grid(tables, op, rays)
                print(f"    grid {blocks} blocks x 128 for {rays} rays "
                      f"({rays / (blocks * 128):.2f} rays a thread), warp "
                      "efficiency one ray a thread "
                      f"{warp_efficiency(k.dsim, ds, DYN_REFILL_STEPS):.3f}",
                      flush=True)
            st = fan_state(RAYS_CHECK + 17)
            kw = dict(field=tables, op=op, delta_s=ds, box=box)
            short = dict(steps=DYN_REFILL_DEPTH, step_limit=120.0,
                         offset=0.0, **kw)
            e.pos = max(e.pos, dyn_exact(
                f"dynamic_step_strat {op} {kind}, step limit 120 of "
                f"{DYN_REFILL_STEPS}", kd.dynamic_step(st, **short),
                replay.dynamic_plain(st, **short)))
            one = kd.dynamic_step(st, steps=DYN_REFILL_DEPTH,
                                  step_limit=DYN_REFILL_STEPS, offset=0.0,
                                  **kw)
            chain, done, segs = st, 0, []
            for seg in (1, 37, 120, DYN_REFILL_DEPTH):
                seg = min(seg, DYN_REFILL_DEPTH - done)
                chain = kd.dynamic_step(chain, steps=seg,
                                        step_limit=DYN_REFILL_STEPS,
                                        offset=float(done), **kw)
                done += seg
                segs.append(seg)
            resume_check(f"dynamic_step_strat {op} {kind}, segments {segs}",
                         one, chain)
    print(f"  {info.name}: {info.launches - before} launches in this phase; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_sampled(device, media, rays=RAYS_MAIN):
    """The sampled main path: the seven runs through fast_trace at the
    reference table's step, each held to its oracle; returns
    {run: (MainRun, kind)}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import SAMPLED_RUNS
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.engine import oracles

    runs = {}
    for name, scen_name, kind, op in SAMPLED_RUNS:
        scen = rtt.scenario(scen_name)
        ds, div = calibrated_with_fallback(op, scen_name)
        steps = scen.max_size(ds, div, 1) - 1
        stats = scen_name in ("vert", "aniso")
        pos0, theta0 = fan(scen, rays)
        t0 = time.perf_counter()
        res = rtt.fast_trace(op, scen, media[(kind, scen_name)], delta_s=ds,
                             pos0=pos0, theta0=theta0, steps=steps,
                             stats=stats, device=device)
        sync()
        secs = time.perf_counter() - t0
        print(f"[sampled] {name}: {scen_name} {op} on {kind} "
              f"engine={res.engine} {rays} rays x {steps} steps in "
              f"{secs:.3f} s", flush=True)
        runs[name] = (MainRun(scen, op, float(ds), steps, stats, pos0, theta0,
                              res), kind)
        if scen.is_interface:
            errs_deg = oracles.snell_errors_from_tangent(res.tangent,
                                                         scen.theta0)
            print(f"  Snell error mean {errs_deg.mean():.4f} deg (bar < 0.2)"
                  f" max {errs_deg.max():.4f} deg (bar < 0.8)", flush=True)
            ok = errs_deg.mean() < 0.2 and errs_deg.max() < 0.8
        elif scen.is_fisheye:
            closure = float(100.0 * torch.linalg.vector_norm(
                res.pos[0] - torch.tensor([1.0, 0.0], device=device))
                / (2 * math.pi))
            print(f"  closure {closure:.6f} % (bar < 5)", flush=True)
            ok = closure < 5.0
        else:
            nf = len(scen.theta0)
            cv = oracles.momentum_cv_pct_from_welford(
                res.mom_count[:nf], res.mom_mean[:nf], res.mom_m2[:nf])
            avg = float(np.mean(cv[1:-1]))
            bar = CV_BAR.get(name, 0.05)
            print(f"  momentum CV {avg:.6f} % (bar < {bar})", flush=True)
            ok = avg < bar
        if not ok:
            fail(f"{name}: oracle missed")
    return runs


def phase_sampled_shapes(device, errs, media, runs):
    """Each sampled run's fast_trace result against the plain version on
    the same inputs at the full shape and step count, and the kernel's
    time there.  Returns {kernel: times} at :data:`TIMED_SHAPE`."""
    times = {}
    print("[sampled-shapes] fast_trace against the plain version, same "
          "inputs", flush=True)
    for name, (r, kind) in runs.items():
        compare_run(device, errs, times, name, r,
                    kernel_medium(media, kind, r.scen, r.ds))
    return times


def exact(errs, label, k, p):
    """A kernel's resume state ``k`` against its plain version's ``p``, to
    the bit: every field equal.  Prints |dpos|, |dtt| and the active flips;
    records |dpos| in ``errs``."""
    dpos = max(float((getattr(k, c) - getattr(p, c)).abs().max())
               for c in ("x", "y", "z") if hasattr(k, c))
    dtt = float((k.tt - p.tt).abs().max())
    flips = int((k.active != p.active).sum())
    same = all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(k, p))
    errs.pos = max(errs.pos, dpos)
    print(f"  {label}: |dpos| {dpos:.3e} |dtt| {dtt:.3e} active flips "
          f"{flips} (bit parity required)", flush=True)
    if not same:
        fail(f"{label}: kernel differs from its plain version")


def same_final(label, a, b, names=("pos", "traveltime", "dist_sim", "active",
                                   "mom_count", "mom_mean", "mom_m2")):
    """Two final bundles (FusedFinal / FastResult / GoldenFinal) equal to the
    bit in every named field both carry."""
    worst, flips = 0.0, 0
    for n in names:
        x, y = getattr(a, n, None), getattr(b, n, None)
        if x is None or y is None:
            if (x is None) != (y is None):
                fail(f"{label}: {n} present in one result only")
            continue
        if x.dtype == torch.bool:
            flips += int((x != y).sum())
        elif not torch.equal(x, y):
            worst = max(worst, float((x - y).abs().max()))
            if worst == 0.0:      # NaN against NaN, or signed zeros
                fail(f"{label}: {n} differs")
    print(f"  {label}: max |d| {worst:.3e}, active flips {flips} "
          "(bit parity required)", flush=True)
    if worst or flips:
        fail(f"{label}: results differ")


def visited_cells(run_plain, tables):
    """Distinct grid cells a plain run of the grid kernel reads: its
    per-cell evaluator wrapped to mark each lookup's row in a mask on the
    card (no host sync, so the run may be replayed from a CUDA graph).  A
    frozen ray still evaluates its (constant) proposed step, so this counts
    at most one cell a ray more than the kernel reads."""
    from raytracing_tpu_torch.engine.segmented import _cells
    from raytracing_tpu_torch.kernels import fused as kfu
    seen = torch.zeros(tables.table.shape[0], dtype=torch.bool,
                       device=tables.table.device)
    inner = kfu.tile_nag_plain

    def recording(g):
        nag = inner(g)

        def rec(x, y):
            ix, iy, _, _ = _cells(x, y, g)
            seen.index_fill_(0, iy.long() * (g.nx - 1) + ix.long(), True)
            return nag(x, y)
        return rec

    kfu.tile_nag_plain = recording
    try:
        run_plain()
    finally:
        kfu.tile_nag_plain = inner
    cells = int(seen.sum())
    if cells == 0:
        fail("the plain run read no grid cell")
    return cells


def phase_sweep_vs_plain(device, media):
    """fused_sweep_grid against its plain version (replayed from a CUDA
    graph, bench/replay.py sweep_plain) on the full fisheye candidate grid,
    parity and C1 grids, op1/op6/op7; times the op1 parity sweep (the
    search's own launch) and its longest candidate alone, the sweep's
    serial-latency figure beside its roofline bound.  Returns (Errors,
    times, the plain op1 parity final positions)."""
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import fused as kfu
    errs = Errors()
    t0 = time.perf_counter()
    scen, _, pos0, theta0, ds, lim = sweep_inputs(device)
    steps = int(lim.max())
    box = tuple(scen.box)
    print(f"[sweep-vs-plain] {len(ds)} candidates (divisor 303 -> 4, ten "
          f"turns), up to {steps} steps, one ray each", flush=True)
    times = plain_pos = None
    for kind in ("grid", "c1_grid"):
        tables = kernel_medium(media, kind, scen, 0.0)
        for op in ("op1", "op6", "op7"):
            st = kfu.initial_state(op, pos0, theta0, field=tables,
                                   with_stats=False, device=device)
            kw = dict(field=tables, op=op, steps=steps, box=box)
            k_ms, k = cuda_ms(lambda: kfu.fused_sweep_grid(st, ds, lim, **kw),
                              reps=3)

            def plain(s, n, d=ds, m=lim):
                return replay.sweep_plain(s, field=tables, op=op, steps=n,
                                          delta_s=d, step_limit=m, box=box)
            p_ms, p = cuda_ms(lambda: plain(st, steps))
            exact(errs, f"fused_sweep_grid {op} {kind}", k, p)
            print(f"    kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms "
                  "(replayed)", flush=True)
            if kind == "grid" and op == "op1":
                plain_pos = torch.stack([p.x, p.y], -1)
                ops = ops_per_step(lambda n: kfu.fused_step_plain(
                    head(st), field=tables, op=op, steps=n,
                    delta_s=ds[:HEAD_RAYS], step_limit=lim[:HEAD_RAYS],
                    offset=0.0, box=box))
                live = float(torch.clamp(torch.round(
                    k.dsim.double() / ds.double()), max=steps).sum())
                cells = visited_cells(lambda: plain(st, steps), tables)
                row = tables.table[0].numel() * tables.table.element_size()
                nbytes = state_bytes(st, k, [ds, lim]) + cells * row
                bms, by = bound(ops * live, nbytes)
                # the longest candidate alone: one chain of dependent steps
                i = int(torch.argmax(lim))
                one = type(st)(*(None if t is None
                                 else t[i:i + 1].contiguous() for t in st))
                a_ms, a = cuda_ms(lambda: kfu.fused_sweep_grid(
                    one, ds[i:i + 1].contiguous(), lim[i:i + 1].contiguous(),
                    **kw), reps=3)
                if not all(x is None or torch.equal(x, y[i:i + 1])
                           for x, y in zip(a, k)):
                    fail("fused_sweep_grid: a candidate alone differs from "
                         "its row of the sweep")
                print(f"    fused_sweep_grid {k_ms:.4f} ms for the "
                      f"{len(ds)} candidates; the longest ({steps} steps) "
                      f"alone {a_ms:.4f} ms, every plane equal to its row "
                      f"(the serial-latency figure); bound {bms:.5f} ms "
                      f"({by}: {ops} FP32 ops a ray-step, {live:.0f} "
                      f"ray-steps, {cells} of {tables.table.shape[0]} cells "
                      "read)", flush=True)
                times = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                             bound_by=by)
    print(f"[sweep-vs-plain] {time.perf_counter() - t0:.1f} s", flush=True)
    return errs, times, plain_pos


def phase_nodes_vs_plain(device, media, rays=RAYS_CHECK, cap=STEP_CAP):
    """fused_step_nodes against its plain version on the parity fisheye
    grid's node table, every fused op, with and without the stats."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine import segmented as seg
    from raytracing_tpu_torch.kernels import fused as kfu
    errs = Errors()
    rng = np.random.default_rng(2)
    scen = rtt.scenario("fisheye")
    nodes = seg.node_tables(fast._as_hermite(media[("grid", "fisheye")]))
    print(f"[nodes-vs-plain] {rays} rays, at most {cap} steps, reference "
          "table steps", flush=True)
    for op in kfu.FUSED_OPS:
        ds, div = calibrated_with_fallback(op, "fisheye")
        steps = min(cap, scen.max_size(ds, div, 1) - 1)
        pos0, theta0 = fan(scen, rays, rng)
        for stats in (False, True):
            st = kfu.initial_state(op, pos0, theta0, field=nodes,
                                   with_stats=stats, device=device)
            kw = dict(field=nodes, op=op, steps=steps, delta_s=float(ds),
                      step_limit=steps, offset=0.0, box=tuple(scen.box))
            exact(errs, f"fused_step_nodes {op} stats={stats} {steps} steps",
                  kfu.fused_step(st, **kw), replay.fused_plain(st, **kw))
    return errs


#: the searches of the search path: (scenario, medium, op) on the media the
#: CLI's --medium auto builds
SEARCHES = (("fisheye", "grid", "op1"), ("interface", "strat", "op6"),
            ("vert", "strat", "op8"), ("aniso", "strat", "op11"))
SEGMENT = 256


def reference_divisor(op, scen_name):
    """The reference's calibrated divisor (calibrated.py): the fisheye's
    ten-turn set (the search's own criterion), SIGMA divisors otherwise."""
    from raytracing_tpu_torch import calibrated as cal
    from raytracing_tpu_torch.config import SIGMA
    if scen_name == "fisheye":
        return cal.FISHEYE_DIVISOR_N10[op]
    return round(SIGMA / cal.calibrated(op, scen_name)[0], 2)


def phase_search_path(device, media, kernels):
    """The search path and this slice's other entry points: delta_s_search
    on the four reference scenarios, the CLI's search mode, grid_trace at
    the headline shape, and segmented_trace (compaction, and a checkpoint
    interrupted and resumed).  Returns what the comparisons need."""
    import tempfile

    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import cli
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine import segmented as seg
    from raytracing_tpu_torch.parallel import sweep

    def counted(fn):
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
        delta = {k.name: k.launches - before[k.name] for k in kernels
                 if k.launches != before[k.name]}
        return out, secs, delta

    out = {"search": {}}
    for scen_name, kind, op in SEARCHES:
        scen = rtt.scenario(scen_name)
        sr, secs, delta = counted(lambda: sweep.delta_s_search(
            op, scen, media[(kind, scen_name)], engine="fused",
            device=device))
        sel = ("no index" if sr.index is None else
               f"index {sr.index} divisor {sr.divisor:g}")
        print(f"[search] {scen_name} {op} on {kind}: {sel} (reference "
              f"calibrated {reference_divisor(op, scen_name)}), "
              f"{len(sr.divisors)} candidates, engine={sr.engine}, "
              f"{secs:.3f} s, launches {delta}", flush=True)
        out["search"][scen_name] = (sr, kind)

    args = ["--scenario", "fisheye", "--op", "1", "--delta-s", "search",
            "--device", str(device)]
    res, secs, delta = counted(lambda: cli.main(args))
    if res is None:
        fail("cli: the search mode found no divisor")
    closure = float(100.0 * torch.linalg.vector_norm(
        res.final.pos[0] - torch.tensor([1.0, 0.0], device=device))
        / (2 * math.pi))
    print(f"[cli] {' '.join(args)}: {secs:.1f} s, display-run closure "
          f"{closure:.6f} % (bar < 5), launches {delta}", flush=True)
    if not closure < 5.0 or "fused_sweep_grid" not in delta:
        fail("cli: the search mode missed its oracle or the sweep kernel")

    scen = rtt.scenario("fisheye")
    ds, div = calibrated_with_fallback("op1", "fisheye")
    steps = scen.max_size(ds, div, 1) - 1
    pos0, theta0 = fan(scen, RAYS_MAIN)
    med = fast._as_hermite(media[("grid", "fisheye")])
    g, secs, delta = counted(lambda: seg.grid_trace(
        "op1", pos0, theta0, float(ds), med, steps=steps,
        box=tuple(scen.box), device=device))
    print(f"[grid_trace] fisheye op1 {RAYS_MAIN} rays x {steps} steps in "
          f"{secs:.3f} s, launches {delta}", flush=True)
    out["grid_trace"] = (g, med, pos0, theta0, float(ds), steps)

    segs = {}
    for scen_name, op, stats in (("interface", "op6", False),
                                 ("aniso", "op11", True)):
        scen = rtt.scenario(scen_name)
        ds, div = calibrated_with_fallback(op, scen_name)
        steps = scen.max_size(ds, div, 1) - 1
        pos0, theta0 = fan(scen, RAYS_MAIN)
        med = rtt.compact_for_trace(media[("strat", scen_name)], scen.box, ds)
        kw = dict(steps=steps, box=tuple(scen.box), medium=med,
                  segment=SEGMENT, with_stats=stats, gamma=scen.gamma,
                  device=device)
        r, secs, delta = counted(lambda: seg.segmented_trace(
            op, pos0, theta0, float(ds), compact=True, compact_every=2, **kw))
        print(f"[segmented] {scen_name} {op} strat {RAYS_MAIN} rays x "
              f"{steps} steps, segment {SEGMENT}, compaction: {secs:.3f} s, "
              f"launches {delta}, {int(r.active.sum())} rays still live",
              flush=True)
        segs[scen_name] = (r, (op, pos0, theta0, float(ds), kw), delta)
    op, pos0, theta0, ds, kw = segs["interface"][1]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.npz"
        cut = (kw["steps"] // (2 * SEGMENT)) * SEGMENT
        _, secs1, _ = counted(lambda: seg.segmented_trace(
            op, pos0, theta0, ds, checkpoint=path, checkpoint_every=4,
            **{**kw, "steps": cut}))
        resumed, secs2, _ = counted(lambda: seg.segmented_trace(
            op, pos0, theta0, ds, checkpoint=path, checkpoint_every=4, **kw))
    print(f"[segmented] interface op6 checkpointed: {cut} steps then resumed "
          f"to {kw['steps']} ({secs1:.3f} + {secs2:.3f} s)", flush=True)
    plain_run = seg.segmented_trace(op, pos0, theta0, ds, **kw)
    segs["checkpoint"] = (resumed, plain_run)
    out["segmented"] = segs
    return out


def phase_search_checks(device, errs, times, media, runs, sruns,
                        sweep_plain_pos):
    """Hold the search path's results to their references: every search's
    candidate metrics to the plain versions', grid_trace to
    grid_trace_tiled (the sampled path's fisheye_grid run) with the
    kernel's time, segmented_trace to one launch (the sampled path's runs)
    and across a checkpoint resume."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.engine import segmented as seg
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg
    from raytracing_tpu_torch.media.samples import compact_for_trace
    from raytracing_tpu_torch.parallel import sweep

    t0 = time.perf_counter()
    print("[search] every candidate's metric against the plain versions' "
          "(replayed from CUDA graphs)", flush=True)
    for scen_name, (sr, kind) in runs["search"].items():
        scen = rtt.scenario(scen_name)
        n = len(sr.delta_s)
        if scen.is_fisheye:
            want = (100.0 / (2.0 * np.pi)) * np.linalg.norm(
                sweep_plain_pos.cpu().numpy() - [1.0, 0.0], axis=1)
            checked = list(range(n))
            got = {"closure_pct": want}
        else:
            sizes = sweep._max_sizes(scen, sr.delta_s, None, 1)
            lim, max_steps = sizes - 1, int(sizes.max()) - 1
            med = compact_for_trace(media[(kind, scen_name)],
                                    scen.box, float(np.max(sr.delta_s)))
            tables = kfu.strat_tables(med)
            pos0, th, nf = sweep.sweep_fan(scen)
            golden = sr.op_name in kg.GOLDEN_OPS
            if golden:
                # the selected candidate and its neighbours, or the first
                # three where nothing was selected
                mid = 1 if sr.index is None else min(max(sr.index, 1), n - 2)
                checked = [mid - 1, mid, mid + 1]
            else:
                checked = list(range(n))
            got = {k: np.full(n, np.nan) for k in sr.metrics}
            if golden:
                it, pol = kg.golden_schedule()
                for i in checked:
                    st = kg.initial_state(sr.op_name, pos0, th, scen.gamma,
                                          field=tables, with_stats=True,
                                          device=device)
                    scal = kg.golden_scalars(np.float32(sr.delta_s[i]),
                                             np.float32(scen.gamma),
                                             np.float32(lim[i]), 0.0, it,
                                             device=device)
                    p = replay.golden_plain(st, scal, field=tables,
                                            op=sr.op_name, steps=max_steps,
                                            box=tuple(scen.box), iters=it,
                                            polish=pol)
                    for k_, v in sweep.candidate_metrics(
                            scen, th, nf, kg.final_from_state(p)).items():
                        got[k_][i] = v
            else:
                # every candidate at once: nf rays each, per-ray step sizes
                # and limits
                ds_r = torch.as_tensor(np.repeat(
                    sr.delta_s.astype(np.float32), nf), device=device)
                lim_r = torch.as_tensor(np.repeat(
                    lim.astype(np.float32), nf), device=device)
                st = kfu.initial_state(
                    sr.op_name, np.tile(pos0, (n, 1)), np.tile(th, n),
                    field=tables, with_stats=scen.is_vert, device=device)
                p = replay.sweep_plain(st, field=tables, op=sr.op_name,
                                       steps=max_steps, delta_s=ds_r,
                                       step_limit=lim_r, box=tuple(scen.box))
                final = kfu.final_from_state(p)
                for i in checked:
                    one = type(final)(*(None if t is None
                                        else t[i * nf:(i + 1) * nf]
                                        for t in final))
                    for k_, v in sweep.candidate_metrics(scen, th, nf,
                                                         one).items():
                        got[k_][i] = v
        worst = max(float(np.max(np.abs(np.asarray(sr.metrics[k])[checked]
                                         - got[k][checked])))
                    for k in sr.metrics)
        print(f"  {scen_name} {sr.op_name}: {len(checked)} of {n} candidates "
              f"against the plain versions, max |d metric| {worst:.3e} "
              "(equality required)", flush=True)
        if worst != 0.0:
            fail(f"search {scen_name}: a candidate metric differs from the "
                 "plain version's")
    print(f"  [search] checks {time.perf_counter() - t0:.1f} s", flush=True)

    g, med, pos0, theta0, ds, steps = runs["grid_trace"]
    tiled = sruns["fisheye_grid"][0].res
    same_final("[grid_trace] grid_trace against grid_trace_tiled (the "
               "fisheye_grid run)", g, tiled,
               names=("pos", "traveltime", "dist_sim", "active"))
    nodes = seg.node_tables(med)
    st = kfu.initial_state("op1", pos0, theta0, field=nodes,
                           with_stats=False, device=device)
    kw = dict(field=nodes, op="op1", delta_s=ds, offset=0.0,
              box=tuple(rtt.scenario("fisheye").box))
    depth = min(steps, MAIN_PLAIN_CAP)
    k_ms, out = cuda_ms(lambda: kfu.fused_step(st, steps=steps,
                                               step_limit=steps, **kw), reps=3)
    p_ms, p = cuda_ms(lambda: kfu.fused_step_plain(st, steps=depth,
                                                   step_limit=depth, **kw))
    same_final("[grid_trace] grid_trace against a direct launch", g,
               kfu.final_from_state(out), names=("pos", "traveltime",
                                                 "active"))
    k = kfu.fused_step(st, steps=depth, step_limit=depth, **kw)
    errs["fused_step_nodes"].pos = max(
        errs["fused_step_nodes"].pos,
        float(torch.stack([p.x - k.x, p.y - k.y], -1).abs().max()))
    same_final(f"[grid_trace] its kernel against the plain version, {depth} "
               f"of {steps} steps", kfu.final_from_state(k),
               kfu.final_from_state(p), names=("pos", "traveltime", "active"))
    bms, by = timed_bound("fused_step_nodes",
                          lambda n: kfu.fused_step_plain(head(st), steps=n,
                                                         step_limit=steps,
                                                         **kw),
                          st, out, nodes, ds, steps)
    print(f"    fused_step_nodes {k_ms:.3f} ms ({steps} steps; "
          f"fused_step_grid on the same run "
          f"{times['fused_step_grid']['ms']:.3f} ms), plain {p_ms:.1f} ms "
          f"({depth} steps)", flush=True)
    times["fused_step_nodes"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                     bound_by=by)

    segs = runs["segmented"]
    for scen_name, run in (("interface", "interface_strat"),
                           ("aniso", "golden_strat_op11")):
        r, (op, pos0, theta0, ds, kw), delta = segs[scen_name]
        same_final(f"[segmented] {scen_name} {op} with compaction against one "
                   f"launch ({run})", r, sruns[run][0].res)
    resumed, uninterrupted = segs["checkpoint"]
    same_final("[segmented] interface op6 checkpoint-resumed against "
               "uninterrupted", resumed, uninterrupted)
    r, (op, pos0, theta0, ds, kw), delta = segs["interface"]
    seg_ms, _ = cuda_ms(lambda: seg.segmented_trace(
        op, pos0, theta0, ds, compact=True, compact_every=2, **kw))
    print(f"    segmented interface op6 with compaction {seg_ms:.3f} ms "
          f"({delta.get('fused_step_strat', 0)} launches), one launch "
          f"{times['fused_step_strat']['ms']:.3f} ms, plain "
          f"{times['fused_step_strat']['plain_ms']:.1f} ms, bound "
          f"{times['fused_step_strat']['bound_ms']:.3f} ms", flush=True)


# -- the dynamic path (kernels/dynamic.py, engine/dynamic.py, eigenray.py) --
DYN_OPS = ("op1", "op2", "op6", "op8")
#: the f64 scan-tier oracle's sample of a main-path fan
DYN_ORACLE_RAYS = 4096
# the JAX package's own kernel-against-scan bars (tests/
# test_dynamic_kernel.py): analytic and stratified :93-100, :136-143 (q and
# dtheta within 2e-3 of their largest magnitude, KMAH on 99 % of the rays);
# the tiled grids :272-278 and :331-335 (q and dtheta rtol 5e-5, C1 q 1e-4,
# atol 1e-6, KMAH equal), which that test holds at its own depth of 400
# steps on this grid and step (GRID_ORACLE_STEPS): over the whole turn the
# kernels' rotated unit tangent drifts off unit norm (8.2e-5 after 4587
# steps), which moves positions 2.6e-4 off the float64 trace, as it moves
# the kinematic kernels'.  After the fisheye's turn q has refocused to ~0,
# so its bar is taken relative to |q| over the whole path, and its
# positions are not barred
DYN_BARS = {
    "fisheye": dict(q_rel=2e-3, kmah_share=1.0),
    "vert_strat": dict(pos=2e-4, tt=2e-4, q_rel=2e-3, dth_rel=2e-3,
                       kmah_share=0.99),
    "fisheye_grid": dict(pos=5e-6, q_rtol=5e-5, dth_rtol=5e-5, atol=1e-6,
                         kmah_share=1.0),
    "fisheye_c1_grid": dict(pos=5e-6, q_rtol=1e-4, atol=1e-6,
                            kmah_share=1.0),
}
GRID_ORACLE_STEPS = 400


def dyn_q(st):
    return st.dpx * (-st.uy) + st.dpy * st.ux


def dyn_exact(label, k, p):
    """A dynamic kernel's 18 planes against its plain version's, to the
    bit; prints the largest |d| of pos, tt, q and dtheta and the KMAH
    mismatches.  Returns |dpos|."""
    dpos = max(float((getattr(k, c) - getattr(p, c)).abs().max())
               for c in ("x", "y", "z") if hasattr(k, c))
    dtt = float((k.tt - p.tt).abs().max())
    dq = float((dyn_q(k) - dyn_q(p)).abs().max())
    ddth = float((k.dth - p.dth).abs().max())
    nk = int((k.kmah != p.kmah).sum())
    same = all(torch.equal(a, b) for a, b in zip(k, p))
    print(f"  {label}: |dpos| {dpos:.3e} |dtt| {dtt:.3e} |dq| {dq:.3e} "
          f"|ddtheta| {ddth:.3e} KMAH mismatches {nk} (bit parity required)",
          flush=True)
    if not same:
        fail(f"{label}: kernel differs from its plain version")
    return dpos


def guard_line(guards):
    """Print the share of ray-steps on which a kernel took an operation's
    IEEE form because a fast path's guard failed: ``guards`` as the plain
    versions' model of the kernels' guards counts them
    (kernels/dynamic.py::dynamic_step_plain,
    kernels/fused3d.py::fused3d_step_plain,
    kernels/golden.py::golden_step_plain: failed, moved).  Modelled, not
    read from the kernel, which does not report its path."""
    failed, moved = (float(v) for v in guards.cpu())
    print(f"    guard failures (modelled) {failed:.0f} of {moved:.0f} "
          f"ray-steps "
          f"({100.0 * failed / max(moved, 1.0):.4f} %)", flush=True)


def dyn_inputs(media, kind, scen_name, op, rays, rng, cap):
    """(scen, ds, steps, pos0, theta0, medium) of one [dynamic-vs-plain]
    case: the analytic fields at the op's calibrated analytic step, the
    sampled media at the reference table's step, at most ``cap`` steps."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    scen = rtt.scenario(scen_name)
    pos0, theta0 = fan(scen, rays, rng)
    if kind == "analytic":
        ds, div = calibrated_step(op, scen_name)
        steps = min(cap, int(div) if scen.is_fisheye
                    else scen.max_size(ds) - 1)
        return scen, ds, steps, pos0, theta0, scen.field
    ds, div = calibrated_with_fallback(op, scen_name)
    steps = min(cap, scen.max_size(ds, div, 1) - 1)
    return (scen, float(ds), steps, pos0, theta0,
            kernel_medium(media, kind, scen, ds))


def phase_dynamic_vs_plain(device, media, rays=RAYS_CHECK, cap=STEP_CAP):
    """The three dynamic kernels against dynamic_step_plain (replayed,
    bench/replay.py) on the card:
    op1/op2/op6/op8 on the analytic fisheye, vert and interface, the parity
    and C1 vert tables and the parity interface table, the parity and C1
    fisheye grids; every plane to the bit, and a resume check a kernel."""
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import dynamic as kd
    rng = np.random.default_rng(3)
    errs = {k.name: Errors() for k in kd.KERNELS}
    before = {k.name: k.launches for k in kd.KERNELS}
    t0 = time.perf_counter()
    cases = ([("analytic", s) for s in ("fisheye", "vert", "interface")]
             + [("strat", "vert"), ("c1_strat", "vert"),
                ("strat", "interface"), ("grid", "fisheye"),
                ("c1_grid", "fisheye")])
    name_of = {"analytic": "dynamic_step", "strat": "dynamic_step_strat",
               "c1_strat": "dynamic_step_strat", "grid": "dynamic_step_grid",
               "c1_grid": "dynamic_step_grid"}
    print(f"[dynamic-vs-plain] {rays} rays, at most {cap} steps", flush=True)
    for op in DYN_OPS:
        for kind, scen_name in cases:
            scen, ds, steps, pos0, theta0, tab = dyn_inputs(
                media, kind, scen_name, op, rays, rng, cap)
            st = kd.initial_dyn_state(pos0, theta0, device=device)
            kw = dict(field=tab, op=op, steps=steps, delta_s=ds,
                      step_limit=steps, offset=0.0, box=tuple(scen.box))
            name = name_of[kind]
            guards = torch.zeros(2, dtype=torch.float64, device=device)
            dpos = dyn_exact(f"{name} {op} {scen_name} {kind} {steps} steps",
                             kd.dynamic_step(st, **kw),
                             replay.dynamic_plain(st, guards=guards, **kw))
            guard_line(guards)
            errs[name].pos = max(errs[name].pos, dpos)
    # resume: k then n - k steps (offset k) equal n steps, one case a kernel
    for kind, scen_name, op in (("analytic", "fisheye", "op6"),
                                ("c1_strat", "vert", "op2"),
                                ("grid", "fisheye", "op8"),
                                ("c1_grid", "fisheye", "op6")):
        scen, ds, steps, pos0, theta0, tab = dyn_inputs(
            media, kind, scen_name, op, rays, rng, cap)
        st = kd.initial_dyn_state(pos0, theta0, device=device)
        kw = dict(field=tab, op=op, delta_s=ds, step_limit=steps,
                  box=tuple(scen.box))
        cut = steps // 3
        resume_check(f"{name_of[kind]} {op} {scen_name} {kind}",
                     kd.dynamic_step(st, steps=steps, offset=0.0, **kw),
                     kd.dynamic_step(kd.dynamic_step(st, steps=cut,
                                                     offset=0.0, **kw),
                                     steps=steps - cut, offset=float(cut),
                                     **kw))
    for k in kd.KERNELS:
        delta = k.launches - before[k.name]
        print(f"  {k.name}: {delta} launches in this phase", flush=True)
        if delta <= 0:
            fail(f"{k.name} was not launched against its plain version")
    print(f"[dynamic-vs-plain] {time.perf_counter() - t0:.1f} s", flush=True)
    return errs


class DynRun(NamedTuple):
    """One run of the dynamic main path: its inputs and fast_dynamic's
    result."""

    scen: Any
    medium: Any
    op: str
    ds: float
    steps: int
    pos0: Any
    theta0: Any
    res: Any


def dyn_main_cases(media, rays):
    """The dynamic main path's runs at full width (the JAX package's
    benchmarks/kernel_matrix.py rows dyn_op6, dyn_strat_op6,
    dyn_tiled_op6): (name, scenario, medium, op, delta_s, steps, pos0,
    theta0)."""
    import raytracing_tpu_torch as rtt
    fish, vert = rtt.scenario("fisheye"), rtt.scenario("vert")
    # the scenario's one ray resized to 2^20 with +-1e-3 rad of jitter
    fpos, fth = fan(fish, rays, np.random.default_rng(0))
    fds = float(np.float32(2.0 * math.pi / HEADLINE_DIVISOR))
    # kernel_matrix.py:85-103, :179-186: (-2, -2), angles U[0.05, 1.5]
    vth = np.random.default_rng(0).uniform(0.05, 1.5, rays).astype(np.float32)
    vpos = np.full((rays, 2), -2.0, np.float32)
    return (
        ("fisheye", fish, rtt.analytic_medium("fisheye"), "op6", fds,
         HEADLINE_DIVISOR, fpos, fth),
        ("vert_strat", vert, media[("strat", "vert")], "op6",
         float(np.float32(0.0193)), 2000, vpos, vth),
        ("fisheye_grid", fish, media[("grid", "fisheye")], "op6", fds,
         HEADLINE_DIVISOR - 1, fpos, fth),
        ("fisheye_c1_grid", fish, media[("c1_grid", "fisheye")], "op6", fds,
         HEADLINE_DIVISOR - 1, fpos, fth),
    )


def phase_dynamic(device, media, rays=RAYS_MAIN):
    """The dynamic main path: each run through fast_dynamic at 2^20 rays;
    returns {run: DynRun}."""
    import raytracing_tpu_torch as rtt
    runs = {}
    for name, scen, med, op, ds, steps, pos0, theta0 in dyn_main_cases(
            media, rays):
        t0 = time.perf_counter()
        res, engine = rtt.fast_dynamic(op, scen, med, delta_s=ds, pos0=pos0,
                                       theta0=theta0, steps=steps,
                                       device=device)
        sync()
        print(f"[dynamic] {name}: {op} engine={engine} {rays} rays x {steps} "
              f"steps in {time.perf_counter() - t0:.3f} s", flush=True)
        runs[name] = DynRun(scen, med, op, ds, steps, pos0, theta0, res)
    return runs


def median_ms(fn, reps=5):
    """Median device time (ms) of ``fn`` over ``reps`` runs after one
    warm-up, each timed by CUDA events."""
    fn()
    times, out = [], None
    for _ in range(reps):
        ms, out = cuda_ms(fn)
        times.append(ms)
    return float(np.median(times)), out


def dyn_kernel_field(r):
    """The tables a dynamic main-path run's kernel reads, made as
    fast_dynamic makes them, and the medium its f64 scan oracle reads (the
    same float32 values)."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine.segmented import grid_tables
    from raytracing_tpu_torch.kernels.fused import strat_tables
    med = r.medium
    if isinstance(med, rtt.AnalyticMedium):
        return med.field, med
    if isinstance(med, fast.STRAT_MEDIA):
        return strat_tables(rtt.compact_for_trace(med, r.scen.box, r.ds)), med
    if isinstance(med, rtt.GridMedium):
        med = fast._as_hermite(med)
    return grid_tables(med), med


def dyn_deviations(label, got, ref, bars, ds, box, q_scale=None):
    """Print a dynamic result's deviations from its float64 scan oracle and
    hold them to ``bars`` (absent keys are not barred); False on a miss."""
    # a ray that grazes the box may leave it one step earlier or later in
    # float32 than in float64 and freeze a step apart: such rays are
    # listed and counted (at most ACTIVE_TOL of them, each out of the box
    # in the float64 run too) and the bars hold on the rest
    same = (got.dist_sim.double() - ref.dist_sim).abs() < 0.5 * ds
    flips = int((~same).sum())
    x, y = ref.pos[:, 0], ref.pos[:, 1]
    inside = (x >= box[0]) & (x <= box[1]) & (y >= box[2]) & (y <= box[3])
    for i in torch.nonzero(~same).flatten().tolist():
        print(f"    ray {i} leaves the box a step apart: dist_sim "
              f"{float(got.dist_sim[i]):.6f} (float32) against "
              f"{float(ref.dist_sim[i]):.6f} (float64), float64 end "
              f"({float(x[i]):.6f}, {float(y[i]):.6f})", flush=True)
    if bool((inside & ~same).any()):
        print("    a ray set aside is still in the box in the float64 run",
              flush=True)
        return False
    got = type(got)(*(t[same] for t in got))
    ref = type(ref)(*(t[same] if torch.is_tensor(t) and t.dim() and
                      t.shape[0] == len(same) else t for t in ref))
    dpos = float((got.pos.double() - ref.pos).abs().max())
    dtt = float((got.traveltime.double() - ref.traveltime).abs().max())
    dq = (got.q.double() - ref.q).abs()
    ddth = (got.dtheta.double() - ref.dtheta).abs()
    share = float((got.kmah == ref.kmah).double().mean())
    q_scale = float(ref.q.abs().max()) if q_scale is None else q_scale
    ok = share >= bars.get("kmah_share", 0.0)
    ok &= flips <= ACTIVE_TOL * len(same)
    ok &= dpos <= bars.get("pos", math.inf)
    ok &= dtt <= bars.get("tt", math.inf)
    ok &= float(dq.max()) <= bars.get("q_rel", math.inf) * q_scale
    ok &= float(ddth.max()) <= bars.get("dth_rel", math.inf) * float(
        ref.dtheta.abs().max())
    atol = bars.get("atol", 0.0)
    ok &= bool((dq <= atol + bars.get("q_rtol", math.inf)
                * ref.q.abs()).all())
    ok &= bool((ddth <= atol + bars.get("dth_rtol", math.inf)
                * ref.dtheta.abs()).all())
    print(f"  {label}: |dpos| {dpos:.3e} |dtt| {dtt:.3e} max |dq| "
          f"{float(dq.max()):.3e} (max |q| {q_scale:.4e}) max |ddtheta| "
          f"{float(ddth.max()):.3e} KMAH equal on {share:.6f}; {flips} rays "
          f"leave the box a step apart (bars {bars})", flush=True)
    return ok


def dyn_oracle(device, name, r):
    """Hold a dynamic main-path run to trace_dynamic at float64 on the card,
    on every 256th ray, at the JAX package's kernel-against-scan bars; the
    grid runs at that test's depth (a launch of GRID_ORACLE_STEPS steps on
    the same rays).  On the sampled media the oracle takes its tangent
    from torch.func.jvp of the op6 step through the medium's own
    n_and_grad (HAND_TANGENT off), not from the 9-channel evaluators the
    kernels and op6's hand step share, so that a wrong table channel
    cannot pass on both sides; the analytic fisheye keeps the hand step
    (2.5x faster there), its closed-form channels held to autodiff by the
    CPU tests and its tangent to the caustic count on every ray."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine import dynamic as edyn
    from raytracing_tpu_torch.kernels import dynamic as kd
    sub = slice(None, None, r.pos0.shape[0] // DYN_ORACLE_RAYS)
    field, med = dyn_kernel_field(r)
    steps = GRID_ORACLE_STEPS if name.endswith("grid") else r.steps
    t0 = time.perf_counter()
    saved, hand = edyn.HAND_TANGENT, isinstance(med, rtt.AnalyticMedium)
    edyn.HAND_TANGENT = hand
    kw = dict(delta_s=r.ds, device=device, mode="history"
              if name == "fisheye" else "metrics", dtype=torch.float64,
              pos0=r.pos0[sub], theta0=r.theta0[sub], max_size=steps + 1,
              step_limit=steps)
    try:
        ref = rtt.trace_dynamic(r.op, r.scen, med, **kw)
        secs = time.perf_counter() - t0
        if name == "fisheye":
            # the same trace inside torch.inference_mode(): the tangent must
            # not change (ROADMAP.md §3, closed in the df32 slice)
            t1 = time.perf_counter()
            with torch.inference_mode():
                inside = rtt.trace_dynamic(r.op, r.scen, med, **kw)
            same = all(torch.equal(getattr(ref, f), getattr(inside, f))
                       for f in ("q", "dtheta", "kmah"))
            print(f"  fisheye under torch.inference_mode(), {len(ref.q)} "
                  f"rays x {steps} steps ({time.perf_counter() - t1:.1f} s):"
                  f" q, dtheta, KMAH {'equal' if same else 'DIFFER'} to the "
                  f"bit; KMAH 1 on {int((inside.kmah == 1).sum())} rays "
                  f"inside, {int((ref.kmah == 1).sum())} outside", flush=True)
            if not (same and bool((inside.kmah == 1).all())):
                fail("fisheye: trace_dynamic differs in inference mode")
    finally:
        edyn.HAND_TANGENT = saved
    if steps == r.steps:
        got = type(r.res)(*(t[sub] for t in r.res))
    else:
        st = kd.dynamic_step(kd.initial_dyn_state(r.pos0[sub], r.theta0[sub],
                                                  device=device),
                             field=field, op=r.op, steps=steps, delta_s=r.ds,
                             step_limit=steps, box=tuple(r.scen.box))
        got = kd.final_from_dyn_state(st, med.n(st.x, st.y))
    # the fisheye's q is held relative to its largest |q| along the path
    scale = (float(ref.history[..., 4].abs().max()) if name == "fisheye"
             else None)
    if not dyn_deviations(
            f"{name} against trace_dynamic f64 ("
            f"{'hand' if hand else 'jvp'} tangent), {len(ref.q)} "
            f"rays x {steps} steps ({secs:.1f} s)", got, ref, DYN_BARS[name],
            r.ds, tuple(r.scen.box), scale):
        fail(f"{name}: the dynamic kernel misses its f64 oracle")


def phase_dynamic_checks(device, errs, runs):
    """The dynamic main path's checks: the fisheye caustic count on every
    ray (f64 scan tier first, then the kernel), each run against
    trace_dynamic at f64 on 4096 rays, each run's fast_dynamic result
    against a direct launch of its kernel, the kernel against
    dynamic_step_plain on the same inputs at 2**20 rays and at most
    MAIN_PLAIN_CAP steps (replayed from a CUDA graph, bench/replay.py),
    and each kernel's time at the full shape.
    Returns {kernel: times}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import dynamic as kd
    print("[dynamic] checks", flush=True)
    r = runs["fisheye"]
    t0 = time.perf_counter()
    full = rtt.trace_dynamic(r.op, r.scen, r.medium, delta_s=r.ds,
                             device=device, mode="metrics",
                             dtype=torch.float64, pos0=r.pos0,
                             theta0=r.theta0, max_size=r.steps + 1,
                             step_limit=r.steps)
    k_scan = int((full.kmah == 1).sum())
    k_kern = int((r.res.kmah == 1).sum())
    print(f"  fisheye one turn: KMAH 1 on {k_scan} of {len(full.kmah)} rays "
          f"(trace_dynamic f64, {time.perf_counter() - t0:.1f} s), on "
          f"{k_kern} (dynamic_step)", flush=True)
    del full
    if k_scan != len(r.res.kmah) or k_kern != len(r.res.kmah):
        fail("fisheye: a ray does not carry KMAH 1 after the turn")
    for name, r in runs.items():
        dyn_oracle(device, name, r)

    times = {}
    timed = {"fisheye": "dynamic_step", "vert_strat": "dynamic_step_strat",
             "fisheye_grid": "dynamic_step_grid"}
    for name, r in runs.items():
        field, _ = dyn_kernel_field(r)
        st = kd.initial_dyn_state(r.pos0, r.theta0, device=device)
        kw = dict(field=field, op=r.op, delta_s=r.ds, offset=0.0,
                  box=tuple(r.scen.box))
        depth = min(r.steps, MAIN_PLAIN_CAP)
        k_ms, out = median_ms(lambda: kd.dynamic_step(
            st, steps=r.steps, step_limit=r.steps, **kw))
        p_ms, p = cuda_ms(lambda: replay.dynamic_plain(
            st, steps=depth, step_limit=depth, **kw))
        kernel = (kd.KERNEL if isinstance(field, str) else kd.KERNEL_STRAT
                  if isinstance(field, kd.StratTables) else kd.KERNEL_GRID)
        same_final(f"[dynamic] {name} fast_dynamic against a direct launch",
                   r.res, kd.final_from_dyn_state(out, r.res.n),
                   names=("pos", "tangent", "traveltime", "dist_sim",
                          "active", "q", "dtheta", "kmah"))
        k = out if depth == r.steps else kd.dynamic_step(
            st, steps=depth, step_limit=depth, **kw)
        dpos = dyn_exact(f"[dynamic] {name} {kernel.name} {r.pos0.shape[0]} "
                         f"rays x {depth} of {r.steps} steps against the "
                         "plain version", k, p)
        errs[kernel.name].pos = max(errs[kernel.name].pos, dpos)
        live = live_ray_steps(out.dsim, r.ds, r.steps)
        rate = live / (k_ms * 1e-3)
        print(f"    {kernel.name} {name}: {k_ms:.3f} ms median of 5 "
              f"({r.steps} steps), {rate:.4e} live ray-steps/s, plain "
              f"{p_ms:.1f} ms ({depth} steps, replayed)", flush=True)
        bms, by = timed_bound(
            kernel.name,
            lambda n: kd.dynamic_step_plain(head(st), steps=n,
                                            step_limit=r.steps, **kw),
            st, out, None if isinstance(field, str) else field, r.ds,
            r.steps)
        if timed.get(name) == kernel.name:
            times[kernel.name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                      bound_by=by)
    return times


def cli_eigenrays(device, timeout=600):
    """``python -m raytracing_tpu_torch.cli --eigenrays`` on the Munk
    profile written to a temporary .npz, as a process of its own (killed
    past ``timeout`` seconds); returns (command, exit code, stdout, stderr,
    seconds)."""
    import os
    import tempfile
    depth, c = munk_profile()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "munk.npz")
        np.savez(path, samples=c.min() / c, y=depth)
        cmd = [sys.executable, "-m", "raytracing_tpu_torch.cli",
               "--medium-file", path, "--family", "c1", "--op", "6",
               "--delta-s-value", "0.01", "--steps", "800", "--eigenrays",
               "0", "-1", "--receiver", "4", "-1", "--receiver", "7",
               "-1.5", "--fan", "-0.3", "0.3", "48", "--box", "-1", "9",
               "-3", "0", "--omega", "40", "--device", str(device)]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    return (cmd, done.returncode, done.stdout, done.stderr,
            time.perf_counter() - t0)


def phase_eigenrays(device):
    """The eigenray solver on the card at float64: the scan tier's aten
    operations a step of the TL map's crossing trace, the Slotnick
    two-point traveltime, and the CLI's --eigenrays run
    (:func:`cli_eigenrays`).  The TL field map of examples/tl_field_map.py
    itself (19 x 12 receivers, fan 256, the example's asserts) runs in
    phase 20, as that example's twin in a process of its own."""
    import raytracing_tpu_torch as rtt

    # the Munk-style profile, source on the channel axis (0, -1)
    depth, c = munk_profile()
    medium = rtt.c1_stratified_from_samples(c.min() / c, depth,
                                            dtype=torch.float64,
                                            device=device)
    ranges = np.linspace(4.0, 40.0, 19)

    # the scan tier's cost a step: the aten operations one step dispatches
    # (each launches at least one kernel), from a 1- and a 2-step crossing
    # trace of the same fan
    class _AllOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    scen = rtt.ScenarioConfig(name="custom", key="-", field="", gamma=1.0,
                              ray_count=256, theta0=np.zeros(1),
                              pos0=np.zeros((1, 2)), s_max=0.0,
                              box=(-1.0, 42.0, -3.0, 0.0))
    counts = []
    for n in (2, 3):
        with _AllOps() as m:
            rtt.trace_crossings_fan(
                "op6", scen, medium, delta_s=0.01, ranges=ranges,
                dtype=torch.float64, device=device, max_size=n,
                pos0=np.tile([[0.0, -1.0]], (256, 1)),
                theta0=np.linspace(-0.3, 0.3, 256))
        counts.append(m.n)
    print(f"[eigenrays] the crossing trace of the TL map's fan dispatches "
          f"{counts[1] - counts[0]} aten "
          "operations a step", flush=True)

    vert = rtt.analytic_medium("vert_heterogeneous")
    t0 = time.perf_counter()
    sl = rtt.find_eigenrays("op6", vert, source=(0, 0), receivers=[(3, -1)],
                            delta_s=0.005, max_size=2000,
                            box=(-2, 5, -2.5, 1), fan=(-1.2, 0.6, 128),
                            tol=1e-12, device=device)
    t_exact = np.arccosh(1 + 4.0 * 10.0 / (2 * 18.0 * 16.0)) / 2.0
    rel = abs(float(sl.traveltime[0]) / t_exact - 1) if len(sl.theta0) else 1
    print(f"[eigenrays] Slotnick v = 18 + 2y, (0, 0) -> (3, -1): "
          f"{len(sl.theta0)} arrival, traveltime {float(sl.traveltime[0]):.15f}"
          f" against {t_exact:.15f} (rel {rel:.3e}, bar 2e-7), miss "
          f"{float(sl.y_err[0]):.3e}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not (len(sl.theta0) == 1 and bool(sl.converged[0]) and rel < 2e-7):
        fail("eigenrays: the Slotnick traveltime")

    cmd, code, stdout, stderr, secs = cli_eigenrays(device)
    out = stdout.strip().splitlines()
    print(f"[eigenrays] python -m raytracing_tpu_torch.cli "
          f"{' '.join(cmd[3:])}: exit {code} in {secs:.1f} s", flush=True)
    for line in out[-8:]:
        print(f"    {line}", flush=True)
    if (code != 0 or not any("TL incoherent" in ln for ln in out)
            or any("WARNING" in ln for ln in out)):
        fail(f"eigenrays: the CLI run failed: {stderr[-2000:]}")


# -- the df32 tier (kernels/df.py, engine/df_grid.py) -----------------------
#: depths of [df32-vs-plain]: the analytic fields' plain versions take ~12 ms
#: a step on the card's host, the tables' ~40-60 ms
DF_CAP_ANALYTIC = 1000
DF_CAP_TABLES = 200
DF_TEN_TURNS = 10 * HEADLINE_DIVISOR
# bars: the one-turn error against the analytic circle (bench.py:682-692),
# the north-star RMS over ten prefixes (tests/test_df.py:33-56), the
# ORACLES rows (bench.py:519-567), vert and the profile against the float64
# scan tier (tests/test_df.py:92-95, tests/test_df_grid.py:162-187)
DF_BARS = {"one_turn": 6e-7, "rms": 5e-7, "ten_turn": 1e-5, "vert": 1e-6,
           "grid_ten_turn": 5e-3, "c1_ten_turn": 1e-4, "profile": 2e-7}


def df_bound(name, medium, st, steps):
    """(bound_ms, bound_by) of one df launch of ``steps`` steps on the state
    ``st``: its operations over every ray-step (the df tier has no box: no
    ray freezes), counted from its plain version on the state's head (the
    table media evaluate a row's spline blocks in one call an operation,
    each element counted; each exact product charged the kernel's FMUL and
    FFMA, :func:`exact_products_charged`); its bytes the eight planes in and out and the
    medium's packed table once (all of it: the operations bound it either
    way)."""
    from raytracing_tpu_torch.kernels import df as kdf
    few = head(st)
    ops = ops_per_step(lambda k: kdf.df_step_plain(few, medium, 0.01, k),
                       exact_products_charged)
    tables = getattr(medium, "kernel_tables", ())
    nbytes = 2 * state_bytes(st) + state_bytes(
        tables if isinstance(tables, tuple) else (tables,))
    bms, by = bound(ops * st.xh.shape[0] * float(steps), nbytes)
    print(f"    {name} bound {bms:.3f} ms ({by}: {ops} FP32 ops a ray-step, "
          f"an exact product {EXACT_PRODUCT_OPS})", flush=True)
    return bms, by


def build_df_media(device):
    """The split-word media of the reference's grid (DELTA, 511 x 511 fisheye
    nodes), parity and C1, and the Munk profile, built on the card."""
    from raytracing_tpu_torch.bench import df_media
    t0 = time.perf_counter()
    media = df_media(device)
    print(f"[df32] split-word media built in {time.perf_counter() - t0:.1f} "
          "s: the parity and C1 fisheye grids (511 x 511), the Munk profile",
          flush=True)
    return media


def df_exact(label, k, p):
    """A df kernel's 8 planes against its plain version's, to the bit;
    prints the largest |dpos| (hi + lo).  Returns it."""
    from raytracing_tpu_torch.kernels import df as kdf
    dpos = float((kdf.df_positions(k) - kdf.df_positions(p)).abs().max())
    same = all(torch.equal(a, b) for a, b in zip(k, p))
    print(f"  {label}: |dpos| {dpos:.3e}, all 8 planes "
          f"{'equal' if same else 'DIFFER'} (bit parity required)",
          flush=True)
    if not same:
        fail(f"{label}: kernel differs from its plain version")
    return dpos


def phase_df_vs_plain(device, media, rays=RAYS_CHECK):
    """The four df kernels on their five media against df_step_plain in the
    kernel's form (kernels/df.py fma_form: the FMA form on the analytic
    fields and the profile, JAX's roundings on the grids) at 65,536 rays
    (jitter from numpy seed 0), the analytic fields at most
    DF_CAP_ANALYTIC steps (vert DF_VERT_STEPS), the tables DF_CAP_TABLES;
    every plane to the bit, and k + (n - k) steps against n.  Returns
    {kernel: Errors}."""
    from raytracing_tpu_torch.bench import df_launch, df_state, replay
    from raytracing_tpu_torch.kernels import df as kdf
    rng = np.random.default_rng(0)
    errs = {k.name: Errors() for k in kdf.KERNELS}
    before = {k.name: k.launches for k in kdf.KERNELS}
    print(f"[df32-vs-plain] {rays} rays, the analytic fields at most "
          f"{DF_CAP_ANALYTIC} steps, the tables {DF_CAP_TABLES}", flush=True)
    for kind, name in (("fisheye", "df_step"),
                       ("vert_heterogeneous", "df_step"),
                       ("grid", "df_step_grid"), ("c1", "df_step_c1"),
                       ("profile", "df_step_profile")):
        medium = media.get(kind, kind)
        pos0, theta0, ds = df_launch(kind, rays, rng)
        steps = (DF_VERT_STEPS if kind == "vert_heterogeneous"
                 else DF_CAP_ANALYTIC if kind in kdf.DF_FIELDS
                 else DF_CAP_TABLES)
        st = df_state(kind, pos0, theta0, device)
        k_ms, k = cuda_ms(lambda: kdf.df_step(st, medium, ds, steps))
        p_ms, p = cuda_ms(lambda: replay.df_plain(st, medium, ds, steps))
        form = "FMA form" if kdf.fma_form(medium) else "JAX's roundings"
        dpos = df_exact(f"{name} {kind} ({form}) {steps} steps (kernel "
                        f"{k_ms:.3f} ms, plain (replayed) {p_ms:.1f} ms)",
                        k, p)
        errs[name].pos = max(errs[name].pos, dpos)
        cut = steps // 3
        resume_check(f"{name} {kind}", k, kdf.df_step(
            kdf.df_step(st, medium, ds, cut), medium, ds, steps - cut))
    for k in kdf.KERNELS:
        delta = k.launches - before[k.name]
        print(f"  {k.name}: {delta} launches in this phase", flush=True)
        if delta <= 0:
            fail(f"{k.name} was not launched against its plain version")
    return errs


class DfRun(NamedTuple):
    """One run of the df32 main path: its kernel, its medium (a field name
    or a split-word medium), the launch state the entry point built, its
    step and depth, its launch inputs, and the positions it returned."""

    kernel: str
    medium: Any
    st: Any
    ds: float
    steps: int
    pos0: Any
    theta0: Any
    pos: Any


def phase_df(device, media, rays=RAYS_MAIN):
    """The df32 main path through the entry points users call:
    fast_trace(precision="high") on the fisheye (one turn at the headline
    divisor, the headline's fan, timed) and on vert, df_trace for the
    ORACLES ten-turn closure, df_grid_trace on the parity and C1 fisheye
    grids (ten turns at 256 rays, one turn at 2^20) and on the Munk
    profile; each held to its oracle.  Returns {run: DfRun} of the 2^20-ray
    runs."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import df_launch, df_state
    from raytracing_tpu_torch.kernels import df as kdf
    fish = rtt.scenario("fisheye")
    ds = float(np.float32(2.0 * math.pi / HEADLINE_DIVISOR))
    pos0, theta0 = fan(fish, rays)
    kw = dict(delta_s=ds, pos0=pos0, theta0=theta0, divisor=HEADLINE_DIVISOR,
              n_turns=1, precision="high", device=device)
    med = rtt.analytic_medium("fisheye")
    f_ms, res = median_ms(lambda: rtt.fast_trace("op12", fish, med, **kw))
    steps = fish.max_size(ds, HEADLINE_DIVISOR, 1) - 1
    sarc = steps * ds
    err = float(np.linalg.norm(res.pos[0].cpu().numpy()
                               - [math.cos(sarc), math.sin(sarc)]))
    print(f"[df32] fast_trace op12 fisheye precision='high': engine="
          f"{res.engine}, {rays} rays x {steps} steps in {f_ms:.3f} ms "
          f"(median of 5 after a warm-up, CUDA events), ray 0's one-turn "
          f"error against the circle {err:.3e} (bar {DF_BARS['one_turn']})",
          flush=True)
    if res.engine != "df32" or not err < DF_BARS["one_turn"]:
        fail("df32: the one-turn fisheye trace")
    # fast_trace launches from the float32 position and angle
    runs = {"fisheye": DfRun("df_step", "fisheye", kdf.initial_df_state(
        pos0.astype(np.float32), theta0.astype(np.float32), device=device),
        ds, steps, pos0, theta0, res.pos)}
    # the north-star RMS: ten evenly spaced prefixes of the same turn, each
    # read from the state of a resumed segment
    st = runs["fisheye"].st
    done, sq = 0, []
    for frac in range(1, 11):
        n = HEADLINE_DIVISOR * frac // 10
        st = kdf.df_step(st, "fisheye", ds, n - done)
        done = n
        p = kdf.df_positions(st)[0].cpu().numpy()
        sq.append(np.linalg.norm(p - [math.cos(n * ds), math.sin(n * ds)])
                  ** 2)
    rms = float(np.sqrt(np.mean(sq)))
    print(f"  north-star RMS over 10 prefixes of the turn {rms:.3e} (bar "
          f"{DF_BARS['rms']})", flush=True)
    ten = kdf.df_trace(pos0[:4096], theta0[:4096], ds, steps=DF_TEN_TURNS,
                       device=device)
    closure = float(np.linalg.norm(ten[0].cpu().numpy() - [1.0, 0.0]))
    print(f"  df32_10turn_closure_abs: 4096 rays x {DF_TEN_TURNS} steps, "
          f"{closure:.3e} (bar {DF_BARS['ten_turn']})", flush=True)
    if not (rms < DF_BARS["rms"] and closure < DF_BARS["ten_turn"]):
        fail("df32: the north-star RMS or the ten-turn closure")

    rng = np.random.default_rng(0)
    vpos, vth, vds = df_launch("vert_heterogeneous", rays, rng)
    vres = rtt.fast_trace("op12", rtt.scenario("vert"),
                          rtt.analytic_medium("vert_heterogeneous"),
                          delta_s=vds, pos0=vpos, theta0=vth,
                          steps=DF_VERT_STEPS, precision="high",
                          device=device)
    print(f"[df32] fast_trace op12 vert precision='high': engine="
          f"{vres.engine}, {rays} rays x {DF_VERT_STEPS} steps", flush=True)
    if vres.engine != "df32":
        fail("df32: vert did not run the df32 kernel")
    runs["vert"] = DfRun("df_step", "vert_heterogeneous",
                         kdf.initial_df_state(vpos.astype(np.float32),
                                              vth.astype(np.float32),
                                              device=device),
                         vds, DF_VERT_STEPS, vpos, vth, vres.pos)

    for kind, bar in (("grid", "grid_ten_turn"), ("c1", "c1_ten_turn")):
        kernel, t0 = media[kind].KERNEL, time.perf_counter()
        n0 = kernel.launches
        p10 = rtt.df_grid_trace(pos0[:256], theta0[:256], ds, media[kind],
                                steps=DF_TEN_TURNS, device=device)
        sync()
        n10 = kernel.launches - n0
        gerr = float(np.linalg.norm(p10[0].cpu().numpy() - [1.0, 0.0]))
        one = rtt.df_grid_trace(pos0, theta0, ds, media[kind], steps=steps,
                                device=device)
        sync()
        print(f"[df32] df_grid_trace {kind}: 256 rays x {DF_TEN_TURNS} steps"
              f" closure {gerr:.3e} (bar {DF_BARS[bar]}, {n10} launches), "
              f"then {rays} rays x {steps} steps "
              f"({kernel.launches - n0 - n10} launches), "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not gerr < DF_BARS[bar]:
            fail(f"df32: the {kind} ten-turn closure")
        runs[kind] = DfRun(f"df_step_{kind}", media[kind],
                           df_state(kind, pos0, theta0, device), ds, steps,
                           pos0, theta0, one)
    ppos, pth, pds = df_launch("profile", rays, rng)
    pres = rtt.df_grid_trace(ppos, pth, pds, media["profile"],
                             steps=DF_PROFILE_STEPS, device=device)
    sync()
    print(f"[df32] df_grid_trace Munk profile: {rays} rays x "
          f"{DF_PROFILE_STEPS} steps at {pds}", flush=True)
    runs["profile"] = DfRun("df_step_profile", media["profile"],
                            df_state("profile", ppos, pth, device), pds,
                            DF_PROFILE_STEPS, ppos, pth, pres)
    return runs


def phase_df_checks(device, errs, runs):
    """The df32 main path's checks: vert and the Munk profile against the
    float64 scan tier (every 256th ray), DfEvalProfile on the card against
    the CPU; then each 2^20-ray run's result against a direct launch of its
    kernel on the same launch state (every ray to the bit), that kernel
    against df_step_plain (replayed) at min(steps, MAIN_PLAIN_CAP) steps
    (all 8 planes to the bit), and each kernel's time at its main shape
    beside its bound and its plain version's there.  Returns ({kernel: times}, the seconds
    of those comparisons)."""
    import dataclasses
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import df as kdf
    print("[df32] checks", flush=True)
    v = runs["vert"]
    sub = slice(None, None, v.pos0.shape[0] // DYN_ORACLE_RAYS)
    big = dataclasses.replace(rtt.scenario("vert"),
                              box=(-1e9, 1e9, -1e9, 1e9))
    ref = rtt.trace("op12", big, rtt.analytic_medium("vert_heterogeneous"),
                    delta_s=v.ds, max_size=v.steps + 1, mode="metrics",
                    dtype=torch.float64, pos0=v.pos0[sub],
                    theta0=v.theta0[sub], device=device)
    verr = float((v.pos[sub] - ref.final.pos).norm(dim=1).max())
    pr = runs["profile"]
    depth, c = munk_profile()
    chan = dataclasses.replace(rtt.scenario("vert"), name="profile",
                               gamma=1.0, box=(-1e6, 1e6, -3.0, 0.0))
    pref = rtt.trace("op12", chan, rtt.c1_stratified_from_samples(
        c.min() / c, depth, dtype=torch.float64, device=device),
        delta_s=pr.ds, max_size=pr.steps + 1, mode="metrics",
        dtype=torch.float64, pos0=pr.pos0[sub], theta0=pr.theta0[sub],
        device=device)
    perr = float((pr.pos[sub] - pref.final.pos).abs().max())
    print(f"  vert against the float64 op12 scan tier, {len(ref.final.pos)} "
          f"rays x {v.steps} steps: max |dpos| {verr:.3e} (bar "
          f"{DF_BARS['vert']}); the Munk profile, {len(pref.final.pos)} rays"
          f" x {pr.steps} steps: {perr:.3e} (bar {DF_BARS['profile']})",
          flush=True)
    if not (verr < DF_BARS["vert"] and perr < DF_BARS["profile"]):
        fail("df32: vert or the profile against the float64 scan tier")

    y = np.random.default_rng(9).uniform(-3.2, 0.2, RAYS_MAIN)
    x = np.zeros_like(y)
    card = rtt.df_eval_profile_medium(c.min() / c, depth, device=device)
    host = rtt.df_eval_profile_medium(c.min() / c, depth, device="cpu")
    a = card.n_and_grad(torch.as_tensor(x, device=device),
                        torch.as_tensor(y, device=device))
    b = host.n_and_grad(torch.as_tensor(x), torch.as_tensor(y))
    same = all(torch.equal(u.cpu(), v) for u, v in ((a[0], b[0]),
                                                    (a[1][0], b[1][0]),
                                                    (a[1][1], b[1][1])))
    print(f"  DfEvalProfile.n_and_grad on {RAYS_MAIN} depths: the card's "
          f"{'equals' if same else 'DIFFERS from'} the CPU's, every value",
          flush=True)
    if not same:
        fail("df32: DfEvalProfile differs between the card and the CPU")

    # vert shares df_step with the fisheye, whose run is the timed one
    times, t0 = {}, time.perf_counter()
    for name, r in runs.items():
        rays, fisheye = r.st.xh.shape[0], name == "fisheye"
        k_ms, out = (median_ms if fisheye else cuda_ms)(
            lambda: kdf.df_step(r.st, r.medium, r.ds, r.steps))
        direct = torch.equal(kdf.df_positions(out), r.pos)
        print(f"  {name}: the entry point's {rays} rays x {r.steps} steps "
              f"{'equal' if direct else 'DIFFER from'} a direct launch of "
              f"{r.kernel}, every ray to the bit", flush=True)
        if not direct:
            fail(f"df32 {name}: the main path differs from its kernel")
        depth = min(r.steps, MAIN_PLAIN_CAP)
        p_ms, p = cuda_ms(lambda: replay.df_plain(r.st, r.medium, r.ds,
                                                  depth))
        k = out if depth == r.steps else kdf.df_step(r.st, r.medium, r.ds,
                                                     depth)
        dpos = df_exact(f"[df32] {name} {r.kernel} {rays} rays x {depth} of "
                        f"{r.steps} steps against the plain version", k, p)
        errs[r.kernel].pos = max(errs[r.kernel].pos, dpos)
        rate = rays * r.steps / (k_ms * 1e-3)
        print(f"    {r.kernel} {name}: {k_ms:.3f} ms ({r.steps} steps, "
              f"{'median of 5' if fisheye else 'one run'}), {rate:.4e} "
              f"ray-steps/s; plain (replayed) {p_ms:.1f} ms ({depth} "
              "steps)",
              flush=True)
        if name != "vert":
            bms, by = df_bound(r.kernel, r.medium, r.st, r.steps)
            times[r.kernel] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                   bound_by=by)
    phase_df_dispersed(device, runs, times)
    return times, time.perf_counter() - t0


#: bytes a grid evaluation reads: the parity grid's 64-float cell row and
#: its four (hi, lo) nodes; the C1 grid's 96-float cell row
DF_ROW_BYTES = {"grid": 64 * 4 + 4 * 8, "c1": 96 * 4}
DF_DISPERSED_SAMPLES = 10


def phase_df_dispersed(device, runs, times):
    """The two grid kernels on a dispersed fan at the main shape: 2^20
    launch points uniform over the grid, angles uniform (numpy seed 5), so
    that a warp's rays read unrelated cell rows and the tables (beyond the
    50 MB L2) are read from wherever they lie.  Prints one run's time beside
    the main path's fan's, the share of ray-steps on the grid (sampled at
    DF_DISPERSED_SAMPLES resumed segments: off the grid a ray reads the
    edge cell's row) and the HBM estimate of four row reads a ray-step,
    were no row cached (not a bound).  Recorded, not tuned for."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import df_state, dispersed_fan
    from raytracing_tpu_torch.kernels import df as kdf
    box = rtt.scenario("fisheye").box
    pos0, theta0 = dispersed_fan(box, RAYS_MAIN, np.random.default_rng(5))
    for kind in ("grid", "c1"):
        r = runs[kind]
        st = df_state(kind, pos0, theta0, device)
        k_ms, out = cuda_ms(lambda: kdf.df_step(st, r.medium, r.ds, r.steps))
        seg, inside, cur = -(-r.steps // DF_DISPERSED_SAMPLES), [], st
        for done in range(0, r.steps, seg):
            cur = kdf.df_step(cur, r.medium, r.ds, min(seg, r.steps - done))
            p = kdf.df_positions(cur)
            inside.append(float(((p[:, 0] >= box[0]) & (p[:, 0] <= box[1])
                                 & (p[:, 1] >= box[2])
                                 & (p[:, 1] <= box[3])).double().mean()))
        if not (bool(torch.isfinite(kdf.df_positions(out)).all())
                and all(torch.equal(a, b) for a, b in zip(out, cur))):
            fail(f"df32 dispersed {r.kernel}: non-finite, or the resumed "
                 "segments differ from one launch")
        est = (1e3 * RAYS_MAIN * r.steps * 4 * DF_ROW_BYTES[kind]
               / PEAK_BYTES)
        print(f"  [df32] dispersed fan {r.kernel}: {RAYS_MAIN} rays x "
              f"{r.steps} steps {k_ms:.3f} ms (one run; the main path's fan "
              f"{times[r.kernel]['ms']:.3f} ms), {100 * np.mean(inside):.1f}"
              f" % of the rays on the grid at {len(inside)} samples; "
              f"row-read HBM estimate {est:.3f} ms ({DF_ROW_BYTES[kind]} B "
              "x 4 a ray-step over 3.35 TB/s, were no row cached; not a "
              "bound)", flush=True)


# -- user-defined media (kernels/custom.py) -----------------------------------
#: the interface field's width (config.THCK_PARAM)
THCK = 0.005
SQRT2 = math.sqrt(2.0)
#: the [custom] fisheye run against the analytic fused_step on the same fan:
#: the dual-number gradient of 1/(1 + x^2 + y^2) rounds as the analytic
#: field's closed form does (both are -2 fl(fl(n n) x)), so the two are
#: expected to agree to the bit; the bar is the fused kernel's own fisheye
#: bar against the scan tier
CUSTOM_FISHEYE_BAR = POS_TOL["fisheye"]


def _sigmoid_n(x, y):
    return SQRT2 - (SQRT2 - 1.0) * torch.sigmoid(y / THCK)


def _sigmoid_grad(x, y):
    s = torch.sigmoid(y / THCK)
    return torch.zeros_like(x), -(SQRT2 - 1.0) * s * (1.0 - s) / THCK


def custom_media():
    """The [custom] phase's media, written as CustomMediums in torch: the
    reference's fisheye and vert fields by dual numbers, its interface
    logistic with a hand grad_fn (the ill-conditioned case CustomMedium's
    docstring names), and the JAX package's own test field
    (tests/test_fast.py:151)."""
    import raytracing_tpu_torch as rtt
    return {
        "fisheye": rtt.CustomMedium(lambda x, y: 1.0 / (1.0 + x * x + y * y)),
        "interface": rtt.CustomMedium(_sigmoid_n, grad_fn=_sigmoid_grad),
        "aniso": rtt.CustomMedium(lambda x, y: 1.0 / (18.0 + 2.0 * y)),
        "jax_test": rtt.CustomMedium(
            lambda x, y: 1.2 + 0.1 * torch.sin(x) * torch.cos(y)),
    }


#: golden schedules of [custom-vs-plain] beyond the default: (op, bracket
#: iterations, polish), the bracket-parity mode and the coarse bracket +
#: polish, as phase 3 runs them
CUSTOM_SCHEDULES = (("op5", None, 0), ("op10", None, 0), ("op9", None, 0),
                    ("op11", 12, 2))


def phase_custom_build(device, media):
    """Trace the [custom] media and build their kernels' libraries, every
    nvcc at once: every fused op and golden variant on the fisheye (dual)
    and interface (grad_fn) media, and the aniso op11 loop.  The JAX test
    field's op6 library is left to its first fast_trace call, which times a
    user's first call."""
    from raytracing_tpu_torch.kernels import custom
    t0 = time.perf_counter()
    fields = {k: custom.trace_custom(m) for k, m in media.items()}
    specs = (custom.specs_of(fields["fisheye"], "fused")
             + custom.specs_of(fields["fisheye"], "golden")
             + custom.specs_of(fields["interface"], "fused")
             + custom.specs_of(fields["interface"], "golden")
             + [(fields["aniso"], "golden", "op11")])
    secs = custom.build_libraries(specs)
    wall = time.perf_counter() - t0
    name = {id(f): k for k, f in fields.items()}
    for (f, family, op), sec in sorted(secs.items(), key=lambda kv: kv[1]):
        print(f"  nvcc {name[id(f)]} {family} {op}: {sec:.1f} s", flush=True)
    for key, family, op in (("fisheye", "fused", "op6"),
                            ("aniso", "golden", "op11")):
        info = [ln.split(":", 1)[-1].strip() for ln in custom.build_log(
            fields[key], family, op).splitlines()
            if "registers" in ln or "stack frame" in ln]
        print(f"  ptxas {key} {family} {op}: {'; '.join(info)}", flush=True)
    print(f"[custom] traced {len(fields)} media "
          f"({', '.join(f'{k} {sum(f.ops().values())} ops' for k, f in fields.items())}"
          f") and built {len(secs)} libraries, all nvcc at once, in "
          f"{wall:.1f} s (slowest {max(secs.values(), default=0):.1f} s)",
          flush=True)
    return fields


def phase_custom_vs_plain(device, fields, rays=RAYS_CHECK, cap=STEP_CAP):
    """The two custom kernels against their plain versions at 65,536 rays:
    every fused op and every golden op (default schedule, then
    CUSTOM_SCHEDULES) on the fisheye (dual) and interface (grad_fn) media,
    at the op's calibrated analytic step capped at STEP_CAP, every plane to
    the bit; a k + (n - k) resume check each.  Returns {kernel: Errors}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import custom
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg
    rng = np.random.default_rng(2)
    errs = {"fused_step_custom": Errors(), "golden_step_custom": Errors()}
    infos = (custom.KERNEL_FUSED, custom.KERNEL_GOLDEN)
    before = {k.name: k.launches for k in infos}
    t0 = time.perf_counter()
    print(f"[custom-vs-plain] {rays} rays, at most {cap} steps, the fisheye "
          "(dual numbers) and interface (grad_fn) media", flush=True)

    def inputs(scen_name, op):
        scen = rtt.scenario(scen_name)
        ds, div = calibrated_step(op, scen_name)
        steps = min(cap, int(div) if scen.is_fisheye
                    else scen.max_size(ds) - 1)
        pos0, theta0 = fan(scen, rays, rng)
        return scen, ds, steps, pos0, theta0

    for scen_name in ("fisheye", "interface"):
        field, stats = fields[scen_name], scen_name != "fisheye"
        for op in kfu.FUSED_OPS:
            scen, ds, steps, pos0, theta0 = inputs(scen_name, op)
            st = kfu.initial_state(op, pos0, theta0, field=field,
                                   with_stats=stats, device=device)
            kw = dict(field=field, op=op, steps=steps, delta_s=ds,
                      step_limit=steps, offset=0.0, box=tuple(scen.box))
            exact(errs["fused_step_custom"],
                  f"fused_step_custom {op} {scen_name} {steps} steps",
                  kfu.fused_step(st, **kw), replay.fused_plain(st, **kw))
        cases = ([(op, None, None) for op in kg.GOLDEN_OPS]
                 + list(CUSTOM_SCHEDULES))
        for op, iters, polish in cases:
            scen, ds, steps, pos0, theta0 = inputs(scen_name, op)
            it, pol = kg.golden_schedule(polish, iters)
            st = kg.initial_state(op, pos0, theta0, scen.gamma, field=field,
                                  with_stats=stats, device=device)
            scal = kg.golden_scalars(ds, scen.gamma, steps, 0.0, it,
                                     device=device)
            g = torch.zeros(2, dtype=torch.float64, device=device)
            exact(errs["golden_step_custom"],
                  f"golden_step_custom {op} {scen_name} iters={it} "
                  f"polish={pol} {steps} steps",
                  kg.golden_step(st, scal, field=field, op=op, steps=steps,
                                 box=scen.box, gold_iters=it, polish=pol),
                  replay.golden_plain(st, scal, field=field, op=op,
                                      steps=steps, box=tuple(scen.box),
                                      iters=it, polish=pol, guards=g))
            guard_line(g)

    # resume: k steps then n - k (offset k) against n steps
    scen, ds, steps, pos0, theta0 = inputs("fisheye", "op7")
    field = fields["fisheye"]
    st = kfu.initial_state("op7", pos0, theta0, field=field,
                           with_stats=False, device=device)
    kw = dict(field=field, op="op7", delta_s=ds, step_limit=steps,
              box=tuple(scen.box))
    cut = steps // 3
    resume_check("fused_step_custom op7 fisheye",
                 kfu.fused_step(st, steps=steps, offset=0.0, **kw),
                 kfu.fused_step(kfu.fused_step(st, steps=cut, offset=0.0,
                                               **kw),
                                steps=steps - cut, offset=float(cut), **kw))
    scen, ds, steps, pos0, theta0 = inputs("interface", "op11")
    field = fields["interface"]
    it, pol = kg.golden_schedule()
    st = kg.initial_state("op11", pos0, theta0, scen.gamma, field=field,
                          with_stats=True, device=device)
    cut = steps // 3

    def run(s, n, off):
        scal = kg.golden_scalars(ds, scen.gamma, steps, off, it,
                                 device=device)
        return kg.golden_step(s, scal, field=field, op="op11", steps=n,
                              box=scen.box)

    resume_check("golden_step_custom op11 interface", run(st, steps, 0.0),
                 run(run(st, cut, 0.0), steps - cut, float(cut)))
    for k in infos:
        delta = k.launches - before[k.name]
        print(f"  {k.name}: {delta} launches in this phase", flush=True)
        if delta <= 0:
            fail(f"{k.name} was not launched against its plain version")
    print(f"[custom-vs-plain] {time.perf_counter() - t0:.1f} s", flush=True)
    return errs


class CustomRun(NamedTuple):
    """One run of the [custom] main path: its medium, scenario, op, step and
    depth, its launch inputs, and fast_trace's result."""

    medium: Any
    scen: Any
    op: str
    ds: float
    steps: int
    pos0: Any
    theta0: Any
    res: Any


def phase_custom(device, media, rays=RAYS_MAIN):
    """The custom main path: four reference scenarios written as
    CustomMediums through fast_trace at 2**20 rays, each held to its
    oracle (the aniso run's momentum CV in phase_custom_checks, from a
    direct launch with the Welford tracker, which fast_trace refuses on a
    custom medium).  Returns {run: CustomRun}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.engine import oracles
    runs = {}

    def run(name, scen, op, ds, steps, pos0, theta0, engine):
        t0 = time.perf_counter()
        res = rtt.fast_trace(op, scen, media[name], delta_s=ds, pos0=pos0,
                             theta0=theta0, steps=steps, device=device)
        sync()
        print(f"[custom] {name} {op} engine={res.engine} {rays} rays x "
              f"{steps} steps in {time.perf_counter() - t0:.3f} s",
              flush=True)
        if res.engine != engine:
            fail(f"custom {name}: engine {res.engine}, not {engine}")
        runs[name] = CustomRun(media[name], scen, op, ds, steps, pos0,
                               theta0, res)
        return res

    # the fisheye for one turn at the headline divisor; every ray but the
    # first with +-1e-3 rad of jitter
    fish = rtt.scenario("fisheye")
    ds = 2.0 * math.pi / HEADLINE_DIVISOR
    steps = fish.max_size(ds, HEADLINE_DIVISOR, 1) - 1
    pos0, theta0 = fan(fish, rays, np.random.default_rng(3))
    theta0[0] = np.float32(math.pi / 2.0)
    res = run("fisheye", fish, "op6", ds, steps, pos0, theta0,
              "fused-custom")
    closure = float(100.0 * torch.linalg.vector_norm(
        res.pos[0] - torch.tensor([1.0, 0.0], device=device)) / (2 * math.pi))
    ana = rtt.fast_trace("op6", fish, rtt.analytic_medium("fisheye"),
                         delta_s=ds, pos0=pos0, theta0=theta0, steps=steps,
                         device=device)
    dpos = float((res.pos - ana.pos).abs().max())
    print(f"  fisheye one-turn closure {closure:.4f} % (bar < 5); against "
          f"the analytic fused_step on the same fan max |dpos| {dpos:.3e} "
          f"(bar {CUSTOM_FISHEYE_BAR})", flush=True)
    if not (closure < 5.0 and dpos <= CUSTOM_FISHEYE_BAR):
        fail("custom fisheye: closure or the analytic kernel")

    iface = rtt.scenario("interface")
    ds = config.SIGMA / 5.0
    pos0, theta0 = fan(iface, rays)
    res = run("interface", iface, "op6", ds, iface.max_size(ds) - 1, pos0,
              theta0, "fused-custom")
    errs_deg = oracles.snell_errors_from_tangent(res.tangent, iface.theta0)
    print(f"  interface (grad_fn) Snell error mean {errs_deg.mean():.4f} deg "
          f"(bar < 0.2) max {errs_deg.max():.4f} deg (bar < 0.8)", flush=True)
    if not (errs_deg.mean() < 0.2 and errs_deg.max() < 0.8):
        fail("custom interface: Snell oracle")

    aniso = rtt.scenario("aniso")
    ds = config.SIGMA / 1.2
    pos0, theta0 = fan(aniso, rays)
    run("aniso", aniso, "op11", ds, aniso.max_size(ds) - 1, pos0, theta0,
        "golden-custom")

    # the JAX package's test field and launch (tests/test_fast.py:143-162)
    # at 2**20 rays; its library's build is a user's first call
    t0 = time.perf_counter()
    pos0 = np.tile(np.array([[0.2, -0.1]], np.float32), (rays, 1))
    theta0 = np.linspace(0.0, np.pi, rays).astype(np.float32)
    run("jax_test", fish, "op6", 0.01, 1000, pos0, theta0, "fused-custom")
    print(f"  jax_test: a user's first call (trace, nvcc, load, launch) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def phase_custom_checks(device, errs, runs):
    """The custom main path's checks: each 2**20-ray run against a direct
    launch of its kernel on the launch state fast_trace built (every ray to
    the bit; the aniso one with the Welford tracker, for its momentum CV),
    that kernel against its plain version at min(steps, MAIN_PLAIN_CAP)
    steps (every plane to the bit), and the kernel's time at the full shape
    beside its plain version's and its bound.  Returns {kernel: times}."""
    from raytracing_tpu_torch.engine import oracles
    from raytracing_tpu_torch.kernels import custom
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels import golden as kg
    print("[custom] checks", flush=True)
    times, t0 = {}, time.perf_counter()
    for name, r in runs.items():
        field = custom.trace_custom(r.medium)
        box = tuple(r.scen.box)
        depth = min(r.steps, MAIN_PLAIN_CAP)
        golden = r.op in kg.GOLDEN_OPS
        if golden:
            kernel = "golden_step_custom"
            it, pol = kg.golden_schedule()
            st = kg.initial_state(r.op, r.pos0, r.theta0, r.scen.gamma,
                                  field=field, with_stats=True,
                                  device=device)

            def launch(s, n):
                scal = kg.golden_scalars(r.ds, r.scen.gamma, n, 0.0, it,
                                         device=device)
                return kg.golden_step(s, scal, field=field, op=r.op,
                                      steps=n, box=box)

            def plain(s, n):
                scal = kg.golden_scalars(r.ds, r.scen.gamma, n, 0.0, it,
                                         device=device)
                return kg.golden_step_plain(s, scal, field=field, op=r.op,
                                            steps=n, box=box, iters=it,
                                            polish=pol)
        else:
            kernel = "fused_step_custom"
            st = kfu.initial_state(r.op, r.pos0, r.theta0, field=field,
                                   with_stats=False, device=device)

            def launch(s, n):
                return kfu.fused_step(s, field=field, op=r.op, steps=n,
                                      delta_s=r.ds, step_limit=n,
                                      offset=0.0, box=box)

            def plain(s, n):
                return kfu.fused_step_plain(s, field=field, op=r.op,
                                            steps=n, delta_s=r.ds,
                                            step_limit=n, offset=0.0,
                                            box=box)
        k_ms, out = cuda_ms(lambda: launch(st, r.steps), reps=3)
        direct = (torch.equal(torch.stack([out.x, out.y], -1), r.res.pos)
                  and torch.equal(out.tt, r.res.traveltime)
                  and torch.equal(out.dsim, r.res.dist_sim)
                  and torch.equal(out.active, r.res.active))
        print(f"  {name}: fast_trace's {st.x.shape[0]} rays x {r.steps} "
              f"steps {'equal' if direct else 'DIFFER from'} a direct launch "
              f"of {kernel}, every ray to the bit", flush=True)
        if not direct:
            fail(f"custom {name}: the main path differs from its kernel")
        if golden:
            nf = len(r.scen.theta0)
            cv = oracles.momentum_cv_pct_from_welford(
                out.mom_count[:nf], out.mom_mean[:nf], out.mom_m2[:nf])
            avg = float(np.mean(cv[1:-1]))
            print(f"  {name} {r.op} momentum CV {avg:.6f} % (bar < 0.05), "
                  "from the direct launch's Welford tracker", flush=True)
            if not avg < 0.05:
                fail(f"custom {name}: momentum CV oracle")
        p_ms, p = cuda_ms(lambda: plain(st, depth))
        k = out if depth == r.steps else launch(st, depth)
        exact(errs[kernel], f"[custom] {name} {kernel} {st.x.shape[0]} rays x "
              f"{depth} of {r.steps} steps against the plain version", k, p)
        rate = st.x.shape[0] * r.steps / (k_ms * 1e-3)
        print(f"    {kernel} {name}: {k_ms:.3f} ms ({r.steps} steps, mean "
              f"of 3), {rate:.4e} ray-steps/s; plain {p_ms:.1f} ms ({depth} "
              "steps)", flush=True)
        if name in ("fisheye", "aniso"):
            # the same shape on the analytic field the custom one rounds as
            # (fisheye; aniso is vert's field), through the main library
            ana = "fisheye" if name == "fisheye" else "vert_heterogeneous"
            a_ms, a_out = cuda_ms(lambda: (
                kg.golden_step(st, kg.golden_scalars(
                    r.ds, r.scen.gamma, r.steps, 0.0, it, device=device),
                    field=ana, op=r.op, steps=r.steps, box=box) if golden
                else kfu.fused_step(st, field=ana, op=r.op, steps=r.steps,
                                    delta_s=r.ds, step_limit=r.steps,
                                    offset=0.0, box=box)), reps=3)
            same = all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(out, a_out))
            print(f"    the analytic {ana} kernel at the same shape: "
                  f"{a_ms:.3f} ms, every plane "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            bms, by = timed_bound(kernel, lambda n: plain(head(st), n), st,
                                  out, None, r.ds, r.steps)
            times[kernel] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                 bound_by=by)
    print(f"[custom] checks {time.perf_counter() - t0:.1f} s", flush=True)
    return times


# -- the 3-D kinematic tier (kernels/fused3d.py, engine/tiled3.py) ----------
#: the sampled fisheye's one-turn positions against the analytic kernel's
#: on the same fan: JAX's sampled-fisheye bar (tests/test_grid3.py:185)
GRID3_DEV_BAR = 2e-4
#: the horizontal-slowness CV bar (%) of the stratified scan route: the
#: reference's 0.05 % in 3-D (tests/test_trace3d.py:109)
CV3_BAR = 0.05
#: HBM bytes one grid3 evaluation reads when its row is not cached
ROW3_BYTES = 256


def phase_3d_vs_plain(device, gmed, rays=RAYS_CHECK, cap=STEP_CAP):
    """Both 3-D kernels against fused3d_step_plain (replayed,
    bench/replay.py) at 65,536 rays, at most 1,000 steps, all 12 planes to
    the bit: fused3d_step every op on each field, fused3d_step_grid every
    op on the 71^3 sampled fisheye; a resume check each.  Returns {kernel:
    Errors}."""
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    from raytracing_tpu_torch.kernels import fused3d as kf3
    errs = {k.name: Errors() for k in kf3.KERNELS}
    before = {k.name: k.launches for k in kf3.KERNELS}
    t0 = time.perf_counter()
    print(f"[3d-vs-plain] {rays} rays, at most {cap} steps", flush=True)
    g3 = grid3_tables(gmed)
    cases = ([(f, kind, "fused3d_step") for f, kind in (
        ("fisheye", "tilted"), ("vert_heterogeneous", "vert"),
        ("interface", "interface"))]
        + [(g3, "tilted", "fused3d_step_grid"),
           (g3, "dispersed", "fused3d_step_grid")])
    for seed, (field, kind, kernel) in enumerate(cases):
        pos0, dir0, ds, steps, box = fan3(kind, rays, seed)
        steps = min(cap, steps)
        st = kf3.initial_state3(pos0, dir0, device=device)
        name = field if isinstance(field, str) else f"grid3 {kind}"
        for op in kf3.FUSED3_OPS:
            kw = dict(field=field, op=op, steps=steps, delta_s=ds,
                      step_limit=steps, offset=0.0, box=box)
            guards = torch.zeros(2, dtype=torch.float64, device=device)
            exact(errs[kernel], f"{kernel} {op} {name} {steps} steps",
                  kf3.fused3d_step(st, **kw),
                  replay.fused3d_plain(st, guards=guards, **kw))
            guard_line(guards)
        # resume: k steps then n - k (offset k) against n steps
        kw = dict(field=field, op="op8", delta_s=ds, step_limit=steps,
                  box=box)
        cut = steps // 3
        resume_check(f"{kernel} op8 {name}",
                     kf3.fused3d_step(st, steps=steps, offset=0.0, **kw),
                     kf3.fused3d_step(kf3.fused3d_step(
                         st, steps=cut, offset=0.0, **kw),
                         steps=steps - cut, offset=float(cut), **kw))
    for k in kf3.KERNELS:
        delta = k.launches - before[k.name]
        print(f"  {k.name}: {delta} launches in this phase", flush=True)
        if delta <= 0:
            fail(f"{k.name} was not launched against its plain version")
    print(f"[3d-vs-plain] {time.perf_counter() - t0:.1f} s", flush=True)
    return errs


class Run3(NamedTuple):
    """One 2^20-ray run of the [3d] main path: its medium (a field name or
    the grid3 medium), op, launch and fast_trace3's result."""

    medium: Any
    op: str
    pos0: Any
    dir0: Any
    ds: float
    steps: int
    box: Any
    res: Any


def phase_3d(device, gmed, rays=RAYS_MAIN):
    """The [3d] main path, every run through the entry points a user calls:
    fast_trace3 at 2^20 rays on the analytic fisheye (one turn, tilted fan,
    closure), vert op8 and interface op6 (some rays leave the box), the
    71^3 sampled fisheye (one turn, tilted fan; against the analytic run)
    and on a dispersed fan, the benchmark's two shapes (fused3d_op6,
    tiled3_grid_op6) with ray-steps/s; the scan route (Stratified3D of the
    vert field: engine "scan3d", and trace3d(stats=True)'s horizontal
    slowness CV at 4,096 rays); trace3d history at 256 rays, divisor 303,
    closure and the Bouguer drift (bench.py:574-591); and
    delta_s_search_convergence3 on tests/test_trace3d.py:214-221's inputs.
    Returns {run: Run3}."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.parallel.sweep import delta_s_search_convergence3
    runs = {}
    t0 = time.perf_counter()

    def run(name, medium, op, kind, seed, engine):
        pos0, dir0, ds, steps, box = fan3(kind, rays, seed)
        med = (rtt.analytic_medium3(medium) if isinstance(medium, str)
               else medium)
        t1 = time.perf_counter()
        res, eng = rtt.fast_trace3(op, med, pos0=pos0, dir0=dir0, delta_s=ds,
                                   steps=steps, box=box, device=device)
        sync()
        secs = time.perf_counter() - t1
        live = int(res.active.sum())
        print(f"[3d] {name} {op} engine={eng} {rays} rays x {steps} steps in "
              f"{secs:.3f} s ({rays * steps / secs:.4e} ray-steps/s with the "
              f"host), {live} rays never left the box", flush=True)
        if eng != engine:
            fail(f"3d {name}: engine {eng}, not {engine}")
        if not bool(torch.isfinite(res.pos).all()):
            fail(f"3d {name}: non-finite positions")
        runs[name] = Run3(medium, op, pos0, dir0, ds, steps, box, res)
        return res

    res = run("fisheye", "fisheye", "op6", "tilted", 0, "fused3d")
    p0 = torch.tensor([1.0, 0.0, 0.0], device=device)
    closure = float(100.0 * torch.linalg.vector_norm(res.pos - p0, dim=-1)
                    .max() / (2.0 * math.pi))
    print(f"  fisheye one-turn closure, worst of {rays} tilted planes "
          f"{closure:.6f} % (bar < 5, ORACLES trace3d_closure_pct)",
          flush=True)
    if not closure < 5.0:
        fail("3d fisheye closure")
    run("vert", "vert_heterogeneous", "op8", "vert", 1, "fused3d")
    run("interface", "interface", "op6", "interface", 2, "fused3d")
    gres = run("grid3", gmed, "op6", "tilted", 0, "grid3")
    gclosure = float(100.0 * torch.linalg.vector_norm(gres.pos - p0, dim=-1)
                     .max() / (2.0 * math.pi))
    dev = float((gres.pos - res.pos).abs().max())
    print(f"  grid3 (71^3 nodes) one-turn closure {gclosure:.6f} % (bar < 5);"
          f" against the analytic run on the same fan max |dpos| {dev:.3e} "
          f"(bar {GRID3_DEV_BAR})", flush=True)
    if not (gclosure < 5.0 and dev < GRID3_DEV_BAR):
        fail("3d grid3 closure or its distance from the analytic run")
    run("grid3_dispersed", gmed, "op6", "dispersed", 3, "grid3")
    run("fused3d_op6", "fisheye", "op6", "matrix", 0, "fused3d")
    run("tiled3_grid_op6", gmed, "op6", "matrix", 0, "grid3")

    # the scan route: x-independent media lift through Stratified3D
    strat = rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous"))
    rng = np.random.default_rng(4)
    n_scan = 4096
    dir0 = np.stack([rng.uniform(0.2, 0.9, n_scan),
                     -rng.uniform(0.3, 0.9, n_scan),
                     rng.uniform(0.2, 0.6, n_scan)], -1)
    pos0 = np.zeros((n_scan, 3))
    t1 = time.perf_counter()
    _, eng = rtt.fast_trace3("op8", strat, pos0=pos0, dir0=dir0,
                             delta_s=0.01, steps=400,
                             box=(-9.0, 9.0, -8.0, 8.0, -9.0, 9.0),
                             device=device)
    tr = rtt.trace3d("op8", strat, pos0=pos0, dir0=dir0, delta_s=0.01,
                     steps=400, mode="metrics", stats=True,
                     dtype=torch.float64, device=device)
    cv = float(np.nanmax(tr.horizontal_slowness_cv_pct()))
    print(f"  Stratified3D(vert) op8 engine={eng}; trace3d(stats=True) "
          f"float64 {n_scan} rays x 400 steps: horizontal-slowness CV "
          f"{cv:.6f} % (bar < {CV3_BAR}) in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    if eng != "scan3d" or not cv < CV3_BAR:
        fail("3d scan route: engine or the slowness oracle")

    # the ORACLES rows of bench.py:574-591, on the card
    tilt = np.resize(np.linspace(0.0, 1.0, 8), 256)
    p3 = np.tile([[1.0, 0.0, 0.0]], (256, 1))
    d3 = np.stack([np.zeros(256), np.cos(tilt), np.sin(tilt)], -1)
    r3 = rtt.trace3d("op6", rtt.analytic_medium3("fisheye"), pos0=p3,
                     dir0=d3, delta_s=2 * np.pi / 303, steps=303,
                     dtype=torch.float32, mode="history", device=device)
    clo3 = float(np.linalg.norm(r3.final.pos.cpu().numpy() - p3,
                                axis=1).max()) / (2 * np.pi) * 100
    b = rtt.bouguer_invariant(r3)
    bdrift = float(np.abs(b - b[:1]).max())
    print(f"  trace3d history 256 rays, divisor 303: closure {clo3:.6f} % "
          f"(bar < 5), Bouguer drift {bdrift:.3e} (bar < 1e-3)", flush=True)
    if not (clo3 < 5.0 and bdrift < 1e-3):
        fail("3d trace3d oracles")

    # the 3-D Richardson calibration (tests/test_trace3d.py:214-221)
    r8 = 8
    tilt8 = np.linspace(0, 0.5, r8)
    t1 = time.perf_counter()
    sr = delta_s_search_convergence3(
        "op6", rtt.analytic_medium3("fisheye"),
        pos0=np.tile([[1.0, 0, 0]], (r8, 1)),
        dir0=np.stack([np.zeros(r8), np.cos(tilt8), np.sin(tilt8)], -1),
        arc_length=2 * np.pi, tol=1e-4, device=device)
    print(f"  delta_s_search_convergence3 op6 fisheye: index {sr.index}, "
          f"delta_s {sr.delta_s_selected}, halving error "
          f"{sr.metrics['halving_err'][sr.index]:.3e} (tol 1e-4), "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    if sr.index is None:
        fail("3d calibration selected nothing")
    print(f"[3d] main path {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def phase_3d_checks(device, errs, runs, gmed):
    """The [3d] runs' checks: each 2^20-ray run against a direct launch of
    its kernel on the launch state fast_trace3 built (every ray to the
    bit), that kernel against fused3d_step_plain at min(steps,
    MAIN_PLAIN_CAP) steps (all 12 planes to the bit), and its time beside
    the plain version's and its bounds: the rule's (FP32 operations counted
    from the plain version, the state planes and the table once) and, for
    the grid, the row-read HBM estimate (256 bytes a live ray-step over
    HBM's rate; not a bound, as rows read from the L2 cost no HBM bytes).  Returns ({kernel: times}, seconds)."""
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    from raytracing_tpu_torch.kernels import fused3d as kf3
    print("[3d-shapes] each 2^20-ray run against a direct launch and the "
          "plain version, same inputs", flush=True)
    times, t0 = {}, time.perf_counter()
    timed = {"fisheye": "fused3d_step", "grid3": "fused3d_step_grid"}
    t_ms, g3 = cuda_ms(lambda: grid3_tables(gmed), reps=3)
    print(f"  grid3_tables (the {g3.table.numel() * 4 / 1e6:.1f} MB per-cell "
          f"table, built each fast_trace3 call): {t_ms:.3f} ms", flush=True)
    for name, r in runs.items():
        field = r.medium if isinstance(r.medium, str) else g3
        kernel = "fused3d_step" if isinstance(field, str) else \
            "fused3d_step_grid"
        st = kf3.initial_state3(r.pos0, r.dir0, device=device)
        depth = min(r.steps, MAIN_PLAIN_CAP)
        kw = dict(field=field, op=r.op, delta_s=r.ds, offset=0.0, box=r.box)
        k_ms, out = cuda_ms(lambda: kf3.fused3d_step(
            st, steps=r.steps, step_limit=r.steps, **kw), reps=3)
        same_final(
            f"{name}: fast_trace3's {st.x.shape[0]} rays x {r.steps} steps "
            f"against a direct launch of {kernel}",
            r.res, kf3.final_from_state3(out),
            names=("pos", "tangent", "traveltime", "dist_sim", "active"))
        p_ms, p = cuda_ms(lambda: kf3.fused3d_step_plain(
            st, steps=depth, step_limit=float(depth), **kw))
        k = out if depth == r.steps else kf3.fused3d_step(
            st, steps=depth, step_limit=depth, **kw)
        exact(errs[kernel], f"[3d] {name} {kernel} {st.x.shape[0]} rays x "
              f"{depth} of {r.steps} steps against the plain version", k, p)
        live = live_ray_steps(out.dsim, r.ds, r.steps)
        print(f"    {kernel} {name}: {k_ms:.3f} ms ({r.steps} steps, mean of "
              f"3), {st.x.shape[0] * r.steps / (k_ms * 1e-3):.4e} "
              f"ray-steps/s ({live:.4e} live); plain {p_ms:.1f} ms "
              f"({depth} steps)", flush=True)
        if kernel == "fused3d_step_grid":
            row_ms = 1e3 * ROW3_BYTES * live / PEAK_BYTES
            print(f"    row-read HBM estimate {row_ms:.3f} ms ({ROW3_BYTES} "
                  "bytes a live ray-step over 3.35 TB/s, were no row "
                  "cached; not a bound)",
                  flush=True)
        bms, by = timed_bound(
            kernel, lambda n: kf3.fused3d_step_plain(
                head(st), steps=n, step_limit=float(n), **kw),
            st, out, None if isinstance(field, str) else field, r.ds,
            r.steps)
        if timed.get(name) == kernel:
            times[kernel] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                 bound_by=by)
    secs = time.perf_counter() - t0
    print(f"[3d-shapes] {secs:.1f} s", flush=True)
    return times, secs


# -- the 3-D dynamic tier (kernels/dynamic3d.py, engine/dynamic3d.py) -------
#: the kernel-against-float64-scan checks of [dyn3], at the JAX tests' own
#: depths and bars: the analytic fisheye (tests/test_dynamic_kernel3.py:
#: 62-84, 500 steps of its 600-step turn, and the focus locator of :115-131
#: within 2 steps there), vert and the interface (:86-112, their 250-step
#: launches), the grid (tests/test_dynamic_tiled3.py:107-136, 300 steps:
#: positions and traveltime 1e-5, det Q's 95th-percentile relative error
#: 1e-3, KMAH and the locator equal) and a dispersed batch on it (the 50
#: steps of tests/test_tiled3.py's dispersed batch at the same bars).
#: Step 300 of a 600-step turn is the fisheye's antipodal point focus,
#: where det Q has collapsed to ~1e-7 of its size, so on the grid, as in
#: the 2-D dynamic checks (DYN_BARS), det Q's error is taken relative to
#: |det Q|'s largest value along the ray
DYN3_BARS = {
    "fisheye": dict(depth=500, pos=1e-5, tt=3e-5, det_rtol=5e-5,
                    det_atol=1e-8, locator=2),
    "field": dict(depth=250, pos=2e-4, det_rtol=2e-4, det_atol=1e-6,
                  locator=2),
    "grid": dict(depth=300, pos=1e-5, tt=1e-5, det_p95=1e-3, locator=0),
    "dispersed": dict(depth=50, pos=1e-5, tt=1e-5, det_p95=1e-3, locator=0),
}
#: a ray whose float64 |det Q| came within this share of its largest value
#: passed through a focus deeper than float32 resolves (the fisheye's point
#: foci: ~1e-7 and below): there the sign of det Q and the step of its
#: minimum are the rounding's, not the integrator's, so KMAH and the
#: locator are held on every other ray, and on these printed
DYN3_FOCUS_FLOOR = 1e-6
DYN3_ORACLE_RAYS = 4096
def dyn3_exact(label, k, p):
    """A 3-D dynamic kernel's 25 planes against its plain version's, to the
    bit; prints the largest |d| of pos, tt and det Q and the KMAH
    mismatches.  Returns |dpos|."""
    from raytracing_tpu_torch.kernels.dynamic3d import detq3
    dpos = max(float((getattr(k, c) - getattr(p, c)).abs().max())
               for c in ("x", "y", "z"))
    dtt = float((k.tt - p.tt).abs().max())
    ddet = float((detq3(k) - detq3(p)).abs().max())
    nk = int((k.kmah != p.kmah).sum())
    same = all(torch.equal(a, b) for a, b in zip(k, p))
    print(f"  {label}: |dpos| {dpos:.3e} |dtt| {dtt:.3e} |ddetQ| {ddet:.3e} "
          f"KMAH mismatches {nk} (bit parity required)", flush=True)
    if not same:
        fail(f"{label}: kernel differs from its plain version")
    return dpos


def dyn3_medium(name, gmed):
    """(kernel field, medium, engine) of a [dyn3] run by its name."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    field = {"dyn3_op6": "fisheye", "fisheye": "fisheye",
             "vert": "vert_heterogeneous", "interface": "interface"}.get(name)
    if field is not None:
        return field, rtt.analytic_medium3(field), "dynamic3-kernel"
    return grid3_tables(gmed), gmed, "dynamic3-kernel-grid"


#: [div_by]'s checks: (label, div_check arguments); the fused step's n lies
#: near 1 or 1/18 (fisheye (0, 1], vert about 1/18, interface 1 .. 1.41)
DIV_CHECKS = (
    ("div_by, all 2^32 numerators / 60", dict(denominator=60.0,
                                               count=1 << 32)),
    ("div_by, all 2^32 numerators / 360", dict(denominator=360.0,
                                                count=1 << 32)),
    ("div_by, 2^28 seeded pairs", dict(count=1 << 28, seed=11)),
    *((f"div_fast_pos, all 2^32 numerators / {b!r}",
       dict(kind="div_pos", denominator=b, count=1 << 32))
      for b in (1.0, 0.5, 0.0555555559694767, 1.2071068286895752)),
    ("div_fast_pos, 2^28 seeded pairs", dict(kind="div_pos", count=1 << 28,
                                             seed=13)),
    ("rcp_rn, all 2^32 denominators, against __frcp_rn",
     dict(kind="rcp", count=1 << 32)),
    ("sqrt_fast, all 2^32 operands, against __fsqrt_rn",
     dict(kind="sqrt", count=1 << 32)),
    ("rsqrt_fast, all 2^32 operands, against rsqrtf",
     dict(kind="rsqrt", count=1 << 32)),
)


def phase_div_check(device):
    """The correctly rounded operations from shared or approximate
    reciprocals (csrc/common.cuh; csrc/divide.cu, DIV_CHECKS) against the
    card's own: div_by (the 3-D dynamic loop's quotients) and div_fast_pos
    (the fused step's) against __fdiv_rn, rcp_rn (the analytic and custom
    fields' reciprocals), sqrt_fast (the fused step's length) and
    rsqrt_fast (fisheye_op1's normalization) against __frcp_rn,
    __fsqrt_rn and rsqrtf.  Any differing operand fails the run."""
    from raytracing_tpu_torch.kernels.divide import div_check
    t0 = time.perf_counter()
    for label, kw in DIV_CHECKS:
        bad, pair = div_check(device=device, **kw)
        what = ("" if pair is None else
                f" (e.g. {pair[0]!r} / {pair[1]!r})"
                if kw.get("kind", "div_by").startswith("div")
                else f" (e.g. {pair[0]!r})")
        print(f"[div_by] {label}: {bad} differ{what}", flush=True)
        if bad:
            fail(f"{label}: differs from the card's own operation")
    print(f"[div_by] {time.perf_counter() - t0:.1f} s", flush=True)


#: [fma32]'s triples (bench.fma_triples): (kind, count), 2^26 random ones
#: and 2^21 constructed float64 midpoints
FMA_CHECKS = (("bits", 1 << 25), ("moderate", 1 << 25),
              ("midpoint", 1 << 20), ("midpoint-subnormal", 1 << 20))
#: triples a launch of [fma32]
FMA_CHUNK = 1 << 23


def fma_off(card, plain):
    """How many results differ in their bits (NaN against NaN is equal)."""
    return int(((card.view(torch.int32) != plain.view(torch.int32))
                & ~(card.isnan() & plain.isnan())).sum())


def phase_fma32(device, media):
    """The card's fmaf (csrc/divide.cu rt_fma: the 2-D grid blend's FFMA,
    csrc/media.cuh hermite_blend) against the plain versions' fma32
    (utils/fma.py) computed on the card, on FMA_CHECKS' seeded triples and
    on the operands of the plain versions' own fma32 calls
    (:func:`fma_operands`, the sampled ``media``' 2-D grids among them):
    every result's bits (NaN against NaN).  Any differing triple fails the
    run."""
    from raytracing_tpu_torch.bench import fma_triples
    from raytracing_tpu_torch.kernels.divide import fma_card
    from raytracing_tpu_torch.utils.fma import fma32
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    for kind, count in FMA_CHECKS:
        off = 0
        for start in range(0, count, FMA_CHUNK):
            a, b, c = (torch.as_tensor(v, device=device) for v in fma_triples(
                kind, min(FMA_CHUNK, count - start), rng))
            off += fma_off(fma_card(a, b, c), fma32(a, b, c))
        print(f"[fma32] {kind}: {off} of {count} triples off", flush=True)
        if off:
            fail(f"[fma32] {kind}: the card's fmaf differs from fma32")
    for label, triples in fma_operands(device, media):
        a, b, c = (torch.cat(t) for t in zip(*triples))
        off = fma_off(fma_card(a, b, c), fma32(a, b, c))
        print(f"[fma32] {label}: {off} of {a.numel()} operand triples off",
              flush=True)
        if off:
            fail(f"[fma32] {label}: the card's fmaf differs from fma32")
    print(f"[fma32] {time.perf_counter() - t0:.1f} s", flush=True)


#: the rays and steps of each plain run whose fma32 operands [fma32] checks
FMA_OPERAND_RAYS, FMA_OPERAND_STEPS = 256, 10


def fma_operands(device, media):
    """[(label, [(a, b, c), ...])]: the operands of every fma32 call that
    the 2-D dynamic, the analytic 3-D and the df32 steps' plain versions
    make (their FMA forms), recorded on the card as float32 vectors:
    dynamic_step_plain, every op on each analytic field and on the parity
    and C1 fisheye grids of ``media`` (the step and the grids' blends,
    [dynamic-vs-plain]'s inputs), fused3d_step_plain, every op on each
    analytic field, and df_step_plain on the analytic fields and the Munk
    profile, from phase 3's, phase 11's, phase 16's and phase 14's launch
    fans at FMA_OPERAND_RAYS rays for FMA_OPERAND_STEPS steps."""
    from unittest import mock

    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import df_launch, df_state
    from raytracing_tpu_torch.engine import df_grid as dg
    from raytracing_tpu_torch.kernels import df as kdf
    from raytracing_tpu_torch.kernels import dynamic as kd
    from raytracing_tpu_torch.kernels import fused3d as kf3
    from raytracing_tpu_torch.utils import fma
    inner = fma.fma32
    rec = []

    def recording(a, b, c, neg_ab=False, neg_c=False):
        # the FFMA's own operands: -(a b) as (-a) b, both exact; a 0-d
        # host tensor (the df grid coordinate's constants) is a scalar
        out = inner(a, b, c, neg_ab=neg_ab, neg_c=neg_c)
        rec.append(tuple(
            (v.to(out.device) if torch.is_tensor(v) else torch.tensor(
                float(np.float32(v)), device=out.device)).expand(
                out.shape).reshape(-1).float() * sign
            for v, sign in ((a, -1.0 if neg_ab else 1.0), (b, 1.0),
                            (c, -1.0 if neg_c else 1.0))))
        return out

    rng = np.random.default_rng(19)
    out = []
    with mock.patch.object(fma, "fma32", recording):
        for field, scen_name in (("fisheye", "fisheye"),
                                 ("vert_heterogeneous", "vert"),
                                 ("interface", "interface")):
            scen = rtt.scenario(scen_name)
            pos0, theta0 = fan(scen, FMA_OPERAND_RAYS, rng)
            st = kd.initial_dyn_state(pos0, theta0, device=device)
            for op in DYN_OPS:
                ds, _ = calibrated_step(op, scen_name)
                kd.dynamic_step_plain(st, field=field, op=op,
                                      steps=FMA_OPERAND_STEPS, delta_s=ds,
                                      step_limit=FMA_OPERAND_STEPS,
                                      offset=0.0, box=tuple(scen.box))
            out.append((f"dynamic_step_plain {field}", rec))
            rec = []
        for kind in ("grid", "c1_grid"):
            for op in DYN_OPS:
                scen, ds, steps, pos0, theta0, tab = dyn_inputs(
                    media, kind, "fisheye", op, FMA_OPERAND_RAYS, rng,
                    FMA_OPERAND_STEPS)
                kd.dynamic_step_plain(
                    kd.initial_dyn_state(pos0, theta0, device=device),
                    field=tab, op=op, steps=steps, delta_s=ds,
                    step_limit=steps, offset=0.0, box=tuple(scen.box))
            out.append((f"dynamic_step_plain fisheye {kind}", rec))
            rec = []
        for seed, (field, kind) in enumerate((
                ("fisheye", "tilted"), ("vert_heterogeneous", "vert"),
                ("interface", "interface"))):
            pos0, dir0, ds, _, box = fan3(kind, FMA_OPERAND_RAYS, seed)
            st = kf3.initial_state3(pos0, dir0, device=device)
            for op in kf3.FUSED3_OPS:
                kf3.fused3d_step_plain(st, field=field, op=op,
                                       steps=FMA_OPERAND_STEPS, delta_s=ds,
                                       step_limit=FMA_OPERAND_STEPS,
                                       offset=0.0, box=box)
            out.append((f"fused3d_step_plain {field}", rec))
            rec = []
        depth, c = munk_profile()
        for kind in ("fisheye", "vert_heterogeneous", "profile"):
            medium = kind if kind != "profile" else (
                dg.df_c1_profile_from_samples(c.min() / c, depth,
                                              device=device))
            pos0, theta0, ds = df_launch(kind, FMA_OPERAND_RAYS, rng)
            kdf.df_step_plain(df_state(kind, pos0, theta0, device), medium,
                              ds, FMA_OPERAND_STEPS)
            out.append((f"df_step_plain {kind}", rec))
            rec = []
    return out


def phase_dyn3_vs_plain(device, gmed, rays=RAYS_CHECK, cap=STEP_CAP):
    """Both 3-D dynamic kernels against dynamic3d_step_plain (replayed,
    bench/replay.py) at 65,536 rays, at most 1,000 steps, all 25 planes to
    the bit: dynamic3d_step every op on each analytic field (the fisheye's
    tilted fan through its focus, JAX's vert and interface launches),
    dynamic3d_step_grid op1 and op6 on the 71^3 grid with a tilted and a
    dispersed fan; a resume check each.  Returns {kernel: Errors}."""
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    from raytracing_tpu_torch.kernels import dynamic3d as kd3
    errs = {k.name: Errors() for k in kd3.KERNELS}
    before = {k.name: k.launches for k in kd3.KERNELS}
    t0 = time.perf_counter()
    print(f"[dyn3-vs-plain] {rays} rays, at most {cap} steps", flush=True)
    g3 = grid3_tables(gmed)
    cases = ([(f, kind, "dynamic3d_step", kd3.DYN3_FUSED_OPS)
              for f, kind in (("fisheye", "tilted"),
                              ("vert_heterogeneous", "vert"),
                              ("interface", "interface"))]
             + [(g3, kind, "dynamic3d_step_grid", ("op1", "op6"))
                for kind in ("tilted", "dispersed")])
    for seed, (field, kind, kernel, ops) in enumerate(cases):
        pos0, dir0, ds, steps, box = fan3_dyn(kind, rays, seed)
        steps = min(cap, steps)
        st = kd3.initial_dyn3_state(pos0, dir0, device=device)
        name = field if isinstance(field, str) else f"grid3 {kind}"
        for op in ops:
            kw = dict(field=field, op=op, steps=steps, delta_s=ds,
                      step_limit=steps, offset=0.0, box=box)
            k = kd3.dynamic3d_step(st, **kw)
            errs[kernel].pos = max(errs[kernel].pos, dyn3_exact(
                f"{kernel} {op} {name} {steps} steps", k,
                replay.dynamic3d_plain(st, **kw)))
        kw = dict(field=field, op="op6", delta_s=ds, step_limit=steps,
                  box=box)
        cut = steps // 3
        resume_check(f"{kernel} op6 {name}",
                     kd3.dynamic3d_step(st, steps=steps, offset=0.0, **kw),
                     kd3.dynamic3d_step(kd3.dynamic3d_step(
                         st, steps=cut, offset=0.0, **kw),
                         steps=steps - cut, offset=float(cut), **kw))
    for k in kd3.KERNELS:
        delta = k.launches - before[k.name]
        print(f"  {k.name}: {delta} launches in this phase", flush=True)
        if delta <= 0:
            fail(f"{k.name} was not launched against its plain version")
    print(f"[dyn3-vs-plain] {time.perf_counter() - t0:.1f} s", flush=True)
    return errs


def phase_dyn3(device, gmed, rays=RAYS_MAIN):
    """The [dyn3] main path, every run through fast_dynamic3 at 2^20 rays:
    the benchmark's dyn3_op6 (kernel_matrix.py:191-213: identical rays, one
    turn of the fisheye), the tilted fan for one turn (the point focus),
    vert op8 and interface op6 (JAX's launches), dyn3_tiled_op6 (the same
    rays on the 71^3 grid, kernel_matrix.py:234-244), the grid on the
    tilted and the dispersed fan; then the scan route on the card: the
    homogeneous Custom3D (det Q = 25, TL = 20 log10 5 at float64,
    tests/test_dynamic3d.py:24-35) and the astigmatic Stratified3D
    waveguide (KMAH = det Q's sign changes >= 2, :63-75), with the float64
    scan tier's ms a step.  Returns {run: Run3}."""
    import raytracing_tpu_torch as rtt
    runs, t0 = {}, time.perf_counter()

    def run(name, op, kind, seed):
        pos0, dir0, ds, steps, box = fan3_dyn(kind, rays, seed)
        _, med, engine = dyn3_medium(name, gmed)
        t1 = time.perf_counter()
        res, eng = rtt.fast_dynamic3(op, med, pos0=pos0, dir0=dir0,
                                     delta_s=ds, steps=steps, box=box,
                                     device=device)
        sync()
        secs = time.perf_counter() - t1
        kmah = torch.bincount(res.kmah.long()).tolist()
        print(f"[dyn3] {name} {op} engine={eng} {rays} rays x {steps} steps "
              f"in {secs:.3f} s, {int(res.active.sum())} rays never left "
              f"the box, rays by KMAH 0, 1, ...: {kmah}, min |det Q| "
              f"{float(res.min_absdet.max()):.3e} at steps "
              f"{int(res.min_absdet_step.min())}-"
              f"{int(res.min_absdet_step.max())}", flush=True)
        if eng != engine:
            fail(f"dyn3 {name}: engine {eng}, not {engine}")
        if not (bool(torch.isfinite(res.pos).all())
                and bool(torch.isfinite(res.detq).all())):
            fail(f"dyn3 {name}: non-finite positions or det Q")
        runs[name] = Run3(name, op, pos0, dir0, ds, steps, box, res)
        return res

    run("dyn3_op6", "op6", "matrix", 0)
    fres = run("fisheye", "op6", "tilted", 0)
    run("vert", "op8", "vert", 1)
    run("interface", "op6", "interface", 2)
    run("dyn3_tiled_op6", "op6", "matrix", 0)
    gres = run("grid3", "op6", "tilted", 0)
    dev = float((gres.pos - fres.pos).abs().max())
    print(f"  grid3 (71^3 nodes) against the analytic run on the tilted fan, "
          f"one turn: max |dpos| {dev:.3e} (bar 5e-5)", flush=True)
    if not dev < 5e-5:
        fail("dyn3: the grid run's distance from the analytic run")
    run("grid3_dispersed", "op6", "dispersed", 3)

    # the scan route on the card at float64
    homog = rtt.Custom3D(lambda x, y, z: torch.ones_like(x))
    d = np.array([[1.0, 2.0, 2.0], [0.0, 0.0, 1.0], [3.0, -4.0, 0.0]])
    h = rtt.trace_dynamic3("op6", homog, pos0=np.zeros((3, 3)), dir0=d,
                           delta_s=0.1, steps=50, device=device)
    det_err = float((h.detq - 25.0).abs().max())
    tl_err = float((h.transmission_loss_db() - 20.0 * math.log10(5.0))
                   .abs().max())
    _, eng = rtt.fast_dynamic3("op6", homog, pos0=np.zeros((3, 3)), dir0=d,
                               delta_s=0.1, steps=50,
                               box=(-9.0, 9.0) * 3, device=device)
    print(f"  Custom3D homogeneous (engine={eng}): trace_dynamic3 float64 "
          f"|det Q - 25| {det_err:.3e}, |TL - 20 log10 5| {tl_err:.3e} "
          f"(bars 1e-9), KMAH {h.kmah.tolist()}", flush=True)
    if not (eng == "dynamic3-scan" and det_err < 1e-9 and tl_err < 1e-9
            and int(h.kmah.abs().sum()) == 0):
        fail("dyn3: the homogeneous scan-route oracle")
    guide = rtt.Stratified3D(rtt.CustomMedium(
        lambda x, y: 1.5 - 0.5 * y * y + 0.0 * x))
    t1 = time.perf_counter()
    w = rtt.trace_dynamic3("op6", guide, pos0=np.zeros((1, 3)),
                           dir0=np.array([[math.cos(0.3), math.sin(0.3),
                                           0.0]]),
                           delta_s=0.02, steps=1500, device=device)
    per_step = (time.perf_counter() - t1) / 1500 * 1e3
    hdet = w.history[:, 0, 5].cpu().numpy()
    changes = int(np.sum(np.sign(hdet[1:-1]) * np.sign(hdet[2:]) < 0))
    print(f"  Stratified3D waveguide float64, 1500 steps: KMAH "
          f"{int(w.kmah[0])}, det Q sign changes {changes} (equal, >= 2); "
          f"the float64 scan tier {per_step:.2f} ms a step (one ray, "
          "history)", flush=True)
    if not (changes >= 2 and int(w.kmah[0]) == changes):
        fail("dyn3: the astigmatic waveguide's KMAH")
    print(f"[dyn3] main path {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def dyn3_oracle(device, r, kernel_field, medium):
    """One [dyn3] run's kernel against trace_dynamic3 at float64 on a
    4,096-ray head, at its DYN3_BARS depth and bars."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.kernels import dynamic3d as kd3
    kind = ("dispersed" if r.medium.endswith("dispersed") else "grid"
            if not isinstance(kernel_field, str) else "fisheye"
            if kernel_field == "fisheye" else "field")
    b = DYN3_BARS[kind]
    n, depth = DYN3_ORACLE_RAYS, min(DYN3_BARS[kind]["depth"], r.steps)
    st = kd3.initial_dyn3_state(r.pos0[:n], r.dir0[:n], device=device)
    k = kd3.dynamic3d_step(st, field=kernel_field, op=r.op, steps=depth,
                           delta_s=r.ds, step_limit=depth, offset=0.0,
                           box=r.box)
    t0 = time.perf_counter()
    s = rtt.trace_dynamic3(r.op, medium, pos0=r.pos0[:n].astype(np.float64),
                           dir0=r.dir0[:n].astype(np.float64),
                           delta_s=float(np.float32(r.ds)), steps=depth,
                           box=r.box, mode="history", device=device)
    secs = time.perf_counter() - t0
    kpos = torch.stack([k.x, k.y, k.z], -1).double()
    dpos = float((kpos - s.pos).abs().max())
    dtt = float((k.tt.double() - s.traveltime).abs().max())
    kdet = kd3.detq3(k).double()
    scale = s.history[..., 5].abs().amax(0)
    focus = (s.history[1:, :, 5].abs().amin(0) < DYN3_FOCUS_FLOOR * scale)
    kmah_off = k.kmah.long() != s.kmah.long()
    loc_off = ((k.minstep.long() - s.min_absdet_step.long()).abs()
               > b["locator"])
    ok = (dpos <= b["pos"] and dtt <= b.get("tt", float("inf"))
          and not bool(((kmah_off | loc_off) & ~focus).any()))
    if "det_rtol" in b:
        excess = float(((kdet - s.detq).abs()
                        - (b["det_atol"] + b["det_rtol"] * s.detq.abs()))
                       .max())
        det_line = f"det Q excess over rtol {b['det_rtol']} / atol " \
                   f"{b['det_atol']} {excess:.3e} (<= 0)"
        ok = ok and excess <= 0.0
    else:
        rel = ((kdet - s.detq).abs() / scale).cpu().numpy()
        p95 = float(np.percentile(rel, 95))
        det_line = (f"det Q p95 relative to its path maximum {p95:.3e} (bar "
                    f"{b['det_p95']})")
        ok = ok and p95 < b["det_p95"]
    print(f"    oracle {r.medium} {n} rays x {depth} steps against "
          f"trace_dynamic3 float64 ({secs:.1f} s): |dpos| {dpos:.3e} (bar "
          f"{b['pos']}), |dtt| {dtt:.3e}, {det_line}; on the "
          f"{int((~focus).sum())} rays clear of a focus below float32's "
          f"resolution KMAH mismatches {int((kmah_off & ~focus).sum())}, "
          f"locator steps off by > {b['locator']} "
          f"{int((loc_off & ~focus).sum())} (both 0 required); on the other "
          f"{int(focus.sum())} {int((kmah_off & focus).sum())} and "
          f"{int((loc_off & focus).sum())}", flush=True)
    if not ok:
        fail(f"dyn3 {r.medium}: the kernel against the float64 scan tier")


def phase_dyn3_checks(device, errs, runs, gmed):
    """The [dyn3] runs' checks: each 2^20-ray run against a direct launch of
    its kernel (every ray to the bit), that kernel against its plain
    version (replayed) at min(steps, MAIN_PLAIN_CAP) steps (all 25 planes),
    the kernel against the float64 scan tier on a head (dyn3_oracle), and
    the kernels' times: median of 5 by CUDA events, the plain version's
    eager time for the timed runs (dyn3_op6, dyn3_tiled_op6), the bound and
    for the grid the row-read HBM estimate.  Returns {kernel: times}."""
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.kernels import dynamic3d as kd3
    print("[dyn3] checks: each 2^20-ray run against a direct launch, the "
          "plain version and the float64 scan tier", flush=True)
    times, t0 = {}, time.perf_counter()
    timed = {"dyn3_op6": "dynamic3d_step",
             "dyn3_tiled_op6": "dynamic3d_step_grid"}
    for name, r in runs.items():
        field, medium, _ = dyn3_medium(name, gmed)
        kernel = "dynamic3d_step" if isinstance(field, str) else \
            "dynamic3d_step_grid"
        st = kd3.initial_dyn3_state(r.pos0, r.dir0, device=device)
        depth = min(r.steps, MAIN_PLAIN_CAP)
        kw = dict(field=field, op=r.op, delta_s=r.ds, offset=0.0, box=r.box)
        k_ms, out = median_ms(lambda: kd3.dynamic3d_step(
            st, steps=r.steps, step_limit=r.steps, **kw))
        same_final(f"[dyn3] {name}: fast_dynamic3's {st.x.shape[0]} rays x "
                   f"{r.steps} steps against a direct launch of {kernel}",
                   r.res, kd3.final_from_dyn3_state(out, r.res.n),
                   names=("pos", "tangent", "traveltime", "dist_sim",
                          "active", "detq", "kmah", "min_absdet",
                          "min_absdet_step"))
        k = out if depth == r.steps else kd3.dynamic3d_step(
            st, steps=depth, step_limit=depth, **kw)
        errs[kernel].pos = max(errs[kernel].pos, dyn3_exact(
            f"[dyn3] {name} {kernel} {st.x.shape[0]} rays x {depth} of "
            f"{r.steps} steps against the plain version (replayed)", k,
            replay.dynamic3d_plain(st, steps=depth, step_limit=depth, **kw)))
        live = live_ray_steps(out.dsim, r.ds, r.steps)
        rate = st.x.shape[0] * r.steps / (k_ms * 1e-3)
        line = (f"    {kernel} {name}: {k_ms:.3f} ms median of 5 "
                f"({r.steps} steps), {rate:.4e} ray-steps/s ({live:.4e} "
                "live)")
        p_ms = None
        if timed.get(name) == kernel:
            p_ms, _ = cuda_ms(lambda: kd3.dynamic3d_step_plain(
                st, steps=depth, step_limit=float(depth), **kw))
            line += f"; plain {p_ms:.1f} ms ({depth} steps, eager)"
        print(line, flush=True)
        if kernel == "dynamic3d_step_grid":
            row_ms = 1e3 * ROW3_BYTES * live / PEAK_BYTES
            print(f"    row-read HBM estimate {row_ms:.3f} ms ({ROW3_BYTES} "
                  "bytes a live ray-step over 3.35 TB/s, were no row "
                  "cached; not a bound)", flush=True)
        bms, by = timed_bound(
            kernel, lambda n: kd3.dynamic3d_step_plain(
                head(st), steps=n, step_limit=float(n), **kw),
            st, out, None if isinstance(field, str) else field, r.ds,
            r.steps)
        if p_ms is not None:
            times[kernel] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                 bound_by=by)
        dyn3_oracle(device, r, field, medium)
    secs = time.perf_counter() - t0
    print(f"[dyn3] checks {secs:.1f} s", flush=True)
    return times


def cli_eigenrays3(device, timeout=300):
    """``python -m raytracing_tpu_torch.cli --eigenrays3`` on the Munk
    profile (:func:`munk_profile`) lifted to 3-D, source on the channel
    axis, three receivers off the source plane, a 9 x 9 fan and 800 steps
    of 0.01, as a process of its own (killed past ``timeout`` seconds);
    returns (command, exit code, stdout, stderr, seconds)."""
    import os
    import tempfile
    depth, c = munk_profile()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "munk.npz")
        np.savez(path, samples=c.min() / c, y=depth)
        cmd = [sys.executable, "-m", "raytracing_tpu_torch.cli",
               "--medium-file", path, "--family", "c1", "--op", "6",
               "--delta-s-value", "0.01", "--steps", "800",
               "--eigenrays3", "0", "-1", "0",
               "--receiver3", "4", "-1", "0.3",
               "--receiver3", "6", "-1.3", "-0.4",
               "--receiver3", "7", "-0.8", "0.6",
               "--fan3", "-0.3", "0.3", "9", "-0.3", "0.3", "9",
               "--omega", "40", "--device", str(device)]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    return (cmd, done.returncode, done.stdout, done.stderr,
            time.perf_counter() - t0)


def phase_eigenrays3(device):
    """The 3-D eigenray solver on the card at float64: the homogeneous
    single arrival (tests/test_eigenray3d.py:27-42) and the eddy's
    out-of-plane arrival (:72-91), each with the JAX test's asserts, and
    the CLI's --eigenrays3 run (:func:`cli_eigenrays3`): exit 0, at least
    one converged arrival a receiver, finite TL.  Returns its seconds."""
    import raytracing_tpu_torch as rtt
    t0 = time.perf_counter()
    r = np.array([3.0, 1.0, -0.5])
    eig = rtt.find_eigenrays3(
        "op1", rtt.Custom3D(lambda x, y, z: torch.ones_like(x)),
        source=(0, 0, 0), receivers=[r], delta_s=0.02, max_size=250,
        box=(-1, 5, -3, 3, -3, 3), fan=(-0.5, 0.5, 17, -0.5, 0.5, 17),
        device=device)
    d = float(np.linalg.norm(r))
    ok = (len(eig.traveltime) == 1 and bool(eig.converged[0])
          and float(np.abs(eig.dir0[0] - r / d).max()) < 1e-12
          and abs(eig.traveltime[0] - d) < 1e-12
          and abs(eig.amplitude[0] - 1 / d) < 2e-6 and eig.miss[0] < 1e-12
          and int(eig.kmah[0]) == 0
          and bool(np.isfinite(rtt.incoherent_tl(eig, n_receivers=1)).all()))
    print(f"[eigenrays3] homogeneous (0, 0, 0) -> (3, 1, -0.5): "
          f"{len(eig.traveltime)} arrival, traveltime "
          f"{float(eig.traveltime[0]):.15f} (exact {d:.15f}), amplitude "
          f"{float(eig.amplitude[0]):.9f} (1/d {1 / d:.9f}), miss "
          f"{float(eig.miss[0]):.3e}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not ok:
        fail("eigenrays3: the homogeneous arrival")

    def eddy(x, y, z):
        bump = torch.exp(-((x - 5.0) ** 2 + (z - 1.0) ** 2) / 4.0)
        return (1.3 - 0.02 * torch.tanh(y)) * (1.0 - 5e-3 * bump)

    t1 = time.perf_counter()
    recv = np.array([12.0, 0.5, 0.8])
    e = rtt.find_eigenrays3("op6", rtt.Custom3D(eddy), source=(0, 0, 0),
                            receivers=[recv], delta_s=0.02, max_size=900,
                            box=(-1, 15, -6, 6, -6, 6),
                            fan=(-0.3, 0.3, 15, -0.3, 0.3, 15),
                            device=device)
    bend = float(np.abs(e.dir0[:, 2] - (recv / np.linalg.norm(recv))[2])
                 .max()) if len(e.traveltime) else 0.0
    print(f"[eigenrays3] eddy (0, 0, 0) -> (12, 0.5, 0.8): "
          f"{len(e.traveltime)} arrival(s), miss {e.miss.tolist()}, "
          f"traveltime {e.traveltime.tolist()}, out-of-plane launch "
          f"correction {bend:.3e} (> 1e-4), "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    if not (len(e.traveltime) >= 1 and bool(np.all(e.converged))
            and bool(np.all(e.miss < 1e-7)) and bend > 1e-4):
        fail("eigenrays3: the eddy arrival")

    cmd, code, stdout, stderr, secs = cli_eigenrays3(device)
    out = stdout.strip().splitlines()
    print(f"[eigenrays3] python -m raytracing_tpu_torch.cli "
          f"{' '.join(cmd[3:])}: exit {code} in {secs:.1f} s", flush=True)
    for line in out[-10:]:
        print(f"    {line}", flush=True)
    rows = [ln for ln in out if ln.startswith("(") and "no arrivals" not in ln]
    tls = [float(ln.split()[2]) for ln in out if "TL incoherent" in ln]
    if (code != 0 or len(tls) != 3 or not all(math.isfinite(t) for t in tls)
            or len({ln.split(")")[0] for ln in rows}) != 3
            or any(abs(float(ln.split()[-1])) > 1e-6 for ln in rows)):
        fail(f"eigenrays3: the CLI run failed: {stderr[-2000:]}")
    return time.perf_counter() - t0


# -- the differentiable tier, the 3-D df32 facade, history streaming and
# profiling: paths with no kernel of their own (each phase prints its
# seconds; together they stay within ~90 s) --------------------------------
#: [diff]: benchmarks/diff_probe.py's configuration
DIFF_RAYS, DIFF_STEPS, DIFF_REMAT, DIFF_NG = 1 << 18, 300, 4, 12
#: [diff]'s float64 checks
DIFF_CHECK_RAYS, DIFF_CHECK_STEPS = 4096, 120
#: [diff]'s anisotropy check: 4 rays, this many op10n / op10 steps (the
#: Newton op's nested forward modes cost ~0.1 s a step on the card), and
#: the gamma step of its central differences
DIFF_GAMMA_STEPS, DIFF_GAMMA_H = 8, 1e-3
#: [df3]: the trace3d and trace_dynamic3 runs' rays and depths (250 steps:
#: short of the tilted fan's point focus at the antipode, ~300 steps, so
#: KMAH and the focus locator are held on every ray)
DF3_RAYS, DF3_STEPS = 1 << 16, 250
DF3_DYN_RAYS, DF3_DYN_STEPS = 4096, 250
#: [stream]: the bit-equality run's rays, the large run's, and the chunk;
#: the bit-equality run's divisor (one turn of 1,200 rows: two chunk edges)
STREAM_RAYS, STREAM_BIG_RAYS, STREAM_CHUNK = 4096, 1 << 18, 512
STREAM_CHECK_DIVISOR = 1199


def diff_case(device, rays, steps, dtype):
    """diff_probe.py's run: the fisheye's n sampled on a 12 x 12 grid over
    [-1, 1]^2 (144 parameters, ``parametric_grid_medium``), ``rays`` rays
    from (0.6, 0) at pi/2 +- 0.02 rad, ``steps`` op6 steps of 2 pi /
    steps, no box; the loss is the mean squared closure miss.  Returns
    (values, loss(values, remat), pos0, theta0, ds, h)."""
    import raytracing_tpu_torch as rtt
    h = 2.0 / (DIFF_NG - 1)
    ax = np.linspace(-1, 1, DIFF_NG)
    X, Y = np.meshgrid(ax, ax)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    values = torch.tensor((1.0 / (1.0 + X * X + Y * Y)).astype(np_dt),
                          device=device)
    theta0 = torch.tensor((np.pi / 2 + np.linspace(-0.02, 0.02, rays))
                          .astype(np_dt), device=device)
    pos0 = torch.tensor(np.tile([[0.6, 0.0]], (rays, 1)).astype(np_dt),
                        device=device)
    ds = 2 * np.pi / steps

    def loss(v, remat=DIFF_REMAT):
        med = rtt.parametric_grid_medium(v, -1.0, -1.0, h, h, device=device)
        pos, *_ = rtt.trace_diff("op6", med, pos0, theta0, ds, steps=steps,
                                 remat_segments=remat, device=device)
        return torch.mean(torch.sum((pos - pos0) ** 2, dim=-1))
    return values, loss, pos0, theta0, ds, h


def visited_nodes(device, values, pos0, theta0, ds, h, steps):
    """(ng, ng) bool: the nodes of every cell a ray of the run evaluates the
    medium in (the scan tier's op6 on the same parametric grid, the same
    positions as trace_diff's, unbounded box)."""
    import dataclasses
    import raytracing_tpu_torch as rtt
    scen = dataclasses.replace(rtt.scenario("fisheye"),
                               box=(-1e30, 1e30, -1e30, 1e30))
    med = rtt.parametric_grid_medium(values, -1.0, -1.0, h, h, device=device)
    with torch.no_grad():
        res = rtt.trace("op6", scen, med, delta_s=ds, dtype=values.dtype,
                        pos0=pos0.cpu().numpy(), theta0=theta0.cpu().numpy(),
                        max_size=steps + 1, device=device)
    ng = values.shape[0]
    lim = ng - 1 - 1e-9
    ix = torch.floor(torch.clamp((res.history[..., 0] + 1.0) / h, 0.0, lim))
    iy = torch.floor(torch.clamp((res.history[..., 1] + 1.0) / h, 0.0, lim))
    seen = torch.zeros((ng, ng), dtype=torch.bool, device=device)
    for dy in (0, 1):
        for dx in (0, 1):
            seen[(iy.long() + dy).clamp(max=ng - 1).reshape(-1),
                 (ix.long() + dx).clamp(max=ng - 1).reshape(-1)] = True
    return seen


def phase_diff(device):
    """[diff]: trace_diff at diff_probe.py's configuration (2^18 rays, 300
    op6 steps, float32, remat 4, the 144-node grid): the forward pass
    alone and forward plus backward (``torch.autograd.grad``), cold and
    warm, and the peak device memory; the gradient finite and nonzero only
    on visited nodes.  Then at float64 on 4,096 rays x 120 steps: the
    gradient against central differences (a node step of 1e-8) on the 3
    largest nodes (rtol 5e-5), remat 1 against 4 (rtol 1e-12 of the largest entry: the card's
    backward gathers by atomics, so its sums are not bit-reproducible),
    trace_diff's final state against the scan trace (atol 1e-12), and the
    op10n gamma gradient against central differences (rtol 1e-4) with the
    golden op10's exactly 0."""
    import raytracing_tpu_torch as rtt
    t0 = time.perf_counter()
    # a short run first loads every kernel the timed runs launch
    wv, wloss = diff_case(device, 4096, 2 * DIFF_REMAT, torch.float32)[:2]
    wv.requires_grad_()
    torch.autograd.grad(wloss(wv), wv)
    warm = time.perf_counter() - t0
    values, loss, pos0, theta0, ds, h = diff_case(device, DIFF_RAYS,
                                                  DIFF_STEPS, torch.float32)
    secs, peaks = {}, {}
    for tag in ("forward", "forward+backward"):
        v = values.clone().requires_grad_()
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if tag == "forward":
            with torch.no_grad():
                val = loss(v)
        else:
            val = loss(v)
            grad, = torch.autograd.grad(val, v)
        sync()
        secs[tag] = time.perf_counter() - t
        peaks[tag] = torch.cuda.max_memory_allocated() - base
    seen = visited_nodes(device, values, pos0, theta0, ds, h, DIFF_STEPS)
    nz = grad != 0
    print(f"[diff] diff_probe.py's run: {DIFF_RAYS} rays x {DIFF_STEPS} op6 "
          f"steps, float32, remat {DIFF_REMAT}, {values.numel()} parameters "
          f"(after a {warm:.1f} s warm-up at 4096 rays): forward "
          f"{secs['forward']:.3f} s, forward + backward "
          f"{secs['forward+backward']:.3f} s; "
          f"{DIFF_RAYS * DIFF_STEPS / secs['forward+backward']:.4e} "
          f"ray-steps/s with the gradient; peak device memory "
          f"{peaks['forward+backward'] / 1e9:.3f} GB (forward "
          f"{peaks['forward'] / 1e9:.3f} GB); loss {float(val.detach()):.6e}, "
          f"{int(nz.sum())} nonzero gradient entries, all on the "
          f"{int(seen.sum())} visited nodes: {not bool((nz & ~seen).any())}",
          flush=True)
    if not bool(torch.isfinite(grad).all()) or not bool(nz.any()) \
            or bool((nz & ~seen).any()):
        fail("diff: the gradient is not finite, is all zero, or is nonzero "
             "on a node no ray visits")

    # float64 checks
    t1 = time.perf_counter()
    values, loss, pos0, theta0, ds, h = diff_case(
        device, DIFF_CHECK_RAYS, DIFF_CHECK_STEPS, torch.float64)
    got, remat_peak = {}, {}
    for k in (1, DIFF_REMAT):
        v = values.clone().requires_grad_()
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        val = loss(v, k)
        got[k] = (float(val.detach()), torch.autograd.grad(val, v)[0])
        remat_peak[k] = torch.cuda.max_memory_allocated() - base
    t_fd = time.perf_counter()
    g1, g4 = got[1][1], got[DIFF_REMAT][1]
    remat_rel = float((g1 - g4).abs().max() / g1.abs().max())
    worst_fd = 0.0
    # the bilinear field's gradient jumps at cell edges, so the loss jumps
    # (by ~ds^2 |dgrad|) where an evaluation point crosses one: a node step
    # of 1e-6 crosses some of these 4,096 x 120 points; one of 1e-8 keeps
    # clear of them with float64 rounding at ~1e-8 relative
    eps = 1e-8
    for node in torch.topk(g1.abs().reshape(-1), 3).indices.tolist():
        e = torch.zeros_like(values).reshape(-1)
        e[node] = eps
        e = e.reshape(values.shape)
        with torch.no_grad():
            fd = (float(loss(values + e)) - float(loss(values - e))) / (2 * eps)
        an = float(g1.reshape(-1)[node])
        worst_fd = max(worst_fd, abs(an - fd) / abs(fd))
    t_scan = time.perf_counter()
    # trace_diff against the scan tier: op1 on the fisheye, a fan of
    # 4,096 rays around pi/2 from (1, 0), 120 steps of 2 pi / 400
    scen = rtt.scenario("fisheye")
    fds = 2 * np.pi / 400
    fpos0 = np.tile([[1.0, 0.0]], (DIFF_CHECK_RAYS, 1))
    fth0 = np.pi / 2 + np.linspace(-0.02, 0.02, DIFF_CHECK_RAYS)
    fish = rtt.ParametricMedium(lambda p, x, y: 1.0 / (1.0 + p * (x * x + y * y)),
                                torch.tensor(1.0, dtype=torch.float64,
                                             device=device))
    with torch.no_grad():
        d = rtt.trace_diff("op1", fish, torch.tensor(fpos0, device=device),
                           torch.tensor(fth0, device=device), fds,
                           steps=DIFF_CHECK_STEPS, box=tuple(scen.box),
                           device=device)
    s = rtt.trace("op1", scen, rtt.analytic_medium("fisheye"), delta_s=fds, dtype=torch.float64, pos0=fpos0,
        theta0=fth0, max_size=DIFF_CHECK_STEPS + 1, mode="metrics",
        device=device)
    scan_dpos = float((d.pos - s.final.pos).abs().max())
    t_gamma = time.perf_counter()
    # the anisotropy gamma through the Newton op (nested forward mode,
    # reverse mode over it) and the golden op
    vert = rtt.ParametricMedium(
        lambda p, x, y: 1.0 / (18.0 + 2.0 * y) + 0.0 * x + 0.0 * p,
        torch.tensor(1.0, dtype=torch.float64, device=device))
    gpos0 = torch.tensor([[0.0, -1.0]] * 4, dtype=torch.float64,
                         device=device)
    gth0 = torch.full((4,), np.pi / 4, dtype=torch.float64, device=device)

    def endsum(op, gam):
        pos, *_ = rtt.trace_diff(op, vert, gpos0, gth0, 0.01,
                                 steps=DIFF_GAMMA_STEPS, gamma=gam,
                                 device=device)
        return pos.sum()

    gam = torch.tensor(3.0, dtype=torch.float64, device=device,
                       requires_grad=True)
    g_newton = float(torch.autograd.grad(endsum("op10n", gam), gam)[0])
    hg = DIFF_GAMMA_H
    with torch.no_grad():
        fd_newton = (float(endsum("op10n", 3.0 + hg))
                     - float(endsum("op10n", 3.0 - hg))) / (2 * hg)
    g_gold, = torch.autograd.grad(endsum("op10", gam), gam,
                                  allow_unused=True)
    g_gold = 0.0 if g_gold is None else float(g_gold)
    newton_rel = abs(g_newton - fd_newton) / abs(fd_newton)
    t_end = time.perf_counter()
    print(f"[diff] float64 checks, {DIFF_CHECK_RAYS} rays x "
          f"{DIFF_CHECK_STEPS} steps ({t_end - t1:.1f} s: remat "
          f"{t_fd - t1:.1f}, differences {t_scan - t_fd:.1f}, scan "
          f"{t_gamma - t_scan:.1f}, gamma {t_end - t_gamma:.1f}): "
          f"gradient against central differences on its 3 largest nodes, "
          f"worst relative {worst_fd:.3e} (bar 5e-5); remat 1 against "
          f"{DIFF_REMAT}: loss equal {got[1][0] == got[DIFF_REMAT][0]}, "
          f"gradient {remat_rel:.3e} of its largest entry (bar 1e-12), "
          f"peak device memory {remat_peak[1] / 1e6:.1f} MB against "
          f"{remat_peak[DIFF_REMAT] / 1e6:.1f} MB; "
          f"trace_diff against the scan trace (op1, fisheye) |dpos| "
          f"{scan_dpos:.3e} (bar 1e-12); gamma through op10n "
          f"{g_newton:.12e} against central differences {fd_newton:.12e}, "
          f"relative {newton_rel:.3e} (bar 1e-4), through the golden op10 "
          f"{g_gold!r} (exactly 0 required)", flush=True)
    if not (worst_fd < 5e-5 and got[1][0] == got[DIFF_REMAT][0]
            and remat_rel <= 1e-12 and scan_dpos <= 1e-12
            and newton_rel < 1e-4 and g_gold == 0.0):
        fail("diff: a float64 check failed")
    secs_all = time.perf_counter() - t0
    print(f"[diff] {secs_all:.1f} s", flush=True)
    return secs_all, secs, peaks


def dyn3_focus_and_bars(s32, s64, bars):
    """trace_dynamic3 float32 against float64 at the [dyn3] grid bars:
    (ok, line).  KMAH and the locator are held on rays clear of a focus
    below float32's resolution (dyn3_oracle's rule)."""
    dpos = float((s32.pos.double() - s64.pos).abs().max())
    dtt = float((s32.traveltime.double() - s64.traveltime).abs().max())
    scale = s64.history[..., 5].abs().amax(0)
    focus = s64.history[1:, :, 5].abs().amin(0) < DYN3_FOCUS_FLOOR * scale
    rel = ((s32.detq.double() - s64.detq).abs() / scale).cpu().numpy()
    p95 = float(np.percentile(rel, 95))
    kmah_off = s32.kmah.long() != s64.kmah.long()
    loc_off = ((s32.min_absdet_step.long() - s64.min_absdet_step.long())
               .abs() > bars["locator"])
    bad = int(((kmah_off | loc_off) & ~focus).sum())
    ok = (dpos <= bars["pos"] and dtt <= bars["tt"]
          and p95 < bars["det_p95"] and bad == 0)
    return ok, (f"|dpos| {dpos:.3e} (bar {bars['pos']}), |dtt| {dtt:.3e} "
                f"(bar {bars['tt']}), det Q p95 relative to its path "
                f"maximum {p95:.3e} (bar {bars['det_p95']}), KMAH or "
                f"locator off on {bad} of the {int((~focus).sum())} rays "
                f"clear of a focus (0 required)")


def phase_df3(device):
    """[df3]: the df32 facade ``df_eval_medium3_from_samples`` of the grid3
    phase's 71^3 fisheye samples: trace3d at float32 on 2^16 tilted rays x
    250 steps against trace3d at float64 on the float64 C1Grid3Medium of
    the same samples (|dpos| < 5e-6, test_df_grid3.py:134);
    trace_dynamic3 at float32 on 4,096 rays x 250 steps (its tangent from
    ``_hess3`` through ``_medium_lin3``, counted) against float64 on that
    medium at DYN3_BARS["grid"]'s bars; one find_eigenrays3(dtype=float32) solve
    on the card on the facade of test_df_grid3.py:137-163's 21^3 samples
    against the float64 solve, run on the CPU (traveltimes within 5e-5 (1
    + max |tt|)); each tier's ms a step."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.bench import AX3, fan3
    from raytracing_tpu_torch.engine import df_grid3
    t0 = time.perf_counter()
    X, Y, Z = np.meshgrid(AX3, AX3, AX3, indexing="ij")
    F = 1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2)
    facade = rtt.df_eval_medium3_from_samples(F, AX3, AX3, AX3,
                                              device=device)
    m64 = rtt.c1_medium3_from_samples(F, AX3, AX3, AX3, device=device,
                                      dtype=torch.float64)
    mb = (facade.med.Nh.numel() + facade.med.Nl.numel()) * 4 / 1e6
    print(f"[df3] facade of the {len(AX3)}^3 fisheye samples ({mb:.1f} MB "
          f"of split tables) and the float64 C1Grid3Medium built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ms = {}

    def timed(label, fn, steps):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        ms[label] = (time.perf_counter() - t) * 1e3 / steps
        return out

    pos0, dir0, _, _, box = fan3("tilted", DF3_RAYS, 0)
    ds = 2 * np.pi / 600
    kw = dict(delta_s=ds, steps=DF3_STEPS, box=box, mode="metrics",
              device=device)
    r32 = timed("trace3d float32 facade", lambda: rtt.trace3d(
        "op6", facade, pos0=pos0, dir0=dir0, dtype=torch.float32, **kw),
        DF3_STEPS)
    r64 = timed("trace3d float64 C1Grid3Medium", lambda: rtt.trace3d(
        "op6", m64, pos0=pos0.astype(np.float64),
        dir0=dir0.astype(np.float64), dtype=torch.float64, **kw), DF3_STEPS)
    dpos3 = float((r32.final.pos.double() - r64.final.pos).abs().max())
    print(f"[df3] trace3d op6 {DF3_RAYS} rays x {DF3_STEPS} steps: float32 "
          f"facade against float64 C1Grid3Medium |dpos| {dpos3:.3e} (bar "
          f"5e-6)", flush=True)

    bars = DYN3_BARS["grid"]
    n = DF3_DYN_RAYS
    calls = []
    real = df_grid3._hess3
    df_grid3._hess3 = lambda *a: calls.append(1) or real(*a)
    try:
        s32 = timed("trace_dynamic3 float32 facade", lambda: rtt.trace_dynamic3(
            "op6", facade, pos0=pos0[:n], dir0=dir0[:n], delta_s=ds,
            steps=DF3_DYN_STEPS, box=box, mode="metrics",
            dtype=torch.float32, device=device), DF3_DYN_STEPS)
    finally:
        df_grid3._hess3 = real
    s64 = timed("trace_dynamic3 float64 C1Grid3Medium",
                lambda: rtt.trace_dynamic3(
                    "op6", m64, pos0=pos0[:n].astype(np.float64),
                    dir0=dir0[:n].astype(np.float64), delta_s=ds,
                    steps=DF3_DYN_STEPS, box=box, mode="history",
                    dtype=torch.float64, device=device), DF3_DYN_STEPS)
    ok_dyn, line = dyn3_focus_and_bars(s32, s64, bars)
    print(f"[df3] trace_dynamic3 op6 {n} rays x {DF3_DYN_STEPS} steps, the "
          f"facade's tangent by _hess3 ({len(calls)} evaluations, "
          f">= {DF3_DYN_STEPS} required) against float64 C1Grid3Medium: "
          f"{line}", flush=True)

    ax = np.linspace(-1.6, 1.6, 21)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    F21 = np.transpose(1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2), (2, 1, 0))
    ekw = dict(source=(1.0, 0.0, 0.0), receivers=[(-0.9, 0.02, 0.01)],
               delta_s=2 * np.pi / 500, max_size=1200,
               box=(-1.4, 1.4, -1.4, 1.4, -1.4, 1.4),
               fan=(-0.35, 0.35, 13, -0.35, 0.35, 13), iters=8, tol=3e-6,
               device=device)
    t_e = time.perf_counter()
    e32 = rtt.find_eigenrays3("op6", rtt.df_eval_medium3_from_samples(
        F21, ax, ax, ax, device=device), dtype=torch.float32, **ekw)
    t_e32 = time.perf_counter() - t_e
    # the float64 reference solve runs on the host's CPU: the same scan
    # tier, ~2.5x faster than the card at these 1-169 rays, whose host
    # dispatch bounds every step
    e64 = rtt.find_eigenrays3("op6", rtt.c1_medium3_from_samples(
        F21, ax, ax, ax, device="cpu", dtype=torch.float64),
        **{**ekw, "device": "cpu"})
    tt32 = np.sort(np.asarray(e32.traveltime, np.float64))
    tt64 = np.sort(np.asarray(e64.traveltime, np.float64))
    ok_eig = len(tt32) == len(tt64) >= 1
    dtt = float(np.abs(tt32 - tt64).max()) if ok_eig else float("inf")
    bar = 5e-5 * (1.0 + float(np.abs(tt64).max())) if len(tt64) else 0.0
    print(f"[df3] find_eigenrays3 float32 on the 21^3 facade on the card "
          f"({t_e32:.1f} s) against float64 on the CPU "
          f"({time.perf_counter() - t_e - t_e32:.1f} s): "
          f"{len(tt32)} and {len(tt64)} arrivals, traveltimes {tt32} and "
          f"{tt64}, |dtt| {dtt:.3e} (bar {bar:.3e})", flush=True)
    print("[df3] ms a step: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in ms.items()), flush=True)
    if not (dpos3 < 5e-6 and ok_dyn and len(calls) >= DF3_DYN_STEPS
            and ok_eig and dtt < bar):
        fail("df3: a check of the facade failed")
    secs = time.perf_counter() - t0
    print(f"[df3] {secs:.1f} s", flush=True)
    return secs, ms


def phase_stream(device):
    """[stream]: stream_history on the fisheye with op7 (its window and
    order ramp across chunk edges), 4,096 rays, chunk 512, one turn of
    1,200 rows, against trace(mode="history") to the bit; the same at
    2^18 rays over one turn of the headline divisor (4,588 rows), each
    chunk consumed and dropped, with the device's
    peak memory against one turn's history (fails above 2 chunks' rows
    plus the state); trace_chunked against trace(mode="metrics") on vert
    with exits, every final field and exit_step to the bit."""
    import dataclasses
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine.streaming import (
        stream_history, trace_chunked)
    from raytracing_tpu_torch.engine.trace import prepare
    t0 = time.perf_counter()
    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    rng = np.random.default_rng(0)
    ckw = dict(delta_s=2 * np.pi / STREAM_CHECK_DIVISOR,
               divisor=STREAM_CHECK_DIVISOR + 1, n_turns=1,
               dtype=torch.float32, device=device)
    pos0, theta0 = launch_fan(scen, STREAM_RAYS)
    theta0 = jittered(theta0, rng)
    chunks = list(stream_history("op7", scen, med, chunk=STREAM_CHUNK,
                                 pos0=pos0, theta0=theta0, **ckw))
    ref = rtt.trace("op7", scen, med, pos0=pos0, theta0=theta0, **ckw)
    same = np.array_equal(np.concatenate(chunks, 0),
                          ref.history.cpu().numpy())
    check_secs = time.perf_counter() - t0
    rows = sum(c.shape[0] for c in chunks)
    del chunks, ref
    print(f"[stream] op7 fisheye {STREAM_RAYS} rays, {rows} rows in chunks "
          f"of {STREAM_CHUNK}: equal to trace(mode='history') to the bit: "
          f"{same} ({check_secs:.1f} s, both runs)", flush=True)

    kw = dict(delta_s=2 * np.pi / HEADLINE_DIVISOR,
              divisor=HEADLINE_DIVISOR + 1, n_turns=1, dtype=torch.float32,
              device=device)
    big0, bigth = launch_fan(scen, STREAM_BIG_RAYS)
    bigth = jittered(bigth, rng)
    st = prepare("op7", scen, med, delta_s=kw["delta_s"], device=device,
                 max_size=2, dtype=torch.float32, pos0=big0,
                 theta0=bigth)[1]
    state_bytes = sum(t.numel() * t.element_size() for t in st
                      if torch.is_tensor(t))
    del st
    row_bytes = STREAM_BIG_RAYS * 6 * 4
    limit = 2 * STREAM_CHUNK * row_bytes + state_bytes
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    n_rows = 0
    last = None
    for c in stream_history("op7", scen, med, chunk=STREAM_CHUNK, pos0=big0,
                            theta0=bigth, **kw):
        n_rows += c.shape[0]
        last = c[-1, :, :2].copy()     # the chunk itself is dropped
    finite = bool(np.isfinite(last).all())
    sync()
    big_secs = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[stream] op7 fisheye {STREAM_BIG_RAYS} rays x one turn: "
          f"{n_rows} rows ({n_rows * row_bytes / 1e9:.2f} GB of history) "
          f"streamed in {big_secs:.1f} s; peak device memory "
          f"{peak / 1e9:.3f} GB (limit {limit / 1e9:.3f} GB: 2 chunks' rows "
          f"plus the {state_bytes / 1e6:.1f} MB state); last row's "
          f"positions finite {finite}", flush=True)

    vscen = dataclasses.replace(rtt.scenario("vert"), s_max=20.0,
                                box=(-2.0, 5.0, -2.5, 0.0))
    vmed = rtt.analytic_medium("vert_heterogeneous")
    vp, vt = launch_fan(vscen, STREAM_RAYS)
    vt = (vt + rng.uniform(-0.3, 0.3, STREAM_RAYS)).astype(np.float32)
    vkw = dict(delta_s=0.05, dtype=torch.float32, pos0=vp, theta0=vt,
               device=device)
    t2 = time.perf_counter()
    one = rtt.trace("op8", vscen, vmed, mode="metrics", **vkw)
    chk = trace_chunked("op8", vscen, vmed, chunk=13, **vkw)
    fields = ("pos", "traveltime", "dist_sim", "active", "mom_count",
              "mom_mean", "mom_m2")
    chunked_same = (all(torch.equal(getattr(chk.final, f),
                                    getattr(one.final, f)) for f in fields)
                    and torch.equal(chk.exit_step, one.exit_step))
    exits = int((one.exit_step < one.exit_step.max()).sum())
    print(f"[stream] trace_chunked op8 vert {STREAM_RAYS} rays, chunks of 13 "
          f"steps, {exits} rays exiting before the end: final state and "
          f"exit_step equal to trace(mode='metrics') to the bit: "
          f"{chunked_same} ({time.perf_counter() - t2:.1f} s, both runs)",
          flush=True)
    if not (same and rows == STREAM_CHECK_DIVISOR + 1 and finite
            and n_rows == HEADLINE_DIVISOR + 1 and peak <= limit
            and chunked_same and exits > 0):
        fail("stream: a streaming check failed")
    secs = time.perf_counter() - t0
    print(f"[stream] {secs:.1f} s", flush=True)
    return secs, peak


def phase_profiling(device):
    """[profiling]: ``device_trace`` around one headline launch (2^20 rays,
    one fisheye turn) writes a Chrome trace that names fisheye_op1; then
    ``step_timer``'s rate on that launch against CUDA events' (within
    10 %, median of 3).  The launches here are not the main path's: the
    kernel's count is taken back."""
    import glob
    import os
    from raytracing_tpu_torch.kernels import fisheye as kf
    from raytracing_tpu_torch.utils.profiling import device_trace, step_timer
    t0 = time.perf_counter()
    counted = kf.KERNEL.launches
    run = kf.make_fisheye_runner(RAYS_MAIN, HEADLINE_DIVISOR, 1,
                                 device=device)
    run()
    from raytracing_tpu_torch.kernels import build
    logdir = str(build.BUILD_DIR / "device_trace")
    before = set(glob.glob(os.path.join(logdir, "*.pt.trace.json")))
    with device_trace(logdir) as prof:
        run()
    new = sorted(set(glob.glob(os.path.join(logdir, "*.pt.trace.json")))
                 - before)
    names = set()
    if new:
        with open(new[-1]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernel_names = sorted(n for n in names if "fisheye_op1" in n)
    dev_us = [getattr(e, "device_time_total", getattr(e, "cuda_time_total",
                                                      0.0))
              for e in prof.key_averages() if "fisheye_op1" in e.key]
    print(f"[profiling] device_trace of one headline launch: {len(new)} "
          f"trace file ({new[-1] if new else None}, "
          f"{os.path.getsize(new[-1]) if new else 0} bytes), events naming "
          f"fisheye_op1: {kernel_names}, its device time "
          f"{sum(dev_us) / 1e3:.3f} ms", flush=True)
    ratios = []
    steps = run.steps
    for _ in range(3):
        sink = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with step_timer(RAYS_MAIN * steps, sink=sink, device=device):
            start.record()
            run()
            end.record()
        ev_rate = RAYS_MAIN * steps / (start.elapsed_time(end) / 1e3)
        ratios.append(sink[0].rate / ev_rate)
    ratio = float(np.median(ratios))
    kf.KERNEL.launches = counted
    print(f"[profiling] step_timer on the headline launch: "
          f"{sink[0].rate:.4e} ray-steps/s, CUDA events {ev_rate:.4e}; "
          f"ratio median of 3 {ratio:.4f} ({', '.join(f'{r:.4f}' for r in ratios)}; "
          f"within 10 % required)", flush=True)
    if not (new and kernel_names and 0.9 <= ratio <= 1.1):
        fail("profiling: no trace naming fisheye_op1, or step_timer and "
             "CUDA events disagree")
    secs = time.perf_counter() - t0
    print(f"[profiling] {secs:.1f} s", flush=True)
    return secs


#: the kernels the serving path launches (phase 19)
SERVE_KERNELS = ("fisheye_op1", "fused_step", "golden_step",
                 "fused_step_strat", "golden_step_strat", "fused_step_grid",
                 "df_step")
#: the JAX server's /v1/models lists (raytracing_tpu/serve.py:785-796), as
#: the port's copies of the names give them
SERVE_MEDIA = ["analytic", "stratified", "grid", "c1", "c1-stratified"]
SERVE_ENDPOINTS = ["/healthz", "/v1/models", "/v1/trace",
                   "/v1/trace_samples", "/v1/calibrate_samples",
                   "/v1/eigenrays", "/v1/trace3d_samples", "/v1/eigenrays3"]
#: one payload of each kind tests/test_serve.py::
#: test_trace_hostile_payloads_rejected sends
SERVE_HOSTILE = [
    {"scenario": "fisheye", "op": "op1", "delta_s": 0.0},
    {"scenario": "interface", "op": "op1", "delta_s": 1e-9},
    {"scenario": "interface", "op": "op1", "delta_s": float("nan")},
    {"scenario": "interface", "op": "op1", "delta_s": -1.0},
    {"scenario": "fisheye", "op": "op1", "n_turns": 10 ** 9},
    {"rays": "many"},
]


def serve_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, json.loads(r.read())


def serve_post(url, body):
    """(status, response, the request's seconds on the client's clock)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, resp = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, resp = e.code, json.loads(e.read())
    return code, resp, time.perf_counter() - t0


def serve_strip(resp):
    """A response without its timings, which no two runs share."""
    return {k: v for k, v in resp.items()
            if k not in ("seconds", "ray_steps_per_sec")}


def serve_direct(device, path, body):
    """The response the server gives ``body``, rebuilt from a direct call
    of the endpoint's work (fast_trace, delta_s_search_convergence,
    find_eigenrays, trace3d, find_eigenrays3) on the same inputs; its
    timings are placeholders."""
    from raytracing_tpu_torch import serve as ts
    ep = ts.ROUTES[path]
    inp = ep.inputs(body, device)
    return serve_strip(ep.response(inp, ep.call(inp, device), 1.0))


def serve_parts(device, body, path="/v1/trace"):
    """Seconds of a direct call's three parts: the inputs (validation,
    launch arrays), the call (upload, kernel, host copy), the response."""
    from raytracing_tpu_torch import serve as ts
    ep = ts.ROUTES[path]
    t0 = time.perf_counter()
    inp = ep.inputs(body, device)
    t1 = time.perf_counter()
    out = ep.call(inp, device)
    t2 = time.perf_counter()
    ep.response(inp, out, t2 - t1)
    return t1 - t0, t2 - t1, time.perf_counter() - t2


def serve_profile(n=501):
    """(samples, y): a parabolic index channel, ``n`` samples over 3 units
    of depth (tests/test_serve.py:321's waveguide, finer)."""
    y = np.linspace(-1.5, 1.5, n)
    return (1.2 - 0.25 * y * y).tolist(), y.tolist()


def serve_grid(n=129):
    """(Z, x, y): tests/test_serve.py:180's lens sampled on n x n nodes."""
    gx = np.linspace(-2.0, 2.0, n)
    gy = np.linspace(-1.5, 1.5, n)
    Z = 1.0 / (1.0 + 0.4 * gx[None, :] ** 2 + 0.6 * gy[:, None] ** 2)
    return Z.tolist(), gx.tolist(), gy.tolist()


def serve_requests(rays=RAYS_MAIN, big=1 << 24):
    """The serving path: (label, path, body, engine) in the order posted."""
    ds = 2 * math.pi / HEADLINE_DIVISOR
    head = {"scenario": "fisheye", "op": "op1", "rays": rays, "delta_s": ds,
            "divisor": HEADLINE_DIVISOR, "n_turns": 1}
    col, y = serve_profile()
    Z, gx, gy = serve_grid()
    profile = {"samples": col, "y": y, "op": "op6", "family": "c1",
               "rays": rays, "delta_s": 0.01, "steps": 1000,
               "box": [-1e6, 1e6, -1.5, 1.5], "report_conservation": True,
               "launch": {"x": 0.0, "y": [-0.1, 0.1], "theta": 0.3}}
    return [
        ("headline_2^20", "/v1/trace", head, "fisheye"),
        ("headline_2^24", "/v1/trace", dict(head, rays=big), "fisheye"),
        ("interface_op6", "/v1/trace",
         {"scenario": "interface", "op": "op6", "rays": rays}, "fused"),
        ("aniso_op11", "/v1/trace",
         {"scenario": "aniso", "op": "op11", "rays": rays}, "golden"),
        ("vert_op8", "/v1/trace",
         {"scenario": "vert", "op": "op8", "rays": rays}, "fused"),
        ("aniso_op11_strat", "/v1/trace",
         {"scenario": "aniso", "op": "op11", "rays": rays,
          "medium": "stratified"}, "golden-strat"),
        ("vert_op8_strat", "/v1/trace",
         {"scenario": "vert", "op": "op8", "rays": rays,
          "medium": "stratified"}, "fused-strat"),
        ("fisheye_op1_grid", "/v1/trace",
         {"scenario": "fisheye", "op": "op1", "rays": rays, "medium": "grid",
          "n_turns": 1}, "grid"),
        ("fisheye_op1_c1", "/v1/trace",
         {"scenario": "fisheye", "op": "op1", "rays": rays, "medium": "c1",
          "n_turns": 1}, "grid"),
        ("fisheye_op12_df32", "/v1/trace",
         dict(head, op="op12", precision="high"), "df32"),
        ("samples_profile", "/v1/trace_samples", profile, "fused-strat"),
        ("samples_grid", "/v1/trace_samples",
         {"samples": Z, "x": gx, "y": gy, "op": "op6", "rays": rays,
          "delta_s": 0.01, "steps": 300,
          "launch": {"x": -1.5, "y": [-0.3, 0.3], "theta": 0.0}}, "grid"),
        ("calibrate_profile", "/v1/calibrate_samples",
         {k: v for k, v in profile.items()
          if k not in ("delta_s", "steps", "report_conservation")}
         | {"rays": 65536, "arc_length": 1.0, "tol": 1e-4}, None),
    ]


def serve_solves():
    """The solve endpoints at small sizes (host-bound: each step is
    hundreds of torch calls): (label, path, body)."""
    col, y = serve_profile(61)
    eig = {"samples": col, "y": y, "op": "op6", "family": "c1",
           "delta_s": 0.16, "steps": 60, "box": [-1.0, 10.0, -1.5, 1.5],
           "source": [0.0, 0.0], "receivers": [[8.0, 0.0], [8.0, 0.3]],
           "fan": {"theta": [-0.45, 0.45], "count": 64}, "omega": 40.0}
    ax = np.linspace(-1.5, 1.5, 31)
    Zg, Yg, Xg = np.meshgrid(ax, ax, ax, indexing="ij")
    F = 1.2 - 0.1 * (Yg ** 2 + 0.3 * Xg * Zg)
    return [
        ("eigenrays_f64", "/v1/eigenrays", eig),
        ("eigenrays_on_device", "/v1/eigenrays",
         {k: v for k, v in eig.items() if k != "family"} | {"on_device": True}),
        ("trace3d_profile", "/v1/trace3d_samples",
         {"samples": col, "y": y, "op": "op6", "family": "c1",
          "delta_s": 0.02, "steps": 300, "rays": 1 << 16,
          "box": [-1.0, 50.0, -1.5, 1.5, -50.0, 50.0],
          "launch": {"pos": [0.0, 0.0, 0.0], "axis": [1.0, 0.0, 0.2],
                     "half_angle": 0.2}, "report_conservation": True}),
        ("trace3d_grid3", "/v1/trace3d_samples",
         {"samples": F.tolist(), "x": ax.tolist(), "y": ax.tolist(),
          "z": ax.tolist(), "op": "op6", "delta_s": 0.02, "steps": 120,
          "rays": 1 << 16,
          "launch": {"pos": [-1.0, 0.0, 0.0], "axis": [1.0, 0.0, 0.1],
                     "half_angle": 0.15}}),
        ("eigenrays3", "/v1/eigenrays3",
         {"samples": col, "y": y, "op": "op6", "family": "c1",
          "delta_s": 0.03, "steps": 160,
          "box": [-1.0, 10.0, -1.5, 1.5, -5.0, 5.0],
          "source": [0.0, 0.0, 0.0],
          "receivers": [[4.0, 0.0, 0.0], [4.0, 0.2, 0.1]],
          "fan": {"alpha": [-0.35, 0.35], "beta": [-0.35, 0.35],
                  "count": [8, 8]}, "omega": 40.0}),
    ]


def headline_kernel_ms(rays, reps=3):
    """fisheye_op1's device time at the headline shape and ``rays`` rays
    (CUDA events, after one warm-up); its launches are taken back."""
    from raytracing_tpu_torch.kernels import fisheye as kf
    counted = kf.KERNEL.launches
    x = torch.ones(rays, device="cuda")
    y = torch.zeros(rays, device="cuda")
    ux = torch.zeros(rays, device="cuda")
    uy = torch.ones(rays, device="cuda")
    ds = float(np.float32(2 * math.pi / HEADLINE_DIVISOR))
    kf.fisheye_op1(x, y, ux, uy, ds, HEADLINE_DIVISOR)
    ms, _ = cuda_ms(lambda: kf.fisheye_op1(x, y, ux, uy, ds,
                                           HEADLINE_DIVISOR), reps)
    kf.KERNEL.launches = counted
    return ms


def phase_serve(device, kernels, name, rays=RAYS_MAIN, big=1 << 24):
    """Phase 19: the port's server on ``device`` (module docstring), the
    headline requests at ``rays`` and ``big`` rays, the others at
    ``rays``.  Returns (seconds, the serving path's launches)."""
    import threading
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch import serve as ts
    from raytracing_tpu_torch.ops.registry import EXTENSION_OPS, OP_NAMES
    t0 = time.perf_counter()
    srv = ts.create_server("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, health = serve_get(url + "/healthz")
        if code != 200 or name not in health["device"]:
            fail(f"serve: /healthz names {health.get('device')!r}, not {name}")
        code, listing = serve_get(url + "/v1/models")
        want = {"scenarios": list(config.SCENARIO_NAMES),
                "ops": list(OP_NAMES), "extensions": list(EXTENSION_OPS),
                "media": SERVE_MEDIA, "sample_families": ["parity", "c1"],
                "endpoints": SERVE_ENDPOINTS}
        if code != 200 or listing != want:
            fail(f"serve: /v1/models differs from JAX's lists: {listing}")
        print(f"[serve] up in {time.perf_counter() - t0:.1f} s on "
              f"{health['device']}; /v1/models equal to JAX's lists",
              flush=True)

        reqs = serve_requests(rays, big)
        answers, launches = main_path(
            kernels, SERVE_KERNELS,
            lambda: [serve_post(url + p, b) for _, p, b, _ in reqs])
        alone = {}
        for (label, path, body, engine), (code, resp, wall) in zip(reqs,
                                                                   answers):
            if code != 200:
                fail(f"serve: {label} answered {code}: {resp}")
            if engine is not None and resp["engine"] != engine:
                fail(f"serve: {label} ran on {resp['engine']}, not {engine}")
            same = serve_strip(resp) == serve_direct(device, path, body)
            alone[label] = resp
            extra = {k: resp[k] for k in ("closure_error_pct",
                                          "momentum_cv_pct_max", "delta_s",
                                          "escaped_rays") if k in resp}
            print(f"  {label}: {resp.get('engine', path)} {wall:.3f} s "
                  f"request, {resp['seconds']:.4f} s in the server, "
                  f"{extra}; equal to the direct call to the bit: {same}",
                  flush=True)
            if not same:
                fail(f"serve: {label} differs from its direct call")
        for label, bar in (("headline_2^20", 5.0), ("headline_2^24", 5.0),
                           ("fisheye_op1_grid", 5.0), ("fisheye_op1_c1", 5.0),
                           ("fisheye_op12_df32", 1e-4)):
            if not alone[label]["closure_error_pct"] < bar:
                fail(f"serve: {label} closure {alone[label]} >= {bar} %")
        if not alone["samples_profile"]["momentum_cv_pct_max"] < 0.05:
            fail("serve: the posted profile's momentum CV >= 0.05 %")
        if not alone["calibrate_profile"]["accepted"]:
            fail("serve: no calibrate candidate accepted")

        # the serving overhead of the headline requests: the main path's
        # (the server's first request) and the median of three more
        for label, n in (("headline_2^20", rays), ("headline_2^24", big)):
            first = answers[[r[0] for r in reqs].index(label)][2]
            body = next(b for lb, _, b, _ in reqs if lb == label)
            again = [serve_post(url + "/v1/trace", body) for _ in range(3)]
            wall = float(np.median([w for _, _, w in again]))
            server = float(np.median([r["seconds"] for _, r, _ in again]))
            kms = headline_kernel_ms(n)
            parts = serve_parts(device, body)
            print(f"[serve-overhead] {label}: request {wall:.4f} s (median "
                  f"of 3; the first {first:.4f} s), {server:.4f} s in the "
                  f"server, kernel {kms:.3f} ms: host share "
                  f"{1 - kms / 1e3 / wall:.4f}; a direct call's parts: "
                  f"inputs {parts[0]:.4f} s, trace and host copy "
                  f"{parts[1]:.4f} s, response {parts[2]:.4f} s", flush=True)
        t_main = time.perf_counter() - t0

        # the solve endpoints at small sizes
        t_solve = time.perf_counter()
        for label, path, body in serve_solves():
            code, resp, wall = serve_post(url + path, body)
            if code != 200:
                fail(f"serve: {label} answered {code}: {resp}")
            same = serve_strip(resp) == serve_direct(device, path, body)
            alone[label] = resp
            n_arr = len(resp.get("arrivals", ()))
            print(f"  {label}: {wall:.3f} s request, {resp['seconds']:.4f} s"
                  f" in the server, {n_arr} arrivals; equal to the direct "
                  f"call to the bit: {same}", flush=True)
            if not same:
                fail(f"serve: {label} differs from its direct call")
            if path != "/v1/trace3d_samples" and not (
                    n_arr >= 2 and all(a["converged"]
                                       for a in resp["arrivals"])):
                fail(f"serve: {label}: {resp['arrivals']}")
        t_solve = time.perf_counter() - t_solve

        # eight requests at once, across the endpoints
        t_conc = time.perf_counter()
        pool = {label: (path, body) for label, path, body, _ in reqs}
        pool.update({label: (path, body) for label, path, body
                     in serve_solves()})
        labels = ("headline_2^20", "interface_op6", "aniso_op11_strat",
                  "fisheye_op1_grid", "fisheye_op12_df32", "samples_profile",
                  "calibrate_profile", "trace3d_profile")
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(8) as ex:
            together = list(ex.map(
                lambda lb: serve_post(url + pool[lb][0], pool[lb][1]),
                labels))
        for label, (code, resp, _) in zip(labels, together):
            if code != 200 or serve_strip(resp) != serve_strip(alone[label]):
                fail(f"serve: {label} answered concurrently differs from "
                     "the same request alone")
        t_conc = time.perf_counter() - t_conc
        print(f"[serve-concurrent] 8 requests at once ({', '.join(labels)})"
              f" in {t_conc:.1f} s, each equal to the same request alone "
              "to the bit", flush=True)

        for body in SERVE_HOSTILE:
            code, resp, _ = serve_post(url + "/v1/trace", body)
            if code != 400:
                fail(f"serve: hostile payload {body} answered {code}")
        code, health = serve_get(url + "/healthz")
        if code != 200:
            fail("serve: /healthz after the hostile payloads")
        print(f"[serve-errors] {len(SERVE_HOSTILE)} hostile payloads "
              "answered 400, /healthz 200 after them", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    secs = time.perf_counter() - t0
    print(f"[phase 19] the serving path {secs:.1f} s: main path and its "
          f"direct calls {t_main:.1f} s, the solve endpoints {t_solve:.1f}"
          f" s, concurrency {t_conc:.1f} s", flush=True)
    return secs, launches


# -- phase 20: the native spline library, the display path, the example twins
#: the native library's bars (tests/test_native.py): gradient2 against
#: np.gradient; bicubic_cells against FITPACK (rtol, atol); the grid run's
#: positions on native tables against the scipy tables' (JAX's grid bar)
NATIVE_GRAD_TOL = 1e-12
NATIVE_CELL_TOL = (1e-9, 1e-10)
NATIVE_GRID_POS_TOL = 1e-5
#: the 65,536-ray kernel-against-plain depth of [native]
NATIVE_STEP_CAP = 300


def best_of(fn, n=3):
    """The least of ``n`` wall times of ``fn()`` (seconds), synchronized."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def native_build():
    """``[native]``'s first line: the g++ build (or the load of a built
    library) and its seconds; fails unless the library is available.
    Returns the seconds."""
    from raytracing_tpu_torch import native
    built = native.library_path().exists()
    t0 = time.perf_counter()
    ok = native.available()
    secs = time.perf_counter() - t0
    print(f"[native] g++ {' '.join(native.GXX_FLAGS)}: "
          f"{'loaded the built library' if built else 'built'} in "
          f"{secs:.2f} s, {native.library_path().name}; available: {ok}",
          flush=True)
    if not ok:
        fail("native: the spline library does not build on this host")
    return secs


@contextlib.contextmanager
def native_off():
    """The port's native spline library reported unavailable, as the tests
    switch it off, so that every build takes scipy."""
    from raytracing_tpu_torch import native
    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def native_build_times(device):
    """The table builds timed native against scipy (under :func:`native_off`)
    on ``device``, best of 3 with the upload, a ``[build]`` line each;
    returns {label: (native seconds, scipy seconds)}.  Run with no other
    process of this script alive."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.media.grid import gen_grid
    vert, fish = rtt.scenario("vert"), rtt.scenario("fisheye")
    _, _, fz = gen_grid("fisheye", fish.box)
    sx = np.linspace(-1.5, 1.5, 511)
    samples = 1.0 / (1.0 + sx[None, :] ** 2 + sx[:, None] ** 2)
    builds = (
        ("interface reference grid (-2, 20, -2, 4)",
         lambda: rtt.build_grid_medium("interface", (-2.0, 20.0, -2.0, 4.0),
                                       device=device)),
        (f"fisheye parity grid {fz.shape[0]}x{fz.shape[1]}",
         lambda: rtt.build_grid_medium("fisheye", fish.box, device=device)),
        (f"fisheye C1 grid {fz.shape[0]}x{fz.shape[1]}",
         lambda: rtt.build_c1_medium("fisheye", fish.box, device=device)),
        ("vert stratified tables",
         lambda: rtt.build_stratified_medium("vert_heterogeneous", vert.box,
                                             device=device)),
        ("grid_medium_from_samples 511x511",
         lambda: rtt.grid_medium_from_samples(samples, sx, sx,
                                              device=device)),
    )
    times = {}
    for label, build in builds:
        tn = best_of(build)
        with native_off():
            ts = best_of(build)
        times[label] = (tn, ts)
        print(f"  [build] {label}: native {tn * 1e3:.1f} ms, scipy "
              f"{ts * 1e3:.1f} ms (best of 3, tables uploaded): "
              f"{ts / tn:.1f}x", flush=True)
    return times


def phase_native(device, kernels):
    """Phase 20's ``[native]`` in this process: the library against numpy
    and scipy, the fused grid and stratified kernels on native-built
    tables against their plain versions, and the 2**20-ray one-turn
    fisheye grid run on native and scipy tables (the build is
    :func:`native_build`'s, the timed builds :func:`native_build_times`').
    Returns (seconds, the grid run's launches)."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import native
    from raytracing_tpu_torch.bench import replay
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine.segmented import grid_tables
    from raytracing_tpu_torch.kernels import fused as kfu
    from raytracing_tpu_torch.kernels.fused import strat_tables
    from scipy.interpolate import RectBivariateSpline

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(57, 83))
    ddx, ddy = native.gradient2(Z, 0.13)
    want_dy, want_dx = np.gradient(Z, 0.13, edge_order=2)
    dg = max(float(np.abs(ddx - want_dx).max()),
             float(np.abs(ddy - want_dy).max()))
    ny, nx, hy, hx = 40, 55, 0.21, 0.17
    y, x = np.arange(ny) * hy, np.arange(nx) * hx
    Z = (np.cos(y[:, None]) * np.sin(x[None, :])
         + 0.1 * rng.normal(size=(ny, nx)))
    C = native.bicubic_cells(Z)
    qy, qx = rng.uniform(0, (ny - 1) * hy, 400), rng.uniform(0, (nx - 1) * hx,
                                                            400)
    iy = np.minimum((qy / hy).astype(int), ny - 2)
    ix = np.minimum((qx / hx).astype(int), nx - 2)
    uy, ux = qy / hy - iy, qx / hx - ix
    got = np.einsum("qab,qa,qb->q", C[iy, ix],
                    np.stack([uy ** 0, uy, uy ** 2, uy ** 3], -1),
                    np.stack([ux ** 0, ux, ux ** 2, ux ** 3], -1))
    want = RectBivariateSpline(y, x, Z, kx=3, ky=3)(qy, qx, grid=False)
    rtol, atol = NATIVE_CELL_TOL
    dc = float(np.abs(got - want).max())
    cells_ok = bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))
    print(f"  gradient2 against np.gradient: max |d| {dg:.3e} (bar "
          f"{NATIVE_GRAD_TOL}); bicubic_cells against RectBivariateSpline "
          f"on 400 points: max |d| {dc:.3e} (bar rtol {rtol}, atol {atol})",
          flush=True)
    if not (dg <= NATIVE_GRAD_TOL and cells_ok):
        fail("native: the library misses tests/test_native.py's bars")

    iface, vert, fish = (rtt.scenario(n) for n in ("interface", "vert",
                                                   "fisheye"))

    # the fused grid and stratified kernels on native-built tables against
    # their plain versions, every plane to the bit
    errs = {}
    nat = {"grid": rtt.build_grid_medium("fisheye", fish.box, device=device,
                                         backend="native"),
           "strat": rtt.build_stratified_medium("interface", iface.box,
                                                device=device),
           "vert": rtt.build_stratified_medium("vert_heterogeneous",
                                               vert.box, device=device)}
    for name, scen, key, op in (
            ("fused_step_grid", fish, "grid", "op1"),
            ("fused_step_grid", fish, "grid", "op6"),
            ("fused_step_strat", iface, "strat", "op6"),
            ("fused_step_strat", vert, "vert", "op8")):
        ds, div = calibrated_with_fallback(op, scen.name)
        steps = min(NATIVE_STEP_CAP, scen.max_size(ds, div, 1) - 1)
        pos0, theta0 = fan(scen, RAYS_CHECK, np.random.default_rng(1))
        tab = (grid_tables(fast._as_hermite(nat[key])) if key == "grid"
               else strat_tables(rtt.compact_for_trace(nat[key], scen.box,
                                                       ds)))
        st = kfu.initial_state(op, pos0, theta0, field=tab,
                               with_stats=key != "grid", device=device)
        kw = dict(field=tab, op=op, steps=steps, delta_s=float(ds),
                  step_limit=steps, offset=0.0, box=tuple(scen.box))
        errs.setdefault(name, Errors())
        exact(errs[name], f"[native] {name} {op} {scen.name} on native "
              f"tables, {RAYS_CHECK} rays x {steps} steps",
              kfu.fused_step(st, **kw), replay.fused_plain(st, **kw))

    # the 2**20-ray one-turn fisheye grid run, native against scipy tables
    ds, div = calibrated_with_fallback("op1", "fisheye")
    steps = fish.max_size(ds, div, 1) - 1
    pos0, theta0 = fan(fish, RAYS_MAIN)
    sci = rtt.build_grid_medium("fisheye", fish.box, device=device,
                                backend="scipy")
    runs, launches = main_path(
        kernels, ("fused_step_grid",),
        lambda: [rtt.fast_trace("op1", fish, m, delta_s=ds, pos0=pos0,
                                theta0=theta0, steps=steps, device=device)
                 for m in (nat["grid"], sci)])
    (rn, rs) = runs
    closure = float(100.0 * torch.linalg.vector_norm(
        rn.pos[0] - torch.tensor([1.0, 0.0], device=device)) / (2 * math.pi))
    dpos = float((rn.pos - rs.pos).abs().max())
    print(f"[native] fisheye grid op1, {RAYS_MAIN} rays x {steps} steps "
          f"(divisor {div}) on {rn.engine}: closure {closure:.6f} % (bar < 5)"
          f"; positions against the scipy tables' run: max |d| {dpos:.3e} "
          f"(bar {NATIVE_GRID_POS_TOL})", flush=True)
    if not (closure < 5.0 and dpos <= NATIVE_GRID_POS_TOL):
        fail("native: the grid run on native tables misses its bars")
    return time.perf_counter() - t_phase, launches


def cli_lines(device, argv, input_fn=None):
    """``cli.main(argv)`` on ``device`` (or ``cli.interactive(input_fn,
    device)``) in this process; returns (result, seconds, its standard
    output)."""
    import io
    from raytracing_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = (cli.interactive(input_fn=input_fn, device=device)
               if input_fn is not None
               else cli.main(argv + ["--device", str(device)]))
    sync()
    return res, time.perf_counter() - t0, buf.getvalue()


def oracle_value(label, pattern, text, bar):
    """The number ``pattern`` captures in ``text``; fails unless it is
    under ``bar``."""
    import re
    m = re.search(pattern, text)
    if not m:
        fail(f"viz-cli: {label}: no line matches {pattern!r}")
    v = float(m[1])
    print(f"  {label}: {v:.6g} (bar < {bar})", flush=True)
    if not v < bar:
        fail(f"viz-cli: {label} {v} not under {bar}")
    return v


def phase_viz_cli(device):
    """Phase 20's ``[viz-cli]``: with matplotlib, the CLI's plots and menus
    on the card, each file written and each printed oracle under its bar;
    without it, the wavefront analysis of a vert trace on the card, no
    drawing call.  Returns seconds."""
    import importlib.util
    import os
    import tempfile
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.viz import plots

    t0 = time.perf_counter()
    have = importlib.util.find_spec("matplotlib") is not None
    print(f"[viz-cli] importlib.util.find_spec('matplotlib'): "
          f"{'found' if have else 'None (not installed here)'}", flush=True)
    cv = r"Coefficient of Variation:\s+(\S+)"
    if have:
        with tempfile.TemporaryDirectory() as tmp:
            f = os.path.join(tmp, "vert.png")
            _, secs, out = cli_lines(device, [
                "--scenario", "vert", "--op", "8", "--delta-s", "calibrated",
                "--plot", "static", "--save-plot", f])
            sizes = [os.path.getsize(p) for p in (f, f + ".momentum.png")]
            print(f"  vert op8 --plot static --save-plot: {secs:.1f} s, "
                  f"figure {sizes[0]} bytes, momentum plot {sizes[1]} bytes, "
                  f"{out.count('Travel Time')} wavefronts reported",
                  flush=True)
            if min(sizes) <= 0 or "Travel Time" not in out:
                fail("viz-cli: the static plot or its report is missing")
            oracle_value("vert op8 momentum CV %", cv, out, 0.05)

            video = os.path.join(tmp, "wf.mp4")
            _, secs, out = cli_lines(device, [
                "--scenario", "vert", "--op", "8", "--plot", "movie",
                "--save-video", video])
            movie = [p for p in (video, video[:-4] + ".gif")
                     if os.path.exists(p)]
            print(f"  vert op8 --plot movie --save-video: {secs:.1f} s, "
                  f"{movie} {[os.path.getsize(p) for p in movie]} bytes",
                  flush=True)
            if not movie or os.path.getsize(movie[0]) <= 0:
                fail("viz-cli: the movie was not written")
            oracle_value("vert op8 momentum CV %", cv, out, 0.05)

            _, secs, out = cli_lines(device, [
                "--scenario", "interface", "--op", "6", "--plot", "static"])
            print(f"  interface op6 --plot static: {secs:.1f} s", flush=True)
            oracle_value("interface op6 mean Snell error (deg)",
                         r"Average ray error:\s+(\S+) degrees", out, 0.2)

            y = np.linspace(-2.0, 1.0, 61)
            prof = os.path.join(tmp, "prof.npz")
            np.savez(prof, samples=1.0 + 0.3 * np.tanh(2.0 * y), y=y)
            png = os.path.join(tmp, "prof.png")
            _, secs, out = cli_lines(device, [
                "--medium-file", prof, "--op", "op6", "--delta-s-value",
                "0.01", "--steps", "80", "--rays", "4096", "--family", "c1",
                "--box", "-5", "5", "-2", "1", "--launch", "0.0", "-1.5",
                "-0.5", "0.3", "--plot", "static", "--save-plot", png])
            print(f"  --medium-file profile --plot static: {secs:.1f} s, "
                  f"figure {os.path.getsize(png)} bytes", flush=True)
            oracle_value("profile momentum CV max %",
                         r"CV\(p_x\).*max (\S+) %", out, 0.05)

            answers = iter(["2", "1", "n", "y", "n"])
            _, secs, out = cli_lines(device, None, lambda _: next(answers))
            print(f"  interactive (fisheye, op1, calibrated, no benchmark, "
                  f"static plot): {secs:.1f} s", flush=True)
            if "Choose a Test Option" not in out:
                fail("viz-cli: the menus did not show")
            oracle_value("fisheye op1 closure %", r"Closure error\s+(\S+) %",
                         out, 5.0)
    else:
        _, secs, out = cli_lines(device, [
            "--scenario", "vert", "--op", "8", "--delta-s", "calibrated"])
        oracle_value("cli vert op8 momentum CV %", cv, out, 0.05)
        scen = rtt.scenario("vert")
        ds, _ = calibrated_with_fallback("op8", "vert")
        res = rtt.trace("op8", scen, rtt.analytic_medium("vert_heterogeneous"),
                        delta_s=ds, device=device)
        x, y, ang, tt = plots.ray_xy(res, 3)
        wf = plots.wavefront(res, 0.3)
        lines = []
        fronts = plots.wavefront_report(res, printer=lines.append)
        med = float(np.median(wf.angle_diffs[2:-2]))
        print(f"  vert op8 on {device} ({secs:.1f} s through cli.main): "
              f"ray_xy(ray 3) {len(x)} points to ({x[-1]:.4f}, {y[-1]:.4f}) "
              f"at traveltime {tt[-1]:.4f}; wavefront at 0.3: "
              f"{wf.points.shape[0]} rays, median interior |ray - normal| "
              f"{med:.4f} rad (bar < 0.05); wavefront_report: "
              f"{len(fronts)} fronts, {len(lines)} lines", flush=True)
        for line in lines[:3]:
            print(f"    {line.strip()}", flush=True)
        if not (med < 0.05 and len(fronts) > 0):
            fail("viz-cli: the wavefront analysis misses its bar")
    secs = time.perf_counter() - t0
    print(f"[viz-cli] {secs:.1f} s", flush=True)
    return secs


#: the example twins (examples/*_torch.py) phase 20 calls in this process,
#: under ``main_path``, with the kernels each should launch; each twin's
#: own asserts hold inside its ``main``
TWINS_HERE = (("million_ray_benchmark", [], ("fused_step",)),
              ("delta_s_search", [], ("fused_step",)),
              ("ocean_waveguide", [], ("fused_step_strat",)),
              ("measured_medium", [], ("fused_step_grid", "df_step_c1")))
# -- the sharded path (parallel/mesh.py, parallel/distributed.py) ------------
#: [mesh]'s three fast_trace_sharded runs at 2**20 rays and full depth:
#: (name, scenario, medium kind, op, stats, kernel)
MESH_RUNS = (("interface_strat", "interface", "strat", "op6", True,
              "fused_step_strat"),
             ("aniso", "aniso", "analytic", "op11", False, "golden_step"),
             ("fisheye_grid", "fisheye", "grid", "op1", False,
              "fused_step_grid"))
#: the sweep check's candidates: the reference's first 8 fisheye divisors
#: (303 -> 296), one turn, on the float32 scan tier
MESH_CANDIDATES = 8
#: the 3-D dynamic grid check's depth (dyn3_tiled_op6 runs 600 steps)
MESH_DYN3_STEPS = 100
#: a process of [mesh]: mesh_rank on the card, then one JSON line
MESH_RUNNER = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
print(json.dumps(chip_smoke.mesh_rank(int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3])))
"""


def mesh_rank(world, rank, store):
    """One rank of [mesh]: world 1 is make_mesh()'s own one-rank NCCL group;
    world 2 is a gloo group of two processes on the one card, joined through
    a FileStore at ``store`` (NCCL refuses two ranks on one GPU).  Runs
    MESH_RUNS through fast_trace_sharded and fast_trace on the same batch,
    every plane of this rank's rows equal to the bit, with each call's ms
    (CUDA events, medians of 3) and the kernel's launches in the sharded
    call; summarize_sharded against numpy on the host copy; in world 2 also
    run_candidates(mesh=) on the fisheye candidates and
    grid3_trace_dynamic_tiled(mesh=) at dyn3_tiled_op6's shape, each
    against the call without a mesh.  Returns {"lines": [...]}; raises on
    any disagreement."""
    import torch.distributed as dist

    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    from raytracing_tpu_torch.engine.fast import fast_trace_sharded
    from raytracing_tpu_torch.parallel.distributed import summarize_sharded
    from raytracing_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    lines = []

    def say(msg):
        lines.append(f"  [mesh] world {world} rank {rank} at "
                     f"{time.perf_counter() - t0:.1f} s: {msg}")

    if world > 1:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
    mesh = make_mesh(world, device="cuda")
    backend = dist.get_backend()
    kernels = {k.name: k for k in kernel_infos()}
    lo, hi = rank * (RAYS_MAIN // world), (rank + 1) * (RAYS_MAIN // world)
    media = {"strat": rtt.build_stratified_medium(
        "interface", rtt.scenario("interface").box, device="cuda"),
             "grid": rtt.build_grid_medium(
        "fisheye", rtt.scenario("fisheye").box, device="cuda")}
    for name, scen_name, kind, op, stats, kernel in MESH_RUNS:
        scen = rtt.scenario(scen_name)
        ds, div = (calibrated_step(op, scen_name) if kind == "analytic"
                   else calibrated_with_fallback(op, scen_name))
        steps = scen.max_size(float(ds), div, 1) - 1
        med = (rtt.analytic_medium(scen.field) if kind == "analytic"
               else media[kind])
        pos0, theta0 = fan(scen, RAYS_MAIN, np.random.default_rng(0))
        kw = dict(delta_s=ds, pos0=pos0, theta0=theta0, steps=steps,
                  stats=stats, device="cuda")
        kernels[kernel].launches = 0
        s = fast_trace_sharded(op, scen, med, mesh=mesh, **kw)
        launched = kernels[kernel].launches
        if launched <= 0:
            fail(f"[mesh] {name}: {kernel} never launched in the sharded run")
        del s
        # medians of 3 after a warm-up each, sharded and unsharded in turn
        sh_ms, s = median_ms(lambda: fast_trace_sharded(
            op, scen, med, mesh=mesh, **kw), reps=3)
        one_ms, one = median_ms(lambda: rtt.fast_trace(op, scen, med, **kw),
                                reps=3)
        planes = [f for f in one._fields
                  if torch.is_tensor(getattr(one, f))]
        for f in planes:
            if not torch.equal(getattr(s, f).to_local(),
                               getattr(one, f)[lo:hi]):
                fail(f"[mesh] world {world} {name}: plane {f} of rank "
                     f"{rank}'s rows differs from the unsharded run")
        say(f"{name} {op} engine={s.engine} {RAYS_MAIN} rays x {steps} "
            f"steps ({RAYS_MAIN // world} on this rank), {kernel} "
            f"launched {launched}x, every plane of its rows equal to "
            f"fast_trace's ({', '.join(planes)}): sharded {sh_ms:.3f} ms, "
            f"unsharded {one_ms:.3f} ms (medians of 3)")
        if name == "fisheye_grid":
            summ = summarize_sharded(s)
            p = one.pos.double().cpu().numpy()
            closure = 100.0 * np.linalg.norm(p - [1.0, 0.0], axis=-1) / (
                2.0 * math.pi)
            dsum = one.dist_sim.double().cpu().numpy().sum()
            ok = (summ.rays == RAYS_MAIN
                  and abs(float(summ.mean_closure_pct) - closure.mean())
                  <= 1e-12 * abs(closure.mean())
                  and abs(float(summ.total_distance) - dsum) <= 1e-12 * dsum)
            say(f"summarize_sharded ({backend}): mean closure "
                f"{float(summ.mean_closure_pct):.9f} % (numpy on the host "
                f"copy {closure.mean():.9f}), total distance "
                f"{float(summ.total_distance):.6f} ({dsum:.6f}), rays "
                f"{summ.rays}, within 1e-12: {ok}")
            if not ok:
                fail("[mesh] summarize_sharded disagrees with numpy")
        del s, one
    if world > 1:
        from raytracing_tpu_torch.engine.tiled3 import (
            grid3_trace_dynamic_tiled)
        from raytracing_tpu_torch.parallel import sweep as sw

        scen = rtt.scenario("fisheye")
        divs, ds, tdivs = sw.candidates(scen)
        divs, ds, tdivs = (a[:MESH_CANDIDATES] for a in (divs, ds, tdivs))
        sizes = sw._max_sizes(scen, ds, tdivs, 1)
        med = rtt.analytic_medium("fisheye")
        kw = dict(n_turns=1, dtype=torch.float32, device="cuda")
        t1 = time.perf_counter()
        one = sw.run_candidates("op1", scen, med, ds, sizes - 1,
                                int(sizes.max()), **kw)
        t2 = time.perf_counter()
        smesh = make_mesh(world, sweep=world, device="cuda")
        shard = sw.run_candidates("op1", scen, med, ds, sizes - 1,
                                  int(sizes.max()), mesh=smesh, **kw)
        t3 = time.perf_counter()
        if not np.array_equal(shard["closure_pct"], one["closure_pct"]):
            fail("[mesh] run_candidates(mesh=) differs from the unsharded "
                 "metrics")
        say(f"run_candidates(mesh={tuple(smesh.mesh.shape)}) on the "
            f"fisheye divisors {divs[0]:.0f}-{divs[-1]:.0f} (one turn, "
            f"float32 scan tier): every candidate's closure equal to the "
            f"unsharded sweep's; sharded {t3 - t2:.3f} s, unsharded "
            f"{t2 - t1:.3f} s")
        gmed = grid3_medium("cuda")
        pos0, dir0, ds3, _, box = fan3_dyn("matrix", RAYS_MAIN, 0)
        kw = dict(steps=MESH_DYN3_STEPS, box=box, device="cuda")
        kernels["dynamic3d_step_grid"].launches = 0
        s = grid3_trace_dynamic_tiled("op6", pos0, dir0, ds3, gmed,
                                      mesh=mesh, **kw)
        launched = kernels["dynamic3d_step_grid"].launches
        sh_ms, s = cuda_ms(lambda: grid3_trace_dynamic_tiled(
            "op6", pos0, dir0, ds3, gmed, mesh=mesh, **kw))
        one_ms, one = cuda_ms(lambda: grid3_trace_dynamic_tiled(
            "op6", pos0, dir0, ds3, gmed, **kw))
        for f in one._fields:
            if not torch.equal(getattr(s, f).to_local(),
                               getattr(one, f)[lo:hi]):
                fail(f"[mesh] grid3_trace_dynamic_tiled(mesh=): plane {f} "
                     f"of rank {rank}'s rows differs")
        if launched <= 0:
            fail("[mesh] dynamic3d_step_grid never launched in the sharded "
                 "run")
        say(f"grid3_trace_dynamic_tiled(mesh=) dyn3_tiled_op6 "
            f"{gmed.nz}x{gmed.ny}x{gmed.nx} nodes, {RAYS_MAIN} rays x "
            f"{MESH_DYN3_STEPS} steps, dynamic3d_step_grid launched "
            f"{launched}x, all {len(one._fields)} planes of its rows equal: "
            f"sharded {sh_ms:.3f} ms, unsharded {one_ms:.3f} ms")
    dist.destroy_process_group()
    return {"lines": lines, "seconds": time.perf_counter() - t0}


def phase_mesh(name):
    """[mesh]: the sharded path in processes of their own, so that no
    process group is left in this one: world size 1 over NCCL and world
    size 2 over gloo on the one card, started together (mesh_rank).
    Returns the phase's seconds; fails if a process fails."""
    import os
    import tempfile
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    code = MESH_RUNNER.format(root=root)
    tmp = tempfile.TemporaryDirectory()
    store = os.path.join(tmp.name, "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = [(w, r, subprocess.Popen(
        [sys.executable, "-c", code, str(w), str(r), store], cwd=tmp.name,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for w, r in ((1, 0), (2, 0), (2, 1))]
    try:
        for w, r, proc in procs:
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            try:
                rec = json.loads(out.strip().splitlines()[-1])
            except (IndexError, ValueError):
                rec = None
            if proc.returncode != 0 or rec is None:
                fail(f"[mesh] world {w} rank {r} exited {proc.returncode}: "
                     f"{out[-1500:]} {err[-3000:]}")
            for line in rec["lines"]:
                print(line, flush=True)
            print(f"  [mesh] world {w} rank {r}: {rec['seconds']:.1f} s in "
                  "its process", flush=True)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    secs = time.perf_counter() - t0
    print(f"[mesh] world size 1 (NCCL) and 2 (gloo) on {name}: every "
          f"sharded run equal to the unsharded one; phase {secs:.1f} s",
          flush=True)
    return secs


#: the host-bound work with no kernel launch that runs in processes of its
#: own, started in phase 20 after its timed table builds (every timed phase
#: before it done) and collected at its end: phase 20's twins that run the
#: float64 scan tiers (~3.5 ms of dispatch a step), phase 13's [eigenrays]
#: and phase 17's [eigenrays3] (float64 scan-tier solves); each (label,
#: module, argv).
#: tl_field_map
#: at its default argv is the TL field map phase 13 ran before (19 x 12
#: receivers, fan 256, its asserts)
APART = (("transmission_loss", "examples", ["6", "160"]),
         ("tl_field_map", "examples", []),
         ("eddy_3d", "examples", ["32", "2300"]),
         ("wavefront_movie", "examples", ["--report-only"]),
         ("phase_eigenrays", "chip_smoke", []),
         ("phase_eigenrays3", "chip_smoke", []))
#: a process of APART: the twin's main (or chip_smoke's function) on the
#: card, then one JSON line with its seconds, the scan-tier traces it built
#: and the kernels it launched
APART_RUNNER = """
import json, sys, time, importlib.util
sys.path.insert(0, {root!r})
import chip_smoke
from raytracing_tpu_torch.engine import dynamic as edyn
traces, inner = [], edyn._build_dynamic_fn
def counting(op_name, max_size, mode, dtype, max_ord=0):
    traces.append((mode, max_size - 1))
    return inner(op_name, max_size, mode, dtype, max_ord)
edyn._build_dynamic_fn = counting
name, where, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
t0 = time.perf_counter()
if where == "chip_smoke":
    getattr(chip_smoke, name)("cuda")
else:
    spec = importlib.util.spec_from_file_location(
        name, {root!r} + "/examples/" + name + "_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv + ["--device", "cuda"])
secs = time.perf_counter() - t0
print(json.dumps({{"seconds": secs, "traces": traces,
                  "launches": sum(k.launches
                                  for k in chip_smoke.kernel_infos())}}))
"""


def start_apart(tmp):
    """Start each of APART in its own process, working in ``tmp``; returns
    [(label, argv, Popen, start time)]."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    code = APART_RUNNER.format(root=root)
    procs = []
    for name, where, argv in APART:
        procs.append((name, argv, subprocess.Popen(
            [sys.executable, "-c", code, name, where, *argv], cwd=tmp,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.perf_counter()))
    return procs


def stop_apart(procs):
    """Kill whatever of ``procs`` still runs."""
    for _, _, proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_apart(procs, timeout=900):
    """Wait for APART's processes; print each one's seconds and the end of
    its output (every line of [eigenrays] and [eigenrays3]); fail if one
    failed.  Returns {label: seconds}."""
    secs = {}
    for name, argv, proc, t0 in procs:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = out.strip().splitlines()
        try:
            rec = json.loads(lines[-1])
        except (IndexError, ValueError):
            rec = None
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or rec is None:
            fail(f"{name} {argv} (own process) exited {proc.returncode}: "
                 f"{err[-2000:]}")
        secs[name] = rec["seconds"]
        if name in ("phase_eigenrays", "phase_eigenrays3"):
            print(f"[{name}] in a process of its own, {rec['seconds']:.1f} "
                  "s:", flush=True)
            for line in lines[:-1]:
                print(line, flush=True)
            continue
        kinds = sorted({m for m, _ in rec["traces"]})
        print(f"  [twin] {name}_torch {' '.join(argv)} (own process): main "
              f"{rec['seconds']:.1f} s, done {wall:.1f} s after it started; "
              f"{len(rec['traces'])} scan-tier dynamic traces "
              f"({', '.join(kinds)}); kernel launches {rec['launches']}",
              flush=True)
        for line in lines[:-1][-4:]:
            print(f"    {line.strip()}", flush=True)
    return secs


def phase_examples(kernels):
    """Phase 20's ``[examples]`` in this process: TWINS_HERE on the card,
    one ``main_path``; returns ({name: seconds}, launches)."""
    import io
    import importlib.util
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    secs = {}

    def run():
        for name, argv, _ in TWINS_HERE:
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(root, "examples", f"{name}_torch.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            t0 = time.perf_counter()
            # delta_s_search writes its checkpoint in the working directory
            with tempfile.TemporaryDirectory() as tmp, \
                    contextlib.chdir(tmp), contextlib.redirect_stdout(buf):
                mod.main(argv + ["--device", "cuda"])
            sync()
            secs[name] = time.perf_counter() - t0
            print(f"  [twin] {name}_torch {' '.join(argv)}: "
                  f"{secs[name]:.1f} s", flush=True)
            for line in buf.getvalue().strip().splitlines()[-4:]:
                print(f"    {line.strip()}", flush=True)

    want = tuple(dict.fromkeys(k for *_, ks in TWINS_HERE for k in ks))
    _, launches = main_path(kernels, want, run)
    return secs, launches



def main_path(kernels, want, run):
    """Drive one main path with every launch count set to 0 just before it
    and read just after; each kernel named in ``want`` must have launched."""
    for k in kernels:
        k.launches = 0
    out = run()
    launches = {k.name: k.launches for k in kernels}
    print(f"[main-path] launches {launches}", flush=True)
    for name in want:
        if launches[name] <= 0:
            fail(f"{name} never launched on its main path")
    return out, {n: launches[n] for n in want}


def main():
    t_start = time.perf_counter()
    name, _ = phase_environment()
    phase_build()
    # the native spline library before the first sampled medium needs it
    build_secs = native_build()
    kernels = kernel_infos()
    media = build_sampled_media("cuda")
    phase_fma32("cuda", media)

    t3 = time.perf_counter()
    errs = phase_kernel_vs_plain("cuda")
    t3_analytic = time.perf_counter() - t3
    t3s = time.perf_counter()
    errs.update(phase_sampled_kernel_vs_plain("cuda", media))
    t3r = time.perf_counter()
    phase_refill_vs_plain("cuda", media, errs)
    t3g = time.perf_counter()
    phase_golden_refill_vs_plain("cuda", media, errs)
    print(f"[phase 3] kernel-vs-plain {t3_analytic:.1f} s, sampled-vs-plain "
          f"{t3r - t3s:.1f} s, refill-vs-plain {t3g - t3r:.1f} s (golden "
          f"{time.perf_counter() - t3g:.1f} s) (plain versions replayed "
          "from CUDA graphs)",
          flush=True)
    # the analytic main path, then the sampled one, counts from zero each
    (times, runs), launches = main_path(
        kernels, ("fisheye_op1", "fused_step", "golden_step"),
        lambda: (phase_headline("cuda", errs), phase_scenarios("cuda")))
    sruns, slaunches = main_path(
        kernels, ("fused_step_strat", "golden_step_strat", "fused_step_grid",
                  "golden_step_grid"),
        lambda: phase_sampled("cuda", media))
    launches.update(slaunches)
    times.update(phase_main_shapes("cuda", errs, runs))
    times.update(phase_sampled_shapes("cuda", errs, media, sruns))
    print(f"[phases 1-7] passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # this slice: the search path and the other entry points, against
    # their plain versions and references
    t_new = time.perf_counter()
    errs["fused_sweep_grid"], times["fused_sweep_grid"], sweep_pos = \
        phase_sweep_vs_plain("cuda", media)
    errs["fused_step_nodes"] = phase_nodes_vs_plain("cuda", media)
    search_runs, search_launches = main_path(
        kernels, ("fused_sweep_grid", "fused_step_nodes"),
        lambda: phase_search_path("cuda", media, kernels))
    launches.update(search_launches)
    phase_search_checks("cuda", errs, times, media, search_runs, sruns,
                        sweep_pos)
    print(f"[phases 1-10] passed in {time.perf_counter() - t_start:.1f} s "
          f"(the search path's {time.perf_counter() - t_new:.1f} s)",
          flush=True)
    # this slice: the dynamic path and the eigenray solver
    t_dyn = time.perf_counter()
    errs.update(phase_dynamic_vs_plain("cuda", media))
    phase_dynamic_refill_vs_plain("cuda", media, errs)
    druns, dlaunches = main_path(
        kernels, ("dynamic_step", "dynamic_step_strat", "dynamic_step_grid"),
        lambda: phase_dynamic("cuda", media))
    launches.update(dlaunches)
    times.update(phase_dynamic_checks("cuda", errs, druns))
    # phase 13's [eigenrays] runs in phase 20, in a process of its own
    # this slice: the df32 tier
    t_df = time.perf_counter()
    df_media = build_df_media("cuda")
    errs.update(phase_df_vs_plain("cuda", df_media))
    dfruns, dflaunches = main_path(
        kernels, ("df_step", "df_step_grid", "df_step_c1", "df_step_profile"),
        lambda: phase_df("cuda", df_media))
    launches.update(dflaunches)
    df_times, df_main_secs = phase_df_checks("cuda", errs, dfruns)
    times.update(df_times)
    # this slice: user-defined media in the fused and golden kernels
    t_cu = time.perf_counter()
    cmedia = custom_media()
    cfields = phase_custom_build("cuda", cmedia)
    errs.update(phase_custom_vs_plain("cuda", cfields))
    curuns, culaunches = main_path(
        kernels, ("fused_step_custom", "golden_step_custom"),
        lambda: phase_custom("cuda", cmedia))
    launches.update(culaunches)
    times.update(phase_custom_checks("cuda", errs, curuns))
    # this slice: the 3-D kinematic tier
    t_3d = time.perf_counter()
    gmed = grid3_medium("cuda")
    print(f"[3d] grid3 medium {gmed.nz}x{gmed.ny}x{gmed.nx} nodes built and "
          f"uploaded in {time.perf_counter() - t_3d:.1f} s", flush=True)
    errs.update(phase_3d_vs_plain("cuda", gmed))
    runs3, launches3 = main_path(
        kernels, ("fused3d_step", "fused3d_step_grid"),
        lambda: phase_3d("cuda", gmed))
    launches.update(launches3)
    times3, secs3 = phase_3d_checks("cuda", errs, runs3, gmed)
    times.update(times3)
    # this slice: the 3-D dynamic tier and the 3-D eigenray solver
    t_d3 = time.perf_counter()
    phase_div_check("cuda")
    errs.update(phase_dyn3_vs_plain("cuda", gmed))
    t_d3_main = time.perf_counter()
    druns3, dlaunches3 = main_path(
        kernels, ("dynamic3d_step", "dynamic3d_step_grid"),
        lambda: phase_dyn3("cuda", gmed))
    launches.update(dlaunches3)
    times.update(phase_dyn3_checks("cuda", errs, druns3, gmed))
    print(f"[phase 17] the 3-D dynamic phase {time.perf_counter() - t_d3:.1f}"
          f" s: [dyn3-vs-plain] {t_d3_main - t_d3:.1f} s ([eigenrays3] runs "
          "in phase 20, in a process of its own)", flush=True)
    # this slice: the differentiable tier, the 3-D df32 facade, history
    # streaming and profiling (no kernels of their own).  The earlier
    # paths' runs and media are dropped first (their figures are in
    # `times`, `errs` and `launches`), so that phase 18 starts from a card
    # holding only what it makes (it allocates up to 16 GB)
    del (media, runs, sruns, search_runs, sweep_pos, druns, df_media, dfruns,
         cmedia, cfields, curuns, gmed, runs3, druns3)
    gc.collect()
    torch.cuda.empty_cache()
    # the objects the earlier phases left are moved out of the collector's
    # reach: phase 18's host-bound loops create tensors by the million, and
    # every full collection would walk them all again
    tracked = len(gc.get_objects())
    gc.freeze()
    print(f"[phase 18] device memory at its start: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved; "
          f"{tracked} objects frozen out of the garbage collector",
          flush=True)
    t_api = time.perf_counter()
    diff_secs, _, _ = phase_diff("cuda")
    df3_secs, _ = phase_df3("cuda")
    stream_secs, _ = phase_stream("cuda")
    prof_secs = phase_profiling("cuda")
    api_secs = time.perf_counter() - t_api
    print(f"[phase 18] [diff] {diff_secs:.1f} s, [df3] {df3_secs:.1f} s,"
          f" [stream] {stream_secs:.1f} s, [profiling] {prof_secs:.1f} "
          f"s: {api_secs:.1f} s together", flush=True)
    # this slice: the serving layer, its requests through the kernels
    serve_secs, _ = phase_serve("cuda", kernels, name)
    # this slice: the sharded path, in processes of its own, before phase
    # 20's timed builds (no other process of this script alive there)
    mesh_secs = phase_mesh(name)
    # this slice: the native spline library, the display path and the
    # example twins.  The timed table builds first, with no other process
    # of this script alive; then the host-bound work with no kernel launch
    # in processes of its own (APART), beside the rest of the phase
    t20 = time.perf_counter()
    native_build_times("cuda")
    times_secs = time.perf_counter() - t20
    import tempfile
    apart_tmp = tempfile.TemporaryDirectory()
    t_apart = time.perf_counter()
    procs = start_apart(apart_tmp.name)
    try:
        native_secs, _ = phase_native("cuda", kernels)
        viz_secs = phase_viz_cli("cuda")
        here_secs, _ = phase_examples(kernels)
        t_here = time.perf_counter() - t_apart
        apart_secs = finish_apart(procs)
    finally:
        stop_apart(procs)
        apart_tmp.cleanup()
    secs20 = time.perf_counter() - t20
    print(f"[phase 20] {secs20:.1f} s: the timed table builds "
          f"{times_secs:.1f} s alone, then beside the processes of APART: "
          f"[native] {native_secs:.1f} s (its g++ build {build_secs:.2f} s, "
          f"before phase 2's media), [viz-cli] {viz_secs:.1f} s, the twins "
          f"here {sum(here_secs.values()):.1f} s, then "
          f"{secs20 - times_secs - t_here:.1f} s waiting for the processes "
          "(their own seconds: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in apart_secs.items()) + ")",
          flush=True)
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s"
          f" (the dynamic path's phases {t_df - t_dyn:.1f} s, the df32 "
          f"phase's {t_cu - t_df:.1f} s, of which its 2^20-ray"
          f" runs against direct launches and the plain version "
          f"{df_main_secs:.1f} s; the custom phase's "
          f"{t_3d - t_cu:.1f} s; the 3-D phase's "
          f"{t_d3 - t_3d:.1f} s, of which [3d-shapes] "
          f"{secs3:.1f} s; the 3-D dynamic phase's "
          f"{t_api - t_d3:.1f} s; phase 18's {api_secs:.1f} s; phase "
          f"19's {serve_secs:.1f} s; [mesh]'s {mesh_secs:.1f} s; phase "
          f"20's {secs20:.1f} s; "
          f"{time.perf_counter() - T_IMPORTS:.1f} s with the imports)",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": errs[k.name].pos, **times[k.name],
         "library_ms": None} for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
