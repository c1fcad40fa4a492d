"""Command line: the reference's interactive menus plus a flags front end.

Port of ``raytracing_tpu/cli.py``: ``_menu`` and ``_yes_no`` (cli.py:58-77),
``op_for_choice`` (:79), ``run_batch`` (:86), ``load_samples_medium``
(:130), ``run_samples_file`` (:159), ``run_eigenrays_file`` (:273),
``run_eigenrays3_file`` (:336), ``samples_is_profile`` (:397),
``build_medium`` (:404), ``run_pipeline`` (:419), ``interactive`` (:514)
and ``main`` (:566) — the reference's main() pipeline (RT_bench.py:961-1547)
with its three modes: display/validate (with the plots of
``viz/plots.py``), search for a suitable DELTA_S (``--delta-s search``),
and benchmark.  Everything runs on ``--device`` (default ``cuda``); the
search runs through the kernels there.

    python -m raytracing_tpu_torch.cli                 # interactive menus
    python -m raytracing_tpu_torch.cli --scenario fisheye --op 1 --delta-s search
    python -m raytracing_tpu_torch.cli --scenario vert --op 8 --benchmark
    python -m raytracing_tpu_torch.cli --scenario vert --op 8 --plot static --save-plot f.png

Without ``--scenario`` or ``--medium-file`` the program asks through the
reference's stdin menus (RT_bench.py:1550-1588, 1199-1294): scenario,
algorithm, DELTA_S search or calibrated step, benchmark, plot.
``--plot static`` draws the trajectories (and for the vertically
heterogeneous scenarios the wavefronts, their console report and the
momentum plot, saved beside ``--save-plot`` as ``.momentum.png``);
``--plot movie`` animates the wavefronts (``--save-video``: mp4 by ffmpeg,
a GIF where there is none).

``--medium-file`` with ``--eigenrays SRC_X SRC_Y`` solves the boundary-value
problem instead (``run_eigenrays_file``, cli.py:273-333): every fan-resolved
arrival from the source to each ``--receiver`` through the measured medium
(float64 tables, on ``--device``), reduced to transmission loss.
``--eigenrays3 SRC_X SRC_Y SRC_Z`` with ``--receiver3`` (and ``--fan3``)
lifts a 1-D profile to a ``Stratified3D`` and solves in 3-D
(``run_eigenrays3_file``, cli.py:336-394, ``engine/eigenray3d.py``); a 2-D
grid file is refused, as JAX refuses it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.bench import harness
from raytracing_tpu_torch.calibrated import calibrated_with_fallback
from raytracing_tpu_torch.engine import eigenray as er
from raytracing_tpu_torch.engine.eigenray3d import find_eigenrays3
from raytracing_tpu_torch.engine import oracles
from raytracing_tpu_torch.engine.fast import STRAT_MEDIA, fast_trace
from raytracing_tpu_torch.engine.trace import _torch_dtype, trace
from raytracing_tpu_torch.engine.trace3d import canonical3
from raytracing_tpu_torch.media.fields3d import Stratified3D
from raytracing_tpu_torch.media.medium import analytic_medium
from raytracing_tpu_torch.media.samples import medium_from_samples
from raytracing_tpu_torch.media.spline import (
    build_grid_medium, build_stratified_medium)
from raytracing_tpu_torch.ops.registry import GOLDEN_OPS, canonical
from raytracing_tpu_torch.parallel.sweep import (
    delta_s_search, delta_s_search_convergence)

BOLD, BLUE, GREEN, RESET = "\033[1m", "\033[1;94m", "\033[92m", "\033[0m"

SCENARIO_TITLES = [
    "the sharp interface scenario",
    "the fish-eye scenario",
    "the isotropic vertically heterogeneous scenario",
    "the anisotropic vertically heterogeneous scenario",
]

ISO_MESSAGES = [
    " 1st order Taylor  + analytical 2-point momentum-impulse",
    " 1st order Taylor  + d_theta/d_s Runge-Kutta (AnDF)",
    " 2-point curvature + d_theta/d_s Runge-Kutta",
    " 2-point curvature + analytical 2-point momentum-impulse",
    " 2-point curvature + optimized  2-point momentum-impulse",
    " 2nd order Taylor  + d_theta/d_s Runge-Kutta (HySA)",
    " 2nd order Taylor  + 4-point difference method (MxSA)",
    " 2nd order Taylor  + analytical 2-point momentum-impulse",
    " 2nd order Taylor  + optimized  2-point momentum-impulse",
]
ANISO_MESSAGES = [
    " 2-point curvature + optimized 2-point momentum-impulse",
    " 2nd order Taylor  + optimized 2-point momentum-impulse",
]


def _menu(title: str, items: list[str], prompt: str, keys: list[str],
          input_fn) -> str:
    while True:
        print(f"{BOLD}\n{title}{RESET}")
        print("─" * max(len(title), 20))
        for i, item in enumerate(items, 1):
            print(f"• {BLUE}{i}.{RESET} {item}")
        choice = input_fn(f"\n{GREEN}{prompt}{RESET} ").strip()
        if choice in keys:
            return choice
        print(f"Invalid choice. Please choose {', '.join(keys[:-1])} or {keys[-1]}.")


def _yes_no(prompt: str, input_fn) -> bool:
    while True:
        v = input_fn(f"\n{GREEN}{prompt} (Y/N):{RESET} ").strip().lower()
        if v in ("y", "n"):
            return v == "y"
        print("Invalid input. Please enter 'Y' or 'N'.")


def op_for_choice(scen_name: str, choice: str) -> str:
    """Menu number -> op, matching RT_bench.py:1238-1291."""
    if scen_name == "aniso":
        return {"1": "op10", "2": "op11"}[choice]
    return f"op{int(choice)}"


def _host(t) -> np.ndarray:
    """A tensor's values on the host (synchronizes with the card)."""
    return t.detach().cpu().numpy()


def build_medium(scen, medium_kind: str = "auto", dtype=torch.float32,
                 device="cuda"):
    """Medium per CLI choice, built on ``device``.  "auto" = the cheapest
    sampled-grid representation with reference physics: 1-D stratified
    tables for the x-independent fields, the full 2-D grid for the
    fisheye."""
    if medium_kind == "analytic":
        return analytic_medium(scen.field)
    if medium_kind == "auto":
        medium_kind = "grid" if scen.is_fisheye else "stratified"
    kw = dict(device=device, dtype=_torch_dtype(dtype))
    if medium_kind == "stratified":
        return build_stratified_medium(scen.field, scen.box, **kw)
    return build_grid_medium(scen.field, scen.box, **kw)


def run_batch(scen, op_name: str, rays: int, *, delta_s_mode: str,
              medium_kind: str, n_turns: int, device="cuda", printer=print):
    """Production path: a custom-size ray batch through the kernels.

    Launch fan: ``rays`` angles spread over the scenario's span, all from the
    scenario's start position.  Reports throughput and the scenario metric.
    """
    medium = build_medium(scen, medium_kind, device=device)
    if delta_s_mode == "calibrated":
        delta_s, divisor = calibrated_with_fallback(op_name, scen.name)
    else:
        divisor = config.DELTA_S_DIVISOR_FISHEYE
        delta_s = 2 * np.pi / divisor if scen.is_fisheye else config.DELTA_S
    if scen.is_fisheye:
        theta0 = np.full(rays, np.pi / 2.0, np.float32)
        pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (rays, 1))
        steps = scen.max_size(delta_s, int(divisor) + 1, n_turns) - 1
    else:
        theta0 = np.linspace(scen.theta0[0], scen.theta0[-1],
                             rays).astype(np.float32)
        pos0 = np.tile(scen.pos0[:1].astype(np.float32), (rays, 1))
        steps = scen.max_size(delta_s) - 1

    def run():
        out = fast_trace(op_name, scen, medium, delta_s=delta_s, steps=steps,
                         pos0=pos0, theta0=theta0, device=device)
        _host(out.pos[:1])
        return out

    run()   # builds the kernels on first use
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    printer(f"\n{rays} rays x {steps} steps via the {out.engine} engine: "
            f"{dt:.3f}s  ({rays * steps / dt:.3e} ray-steps/s)")
    if scen.is_fisheye:
        closure = 100 * np.linalg.norm(_host(out.pos[0]) - [1, 0]) / (2 * np.pi)
        printer(f"Closure error  {closure} %")
    printer(f"Escaped rays: {int(rays - _host(out.active).sum())} / {rays}")
    return out


def load_samples_medium(path: str, family: str = "parity",
                        dtype=torch.float32, device="cuda"):
    """(medium, default_box, description) from a measured ``.npz`` file.

    The file carries ``samples`` — a (ny, nx) index grid with coordinate
    vectors ``x``/``y``, or a (ny,) profile with ``y`` only.
    """
    with np.load(path) as data:
        if "samples" not in data:
            raise SystemExit(f"{path}: needs a 'samples' array "
                             "(plus 'x'/'y' coordinate vectors)")
        samples = np.asarray(data["samples"], np.float64)
        y = np.asarray(data["y"], np.float64) if "y" in data else None
        x = np.asarray(data["x"], np.float64) if "x" in data else None
    try:
        medium, default_box, kind = medium_from_samples(
            samples, x, y, family=family, device=device,
            dtype=_torch_dtype(dtype))
    except ValueError as e:
        raise SystemExit(f"{path}: {e}")
    kind = (f"{len(y)}-sample profile" if kind == "profile"
            else f"{len(y)}x{len(x)} grid")
    return medium, default_box, kind


def run_samples_file(path: str, op_name: str, *, delta_s: float, steps: int,
                     rays: int, launch, family: str = "parity",
                     box=None, gamma: float = 1.0, save_pos=None,
                     plot: str = "none", save_plot=None,
                     preloaded=None, device="cuda", printer=print):
    """Trace a measured medium loaded from an ``.npz`` file.

    ``launch`` is (x, y_lo, y_hi, theta): a ``rays``-ray fan.  A profile
    (x-independent) medium also reports the conservation of p_x, from the
    kernels' Welford tracker, or from a strided subset's scan-tier history
    where the op has no tracker.  ``plot="static"`` draws that subset's
    trajectories over the medium (``save_plot``: the figure's file).
    """
    medium, default_box, kind = (preloaded if preloaded is not None
                                 else load_samples_medium(path, family,
                                                          device=device))
    box = tuple(box) if box else default_box
    if not (box[0] < box[1] and box[2] < box[3]):
        raise SystemExit(f"--box must be ordered (x0 < x1, y0 < y1), "
                         f"got {box}")
    scen = dataclasses.replace(config.scenario("fisheye"), name="samples",
                               gamma=gamma, box=box)

    lx, ylo, yhi, th = (float(v) for v in launch)
    pos0 = np.stack([np.full(rays, lx, np.float32),
                     np.linspace(ylo, yhi, rays, dtype=np.float32)], -1)
    theta0 = np.full(rays, th, np.float32)
    kw = dict(delta_s=np.float32(delta_s), steps=steps, pos0=pos0,
              theta0=theta0, device=device)

    fast_trace(op_name, scen, medium, **kw)   # builds the kernels
    t0 = time.perf_counter()
    out = fast_trace(op_name, scen, medium, **kw)
    pos = _host(out.pos)
    dt = time.perf_counter() - t0
    printer(f"\n{kind} ({family}) from {path}")
    printer(f"{rays} rays x {steps} steps via the {out.engine} engine: "
            f"{dt:.3f}s  ({rays * steps / dt:.3e} ray-steps/s)")
    printer(f"Escaped rays: {int(rays - _host(out.active).sum())} "
            f"/ {rays}")
    printer(f"Mean final position: ({pos[:, 0].mean():+.5f}, "
            f"{pos[:, 1].mean():+.5f})")
    if save_pos:
        np.save(save_pos, pos)
        printer(f"Final positions saved to {save_pos}")

    # the conservation fallback and the static plot share one strided
    # subset's history trace, run at most once (a whole scan-tier run)
    _sub = []

    def subset_history():
        if not _sub:
            # strided subset: the first rays of a linspace fan would all
            # sample one edge of the launch span
            sel = slice(None, None, max(1, rays // 64))
            _sub.append(trace(op_name, scen, medium, delta_s=float(delta_s),
                              mode="history", max_size=steps + 1,
                              pos0=pos0[sel], theta0=theta0[sel],
                              device=device))
        return _sub[0]

    if isinstance(medium, STRAT_MEDIA):
        try:
            # full-batch conservation from the kernels' Welford tracker
            s = fast_trace(op_name, scen, medium, stats=True, **kw)
            cv = oracles.momentum_cv_pct_from_welford(
                s.mom_count, s.mom_mean, s.mom_m2)
            span = f"full {rays}-ray batch"
        except ValueError:              # op has no stats kernel path
            res = subset_history()
            cv = _host(oracles.momentum_cv_pct_from_history(res))
            span = f"{res.history.shape[1]}-ray subset"
        cv_mean, cv_max, n_excluded = oracles.momentum_cv_summary(cv)
        if np.isnan(cv_mean):
            printer("Momentum conservation CV(p_x): undefined — every "
                    "ray launches with p_x ~ 0 (theta at ±pi/2)")
        else:
            note = (f" [{n_excluded} rays with p_x ~ 0 excluded]"
                    if n_excluded else "")
            printer(f"Momentum conservation CV(p_x), {span}: "
                    f"mean {cv_mean:.6f} % / max {cv_max:.6f} % "
                    f"(x-independent medium: p_x is an invariant){note}")
    if plot == "static":
        from raytracing_tpu_torch.viz import plots

        res = subset_history()
        pscen = scen
        if not np.all(np.isfinite(scen.box)) or \
                max(map(abs, scen.box)) > 1e6:
            # an unbounded box (a profile's default) cannot frame a plot:
            # frame the subset's trajectories instead
            h = _host(res.history)
            pscen = dataclasses.replace(scen, box=(
                float(h[:, :, 0].min()), float(h[:, :, 0].max()),
                float(h[:, :, 1].min()), float(h[:, :, 1].max())))
        fig, _ = plots.plot_static(res, pscen, medium=medium, save=save_plot)
        if save_plot:
            printer(f"Plot saved to {save_plot}")
        plots._mpl()[1].close(fig)
    return out


def run_eigenrays_file(path: str, op_name: str, *, delta_s: float,
                       steps: int, source, receivers, fan=None, box=None,
                       gamma: float = 1.0, omega=None,
                       family: str = "parity", device="cuda", printer=print):
    """Eigenray arrivals and transmission loss through a measured medium:
    every fan-resolved ray path from ``source`` to each receiver, with
    travel time, amplitude and KMAH caustic phase, reduced to per-receiver
    TL (``engine/eigenray.py``).  The medium's tables are float64."""
    if op_name in GOLDEN_OPS:
        raise SystemExit(
            f"{op_name} uses a golden-section solver whose paraxial "
            f"tangents vanish (engine/dynamic.py); use a smooth op "
            f"(op1-op4, op6-op8, op12) or op10n/op11n")
    medium, default_box, kind = load_samples_medium(
        path, family, dtype=torch.float64, device=device)
    box = tuple(box) if box else default_box
    fan = tuple(fan) if fan else (-0.3, 0.3, 256)
    receivers = np.atleast_2d(np.asarray(receivers, np.float64))
    # max_size = steps + 1: --steps counts integration steps, as in the
    # forward --medium-file path (run_samples_file)
    eig = er.find_eigenrays(op_name, medium, source=source,
                            receivers=receivers, delta_s=delta_s,
                            max_size=int(steps) + 1, box=box, gamma=gamma,
                            fan=(float(fan[0]), float(fan[1]), int(fan[2])),
                            device=device)
    printer(f"\n{kind} ({family}) from {path}")
    printer(f"eigenrays {op_name}: source ({source[0]:g}, {source[1]:g}), "
            f"fan [{fan[0]:g}, {fan[1]:g}] x {int(fan[2])}, "
            f"delta_s {delta_s:g} x {steps} steps")
    k = len(receivers)
    itl = er.incoherent_tl(eig, n_receivers=k)
    ctl = (er.coherent_tl(eig, float(omega), n_receivers=k)
           if omega is not None else None)
    printer(f"{'receiver':>18} {'theta0':>11} {'traveltime':>12} "
            f"{'amplitude':>10} {'kmah':>5} {'miss':>9}")
    for i, (rx, ry) in enumerate(receivers):
        e = eig.for_receiver(i)
        if not len(e.theta0):
            printer(f"({rx:7.3g}, {ry:6.3g})   no arrivals in the fan")
            continue
        for t, tt, a, m, ye in zip(e.theta0, e.traveltime, e.amplitude,
                                   e.kmah, e.y_err):
            printer(f"({rx:7.3g}, {ry:6.3g}) {t:+11.6f} {tt:12.6f} "
                    f"{a:10.4f} {int(m):5d} {ye:+9.1e}")
        line = f"    TL incoherent {itl[i]:7.2f} dB"
        if ctl is not None and np.isfinite(ctl[i]):
            line += f"   coherent {ctl[i]:7.2f} dB (omega {omega:g})"
        printer(line)
    n_bad = int(np.sum(~np.asarray(eig.converged)))
    if n_bad:
        printer(f"WARNING: {n_bad} arrival(s) above miss tolerance")
    return eig


def run_eigenrays3_file(path: str, op_name: str, *, delta_s: float,
                        steps: int, source, receivers, fan=None, box=None,
                        omega=None, family: str = "parity", device="cuda",
                        printer=print):
    """3-D eigenray arrivals and TL through a measured PROFILE medium: the
    profile (float64 tables) lifts to a ``Stratified3D`` and
    ``engine/eigenray3d.py::find_eigenrays3`` Gauss-Newtons a two-angle
    launch grid onto each (x, y, z) receiver."""
    method = canonical3(op_name)
    medium2d, default_box, kind = load_samples_medium(
        path, family, dtype=torch.float64, device=device)
    if not samples_is_profile(medium2d):
        raise SystemExit("--eigenrays3 lifts 1-D PROFILES (n = n(y)); this "
                         "file holds a 2-D grid — use --eigenrays for the "
                         "planar pipeline")
    medium = Stratified3D(medium2d)
    box = tuple(box) if box else (-1e30, 1e30, default_box[2],
                                  default_box[3], -1e30, 1e30)
    fan = tuple(fan) if fan else (-0.3, 0.3, 25, -0.3, 0.3, 25)
    receivers = np.atleast_2d(np.asarray(receivers, np.float64))
    eig = find_eigenrays3(
        method, medium, source=tuple(source), receivers=receivers,
        delta_s=delta_s, max_size=int(steps), box=box,
        fan=(float(fan[0]), float(fan[1]), int(fan[2]),
             float(fan[3]), float(fan[4]), int(fan[5])), device=device)
    printer(f"\n{kind} ({family}) from {path}, lifted to 3-D")
    printer(f"eigenrays3 {method}: source ({source[0]:g}, {source[1]:g}, "
            f"{source[2]:g}), fan {int(fan[2])}x{int(fan[5])}, "
            f"delta_s {delta_s:g} x {steps} steps")
    k = len(receivers)
    itl = er.incoherent_tl(eig, n_receivers=k)
    ctl = (er.coherent_tl(eig, float(omega), n_receivers=k)
           if omega is not None else None)
    printer(f"{'receiver':>26} {'traveltime':>12} {'amplitude':>10} "
            f"{'kmah':>5} {'miss':>9}")
    for i, (rx, ry, rz) in enumerate(receivers):
        e = eig.for_receiver(i)
        if not len(e.traveltime):
            printer(f"({rx:7.3g}, {ry:6.3g}, {rz:6.3g})  no arrivals")
            continue
        for tt, a, m, ye in zip(e.traveltime, e.amplitude, e.kmah, e.miss):
            printer(f"({rx:7.3g}, {ry:6.3g}, {rz:6.3g}) {tt:12.6f} "
                    f"{a:10.4f} {int(m):5d} {ye:+9.1e}")
        line = f"    TL incoherent {itl[i]:7.2f} dB"
        if ctl is not None and np.isfinite(ctl[i]):
            line += f"   coherent {ctl[i]:7.2f} dB (omega {omega:g})"
        printer(line)
    return eig


def samples_is_profile(medium) -> bool:
    """Whether a medium loaded from a samples file is a 1-D profile."""
    return isinstance(medium, STRAT_MEDIA)


def run_pipeline(scen, op_name: str, *, delta_s_mode: str = "calibrated",
                 medium_kind: str = "auto", dtype=torch.float32,
                 n_turns: int = config.N_TURNS, do_benchmark: bool = False,
                 bench_trials: int = 10, plot: str = "none", save_plot=None,
                 save_video=None, device="cuda", printer=print):
    """The reference's main() pipeline, flag-driven (RT_bench.py:961-1547):
    the step (searched, calibrated or default), the display run through
    the scan tier with its oracle, the optional benchmark, and the plots
    (RT_bench.py:1121-1197: ``plot`` "static" or "movie")."""
    dtype = _torch_dtype(dtype)
    medium = build_medium(scen, medium_kind, dtype, device=device)

    divisor = None
    if delta_s_mode == "search":
        printer("\nFINDING SUITABLE DIVISOR...")
        sr = delta_s_search(op_name, scen, medium, n_turns=n_turns,
                            dtype=dtype, device=device)
        if sr.index is None:
            printer("\nNo suitable divisor was found. Try using another search "
                    "interval (*_UPPER_LIMIT, *_LOWER_LIMIT). Exiting...")
            return None
        delta_s = sr.delta_s_selected
        if scen.is_fisheye:
            divisor = int(sr.divisor)
            printer(f"Found best divisor! Using DELTA_S = 2*pi / {divisor:.0f}")
        else:
            printer(f"Found best divisor! Using DELTA_S = SIGMA / {sr.divisor:.2f}")
    elif delta_s_mode == "calibrated":
        delta_s, divisor = calibrated_with_fallback(op_name, scen.name)
    else:  # default constants (RT_bench.py:79-84)
        delta_s = config.DELTA_S
        divisor = config.DELTA_S_DIVISOR_FISHEYE
        if scen.is_fisheye:
            delta_s = 2 * np.pi / divisor

    kw = dict(delta_s=delta_s, n_turns=n_turns, dtype=dtype, device=device,
              divisor=(divisor + 1) if scen.is_fisheye else None)
    t1 = time.perf_counter()
    result = trace(op_name, scen, medium, **kw)
    _host(result.final.pos[:1])
    t2 = time.perf_counter()

    printer("\nRESULTS")
    if scen.is_fisheye:
        printer(f"Closure error  {float(oracles.closure_error_pct(result)[0])} %")
    elif scen.is_interface:
        # per-ray Snell table, the reference's show=True run (RT_bench.py:1470)
        errs = oracles.snell_report(result, scen.theta0, printer=printer)
        printer(f"Average ray error:  {errs.mean()} degrees")
    else:
        cv = oracles.momentum_cv_pct_from_history(result)
        printer(f"Average ray Coefficient of Variation:  "
                f"{float(oracles.scenario_average_cv_pct(cv))}")
    printer(f"Total travelled distance:  {float(result.dist_sim.sum())}")

    if do_benchmark:
        # protocol banner with a duration estimate from the timed display
        # run, mirroring RT_bench.py:1487-1500
        est_min = round((t2 - t1) * (2 + bench_trials * 2) / 60.0, 1)
        printer(f"{BOLD}\nBenchmarking Process{RESET}")
        printer("────────────────────")
        printer(f"• {BOLD}Purpose:{RESET} measure execution time per scenario: warmup runs,")
        printer(f"           then {bench_trials} trials per round until two round medians agree within 0.5%.")
        printer(f"• {BOLD}Estimated Duration:{RESET} ~{est_min} minutes (two convergence rounds assumed).")
        idx = int(op_name[2:].rstrip("n"))
        if scen.is_aniso and idx >= 10:
            msg = ANISO_MESSAGES[min(idx, 11) - 10]
        elif idx <= 9:
            msg = ISO_MESSAGES[idx - 1]
        else:
            msg = f" {op_name}"
        printer(f"Benchmarking{msg} in {SCENARIO_TITLES[int(scen.key) - 1]}...")

        def fn():
            r = trace(op_name, scen, medium, mode="metrics", **kw)
            _host(r.final.pos[:1])

        steps = scen.max_size(delta_s, kw["divisor"], n_turns) - 1
        b = harness.benchmark(fn, scen.ray_count * steps, trials=bench_trials)
        printer(f"\nCompletion time per scenario: {b.seconds} seconds.")
        printer(f"Throughput: {b.ray_steps_per_sec:.3e} ray-steps/sec")

    if plot != "none":
        from raytracing_tpu_torch.viz import plots
        _, plt = plots._mpl()
        if plot == "movie" and scen.is_vert:
            ani, _ = plots.animate_wavefronts(result, scen, save=save_video)
            plt.close(ani._fig)
        else:
            fig, _ = plots.plot_static(result, scen, save=save_plot)
            plt.close(fig)
            if scen.is_vert:
                plots.wavefront_report(result, printer=printer)
                plt.close(plots.plot_momentum(
                    result, scen, delta_s=delta_s,
                    save=(save_plot + ".momentum.png") if save_plot
                    else None))
    return result


def interactive(input_fn=input, device="cuda"):
    """The reference's stdin flow (RT_bench.py:1550-1588), on ``device``."""
    key = _menu("Choose a Test Option",
                ["Sharp changes in n(x,y)", "Gradual changes in n(x,y)",
                 "Vertically heterogeneous - isotropic",
                 "Vertically heterogeneous - anisotropic"],
                "Enter the number of your choice:",
                ["1", "2", "3", "4"], input_fn)
    scen = config.scenario(key)
    if key == "4":
        choice = _menu("Choose an Algorithm Option. (Methods for ray advancement + angle determination)",
                       [f"Run{m}..." for m in ANISO_MESSAGES],
                       "Enter the number of your choice:", ["1", "2"], input_fn)
    else:
        choice = _menu("Choose an Algorithm Option. (Methods for ray advancement + angle determination)",
                       [f"Run{m}..." for m in ISO_MESSAGES],
                       "Enter the number of your choice:",
                       [str(i) for i in range(1, 10)], input_fn)
    op_name = op_for_choice(scen.name, choice)

    if _yes_no("Do you want to find an appropriate DELTA_S?", input_fn):
        mode = "search"
    elif _yes_no("Do you want to use the calibrated DELTA_S? If not, the "
                 "default DELTA_S will be used.", input_fn):
        mode = "calibrated"
    else:
        mode = "default"

    do_bench = _yes_no("Do you want to proceed with the benchmark?", input_fn)
    plot = "none"
    save_video = None
    if scen.is_vert:
        while True:
            v = input_fn(f"\n{GREEN}Do you want to make a static (enter 1) or "
                         f"movie (enter 2) plot?: {RESET} ").strip()
            if v in ("1", "2"):
                plot = "static" if v == "1" else "movie"
                break
            print("Invalid input. Please enter 1 or 2.")
        if plot == "movie" and _yes_no("Do you want to save a video?", input_fn):
            save_video = "wavefront_propagation.mp4"
    else:
        plot = "static"

    return run_pipeline(scen, op_name, delta_s_mode=mode,
                        do_benchmark=do_bench, plot=plot,
                        save_video=save_video, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracing_tpu_torch",
                                description="batched ray tracing on the "
                                            "GPU (PyTorch and CUDA)")
    p.add_argument("--scenario", choices=["interface", "fisheye", "vert",
                                          "aniso", "1", "2", "3", "4"])
    p.add_argument("--op", help="algorithm menu number (1-9 iso, 1-2 aniso) "
                                "or op name/alias (op6, HySA, ...)")
    p.add_argument("--delta-s", dest="delta_s_mode", default="calibrated",
                   choices=["search", "calibrated", "default"])
    p.add_argument("--medium", default="auto",
                   choices=["auto", "grid", "stratified", "analytic"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--n-turns", type=int, default=config.N_TURNS)
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--bench-trials", type=int, default=10)
    p.add_argument("--rays", type=int,
                   help="trace a custom-size batch through the kernels "
                        "instead of the scenario's reference fan")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--plot", default="none", choices=["none", "static", "movie"])
    p.add_argument("--save-plot")
    p.add_argument("--save-video")
    g = p.add_argument_group("measured media (.npz with samples + x/y)")
    g.add_argument("--medium-file", metavar="FILE.npz",
                   help="trace a MEASURED medium instead of a named "
                        "scenario; needs --op, --delta-s-value, --steps, "
                        "--launch")
    g.add_argument("--family", default="parity", choices=["parity", "c1"],
                   help="reference-exact pipeline or consistent-gradient")
    g.add_argument("--delta-s-value", type=float,
                   help="integration step (no calibrated table exists "
                        "for user media)")
    g.add_argument("--steps", type=int, help="integration step count")
    g.add_argument("--launch", nargs=4, type=float,
                   metavar=("X", "Y_LO", "Y_HI", "THETA"),
                   help="ray fan: start x, y span, launch angle")
    g.add_argument("--box", nargs=4, type=float,
                   metavar=("X0", "X1", "Y0", "Y1"),
                   help="exit box (default: the sample extent)")
    g.add_argument("--gamma", type=float, default=1.0)
    g.add_argument("--save-pos", metavar="OUT.npy",
                   help="write final positions to a .npy file")
    g.add_argument("--calibrate", type=float, metavar="TOL",
                   help="pick delta_s by Richardson self-convergence "
                        "(halving-displacement tolerance; measured media "
                        "have no physics oracle) — replaces "
                        "--delta-s-value/--steps, needs --arc-length")
    g.add_argument("--arc-length", type=float,
                   help="trace length for --calibrate")
    g.add_argument("--eigenrays", nargs=2, type=float,
                   metavar=("SRC_X", "SRC_Y"),
                   help="solve the boundary-value problem from this source "
                        "to every --receiver instead of tracing a fan")
    g.add_argument("--receiver", nargs=2, type=float, action="append",
                   metavar=("X", "Y"), help="receiver point (repeatable)")
    g.add_argument("--fan", nargs=3, type=float,
                   metavar=("TH_LO", "TH_HI", "COUNT"),
                   help="eigenray search fan (default -0.3 0.3 256)")
    g.add_argument("--omega", type=float,
                   help="angular frequency (rad per traveltime unit) for "
                        "coherent TL")
    g.add_argument("--eigenrays3", nargs=3, type=float,
                   metavar=("SRC_X", "SRC_Y", "SRC_Z"),
                   help="3-D boundary-value arrivals from this source to "
                        "every --receiver3 (the profile lifts to a 3-D "
                        "stratified medium)")
    g.add_argument("--receiver3", nargs=3, type=float, action="append",
                   metavar=("X", "Y", "Z"),
                   help="3-D receiver point (repeatable)")
    g.add_argument("--fan3", nargs=6, type=float,
                   metavar=("A_LO", "A_HI", "NA", "B_LO", "B_HI", "NB"),
                   help="3-D eigenray launch grid around the source->mean-"
                        "receiver direction (default -0.3 0.3 25 x2)")
    args = p.parse_args(argv)

    if args.eigenrays is not None and not args.medium_file:
        p.error("--eigenrays needs --medium-file (measured media; named "
                "scenarios have analytic eigenray oracles in the tests)")
    if args.eigenrays3 is not None and not args.medium_file:
        p.error("--eigenrays3 needs --medium-file (a measured 1-D profile)")
    device = args.device

    if args.medium_file and args.eigenrays3 is not None:
        need = [("--op", args.op), ("--delta-s-value", args.delta_s_value),
                ("--steps", args.steps), ("--receiver3", args.receiver3)]
        missing = [f for f, v in need if v is None]
        if missing:
            p.error(f"--eigenrays3 needs {', '.join(missing)}")
        op = canonical(f"op{int(args.op)}" if args.op.isdigit()
                       else args.op)
        return run_eigenrays3_file(
            args.medium_file, op, delta_s=args.delta_s_value,
            steps=args.steps, source=args.eigenrays3,
            receivers=args.receiver3, fan=args.fan3, omega=args.omega,
            family=args.family, device=device)

    if args.medium_file and args.eigenrays is not None:
        if args.calibrate is not None:
            p.error("--eigenrays and --calibrate are mutually exclusive; "
                    "calibrate first, then pass --delta-s-value")
        need = [("--op", args.op), ("--delta-s-value", args.delta_s_value),
                ("--steps", args.steps), ("--receiver", args.receiver)]
        missing = [f for f, v in need if v is None]
        if missing:
            p.error(f"--eigenrays needs {', '.join(missing)}")
        op = canonical(f"op{int(args.op)}" if args.op.isdigit()
                       else args.op)
        return run_eigenrays_file(
            args.medium_file, op, delta_s=args.delta_s_value,
            steps=args.steps, source=args.eigenrays,
            receivers=args.receiver, fan=args.fan, box=args.box,
            gamma=args.gamma, omega=args.omega, family=args.family,
            device=device)

    if args.medium_file:
        calibrating = args.calibrate is not None
        need = [("--op", args.op), ("--launch", args.launch)]
        need += ([("--arc-length", args.arc_length)] if calibrating else
                 [("--delta-s-value", args.delta_s_value),
                  ("--steps", args.steps)])
        missing = [f for f, v in need if v is None]
        if missing:
            p.error(f"--medium-file needs {', '.join(missing)}")
        if args.plot == "movie":
            p.error("--plot movie is not supported with --medium-file "
                    "(wavefront movies need a named scenario); use "
                    "--plot static")
        op = canonical(f"op{int(args.op)}" if args.op.isdigit()
                       else args.op)
        delta_s, steps = args.delta_s_value, args.steps
        pre = load_samples_medium(args.medium_file, args.family,
                                  device=device)
        if calibrating:
            medium, default_box, kind = pre
            rays = min(args.rays or 1024, 4096)   # search fan
            lx, ylo, yhi, th = args.launch
            pos0 = np.stack([np.full(rays, lx, np.float32),
                             np.linspace(ylo, yhi, rays,
                                         dtype=np.float32)], -1)
            sr = delta_s_search_convergence(
                op, medium, pos0=pos0, theta0=np.full(rays, th, np.float32),
                arc_length=args.arc_length,
                box=tuple(args.box) if args.box else default_box,
                gamma=args.gamma, tol=args.calibrate, device=device)
            if sr.index is None:
                raise SystemExit(
                    f"no candidate step reached halving tolerance "
                    f"{args.calibrate} (errors: {sr.metrics['halving_err']})")
            delta_s = sr.delta_s_selected
            steps = int(sr.divisor)
            print(f"calibrated ({kind}): delta_s = {delta_s:.6g} "
                  f"({steps} steps over arc {args.arc_length}; halving "
                  f"displacement {sr.metrics['halving_err'][sr.index]:.2e})")
        return run_samples_file(
            args.medium_file, op, delta_s=delta_s, steps=steps,
            rays=args.rays or 1024, launch=args.launch,
            family=args.family, box=args.box, gamma=args.gamma,
            save_pos=args.save_pos, plot=args.plot,
            save_plot=args.save_plot, preloaded=pre, device=device)

    if args.scenario is None:
        return interactive(device=device)

    scen = config.scenario(args.scenario)
    op_name = args.op or "1"
    if op_name.isdigit():
        op_name = op_for_choice(scen.name, op_name)
    if args.rays:
        return run_batch(scen, op_name, args.rays,
                         delta_s_mode=args.delta_s_mode,
                         medium_kind=args.medium, n_turns=args.n_turns,
                         device=device)
    return run_pipeline(
        scen, op_name, delta_s_mode=args.delta_s_mode,
        medium_kind=args.medium, dtype=np.dtype(args.dtype),
        n_turns=args.n_turns, do_benchmark=args.benchmark,
        bench_trials=args.bench_trials, plot=args.plot,
        save_plot=args.save_plot, save_video=args.save_video, device=device)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
