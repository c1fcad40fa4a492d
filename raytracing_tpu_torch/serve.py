"""Minimal production serving layer: ray tracing over HTTP, on the card.

Port of ``raytracing_tpu/serve.py``: the caps (serve.py:68-72, 371-373,
508), ``_trace_request`` (:75), ``_finite`` (:157), ``_samples_medium``
(:163), ``_launch_fan`` (:188), ``_samples_scenario`` (:227),
``_calibrate_samples_request`` (:243), ``_trace_samples_request`` (:296),
``_eigenrays_request`` (:376), ``_trace3d_samples_request`` (:511),
``_eigenrays3_request`` (:647), ``_Handler`` (:770), ``create_server``
(:824) and ``main`` (:828).  A long-lived process answers JSON requests
through the port's kernels, on the stdlib ``http.server``:

    GET  /healthz              -> {"status": "ok", "device": ..., "version"}
    GET  /v1/models            -> scenarios, ops, extensions, media, ...
    POST /v1/trace             -> a named scenario through fast_trace
    POST /v1/trace_samples     -> a posted measured medium (2-D grid or 1-D
                                  profile) through fast_trace
    POST /v1/calibrate_samples -> delta_s for that medium by Richardson
                                  self-convergence
    POST /v1/trace3d_samples   -> a posted profile (lifted) or 3-D grid
                                  through the 3-D scan tier
    POST /v1/eigenrays         -> boundary-value arrivals and TL (2-D)
    POST /v1/eigenrays3        -> the same in 3-D, through a lifted profile

    python -m raytracing_tpu_torch.serve --port 8080               # the card
    python -m raytracing_tpu_torch.serve --port 8080 --device cpu  # plain versions

The server has one device.  ``create_server(device="cuda")`` builds the
kernel library before it binds its socket, so no request waits for
``nvcc`` (the counterpart of the JAX server's warm compile caches), and
raises where there is no CUDA device: it never serves on the CPU in its
place.  ``device="cpu"`` runs every kernel's plain version, as the tests
do.  Requests run on the threads of a ``ThreadingHTTPServer``;
``kernels/build.py::library``, ``engine/fast.py::_as_hermite`` and
``models.get`` are safe across them.

A bad payload is refused by this module's validation, or the port's own, as
``ValueError`` (or one of the other exceptions of JAX's tuple, serve.py:816)
and answered 400.  Nothing else is caught: a CUDA error, a failed build or
an out-of-memory error is never a 400, and no request falls back to the
CPU or to a plain version.

Differences from JAX:

* Engine names are the port's (``"grid"``, ``"fused-strat"``,
  ``"golden-strat"``; ``engine/fast.py``).  ``/v1/trace`` on the analytic
  fisheye with op1, where every ray starts at (1, 0) heading pi/2 (the
  headline workload, bench.py:641-657), runs the headline kernel
  ``fisheye_op1`` (``kernels/fisheye.py``, engine ``"fisheye"``); JAX's
  server runs it through its fused kernel.  The rays stay on the unit
  circle, inside the box; ``active`` is the final position's containment.
* Float64 tables for the eigenray endpoints are built with
  ``dtype=torch.float64`` (JAX: under ``jax.enable_x64``, :420, :677);
  ``on_device`` solves run ``find_eigenrays(dtype=float32, tol=2e-6)`` on
  the server's device (the port has no ``on_host``: engine/eigenray.py).
* The 3-D launch cone's count is checked against ``MAX_RAYS3`` before the
  cone is built, as ``_launch_fan`` checks its own (JAX builds first).
* Not ported, TPU-only: ``tight_block_rays`` (:59, :281, :336; a thread is
  one ray here) and ``enable_persistent_cache`` (:831, :837; there is no
  compile cache to keep: the kernel library is built once, at start).
"""
from __future__ import annotations

import dataclasses
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace as Inputs
from typing import Callable, NamedTuple

import numpy as np
import torch

import raytracing_tpu_torch as rtt
from raytracing_tpu_torch import config, models
from raytracing_tpu_torch.calibrated import calibrated_with_fallback
from raytracing_tpu_torch.engine import oracles
from raytracing_tpu_torch.engine.fast import FastResult, fast_trace
from raytracing_tpu_torch.kernels.fisheye import fisheye_trace_final
from raytracing_tpu_torch.ops.registry import (EXTENSION_OPS, GOLDEN_OPS,
                                               OP_NAMES, canonical)

# Serving-side resource bounds (serve.py:64-72): every derived step count is
# capped, not just ``rays``.
MAX_RAYS = 16_777_216
MAX_STEPS = 2_000_000
MAX_TURNS = 1_000
MAX_SAMPLE_VALUES = 4_000_000   # host spline fit + device table bound
MAX_RETURNED_RAYS = 65_536      # cap on positions echoed back in JSON

#: the rays per request of /v1/calibrate_samples (serve.py:255)
MAX_CALIBRATE_RAYS = 65_536


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class Endpoint(NamedTuple):
    """One POST endpoint in three steps: ``inputs(body, device)``
    validates a body (raising ValueError) into an :class:`Inputs`;
    ``call(inp, device)`` runs the work, host copies included (the timed
    part); ``response(inp, out, seconds)`` is the JSON answer."""

    inputs: Callable
    call: Callable
    response: Callable

    def answer(self, body: dict, device) -> dict:
        inp = self.inputs(body, device)
        t0 = time.perf_counter()
        out = self.call(inp, device)
        return self.response(inp, out, time.perf_counter() - t0)


# ------------------------------------------------------------- /v1/trace

def _headline(inp) -> bool:
    """True for the headline workload: op1 on the analytic fisheye (every
    ray of ``/v1/trace``'s fisheye launch starts at (1, 0) heading pi/2),
    which runs on ``fisheye_op1``."""
    return (inp.scen.is_fisheye and inp.op == "op1"
            and inp.medium_kind == "analytic" and inp.precision == "standard")


def _trace_headline(inp, device):
    """``fisheye_op1`` for ``inp.steps`` steps: a FastResult with ``active``
    the final position's containment in the scenario's box."""
    pos, tt = fisheye_trace_final(inp.pos0, inp.theta0, inp.delta_s,
                                  steps=int(inp.steps), device=device)
    b = inp.scen.box
    active = ((pos[:, 0] >= b[0]) & (pos[:, 0] <= b[1])
              & (pos[:, 1] >= b[2]) & (pos[:, 1] <= b[3]))
    return FastResult(pos=pos, traveltime=tt, dist_sim=None, active=active,
                      engine="fisheye")


def trace_inputs(body: dict, device):
    """The validated inputs of a ``/v1/trace`` body (serve.py:76-135)."""
    scen = config.scenario(str(body.get("scenario", "fisheye")))
    op = canonical(str(body.get("op", "op6")))
    rays = int(body.get("rays", 1024))
    if not 1 <= rays <= MAX_RAYS:
        raise ValueError(f"rays must be in [1, {MAX_RAYS}], got {rays}")
    n_turns = int(body.get("n_turns", 1))
    if not 1 <= n_turns <= MAX_TURNS:
        raise ValueError(f"n_turns must be in [1, {MAX_TURNS}], got {n_turns}")

    if "delta_s" in body:
        delta_s = float(body["delta_s"])
        if not (np.isfinite(delta_s) and delta_s > 0):
            raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
        divisor = (int(body.get("divisor", round(2 * np.pi / delta_s)))
                   if scen.is_fisheye else None)
        if divisor is not None and not 1 <= divisor <= MAX_STEPS:
            raise ValueError(f"divisor must be in [1, {MAX_STEPS}], got {divisor}")
    else:
        delta_s, divisor = calibrated_with_fallback(op, scen.name)

    if scen.is_fisheye:
        theta0 = np.full(rays, np.pi / 2.0, np.float32)
        pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (rays, 1))
        steps = scen.max_size(delta_s, int(divisor) + 1, n_turns) - 1
    else:
        theta0 = np.linspace(scen.theta0[0], scen.theta0[-1],
                             rays).astype(np.float32)
        pos0 = np.tile(scen.pos0[:1].astype(np.float32), (rays, 1))
        steps = scen.max_size(delta_s) - 1
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(
            f"configuration implies {steps} integration steps "
            f"(bounds: [1, {MAX_STEPS}]); raise delta_s or lower n_turns")

    medium_kind = str(body.get("medium", "analytic"))
    if medium_kind not in models.MEDIUM_KINDS:
        raise ValueError(f"medium must be 'analytic', 'stratified', 'grid', "
                         f"'c1' or 'c1-stratified', got {medium_kind!r}")
    if medium_kind.endswith("stratified") and scen.is_fisheye:
        fix = "grid" if medium_kind == "stratified" else "c1"
        raise ValueError(f"{medium_kind} medium needs an x-independent "
                         f"field; fisheye samples in 2-D — use medium={fix}")
    # the sampled media: models caches their tables per scenario and device
    medium = (rtt.analytic_medium(scen.field) if medium_kind == "analytic"
              else models.get(scen.name, medium=medium_kind,
                              device=device).medium)
    precision = str(body.get("precision", "standard"))
    return Inputs(scen=scen, op=op, rays=rays, steps=steps, delta_s=delta_s,
                  medium_kind=medium_kind, medium=medium, precision=precision,
                  pos0=pos0, theta0=theta0)


def trace_call(inp, device):
    """``(FastResult, host positions)``: ``fisheye_op1`` for the headline
    workload (module docstring), else ``fast_trace``."""
    if _headline(inp):
        out = _trace_headline(inp, device)
    else:
        out = fast_trace(inp.op, inp.scen, inp.medium, delta_s=inp.delta_s,
                         steps=inp.steps, pos0=inp.pos0, theta0=inp.theta0,
                         precision=inp.precision, device=device)
    return out, _np(out.pos)


def trace_response(inp, out, dt) -> dict:
    """serve.py:142-154: final-state metrics and throughput."""
    res, pos = out
    resp = {
        "scenario": inp.scen.name, "op": inp.op, "rays": inp.rays,
        "steps": int(inp.steps), "medium": inp.medium_kind,
        "delta_s": float(inp.delta_s), "engine": res.engine,
        "seconds": round(dt, 4),
        "ray_steps_per_sec": round(inp.rays * inp.steps / dt, 1),
        "escaped_rays": int(inp.rays - int(res.active.sum())),
        "mean_final_pos": [float(v) for v in pos.mean(0)],
    }
    if inp.scen.is_fisheye:
        resp["closure_error_pct"] = float(
            100 * np.linalg.norm(pos[0] - [1, 0]) / (2 * np.pi))
    return resp


# ------------------------------------------------------ the samples bodies

def _finite(name: str, a: np.ndarray) -> np.ndarray:
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{name} must be finite")
    return a


_NEEDS_SAMPLES = ("this endpoint needs 'samples' (1-D profile or 2-D grid "
                  "of refractive-index values)")


def _samples(body: dict, missing: str = _NEEDS_SAMPLES):
    """``(samples, y)`` of a posted measured medium, finite and within
    ``MAX_SAMPLE_VALUES`` (serve.py:173-180); ``missing`` is the error
    without samples."""
    if "samples" not in body:
        raise ValueError(missing)
    samples = _finite("samples", np.asarray(body["samples"], np.float64))
    if not 0 < samples.size <= MAX_SAMPLE_VALUES:
        raise ValueError(f"samples size must be in [1, {MAX_SAMPLE_VALUES}],"
                         f" got {samples.size}")
    y = _finite("y", np.asarray(body.get("y", ()), np.float64))
    return samples, y


def _samples_medium(body: dict, device):
    """(medium, default_box, family, kind) from a posted samples body, its
    tables on ``device`` at float32 (media/samples.py)."""
    family = str(body.get("family", "parity"))
    samples, y = _samples(body)
    x = (_finite("x", np.asarray(body["x"], np.float64))
         if "x" in body else None)
    medium, default_box, kind = rtt.medium_from_samples(
        samples, x, y, family=family, device=device)
    return medium, default_box, family, kind


def _launch_fan(body: dict, max_rays: int = MAX_RAYS):
    """(pos0, theta0, rays) from explicit arrays or a compact fan spec.

    ``max_rays`` is the endpoint's cap, enforced before the fan arrays are
    built, so a hostile count never allocates.
    """
    if "pos0" in body:
        pos0 = _finite("pos0", np.asarray(body["pos0"], np.float32))
        theta0 = _finite("theta0",
                         np.asarray(body.get("theta0", ()), np.float32))
        if pos0.ndim != 2 or pos0.shape[1] != 2 or len(theta0) != len(pos0):
            raise ValueError("pos0 must be (rays, 2) with theta0 (rays,), "
                             f"got {pos0.shape} / {theta0.shape}")
        rays = len(pos0)
        if not 1 <= rays <= max_rays:
            raise ValueError(f"rays must be in [1, {max_rays}], got {rays}")
    else:
        fan = body.get("launch")
        if not isinstance(fan, dict):
            raise ValueError("this endpoint needs 'pos0'/'theta0' arrays or "
                             "a 'launch' fan {'x':…, 'y':[lo,hi], 'theta':…}")
        rays = int(body.get("rays", 1024))
        if not 1 <= rays <= max_rays:
            raise ValueError(f"rays must be in [1, {max_rays}], got {rays}")
        fx = float(fan["x"])
        fy = np.asarray(fan["y"], np.float64).reshape(-1)
        th = np.asarray(fan.get("theta", 0.0), np.float64).reshape(-1)
        if len(fy) == 0 or len(th) == 0:
            raise ValueError("launch 'y' and 'theta' must be non-empty")
        _finite("launch", np.concatenate([[fx], fy, th]))
        pos0 = np.stack([np.full(rays, fx, np.float32),
                         np.linspace(fy[0], fy[-1], rays,
                                     dtype=np.float32)], -1)
        theta0 = (np.full(rays, th[0], np.float32) if len(th) == 1
                  else np.linspace(th[0], th[-1], rays, dtype=np.float32))
    return pos0, theta0, rays


def _samples_scenario(body: dict, default_box):
    box = tuple(float(v) for v in body.get("box", default_box))
    if len(box) != 4 or not np.all(np.isfinite(box)):
        raise ValueError(f"box must be 4 finite floats, got {box!r}")
    if not (box[0] < box[1] and box[2] < box[3]):
        raise ValueError(f"box must be ordered (x0 < x1, y0 < y1), "
                         f"got {box!r}")
    gamma = float(body.get("gamma", 1.0))
    if not np.isfinite(gamma):
        raise ValueError("gamma must be finite")
    return dataclasses.replace(config.scenario("fisheye"), name="samples",
                               gamma=gamma, box=box)


# ------------------------------------------------- /v1/calibrate_samples

def calibrate_inputs(body: dict, device):
    """The validated inputs of a ``/v1/calibrate_samples`` body
    (serve.py:254-275)."""
    medium, default_box, family, kind = _samples_medium(body, device)
    pos0, theta0, rays = _launch_fan(body, max_rays=MAX_CALIBRATE_RAYS)
    scen = _samples_scenario(body, default_box)
    op = canonical(str(body.get("op", "op6")))
    arc = float(body.get("arc_length", 0.0))
    tol = float(body.get("tol", 1e-4))
    if not (np.isfinite(tol) and tol > 0):
        raise ValueError(f"tol must be finite and > 0, got {tol}")
    cands = body.get("candidates")
    if cands is not None:
        cands = _finite("candidates", np.asarray(cands, np.float64))
        if not 1 <= len(cands) <= 16:
            raise ValueError("candidates caps at 16 entries")
        if np.any(cands <= 0):
            raise ValueError("candidates must be positive step sizes")
    if not (np.isfinite(arc) and 0 < arc):
        raise ValueError(f"calibrate needs 'arc_length' > 0, got {arc}")
    finest = float(cands.min()) if cands is not None else arc / 6400.0
    if arc / finest * 2 > MAX_STEPS:
        raise ValueError(f"finest candidate implies "
                         f"{int(arc / finest * 2)} halving steps "
                         f"(bound {MAX_STEPS})")
    return Inputs(medium=medium, family=family, kind=kind, pos0=pos0,
                  theta0=theta0, rays=rays, scen=scen, op=op, arc=arc,
                  tol=tol, cands=cands)


def calibrate_call(inp, device):
    """Richardson self-convergence
    (``parallel/sweep.py::delta_s_search_convergence``): the coarsest
    candidate step whose halving moves no final position beyond ``tol``
    over ``arc_length``; candidates default to arc_length / {50, ...,
    6400}."""
    from raytracing_tpu_torch.parallel.sweep import delta_s_search_convergence

    return delta_s_search_convergence(
        inp.op, inp.medium, pos0=inp.pos0, theta0=inp.theta0,
        arc_length=inp.arc, box=inp.scen.box, gamma=inp.scen.gamma,
        candidates=inp.cands, tol=inp.tol, device=device)


def calibrate_response(inp, sr, dt) -> dict:
    """serve.py:283-293."""
    errs = sr.metrics["halving_err"]
    return {
        "op": inp.op, "family": inp.family, "medium_kind": inp.kind,
        "rays": inp.rays, "arc_length": inp.arc, "tol": inp.tol,
        "delta_s": sr.delta_s_selected,
        "steps": int(sr.divisor) if sr.divisor is not None else None,
        "accepted": sr.index is not None,
        "candidates": [float(v) for v in sr.delta_s],
        "halving_err": [None if np.isnan(e) else float(e) for e in errs],
        "seconds": round(dt, 4),
    }


# ----------------------------------------------------- /v1/trace_samples

def trace_samples_inputs(body: dict, device):
    """The validated inputs of a ``/v1/trace_samples`` body
    (serve.py:308-331)."""
    medium, default_box, family, kind = _samples_medium(body, device)
    if "delta_s" not in body:
        raise ValueError("trace_samples needs 'delta_s' (no calibrated "
                         "table exists for user media; run the DELTA_S "
                         "search offline)")
    delta_s = float(body["delta_s"])
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"steps must be in [1, {MAX_STEPS}], got {steps}")

    pos0, theta0, rays = _launch_fan(body)
    scen = _samples_scenario(body, default_box)
    op = canonical(str(body.get("op", "op6")))
    return_positions = bool(body.get("return_positions", False))
    if return_positions and rays > MAX_RETURNED_RAYS:
        raise ValueError(f"return_positions caps at {MAX_RETURNED_RAYS} "
                         f"rays, got {rays}")
    report_cv = bool(body.get("report_conservation", False))
    if report_cv and kind != "profile":
        raise ValueError("report_conservation needs a 1-D profile medium "
                         "(p_x is only an invariant in stratified media)")
    return Inputs(medium=medium, family=family, kind=kind, delta_s=delta_s,
                  steps=steps, pos0=pos0, theta0=theta0, rays=rays, scen=scen,
                  op=op, return_positions=return_positions,
                  report_cv=report_cv)


def trace_samples_call(inp, device):
    """``(FastResult, host positions)`` of the posted medium's trace."""
    out = fast_trace(inp.op, inp.scen, inp.medium, delta_s=inp.delta_s,
                     steps=inp.steps, pos0=inp.pos0, theta0=inp.theta0,
                     stats=inp.report_cv, device=device)
    return out, _np(out.pos)


def trace_samples_response(inp, out, dt) -> dict:
    """serve.py:340-363."""
    res, pos = out
    resp = {
        "op": inp.op, "rays": inp.rays, "steps": inp.steps,
        "family": inp.family, "medium_kind": inp.kind,
        "delta_s": inp.delta_s, "engine": res.engine,
        "seconds": round(dt, 4),
        "ray_steps_per_sec": round(inp.rays * inp.steps / dt, 1),
        "escaped_rays": int(inp.rays - int(res.active.sum())),
        "mean_final_pos": [float(v) for v in pos.mean(0)],
    }
    if inp.report_cv:
        cv = oracles.momentum_cv_pct_from_welford(
            res.mom_count, res.mom_mean, res.mom_m2)
        cv_mean, cv_max, n_excluded = oracles.momentum_cv_summary(cv)
        # rays with p_x ~ 0 (theta at +-pi/2) have no relative spread; they
        # are excluded rather than emitting non-JSON Infinity/NaN tokens
        resp["momentum_cv_pct_mean"] = (None if np.isnan(cv_mean)
                                        else cv_mean)
        resp["momentum_cv_pct_max"] = None if np.isnan(cv_max) else cv_max
        if n_excluded:
            resp["momentum_cv_rays_excluded"] = n_excluded
    if inp.return_positions:
        resp["pos"] = pos.astype(float).tolist()
        resp["active"] = _np(res.active).astype(bool).tolist()
    return resp


# --------------------------------------------------------- /v1/eigenrays

# fan_count * steps bound: a per-request compute budget (serve.py:366-373)
MAX_EIGEN_ELEMS = 64_000_000
MAX_RECEIVERS = 128
MAX_FAN = 1024


def _box6(box) -> tuple:
    box = tuple(float(v) for v in box)
    if len(box) != 6 or not np.all(np.isfinite(box)):
        raise ValueError(f"box must be 6 finite floats, got {box!r}")
    return box


def _omega(body: dict):
    omega = body.get("omega")
    if omega is not None and not (np.isfinite(float(omega))
                                  and float(omega) > 0):
        raise ValueError(f"omega must be finite and > 0, got {omega}")
    return omega


def _receivers(body: dict, dim: int) -> np.ndarray:
    receivers = _finite("receivers",
                        np.atleast_2d(np.asarray(body.get("receivers", ()),
                                                 np.float64)))
    if receivers.ndim != 2 or receivers.shape[1] != dim or \
            not 1 <= len(receivers) <= MAX_RECEIVERS:
        raise ValueError(f"receivers must be (k, {dim}) with k in "
                         f"[1, {MAX_RECEIVERS}], got {receivers.shape}")
    return receivers


def _tl(eig, omega, k: int, resp: dict) -> dict:
    """Per-receiver incoherent (and, given ``omega``, coherent) TL; JSON
    has no Infinity: receivers with no arrivals report null."""
    from raytracing_tpu_torch.engine import eigenray as er

    itl = er.incoherent_tl(eig, n_receivers=k)
    resp["incoherent_tl_db"] = [None if not np.isfinite(v) else float(v)
                                for v in itl]
    if omega is not None:
        ctl = er.coherent_tl(eig, float(omega), n_receivers=k)
        resp["coherent_tl_db"] = [None if not np.isfinite(v) else float(v)
                                  for v in ctl]
    return resp


def eigenrays_inputs(body: dict, device):
    """The validated inputs of a ``/v1/eigenrays`` body (serve.py:390-467).
    Tables are built float64: the landing-curve noise floor of float32
    tables defeats the Newton polish."""
    family = str(body.get("family", "parity"))
    samples, y = _samples(body)
    x = (_finite("x", np.asarray(body["x"], np.float64))
         if "x" in body else None)
    # "on_device": a float32 solve with the split-word-evaluated profile
    # (engine/df_grid.DfEvalProfile), instead of the float64 tables
    on_device = bool(body.get("on_device", False))
    if on_device:
        if samples.ndim != 1 or x is not None:
            raise ValueError("on_device eigenrays run the split-word "
                             "PROFILE evaluator; post a 1-D 'samples' + "
                             "'y' (2-D grids stay on the float64 path)")
        medium = rtt.df_eval_profile_medium(samples, y, device=device)
        # profiles are x-independent: unbounded in x (medium_from_samples)
        default_box = (-1e30, 1e30, float(y[0]), float(y[-1]))
        kind = "df32-profile"
    else:
        medium, default_box, kind = rtt.medium_from_samples(
            samples, x, y, family=family, dtype=torch.float64, device=device)

    op = canonical(str(body.get("op", "op6")))
    if op in GOLDEN_OPS:
        raise ValueError(
            f"{op} uses a golden-section solver whose paraxial tangents "
            f"vanish (engine/dynamic.py caveat); use a smooth op "
            f"(op1-op4, op6-op8, op12) or the Newton extensions op10n/op11n")

    source = _finite("source", np.asarray(body.get("source", ()), np.float64))
    if source.shape != (2,):
        raise ValueError(f"source must be [x, y], got shape {source.shape}")
    receivers = _receivers(body, 2)

    delta_s = float(body.get("delta_s", 0.0))
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    fan_spec = body.get("fan", {})
    if not isinstance(fan_spec, dict):
        raise ValueError("fan must be {'theta': [lo, hi], 'count': n}")
    th = np.asarray(fan_spec.get("theta", (-0.3, 0.3)), np.float64).reshape(-1)
    _finite("fan theta", th)
    if len(th) != 2 or not th[0] < th[1]:
        raise ValueError(f"fan theta must be [lo, hi] with lo < hi, got {th}")
    n_fan = int(fan_spec.get("count", 256))
    if not 8 <= n_fan <= MAX_FAN:
        raise ValueError(f"fan count must be in [8, {MAX_FAN}], got {n_fan}")
    if not 1 <= steps * n_fan <= MAX_EIGEN_ELEMS:
        raise ValueError(
            f"steps * fan count must be in [1, {MAX_EIGEN_ELEMS}] "
            f"(per-request compute bound), got {steps * n_fan}")
    box = tuple(float(v) for v in body.get("box", default_box))
    if len(box) != 4 or not np.all(np.isfinite(box)) or \
            not (box[0] < box[1] and box[2] < box[3]):
        raise ValueError(f"box must be 4 finite ordered floats, got {box!r}")
    omega = _omega(body)
    return Inputs(family=family, kind=kind, medium=medium, op=op,
                  source=source, receivers=receivers, delta_s=delta_s,
                  steps=steps, th=th, n_fan=n_fan, box=box, omega=omega,
                  on_device=on_device)


def eigenrays_call(inp, device):
    """``find_eigenrays`` as serve.py:475-481 calls it: ``max_size = steps
    + 1`` ("steps" means integration steps everywhere in the API), and
    ``max_arrivals`` bounds the Newton stage."""
    from raytracing_tpu_torch.engine import eigenray as er

    kw = dict(dtype=torch.float32, tol=2e-6) if inp.on_device else {}
    return er.find_eigenrays(
        inp.op, inp.medium, source=inp.source, receivers=inp.receivers,
        delta_s=inp.delta_s, max_size=inp.steps + 1, box=inp.box,
        fan=(float(inp.th[0]), float(inp.th[1]), inp.n_fan),
        max_arrivals=max(16, MAX_EIGEN_ELEMS // max(inp.steps, 1) // 8),
        device=device, **kw)


def eigenrays_response(inp, eig, dt) -> dict:
    """serve.py:484-505: every arrival with travel time, amplitude, KMAH
    count and launch angle, and the per-receiver TL."""
    resp = {
        "op": inp.op, "family": inp.family, "medium_kind": inp.kind,
        "delta_s": inp.delta_s, "steps": inp.steps, "fan_count": inp.n_fan,
        "seconds": round(dt, 4),
        "arrivals": [
            {"receiver": int(r), "theta0": float(t), "traveltime": float(tt),
             "amplitude": float(a), "kmah": int(m), "angle": float(ang),
             "y_err": float(ye), "converged": bool(c)}
            for r, t, tt, a, m, ang, ye, c in zip(
                eig.receiver, eig.theta0, eig.traveltime, eig.amplitude,
                eig.kmah, eig.angle, eig.y_err, eig.converged)],
    }
    return _tl(eig, inp.omega, len(inp.receivers), resp)


# ------------------------------------------------------ /v1/trace3d_samples

MAX_RAYS3 = 1_048_576


def cone(p, ax, ha: float, rays: int):
    """``(pos0, dir0)`` of a launch cone (serve.py:595-604): ``rays``
    directions area-uniform within ``ha`` of the axis ``ax`` from ``p``.
    The transverse frame is the port's ``_transverse_frame`` at float32,
    as JAX computes it (x64 off)."""
    from raytracing_tpu_torch.engine.dynamic3d import _transverse_frame

    axn = ax / np.linalg.norm(ax)
    e1, e2 = (_np(v)[0] for v in _transverse_frame(
        torch.as_tensor(axn[None, :], dtype=torch.float32)))
    t = np.linspace(0.0, 2 * np.pi, rays, endpoint=False)
    tilt = ha * np.sqrt(np.linspace(0.0, 1.0, rays))  # area-uniform cone
    d = (axn[None, :] + tilt[:, None]
         * (np.cos(t)[:, None] * e1 + np.sin(t)[:, None] * e2))
    dir0 = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.tile(p.astype(np.float32), (rays, 1)), dir0


def trace3d_inputs(body: dict, device):
    """The validated inputs of a ``/v1/trace3d_samples`` body
    (serve.py:525-617)."""
    samples, y = _samples(body, "this endpoint needs 'samples' (a 1-D "
                                "profile or a 3-D (nz, ny, nx) grid of "
                                "refractive-index values) and its "
                                "coordinate axes")
    if samples.ndim == 1:
        family = str(body.get("family", "parity"))
        medium2d, default_box, kind = rtt.medium_from_samples(
            samples, None, y, family=family, device=device)
        medium = rtt.Stratified3D(medium2d)
    elif samples.ndim == 3:
        # a 3-D measured field: tri-Hermite tables (media/grid3.py), the
        # consistent-gradient family only
        family = str(body.get("family", "c1"))
        if family != "c1":
            raise ValueError("3-D sampled grids have only the 'c1' "
                             "(consistent-gradient tri-Hermite) family; "
                             f"got family={family!r}")
        x_ax = _finite("x", np.asarray(body.get("x", ()), np.float64))
        z_ax = _finite("z", np.asarray(body.get("z", ()), np.float64))
        medium = rtt.c1_medium3_from_samples(samples, x_ax, y, z_ax,
                                             device=device)
        default_box = (float(x_ax[0]), float(x_ax[-1]),
                       float(y[0]), float(y[-1]),
                       float(z_ax[0]), float(z_ax[-1]))
        kind = "grid3"
    else:
        raise ValueError("samples must be a 1-D profile (n = n(y)) or a "
                         "3-D (nz, ny, nx) grid; got 2-D samples — use "
                         "/v1/trace_samples for the planar grid pipeline")

    from raytracing_tpu_torch.engine.trace3d import canonical3

    method = canonical3(str(body.get("op", "op6")))
    delta_s = float(body.get("delta_s", 0.0))
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"steps must be in [1, {MAX_STEPS}], got {steps}")

    if "pos0" in body:
        pos0 = _finite("pos0", np.asarray(body["pos0"], np.float32))
        dir0 = _finite("dir0", np.asarray(body.get("dir0", ()), np.float32))
        if pos0.ndim != 2 or pos0.shape[1] != 3 or dir0.shape != pos0.shape:
            raise ValueError(f"pos0/dir0 must both be (rays, 3), got "
                             f"{pos0.shape} / {dir0.shape}")
        rays = len(pos0)
    else:
        spec = body.get("launch")
        if not isinstance(spec, dict):
            raise ValueError("this endpoint needs 'pos0'/'dir0' arrays or a "
                             "'launch' cone {'pos': [x,y,z], 'axis': "
                             "[ux,uy,uz], 'half_angle': a}")
        rays = int(body.get("rays", 1024))
        p = _finite("launch pos", np.asarray(spec.get("pos", ()), np.float64))
        ax = _finite("launch axis",
                     np.asarray(spec.get("axis", ()), np.float64))
        if p.shape != (3,) or ax.shape != (3,):
            raise ValueError("launch pos/axis must each be 3 floats")
        ha = float(spec.get("half_angle", 0.1))
        if not (np.isfinite(ha) and 0 <= ha < np.pi / 2):
            raise ValueError(f"half_angle must be in [0, pi/2), got {ha}")
    if not 1 <= rays <= MAX_RAYS3:
        raise ValueError(f"rays must be in [1, {MAX_RAYS3}], got {rays}")
    if "pos0" not in body:
        pos0, dir0 = cone(p, ax, ha, rays)

    box = body.get("box")
    if box is not None:
        box = _box6(box)
    elif kind == "grid3":
        box = default_box          # sampled region; queries clamp beyond it
    else:
        box = (-1e30, 1e30, default_box[2], default_box[3], -1e30, 1e30)
    report_cv = bool(body.get("report_conservation", False))
    return Inputs(method=method, medium=medium, family=family, kind=kind,
                  delta_s=delta_s, steps=steps, pos0=pos0, dir0=dir0,
                  rays=rays, box=box, report_cv=report_cv)


def trace3d_call(inp, device):
    """``(Trace3Result, host positions)``: the 3-D scan tier in metrics
    mode (serve.py:620)."""
    out = rtt.trace3d(inp.method, inp.medium, pos0=inp.pos0, dir0=inp.dir0,
                      delta_s=inp.delta_s, steps=inp.steps, box=inp.box,
                      mode="metrics", stats=inp.report_cv, device=device)
    return out, _np(out.final.pos)


def trace3d_response(inp, out, dt) -> dict:
    """serve.py:625-644, with the horizontal-slowness CV, the 3-D form of
    the reference's p_x oracle."""
    res, pos = out
    resp = {
        "op": inp.method, "rays": inp.rays, "steps": inp.steps,
        "family": inp.family,
        # lifted profiles report "profile-3d"; native 3-D grids are "grid3"
        "medium_kind": inp.kind if inp.kind == "grid3" else f"{inp.kind}-3d",
        "delta_s": inp.delta_s,
        "seconds": round(dt, 4),
        "ray_steps_per_sec": round(inp.rays * inp.steps / dt, 1),
        # the scan's `active` means "still integrating"; box escapes are
        # the rays whose exit_step stopped short of the step budget
        "escaped_rays": int((_np(res.exit_step) < inp.steps).sum()),
        "mean_final_pos": [float(v) for v in pos.mean(0)],
    }
    if inp.report_cv:
        cv = res.horizontal_slowness_cv_pct()
        finite = np.isfinite(cv)
        resp["slowness_cv_pct_max"] = (float(np.nanmax(cv))
                                       if finite.any() else None)
        resp["slowness_cv_rays_excluded"] = int((~finite.any(-1)).sum())
    return resp


# --------------------------------------------------------- /v1/eigenrays3

def eigenrays3_inputs(body: dict, device):
    """The validated inputs of a ``/v1/eigenrays3`` body (serve.py:664-737)."""
    from raytracing_tpu_torch.engine.trace3d import canonical3

    family = str(body.get("family", "parity"))
    if "samples" not in body:
        raise ValueError("this endpoint needs 'samples' (a 1-D profile of "
                         "refractive-index values) and its 'y' axis")
    samples = _finite("samples", np.asarray(body["samples"], np.float64))
    if samples.ndim != 1:
        raise ValueError("3-D eigenrays lift 1-D PROFILES (n = n(y)); got "
                         "2-D samples — use /v1/eigenrays for the planar "
                         "pipeline")
    if not 0 < samples.size <= MAX_SAMPLE_VALUES:
        raise ValueError(f"samples size must be in [1, {MAX_SAMPLE_VALUES}],"
                         f" got {samples.size}")
    y = _finite("y", np.asarray(body.get("y", ()), np.float64))
    # float64 tables: the eigenray landing-curve floor
    medium2d, default_box, kind = rtt.medium_from_samples(
        samples, None, y, family=family, dtype=torch.float64, device=device)
    medium = rtt.Stratified3D(medium2d)

    method = canonical3(str(body.get("op", "op6")))
    source = _finite("source", np.asarray(body.get("source", ()),
                                          np.float64))
    if source.shape != (3,):
        raise ValueError(f"source must be [x, y, z], got {source.shape}")
    receivers = _receivers(body, 3)
    delta_s = float(body.get("delta_s", 0.0))
    if not (np.isfinite(delta_s) and delta_s > 0):
        raise ValueError(f"delta_s must be finite and > 0, got {delta_s}")
    steps = int(body.get("steps", 0))
    fan_spec = body.get("fan", {})
    if not isinstance(fan_spec, dict):
        raise ValueError("fan must be {'alpha': [lo, hi], 'beta': "
                         "[lo, hi], 'count': [n_a, n_b]}")
    al = np.asarray(fan_spec.get("alpha", (-0.3, 0.3)),
                    np.float64).reshape(-1)
    be = np.asarray(fan_spec.get("beta", (-0.3, 0.3)),
                    np.float64).reshape(-1)
    _finite("fan alpha", al)
    _finite("fan beta", be)
    if len(al) != 2 or not al[0] < al[1] or len(be) != 2 or \
            not be[0] < be[1]:
        raise ValueError("fan alpha/beta must each be [lo, hi] with "
                         f"lo < hi, got {al} / {be}")
    cnt = np.asarray(fan_spec.get("count", (25, 25)), np.int64).reshape(-1)
    if len(cnt) != 2 or not np.all((4 <= cnt) & (cnt * cnt[::-1]
                                                 <= MAX_FAN * MAX_FAN)):
        raise ValueError(f"fan count must be [n_a, n_b] with n >= 4 and "
                         f"n_a*n_b <= {MAX_FAN * MAX_FAN}, got {cnt}")
    n_fan = int(cnt[0] * cnt[1])
    if not 1 <= steps * n_fan <= MAX_EIGEN_ELEMS:
        raise ValueError(
            f"steps * fan grid size must be in [1, {MAX_EIGEN_ELEMS}] "
            f"(per-request compute bound), got {steps * n_fan}")
    center = body.get("center_dir")
    if center is not None:
        center = _finite("center_dir", np.asarray(center, np.float64))
        if center.shape != (3,) or not np.linalg.norm(center) > 0:
            raise ValueError("center_dir must be a nonzero 3-vector")
    box = (_box6(body["box"]) if body.get("box") is not None
           else (-1e30, 1e30, default_box[2], default_box[3], -1e30, 1e30))
    omega = _omega(body)
    return Inputs(family=family, kind=kind, medium=medium, method=method,
                  source=source, receivers=receivers, delta_s=delta_s,
                  steps=steps, al=al, be=be, cnt=cnt, center=center, box=box,
                  omega=omega)


def eigenrays3_call(inp, device):
    """``find_eigenrays3`` as serve.py:740 calls it: a 2-D (alpha, beta)
    launch grid around ``center_dir`` (default: source -> mean
    receiver)."""
    al, be, cnt = inp.al, inp.be, inp.cnt
    return rtt.find_eigenrays3(
        inp.method, inp.medium, source=inp.source, receivers=inp.receivers,
        delta_s=inp.delta_s, max_size=inp.steps, box=inp.box,
        center_dir=inp.center,
        fan=(float(al[0]), float(al[1]), int(cnt[0]),
             float(be[0]), float(be[1]), int(cnt[1])), device=device)


def eigenrays3_response(inp, eig, dt) -> dict:
    """serve.py:746-767: travel time, |det Q| amplitude, KMAH count and
    residual miss per arrival, and the per-receiver TL of the 2-D
    endpoint."""
    resp = {
        "op": inp.method, "family": inp.family,
        "medium_kind": f"{inp.kind}-3d",
        "delta_s": inp.delta_s, "steps": inp.steps,
        "fan_count": [int(inp.cnt[0]), int(inp.cnt[1])],
        "seconds": round(dt, 4),
        "arrivals": [
            {"receiver": int(r), "dir0": [float(v) for v in d],
             "traveltime": float(tt), "amplitude": float(a),
             "kmah": int(m), "miss": float(ms), "converged": bool(c)}
            for r, d, tt, a, m, ms, c in zip(
                eig.receiver, eig.dir0, eig.traveltime, eig.amplitude,
                eig.kmah, eig.miss, eig.converged)],
    }
    return _tl(eig, inp.omega, len(inp.receivers), resp)


#: the POST endpoints (serve.py:800-805)
ROUTES = {
    "/v1/trace": Endpoint(trace_inputs, trace_call, trace_response),
    "/v1/trace_samples": Endpoint(trace_samples_inputs, trace_samples_call,
                                  trace_samples_response),
    "/v1/calibrate_samples": Endpoint(calibrate_inputs, calibrate_call,
                                      calibrate_response),
    "/v1/eigenrays": Endpoint(eigenrays_inputs, eigenrays_call,
                              eigenrays_response),
    "/v1/trace3d_samples": Endpoint(trace3d_inputs, trace3d_call,
                                    trace3d_response),
    "/v1/eigenrays3": Endpoint(eigenrays3_inputs, eigenrays3_call,
                               eigenrays3_response),
}


MEDIA = ["analytic", "stratified", "grid", "c1", "c1-stratified"]
ENDPOINTS = ["/healthz", "/v1/models", "/v1/trace", "/v1/trace_samples",
             "/v1/calibrate_samples", "/v1/eigenrays", "/v1/trace3d_samples",
             "/v1/eigenrays3"]


def models_listing() -> dict:
    """``/v1/models``'s answer: exactly the JAX server's lists
    (serve.py:785-796)."""
    return {"scenarios": list(config.SCENARIO_NAMES), "ops": list(OP_NAMES),
            "extensions": list(EXTENSION_OPS), "media": list(MEDIA),
            "sample_families": ["parity", "c1"], "endpoints": list(ENDPOINTS)}


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok",
                             "device": self.server.device_name,
                             "version": rtt.__version__})
        elif self.path == "/v1/models":
            self._send(200, models_listing())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        endpoint = ROUTES.get(self.path)
        if endpoint is None:
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            self._send(200, endpoint.answer(body, self.server.device))
        except (ValueError, KeyError, TypeError, OverflowError,
                ZeroDivisionError, IndexError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})

    def log_message(self, fmt, *args):  # quiet by default
        pass


class _Server(ThreadingHTTPServer):
    device: str = "cuda"
    device_name: str = "cuda"


def create_server(host: str = "127.0.0.1", port: int = 8080,
                  device="cuda") -> ThreadingHTTPServer:
    """A server answering on ``device``, not yet serving (call
    ``serve_forever``).  On CUDA the kernel library is built first; without
    a CUDA device ``device="cuda"`` raises RuntimeError."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("create_server(device='cuda') needs a CUDA "
                               "device and this machine has none; pass "
                               "device='cpu' to serve the plain versions")
        from raytracing_tpu_torch.kernels import build

        build.library()
        name = f"{dev} ({torch.cuda.get_device_name(dev)})"
    elif dev.type == "cpu":
        name = "cpu"
    else:
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    srv = _Server((host, port), _Handler)
    srv.device = str(dev)
    srv.device_name = name
    return srv


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="raytracing_tpu_torch serving "
                                            "endpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the kernels) or cpu (the plain "
                        "versions)")
    args = p.parse_args(argv)
    srv = create_server(args.host, args.port, device=args.device)
    print(f"serving on http://{args.host}:{args.port} "
          f"(device: {srv.device_name})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
