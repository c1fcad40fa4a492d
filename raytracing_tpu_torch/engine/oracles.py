"""Physics oracles: the reference's built-in validation metrics as functions.

Port of ``raytracing_tpu/engine/oracles.py``: ``closure_error_pct``
(oracles.py:19), ``snell_errors_deg`` (:34), ``snell_expected_deg`` (:67),
``snell_errors_from_tangent`` (:77), ``format_num`` (:93), ``snell_report``
(:101), ``momentum_cv_pct_from_history`` (:128),
``momentum_cv_pct_from_welford`` (:147), ``momentum_cv_summary`` (:168),
``momentum_cv_pct_from_stats`` (:184), ``scenario_average_cv_pct`` (:193)
and ``fisheye_rms_error`` (:202).

They cover Snell-law outbound angles for the interface (RT_bench.py:896-919),
fisheye closure (RT_bench.py:956, 1393), conservation of p_x for the
stratified scenarios (RT_bench.py:957-958, 1352-1360), and the RMS error
against the analytic fisheye circle.  Functions on a :class:`TraceResult`
return tensors on its device; the numpy helpers accept tensors or arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from raytracing_tpu_torch.engine.trace import TraceResult


def _np(a, dtype=None):
    """A host numpy array from a tensor or array-like."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def closure_error_pct(result: TraceResult, row: int | None = None):
    """Fisheye closure error, percent of the unit-circle circumference.

    100 * |(1, 0) - final_pos| / (2 pi)  (RT_bench.py:956, 1393); pass
    ``row`` to read a history row instead of the final state.
    """
    if result.history is not None and row is not None:
        pos = result.history[row, :, 0:2]
    else:
        pos = result.final.pos
    target = torch.tensor([1.0, 0.0], dtype=pos.dtype, device=pos.device)
    return 100.0 * torch.linalg.vector_norm(pos - target, dim=-1) / (2.0 * math.pi)


def snell_errors_deg(result: TraceResult, theta0):
    """Interface outbound-angle errors in degrees, one per ray.

    Port of RT_bench.py:896-919: the expected angle from total internal
    reflection (launch < pi/4) or Snell refraction (launch > pi/4); the
    simulated angle from the slope over the 90-95 % tail of each ray's
    history.  Requires history mode.
    """
    if result.history is None:
        raise ValueError("snell oracle needs history mode")
    hist = result.history
    theta0 = torch.as_tensor(_np(theta0), dtype=hist.dtype, device=hist.device)
    deg = 180.0 / math.pi

    refl = 90.0 - deg * theta0
    refr = deg * torch.arcsin(math.sqrt(2.0) * torch.sin(math.pi / 2.0 - theta0))
    angreal = torch.where(theta0 < math.pi / 4.0, refl,
                          torch.where(theta0 == math.pi / 4.0,
                                      torch.zeros_like(refr), refr))

    # Integer index arithmetic reproduces int(9.5*i/10) / int(9*i/10).
    i = result.exit_step.long()
    idx95 = (19 * i) // 20
    idx90 = (9 * i) // 10
    x = hist[:, :, 0]   # (max_size, R)
    y = hist[:, :, 1]
    ray_idx = torch.arange(x.shape[1], device=hist.device)
    distx = x[idx95, ray_idx] - x[idx90, ray_idx]
    disty = y[idx95, ray_idx] - y[idx90, ray_idx]
    angsim = deg * torch.arctan(torch.abs(distx / disty))
    return torch.abs(angsim - angreal)


def snell_expected_deg(theta0):
    """Expected outbound angle (deg) per launch angle (RT_bench.py:902-908)."""
    theta0 = _np(theta0)
    deg = 180.0 / np.pi
    with np.errstate(invalid="ignore"):  # arcsin>1 on the reflection branch
        refr = deg * np.arcsin(np.sqrt(2.0) * np.sin(np.pi / 2.0 - theta0))
    return np.where(theta0 < np.pi / 4.0, 90.0 - deg * theta0,
                    np.where(theta0 == np.pi / 4.0, 0.0, refr))


def snell_errors_from_tangent(tangent, theta0):
    """Interface Snell errors (deg) from final unit tangents.

    Kernel-tier variant of :func:`snell_errors_deg`: past the interface the
    ray is straight, so the frozen exit tangent equals the history-tail
    secant to f32 rounding (docs/PARITY.md #23).  ``tangent`` is (R, 2);
    uses the first ``len(theta0)`` rays.
    """
    theta0 = _np(theta0)
    nf = len(theta0)
    t = _np(tangent)[:nf]
    deg = 180.0 / np.pi
    angsim = deg * np.arctan(np.abs(t[:, 0] / t[:, 1]))
    return np.abs(angsim - snell_expected_deg(theta0))


def format_num(num: float) -> str:
    """Column-aligned number formatting of the per-ray Snell table
    (RT_bench.py:929-943)."""
    if num < 0:
        return f"{num: >10.8f}" if abs(num) < 10 else f"{num: >10.7f}"
    return f"{num: >10.9f}" if num < 10 else f"{num: >10.8f}"


def snell_report(result: TraceResult, theta0, printer=print):
    """Per-ray Snell table, the reference's ``show=True`` output
    (RT_bench.py:921-945)."""
    errs = _np(snell_errors_deg(result, theta0))
    theta0 = _np(theta0)
    angreal = snell_expected_deg(theta0)
    deg = 180.0 / np.pi
    hist = _np(result.history)
    exit_step = _np(result.exit_step)
    for k in range(len(theta0)):
        i = int(exit_step[k])
        a, b = hist[i, k, 0], hist[i, k, 1]
        i95, i90 = (19 * i) // 20, (9 * i) // 10
        distx = hist[i95, k, 0] - hist[i90, k, 0]
        disty = hist[i95, k, 1] - hist[i90, k, 1]
        c = deg * np.arctan(np.abs(distx / disty))
        printer(f"Coords: [ {format_num(a)} , {format_num(b)} ] | "
                f"SimAng: {format_num(c)} | SnellAng: {format_num(angreal[k])} | "
                f"Err: {format_num(errs[k])} | InitAng: {format_num(theta0[k] * deg)}")
    return errs


def momentum_cv_pct_from_history(result: TraceResult):
    """Per-ray coefficient of variation (%) of p_x over written history rows.

    Port of RT_bench.py:1356-1359 with the row mask ``row <= exit_step``
    explicit.  Population std (ddof=0), matching np.std defaults.
    """
    if result.history is None:
        raise ValueError("momentum CV from history needs history mode")
    mx = result.history[:, :, 2]                     # (max_size, R)
    rows = torch.arange(mx.shape[0], device=mx.device)[:, None]
    mask = rows <= result.exit_step[None, :].long()
    cnt = torch.sum(mask, dim=0).to(mx.dtype)
    zero = torch.zeros_like(mx)
    mean = torch.sum(torch.where(mask, mx, zero), dim=0) / cnt
    var = torch.sum(torch.where(mask, (mx - mean[None, :]) ** 2, zero),
                    dim=0) / cnt
    return 100.0 * torch.sqrt(var) / mean


def momentum_cv_pct_from_welford(count, mean, m2):
    """Per-ray CV (%) from raw Welford aggregates (count, mean, M2).

    The one home for the conservation metric (RT_bench.py:1356-1359,
    population std) on a kernel's momentum tracker.  The mean enters as
    ``|mean|``; a ray whose invariant is ~0 gets inf/nan, which
    :func:`momentum_cv_summary` excludes.  Returns a NumPy array.
    """
    count = _np(count, np.float64)
    mean = _np(mean, np.float64)
    m2 = _np(m2, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 100.0 * np.sqrt(m2 / count) / np.abs(mean)


def momentum_cv_summary(cv):
    """``(mean, max, n_excluded)`` over the finite entries of a CV array."""
    cv = _np(cv, np.float64).reshape(-1)
    finite = cv[np.isfinite(cv)]
    n_excluded = int(cv.size - finite.size)
    if finite.size == 0:
        return float("nan"), float("nan"), n_excluded
    return float(finite.mean()), float(finite.max()), n_excluded


def momentum_cv_pct_from_stats(result: TraceResult):
    """Per-ray CV (%) from the carry's Welford tracker (metrics mode)."""
    st = result.final
    if st.mom_count is None:
        raise ValueError("trace ran without momentum statistics")
    var = st.mom_m2 / st.mom_count
    return 100.0 * torch.sqrt(var) / st.mom_mean


def scenario_average_cv_pct(per_ray_cv):
    """Scenario-level CV: mean over interior rays (RT_bench.py:1356-1360)."""
    return per_ray_cv[1:-1].mean()


def fisheye_rms_error(result: TraceResult, delta_s):
    """RMS distance between the traced ray and the analytic unit circle.

    The fisheye ray from (1, 0) at pi/2 follows pos(s) = (cos s, sin s);
    the BASELINE.json accuracy target is RMS <= 1e-6.  Float64 reference.
    """
    if result.history is None:
        raise ValueError("fisheye RMS needs history mode")
    xy = _np(result.history[:, :, 0:2], np.float64)  # (S, R, 2)
    s = np.arange(xy.shape[0], dtype=np.float64) * float(delta_s)
    ref = np.stack([np.cos(s), np.sin(s)], axis=-1)[:, None, :]
    err = np.linalg.norm(xy - ref, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))
