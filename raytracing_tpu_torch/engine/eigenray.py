"""Eigenray finding: boundary-value ray solutions source -> receiver.

Port of ``raytracing_tpu/engine/eigenray.py``: ``Eigenrays`` (eigenray.py:67),
``_crossing_vals`` (:88), ``_crossing_depths`` (:119), ``_pick_crossings``
(:124), ``find_eigenrays`` (:202, with ``_find_eigenrays`` :262),
``pressure`` (:454), ``coherent_tl`` (:467) and ``incoherent_tl`` (:473).

1. One dynamic fan trace from the source records every range-line
   crossing as it goes (:func:`engine.dynamic.trace_crossings_fan`), so
   the host reads (fan, ranges, ordinal) depths, not histories;
2. a host bracket scan over those depths: a sign transition of
   ``y(xr) - yr`` between adjacent fan rays (same crossing ordinal)
   brackets one eigenray;
3. a safeguarded Newton on the launch angle, batched over every bracket of
   every receiver in one dynamic trace an iteration
   (:func:`engine.dynamic.trace_crossings_pick`), with the exact slope
   dy/dtheta0 = q / cos(angle), the best iterate returned and duplicate
   roots merged.

The traces run on ``device`` (the card by default) at ``dtype`` (float64 by
default: the landing curve needs it, and the card has native float64);
the bracket scan, the Newton bookkeeping and the merge are host numpy.
The JAX package's host/accelerator routing (``on_host``,
``RT_EIGENRAY_ON_HOST``, ``EIGENRAY_TPU_MIN_RECEIVERS``) existed for a
remote TPU without float64 and is not ported.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.engine.dynamic import (
    CROSS_COLS, DYN_COLS, spreading_amplitude, trace_crossings_fan,
    trace_crossings_pick)
from raytracing_tpu_torch.engine.trace import _torch_dtype
from raytracing_tpu_torch.parallel.mesh import run_over_rays

# history-row columns (DYN_COLS) of the host-side crossing scans
_X = DYN_COLS.index("x")
_Y = DYN_COLS.index("y")
_KMAH = DYN_COLS.index("kmah")

# crossing-record columns (CROSS_COLS): what a Newton iteration reads back
_CY = CROSS_COLS.index("y")
_CTT = CROSS_COLS.index("traveltime")
_CANG = CROSS_COLS.index("angle")
_CQ = CROSS_COLS.index("q")
_CKMAH = CROSS_COLS.index("kmah")
_CN = CROSS_COLS.index("n")


class Eigenrays(NamedTuple):
    """All arrivals found, flat over (receiver, path); sorted by receiver
    then travel time.  numpy arrays."""

    receiver: Any     # (E,) int32 index into the receivers argument
    theta0: Any       # (E,) launch angle of the arrival
    traveltime: Any   # (E,) optical path / travel time at the receiver
    y_err: Any        # (E,) residual depth miss at the receiver range
    q: Any            # (E,) transverse spreading at the receiver
    kmah: Any         # (E,) int32 caustic count along the path
    angle: Any        # (E,) ray angle at the receiver
    n: Any            # (E,) index at the receiver
    n0: Any           # (E,) index at the source
    amplitude: Any    # (E,) point-source pressure amplitude
    converged: Any    # (E,) bool: |y_err| under the requested tolerance

    def for_receiver(self, i: int) -> "Eigenrays":
        m = self.receiver == i
        return Eigenrays(*[np.asarray(f)[m] for f in self])


def _crossing_vals(hist: np.ndarray, last: np.ndarray, xr: float,
                   cols, x_col: int = _X):
    """Values at every crossing of ``x == xr``, all rays at once: ``hist``
    is the fan's (S, R, C) history, ``last`` its (R,) frozen-row indices,
    ``cols`` the columns to interpolate.  Returns an (R, M, len(cols))
    nan-padded array ordered along each ray (M = max crossings, >= 1)."""
    cols = list(cols)
    x = hist[:, :, x_col]                                   # (S, R)
    d = x - xr
    n_steps, n_rays = x.shape
    step_ok = np.arange(n_steps - 1)[:, None] < last[None, :]
    hit = step_ok & ((d[:-1] < 0) != (d[1:] < 0))          # (S-1, R)
    counts = hit.sum(0)
    m = max(int(counts.max()) if n_rays else 0, 1)
    out = np.full((n_rays, m, len(cols)), np.nan)
    ray, step = np.nonzero(hit.T)           # row-major: by ray, then step
    if ray.size:
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ordinal = np.arange(ray.size) - np.repeat(starts, counts)
        frac = (d[step, ray] / (x[step, ray] - x[step + 1, ray]))[:, None]
        v0 = hist[step, ray][:, cols]
        out[ray, ordinal] = v0 + frac * (hist[step + 1, ray][:, cols] - v0)
    return out


def _crossing_depths(hist: np.ndarray, last: np.ndarray, xr: float):
    """(R, M) nan-padded crossing depths: the 2-D fan scan's view."""
    return _crossing_vals(hist, last, xr, (_Y,))[..., 0]


def _pick_crossings(h: np.ndarray, last: np.ndarray, xr: np.ndarray,
                    ordk: np.ndarray, x_col: int = _X,
                    kmah_col: int = _KMAH):
    """The ordinal-``k`` crossing state per candidate column of an (S, J, C)
    history, with per-candidate range ``xr`` and ordinal ``ordk``; falls
    back to the last crossing where a path has fewer.  Returns ``(states
    (J, C), found (J,) bool)``, zero rows where nothing crosses; the
    ``kmah_col`` column is taken from the pre-crossing row, not
    interpolated."""
    x = h[:, :, x_col]                                       # (S, J)
    d = x - xr[None, :]
    n_steps, n_cand = x.shape
    if n_steps < 2:
        return np.zeros((n_cand, h.shape[2])), np.zeros(n_cand, bool)
    step_ok = np.arange(n_steps - 1)[:, None] < last[None, :]
    hit = step_ok & ((d[:-1] < 0) != (d[1:] < 0))           # (S-1, J)
    cum = np.cumsum(hit, 0)
    counts = cum[-1]
    found = counts > 0
    target = np.minimum(ordk, np.maximum(counts - 1, 0))
    sel = hit & (cum - 1 == target[None, :])   # one True per found column
    idx = sel.argmax(0)
    j = np.arange(n_cand)
    h0, h1 = h[idx, j], h[idx + 1, j]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = (d[idx, j] / (x[idx, j] - x[idx + 1, j]))[:, None]
        out = np.where(found[:, None], h0 + frac * (h1 - h0), 0.0)
    out[:, kmah_col] = np.where(found, h0[:, kmah_col], 0.0)
    return out, found


def find_eigenrays(op_name: str, medium, *, source, receivers, delta_s,
                   max_size: int, box, fan=(0.0, np.pi / 2, 256),
                   gamma: float = 1.0, dtype=np.float64, iters: int = 12,
                   tol: float = 1e-9, max_arrivals: int | None = None,
                   mesh=None, max_ord: int = 8,
                   device="cuda") -> Eigenrays:
    """Find every fan-resolved ray path from ``source`` to each receiver.

    ``receivers`` is (K, 2); ``fan`` = (theta_lo, theta_hi, count) bounds
    the launch-angle search (arrivals outside it, or multipath finer than
    the fan pitch, are not found).  ``box`` clips rays as in the forward
    engine; ``max_size`` bounds the step count.  ``max_arrivals`` caps the
    bracket-candidate count (looping paths multiply range crossings).
    Returns a flat :class:`Eigenrays`; an empty one if no path crosses any
    receiver range.  The traces run on ``device`` at ``dtype``: a medium's
    tables are read at their own precision, so build sampled media in
    float64 for eigenray work (float32 tables floor the miss near 1e-5).

    ``mesh`` (a ``torch.distributed`` mesh, ``parallel/mesh.py``) pads
    each fan and each Newton batch to the mesh's ``"rays"`` extent and
    splits it over that axis (eigenray.py:279-305); the crossings are
    all-gathered, so the host Newton steps and the merge run the same on
    every rank, and every rank returns the same arrivals.
    """
    if mesh is not None:
        from raytracing_tpu_torch.parallel.mesh import check_device
        check_device(mesh, device)
    dtype = _torch_dtype(dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    source = np.asarray(source, np_dtype)
    receivers = np.atleast_2d(np.asarray(receivers, np_dtype))
    th_lo, th_hi, n_fan = fan
    # a launch container: the traces read only gamma and box from it
    scen = config.ScenarioConfig(
        name="custom", key="-", field="", gamma=float(gamma),
        ray_count=int(n_fan),
        theta0=np.linspace(th_lo, th_hi, int(n_fan)),
        pos0=np.tile(source, (int(n_fan), 1)), s_max=0.0,
        box=tuple(float(b) for b in box))
    kw = dict(delta_s=delta_s, dtype=dtype, max_size=max_size, device=device)

    def fan_crossings(theta0, ranges, m_ord):
        def run(th):
            res = trace_crossings_fan(op_name, scen, medium, ranges=ranges,
                                      max_ord=m_ord,
                                      pos0=np.tile(source, (len(th), 1)),
                                      theta0=th, **kw)
            return res.depths.cpu().numpy(), res.counts.cpu().numpy()
        return run_over_rays(mesh, run, theta0)

    def pick(theta0, xr, ordk):
        def run(th, x, o):
            res = trace_crossings_pick(op_name, scen, medium, xr=x, ordk=o,
                                       pos0=np.tile(source, (len(th), 1)),
                                       theta0=th, **kw)
            return res.state.cpu().numpy(), res.found.cpu().numpy()
        return run_over_rays(mesh, run, theta0, xr, ordk)

    # --- bracket scan: one fan trace records every range-line crossing; a
    # (range x depth) receiver grid shares a range's records
    uniq_xr, xr_inv = np.unique(receivers[:, 0], return_inverse=True)
    fan_th = np.asarray(scen.theta0, np_dtype)
    depths, counts = fan_crossings(fan_th, uniq_xr, int(max_ord))
    if counts.size and int(counts.max()) > int(max_ord):
        # loopy paths crossed more often than recorded: one re-run at the
        # observed count keeps the scan exact
        depths, counts = fan_crossings(fan_th, uniq_xr, int(counts.max()))

    cand_th_lo, cand_th_hi, cand_rec = [], [], []
    cand_flo, cand_ord = [], []
    for ui in range(len(uniq_xr)):
        depth = depths[:, ui, :]                       # (R, M) nan-padded
        here = np.where(xr_inv == ui)[0]               # receivers at xru
        f = depth[None, :, :] - receivers[here, 1][:, None, None]
        ok = ~np.isnan(f[:, :-1, :]) & ~np.isnan(f[:, 1:, :])
        s0, s1 = np.sign(f[:, :-1, :]), np.sign(f[:, 1:, :])
        # any sign TRANSITION brackets a root, an exact hit (f == 0)
        # included; its two intervals converge to one root, merged below
        sign = ok & (s0 != s1) & ~((s0 == 0) & (s1 == 0))
        ki, ri, kk = np.nonzero(sign)                  # (rec, ray, ordinal)
        cand_th_lo.extend(scen.theta0[ri])
        cand_th_hi.extend(scen.theta0[ri + 1])
        cand_flo.extend(f[ki, ri, kk])
        cand_rec.extend(here[ki])
        cand_ord.extend(kk)
    if not cand_th_lo:
        z = np.empty(0)
        zi = np.empty(0, np.int32)
        return Eigenrays(zi, z, z, z, z, zi, z, z, z, z,
                         np.empty(0, bool))
    if max_arrivals is not None and len(cand_th_lo) > int(max_arrivals):
        raise ValueError(
            f"{len(cand_th_lo)} bracket candidates exceed max_arrivals "
            f"{int(max_arrivals)} (looping paths multiply crossings); "
            f"shorten the trace, shrink the fan, or raise the cap")

    lo = np.asarray(cand_th_lo, np_dtype)
    hi = np.asarray(cand_th_hi, np_dtype)
    flo = np.asarray(cand_flo, np_dtype)
    rec = np.asarray(cand_rec, np.int32)
    ordk = np.asarray(cand_ord, np.int32)
    xr = receivers[rec, 0]
    yr = receivers[rec, 1]
    th = 0.5 * (lo + hi)

    # --- safeguarded Newton, batched over every candidate -----------------
    state = np.zeros((len(th), 6))
    best_th = th.copy()
    best_f = np.full(len(th), np.inf)
    for _ in range(int(iters)):
        st, found = pick(th, xr, ordk)
        state = np.where(found[:, None], st, state)
        fcur = np.where(found, st[:, _CY] - yr, np.nan)
        # keep the best-|residual| angle seen and return it, never the
        # last probe
        better = found & (np.abs(fcur) < np.abs(best_f))
        best_th = np.where(better, th, best_th)
        best_f = np.where(better, fcur, best_f)
        # convergence check before any update
        if np.all(np.isfinite(best_f)) and np.abs(best_f).max() < tol:
            break
        lost = np.isnan(fcur)
        # bracket bookkeeping on real signs only; a vanished crossing walks
        # the next probe toward lo (whose fan ray crossed)
        neg = ~lost & (fcur * flo > 0)
        lo = np.where(neg, th, lo)
        hi = np.where(~lost & ~neg, th, hi)
        # Newton proposal from the exact paraxial slope dy/dth = q / cos(a)
        slope = state[:, _CQ] / np.cos(state[:, _CANG])
        with np.errstate(divide="ignore", invalid="ignore"):
            prop = th - fcur / slope
        mid = 0.5 * (lo + hi)
        use = ~lost & np.isfinite(prop) & (prop > lo) & (prop < hi)
        th = np.where(use, prop, np.where(lost, 0.5 * (lo + th), mid))

    # --- final evaluation at the best-seen angles -------------------------
    th = np.where(np.isfinite(best_f), best_th, th)
    rows, ok = pick(th, xr, ordk)
    y_err = np.where(ok, rows[:, _CY] - yr, np.inf)
    src = torch.as_tensor(np.tile(source, (2, 1)), dtype=dtype, device=device)
    n0 = float(medium.n_and_grad(src[:, 0], src[:, 1])[0][0])
    n0 = np.full(len(th), n0)
    amp = spreading_amplitude(torch.as_tensor(rows[:, _CQ]),
                              torch.as_tensor(rows[:, _CN]),
                              torch.as_tensor(n0)).numpy()
    order = np.lexsort((rows[:, _CTT], rec))
    keep = ok[order]
    order = order[keep]
    # merge duplicate roots: arrivals closer than 1e-3 fan pitch in launch
    # angle with the same travel time (to 1e-6 relative) are one; the
    # travel-time guard keeps different crossing ordinals apart
    pitch = (float(th_hi) - float(th_lo)) / max(int(n_fan) - 1, 1)
    tts = rows[:, _CTT]
    dedup = []
    for j in order:
        dup = any(rec[j] == rec[i] and abs(th[j] - th[i]) < 1e-3 * pitch
                  and abs(tts[j] - tts[i]) < 1e-6 * (1.0 + abs(tts[i]))
                  for i in dedup)
        if not dup:
            dedup.append(j)
    order = np.asarray(dedup, int)
    return Eigenrays(
        receiver=rec[order], theta0=th[order],
        traveltime=rows[order, _CTT], y_err=y_err[order],
        q=rows[order, _CQ], kmah=rows[order, _CKMAH].astype(np.int32),
        angle=rows[order, _CANG], n=rows[order, _CN], n0=n0[order],
        amplitude=amp[order],
        converged=np.abs(y_err[order]) < max(tol * 1e3, 1e-6))


def pressure(eig: Eigenrays, omega: float, n_receivers: int) -> np.ndarray:
    """Coherent complex pressure per receiver at angular frequency omega:
    each arrival contributes ``A exp(i(omega tau - pi/2 kmah))``."""
    ph = omega * np.asarray(eig.traveltime) - 0.5 * np.pi * np.asarray(eig.kmah)
    contrib = np.asarray(eig.amplitude) * np.exp(1j * ph)
    p = np.zeros(n_receivers, complex)
    np.add.at(p, np.asarray(eig.receiver), contrib)
    return p


def coherent_tl(eig: Eigenrays, omega: float, n_receivers: int) -> np.ndarray:
    """-20 log10 |sum of arrivals| per receiver (dB re 1 m); inf if none."""
    with np.errstate(divide="ignore"):
        return -20.0 * np.log10(np.abs(pressure(eig, omega, n_receivers)))


def incoherent_tl(eig: Eigenrays, n_receivers: int) -> np.ndarray:
    """-10 log10 sum |A|^2 per receiver: the phase-averaged field."""
    e = np.zeros(n_receivers)
    np.add.at(e, np.asarray(eig.receiver), np.asarray(eig.amplitude) ** 2)
    with np.errstate(divide="ignore"):
        return -10.0 * np.log10(e)
