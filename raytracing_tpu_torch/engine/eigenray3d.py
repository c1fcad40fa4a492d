"""3-D eigenrays: two-parameter boundary-value solving with the exact Q.

Port of ``raytracing_tpu/engine/eigenray3d.py``: ``Eigenrays3``
(eigenray3d.py:51), ``_grid_dirs`` (:72) and ``find_eigenrays3`` with
``_find_eigenrays3`` (:82-300).  A receiver in 3-D is hit by tuning two
launch angles:

1. one dynamic fan over an (alpha, beta) grid of directions around
   ``center_dir`` records every ray's (y, z) landing per receiver range
   and crossing ordinal as it goes
   (:func:`engine.dynamic3d.trace_crossings_fan3`); grid cells that
   locally minimize the miss seed one candidate each (multipath = several
   minima; arrivals finer than the grid pitch, or seeded on the fan's
   edge, are not found);
2. damped Gauss-Newton on all candidates of all receivers at once, one
   crossing-pick trace an iteration
   (:func:`engine.dynamic3d.trace_crossings_pick3`), with the exact 2x2
   Jacobian of the crossing-plane miss from the interpolated tangents,
   ``M[i, j] = dpos_i/da_j - dpos_x/da_j (u_i / u_x)``, steps clamped to
   the grid pitch;
3. the travel time, |det Q| amplitude, KMAH and residual miss of each
   arrival.  The result duck-types into ``engine/eigenray.py``'s
   ``pressure``, ``coherent_tl`` and ``incoherent_tl``.

The traces run on ``device`` (the card by default) at ``dtype`` (float64
by default: the Newton floor is the landing surface's noise, so build
sampled media in float64 for eigenray work); the seed scan, the
Gauss-Newton bookkeeping and the merge are host numpy.  The JAX package's
host/accelerator routing (``on_host``, ``_solve_device``) existed for a
remote TPU without float64 and is not ported.  ``mesh=`` (a
``torch.distributed`` mesh) pads the fan and each Gauss-Newton batch to
the mesh's ``"rays"`` extent and splits it over that axis
(eigenray3d.py:148-165); the crossings are all-gathered, so every rank
runs the same host steps and returns the same arrivals.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.engine.dynamic3d import (
    CROSS3_COLS, _transverse_frame, spreading_amplitude3,
    trace_crossings_fan3, trace_crossings_pick3)
from raytracing_tpu_torch.engine.trace import _torch_dtype
from raytracing_tpu_torch.parallel.mesh import run_over_rays


class Eigenrays3(NamedTuple):
    """3-D arrivals, flat over (receiver, path); sorted by receiver then
    travel time; numpy arrays.  Field names match the 2-D ``Eigenrays``
    where the TL reductions read them."""

    receiver: Any     # (E,) int32
    dir0: Any         # (E, 3) launch direction of the arrival
    traveltime: Any   # (E,)
    miss: Any         # (E,) residual |(y, z) - receiver| at its range
    detq: Any         # (E,) paraxial det Q at the receiver
    kmah: Any         # (E,) int32
    amplitude: Any    # (E,) point-source spherical-spreading amplitude
    n: Any            # (E,)
    n0: Any           # (E,)
    converged: Any    # (E,) bool

    def for_receiver(self, i: int) -> "Eigenrays3":
        m = self.receiver == i
        return Eigenrays3(*[np.asarray(f)[m] for f in self])


def _frame_np(u):
    """The transverse frame of (R, 3) float64 directions, as numpy."""
    e1, e2 = _transverse_frame(torch.as_tensor(np.asarray(u, np.float64)))
    return e1.numpy(), e2.numpy()


def _grid_dirs(center, a, b):
    """The (n_a, n_b, 3) launch grid ``normalize(u0 + a e1 + b e2)`` around
    ``center``, and the frame (e1, e2) of its centre."""
    u0 = np.asarray(center, np.float64)
    u0 = u0 / np.linalg.norm(u0)
    e1, e2 = _frame_np(u0[None, :])
    d = (u0[None, None, :] + a[:, None, None] * e1 + b[None, :, None] * e2)
    return d / np.linalg.norm(d, axis=-1, keepdims=True), e1[0], e2[0]


def find_eigenrays3(method: str, medium, *, source, receivers, delta_s,
                    max_size: int, box=None, center_dir=None,
                    fan=(-0.3, 0.3, 25, -0.3, 0.3, 25), iters: int = 12,
                    tol: float = 1e-9, dtype=torch.float64, mesh=None,
                    max_ord: int = 8, device="cuda") -> Eigenrays3:
    """Every fan-resolved 3-D ray path from ``source`` to each receiver.

    ``receivers`` is (K, 3); ``fan`` = (a_lo, a_hi, n_a, b_lo, b_hi, n_b),
    the launch-direction grid around ``center_dir`` (default: from the
    source toward the mean receiver); ``max_size`` is the traces' step
    count, as JAX's solver passes it; ``max_ord`` caps the range-crossing
    ordinals the crossing records resolve (looping paths that cross a
    range more often need it raised).  Returns a flat :class:`Eigenrays3`,
    empty when no fan ray lands near any receiver.
    """
    if mesh is not None:
        from raytracing_tpu_torch.parallel.mesh import check_device
        check_device(mesh, device)
    dtype = _torch_dtype(dtype)
    source = np.asarray(source, np.float64)
    receivers = np.atleast_2d(np.asarray(receivers, np.float64))
    if center_dir is None:
        center_dir = receivers.mean(0) - source
    a_lo, a_hi, n_a, b_lo, b_hi, n_b = fan
    n_a, n_b = int(n_a), int(n_b)
    a = np.linspace(a_lo, a_hi, n_a)
    b = np.linspace(b_lo, b_hi, n_b)
    pitch = max((a_hi - a_lo) / max(n_a - 1, 1),
                (b_hi - b_lo) / max(n_b - 1, 1))
    dirs, _, _ = _grid_dirs(center_dir, a, b)
    kw = dict(delta_s=delta_s, steps=int(max_size), box=box, dtype=dtype,
              device=device)

    # --- seed scan over the fan's crossing records: grid-local minima of
    # the miss per (receiver, ordinal) seed one candidate each
    uniq_xr, xr_inv = np.unique(receivers[:, 0], return_inverse=True)
    fan_dirs = dirs.reshape(-1, 3)

    def run_fan(d):
        res = trace_crossings_fan3(
            method, medium, pos0=np.tile(source, (len(d), 1)), dir0=d,
            ranges=uniq_xr, max_ord=int(max_ord), **kw)
        return (res.depths.cpu().numpy(),)
    depths, = run_over_rays(mesh, run_fan, fan_dirs)  # (F, NRu, max_ord, 2)

    cand_dir, cand_rec, cand_ord = [], [], []
    for ui in range(len(uniq_xr)):
        yz = depths[:, ui].reshape(n_a, n_b, -1, 2)
        for ri in np.where(xr_inv == ui)[0]:
            m2 = ((yz[..., 0] - receivers[ri, 1]) ** 2
                  + (yz[..., 1] - receivers[ri, 2]) ** 2)
            m2 = np.where(np.isnan(m2), np.inf, m2)
            # interior nodes beating their 4-neighbourhood seed a candidate
            c = m2[1:-1, 1:-1]
            is_min = (np.isfinite(c)
                      & (c <= m2[:-2, 1:-1]) & (c <= m2[2:, 1:-1])
                      & (c <= m2[1:-1, :-2]) & (c <= m2[1:-1, 2:]))
            ii, jj, kk = np.nonzero(is_min)
            cand_dir.extend(dirs[ii + 1, jj + 1])
            cand_rec.extend([ri] * len(ii))
            cand_ord.extend(kk)
    if not cand_dir:
        z = np.empty(0)
        zi = np.empty(0, np.int32)
        return Eigenrays3(zi, np.empty((0, 3)), z, z, z, zi, z, z, z,
                          np.empty(0, bool))

    u = np.asarray(cand_dir, np.float64)
    rec = np.asarray(cand_rec, np.int32)
    ordk = np.asarray(cand_ord, np.int32)
    xr = receivers[rec, 0]
    tgt = receivers[rec, 1:3]

    cY, cZ, cTT, cN, cDETQ, cKMAH = (CROSS3_COLS.index(k) for k in
                                     ("y", "z", "traveltime", "n",
                                      "detq", "kmah"))
    cU = CROSS3_COLS.index("ux")
    cDPA = CROSS3_COLS.index("dpax")
    cDPB = CROSS3_COLS.index("dpbx")

    def run_pick(dir_batch):
        def run(d, x, o):
            res = trace_crossings_pick3(
                method, medium, pos0=np.tile(source, (len(d), 1)), dir0=d,
                xr=x, ordk=o, **kw)
            return res.state.cpu().numpy(), res.found.cpu().numpy()
        return run_over_rays(mesh, run, dir_batch, xr, ordk)

    # --- damped Gauss-Newton, all candidates in one trace an iteration;
    # each candidate follows its seeded crossing ordinal
    miss = np.full(len(u), np.inf)
    for _ in range(int(iters)):
        st, found = run_pick(u)
        m = st[:, [cY, cZ]] - tgt                           # (J, 2)
        miss = np.where(found, np.linalg.norm(m, axis=1), np.inf)
        uc = st[:, cU:cU + 3]
        dpa, dpb = st[:, cDPA:cDPA + 3], st[:, cDPB:cDPB + 3]
        ux = np.where(np.abs(uc[:, 0]) > 1e-9, uc[:, 0],
                      np.copysign(1e-9, uc[:, 0]))
        m00 = dpa[:, 1] - dpa[:, 0] * uc[:, 1] / ux
        m01 = dpb[:, 1] - dpb[:, 0] * uc[:, 1] / ux
        m10 = dpa[:, 2] - dpa[:, 0] * uc[:, 2] / ux
        m11 = dpb[:, 2] - dpb[:, 0] * uc[:, 2] / ux
        det = m00 * m11 - m01 * m10
        mmax = np.maximum(np.maximum(np.abs(m00), np.abs(m01)),
                          np.maximum(np.abs(m10), np.abs(m11)))
        newton_ok = np.abs(det) > 1e-12 * (mmax ** 2 + 1e-30)
        safe_det = np.where(newton_ok, det, 1.0)
        d_n = np.stack([-(m11 * m[:, 0] - m01 * m[:, 1]) / safe_det,
                        -(m00 * m[:, 1] - m10 * m[:, 0]) / safe_det], 1)
        # near a caustic: the damped gradient step -M^T m / |M|^2
        ss = m00 ** 2 + m01 ** 2 + m10 ** 2 + m11 ** 2 + 1e-30
        d_g = np.stack([-(m00 * m[:, 0] + m10 * m[:, 1]) / ss,
                        -(m01 * m[:, 0] + m11 * m[:, 1]) / ss], 1)
        delta = np.where(found[:, None],
                         np.where(newton_ok[:, None], d_n, d_g), 0.0)
        # clamp to one grid pitch: seeds are at most a cell away
        nrm = np.linalg.norm(delta, axis=1, keepdims=True)
        delta = np.where(nrm > pitch,
                         delta * (pitch / np.maximum(nrm, 1e-300)), delta)
        if np.nanmax(np.where(np.isinf(miss), np.nan, miss),
                     initial=0.0) < tol and np.all(np.isfinite(miss)):
            break
        e1c, e2c = _frame_np(u)
        u = u + delta[:, :1] * e1c + delta[:, 1:] * e2c
        u /= np.linalg.norm(u, axis=1, keepdims=True)

    # --- final evaluation ------------------------------------------------
    rows, ok = run_pick(u)
    miss = np.where(ok, np.linalg.norm(rows[:, [cY, cZ]] - tgt, axis=1),
                    np.inf)
    src = torch.as_tensor(np.tile(source, (2, 1)), dtype=dtype,
                          device=device)
    n0 = float(medium.n_and_grad3(src[:, 0], src[:, 1], src[:, 2])[0][0])
    n0 = np.full(len(u), n0)
    amp = spreading_amplitude3(torch.as_tensor(rows[:, cDETQ]),
                               torch.as_tensor(rows[:, cN]),
                               torch.as_tensor(n0)).numpy()

    order = np.lexsort((rows[:, cTT], rec))
    order = order[ok[order]]
    # merge duplicates below the fan's resolving power; the travel-time
    # guard keeps same-direction arrivals of different ordinals apart
    dedup = []
    for j in order:
        if not any(rec[j] == rec[i]
                   and np.linalg.norm(u[j] - u[i]) < 1e-3 * pitch
                   and abs(rows[j, cTT] - rows[i, cTT])
                   < 1e-6 * (1.0 + abs(rows[i, cTT]))
                   for i in dedup):
            dedup.append(j)
    order = np.asarray(dedup, int)
    return Eigenrays3(
        receiver=rec[order], dir0=u[order], traveltime=rows[order, cTT],
        miss=miss[order], detq=rows[order, cDETQ],
        kmah=rows[order, cKMAH].astype(np.int32), amplitude=amp[order],
        n=rows[order, cN], n0=n0[order],
        converged=miss[order] < max(tol * 1e3, 1e-6))
