"""Host-side visualization: the reference's ``graficar`` as library functions.

Port of ``raytracing_tpu/viz/plots.py:1-386``: ``_mpl`` (plots.py:24),
``_setup_axes`` (:31), ``ray_xy`` (:39), ``Wavefront`` (:46), ``wavefront``
(:57), ``wavefront_report`` (:98), ``_draw_medium`` (:115),
``plot_static`` (:146), ``animate_wavefronts`` (:197), ``plot_momentum``
(:240), ``plot_eigenrays`` (:270), ``plot_transmission_loss`` (:319) and
``plot_rays3d`` (:350) -- RT_bench.py:964-1197: trajectory plots over a
pcolormesh of n, PCHIP wavefront reconstruction with the ray-angle-vs-
wavefront-normal cross-check, the FuncAnimation wavefront movie with mp4
export, and the ray-parameter (momentum) plot.

Every function takes the port's results (``TraceResult``,
``DynamicResult``, ``Trace3Result``, ``Eigenrays``) with tensors on any
device; they are read on the host through ``.cpu().numpy()``, and the
analysis runs in float64 numpy and scipy exactly as the JAX package's
does.  matplotlib is imported only when something is drawn, so the
wavefront analysis runs where matplotlib is not installed.

LaTeX text rendering (RT_bench.py:967-969) is opt-in: environments without
a TeX install fall back to mathtext.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch import config as _config
from raytracing_tpu_torch.media.grid import gen_grid


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _medium_device(medium):
    """The device of a sampled medium's tables, or None (analytic and
    custom media hold no tensor)."""
    import dataclasses
    if dataclasses.is_dataclass(medium):
        for f in dataclasses.fields(medium):
            v = getattr(medium, f.name)
            if torch.is_tensor(v):
                return v.device
    return None


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return matplotlib, plt


def _setup_axes(ax, use_tex: bool):
    import matplotlib
    matplotlib.rcParams["text.usetex"] = use_tex
    matplotlib.rcParams["font.family"] = "serif"
    ax.tick_params(axis="x", labelsize=24)
    ax.tick_params(axis="y", labelsize=24)


def ray_xy(result, k: int):
    """Trimmed (x, y, angle, traveltime) arrays of ray k (RT_bench.py:992-993)."""
    i = int(_np(result.exit_step)[k])
    h = _np(result.history)[: i + 1, k, :]
    return h[:, 0], h[:, 1], h[:, 5], h[:, 4]


class Wavefront(NamedTuple):
    """One reconstructed wavefront at a fixed travel time (RT_bench.py:984-1049)."""

    travel_time: float
    points: np.ndarray        # (m, 2) ray positions at the travel time, y-sorted
    ray_angles: np.ndarray    # (m,) interpolated group angles
    normal_angles: np.ndarray  # (m,) wavefront-normal angles
    angle_diffs: np.ndarray   # (m,) |ray - normal| cross-check
    curve: np.ndarray         # (100, 2) smooth wavefront polyline


def wavefront(result, travel_time: float) -> Wavefront | None:
    """Reconstruct the wavefront at ``travel_time`` via PCHIP interpolation.

    Mirrors the reference: per ray, PCHIP (x, y, angle) against accumulated
    travel time and sample at the target (RT_bench.py:997-1002); sort the
    points by y, PCHIP the wavefront curve x(y), differentiate it, and
    compare each ray's angle with the wavefront-normal angle
    (RT_bench.py:1016-1026).  Returns None when fewer than two rays have
    reached the travel time.
    """
    from scipy.interpolate import PchipInterpolator

    r = result.history.shape[1]
    pts, angs = [], []
    for k in range(r):
        x, y, ang, t = ray_xy(result, k)
        if t.max() >= travel_time:
            pts.append([PchipInterpolator(t, x)(travel_time),
                        PchipInterpolator(t, y)(travel_time)])
            angs.append(PchipInterpolator(t, ang)(travel_time))
    if len(pts) < 2:
        return None
    pts = np.asarray(pts, dtype=float)
    angs = np.asarray(angs, dtype=float)
    order = np.argsort(pts[:, 1])
    pts, angs = pts[order], angs[order]

    curve_interp = PchipInterpolator(pts[:, 1], pts[:, 0])
    dy_dx = curve_interp.derivative()(pts[:, 1])
    tangent = np.pi / 2.0 - np.arctan(dy_dx)
    normal = tangent - np.pi / 2.0

    y_fine = np.linspace(pts[:, 1].min(), pts[:, 1].max(), 100)
    curve = np.stack([curve_interp(y_fine), y_fine], axis=-1)
    return Wavefront(travel_time=float(travel_time), points=pts,
                     ray_angles=angs, normal_angles=normal,
                     angle_diffs=np.abs(angs - normal), curve=curve)


def wavefront_report(result,
                     travel_times=np.arange(0.05, 0.6, 0.05),
                     printer=print) -> list[Wavefront]:
    """The reference's static-mode console report (RT_bench.py:1028-1039)."""
    fronts = []
    for t in travel_times:
        wf = wavefront(result, float(t))
        if wf is None:
            continue
        fronts.append(wf)
        printer(f"\033[94m\nTravel Time: {t:.2f}\033[0m - all angles expressed in radians")
        for idx, (d, a, n) in enumerate(zip(wf.angle_diffs, wf.ray_angles,
                                            wf.normal_angles)):
            printer(f"\033[91mRay {idx + 1:<2}:\033[0m Angle Diff = {d: .4f}, "
                    f"Ray Angle = {a: .4f}, Normal Angle = {n: .4f}")
    return fronts


def _draw_medium(ax, scen, use_tex: bool, medium=None):
    """pcolormesh of n with the reference's horizontal colorbar
    (RT_bench.py:1136-1150).  ``medium``: evaluate an arbitrary medium's
    ``n`` over the box instead of a named field — measured media have no
    field name to regenerate from."""
    from matplotlib.ticker import FormatStrFormatter
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    if medium is None:
        x, y, Z = gen_grid(scen.field, scen.box)
        X, Y = np.meshgrid(x, y)
    else:
        x = np.linspace(scen.box[0], scen.box[1], 256)
        y = np.linspace(scen.box[2], scen.box[3], 256)
        X, Y = np.meshgrid(x, y)
        dev = _medium_device(medium) or "cpu"
        Z = _np(medium.n(torch.as_tensor(X.ravel(), device=dev),
                         torch.as_tensor(Y.ravel(), device=dev))
                ).reshape(X.shape)
    pcm = ax.pcolormesh(X, Y, Z, cmap="Greys")
    divider = make_axes_locatable(ax)
    cax = divider.append_axes("bottom", size="8%", pad=0.4)
    cbar = ax.figure.colorbar(pcm, cax=cax, orientation="horizontal")
    cbar.set_ticks([cbar.vmin, cbar.vmax])
    cbar.ax.xaxis.set_major_formatter(FormatStrFormatter("%.2f"))
    cbar.ax.tick_params(labelsize=24)
    label = r"Refractive index $n$"
    cbar.ax.set_xlabel(label, fontsize=28, labelpad=-15)


def plot_static(result, scen, *, travel_times=None,
                use_tex: bool = False, save: str | None = None,
                medium=None):
    """Static scenario plot (RT_bench.py:976-1050, 1121-1156).

    fisheye/interface: every trimmed trajectory over the medium.  vert/aniso:
    every other ray (the reference plots rays with even index,
    RT_bench.py:1007-1010) plus wavefronts and travel-time markers.
    ``medium``: background n field for MEASURED media (no named field).
    Returns (fig, wavefronts).
    """
    _, plt = _mpl()
    fig, ax = plt.subplots(figsize=(12, 8))
    _setup_axes(ax, use_tex)
    fronts = []
    r = result.history.shape[1]

    if scen.is_vert:
        if travel_times is None:
            travel_times = np.arange(0.05, 0.6, 0.05)
        for k in range(r):
            x, y, _, _ = ray_xy(result, k)
            if k % 2 == 0:
                ax.plot(x, y, color="r", linewidth=1.5, zorder=2)
        for t in travel_times:
            wf = wavefront(result, float(t))
            if wf is None:
                continue
            fronts.append(wf)
            ax.plot(wf.points[::2, 0], wf.points[::2, 1], "go", markersize=5,
                    zorder=3)
            ax.plot(wf.curve[:, 0], wf.curve[:, 1], "b--", zorder=4)
        ax.set_xlim([scen.box[0], 4])
        ax.set_ylim([-2, 0])
    else:
        for k in range(r):
            x, y, _, _ = ray_xy(result, k)
            ax.plot(x, y, color="r", linewidth=1.5)
        ax.set_xlim([scen.box[0], scen.box[1]])
        ax.set_ylim([scen.box[2], scen.box[3]])

    ax.set_aspect("equal")
    _draw_medium(ax, scen, use_tex, medium)
    if scen.is_interface:
        ax.set_xticks(np.arange(scen.box[0], scen.box[1] + 2, 2))
        ax.set_yticks(np.arange(scen.box[2], scen.box[3] + 1, 1))
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=100)
    return fig, fronts


def animate_wavefronts(result, scen, *, frames: int = 45,
                       dt: float = 0.01, save: str | None = None,
                       use_tex: bool = False):
    """Wavefront-propagation movie (RT_bench.py:1051-1111, 1158-1167).

    45 frames at travel-time increments of 0.01; saved as mp4 via ffmpeg when
    ``save`` is given.  Returns the FuncAnimation.
    """
    from matplotlib.animation import FuncAnimation

    _, plt = _mpl()
    fig, ax = plt.subplots(figsize=(12, 8))
    _setup_axes(ax, use_tex)
    r = result.history.shape[1]
    for k in range(0, r, 2):
        x, y, _, _ = ray_xy(result, k)
        ax.plot(x, y, "r", linewidth=1.5, zorder=2)
    wavefront_line, = ax.plot([], [], "b--", zorder=4)
    dots, = ax.plot([], [], "go", markersize=5, zorder=3)
    ax.set_xlim([scen.box[0], 4])
    ax.set_ylim([-2, 0])

    def update(frame):
        t = dt + frame * dt
        wf = wavefront(result, t)
        if wf is not None:
            wavefront_line.set_data(wf.curve[:, 0], wf.curve[:, 1])
            dots.set_data(wf.points[::2, 0], wf.points[::2, 1])
        return [wavefront_line, dots]

    ani = FuncAnimation(fig, update, frames=frames, blit=True)
    if save:
        from matplotlib.animation import FFMpegWriter

        if FFMpegWriter.isAvailable():
            ani.save(save, writer="ffmpeg")  # RT_bench.py:1162
        else:
            # hosts without ffmpeg fall back to a GIF (JAX's plots.py:228)
            if save.endswith(".mp4"):
                save = save[:-4] + ".gif"
            ani.save(save, writer="pillow")
    return ani, save if save else None


def plot_momentum(result, scen, *, delta_s: float,
                  use_tex: bool = False, save: str | None = None):
    """Ray-parameter p_x(s) plot with conservation annotations
    (RT_bench.py:1172-1195)."""
    _, plt = _mpl()
    fig, ax = plt.subplots(figsize=(12, 8))
    _setup_axes(ax, use_tex)
    hist = _np(result.history)
    exit_step = _np(result.exit_step)
    r = hist.shape[1]
    for k in range(1, r - 1):
        if k % 2 != 0:
            continue
        i = int(exit_step[k])
        px = hist[: i + 1, k, 2]
        s = np.arange(len(px)) * delta_s
        ax.plot(s, px, color="r", linewidth=1.5)
        avg, std = px.mean(), px.std()
        ax.annotate(
            f"Ray {k // 2}, $\\Delta p_x$={100 * abs(px[0] - avg) / px[0]:.2e}%, "
            f"$\\overline{{p}}_x$={avg:.2e}, CV={100 * std / avg:.4f}%",
            xy=(s[-1], px[-1]), textcoords="offset points", xytext=(-100, 6),
            ha="center", fontsize=16, weight="bold")
    ax.set_xlabel("Ray length", fontsize=24)
    ax.set_ylabel("Ray parameter $p_x$", fontsize=24)
    if save:
        fig.savefig(save, dpi=100)
    return fig


def plot_eigenrays(eig, op_name: str, medium, *, source, receivers,
                   delta_s: float, steps: int, box, gamma: float = 1.0,
                   use_tex: bool = False, save: str | None = None,
                   device=None):
    """Draw every eigenray path source -> receivers, colored by receiver.

    Re-traces the solved launch angles (engine/eigenray.Eigenrays) through
    the dynamic tier in float64 on ``device`` (default: the device of the
    medium's tables, else "cuda") and overlays source/receiver markers;
    caustic passages (KMAH increments) are marked on each path.  The
    eigenray counterpart of the reference's trajectory plot
    (RT_bench.py:1121-1150).
    """
    import dataclasses

    from raytracing_tpu_torch.engine.dynamic import DYN_COLS, trace_dynamic

    _, plt = _mpl()
    fig, ax = plt.subplots(figsize=(12, 8))
    _setup_axes(ax, use_tex)

    theta0 = np.asarray(eig.theta0, np.float64)
    receivers = np.atleast_2d(np.asarray(receivers, np.float64))
    if len(theta0):
        if device is None:
            device = _medium_device(medium) or "cuda"
        scen = dataclasses.replace(_config.scenario("fisheye"),
                                   name="eigenray", gamma=gamma,
                                   box=tuple(float(b) for b in box))
        pos0 = np.tile(np.asarray(source, np.float64), (len(theta0), 1))
        res = trace_dynamic(op_name, scen, medium, delta_s=delta_s,
                            dtype=torch.float64, pos0=pos0, theta0=theta0,
                            max_size=int(steps), mode="history",
                            device=device)
        h = _np(res.history)
        exit_step = _np(res.exit_step)
        kcol = DYN_COLS.index("kmah")
        cmap = plt.get_cmap("tab10")
        for j in range(len(theta0)):
            i = int(exit_step[j])
            color = cmap(int(np.asarray(eig.receiver)[j]) % 10)
            ax.plot(h[: i + 1, j, 0], h[: i + 1, j, 1], color=color,
                    linewidth=1.2)
            flips = np.where(np.diff(h[: i + 1, j, kcol]) > 0)[0]
            if len(flips):
                ax.plot(h[flips + 1, j, 0], h[flips + 1, j, 1], "kx",
                        markersize=7)
    ax.plot([source[0]], [source[1]], "r*", markersize=14, label="source")
    ax.plot(receivers[:, 0], receivers[:, 1], "bv", markersize=10,
            label="receivers")
    ax.legend(fontsize=14)
    ax.set_xlabel("x", fontsize=24)
    ax.set_ylabel("y", fontsize=24)
    if save:
        fig.savefig(save, dpi=100)
    return fig


def plot_transmission_loss(eig, receivers, *, omega: float | None = None,
                           use_tex: bool = False, save: str | None = None):
    """Transmission loss vs receiver range (the sonar TL curve).

    Incoherent TL always; the coherent curve too when ``omega`` is given.
    Receivers with no arrivals plot as gaps.  dB grows DOWNWARD (loss), the
    field's plotting convention.
    """
    from raytracing_tpu_torch.engine.eigenray import (coherent_tl,
                                                      incoherent_tl)

    _, plt = _mpl()
    receivers = np.atleast_2d(np.asarray(receivers, np.float64))
    k = len(receivers)
    rng = receivers[:, 0]
    itl = incoherent_tl(eig, n_receivers=k)
    fig, ax = plt.subplots(figsize=(12, 6))
    _setup_axes(ax, use_tex)
    ax.plot(rng, np.where(np.isfinite(itl), itl, np.nan), "o-",
            color="tab:blue", label="incoherent")
    if omega is not None:
        ctl = coherent_tl(eig, float(omega), n_receivers=k)
        ax.plot(rng, np.where(np.isfinite(ctl), ctl, np.nan), ".--",
                color="tab:red", label=f"coherent ($\\omega$={omega:g})")
    ax.invert_yaxis()
    ax.legend(fontsize=14)
    ax.set_xlabel("Range", fontsize=24)
    ax.set_ylabel("Transmission loss (dB)", fontsize=24)
    if save:
        fig.savefig(save, dpi=100)
    return fig


def plot_rays3d(result, *, box=None, elev: float = 20.0, azim: float = -60.0,
                use_tex: bool = False, save: str | None = None):
    """3-D trajectory plot of an ``engine/trace3d.py::Trace3Result`` history.

    Rays color by launch index; the optional ``box`` draws the domain
    edges.  The 3-D sibling of the reference's trajectory plot
    (RT_bench.py:1121-1150) — the reference has no 3-D state to draw.
    """
    _, plt = _mpl()
    if result.history is None:
        raise ValueError("plot_rays3d needs mode='history'")
    h = _np(result.history)
    exit_step = _np(result.exit_step)
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    cmap = plt.get_cmap("viridis")
    r = h.shape[1]
    for k in range(r):
        i = int(exit_step[k])
        ax.plot(h[: i + 1, k, 0], h[: i + 1, k, 1], h[: i + 1, k, 2],
                color=cmap(k / max(r - 1, 1)), linewidth=1.0)
    if box is not None:
        x0, x1, y0, y1, z0, z1 = box
        for s, e in (((x0, y0, z0), (x1, y0, z0)),
                     ((x0, y0, z0), (x0, y1, z0)),
                     ((x0, y0, z0), (x0, y0, z1)),
                     ((x1, y1, z1), (x0, y1, z1)),
                     ((x1, y1, z1), (x1, y0, z1)),
                     ((x1, y1, z1), (x1, y1, z0))):
            ax.plot(*zip(s, e), color="0.7", linewidth=0.8)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.view_init(elev=elev, azim=azim)
    if save:
        fig.savefig(save, dpi=100)
    return fig
