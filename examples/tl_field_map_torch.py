"""Transmission-loss field map: the classic ocean-acoustics product.

The PyTorch twin of examples/tl_field_map.py.  One ``rtt.find_eigenrays``
call serves an entire (range x depth) receiver grid: the dynamic fan is
traced once and every grid cell brackets its own multipath arrivals, so
the whole field costs one fan and one batched Newton, not a trace a
receiver.  The output is the TL map a sonar engineer reads daily: the
SOFAR channel shows as a low-loss duct around the sound axis, shadow zones
as empty cells.  The solve runs in float64 on ``--device`` (the card has
float64; JAX's script keeps its float64 solve on the host CPU).

Run:  python examples/tl_field_map_torch.py [n_ranges] [n_depths] [fan] [out.png] [--device cpu]
"""
import argparse

import numpy as np
import torch

import raytracing_tpu_torch as rtt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranges", nargs="?", type=int, default=19)
    ap.add_argument("n_depths", nargs="?", type=int, default=12)
    ap.add_argument("n_fan", nargs="?", type=int, default=256)
    ap.add_argument("out_png", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_ranges, n_depths = args.n_ranges, args.n_depths

    # -- measured Munk-style profile, source on the channel axis -----------
    depth = np.linspace(-3.0, 0.0, 121)
    eta = 2.0 * (depth + 1.0)
    c = 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))
    medium = rtt.c1_stratified_from_samples(c.min() / c, depth,
                                            dtype=torch.float64,
                                            device=args.device)

    ranges = np.linspace(4.0, 40.0, n_ranges)
    depths = np.linspace(-2.5, -0.2, n_depths)
    receivers = np.stack(np.meshgrid(ranges, depths, indexing="ij"),
                         -1).reshape(-1, 2)

    eig = rtt.find_eigenrays(
        "op6", medium, source=(0.0, -1.0), receivers=receivers, delta_s=0.01,
        max_size=int(ranges.max() / 0.01 * 1.2),
        box=(-1.0, ranges.max() + 2.0, -3.0, 0.0),
        fan=(-0.3, 0.3, args.n_fan), tol=1e-7, device=args.device)

    itl = rtt.incoherent_tl(eig, n_receivers=len(receivers))
    tl_map = itl.reshape(n_ranges, n_depths)          # (range, depth)

    covered = np.isfinite(tl_map)
    print(f"TL field map: {n_ranges} ranges x {n_depths} depths, "
          f"{len(np.asarray(eig.theta0))} arrivals "
          f"({covered.mean() * 100:.0f} % of cells reached by the fan)")
    # a range's duct check: the axis depth should be among the quietest cells
    axis_j = int(np.argmin(np.abs(depths + 1.0)))
    duct_wins = 0
    for i in range(n_ranges):
        row = tl_map[i]
        if np.isfinite(row[axis_j]) and np.isfinite(row).sum() >= 3:
            duct_wins += row[axis_j] <= np.nanmedian(row)
    print(f"channel-axis cell at or below the row median TL in "
          f"{duct_wins}/{n_ranges} ranges (duct trapping)")

    assert covered.mean() > 0.3, "fan should reach a third of the grid"
    assert bool(np.all(np.asarray(eig.converged))), "all arrivals converged"
    assert duct_wins >= n_ranges // 2, "the SOFAR duct should show"

    if args.out_png:
        from raytracing_tpu_torch.viz.plots import _mpl
        _, plt = _mpl()
        fig, ax = plt.subplots(figsize=(11, 5))
        m = ax.pcolormesh(ranges, depths, tl_map.T, cmap="viridis_r",
                          shading="nearest")
        fig.colorbar(m, ax=ax, label="TL (dB re 1 km)")
        ax.plot([0.0], [-1.0], "r*", markersize=14)
        ax.set_xlabel("range (km)")
        ax.set_ylabel("depth (km)")
        ax.set_title("Incoherent transmission loss, measured SOFAR profile")
        fig.savefig(args.out_png, dpi=110)
        plt.close(fig)
        print(f"map saved to {args.out_png}")
    print("ok")
    return eig, tl_map, duct_wins


if __name__ == "__main__":
    main()
