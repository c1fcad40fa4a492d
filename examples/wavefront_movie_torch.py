"""Reproduce the reference's wavefront movie for the stratified scenario.

The PyTorch twin of examples/wavefront_movie.py: the vertically
heterogeneous fan traced with HySA (op6) at its calibrated step in float64
on ``--device``, the wavefront movie (``viz/plots.py::animate_wavefronts``,
45 frames; mp4 by ffmpeg, a GIF where there is none) and the wavefront
report at three travel times.  ``--report-only`` prints the report and
draws nothing, for hosts without matplotlib.

Run:  python examples/wavefront_movie_torch.py [--report-only] [--device cpu]
Writes wavefront_propagation.mp4 (or .gif without ffmpeg).
"""
import argparse

import torch

import raytracing_tpu_torch as rtt
from raytracing_tpu_torch.calibrated import calibrated
from raytracing_tpu_torch.viz import plots


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report-only", action="store_true",
                    help="print the wavefront report, draw no movie")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scen = rtt.scenario("vert")
    med = rtt.analytic_medium("vert_heterogeneous")
    ds, _ = calibrated("op6", "vert")
    res = rtt.trace("HySA", scen, med, delta_s=ds, dtype=torch.float64,
                    device=args.device)

    path = None
    if not args.report_only:
        ani, path = plots.animate_wavefronts(
            res, scen, save="wavefront_propagation.mp4")
        plots._mpl()[1].close(ani._fig)
        print("wrote", path)
    fronts = plots.wavefront_report(res, travel_times=[0.1, 0.3, 0.5])
    return res, path, fronts


if __name__ == "__main__":
    main()
