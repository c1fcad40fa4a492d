"""Real measured data end to end: the parity pipeline against the C1 medium.

The PyTorch twin of examples/measured_medium.py.  The reference can only
trace the four fields hard-coded in its source (RT_bench.py:104-116); here
the input is what a lab has, a grid of measured refractive-index samples,
and the same array feeds two medium families:

* ``rtt.grid_medium_from_samples``: the reference's exact pipeline
  (bilinear n and independently fitted bicubic gradients);
* ``rtt.c1_medium_from_samples``: ONE spline serving n and grad n
  (media/c1.py), 16 floats a cell instead of 36.

A lens-like field "measured" on a coarse grid: the same fan through both
media on the grid kernel (``fast_trace``, engine ``grid``), each scored
against a float64 scan-tier trace of the smooth truth, then the df32
split-word tier (``rtt.df_c1_medium_from_samples``, ``rtt.df_grid_trace``)
against a float64 RK4 of the truth.  The tables are built by the native
library where g++ is present.

Run:  python examples/measured_medium_torch.py [rays] [steps] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

import raytracing_tpu_torch as rtt


def true_field(x, y):
    return 1.0 / (1.0 + 0.4 * x * x + 0.6 * y * y)


def true_grad(x, y):
    """The truth's gradient in closed form (``CustomMedium``'s
    ``grad_fn``): the scan tier's forward-mode gradient costs several
    times more a step."""
    d = 1.0 + 0.4 * x * x + 0.6 * y * y
    k = -1.0 / (d * d)
    return 0.8 * x * k, 1.2 * y * k


def _wait(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rays", nargs="?", type=int, default=1 << 16)
    ap.add_argument("steps", nargs="?", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rays, steps, device = args.rays, args.steps, args.device

    # -- the "measurement": index samples of an unknown lens on a lab grid
    gx = np.linspace(-2.0, 2.0, 161)
    gy = np.linspace(-1.5, 1.5, 121)
    Z = true_field(gx[None, :], gy[:, None])          # what the lab delivers

    parity = rtt.grid_medium_from_samples(Z, gx, gy, device=device)
    c1 = rtt.c1_medium_from_samples(Z, gx, gy, device=device)

    # -- one fan, both media, kernel tier ------------------------------------
    box = (-1.8, 1.8, -1.3, 1.3)
    # a real ScenarioConfig (the engines read box/gamma/is_* off it); the
    # launch fan below overrides pos0/theta0 a call
    scen = dataclasses.replace(rtt.scenario("fisheye"), name="measured",
                               gamma=1.0, box=box)
    pos0 = np.stack([np.full(rays, -1.5, np.float32),
                     np.linspace(-0.6, 0.6, rays).astype(np.float32)], -1)
    theta0 = np.zeros(rays, np.float32)
    ds = np.float32(0.005)

    def run(med, p, th):
        return rtt.fast_trace("op6", scen, med, delta_s=ds, pos0=p,
                              theta0=th, steps=steps, device=device)

    for tag, med in (("parity", parity), ("c1", c1)):
        run(med, pos0, theta0)                  # builds the kernels
        _wait(device)
        t0 = time.perf_counter()
        out = run(med, pos0, theta0)
        _wait(device)
        dt = time.perf_counter() - t0
        print(f"{tag:7s} [{out.engine}]: {rays * steps / dt / 1e9:.2f} G "
              f"ray-steps/s, final x mean "
              f"{float(out.pos[:, 0].mean()):+.4f}")

    # -- accuracy against the smooth truth: float64 scan on a CustomMedium
    truth = rtt.CustomMedium(n_fn=true_field, grad_fn=true_grad)
    # strided subset: the first rays of a linspace fan would all sample one
    # edge of the launch span
    sel = slice(None, None, max(1, rays // 512))
    spos, sth = pos0[sel], theta0[sel]
    ref = rtt.trace("op6", scen, truth, delta_s=float(ds), mode="metrics",
                    dtype=torch.float64, max_size=steps + 1,
                    pos0=spos.astype(np.float64),
                    theta0=sth.astype(np.float64), device=device)
    ref_pos = ref.final.pos.cpu().numpy()
    devs = {}
    for tag, med in (("parity", parity), ("c1", c1)):
        out = run(med, spos, sth)
        devs[tag] = float(np.linalg.norm(out.pos.cpu().numpy() - ref_pos,
                                         axis=1).max())
        print(f"{tag:7s} max trajectory deviation from the true field: "
              f"{devs[tag]:.2e}")

    print("c1 advantage: consistent grad (conservation-grade) and the same "
          "samples track the smooth truth closer — see docs/PARITY.md #29")

    # -- float64-grade: double-word float32 on the same measured samples
    # (engine/df_grid.py), against a float64 RK4 of the smooth truth so that
    # both sides carry the same integrator error
    dfm = rtt.df_c1_medium_from_samples(Z, gx, gy, device=device)
    p = rtt.df_grid_trace(spos, sth, ds, dfm, steps=steps, device=device)
    tru = rtt.trace("op12", scen, truth, delta_s=float(ds), mode="metrics",
                    dtype=torch.float64, max_size=steps + 1,
                    pos0=spos.astype(np.float64),
                    theta0=sth.astype(np.float64), device=device)
    dev = float(np.abs(p.cpu().numpy() - tru.final.pos.cpu().numpy()).max())
    print(f"df32+c1 deviation from an f64 trace of the true field: {dev:.2e} "
          "(pure-f32 arithmetic, medium-limited)")
    return devs, dev


if __name__ == "__main__":
    main()
