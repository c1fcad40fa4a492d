"""A measured sound-speed profile end to end: the SOFAR-channel waveguide.

The PyTorch twin of examples/ocean_waveguide.py.  The input is what a lab
has: a 1-D sound-speed-vs-depth profile measured at discrete depths (a
Munk-style SOFAR channel, a sound-speed minimum that traps rays into
cycling paths).  One array of samples drives the whole stack:

* ``rtt.c1_stratified_from_samples``: the conservation-grade profile
  medium (4 floats a cell on the kernel tier);
* ``fast_trace``: the fused stratified kernel (``fused_step_strat``);
* the momentum oracle: in an x-independent medium p_x = n cos(theta) is
  an exact invariant, so CV(p_x) from the kernel's Welford tracker
  measures integration truth;
* ``rtt.parametric_profile_medium`` with ``rtt.trace_diff``: the same
  profile as parameters, one backward pass giving the 1-D tomography
  adjoint.

Run:  python examples/ocean_waveguide_torch.py [rays] [steps] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

import raytracing_tpu_torch as rtt
from raytracing_tpu_torch.engine.oracles import (momentum_cv_pct_from_welford,
                                                 momentum_cv_summary)


def _wait(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rays", nargs="?", type=int, default=1 << 16)
    ap.add_argument("steps", nargs="?", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rays, steps, device = args.rays, args.steps, args.device

    # -- the "measurement": sound speed c(z), Munk-like, n = c0 / c ---------
    # depth axis y in km, 0 = surface, -3 = bottom; channel axis at -1 km
    depth = np.linspace(-3.0, 0.0, 121)
    eta = 2.0 * (depth + 1.0)             # scaled distance from the axis
    c = 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))   # km/s
    n_samples = c.min() / c               # slowness, normalized to max 1

    medium = rtt.c1_stratified_from_samples(n_samples, depth, device=device)

    # -- a source on the channel axis, fan of launch angles -----------------
    box = (-1e6, 1e6, -3.0, 0.0)          # the waveguide never ends in x
    ds = np.float32(0.002)                # 2 m arc steps
    theta0 = np.linspace(-0.12, 0.12, rays).astype(np.float32)  # +-7 degrees
    pos0 = np.stack([np.zeros(rays, np.float32),
                     np.full(rays, -1.0, np.float32)], -1)
    scen = dataclasses.replace(rtt.scenario("vert"), name="sofar",
                               gamma=1.0, box=box)
    kw = dict(delta_s=ds, pos0=pos0, theta0=theta0, steps=steps,
              device=device)

    rtt.fast_trace("op6", scen, medium, **kw)        # builds the kernels
    _wait(device)
    t0 = time.perf_counter()
    out = rtt.fast_trace("op6", scen, medium, **kw)
    _wait(device)
    dt = time.perf_counter() - t0
    pos = out.pos.cpu().numpy()
    print(f"{rays} rays x {steps} steps [{out.engine}]: "
          f"{rays * steps / dt / 1e9:.2f} G ray-steps/s")
    trapped = " — trapped in the channel" if pos[:, 1].min() > -2.9 else ""
    print(f"range reached: {pos[:, 0].mean():.3f} km mean "
          f"(max {pos[:, 0].max():.3f}); depth spread "
          f"[{pos[:, 1].min():+.3f}, {pos[:, 1].max():+.3f}] km{trapped}")

    # -- physics: p_x is exact in a stratified medium: the full batch's CV
    # from the kernel's Welford tracker (fast_trace(stats=True)) -----------
    st = rtt.fast_trace("op6", scen, medium, stats=True, **kw)
    cv_mean, cv_max, _ = momentum_cv_summary(
        momentum_cv_pct_from_welford(st.mom_count, st.mom_mean, st.mom_m2))
    print(f"momentum conservation CV(p_x), full {rays}-ray batch: "
          f"mean {cv_mean:.2e} % / max {cv_max:.2e} %")

    # -- inversion teaser: the adjoint with respect to the measured samples
    hy = float(depth[1] - depth[0])
    sel = slice(None, None, max(1, rays // 8))
    profile = torch.tensor(n_samples, dtype=torch.float32, device=device,
                           requires_grad=True)
    m = rtt.parametric_profile_medium(profile, float(depth[0]), hy,
                                      device=device)
    p = rtt.trace_diff("op6", m, pos0[sel], theta0[sel], np.float32(0.01),
                       steps=200, box=box, device=device).pos
    loss = torch.sum(p[:, 1] ** 2)          # e.g. fit observed depths
    (g,) = torch.autograd.grad(loss, profile)
    nz = int((g.abs() > 0).sum())
    print(f"tomography adjoint: d(loss)/d(samples) touches {nz}/{len(depth)} "
          "depth samples (one backward pass through the integrator)")
    return pos, (cv_mean, cv_max), nz


if __name__ == "__main__":
    main()
