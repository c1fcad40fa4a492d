"""Production tracing through the reference's sampled-spline media.

The PyTorch twin of examples/sampled_medium_production.py.  The reference's
hot loop evaluates FITPACK splines of a sampled grid three times per step
(RT_bench.py:435-464, 141-156); here the same sampled medium runs through
the hand-written CUDA kernels, with the physics oracle computed from the
same kernel outputs.

Shows: 1-D stratified tables (interface, ``models.get``) at kernel speed,
the kernel-tier DELTA_S search on the sampled medium, the exact 2-D
fisheye spline through the grid kernel, and the DELTA_S search on that
2-D spline (one candidate a warp, ``fused_sweep_grid``).

Run:  python examples/sampled_medium_production_torch.py [rays] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

import raytracing_tpu_torch as rtt
from raytracing_tpu_torch import models
from raytracing_tpu_torch.parallel.sweep import delta_s_search


def _wait(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(rays: int, device: str):
    # 1. interface on the sampled 1-D tables at the calibrated HySA step
    model = models.get("interface", medium="stratified", device=device)
    scen = model.scenario
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), rays)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (rays, 1))
    model.run("HySA", pos0=pos0, theta0=theta0)      # the library's first use
    _wait(device)
    t0 = time.perf_counter()
    out = model.run("HySA", pos0=pos0, theta0=theta0)
    _wait(device)
    dt = time.perf_counter() - t0
    ds, _ = model.delta_s("HySA")
    steps = scen.max_size(ds) - 1
    print(f"interface sampled medium [{out.engine}]: "
          f"{rays * steps / dt / 1e9:.2f} G ray-steps/s on {device}")

    # 2. kernel-tier DELTA_S search on the sampled medium (the reference's
    #    executor.map sweep, RT_bench.py:1296-1406); on the CPU the
    #    kernels' plain versions
    t0 = time.perf_counter()
    sr = delta_s_search("op8", scen, model.medium, engine="fused",
                        device=device)
    dt = time.perf_counter() - t0
    print(f"DELTA_S search (op8, sampled interface): divisor SIGMA/"
          f"{sr.divisor}, {len(sr.divisors)} candidates in {dt:.0f}s")

    # 3. the exact 2-D fisheye spline through the grid kernel
    fscen = rtt.scenario("fisheye")
    hm = rtt.build_hermite_medium(rtt.build_grid_medium(
        "fisheye", fscen.box, device=device))
    r2 = min(rays, 65536)
    p0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r2, 1))
    th = np.full(r2, np.pi / 2, np.float32)
    div = 1200
    g = rtt.fast_trace("op6", fscen, hm, delta_s=2 * np.pi / div, steps=div,
                       pos0=p0, theta0=th, device=device)
    pos = g.pos.cpu().numpy()
    clo = 100 * np.linalg.norm(pos[0] - [1, 0]) / (2 * np.pi)
    print(f"fisheye 2-D spline [{g.engine}]: closure {clo:.4f} % after one "
          "turn")

    # 4. DELTA_S search on the 2-D spline, the medium the reference
    #    calibrates on
    t0 = time.perf_counter()
    sr = delta_s_search("op1", fscen, hm, engine="fused", device=device)
    dt = time.perf_counter() - t0
    print(f"DELTA_S search (op1, 2-D fisheye spline): divisor {sr.divisor}, "
          f"{len(sr.divisors)} candidates in {dt:.0f}s")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rays", nargs="?", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.rays, args.device)
