"""A million rays through the Maxwell fisheye via the kernel tier.

The PyTorch twin of examples/million_ray_benchmark.py: 2^20 rays, one
turn of HySA (op6) at op1's calibrated divisor, through the fused CUDA
kernel (``fast_trace``); the second call is timed, after the first built
the kernels.  ``rays`` sizes the batch down for a quick run (on the CPU
the kernel's plain version runs instead).

Run on a GPU host:  python examples/million_ray_benchmark_torch.py [rays] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

import raytracing_tpu_torch as rtt

DIV = 4587                          # op1's calibrated divisor (RT_bench.py:1433)


def _wait(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rays", nargs="?", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    R, device = args.rays, args.device

    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    pos0 = torch.tensor(np.stack([np.ones(R), np.zeros(R)], -1),
                        dtype=torch.float32, device=device)
    theta0 = torch.full((R,), np.pi / 2, dtype=torch.float32, device=device)

    def run():
        return rtt.fast_trace("HySA", scen, med, delta_s=2 * np.pi / DIV,
                              steps=DIV, pos0=pos0, theta0=theta0,
                              device=device)

    run()                           # builds the kernels on first use
    _wait(device)
    t0 = time.perf_counter()
    out = run()
    _wait(device)
    dt = time.perf_counter() - t0

    closure = 100 * np.linalg.norm(out.pos[0].cpu().numpy() - [1, 0]) \
        / (2 * np.pi)
    print(f"{R} rays x {DIV} steps in {dt:.3f}s "
          f"({R * DIV / dt / 1e9:.1f} G ray-steps/s, engine={out.engine})")
    print(f"closure error: {closure:.2e} % of the unit circumference")
    return out, dt, closure


if __name__ == "__main__":
    main()
