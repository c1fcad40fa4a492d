"""DELTA_S convergence search on one device.

The PyTorch twin of examples/delta_s_search.py: the reference's search for
the coarsest passing step (RT_bench.py:1296-1406), every fisheye candidate
divisor at once, ten turns, op4, through the kernels on a CUDA device (the
scan tier on the CPU, as JAX's on its CPU backend), with its checkpoint in
the working directory.  JAX's
script shards the candidates over a mesh when it has several devices; on
one device it passes no mesh, as this one does.

Run:  python examples/delta_s_search_torch.py [--device cpu]
"""
import argparse

import torch

import raytracing_tpu_torch as rtt
from raytracing_tpu_torch.parallel.sweep import delta_s_search


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    res = delta_s_search("op4", scen, med, n_turns=10, dtype=torch.float32,
                         checkpoint="fisheye_sweep.npz", device=args.device)
    print(f"swept {len(res.divisors)} candidates; "
          f"selected divisor {res.divisor} -> DELTA_S = {res.delta_s_selected}")
    return res


if __name__ == "__main__":
    main()
