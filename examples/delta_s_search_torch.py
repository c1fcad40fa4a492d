"""DELTA_S convergence search, sharded over whatever ranks exist.

The PyTorch twin of examples/delta_s_search.py: the reference's search for
the coarsest passing step (RT_bench.py:1296-1406), every fisheye candidate
divisor, ten turns, op4, with its checkpoint in the working directory.  In
one process it runs through the kernels on a CUDA device (the scan tier on
the CPU, as JAX's on its CPU backend).  Under ``torchrun`` with more than
one process it builds a mesh over the ranks (``make_mesh``), as JAX's
script does over several devices: the candidates are split over the
ranks on the scan tier, every rank selects the same divisor, rank 0 writes
the checkpoint and prints the result.

Run:  python examples/delta_s_search_torch.py [--device cpu]
      torchrun --nproc-per-node N examples/delta_s_search_torch.py
"""
import argparse
import os

import torch
import torch.distributed as dist

import raytracing_tpu_torch as rtt
from raytracing_tpu_torch.parallel.mesh import make_mesh
from raytracing_tpu_torch.parallel.sweep import delta_s_search


def world_size() -> int:
    """The ranks of this run: the process group's, or torchrun's."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    mesh = make_mesh(device=args.device) if world_size() > 1 else None
    res = delta_s_search("op4", scen, med, n_turns=10, dtype=torch.float32,
                         mesh=mesh, checkpoint="fisheye_sweep.npz",
                         device=args.device)
    if mesh is None or dist.get_rank() == 0:
        print(f"swept {len(res.divisors)} candidates; selected divisor "
              f"{res.divisor} -> DELTA_S = {res.delta_s_selected}")
    return res


if __name__ == "__main__":
    main()
