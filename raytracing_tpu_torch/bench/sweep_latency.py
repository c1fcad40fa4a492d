"""How much of the candidate sweep's time is one candidate's serial chain.

    python -m raytracing_tpu_torch.bench.sweep_latency [--reps 5]

Needs one CUDA device and nvcc.  Times ``fused_sweep_grid`` (PERF.md row 6)
on the fisheye search's candidate grid (:func:`~raytracing_tpu_torch.bench.
sweep_inputs`: 300 candidates, one ray each, op1 on the parity fisheye
grid, up to 3039 steps) in four layouts of the same launch state:

* ``packed``: the 300 candidates as the search launches them;
* ``alone``: the longest candidate alone, one ray: the sweep's serial
  latency, the least time any layout of the 300 can take;
* ``one a warp``: each candidate on lane 0 of a warp of its own (ray 32 c),
  the other 31 lanes frozen rays that store their state and leave;
* ``one a block``: each candidate on lane 0 of a 128-ray block of its own
  (ray 128 c), so that the candidates spread over the SMs.

The padding rays are copies of their candidate with ``active`` false, so
every layout's candidates compute what they compute packed.  The padded
layouts tell how far spreading the candidates helps a kernel that runs one
ray a thread (the sweep's loop before it had a kernel of its own); on a
build whose ``fused_sweep_grid`` already gives each candidate a warp
(``sweep_kernel``), every padding ray gets a warp too.  Each layout's
candidate positions are checked against the packed run's, to the bit.  It
makes four passes in the order A, B, B, A (A the packed layout first, B
the other three), each printing the card's name, power limit, SM clock,
power draw and temperature and, for every layout, the median of ``--reps``
timings (CUDA events around a CUDA graph of launches, as
``fma_probe.time_ms`` times a run under 2 ms).
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from raytracing_tpu_torch.bench import sweep_inputs
from raytracing_tpu_torch.bench.fma_probe import smi, time_ms
from raytracing_tpu_torch.kernels import fused as kfu

#: the padded layouts: rays a candidate's slot holds
STRIDES = {"one a warp": 32, "one a block": 128}


def layouts(device):
    """{layout: (run, candidate rows of its output)}; run() returns the
    output state's (x, y) planes."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine import fast
    from raytracing_tpu_torch.engine import segmented as seg

    scen, _, pos0, theta0, ds, lim = sweep_inputs(device)
    steps = int(lim.max())
    box = tuple(scen.box)
    cells = seg.grid_tables(fast._as_hermite(rtt.build_grid_medium(
        "fisheye", scen.box, device=device)))

    def make(idx, stride):
        n = len(idx) * stride
        rows = torch.arange(len(idx), device=device) * stride
        p = np.repeat(pos0[idx], stride, axis=0)
        t = np.repeat(theta0[idx], stride)
        st = kfu.initial_state("op1", p, t, field=cells, with_stats=False,
                               device=device)
        act = torch.zeros(n, dtype=torch.bool, device=device)
        act[rows] = True
        st = st._replace(active=act & st.active)
        d = ds[idx].repeat_interleave(stride).contiguous()
        m = lim[idx].repeat_interleave(stride).contiguous()

        def run():
            out = kfu.fused_sweep_grid(st, d, m, field=cells, op="op1",
                                       steps=steps, box=box)
            return torch.stack([out.x, out.y], -1)
        return run, rows

    every = np.arange(len(ds))
    longest = int(torch.argmax(lim).item())
    out = {"packed": make(every, 1), "alone": make(np.array([longest]), 1)}
    for name, stride in STRIDES.items():
        out[name] = make(every, stride)
    return out, longest, steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_latency: needs a CUDA device")
    runs, longest, steps = layouts("cuda")
    print(f"fused_sweep_grid op1 fisheye search: longest candidate "
          f"{longest}, {steps} steps", flush=True)
    ref = None
    others = [k for k in runs if k != "packed"]
    for p, order in enumerate((["packed"], others, others[::-1],
                               ["packed"])):
        print(smi(), flush=True)
        for name in order:
            run, rows = runs[name]
            times, pos, batch = time_ms(run, args.reps)
            got = pos[rows]
            if ref is None:
                ref = got
            want = ref[longest:longest + 1] if name == "alone" else ref
            if not torch.equal(got, want):
                raise SystemExit(f"sweep_latency: {name} differs from packed")
            print(f"pass {p} {name}: median {statistics.median(times):.4f} "
                  f"ms runs {[round(t, 4) for t in times]} (graphs of "
                  f"{batch} launches)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
