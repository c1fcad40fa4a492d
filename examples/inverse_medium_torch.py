"""Inverse problem: recover a medium from observed rays by gradient descent.

The PyTorch twin of examples/inverse_medium.py.  The reference program
(RT_bench.py) is a forward simulator; because the port's integrator is a
torch function of its inputs, the opposite question is a gradient: given
observed ray exits, which medium produced them?

A fan of rays crosses a sigmoid interface of unknown thickness THCK (the
reference's interface profile, RT_bench.py:106-108); the thickness is fitted
by differentiating all 250 op6 steps (HySA, RT_bench.py:602-624) with
respect to it, with ``torch.optim.Adam`` on the medium's parameter and an
exponentially decaying step (optax's ``exponential_decay(0.02, 50, 0.3)``).

Run:  python examples/inverse_medium_torch.py [--device cpu]
"""
import argparse
import math
import time

import numpy as np
import torch

import raytracing_tpu_torch as rtt

TRUE_THCK = 0.12
SQRT2 = math.sqrt(2.0)


def n_fn(thck, x, y):
    """Interface profile with free thickness (RT_bench.py:106-108)."""
    return SQRT2 - (SQRT2 - 1.0) / (1.0 + torch.exp(-y / thck))


def fit(device, iters=150, start=0.2):
    """Fit THCK from the fan's exits; returns (thickness, final loss)."""
    r = 9
    theta0 = torch.tensor(np.linspace(np.pi / 5, np.pi / 2.2, r),
                          device=device)
    pos0 = torch.tensor(np.tile([[-2.0, -1.0]], (r, 1)), device=device)
    ds, steps = 0.02, 250

    def exits(med):
        pos, *_ = rtt.trace_diff("op6", med, pos0, theta0, ds, steps=steps,
                                 device=device)
        return pos

    truth = rtt.ParametricMedium(
        n_fn, torch.tensor(TRUE_THCK, dtype=torch.float64, device=device))
    with torch.no_grad():
        target = exits(truth)
    med = rtt.ParametricMedium(
        n_fn, torch.tensor(start, dtype=torch.float64, device=device))
    opt = torch.optim.Adam(med.parameters(), lr=0.02)
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              lambda t: 0.3 ** (t / 50.0))

    def loss_fn():
        return torch.mean(torch.sum((exits(med) - target) ** 2, dim=-1))

    for i in range(iters):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        if i % 25 == 0:
            print(f"  iter {i:3d}  thck={float(med.params):.6f}  "
                  f"loss={float(loss):.3e}  "
                  f"dloss/dthck={float(med.params.grad):+.3f}")
        opt.step()
        sched.step()
    with torch.no_grad():
        final = float(loss_fn())
    return float(med.params), final


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(f"synthesizing observations at THCK={TRUE_THCK} ...")
    t0 = time.time()
    thck, loss = fit(args.device)
    print(f"recovered THCK = {thck:.6f} (true {TRUE_THCK}) "
          f"in {time.time() - t0:.1f}s: loss {loss:.2e}")


if __name__ == "__main__":
    main()
