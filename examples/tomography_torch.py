"""Travel-time tomography: recover a 2-D index field from crossing rays.

The PyTorch twin of examples/tomography.py: fans of rays cross an unknown
medium from all four sides, their exit travel times and positions are
recorded, and a 12 x 12 grid of n values (144 parameters,
``rtt.parametric_grid_medium``) is reconstructed by gradients through
``rtt.trace_diff`` with a smoothness prior and ``torch.optim.Adam``
(optax's ``exponential_decay(0.01, 200, 0.3)`` step), 600 steps.

Run:  python examples/tomography_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

import raytracing_tpu_torch as rtt

NG = 12                                   # reconstruction grid (NG x NG)
BOX = (-1.0, 1.0, -1.0, 1.0)


def make_fans(m=40):
    """Fans of rays entering from all four sides of the box."""
    t = np.linspace(-0.9, 0.9, m)
    spread = np.linspace(-0.7, 0.7, m)
    srcs = [np.stack([np.full(m, -1.0), t], 1),
            np.stack([t, np.full(m, -1.0)], 1),
            np.stack([np.full(m, 1.0), t], 1),
            np.stack([t, np.full(m, 1.0)], 1)]
    angs = [spread, np.pi / 2 + spread, np.pi + spread, -np.pi / 2 + spread]
    return np.concatenate(srcs), np.concatenate(angs)


def ascii_field(a, lo, hi):
    chars = " .:-=+*#%@"
    q = np.clip((a - lo) / (hi - lo + 1e-12), 0, 0.999)
    return "\n".join("".join(chars[int(v * 10)] for v in row) for row in q)


def truth_grid():
    X, Y = np.meshgrid(np.linspace(-1, 1, NG), np.linspace(-1, 1, NG))
    return 1.0 + 0.15 * np.exp(-((X - 0.2) ** 2 + (Y + 0.1) ** 2) / 0.08)


def reconstruct(device, iters=600, steps=170, ds=0.015):
    """(reconstruction, truth) as numpy (NG, NG) arrays."""
    pos0, th0 = (torch.tensor(a, device=device) for a in make_fans())
    h = 2.0 / (NG - 1)

    def observe(med):
        pos, _, tt, _ = rtt.trace_diff("op6", med, pos0, th0, ds,
                                       steps=steps, box=BOX, device=device)
        return tt, pos

    truth = truth_grid()
    print(f"synthesizing observations: {pos0.shape[0]} rays x {steps} "
          f"steps through the hidden medium ...")
    with torch.no_grad():
        target_tt, target_pos = observe(rtt.parametric_grid_medium(
            truth, -1.0, -1.0, h, h, device=device))
    med = rtt.parametric_grid_medium(np.ones((NG, NG)), -1.0, -1.0, h, h,
                                     device=device)
    opt = torch.optim.Adam(med.parameters(), lr=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              lambda t: 0.3 ** (t / 200.0))
    for i in range(iters):
        opt.zero_grad()
        tt, pos = observe(med)
        grid = med.params
        data = (torch.mean((tt - target_tt) ** 2)
                + torch.mean(torch.sum((pos - target_pos) ** 2, -1)))
        dgx = grid[:, 1:] - grid[:, :-1]
        dgy = grid[1:, :] - grid[:-1, :]
        loss = data + 0.02 * (torch.mean(dgx ** 2) + torch.mean(dgy ** 2))
        loss.backward()
        opt.step()
        sched.step()
        if i % 100 == 0:
            print(f"  iter {i:3d}  loss={float(loss):.3e}")
    return med.params.detach().cpu().numpy(), truth


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    t0 = time.time()
    rec, tr = reconstruct(args.device)
    corr = np.corrcoef((rec - 1).ravel(), (tr - 1).ravel())[0, 1]
    ci = np.corrcoef((rec - 1)[2:-2, 2:-2].ravel(),
                     (tr - 1)[2:-2, 2:-2].ravel())[0, 1]
    lo, hi = tr.min(), tr.max()
    print(f"\ntruth (n in [{lo:.2f}, {hi:.2f}]):")
    print(ascii_field(tr, lo, hi))
    print("\nreconstruction:")
    print(ascii_field(rec, lo, hi))
    print(f"\ncorrelation {corr:.3f} (interior {ci:.3f}) "
          f"in {time.time() - t0:.1f}s / 600 Adam steps")


if __name__ == "__main__":
    main()
