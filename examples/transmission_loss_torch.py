"""Transmission loss against range in a SOFAR channel: the sonar product.

The PyTorch twin of examples/transmission_loss.py.  The reference stops at
ray geometry (RT_bench.py:964-1197); an acoustician's deliverable is the
field: at each hydrophone, which ray paths arrive, when, how strong, and
what the coherent interference does to the received level.  From a
measured sound-speed profile:

1. measured c(z) samples -> a consistent-gradient C1 medium in float64
   (``rtt.c1_stratified_from_samples``);
2. ``rtt.find_eigenrays``: one dynamic fan trace shared by every receiver,
   then a batched paraxial-Newton polish for every arrival at every range;
3. per-arrival travel time, amplitude and KMAH caustic phase ->
   ``rtt.incoherent_tl`` and ``rtt.coherent_tl`` a receiver.

Eigenray work is float64 end to end, on ``--device`` (the card has float64).

Run:  python examples/transmission_loss_torch.py [n_ranges] [n_fan] [--device cpu]
"""
import argparse

import numpy as np
import torch

import raytracing_tpu_torch as rtt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranges", nargs="?", type=int, default=8)
    ap.add_argument("n_fan", nargs="?", type=int, default=192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_ranges, n_fan = args.n_ranges, args.n_fan

    # -- measured Munk-style profile (the lab data of ocean_waveguide) -------
    depth = np.linspace(-3.0, 0.0, 121)                       # km, 0 = surface
    eta = 2.0 * (depth + 1.0)                                 # axis at -1 km
    c = 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))    # km/s
    n_samples = c.min() / c
    # float64 tables: the eigenray Newton converges to the landing curve's
    # noise floor, and float32 coefficient tables put that floor at ~1e-5
    # km (10 m of receiver miss)
    medium = rtt.c1_stratified_from_samples(n_samples, depth,
                                            dtype=torch.float64,
                                            device=args.device)

    # -- source on the channel axis; receiver line at axis depth ------------
    source = (0.0, -1.0)
    ranges = np.linspace(5.0, 40.0, n_ranges)                 # km
    receivers = np.stack([ranges, np.full(n_ranges, -1.0)], -1)

    ds = 0.01                                                 # 10 m arc steps
    max_size = int(ranges.max() / ds * 1.2)
    eig = rtt.find_eigenrays(
        "op6", medium, source=source, receivers=receivers, delta_s=ds,
        max_size=max_size, box=(-1.0, ranges.max() + 2.0, -3.0, 0.0),
        fan=(-0.21, 0.21, n_fan), tol=1e-9, device=args.device)

    freq_hz = 50.0
    # traveltime is in seconds once multiplied by 1/c0 (n is normalized
    # slowness c_min/c, so optical path / c_min = time); fold c_min in here
    omega = 2.0 * np.pi * freq_hz / float(c.min())
    itl = rtt.incoherent_tl(eig, n_receivers=n_ranges)
    ctl = rtt.coherent_tl(eig, omega, n_receivers=n_ranges)

    print(f"SOFAR transmission loss, source on axis, f = {freq_hz:g} Hz")
    print(f"{'range km':>9} {'paths':>6} {'first tau s':>12} {'spread ms':>10} "
          f"{'TL incoh dB':>12} {'TL coh dB':>10} {'max kmah':>9}")
    for i, r in enumerate(ranges):
        e = eig.for_receiver(i)
        tau = np.asarray(e.traveltime) / float(c.min())
        spread = 1e3 * (tau.max() - tau.min()) if len(tau) else np.nan
        first = tau.min() if len(tau) else np.nan
        km = int(np.asarray(e.kmah).max()) if len(tau) else -1
        print(f"{r:9.1f} {len(tau):6d} {first:12.4f} {spread:10.2f} "
              f"{itl[i]:12.2f} {ctl[i]:10.2f} {km:9d}")

    n_arrivals = len(np.asarray(eig.theta0))
    assert n_arrivals >= n_ranges, "every range should collect arrivals"
    assert bool(np.all(np.asarray(eig.converged))), "all arrivals converged"
    assert np.all(np.isfinite(itl)), "incoherent TL finite at every range"
    # channel trapping: TL grows far SLOWER than the 10 log10 r of free
    # cylindrical spreading; that is what the waveguide is for
    free = 10 * np.log10(ranges / ranges[0])
    trapped = itl - itl[0]
    assert trapped[-1] < free[-1], (trapped[-1], free[-1])
    print(f"arrivals: {n_arrivals}; TL growth over {ranges[0]:g}->"
          f"{ranges[-1]:g} km: {trapped[-1]:.2f} dB (free cylindrical would "
          f"be {free[-1]:.2f} dB)")
    print("ok")
    return eig, itl, ctl


if __name__ == "__main__":
    main()
