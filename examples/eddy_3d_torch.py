"""Horizontal refraction by an ocean eddy — tracing the reference cannot do.

The PyTorch twin of examples/eddy_3d.py.  A 2-D tracer confines rays to a
vertical plane; a mesoscale eddy is a sound-speed anomaly in (x, z) that
bends paths out of their launch plane.  The same fan goes twice through a
Munk-style channel, once purely stratified and once with a warm eddy beside
the track (``rtt.trace3d`` at float64, engine/trace3d.py):

* stratified control: z stays identically zero and the horizontal
  slowness azimuth is conserved to roundoff (the 3-D conservation oracle);
* with the eddy: rays near it deflect by kilometers in z, arrive at
  other depths, and the azimuth invariant breaks.

Then the axial ray's spreading TL with and without the eddy
(``rtt.trace_dynamic3``), and the same eddy from raw 3-D samples
(``rtt.c1_medium3_from_samples``) against the analytic field.

Run:  python examples/eddy_3d_torch.py [rays] [steps] [--device cpu]
"""
import argparse

import numpy as np
import torch

import raytracing_tpu_torch as rtt


def c_munk(y):
    eta = 2.0 * (y + 1.0)
    return 1.49 * (1.0 + 0.0057 * (eta - 1.0 + torch.exp(-eta)))


def n_munk(y):
    return 1.445 / c_munk(y)          # slowness, ~1 at the axis


def dn_munk(y):
    """d n_munk / dy in closed form."""
    c = c_munk(y)
    dc = 1.49 * 0.0057 * 2.0 * (1.0 - torch.exp(-2.0 * (y + 1.0)))
    return -1.445 * dc / (c * c)


EDDY = dict(x0=20.0, z0=3.0, L=4.0, eps=-4e-3)   # warm core: faster sound


def _bump(x, z):
    dx, dz = x - EDDY["x0"], z - EDDY["z0"]
    return torch.exp(-(dx * dx + dz * dz) / (EDDY["L"] * EDDY["L"])), dx, dz


def n_eddy(x, y, z):
    return n_munk(y) * (1.0 + EDDY["eps"] * _bump(x, z)[0])


def grad_eddy(x, y, z):
    b, dx, dz = _bump(x, z)
    k = n_munk(y) * EDDY["eps"] * b * (-2.0 / (EDDY["L"] * EDDY["L"]))
    return k * dx, dn_munk(y) * (1.0 + EDDY["eps"] * b), k * dz


def grad_control(x, y, z):
    zero = torch.zeros_like(x)
    return zero, dn_munk(y) + zero, zero


def _np(t):
    return t.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rays", nargs="?", type=int, default=64)
    ap.add_argument("steps", nargs="?", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rays, steps, device = args.rays, args.steps, args.device
    f64 = dict(dtype=torch.float64, device=device)

    # the gradients in closed form (``Custom3D``'s ``grad_fn``): the scan
    # tier's forward-mode gradient of these fields costs ~4x more a step
    control = rtt.Custom3D(lambda x, y, z: n_munk(y) + 0.0 * x + 0.0 * z,
                           grad_control)
    with_eddy = rtt.Custom3D(n_eddy, grad_eddy)

    # fan: source on the channel axis, launch along +x with vertical spread
    tilt = np.linspace(-0.1, 0.1, rays)
    pos0 = np.tile([[0.0, -1.0, 0.0]], (rays, 1))
    dir0 = np.stack([np.cos(tilt), np.sin(tilt), np.zeros(rays)], -1)
    ds = 0.015                                            # 15 m arc steps
    box = (-1.0, 60.0, -3.0, 0.0, -30.0, 30.0)

    ctl = rtt.trace3d("op6", control, pos0=pos0, dir0=dir0, delta_s=ds,
                      steps=steps, box=box, mode="metrics", stats=True, **f64)
    edd = rtt.trace3d("op6", with_eddy, pos0=pos0, dir0=dir0, delta_s=ds,
                      steps=steps, box=box, mode="metrics", **f64)

    pc, pe = _np(ctl.final.pos), _np(edd.final.pos)
    ue = _np(edd.final.unitv)

    z_ctl = np.abs(pc[:, 2]).max()
    z_edd = np.abs(pe[:, 2]).max()
    az_edd = np.abs(np.arctan2(ue[:, 2], ue[:, 0])).max()
    cv = ctl.horizontal_slowness_cv_pct()
    dz_depth = np.abs(pe[:, 1] - pc[:, 1]).max()

    rng = pc[:, 0].max()
    print(f"Munk channel, {rays}-ray fan, {steps} x {ds * 1e3:.0f} m steps "
          f"(~{rng:.0f} km range)")
    print(f"stratified control : max |z| = {z_ctl:.2e} km (planar), "
          f"slowness CV <= {np.nanmax(cv):.2e} %")
    print(f"with eddy          : max |z| = {z_edd:.3f} km out-of-plane, "
          f"azimuth deflection up to {np.degrees(az_edd):.3f} deg")
    print(f"arrival depth shift: up to {dz_depth * 1e3:.0f} m")

    assert z_ctl < 1e-12, "control must stay in its launch plane"
    assert np.nanmax(cv) < 0.05, "3-D conservation oracle (stratified)"
    assert z_edd > 0.05, "the eddy must push rays visibly out of plane"
    # the shift depends on where the fan's depth-cycle phase lands at the
    # box exit, so the bar is "clearly nonzero", not a fixed magnitude
    assert dz_depth > 3e-4, "eddy changes vertical arrival structure"

    # -- the field-level payoff: the eddy refocuses energy (the exact 2x2
    # paraxial Jacobian -> spherical-spreading TL along the ray) ----------
    tl = {}
    for name, m in (("control", control), ("eddy", with_eddy)):
        dres = rtt.trace_dynamic3("op6", m, pos0=[[0.0, -1.0, 0.0]],
                                  dir0=[[1.0, 0.0, 0.0]], delta_s=ds,
                                  steps=steps, box=box, mode="metrics", **f64)
        tl[name] = float(_np(dres.transmission_loss_db())[0])
    print(f"axial-ray TL at {rng:.0f} km: control {tl['control']:.2f} dB, "
          f"with eddy {tl['eddy']:.2f} dB "
          f"(focusing shift {tl['control'] - tl['eddy']:+.2f} dB)")
    assert np.isfinite(tl["eddy"]) and abs(tl["control"] - tl["eddy"]) > 1e-4

    # -- the measured-field story: the same eddy from RAW 3-D SAMPLES, as
    # tri-Hermite tables (media/grid3.py), against the analytic trace: the
    # 3-D form of the reference's sample -> fit -> trace pipeline
    # (RT_bench.py:412-464)
    gx = np.linspace(10.0, 30.0, 51)          # 0.4 km pitch across the eddy
    gy = np.linspace(-3.0, 0.0, 61)           # 50 m pitch down the channel
    gz = np.linspace(-10.0, 10.0, 51)
    Zg, Yg, Xg = np.meshgrid(gz, gy, gx, indexing="ij")
    F = _np(n_eddy(torch.as_tensor(Xg), torch.as_tensor(Yg),
                   torch.as_tensor(Zg)))
    sampled = rtt.c1_medium3_from_samples(F, gx, gy, gz, **f64)

    seg_steps = 1100                           # ~16.5 km inside the grid
    pos0s = np.tile([[12.0, -1.0, 0.0]], (rays, 1))
    box_s = (10.2, 29.8, -3.0, 0.0, -9.8, 9.8)
    smp = rtt.trace3d("op6", sampled, pos0=pos0s, dir0=dir0, delta_s=ds,
                      steps=seg_steps, box=box_s, mode="metrics", **f64)
    ana = rtt.trace3d("op6", with_eddy, pos0=pos0s, dir0=dir0, delta_s=ds,
                      steps=seg_steps, box=box_s, mode="metrics", **f64)
    ps, pa = _np(smp.final.pos), _np(ana.final.pos)
    dev = np.abs(ps - pa).max()
    z_smp = np.abs(ps[:, 2]).max()
    print(f"from raw samples   : max |z| = {z_smp:.3f} km out-of-plane, "
          f"max deviation vs analytic = {dev * 1e3:.2f} m over "
          f"{seg_steps * ds:.0f} km")
    assert z_smp > 0.02, "sampled eddy must still deflect out of plane"
    assert dev < 2e-3, f"sampled medium must track the analytic field ({dev})"
    print("ok")
    return {"z_ctl": z_ctl, "z_edd": z_edd, "tl": tl, "dev": dev}


if __name__ == "__main__":
    main()
