"""The port's df32 traces on the split-word sampled media against the float64
scan tier on the same splines, at the JAX package's own bars
(tests/test_df_grid.py:54-69, :84-109, :112-146, :162-187).  The df32
arithmetic carries float32 to double-word grade: the trajectory agrees
with the float64 op12 trace of the same interpolant; on the C1 spline it
also closes on the analytic fisheye's circle.  The parity fisheye grid is
the coarse one (0.05) of test_torch_df_grid.py, the C1 one the
reference's."""
import dataclasses

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.media.medium import CustomMedium  # noqa: E402

DELTA = 0.05
F64 = dict(device="cpu", dtype=torch.float64)


def _scan(scen, medium, ds, steps, pos0, theta0):
    res = rtt.trace("op12", scen, medium, delta_s=ds, max_size=steps + 1,
                    mode="metrics", dtype=torch.float64, pos0=pos0,
                    theta0=theta0, device="cpu")
    return H.to_np(res.final.pos)


def _fisheye_samples(scen, delta=DELTA):
    from raytracing_tpu_torch.media import grid
    x, y, Z = grid.gen_grid("fisheye", scen.box, delta)
    return Z, x, y


def test_parity_grid_matches_f64_scan():
    """One fisheye turn (divisor 1000) on the parity tables: within 1e-6 of
    the float64 scan on the same GridMedium."""
    scen = rtt.scenario("fisheye")
    div = 1000
    ds = float(np.float32(2 * np.pi / div))
    pos0, theta0 = H.fisheye_df_fan(4)
    med = rtt.df_grid_medium_from_samples(
        *_fisheye_samples(scen), gradient_spacing=DELTA, device="cpu")
    p = H.to_np(rtt.df_grid_trace(pos0, theta0, ds, med, steps=div,
                                  device="cpu"))
    ref = _scan(scen, rtt.build_grid_medium("fisheye", scen.box, DELTA,
                                            **F64), ds, div, pos0, theta0)
    assert np.linalg.norm(p[0] - ref[0]) < 1e-6


def test_c1_grid_closes_on_the_circle_and_matches_f64():
    """One turn at divisor 300 on the C1 spline of the reference's grid
    (DELTA, 511 x 511 nodes: its O(h^4) fit error is what the circle
    sees): within 5e-7 of the analytic circle and of the float64 scan on
    the same C1 medium."""
    scen = rtt.scenario("fisheye")
    div = 300
    ds = 2 * np.pi / div
    pos0, theta0 = H.fisheye_df_fan(4)
    med = rtt.df_c1_medium_from_samples(
        *_fisheye_samples(scen, rtt.config.DELTA), device="cpu")
    p = H.to_np(rtt.df_grid_trace(pos0, theta0, np.float32(ds), med,
                                  steps=div, device="cpu"))
    sarc = div * float(np.float32(ds))
    assert np.linalg.norm(p[0] - [np.cos(sarc), np.sin(sarc)]) < 5e-7
    ref = _scan(scen, rtt.build_c1_medium("fisheye", scen.box, **F64), ds,
                div, pos0, theta0)
    assert np.abs(p - ref).max() < 5e-7


def test_user_samples_are_an_f64_substitute():
    """User-measured samples (examples/measured_medium.py's configuration):
    within 1e-7 of the float64 scan of the same C1 interpolant, and within
    5e-6 of the smooth truth the samples came from."""
    def f(x, y):
        return 1.0 / (1.0 + 0.4 * x * x + 0.6 * y * y)

    gx = np.linspace(-2.0, 2.0, 161)
    gy = np.linspace(-1.5, 1.5, 121)
    Z = f(gx[None, :], gy[:, None])
    med = rtt.df_c1_medium_from_samples(Z, gx, gy, device="cpu")
    r, steps, ds = 4, 600, float(np.float32(0.005))
    pos0 = np.stack([np.full(r, -1.5), np.linspace(-0.05, 0.05, r)], -1)
    theta0 = np.zeros(r)
    p = H.to_np(rtt.df_grid_trace(pos0, theta0, np.float32(ds), med,
                                  steps=steps, device="cpu"))
    scen = dataclasses.replace(rtt.scenario("fisheye"), name="measured",
                               gamma=1.0, box=(-1.8, 1.8, -1.3, 1.3))
    ref = _scan(scen, rtt.c1_medium_from_samples(Z, gx, gy, **F64), ds,
                steps, pos0, theta0)
    assert np.abs(p - ref).max() < 1e-7

    def g(x, y):
        d = 1.0 + 0.4 * x * x + 0.6 * y * y
        return -0.8 * x / (d * d), -1.2 * y / (d * d)

    tru = _scan(scen, CustomMedium(n_fn=f, grad_fn=g), ds, steps, pos0,
                theta0)
    assert np.abs(p - tru).max() < 5e-6


def test_profile_matches_f64_scan():
    """A measured 1-D channel profile over a long waveguide trace (1500
    steps at 0.01): within 2e-7 of the float64 scan of the same C1
    profile."""
    y = np.linspace(-1.5, 1.5, 61)
    col = 1.2 - 0.25 * y * y
    med = rtt.df_c1_profile_from_samples(col, y, device="cpu")
    r, steps, ds = 4, 1500, float(np.float32(0.01))
    pos0 = np.stack([np.zeros(r), np.linspace(-0.1, 0.1, r)], -1)
    theta0 = np.full(r, 0.3)
    p = H.to_np(rtt.df_grid_trace(pos0, theta0, np.float32(ds), med,
                                  steps=steps, device="cpu"))
    scen = dataclasses.replace(rtt.scenario("vert"), name="profile",
                               gamma=1.0, box=(-1e6, 1e6, -1.5, 1.5))
    ref = _scan(scen, rtt.c1_stratified_from_samples(col, y, **F64), ds,
                steps, pos0, theta0)
    assert np.abs(p - ref).max() < 2e-7
