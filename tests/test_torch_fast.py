"""The port's fast_trace against the JAX fast_trace (Pallas kernels in
interpret mode) on all four scenarios, with s_max cut so each run is a few
hundred steps; and its routing and refusals."""
import dataclasses

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine.fast import fast_trace as jfast  # noqa: E402
from raytracing_tpu.kernels import fused as jfused  # noqa: E402
from raytracing_tpu.kernels import golden as jgold  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.kernels.golden import GOLDEN_OPS  # noqa: E402

# (scenario, op, delta_s, divisor, s_max, box or None, pos tolerance)
CASES = [
    ("interface", "op6", 0.02, None, 3.0, None, 1e-5),
    ("interface", "op9", 0.02, None, 3.0, None, 5e-4),
    ("fisheye", "op1", 2 * np.pi / 60, 60, None, None, 1e-5),
    ("fisheye", "op10n", 2 * np.pi / 60, 60, None, None, 5e-4),
    ("vert", "op8", 0.05, None, 8.0, H.VERT_BOX, 1e-5),
    ("vert", "op7", 0.05, None, 8.0, H.VERT_BOX, 2e-4),
    ("vert", "op5", 0.05, None, 8.0, H.VERT_BOX, 5e-4),
    ("aniso", "op11", 0.05, None, 8.0, H.VERT_BOX, 5e-4),
]


def _scen(pkg, name, s_max, box):
    kw = {}
    if s_max is not None:
        kw["s_max"] = s_max
    if box is not None:
        kw["box"] = box
    return dataclasses.replace(pkg.scenario(name), **kw)


@pytest.mark.parametrize("name,op,ds,divisor,s_max,box,tol", CASES)
def test_fast_trace_matches_jax(name, op, ds, divisor, s_max, box, tol):
    js = _scen(rt, name, s_max, box)
    ts = _scen(rtt, name, s_max, box)
    pos0 = np.asarray(js.pos0, np.float32)
    theta0 = np.asarray(js.theta0, np.float32)
    if name == "fisheye":   # one ray, duplicated
        pos0, theta0 = np.tile(pos0, (2, 1)), np.tile(theta0, 2)
    kw = dict(delta_s=np.float32(ds), pos0=pos0, theta0=theta0,
              divisor=None if divisor is None else divisor + 1, n_turns=1)
    j = jfast(op, js, rt.analytic_medium(js.field), block_rays=128,
              interpret=True, **kw)
    t = rtt.fast_trace(op, ts, rtt.analytic_medium(ts.field), device="cpu",
                       **kw)
    assert t.engine == ("golden" if op in GOLDEN_OPS else "fused")
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=tol)
    np.testing.assert_allclose(H.to_np(t.traveltime), np.asarray(j.traveltime),
                               atol=5e-4 if tol == 5e-4 else 5e-5)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))
    if box is not None:
        assert not H.to_np(t.active).all()      # rays left the box


def test_fast_trace_stats_on_x_independent_field():
    """stats=True rides the kernel's Welford tracker; on the analytic vert
    field it equals the JAX kernel's tracker."""
    scen = _scen(rtt, "vert", 8.0, H.VERT_BOX)
    pos0 = np.asarray(scen.pos0, np.float32)
    theta0 = np.asarray(scen.theta0, np.float32)
    t = rtt.fast_trace("op8", scen, rtt.analytic_medium(scen.field),
                       delta_s=np.float32(0.05), pos0=pos0, theta0=theta0,
                       stats=True, device="cpu")
    steps = scen.max_size(0.05) - 1
    pad = (-len(theta0)) % 128
    j = jfused.fused_trace_final(
        np.concatenate([pos0, np.tile(pos0[-1:], (pad, 1))]),
        np.concatenate([theta0, np.tile(theta0[-1:], pad)]),
        np.float32(0.05), field=scen.field, op="op8", steps=steps,
        box=scen.box, block_rays=128, interpret=True, with_stats=True)
    r = len(theta0)
    for name in ("mom_count", "mom_mean", "mom_m2"):
        np.testing.assert_allclose(H.to_np(getattr(t, name)),
                                   np.asarray(getattr(j, name))[:r],
                                   atol=1e-6, err_msg=name)
    ascen = _scen(rtt, "aniso", 2.0, H.VERT_BOX)
    g = rtt.fast_trace("op11", ascen, rtt.analytic_medium(ascen.field),
                       delta_s=np.float32(0.05), pos0=pos0, theta0=theta0,
                       stats=True, device="cpu")
    jg = jgold.golden_trace_final(
        np.concatenate([pos0, np.tile(pos0[-1:], (pad, 1))]),
        np.concatenate([theta0, np.tile(theta0[-1:], pad)]),
        np.float32(0.05), np.float32(3.0), field=ascen.field, op="op11",
        steps=ascen.max_size(0.05) - 1, box=ascen.box, block_rays=128,
        interpret=True, with_stats=True)
    np.testing.assert_allclose(H.to_np(g.mom_mean), np.asarray(jg.mom_mean)[:r],
                               atol=1e-5)


def test_fast_trace_refuses_what_it_does_not_port():
    scen = rtt.scenario("vert")
    kw = dict(delta_s=0.1, pos0=scen.pos0, theta0=scen.theta0, device="cpu")
    med = rtt.analytic_medium("vert_heterogeneous")
    # precision="high" is ported (the df32 tier): it runs, and refuses
    # what its kernel does not take (tests/test_torch_df.py)
    assert rtt.fast_trace("op12", scen, med, precision="high", steps=3,
                          **kw).engine == "df32"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rtt.fast_trace("op6", scen, object(), **kw)
    with pytest.raises(ValueError, match="precision"):
        rtt.fast_trace("op6", scen, med, precision="low", **kw)
    with pytest.raises(ValueError, match="x-independent"):
        rtt.fast_trace("op6", rtt.scenario("fisheye"),
                       rtt.analytic_medium("fisheye"), stats=True, steps=3,
                       **kw)


#: ROADMAP.md §3's input for the scan route: a ParametricMedium with the
#: interface's sigmoid at thickness 0.15, op6, delta_s 0.02, 50 steps, 8 rays
#: from (-2, -1); JAX's first ray ends at (-1.1716, -0.4398)
SQRT2 = float(np.sqrt(2.0))


def test_fast_trace_without_a_kernel_takes_the_scan_tier():
    """A 2-D medium with no kernel goes to the float32 scan tier, engine
    "scan", active from the box test on the final positions, as JAX routes
    it (engine/fast.py:237-253); held to JAX's kernel-against-scan bars,
    position 5e-6 and traveltime 5e-5 (tests/test_kernels.py:24-27)."""
    import jax
    import jax.numpy as jnp
    from raytracing_tpu.engine.diff import ParametricMedium as JPM

    jscen, tscen = rt.scenario("interface"), rtt.scenario("interface")
    pos0 = np.tile([-2.0, -1.0], (8, 1))
    theta0 = np.linspace(0.6, 1.2, 8)
    kw = dict(delta_s=0.02, steps=50, pos0=pos0, theta0=theta0)
    j = jfast("op6", jscen, JPM(lambda p, x, y: SQRT2 - (SQRT2 - 1.0)
                                * jax.nn.sigmoid(y / p), jnp.asarray(0.15)),
              **kw)
    t = rtt.fast_trace("op6", tscen, rtt.ParametricMedium(
        lambda p, x, y: SQRT2 - (SQRT2 - 1.0) * torch.sigmoid(y / p),
        torch.tensor(0.15)), device="cpu", **kw)
    assert (t.engine, j.engine) == ("scan", "scan")
    np.testing.assert_allclose(np.asarray(j.pos[0]), [-1.1716, -0.4398],
                               atol=1e-4)
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=5e-6)
    for f in ("traveltime", "dist_sim"):
        np.testing.assert_allclose(H.to_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), atol=5e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))
    # a ray that leaves the box is inactive; one that ran out of steps not
    out = rtt.fast_trace("op6", dataclasses.replace(
        tscen, box=(-2.5, 20.0, -1.5, -0.3)), rtt.ParametricMedium(
        lambda p, x, y: SQRT2 - (SQRT2 - 1.0) * torch.sigmoid(y / p),
        torch.tensor(0.15)), device="cpu", **kw)
    assert not out.active[-1] and out.active[0]
    with pytest.raises(ValueError, match="scan fallback"):
        rtt.fast_trace("op6", tscen, rtt.ParametricMedium(
            lambda p, x, y: 1.0 + 0.0 * x, torch.tensor(0.0)), stats=True,
            device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="no 2-D medium"):
        rtt.fast_trace("op6", tscen, object(), device="cpu", **kw)
