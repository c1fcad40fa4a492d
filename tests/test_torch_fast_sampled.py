"""fast_trace and the scan tier on the reference's sampled media, against the
JAX package on the same tables: the port's fast_trace (plain versions on the
CPU) against the JAX fast_trace (Pallas kernels in interpret mode) at 256
rays for all five medium classes, with its engine names and refusals; and
the scan tier ``trace`` on all five at float64 (1e-9) and float32."""
import dataclasses

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine.fast import fast_trace as jfast  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.bench import launch_fan  # noqa: E402

R = 256
GRID_DELTA = 0.05    # a coarse fisheye grid (181 x 181 nodes)


def jax_medium(kind, scen, dtype=np.float32):
    if kind == "StratifiedGridMedium":
        return jspline.build_stratified_medium(scen.field, scen.box,
                                               dtype=dtype)
    if kind == "C1StratifiedMedium":
        return jc1.build_c1_stratified(scen.field, scen.box, dtype=dtype)
    if kind == "C1GridMedium":
        return jc1.build_c1_medium(scen.field, scen.box, GRID_DELTA,
                                   dtype=dtype, backend="scipy")
    gm = jspline.build_grid_medium(scen.field, scen.box, GRID_DELTA,
                                   dtype=dtype, backend="scipy")
    if kind == "GridMedium":
        return gm
    return jherm.build_hermite_medium(gm, dtype=dtype)


# (medium class, scenario, op, delta_s, divisor, s_max, stats, engine, tol)
CASES = [
    ("StratifiedGridMedium", "interface", "op6", 0.02, None, 3.0, False,
     "fused-strat", 1e-5),
    ("C1StratifiedMedium", "vert", "op8", 0.05, None, 8.0, True,
     "fused-strat", 1e-5),
    ("StratifiedGridMedium", "aniso", "op11", 0.05, None, 4.0, True,
     "golden-strat", 5e-4),
    ("GridMedium", "fisheye", "op1", 2 * np.pi / 60, 60, None, False,
     "grid", 1e-5),
    ("HermiteGridMedium", "fisheye", "op7", 2 * np.pi / 60, 60, None, False,
     "grid", 2e-4),
    ("C1GridMedium", "fisheye", "op5", 2 * np.pi / 60, 60, None, False,
     "grid", 5e-4),
]


def _scen(pkg, name, s_max):
    """The scenario with s_max cut; vert and aniso in a shrunken box that
    rays leave at different steps."""
    scen = pkg.scenario(name)
    if s_max is None:
        return scen
    box = H.VERT_BOX if name in ("vert", "aniso") else scen.box
    return dataclasses.replace(scen, s_max=s_max, box=box)


def _fan(scen, seed=0):
    pos0, theta0 = launch_fan(scen, R)
    rng = np.random.default_rng(seed)
    return pos0, (theta0 + rng.uniform(-0.02, 0.02, R)).astype(np.float32)


@pytest.mark.parametrize(
    "kind,name,op,ds,divisor,s_max,stats,engine,tol", CASES)
def test_fast_trace_sampled_matches_jax(kind, name, op, ds, divisor, s_max,
                                        stats, engine, tol):
    js = _scen(rt, name, s_max)
    ts = _scen(rtt, name, s_max)
    jm = jax_medium(kind, js)
    pos0, theta0 = _fan(ts)
    kw = dict(delta_s=np.float32(ds), pos0=pos0, theta0=theta0,
              divisor=divisor, n_turns=1, stats=stats)
    j = jfast(op, js, jm, block_rays=R, interpret=True, **kw)
    t = rtt.fast_trace(op, ts, H.port_medium(jm), device="cpu", **kw)
    assert t.engine == engine
    golden = tol == 5e-4
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=tol)
    np.testing.assert_allclose(H.to_np(t.traveltime), np.asarray(j.traveltime),
                               atol=5e-4 if golden else 5e-5)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))
    if stats:
        np.testing.assert_array_equal(H.to_np(t.mom_count),
                                      np.asarray(j.mom_count))
        np.testing.assert_allclose(H.to_np(t.mom_mean), np.asarray(j.mom_mean),
                                   atol=1e-5)
    if name in ("vert", "aniso"):
        assert not H.to_np(t.active).all()      # rays left the box


def test_fast_trace_refusals_on_sampled_media():
    fish = rtt.scenario("fisheye")
    grid = rtt.build_grid_medium("fisheye", fish.box, 0.2, device="cpu")
    kw = dict(delta_s=0.1, pos0=np.array([[1.0, 0.0]]),
              theta0=np.array([np.pi / 2]), steps=3, device="cpu")
    with pytest.raises(ValueError, match="x-independent"):
        rtt.fast_trace("op6", fish, grid, stats=True, **kw)
    with pytest.raises(ValueError, match="unknown op"):
        rtt.fast_trace("op99", fish, grid, **kw)
    # precision="high" is ported: the df32 kernel takes op12 on an analytic
    # field only, and refuses a sampled medium with JAX's ValueError
    with pytest.raises(ValueError, match="df32 kernel supports analytic"):
        rtt.fast_trace("op12", fish, grid, precision="high", **kw)
    res = rtt.fast_trace("op6", fish, grid, **kw)
    assert res.engine == "grid" and torch.isfinite(res.pos).all()


def test_as_hermite_cache_keys_on_table_identity():
    from raytracing_tpu_torch.engine import fast as tfast

    fish = rtt.scenario("fisheye")
    grid = rtt.build_grid_medium("fisheye", fish.box, 0.2, device="cpu")
    a = tfast._as_hermite(grid)
    assert tfast._as_hermite(grid) is a
    other = dataclasses.replace(grid, Z=grid.Z.clone())
    assert tfast._as_hermite(other) is not a
    for _ in range(tfast._HERMITE_CACHE_MAX):
        tfast._as_hermite(dataclasses.replace(grid, Z=grid.Z.clone()))
    assert len(tfast._HERMITE_CACHE) == tfast._HERMITE_CACHE_MAX
    assert tfast._as_hermite(grid) is not a     # evicted, rebuilt


SCAN_CASES = [("StratifiedGridMedium", "interface", "op6"),
              ("C1StratifiedMedium", "vert", "op8"),
              ("StratifiedGridMedium", "aniso", "op11"),
              ("GridMedium", "fisheye", "op1"),
              ("HermiteGridMedium", "fisheye", "op7"),
              ("C1GridMedium", "fisheye", "op5")]


@pytest.mark.parametrize("kind,name,op", SCAN_CASES)
def test_scan_tier_on_sampled_media_matches_jax(kind, name, op):
    """The scan tier takes any medium with n_and_grad: float64 to 1e-9 on
    float64 tables, and float32 runs on float32 tables stay float32."""
    s_max = None if name == "fisheye" else 1.0
    js, ts = _scen(rt, name, s_max), _scen(rtt, name, s_max)
    pos0, theta0 = _fan(ts)
    pos0, theta0 = pos0[:16], theta0[:16]
    ds, div = (2 * np.pi / 40, 40) if name == "fisheye" else (0.05, None)
    for np_dtype, t_dtype, atol in ((np.float64, torch.float64, 1e-9),
                                    (np.float32, torch.float32, 5e-5)):
        jm = jax_medium(kind, js, np_dtype)
        kw = dict(delta_s=ds, divisor=div, n_turns=1, mode="metrics",
                  pos0=pos0, theta0=theta0)
        j = rt.trace(op, js, jm, dtype=np_dtype, **kw)
        t = rtt.trace(op, ts, H.port_medium(jm), dtype=t_dtype,
                      device="cpu", **kw)
        assert t.final.pos.dtype == t_dtype
        for field in ("pos", "angle", "traveltime"):
            np.testing.assert_allclose(
                H.to_np(getattr(t.final, field)),
                np.asarray(getattr(j.final, field)), rtol=0, atol=atol,
                err_msg=f"{field} {t_dtype}")
        np.testing.assert_array_equal(H.to_np(t.exit_step),
                                      np.asarray(j.exit_step))
