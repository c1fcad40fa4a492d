"""The port's 3-D scan tier (raytracing_tpu_torch.trace3d) against the JAX
3-D scan tier at float64: the four vector methods on the three analytic 3-D
fields, a Custom3D, Stratified3D over the port's vert field and over its
stratified and C1 profile tables, and a grid3, in both output modes, with
the slowness tracker and a step limit; the JAX package's own 3-D oracle
tests (tests/test_trace3d.py) run on the port; and the 3-D Richardson
calibration, which selects JAX's candidate on JAX's two test inputs."""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine import trace3d as jt3  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import fields3d as jf3  # noqa: E402
from raytracing_tpu.media import grid3 as jg3  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402
from raytracing_tpu.parallel import sweep as jsweep  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine.trace3d import (  # noqa: E402
    METHODS3, TRACE3_COLS, bouguer_invariant, trace3d)
from raytracing_tpu_torch.media.fields3d import (  # noqa: E402
    Custom3D, Stratified3D, analytic_medium3)
from raytracing_tpu_torch.parallel import sweep as tsweep  # noqa: E402

ATOL = 1e-9
F64 = np.float64
BOX = (-1.2, 1.2, -1.2, 1.2, -1.2, 1.2)
CPU = dict(device="cpu")


def _fan(seed, r=16, field=None):
    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(-0.6, 0.6, (r, 3))
    if field == "interface":
        pos0[:, 1] = rng.uniform(-0.02, 0.02, r)
    return pos0, rng.normal(size=(r, 3))


def _grid_axes(n=12, span=1.6):
    ax = np.linspace(-span, span, n)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    return ax, X, Y, Z


def _media(name):
    """(JAX medium, port medium) pairs of the scan-tier comparisons."""
    box2 = (-2.0, 2.0, -2.0, 2.0)
    if name in jf3.FIELDS3:
        return jf3.analytic_medium3(name), analytic_medium3(name)
    if name == "custom":
        return (jf3.Custom3D(lambda x, y, z: 1.0 + 0.2 * jnp.sin(x + 2 * y)
                             * jnp.cos(z)),
                Custom3D(lambda x, y, z: 1.0 + 0.2 * torch.sin(x + 2 * y)
                         * torch.cos(z)))
    if name == "strat_vert":
        return (jf3.Stratified3D(rt.analytic_medium("vert_heterogeneous")),
                Stratified3D(rtt.analytic_medium("vert_heterogeneous")))
    if name == "strat_table":
        jm = jspline.build_stratified_medium("vert_heterogeneous", box2, 0.02,
                                             dtype=np.float64)
        return jf3.Stratified3D(jm), Stratified3D(H.port_medium(jm))
    if name == "strat_c1":
        jm = jc1.build_c1_stratified("vert_heterogeneous", box2, 0.02,
                                     dtype=np.float64)
        return jf3.Stratified3D(jm), Stratified3D(H.port_medium(jm))
    ax, X, Y, Z = _grid_axes()
    F = 1.0 + 0.25 * np.exp(-(X ** 2 + 0.5 * Y ** 2 + 2.0 * Z ** 2))
    jm = jg3.c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float64)
    return jm, H.port_medium(jm)


def _same(j, t, atol=ATOL):
    for f in ("pos", "unitv", "n", "grad", "traveltime", "dist_sim",
              "dist_real"):
        np.testing.assert_allclose(H.to_np(getattr(t.final, f)),
                                   np.asarray(getattr(j.final, f)),
                                   atol=atol, rtol=0, err_msg=f)
    np.testing.assert_array_equal(H.to_np(t.final.active),
                                  np.asarray(j.final.active))
    np.testing.assert_array_equal(H.to_np(t.exit_step),
                                  np.asarray(j.exit_step))


@pytest.mark.parametrize("method", sorted(METHODS3))
@pytest.mark.parametrize("medium", ["fisheye", "vert_heterogeneous",
                                    "interface", "custom", "strat_vert",
                                    "strat_table", "strat_c1", "grid3"])
def test_scan_tier_matches_jax_f64(method, medium):
    """History mode, every row, with a box that some rays leave."""
    jm, tm = _media(medium)
    pos0, dir0 = _fan(1, field=medium)
    kw = dict(pos0=pos0, dir0=dir0, delta_s=0.02, steps=60, box=BOX,
              dtype=F64)
    j = jt3.trace3d(method, jm, **kw)
    t = trace3d(method, tm, **kw, **CPU)
    _same(j, t)
    np.testing.assert_allclose(H.to_np(t.history), np.asarray(j.history),
                               atol=ATOL, rtol=0)
    assert not H.to_np(t.final.active).all() or medium == "interface"


@pytest.mark.parametrize("medium", ["strat_vert", "strat_table", "strat_c1"])
def test_metrics_stats_and_step_limit_match_jax(medium):
    """Metrics mode with the horizontal-slowness tracker and a step limit
    below the buffer: every final field and the CV as JAX."""
    jm, tm = _media(medium)
    pos0, dir0 = _fan(2)
    kw = dict(pos0=pos0, dir0=dir0, delta_s=0.02, steps=80, dtype=F64,
              mode="metrics", stats=True, step_limit=50)
    j = jt3.trace3d("op8", jm, **kw)
    t = trace3d("op8", tm, **kw, **CPU)
    _same(j, t)
    assert t.history is None
    for f in ("slow_count", "slow_mean", "slow_m2"):
        np.testing.assert_allclose(H.to_np(getattr(t.final, f)),
                                   np.asarray(getattr(j.final, f)),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(t.horizontal_slowness_cv_pct(),
                               j.horizontal_slowness_cv_pct(), atol=1e-9,
                               rtol=1e-9)
    assert (H.to_np(t.exit_step) <= 50).all()


# -- the JAX package's oracle tests (tests/test_trace3d.py), on the port ----

def _homog3():
    return Custom3D(lambda x, y, z: torch.ones_like(x))


@pytest.mark.parametrize("method", sorted(METHODS3))
def test_homogeneous_straight_lines_exact(method):
    d = np.array([[1.0, 2.0, 2.0], [0.0, 0.0, 1.0], [-3.0, 0.0, 4.0]])
    res = trace3d(method, _homog3(), pos0=np.zeros((3, 3)), dir0=d,
                  delta_s=0.1, steps=50, dtype=F64, **CPU)
    want = d / np.linalg.norm(d, axis=1, keepdims=True) * 5.0
    np.testing.assert_allclose(H.to_np(res.final.pos), want, atol=1e-13)
    np.testing.assert_allclose(H.to_np(res.final.traveltime), 5.0,
                               atol=1e-12)


def test_fisheye3_closure_and_planarity():
    """Spherical symmetry: every launch plane carries the same circle, and
    the in-plane ray closes as the port's 2-D engine does."""
    med = analytic_medium3("fisheye")
    tilts = np.array([0.0, 0.4, 0.7, 1.2])
    dirs = np.stack([np.zeros_like(tilts), np.cos(tilts), np.sin(tilts)], -1)
    pos0 = np.tile([[1.0, 0.0, 0.0]], (len(tilts), 1))
    div = 600
    res = trace3d("op6", med, pos0=pos0, dir0=dirs, delta_s=2 * np.pi / div,
                  steps=div, dtype=F64, **CPU)
    closure = np.linalg.norm(H.to_np(res.final.pos) - pos0, axis=1)
    assert closure.max() < 1e-7
    np.testing.assert_allclose(closure, closure[0], atol=1e-12)
    r = H.to_np(res.history)[..., 0:3]
    normal = np.cross(pos0, dirs)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    assert np.abs(np.einsum("srk,rk->sr", r, normal)).max() < 1e-10
    r2 = rtt.trace("op6", rtt.scenario("fisheye"),
                   rtt.analytic_medium("fisheye"), delta_s=2 * np.pi / div,
                   divisor=div + 1, n_turns=1, dtype=torch.float64,
                   pos0=np.array([[1.0, 0.0], [1.0, 0.0]]),
                   theta0=np.array([np.pi / 2, np.pi / 2]), mode="metrics",
                   **CPU)
    c2 = np.linalg.norm(H.to_np(r2.final.pos)[0] - [1, 0])
    assert abs(closure[0] - c2) < 1e-11


def test_bouguer_invariant_second_order():
    med = analytic_medium3("fisheye")
    pos0 = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    dir0 = np.array([[0.0, 0.8, 0.6], [0.0, 0.8, 0.6]])
    drifts = []
    for div in (300, 600):
        res = trace3d("op6", med, pos0=pos0, dir0=dir0,
                      delta_s=2 * np.pi / div, steps=div, dtype=F64, **CPU)
        B = bouguer_invariant(res)
        drifts.append(np.abs(B - B[0]).max())
    assert drifts[0] < 1e-7
    assert drifts[1] < drifts[0] / 3.0


def test_stratified_conservation_and_azimuth():
    s3 = Stratified3D(rtt.analytic_medium("vert_heterogeneous"))
    dir0 = np.array([[0.6, -0.5, 0.3], [0.2, -0.8, 0.55]])
    cvs = {"op1": [], "op8": []}
    for method in cvs:
        for ds, steps in ((0.01, 400), (0.005, 800)):
            res = trace3d(method, s3, pos0=np.zeros((2, 3)), dir0=dir0,
                          delta_s=ds, steps=steps, dtype=F64, stats=True,
                          mode="metrics", **CPU)
            cv = res.horizontal_slowness_cv_pct()
            assert np.nanmax(cv) < 0.05
            cvs[method].append(np.nanmax(cv))
            u = H.to_np(res.final.unitv)
            az0 = np.arctan2(dir0[:, 2], dir0[:, 0])
            az1 = np.arctan2(u[:, 2], u[:, 0])
            assert np.abs(az1 - az0).max() < 1e-12
    assert cvs["op1"][1] < cvs["op1"][0] * 0.7
    assert cvs["op8"][1] < cvs["op8"][0] / 3.0
    assert cvs["op8"][0] < cvs["op1"][0] / 100.0


def test_reduces_to_2d_parity_engine():
    """In-plane launches reproduce the port's 2-D engine: second-order
    agreement and identical boundary-exit steps."""
    scen = rtt.scenario("vert")
    prof = rtt.analytic_medium("vert_heterogeneous")
    th = np.array([0.3, 0.7, 1.1])
    pos2 = np.tile(scen.pos0[:1], (3, 1)).astype(F64)
    ds, steps = 0.01, 400
    r2 = rtt.trace("op6", scen, prof, delta_s=ds, dtype=torch.float64,
                   pos0=pos2, theta0=th, mode="metrics", max_size=steps + 1,
                   **CPU)
    p3 = np.concatenate([pos2, np.zeros((3, 1))], -1)
    d3 = np.stack([np.cos(th), np.sin(th), np.zeros(3)], -1)
    r3 = trace3d("op6", Stratified3D(prof), pos0=p3, dir0=d3, delta_s=ds,
                 steps=steps, dtype=F64, mode="metrics",
                 box=(*scen.box, -1.0, 1.0), **CPU)
    np.testing.assert_array_equal(H.to_np(r3.exit_step),
                                  H.to_np(r2.exit_step))
    diff = np.abs(H.to_np(r3.final.pos)[:, :2] - H.to_np(r2.final.pos)).max()
    assert diff < 5e-7
    assert np.abs(H.to_np(r3.final.pos)[:, 2]).max() < 1e-14


def test_measured_profile_lifts_to_3d():
    y = np.linspace(-1.5, 1.5, 61)
    med = rtt.c1_stratified_from_samples(1.2 - 0.25 * y * y, y,
                                         dtype=torch.float64, **CPU)
    dir0 = np.array([[0.7, 0.1, 0.7], [0.9, -0.2, 0.4]])
    res = trace3d("op6", Stratified3D(med), pos0=np.zeros((2, 3)),
                  dir0=dir0, delta_s=0.01, steps=600, dtype=F64, stats=True,
                  **CPU)
    assert np.nanmax(res.horizontal_slowness_cv_pct()) < 0.05
    h = H.to_np(res.history)
    assert h.shape == (601, 2, len(TRACE3_COLS))
    assert np.abs(h[..., 1]).max() < 1.5


def test_history_metrics_agree_and_box_exit():
    med = _homog3()
    d = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    kw = dict(pos0=np.zeros((2, 3)), dir0=d, delta_s=0.1, steps=30,
              dtype=F64, box=(-1, 2.05, -1, 9, -1, 1), **CPU)
    a = trace3d("op8", med, mode="metrics", **kw)
    b = trace3d("op8", med, mode="history", **kw)
    for fld in ("pos", "unitv", "traveltime", "exit_step"):
        assert torch.equal(getattr(a.final, fld), getattr(b.final, fld))
    assert int(a.exit_step[0]) == 21 and int(a.exit_step[1]) == 30
    assert not bool(a.final.active[0])
    np.testing.assert_allclose(H.to_np(a.final.pos)[0, 0], 2.1, atol=1e-12)


def test_named_errors():
    med = _homog3()
    ok = dict(pos0=np.zeros((1, 3)), dir0=np.ones((1, 3)), delta_s=0.1,
              steps=5, **CPU)
    with pytest.raises(ValueError, match="planar"):
        trace3d("op5", med, **ok)
    with pytest.raises(ValueError, match="rays, 3"):
        trace3d("op1", med, pos0=np.zeros((1, 2)), dir0=np.ones((1, 2)),
                delta_s=0.1, steps=5, **CPU)
    with pytest.raises(ValueError, match="mode"):
        trace3d("op1", med, mode="full", **ok)
    with pytest.raises(ValueError, match="box"):
        trace3d("op1", med, box=(0, 1, 0, 1), **ok)
    with pytest.raises(ValueError, match="3-D field"):
        analytic_medium3("warp")
    with pytest.raises(ValueError, match="stats=True"):
        trace3d("op1", med, **ok).horizontal_slowness_cv_pct()
    with pytest.raises(ValueError, match="history"):
        bouguer_invariant(trace3d("op1", med, mode="metrics", **ok))
    res = trace3d("HySA", med, **ok)
    assert torch.isfinite(res.final.pos).all()


def test_stratified3d_rejects_x_dependent_media():
    """The constructor probes x-independence with JAX's message, on a
    sampled 2-D grid and on a user field alike."""
    g2 = rtt.build_grid_medium("fisheye", rtt.scenario("fisheye").box, 0.05,
                               dtype=torch.float64, **CPU)
    with pytest.raises(ValueError, match="x-independent"):
        Stratified3D(g2)
    with pytest.raises(ValueError, match="x-independent"):
        Stratified3D(rtt.CustomMedium(lambda x, y: 1.0 + 0.1 * x + 0.0 * y))
    Stratified3D(rtt.CustomMedium(lambda x, y: 1.0 + 0.1 * y + 0.0 * x))


# -- the 3-D Richardson calibration (parallel/sweep.py:624) -------------------

def test_delta_s_convergence_search_3d_selects_jax_index():
    """JAX's test input (tests/test_trace3d.py:210): the same selection and
    the same halving errors as the JAX search, at float32 (tol 1e-4) and
    float64 (tol 1e-6), and JAX's refusal of ascending candidates."""
    r = 8
    tilt = np.linspace(0, 0.5, r)
    pos0 = np.tile([[1.0, 0, 0]], (r, 1))
    dir0 = np.stack([np.zeros(r), np.cos(tilt), np.sin(tilt)], -1)
    for tol, dtype in ((1e-4, np.float32), (1e-6, np.float64)):
        kw = dict(pos0=pos0, dir0=dir0, arc_length=2 * np.pi, tol=tol,
                  dtype=dtype)
        j = jsweep.delta_s_search_convergence3(
            "op6", jf3.analytic_medium3("fisheye"), **kw)
        t = tsweep.delta_s_search_convergence3(
            "op6", analytic_medium3("fisheye"), **kw, **CPU)
        assert t.index is not None and t.index == j.index
        assert t.delta_s_selected == j.delta_s_selected
        # float32: the two scan tiers round apart by an ulp here and there
        # (XLA:CPU against ATen), 8.8e-7 in the first candidate's error
        np.testing.assert_allclose(t.metrics["halving_err"],
                                   j.metrics["halving_err"], rtol=0,
                                   atol=5e-6 if dtype == np.float32 else 1e-12)
        assert t.metrics["halving_err"][t.index] < tol
    with pytest.raises(ValueError, match="descend"):
        tsweep.delta_s_search_convergence3(
            "op6", analytic_medium3("fisheye"), pos0=pos0, dir0=dir0,
            arc_length=1.0, candidates=np.array([0.01, 0.02]), **CPU)
    with pytest.raises(ValueError, match="arc_length"):
        tsweep.delta_s_search_convergence3(
            "op6", analytic_medium3("fisheye"), pos0=pos0, dir0=dir0,
            arc_length=float("nan"), **CPU)


def test_delta_s_convergence_search_grid3_selects_jax_index():
    """JAX's grid3 input (tests/test_grid3.py:138): a measured 10^3-node
    field, four candidates, tol 1e-3."""
    ax = np.linspace(-1.5, 1.5, 10)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    F = 1.0 + 0.2 * np.exp(-(X ** 2 + Y ** 2 + Z ** 2))
    jm = jg3.c1_medium3_from_samples(F, ax, ax, ax)
    t = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    kw = dict(pos0=np.tile([[-1.0, 0.0, 0.0]], (8, 1)),
              dir0=np.stack([np.full(8, 3.0), np.cos(t), np.sin(t)], -1),
              arc_length=2.5, candidates=2.5 / (40 * 2.0 ** np.arange(4)),
              tol=1e-3)
    j = jsweep.delta_s_search_convergence3("op6", jm, **kw)
    res = tsweep.delta_s_search_convergence3("op6", H.port_medium(jm), **kw,
                                             **CPU)
    assert res.index is not None and res.index == j.index
    assert res.delta_s_selected == j.delta_s_selected > 0
    # float32, as JAX's test runs it: 1.6e-7 apart (ulps of the two tiers)
    np.testing.assert_allclose(res.metrics["halving_err"],
                               j.metrics["halving_err"], rtol=0, atol=5e-6)
