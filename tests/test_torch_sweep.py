"""The port's DELTA_S search (``parallel/sweep.py``) against the JAX
package's: the acceptance policies and candidate grids exactly; the scan
tier at float64 (1e-9); the kernel tier's plain versions against the JAX
kernels in interpret mode on the analytic, stratified, golden-stratified and
grid paths (closure 2e-4 percentage points, i.e. positions to 1e-5; Snell
errors 1e-3 deg; momentum CV rel 1e-3); the grid sweep's final positions;
and whole searches, which must select the same index and divisor.

Scenarios whose rays travel 80 units are cut to a short ``s_max`` (the same
cut in both packages) so that the plain versions finish quickly on the
CPU, the interface fan launched 0.3 below the interface so that its rays
cross it within that length; the fisheye runs one turn on a coarse grid
(``delta`` 0.05)."""
import dataclasses

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu import config as jconfig  # noqa: E402
from raytracing_tpu.engine import segmented as jseg  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402
from raytracing_tpu.parallel import sweep as jsw  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import config as tconfig  # noqa: E402
from raytracing_tpu_torch.engine import segmented as tseg  # noqa: E402
from raytracing_tpu_torch.parallel import sweep as tsw  # noqa: E402

GRID_DELTA = 0.05
CLOSURE_TOL = 2e-4      # percentage points: 1e-5 in position
SNELL_TOL = 1e-3        # degrees
CV_RTOL = 1e-3
#: golden CV: the golden strat bar, 1e-3 percentage points
#: (test_torch_strat.py::test_golden_strat_op11_cv_matches_jax); the golden
#: family's float32 noise is 50x the fused one's (position bars 5e-4 and
#: 1e-5), and CV ~0.03 % is rounding-sensitive at rel ~1e-3
GOLDEN_CV_ATOL = 1e-3


#: the interface scenario cut short: its fan starts 0.3 below the interface
INTERFACE_CUT = {"s_max": 4.0, "pos0": np.tile([[-2.0, -0.3]], (42, 1))}


def scenarios(name, **cut):
    """The JAX and the port scenario, both cut the same way."""
    return (dataclasses.replace(rt.scenario(name), **cut),
            dataclasses.replace(rtt.scenario(name), **cut))


@pytest.fixture(scope="module")
def fisheye_grid():
    box = rt.scenario("fisheye").box
    gm = jspline.build_grid_medium("fisheye", box, GRID_DELTA,
                                   dtype=np.float32, backend="scipy")
    hm = jherm.build_hermite_medium(gm, dtype=np.float32)
    return hm, H.port_medium(hm)


def strat_pair(field, scen_name):
    jm = jspline.build_stratified_medium(field, rt.scenario(scen_name).box,
                                         dtype=np.float32)
    return jm, H.port_medium(jm)


def assert_metrics(t, j, golden=False):
    assert set(t) == set(j)
    for k in t:
        if k == "closure_pct":
            np.testing.assert_allclose(t[k], j[k], atol=CLOSURE_TOL)
        elif k == "cv_pct" and golden:
            np.testing.assert_allclose(t[k], j[k], atol=GOLDEN_CV_ATOL)
        elif k == "cv_pct":
            np.testing.assert_allclose(t[k], j[k], rtol=CV_RTOL)
        else:
            np.testing.assert_allclose(t[k], j[k], atol=SNELL_TOL)


# -- acceptance policies and candidate grids: exact -------------------------
def test_find_index_reference_examples():
    th = tconfig.MAX_MOMENTUM_CV_PCT
    assert tsw.find_index_interface([0.1, 0.1, 0.3], [0.5, 0.5, 0.9]) == 1
    assert tsw.find_index_interface([0.1, 0.1, 0.3], [0.9, 0.5, 0.9]) is None
    assert tsw.find_index_interface([0.3, 0.1, 0.1], [0.5, 0.5, 0.5]) is None
    assert tsw.find_index_fisheye([1.0, 2.0, 6.0, 7.0]) == 1
    assert tsw.find_index_fisheye([6.0, 7.0]) is None
    assert tsw.find_index_vert([th / 2, th / 2, th / 2, th * 2, th * 3]) == 2
    assert tsw.find_index_vert([th * 2, th / 2, th / 2]) is None


@pytest.mark.parametrize("seed", range(4))
def test_find_index_policies_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        mean = rng.uniform(0.0, 0.4, n)
        mx = rng.uniform(0.3, 1.0, n)
        closure = np.sort(rng.uniform(0.0, 10.0, n))
        cv = rng.uniform(0.0, 0.1, n)
        assert (tsw.find_index_interface(mean, mx)
                == jsw.find_index_interface(mean, mx))
        assert tsw.find_index_fisheye(closure) == jsw.find_index_fisheye(closure)
        assert tsw.find_index_vert(cv) == jsw.find_index_vert(cv)


@pytest.mark.parametrize("name", ["interface", "fisheye", "vert", "aniso"])
def test_candidate_grids_match_jax(name):
    t = tsw.candidates(rtt.scenario(name))
    j = jsw.candidates(rt.scenario(name))
    for a, b in zip(t, j):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    if name == "fisheye":
        assert t[0][0] == 303 and t[0][-1] == 4
    if name == "vert":
        # the reference's DELTA_STEP (0.01) quirk, not DELTA_STEP_VERT
        assert t[0][1] - t[0][0] == pytest.approx(-tconfig.DELTA_STEP)


# -- scan tier at float64 ----------------------------------------------------
@pytest.mark.parametrize("name,op,divs,cut", [
    ("fisheye", "op1", [40.0, 30.0, 20.0, 10.0], {}),
    ("interface", "op6", [3.0, 2.0], INTERFACE_CUT),
    ("vert", "op8", [2.0, 1.0, 0.5], {"s_max": 3.0}),
    ("aniso", "op11", [2.0, 1.0], {"s_max": 1.5}),
])
def test_run_candidates_matches_jax(name, op, divs, cut):
    js, ts = scenarios(name, **cut)
    divs = np.asarray(divs)
    if js.is_fisheye:
        ds = 2 * np.pi / divs
        sizes = (divs + 1).astype(np.int64)
    else:
        ds = jconfig.SIGMA / divs
        sizes = np.ceil(js.s_max / ds).astype(np.int64) + 1
    field = js.field
    j = jsw.run_candidates(op, js, rt.analytic_medium(field), ds, sizes - 1,
                           int(sizes.max()), n_turns=1, dtype=np.float64)
    t = tsw.run_candidates(op, ts, rtt.analytic_medium(field), ds, sizes - 1,
                           int(sizes.max()), n_turns=1, dtype=np.float64,
                           device="cpu")
    assert set(t) == set(j)
    for k in t:
        np.testing.assert_allclose(t[k], np.asarray(j[k]), rtol=1e-9,
                                   atol=1e-9)


# -- kernel tier: plain versions against the JAX kernels ---------------------
def test_run_candidates_fused_analytic_matches_jax():
    js, ts = scenarios("fisheye")
    divs = np.arange(40.0, 20.0, -4.0)
    ds = 2 * np.pi / divs
    sizes = (divs + 1).astype(np.int64)
    j = jsw.run_candidates_fused("op6", js, ds, sizes - 1,
                                 int(sizes.max()) - 1, rays=128,
                                 block_rays=128)
    t = tsw.run_candidates_fused("op6", ts, ds, sizes - 1,
                                 int(sizes.max()) - 1, device="cpu")
    assert_metrics(t, j)


def test_run_candidates_fused_strat_matches_jax():
    js, ts = scenarios("interface", **INTERFACE_CUT)
    jm, tm = strat_pair("interface", "interface")
    ds = jconfig.SIGMA / np.array([3.0, 2.0, 1.2])
    sizes = np.ceil(js.s_max / ds).astype(np.int64) + 1
    j = jsw.run_candidates_fused("op8", js, ds, sizes - 1,
                                 int(sizes.max()) - 1, medium=jm, rays=128,
                                 block_rays=128)
    t = tsw.run_candidates_fused("op8", ts, ds, sizes - 1,
                                 int(sizes.max()) - 1, medium=tm,
                                 device="cpu")
    assert_metrics(t, j)


def test_run_candidates_fused_golden_strat_matches_jax():
    js, ts = scenarios("aniso", s_max=1.5)
    jm, tm = strat_pair("vert_heterogeneous", "aniso")
    ds = jconfig.SIGMA / np.array([2.0, 1.0, 0.5])
    sizes = np.ceil(js.s_max / ds).astype(np.int64) + 1
    j = jsw.run_candidates_fused("op11", js, ds, sizes - 1,
                                 int(sizes.max()) - 1, medium=jm, rays=128,
                                 block_rays=128)
    t = tsw.run_candidates_fused("op11", ts, ds, sizes - 1,
                                 int(sizes.max()) - 1, medium=tm,
                                 device="cpu")
    assert_metrics(t, j, golden=True)


def test_run_candidates_fused_grid_matches_jax(fisheye_grid):
    """The batched grid sweep (one ray a candidate here, a 1024-lane block
    with its own window in JAX) and the per-candidate golden grid path."""
    jm, tm = fisheye_grid
    js, ts = scenarios("fisheye")
    divs = np.array([60.0, 40.0, 30.0])
    ds = (2 * np.pi / divs).astype(np.float32)
    sizes = divs.astype(np.int64)
    j = jsw.run_candidates_fused("op1", js, ds, sizes - 1,
                                 int(sizes.max()) - 1, medium=jm, rays=128,
                                 block_rays=128)
    t = tsw.run_candidates_fused("op1", ts, ds, sizes - 1,
                                 int(sizes.max()) - 1, medium=tm,
                                 device="cpu")
    assert_metrics(t, j)
    # golden candidates run one launch each, as grid_trace_tiled runs them
    t = tsw.run_candidates_fused("op5", ts, ds, sizes - 1,
                                 int(sizes.max()) - 1, medium=tm,
                                 device="cpu")
    box = tuple(ts.box)
    for i, d in enumerate(ds):
        f = tseg.grid_trace_tiled("op5", [[1.0, 0.0]], [np.pi / 2], d, tm,
                                  steps=int(sizes[i] - 1), box=box,
                                  device="cpu")
        want = (100.0 / (2 * np.pi)) * np.linalg.norm(
            H.to_np(f.pos[0]) - [1.0, 0.0])
        assert t["closure_pct"][i] == want


def test_grid_sweep_tiled_matches_jax(fisheye_grid):
    jm, tm = fisheye_grid
    box = tuple(rt.scenario("fisheye").box)
    divs = np.array([60.0, 40.0, 30.0])
    ds = (2 * np.pi / divs).astype(np.float32)
    lim = (divs - 1).astype(np.float32)
    pos = np.tile(np.array([[1.0, 0.0]], np.float32), (3, 1))
    th = np.full(3, np.pi / 2, np.float32)
    jf, jfb = jseg.grid_sweep_tiled("op6", pos, th, ds, lim, jm, box=box,
                                    interpret=True)
    tf, tfb = tseg.grid_sweep_tiled("op6", pos, th, ds, lim, tm, box=box,
                                    device="cpu")
    assert jfb == [] and tfb == []
    np.testing.assert_allclose(H.to_np(tf), jf, atol=1e-5)
    # each candidate equals its own one-ray trace
    for i in range(3):
        one = tseg.grid_trace_tiled("op6", pos[i:i + 1], th[i:i + 1], ds[i],
                                    tm, steps=int(lim[i]), box=box,
                                    device="cpu")
        assert torch.equal(one.pos[0], tf[i])
    with pytest.raises(ValueError, match="golden"):
        tseg.grid_sweep_tiled("op5", pos, th, ds, lim, tm, box=box,
                              device="cpu")


# -- whole searches: the same selection as JAX -------------------------------
def test_delta_s_search_scan_selects_as_jax(monkeypatch):
    monkeypatch.setattr(jconfig, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 60.0)
    monkeypatch.setattr(tconfig, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 60.0)
    j = jsw.delta_s_search("op1", rt.scenario("fisheye"),
                           rt.analytic_medium("fisheye"), n_turns=1,
                           dtype=np.float64)
    t = tsw.delta_s_search("op1", rtt.scenario("fisheye"),
                           rtt.analytic_medium("fisheye"), n_turns=1,
                           dtype=np.float64, device="cpu")
    assert t.engine == "scan"     # auto on the CPU, as JAX on its CPU backend
    assert (t.index, t.divisor) == (j.index, j.divisor) and t.divisor == 23.0
    assert t.delta_s_selected == pytest.approx(j.delta_s_selected, rel=1e-15)
    np.testing.assert_allclose(t.metrics["closure_pct"],
                               j.metrics["closure_pct"], rtol=1e-9)


@pytest.mark.parametrize("name,op,divs,cut", [
    ("fisheye", "op1", [34.0, 30.0, 26.0, 24.0, 23.0, 22.0], {}),
    ("interface", "op6", [3.0, 2.5, 2.0, 1.5, 1.2], INTERFACE_CUT),
    ("aniso", "op11", [2.0, 1.5, 1.0, 0.5], {"s_max": 1.5}),
])
def test_delta_s_search_fused_selects_as_jax(name, op, divs, cut,
                                             fisheye_grid):
    js, ts = scenarios(name, **cut)
    if js.is_fisheye:
        jm, tm = fisheye_grid
    else:
        jm, tm = strat_pair(js.field, name)
    kw = dict(n_turns=1, engine="fused", divisors=np.asarray(divs))
    j = jsw.delta_s_search(op, js, jm, rays=128, block_rays=128, **kw)
    t = tsw.delta_s_search(op, ts, tm, device="cpu", **kw)
    assert t.engine == "fused" and t.index is not None
    assert (t.index, t.divisor) == (j.index, j.divisor)
    assert_metrics(t.metrics, j.metrics, golden=op == "op11")


def test_convergence_search_matches_jax():
    from raytracing_tpu.media import c1 as jc1
    y = np.linspace(-2.0, 1.0, 61)
    samples = 1.0 + 0.3 * np.tanh(2.0 * y)
    jm = jc1.c1_stratified_from_samples(samples, y)
    r = 64
    pos0 = np.stack([np.zeros(r, np.float32),
                     np.linspace(-1.5, -0.5, r, dtype=np.float32)], -1)
    theta0 = np.full(r, 0.3, np.float32)
    kw = dict(pos0=pos0, theta0=theta0, arc_length=1.0,
              box=(-5.0, 5.0, -2.0, 1.0),
              candidates=1.0 / np.array([10.0, 20.0, 40.0]), tol=1e-3)
    j = jsw.delta_s_search_convergence("op6", jm, block_rays=128, **kw)
    t = tsw.delta_s_search_convergence("op6", H.port_medium(jm),
                                       device="cpu", **kw)
    assert (t.index, t.divisor) == (j.index, j.divisor)
    assert t.index is not None
    np.testing.assert_allclose(t.metrics["halving_err"],
                               j.metrics["halving_err"], atol=2e-5)
    with pytest.raises(ValueError, match="descend"):
        tsw.delta_s_search_convergence("op6", H.port_medium(jm), device="cpu",
                                       **{**kw, "candidates": [0.1, 0.2]})


def test_fused_sweep_supported_matches_jax(fisheye_grid):
    jgrid, tgrid = fisheye_grid
    jstrat, tstrat = strat_pair("interface", "interface")
    for name in ("interface", "fisheye", "vert", "aniso"):
        js, ts = rt.scenario(name), rtt.scenario(name)
        for op in ("op1", "op5", "op8", "op10", "op11n", "op12"):
            for jm, tm in ((rt.analytic_medium(js.field),
                            rtt.analytic_medium(ts.field)),
                           (rt.analytic_medium("fisheye"),
                            rtt.analytic_medium("fisheye")),
                           (jgrid, tgrid), (jstrat, tstrat)):
                assert (tsw.fused_sweep_supported(op, ts, tm)
                        == jsw.fused_sweep_supported(op, js, jm))


def test_search_refuses_what_is_not_ported():
    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    with pytest.raises(NotImplementedError, match="item 18"):
        tsw.delta_s_search("op1", scen, med, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tsw.delta_s_search("op1", scen, med, engine="pallas", device="cpu")
