"""The port's sharded entry points over a 4-rank gloo world on the CPU:
the mirrors of the five sharded tests of tests/test_fast.py (:66, :87,
:268, :391, :435), tests/test_sweep.py:91, tests/test_grid_tiled.py:238,
tests/test_tiled3.py:220, tests/test_dynamic_tiled3.py:206 and
tests/test_c1.py:361, with the eigenray solver and the search.

One world runs every case once (a module-scoped fixture,
tests/torch_dist_helpers.py); each test reads its case's per-rank results.
Every sharded result equals the port's one-rank call bit for bit, and the
JAX package's unsharded call (its Pallas kernels in interpret mode, or its
scan tier) within the bars the port's other tests hold for the same
route."""
import numpy as np
import pytest
import torch_dist_helpers as D
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine.fast import fast_trace as jfast  # noqa: E402

N = 4          # ranks
R = N * 128    # devices x JAX's 128-ray block
GRID_STEPS = 40
TILED_STEPS = 40
TILED3_STEPS = 60


@pytest.fixture(scope="module")
def jax_media():
    from raytracing_tpu.media.c1 import build_c1_medium
    from raytracing_tpu.media.grid3 import c1_medium3_from_samples
    from raytracing_tpu.media.hermite import build_hermite_medium
    from raytracing_tpu.media.spline import (
        build_grid_medium, stratified_medium_from_samples)

    box = rt.scenario("fisheye").box
    y = np.linspace(-1.5, 1.5, 41)
    ax = np.linspace(-1.6, 1.6, 12)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return {
        "profile": stratified_medium_from_samples(1.3 - 0.1 * y * y, y),
        "grid": build_hermite_medium(build_grid_medium(
            "fisheye", box, delta=0.05, dtype=np.float32)),
        "c1": build_c1_medium("fisheye", box, delta=0.05, dtype=np.float32),
        "grid3": c1_medium3_from_samples(1.0 / (1.0 + X**2 + Y**2 + Z**2),
                                         ax, ax, ax, dtype=np.float32)}


def _kf(jm):
    return type(jm).__name__, H.medium_fields(jm)


@pytest.fixture(scope="module")
def world(jax_media, tmp_path_factory):
    m = {k: _kf(v) for k, v in jax_media.items()}
    cases = [("fast_fused", (R,)), ("fast_refusals", ()),
             ("fast_golden", (m["profile"], R)),
             ("fast_stats", (m["profile"], R)),
             ("fast_grid", (m["grid"], R, GRID_STEPS)),
             ("fast_grid_c1", (m["c1"], R, 16)),
             ("grid_tiled", (m["grid"], R, TILED_STEPS)),
             ("tiled3", (m["grid3"], R, TILED3_STEPS)),
             ("sweep", (16,)), ("eigenrays", ())]
    return D.run_world(N, cases, tmp_path_factory.mktemp("world"))


def _same_on_every_rank(vals, keys):
    for v in vals[1:]:
        for k in keys:
            if k in vals[0]:
                np.testing.assert_array_equal(v[k], vals[0][k], err_msg=k)


def _bit_equal(v, names):
    for k in names:
        if k in v:
            np.testing.assert_array_equal(v[k], v["one_" + k], err_msg=k)


def _shards(vals, m=128):
    """Each rank holds its own m rows of the whole result."""
    for k, w in enumerate(vals):
        np.testing.assert_array_equal(w["local"],
                                      vals[0]["pos"][m * k:m * (k + 1)])


def test_fast_trace_sharded_matches_single(world):
    vals = D.result(world, "fast_fused")
    v = vals[0]
    assert (v["engine"], v["one_engine"]) == ("fused-sharded", "fused")
    _same_on_every_rank(vals, D.FAST_PLANES)
    _bit_equal(v, D.FAST_PLANES)
    _shards(vals)
    pos0, theta0 = D.fisheye_batch(R)
    j = jfast("op6", rt.scenario("fisheye"), rt.analytic_medium("fisheye"),
              delta_s=2 * np.pi / 64, steps=64,
              pos0=pos0.astype(np.float32),
              theta0=theta0.astype(np.float32), block_rays=128)
    np.testing.assert_allclose(v["pos"], np.asarray(j.pos), atol=1e-5)
    np.testing.assert_allclose(v["traveltime"], np.asarray(j.traveltime),
                               atol=5e-5)


def test_fast_trace_sharded_rejects_bad_batch(world):
    for v in D.result(world, "fast_refusals"):
        assert "must divide by devices*block (4*128)" in v["batch"]
        assert "stats=True" in v["stats"]
        assert "fast_trace_sharded covers" in v["medium"]


def test_fast_trace_sharded_golden_matches_single(world, jax_media):
    """The golden family: aniso op11 ("golden-sharded") and op5 on a
    stratified profile ("golden-strat-sharded"), each the one-rank call's
    to the bit and JAX's within the golden bar, 5e-4."""
    vals = D.result(world, "fast_golden")
    scen = rt.scenario("aniso")
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), R)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (R, 1))
    pos0v, theta0v = D.profile_batch(R)
    for name, engine, j in (
            ("aniso", "golden-sharded", jfast(
                "op11", scen, rt.analytic_medium("vert_heterogeneous"),
                delta_s=0.02, steps=64, pos0=pos0, theta0=theta0,
                block_rays=128)),
            ("strat", "golden-strat-sharded", jfast(
                "op5", rt.scenario("vert"), jax_media["profile"],
                delta_s=0.01, steps=64, pos0=pos0v, theta0=theta0v,
                block_rays=128))):
        v = vals[0][name]
        assert v["engine"] == engine
        _same_on_every_rank([w[name] for w in vals], D.FAST_PLANES)
        _bit_equal(v, D.FAST_PLANES)
        np.testing.assert_allclose(v["pos"], np.asarray(j.pos), atol=5e-4,
                                   err_msg=name)


def test_fast_trace_sharded_stats_matches_single(world, jax_media):
    """Welford stats ride the sharded kernels: every mom_* plane the
    one-rank call's, sharded like the result, JAX's within 1e-5."""
    vals = D.result(world, "fast_stats")
    v = vals[0]
    assert v["engine"] == "fused-strat-sharded"
    _same_on_every_rank(vals, D.STATS_PLANES)
    _bit_equal(v, D.STATS_PLANES)
    _shards(vals)
    pos0, theta0 = D.profile_batch(R)
    j = jfast("op6", rt.scenario("vert"), jax_media["profile"], delta_s=0.01,
              steps=64, pos0=pos0, theta0=theta0, block_rays=128, stats=True)
    np.testing.assert_allclose(v["pos"], np.asarray(j.pos), atol=1e-5)
    for k in ("mom_count", "mom_mean", "mom_m2"):
        np.testing.assert_allclose(v[k], np.asarray(getattr(j, k)),
                                   atol=1e-5, err_msg=k)


def test_fast_trace_sharded_grid_medium(world, jax_media):
    """A 2-D grid through the grid route ("grid-sharded"): the one-rank
    call's to the bit, JAX's tiled kernel within 1e-5
    (tests/test_torch_grid.py)."""
    vals = D.result(world, "fast_grid")
    v = vals[0]
    assert (v["engine"], v["one_engine"]) == ("grid-sharded", "grid")
    _same_on_every_rank(vals, D.FAST_PLANES)
    _bit_equal(v, D.FAST_PLANES)
    _shards(vals)
    pos0 = np.tile(np.array([1.0, 0.0], np.float32), (R, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.01, 0.01, R)).astype(np.float32)
    j = jfast("op6", rt.scenario("fisheye"), jax_media["grid"], delta_s=0.01,
              steps=GRID_STEPS, pos0=pos0, theta0=theta0, block_rays=128)
    np.testing.assert_allclose(v["pos"], np.asarray(j.pos), atol=1e-5)


def test_c1_grid_sharded_entry(world, jax_media):
    """fast_trace_sharded takes the 2-D C1 medium too."""
    vals = D.result(world, "fast_grid_c1")
    v = vals[0]
    assert v["engine"] == "grid-sharded"
    assert np.all(np.isfinite(v["pos"]))
    _bit_equal(v, D.FAST_PLANES)
    pos0 = np.tile(np.array([1.0, 0.0], np.float32), (R, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.01, 0.01, R)).astype(np.float32)
    j = jfast("op6", rt.scenario("fisheye"), jax_media["c1"], delta_s=0.01,
              steps=16, pos0=pos0, theta0=theta0, block_rays=128)
    np.testing.assert_allclose(v["pos"], np.asarray(j.pos), atol=1e-5)


def test_tiled_sharded_matches_single(world, jax_media):
    """grid_trace_tiled(mesh=) and grid_trace_dynamic_tiled(mesh=): the
    one-rank calls to the bit; JAX's tiled kernels within 1e-5 in position
    (tests/test_torch_grid.py, tests/test_torch_dynamic_kernel.py); a batch
    that does not divide by devices x block is refused."""
    from raytracing_tpu.engine.segmented import (
        grid_trace_dynamic_tiled, grid_trace_tiled)

    vals = D.result(world, "grid_tiled")
    v = vals[0]
    _bit_equal(v["kin"], D.FAST_PLANES)
    _bit_equal(v["dyn"], ("pos", "traveltime", "q", "dtheta", "kmah"))
    for w in vals:
        assert "must divide by devices*block" in w["refused"]
    pos0, theta0 = D.fisheye_batch(R)
    kw = dict(steps=TILED_STEPS, box=tuple(rt.scenario("fisheye").box),
              block_rays=128, interpret=True)
    ds = np.float32(2 * np.pi / 4587)
    j = grid_trace_tiled("op6", pos0.astype(np.float32),
                         theta0.astype(np.float32), ds, jax_media["grid"],
                         **kw)
    np.testing.assert_allclose(v["kin"]["pos"], np.asarray(j.pos), atol=1e-5)
    np.testing.assert_allclose(v["kin"]["traveltime"],
                               np.asarray(j.traveltime), atol=5e-5)
    jd = grid_trace_dynamic_tiled("op6", pos0.astype(np.float32),
                                  theta0.astype(np.float32), ds,
                                  jax_media["grid"], **kw)
    np.testing.assert_allclose(v["dyn"]["pos"], np.asarray(jd.pos),
                               atol=1e-5)
    np.testing.assert_array_equal(v["dyn"]["kmah"], np.asarray(jd.kmah))


def _jax3(fn, jm, r):
    """JAX's tiled kernel on the first ``r`` rays of the ranks' fan."""
    from raytracing_tpu.engine import tiled3 as jt3

    pos0, dirs = (a[:r] for a in D.fan3(R))
    return getattr(jt3, fn)("op6", pos0, dirs, np.float32(2 * np.pi / 600),
                            jm, steps=TILED3_STEPS, box=D.BOX3,
                            block_rays=128, interpret=True)


def test_tiled3_sharded_matches_single(world, jax_media):
    """grid3_trace_tiled(mesh=) over a 1-D "rays" mesh: the one-rank call
    to the bit; JAX's tiled kernel within 5e-6 in position and 5e-5 in
    traveltime (tests/test_torch_fused3d.py) on its first block."""
    vals = D.result(world, "tiled3")
    _same_on_every_rank([w["kin"] for w in vals],
                        ("pos", "traveltime", "active"))
    v = vals[0]["kin"]
    _bit_equal(v, ("pos", "tangent", "traveltime", "dist_sim", "active"))
    j = _jax3("grid3_trace_tiled", jax_media["grid3"], 128)
    np.testing.assert_allclose(v["pos"][:128], np.asarray(j.pos), atol=5e-6)
    np.testing.assert_allclose(v["traveltime"][:128],
                               np.asarray(j.traveltime), atol=5e-5)


def test_dyn_tiled3_sharded_matches_single(world, jax_media):
    """grid3_trace_dynamic_tiled(mesh=): the one-rank call to the bit on
    pos, det Q, KMAH, traveltime and the locator; JAX's tiled kernel within
    5e-6 in position, KMAH equal (tests/test_torch_dynamic_grid3.py)."""
    vals = D.result(world, "tiled3")
    _same_on_every_rank([w["dyn"] for w in vals], ("pos", "detq", "kmah"))
    v = vals[0]["dyn"]
    _bit_equal(v, ("pos", "detq", "kmah", "traveltime", "min_absdet_step",
                   "active"))
    j = _jax3("grid3_trace_dynamic_tiled", jax_media["grid3"], 128)
    np.testing.assert_allclose(v["pos"][:128], np.asarray(j.pos), atol=5e-6)
    np.testing.assert_array_equal(v["kmah"][:128], np.asarray(j.kmah))


def test_sweep_sharded_over_mesh_matches_single_device(world):
    """run_candidates(mesh=) over a 4 x 1 (sweep, rays) mesh: the one-rank
    metrics to the bit on every rank (a ragged chunk too), JAX's scan tier
    within 1e-9; delta_s_search(mesh=) selects the same divisor on every
    rank through the scan tier, rank 0 writes the checkpoint, and a rerun
    resumes from it."""
    from raytracing_tpu.parallel import sweep as jsw

    vals = D.result(world, "sweep")
    for v in vals:
        np.testing.assert_array_equal(v["closure"], vals[0]["one"])
        np.testing.assert_array_equal(v["ragged"], vals[0]["one"][:9])
        assert v["search"] == vals[0]["search"]
        assert v["again"] == v["search"][:2]
        np.testing.assert_array_equal(v["metrics"], vals[0]["metrics"])
    assert vals[0]["search"][2] == "scan" and vals[0]["file"]
    divs = np.arange(60.0, 3.0, -1.0)[:16]
    sizes = (divs + 1).astype(np.int64)
    j = jsw.run_candidates("op1", rt.scenario("fisheye"),
                           rt.analytic_medium("fisheye"), 2 * np.pi / divs,
                           sizes - 1, int(sizes.max()), n_turns=1,
                           dtype=np.float64)
    np.testing.assert_allclose(vals[0]["closure"], j["closure_pct"],
                               atol=1e-9, rtol=0)


def test_eigenrays_sharded_over_mesh(world):
    """find_eigenrays(mesh=): the fan and every Newton batch split over the
    rays axis, the crossings gathered, the one-rank arrivals to the bit on
    every rank, and JAX's solver's within tests/test_torch_eigenray.py's
    bars."""
    from raytracing_tpu.engine import eigenray as jeig
    from raytracing_tpu.media.medium import CustomMedium as JCustom

    vals = D.result(world, "eigenrays")
    for k, (s, one) in vals[0].items():
        np.testing.assert_array_equal(s, one, err_msg=k)
    for v in vals[1:]:
        for k, (s, _) in v.items():
            np.testing.assert_array_equal(s, vals[0][k][0], err_msg=k)
    t = {k: s for k, (s, _) in vals[0].items()}
    assert len(t["theta0"]) >= 2
    j = jeig.find_eigenrays("op6", JCustom(
        lambda x, y: 1.5 - 0.5 * y * y + 0.0 * x), **D.EIG_KW)
    jo = np.lexsort((np.asarray(j.theta0), np.asarray(j.receiver)))
    to = np.lexsort((t["theta0"], t["receiver"]))
    np.testing.assert_array_equal(t["receiver"][to],
                                  np.asarray(j.receiver)[jo])
    for f in ("theta0", "traveltime"):
        np.testing.assert_allclose(t[f][to], np.asarray(getattr(j, f))[jo],
                                   atol=1e-9, rtol=0, err_msg=f)
