"""The port's parallel/distributed.py over a 4-rank gloo world on the CPU:
the mirrors of tests/test_distributed.py (the sharding helpers, the 3-axis
slice mesh and its refusal, trace_sharded against a single trace at
float64, summarize_sharded, the indivisible batch, fast_trace_sharded on
the stratified table and on a custom and a grid medium) and of
tests/test_diff.py's sharded gradient.

One world runs every case once (a module-scoped fixture,
tests/torch_dist_helpers.py); each test reads its case's per-rank results.
Every sharded result equals the port's one-rank call bit for bit, and the
JAX package's within the bars the port's other tests hold."""
import numpy as np
import pytest
import torch_dist_helpers as D
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine.fast import fast_trace as jfast  # noqa: E402

N = 4          # ranks
R = N * 128    # the kernel routes' batch: devices x JAX's 128-ray block
STEPS = 200


@pytest.fixture(scope="module")
def jax_media():
    from raytracing_tpu.media.hermite import build_hermite_medium
    from raytracing_tpu.media.spline import (
        build_grid_medium, build_stratified_medium)

    scen = rt.scenario("interface")
    strat = build_stratified_medium("interface", scen.box, dtype=np.float32)
    grid = build_hermite_medium(build_grid_medium(
        "fisheye", rt.scenario("fisheye").box, delta=0.05,
        dtype=np.float32))
    return strat, grid


def _kf(jm):
    return type(jm).__name__, H.medium_fields(jm)


@pytest.fixture(scope="module")
def world(jax_media, tmp_path_factory):
    strat, grid = jax_media
    cases = [("trace_sharded", ()), ("trace_sharded_indivisible", ()),
             ("helpers", ()), ("slices", ()),
             ("fast_strat", (_kf(strat), R, STEPS)),
             ("fast_custom", (_kf(grid), R)),
             ("diff_grad", (16, 60))]
    return D.run_world(N, cases, tmp_path_factory.mktemp("world"))


def _same_on_every_rank(vals, keys):
    for v in vals[1:]:
        for k in keys:
            np.testing.assert_array_equal(v[k], vals[0][k], err_msg=k)


def _bit_equal_to_one_rank(v, names):
    for k in names:
        if k in v:
            np.testing.assert_array_equal(v[k], v["one_" + k], err_msg=k)


def test_trace_sharded_matches_single_device(world):
    vals = D.result(world, "trace_sharded")
    _same_on_every_rank(vals, ("pos", "dist_sim", "exit_step"))
    v = vals[0]
    for a, b in (("pos", "one_pos"), ("dist_sim", "one_dist"),
                 ("exit_step", "one_exit")):
        np.testing.assert_array_equal(v[a], v[b], err_msg=a)
    # the result really is distributed: each rank holds its 16 rows
    for k, w in enumerate(vals):
        assert w["placements"] == "(Shard(dim=0),)"
        np.testing.assert_array_equal(w["local"], v["pos"][16 * k:16 * (k + 1)])
    scen, med = rt.scenario("fisheye"), rt.analytic_medium("fisheye")
    pos0, theta0 = D.fisheye_batch(64)
    single = rt.trace("op1", scen, med, delta_s=2 * np.pi / 64, divisor=65,
                      n_turns=1, mode="metrics", dtype=np.float64,
                      pos0=pos0, theta0=theta0)
    np.testing.assert_allclose(v["pos"], np.asarray(single.final.pos),
                               rtol=1e-12, atol=1e-12)


def test_summarize_reduces_on_device(world):
    vals = D.result(world, "trace_sharded")
    assert len({w["summary"] for w in vals}) == 1
    mean, total, rays = vals[0]["summary"]
    assert rays == 64
    assert mean < 1.0 and total > 0
    pos = vals[0]["pos"]
    closure = 100.0 * np.linalg.norm(pos - [1.0, 0.0], axis=-1) / (2 * np.pi)
    np.testing.assert_allclose(mean, closure.mean(), rtol=1e-12)
    np.testing.assert_allclose(total, vals[0]["dist_sim"].sum(), rtol=1e-12)


def test_trace_sharded_rejects_indivisible_batch(world):
    for msg in D.result(world, "trace_sharded_indivisible"):
        assert msg is not None and "not divisible" in msg


def test_mesh_sharding_helpers(world):
    for v in D.result(world, "helpers"):
        assert v["shape"] == (2, 2) and v["names"] == ("sweep", "rays")
        assert v["candidate_ray"][0] == (2, 8)
        assert v["ray"][0] == (8,)          # the rays axis' extent
        assert v["replicated"][0] == (4,)
        assert v["sweep"][0] == (4,)
        assert v["batch"] == ((4, 2), "(Shard(dim=0),)")


def test_slice_mesh_topology(world):
    vals = D.result(world, "slices")
    for k, v in enumerate(vals):
        assert v["names"] == ("slice", "sweep", "rays")
        assert v["shape"] == (2, 1, 2)
        # candidates over (slice, sweep) jointly: rank 2k and 2k+1 share
        np.testing.assert_array_equal(v["local"],
                                      np.arange(8.0)[4 * (k // 2):][:4])


def test_slice_mesh_rejects_indivisible(world):
    for v in D.result(world, "slices"):
        assert "slices=3 does not divide" in v[str(dict(n_devices=4,
                                                        slices=3))]
        assert "world size" in v[str(dict(n_devices=3))]
        assert "sweep=3 does not divide" in v[str(dict(sweep=3))]


def test_fast_trace_sharded_stratified(world, jax_media):
    """The sampled production medium: engine "fused-strat-sharded", every
    plane (stats included) the one-rank call's, JAX's kernel within the
    stratified bars (tests/test_torch_strat.py::tolerances)."""
    vals = D.result(world, "fast_strat")
    v = vals[0]
    assert (v["engine"], v["one_engine"]) == ("fused-strat-sharded",
                                              "fused-strat")
    _same_on_every_rank(vals, D.STATS_PLANES)
    _bit_equal_to_one_rank(v, D.STATS_PLANES)
    for k, w in enumerate(vals):
        np.testing.assert_array_equal(w["local"],
                                      v["pos"][128 * k:128 * (k + 1)])
    scen = rt.scenario("interface")
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), R)
    pos0 = np.tile(scen.pos0[:1].astype(np.float32), (R, 1))
    j = jfast("op6", scen, jax_media[0], delta_s=0.01, steps=STEPS,
              pos0=pos0, theta0=theta0, block_rays=128, stats=True)
    np.testing.assert_allclose(v["pos"], np.asarray(j.pos), atol=1e-5)
    np.testing.assert_allclose(v["traveltime"], np.asarray(j.traveltime),
                               atol=5e-5)
    for k in ("mom_count", "mom_mean", "mom_m2"):
        np.testing.assert_allclose(v[k], np.asarray(getattr(j, k)),
                                   atol=1e-5, err_msg=k)


def test_fast_trace_sharded_custom_medium_correct_physics(world, jax_media):
    """A constant CustomMedium gives straight rays on every shard
    ("fused-custom-sharded"); a 2-D grid goes through the grid route
    ("grid-sharded"), the one-rank call's to the bit and JAX's tiled
    kernel within the grid bar (tests/test_torch_grid.py)."""
    v = D.result(world, "fast_custom")[0]
    c = v["custom"]
    assert c["engine"] == "fused-custom-sharded"
    _bit_equal_to_one_rank(c, D.FAST_PLANES)
    # constant n: straight lines, 36 steps of 0.01 along each launch angle
    p0, t0 = D.fisheye_batch(R)
    t32 = t0.astype(np.float32)
    np.testing.assert_allclose(c["pos"][:, 0], 1.0 + 0.36 * np.cos(t32),
                               atol=1e-5)
    np.testing.assert_allclose(c["pos"][:, 1], 0.36 * np.sin(t32), atol=1e-5)
    g = v["grid"]
    assert g["engine"] == "grid-sharded"
    _bit_equal_to_one_rank(g, D.FAST_PLANES)
    assert np.all(np.isfinite(g["pos"]))
    j = jfast("op1", rt.scenario("fisheye"), jax_media[1], delta_s=0.01,
              steps=8, pos0=p0.astype(np.float32),
              theta0=t0.astype(np.float32), block_rays=128)
    np.testing.assert_allclose(g["pos"], np.asarray(j.pos), atol=1e-5)


def test_grad_sharded_over_mesh(world):
    """tests/test_diff.py:219 made small: the tomography gradient of a
    trace_diff loss, the ranks' shares summed by an autograd-aware
    all-reduce (and the ranks' gradients of it averaged), equals the
    one-process gradient at rtol 1e-12."""
    vals = D.result(world, "diff_grad")
    g_one, g_mesh, _ = vals[0]
    assert g_one != 0.0
    np.testing.assert_allclose(g_mesh, g_one, rtol=1e-12)
    for v in vals[1:]:
        assert v == vals[0]

