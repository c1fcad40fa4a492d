"""The dynamic kernels' plain versions (raytracing_tpu_torch.kernels.dynamic)
against the JAX package: the 9-channel Hessian evaluators against autodiff
and against JAX's evaluators; dynamic_step_plain against the JAX Pallas
kernels in interpret mode at float32 (dynamic_trace_final,
dynamic_trace_final_strat, grid_trace_dynamic_tiled) on the same inputs;
resume to the bit; fast_dynamic's routing, engine names and rejections."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu import config as jconfig  # noqa: E402
from raytracing_tpu.engine import segmented as jseg  # noqa: E402
from raytracing_tpu.kernels import dynamic as jkd  # noqa: E402
from raytracing_tpu.kernels import fused as jfused  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import samples as jsamples  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import segmented as tseg  # noqa: E402
from raytracing_tpu_torch.kernels import dynamic as tkd  # noqa: E402
from raytracing_tpu_torch.kernels import fused as tfused  # noqa: E402

F32 = np.float32
R = 128
#: plain version against the Pallas kernel at float32: position 1e-5,
#: traveltime 5e-6 (measured 2.4e-6 at most), q and dtheta 1e-4 of their
#: largest magnitude (measured 6.9e-5 and 3.4e-5), KMAH equal on every ray
#: (ROADMAP.md §3 has the measurements)
POS_TOL, TT_TOL, TANGENT_TOL = 1e-5, 5e-6, 1e-4


# -- the Hessian evaluators ----------------------------------------------------
@pytest.mark.parametrize("field", tkd.DYN_FUSED_FIELDS)
def test_field_hessians_match_autodiff_and_jax(field):
    f = tkd.field_fn_h(field)
    med = rtt.analytic_medium(field)
    pts = [(0.3, 0.4), (-0.5, 0.2), (1.0, -0.1), (0.0, 0.0), (0.2, -0.003)]
    for x, y in pts:
        p = torch.tensor([x, y], dtype=torch.float64)
        hess = torch.func.hessian(lambda q: med.n(q[0], q[1]))(p)
        grad = torch.func.grad(lambda q: med.n(q[0], q[1]))(p)
        ch = [float(c) for c in f(torch.tensor(x, dtype=torch.float64),
                                  torch.tensor(y, dtype=torch.float64))]
        want = [float(med.n(p[0], p[1])), grad[0], grad[1], grad[0], grad[1],
                hess[0, 0], hess[0, 1], hess[1, 0], hess[1, 1]]
        np.testing.assert_allclose(ch, [float(w) for w in want], rtol=1e-9,
                                   atol=1e-12)
        jch = jkd._field_fn_h(field)(jnp.float64(x), jnp.float64(y))
        np.testing.assert_allclose(ch, [float(c) for c in jch], rtol=1e-14,
                                   atol=1e-14)


def _directional(med, x, y):
    """(gnx, gny, hxx, hxy, hyx, hyy) of a scan-tier medium by jvp along
    the unit vectors."""
    def nag3(a, b):
        n, (gx, gy) = med.n_and_grad(a, b)
        return n, gx, gy
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    _, (gnx, hxx, hyx) = torch.func.jvp(nag3, (x, y), (one, zero))
    _, (gny, hxy, hyy) = torch.func.jvp(nag3, (x, y), (zero, one))
    return gnx, gny, hxx, hxy, hyx, hyy


def _hessian_of_n_matches(med, x, y, ch, points=8):
    """The C1 channels' (hxx, hxy, hyy) are torch.func.hessian of the
    medium's n, point by point."""
    for k in range(points):
        p = torch.stack([x[k], y[k]])
        h = torch.func.hessian(lambda q: med.n(q[0:1], q[1:2])[0])(p)
        np.testing.assert_allclose(
            [float(ch[5][k]), float(ch[6][k]), float(ch[7][k]),
             float(ch[8][k])],
            [float(h[0, 0]), float(h[0, 1]), float(h[1, 0]), float(h[1, 1])],
            rtol=1e-10, atol=1e-10)


def _points(rng, box, n=128):
    return (rng.uniform(box[0], box[1], n), rng.uniform(box[2], box[3], n))


@pytest.mark.parametrize("family", ["parity", "c1"])
def test_strat_channels_match_jvp_and_jax(family):
    vert = rt.scenario("vert")
    build = (jspline.build_stratified_medium if family == "parity"
             else jc1.build_c1_stratified)
    jm = build("vert_heterogeneous", vert.box, 0.05, dtype=np.float64)
    tm = H.port_medium(jm)
    xs, ys = _points(np.random.default_rng(0), (-2.0, 4.0, -2.4, 0.9))
    x, y = torch.as_tensor(xs), torch.as_tensor(ys)
    ch = tkd.strat_nag_h(tfused.strat_tables(tm, torch.float64))(x, y)
    n, (gx, gy) = tm.n_and_grad(x, y)
    gnx, gny, hxx, hxy, hyx, hyy = _directional(tm, x, y)
    for got, want in zip(ch, (n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy)):
        np.testing.assert_allclose(H.to_np(got), H.to_np(want), rtol=1e-12,
                                   atol=1e-12)
    if family == "c1":
        _hessian_of_n_matches(tm, x, y, ch)
    # JAX's evaluator on its own lane-chunk tables, float32
    tables, strat, _ = jfused.strat_tables(jm, 1)
    jch = jkd._strat_nag_h(tables, *strat)(
        jnp.asarray(xs[None], jnp.float32), jnp.asarray(ys[None], jnp.float32))
    ch32 = tkd.strat_nag_h(tfused.strat_tables(tm))(x.float(), y.float())
    for got, want in zip(ch32, jch):
        np.testing.assert_allclose(H.to_np(got), np.asarray(want)[0],
                                   rtol=2e-6, atol=2e-6)


def _small_grids():
    """A 13 x 13-node fisheye-like grid, parity and C1 (JAX media)."""
    ax = np.linspace(-1.5, 1.5, 13)
    X, Y = np.meshgrid(ax, ax)
    Z = 1.0 / (1.0 + X ** 2 + Y ** 2 + 0.3 * X * Y)
    parity = jherm.build_hermite_medium(
        jspline.grid_medium_from_samples(Z, ax, ax, dtype=np.float64,
                                         backend="scipy"), dtype=np.float64)
    c1 = jc1.c1_medium_from_samples(Z, ax, ax, dtype=np.float64,
                                    backend="scipy")
    return {"parity": parity, "c1": c1}


def _jax_tile_channels(jm, xs, ys):
    """JAX's _tile_nag_h / _tile_nag_c1_h with a window over the whole
    grid (base 0, every cell), at float64."""
    ch = int(jm.nodes.shape[-1])
    nodes3d = jnp.asarray(jm.nodes).reshape(jm.ny, jm.nx, ch)
    c36 = np.asarray(jseg._cells36(nodes3d))
    ncell = c36.shape[0]
    nch = -(-ncell // 128)
    c36 = np.concatenate([c36, np.zeros((nch * 128 - ncell, 4 * ch))])
    c36 = c36.reshape(nch, 128, 4 * ch)
    T = [jnp.asarray(c36[k, :, j][None]) for k in range(nch)
         for j in range(4 * ch)]
    meta = (float(jm.x0), float(jm.y0), float(jm.inv_hx), float(jm.inv_hy),
            int(jm.nx), int(jm.ny), int(jm.ny) - 1, int(jm.nx) - 1)
    nag = (jkd._tile_nag_h if ch == 9 else jkd._tile_nag_c1_h)(
        T, 0.0, 0.0, meta)
    return [np.asarray(c)[0] for c in nag(jnp.asarray(xs[None]),
                                          jnp.asarray(ys[None]))]


@pytest.mark.parametrize("family", ["parity", "c1"])
def test_grid_channels_match_jvp_and_jax(family):
    jm = _small_grids()[family]
    tm = H.port_medium(jm)
    xs, ys = _points(np.random.default_rng(1), (-1.4, 1.4, -1.4, 1.4))
    x, y = torch.as_tensor(xs), torch.as_tensor(ys)
    ch = tkd.tile_nag_h(tseg.grid_tables(tm, torch.float64))(x, y)
    n, (gx, gy) = tm.n_and_grad(x, y)
    gnx, gny, hxx, hxy, hyx, hyy = _directional(tm, x, y)
    for got, want in zip(ch, (n, gx, gy, gnx, gny, hxx, hxy, hyx, hyy)):
        np.testing.assert_allclose(H.to_np(got), H.to_np(want), rtol=1e-10,
                                   atol=1e-10)
    if family == "parity":
        # the gradient surfaces are independent bicubics: hxy != hyx
        assert float((ch[6] - ch[7]).abs().max()) > 1e-4
    else:
        # one patch: the Hessian of n itself, symmetric
        _hessian_of_n_matches(tm, x, y, ch)
    for got, want in zip(ch, _jax_tile_channels(jm, xs, ys)):
        np.testing.assert_allclose(H.to_np(got), want, rtol=1e-12,
                                   atol=1e-12)


# -- the plain versions against the Pallas kernels ------------------------------
def launch(field, r=R):
    """(pos0, theta0, delta_s, steps, box) of tests/test_dynamic_kernel.py."""
    if field == "fisheye":
        theta0 = (np.pi / 2 + np.linspace(-0.2, 0.2, r)).astype(F32)
        pos0 = np.tile(np.array([1.0, 0.0], F32), (r, 1))
        return pos0, theta0, F32(2 * np.pi / 300), 300, (-1.5, 1.5, -1.5, 1.5)
    if field == "vert_heterogeneous":
        theta0 = np.linspace(0.05, np.pi / 2 - 0.05, r).astype(F32)
        pos0 = np.tile(np.array([0.0, 0.0], F32), (r, 1))
        return pos0, theta0, F32(0.01), 250, (-2.0, 5.0, -2.5, 1.0)
    theta0 = np.linspace(np.pi / 30, np.pi / 2 - 0.05, r).astype(F32)
    pos0 = np.tile(np.array([-2.0, -2.0], F32), (r, 1))
    return pos0, theta0, F32(0.01), 250, (-2.0, 20.0, -2.0, 4.0)


def assert_close(t, j):
    """Port DynFinal against JAX DynFinal at the float32 bars."""
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos),
                               atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), atol=TT_TOL, rtol=0)
    for f in ("q", "dtheta"):
        a, b = H.to_np(getattr(t, f)), np.asarray(getattr(j, f))
        assert np.abs(a - b).max() <= TANGENT_TOL * np.abs(b).max(), f
    np.testing.assert_array_equal(H.to_np(t.kmah), np.asarray(j.kmah))
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))
    np.testing.assert_allclose(H.to_np(t.n), np.asarray(j.n), atol=5e-6,
                               rtol=0)


@pytest.mark.parametrize("field", tkd.DYN_FUSED_FIELDS)
@pytest.mark.parametrize("op", tkd.DYN_FUSED_OPS)
def test_analytic_plain_matches_pallas(op, field):
    pos0, theta0, ds, steps, box = launch(field)
    j = jkd.dynamic_trace_final(jnp.asarray(pos0), jnp.asarray(theta0), ds,
                                field=field, op=op, steps=steps, box=box,
                                block_rays=R, interpret=True)
    t = tkd.dynamic_trace_final(pos0, theta0, float(ds), field=field, op=op,
                                steps=steps, box=box, device="cpu")
    assert_close(t, j)


@pytest.mark.parametrize("case", [("parity", "vert_heterogeneous"),
                                  ("c1", "vert_heterogeneous"),
                                  ("parity", "interface")])
@pytest.mark.parametrize("op", tkd.DYN_FUSED_OPS)
def test_strat_plain_matches_pallas(op, case):
    family, field = case
    pos0, theta0, ds, steps, box = launch(field)
    build = (jspline.build_stratified_medium if family == "parity"
             else jc1.build_c1_stratified)
    scen = "interface" if field == "interface" else "vert"
    jm = jsamples.compact_for_trace(
        build(field, rt.scenario(scen).box, dtype=np.float32), box, ds)
    j = jkd.dynamic_trace_final_strat(jnp.asarray(pos0), jnp.asarray(theta0),
                                      ds, jm, op=op, steps=steps, box=box,
                                      block_rays=R, interpret=True)
    t = tkd.dynamic_trace_final_strat(pos0, theta0, float(ds),
                                      H.port_medium(jm), op=op, steps=steps,
                                      box=box, device="cpu")
    assert_close(t, j)


@pytest.fixture(scope="module")
def fisheye_grids():
    box = rt.scenario("fisheye").box
    gm = jspline.build_grid_medium("fisheye", box, 0.05, dtype=np.float32,
                                   backend="scipy")
    return {"parity": jherm.build_hermite_medium(gm, dtype=np.float32),
            "c1": jc1.build_c1_medium("fisheye", box, 0.05, dtype=np.float32,
                                      backend="scipy")}


@pytest.mark.parametrize("family", ["parity", "c1"])
@pytest.mark.parametrize("op", ["op1", "op6"])
def test_grid_plain_matches_pallas(op, family, fisheye_grids):
    jm = fisheye_grids[family]
    rng = np.random.default_rng(0)
    pos0 = np.tile(np.array([[1.0, 0.0]], F32), (R, 1))
    theta0 = (np.pi / 2 + rng.uniform(-0.05, 0.05, R)).astype(F32)
    ds, steps = F32(2 * np.pi / 300), 120
    box = tuple(rt.scenario("fisheye").box)
    j = jseg.grid_trace_dynamic_tiled(op, pos0, theta0, ds, jm, steps=steps,
                                      box=box, block_rays=R, interpret=True)
    t = tseg.grid_trace_dynamic_tiled(op, pos0, theta0, float(ds),
                                      H.port_medium(jm), steps=steps,
                                      box=box, device="cpu")
    assert_close(t, j)


@pytest.mark.parametrize("field", ["interface", "strat", "grid"])
def test_resume_equals_one_run(field):
    """k steps, then n - k from offset k, equal n steps to the bit."""
    if field == "strat":
        med = rtt.build_c1_stratified("vert_heterogeneous",
                                      rtt.scenario("vert").box, device="cpu")
        tab, kind = tfused.strat_tables(med), "vert_heterogeneous"
    elif field == "grid":
        tab = tseg.grid_tables(rtt.build_hermite_medium(rtt.build_grid_medium(
            "fisheye", rtt.scenario("fisheye").box, 0.05, device="cpu")))
        kind = "fisheye"
    else:
        tab = kind = field
    pos0, theta0, ds, steps, box = launch(kind, 64)
    st = tkd.initial_dyn_state(pos0, theta0, device="cpu")
    for op in tkd.DYN_FUSED_OPS:
        kw = dict(field=tab, op=op, delta_s=ds, step_limit=120, box=box)
        one = tkd.dynamic_step(st, steps=120, **kw)
        two = tkd.dynamic_step(tkd.dynamic_step(st, steps=45, **kw),
                               steps=75, offset=45.0, **kw)
        for name, a, b in zip(tkd.DynState._fields, one, two):
            assert torch.equal(a, b), (op, name)


# -- fast_dynamic ---------------------------------------------------------------
def test_fast_dynamic_routes_like_jax():
    """Analytic, stratified and grid media go to the three kernels, golden
    ops and custom media to the scan tier; engines as JAX names them (the
    grid one says "grid" for the port's one launch); results agree with
    JAX's routes."""
    field = "vert_heterogeneous"
    r = 100
    pos0, theta0, ds, steps, box = launch(field, r)
    steps = 120
    scen = jconfig.ScenarioConfig(name="t", key="-", field=field, gamma=1.0,
                                  ray_count=r, theta0=theta0, pos0=pos0,
                                  s_max=0.0, box=box)
    tscen = rtt.ScenarioConfig(name="t", key="-", field=field, gamma=1.0,
                               ray_count=r, theta0=theta0, pos0=pos0,
                               s_max=0.0, box=box)
    from raytracing_tpu.engine.fast import fast_dynamic as jfast
    jstrat = jspline.build_stratified_medium(field, box)
    kw = dict(delta_s=ds, pos0=pos0, theta0=theta0, steps=steps)
    cases = [("op6", rt.analytic_medium(field), rtt.analytic_medium(field),
              "dynamic-kernel"),
             ("op2", jstrat, H.port_medium(jstrat), "dynamic-kernel-strat"),
             ("op5", rt.analytic_medium(field), rtt.analytic_medium(field),
              "dynamic-scan")]
    for op, jm, tm, engine in cases:
        j, jeng = jfast(op, scen, jm, block_rays=128, interpret=True,
                        **{**kw, "steps": 20 if engine == "dynamic-scan"
                           else steps})
        t, teng = rtt.fast_dynamic(op, tscen, tm, device="cpu",
                                   **{**kw, "steps": 20 if engine ==
                                      "dynamic-scan" else steps})
        assert teng == engine and jeng == engine
        assert t.q.shape == (r,)
        assert_close(t, j)
    fish = rtt.scenario("fisheye")
    grid = rtt.build_grid_medium("fisheye", fish.box, 0.05, device="cpu")
    _, eng = rtt.fast_dynamic("op6", fish, grid, delta_s=2 * np.pi / 300,
                              pos0=fish.pos0, theta0=fish.theta0, steps=20,
                              device="cpu")
    assert eng == "dynamic-kernel-grid"
    custom = rtt.CustomMedium(lambda x, y: 1.0 / (18.0 + 2.0 * y))
    _, eng = rtt.fast_dynamic("op6", tscen, custom, delta_s=ds, pos0=pos0,
                              theta0=theta0, steps=5, device="cpu")
    assert eng == "dynamic-scan"
    # the kinematic kernels take the custom medium (kernels/custom.py)
    res = rtt.fast_trace("op6", tscen, custom, delta_s=ds, pos0=pos0,
                         theta0=theta0, steps=5, device="cpu")
    assert res.engine == "fused-custom"


def test_dynamic_kernels_reject_golden_and_unknown():
    pos0, th = np.zeros((8, 2), F32), np.zeros(8, F32)
    with pytest.raises(ValueError, match="zero a.e."):
        tkd.dynamic_trace_final(pos0, th, 0.01, field="fisheye", op="op5",
                                steps=4, box=(-1, 1, -1, 1), device="cpu")
    with pytest.raises(ValueError, match="fields"):
        tkd.dynamic_trace_final(pos0, th, 0.01, field="nope", op="op6",
                                steps=4, box=(-1, 1, -1, 1), device="cpu")
    med = rtt.build_stratified_medium("vert_heterogeneous", (-2, 5, -2.5, 1),
                                      device="cpu")
    with pytest.raises(ValueError, match="zero a.e."):
        tkd.dynamic_trace_final_strat(pos0, th, 0.01, med, op="op9",
                                      steps=4, box=(-1, 1, -1, 1),
                                      device="cpu")
    with pytest.raises(ValueError, match="supports"):
        tseg.grid_trace_dynamic_tiled("op5", pos0, th, 0.001, None, steps=8,
                                      box=(-1, 1, -1, 1), device="cpu")
    st = tkd.initial_dyn_state(pos0, th, device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        tkd.dynamic_step(st._replace(kmah=st.kmah.double()),
                         field="fisheye", op="op6", steps=1, delta_s=0.01,
                         step_limit=1, box=(-1, 1, -1, 1))


def test_dynamic_state_crosses_over_from_jax_layout():
    """JAX's 18-component dynamic resume list (segmented.py:1844-1850) maps
    onto DynState plane by plane, and back."""
    from raytracing_tpu_torch.interop import (dynamic_state_from_numpy,
                                              dynamic_state_to_numpy)
    pos0, theta0, ds, steps, box = launch("fisheye", 16)
    zeros, ones = np.zeros(16, F32), np.ones(16, F32)
    comps = [pos0[:, 0], pos0[:, 1], zeros, zeros, np.cos(theta0),
             np.sin(theta0), zeros, zeros, ones, zeros, zeros, ones, zeros,
             zeros, zeros, zeros, zeros, zeros]
    st = dynamic_state_from_numpy(comps, device="cpu")
    want = tkd.initial_dyn_state(pos0, theta0, device="cpu")
    for name, a, b in zip(tkd.DynState._fields, st, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=name)
    st = tkd.dynamic_step(st, field="fisheye", op="op6", steps=40,
                          delta_s=ds, step_limit=40, box=box)
    back = dynamic_state_to_numpy(st)
    assert len(back) == 18 and all(b.dtype == np.float32 for b in back)
    again = dynamic_state_from_numpy(back, device="cpu")
    for name, a, b in zip(tkd.DynState._fields, again, st):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="18 components"):
        dynamic_state_from_numpy(comps[:17], device="cpu")
