"""The port's dynamic scan tier (raytracing_tpu_torch.engine.dynamic) against
the JAX package's trace_dynamic at float64: every smooth op on the analytic
fields in history and metrics modes, op6 and op8 on the sampled media
(parity and C1, stratified and 2-D), the hand-stepped op6 against its jvp,
the on-device crossing records (an exact landing included), and the
homogeneous and fisheye oracles.  Inputs come from numpy; media cross over
through interop."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine import dynamic as jdyn  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402
from raytracing_tpu.media.medium import CustomMedium as JCustom  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import dynamic as tdyn  # noqa: E402
from raytracing_tpu_torch.media.medium import CustomMedium  # noqa: E402

ATOL = 1e-9
F64 = np.float64
SMOOTH = ("op1", "op2", "op3", "op4", "op6", "op7", "op8", "op12")


def homog_jax():
    return JCustom(lambda x, y: jnp.ones_like(x) + 0.0 * y)


def homog():
    """The homogeneous medium, with its (zero) gradient written out."""
    return CustomMedium(lambda x, y: torch.ones_like(x) + 0.0 * y,
                        lambda x, y: (0.0 * x, 0.0 * y))


def run_both(op, scen_name, jmed, tmed, *, mode, **kw):
    j = jdyn.trace_dynamic(op, rt.scenario(scen_name), jmed, dtype=F64,
                           mode=mode, **kw)
    t = tdyn.trace_dynamic(op, rtt.scenario(scen_name), tmed,
                           dtype=torch.float64, mode=mode, device="cpu", **kw)
    return j, t


def assert_same(j, t, atol=ATOL):
    for f in ("pos", "angle", "n", "traveltime", "dist_sim", "dist_real", "q",
              "dtheta", "n0"):
        np.testing.assert_allclose(H.to_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), atol=atol,
                                   rtol=0, err_msg=f)
    for f in ("kmah", "exit_step"):
        np.testing.assert_array_equal(H.to_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    if j.history is not None:
        np.testing.assert_allclose(H.to_np(t.history), np.asarray(j.history),
                                   atol=atol, rtol=0)


def fisheye_fan(r=8, seed=0):
    rng = np.random.default_rng(seed)
    return (np.tile([[1.0, 0.0]], (r, 1)),
            np.pi / 2 + rng.uniform(-0.2, 0.2, r))


@pytest.mark.parametrize("op", SMOOTH)
def test_fisheye_history_matches_jax(op):
    """Half a turn and more on the fisheye: q passes the antipodal caustic,
    so the KMAH counts are 1."""
    pos0, theta0 = fisheye_fan()
    j, t = run_both(op, "fisheye", rt.analytic_medium("fisheye"),
                    rtt.analytic_medium("fisheye"), mode="history",
                    delta_s=2 * np.pi / 120, max_size=81, pos0=pos0,
                    theta0=theta0)
    assert_same(j, t)
    assert (H.to_np(t.kmah) == 1).all()


@pytest.mark.parametrize("op", SMOOTH)
@pytest.mark.parametrize("scen_name", ["interface", "vert"])
def test_exit_scenarios_metrics_match_jax(op, scen_name):
    rng = np.random.default_rng(1)
    if scen_name == "interface":
        pos0, theta0 = H.fan_near_interface(rng, 12)
        kw = dict(delta_s=0.01, max_size=60)
        field = "interface"
    else:
        pos0, theta0 = H.fan_vert(rng, 12)
        kw = dict(delta_s=0.05, max_size=60)
        field = "vert_heterogeneous"
    j, t = run_both(op, scen_name, rt.analytic_medium(field),
                    rtt.analytic_medium(field), mode="metrics", pos0=pos0,
                    theta0=theta0, **kw)
    assert_same(j, t)


def test_newton_op_on_the_anisotropic_scenario_matches_jax():
    rng = np.random.default_rng(2)
    pos0, theta0 = H.fan_vert(rng, 4)
    j, t = run_both("op11n", "aniso", rt.analytic_medium("vert_heterogeneous"),
                    rtt.analytic_medium("vert_heterogeneous"),
                    mode="history", delta_s=0.05, max_size=8, pos0=pos0,
                    theta0=theta0)
    assert_same(j, t)


@pytest.fixture(scope="module")
def sampled():
    """(JAX, port) pairs of the four sampled families, coarse (delta 0.05),
    float64."""
    fish, vert = rt.scenario("fisheye"), rt.scenario("vert")
    gm = jspline.build_grid_medium("fisheye", fish.box, 0.05, dtype=F64,
                                   backend="scipy")
    media = {
        "strat": jspline.build_stratified_medium(
            "vert_heterogeneous", vert.box, dtype=F64),
        "c1_strat": jc1.build_c1_stratified("vert_heterogeneous", vert.box,
                                            dtype=F64),
        "grid": gm,
        "hermite": jherm.build_hermite_medium(gm, dtype=F64),
        "c1_grid": jc1.build_c1_medium("fisheye", fish.box, 0.05, dtype=F64,
                                       backend="scipy"),
    }
    return {k: (m, H.port_medium(m)) for k, m in media.items()}


SAMPLED_CASES = ([(op, kind) for op in ("op6", "op8")
                  for kind in ("strat", "c1_strat", "grid", "hermite",
                               "c1_grid")]
                 + [(op, "strat") for op in ("op1", "op2", "op3", "op4",
                                             "op7", "op12")]
                 + [(op, "c1_grid") for op in ("op1", "op2")])


@pytest.mark.parametrize("op,kind", SAMPLED_CASES)
def test_sampled_media_match_jax(op, kind, sampled):
    """op6 reads the media's closed-form channels (in history mode), the
    other ops differentiate the step with torch.func.jvp: all equal JAX's
    jvp through the gathered spline."""
    jm, tm = sampled[kind]
    if kind.endswith("strat"):
        rng = np.random.default_rng(3)
        pos0, theta0 = H.fan_vert(rng, 8)
        kw = dict(delta_s=0.05, max_size=40)
        scen_name = "vert"
    else:
        pos0, theta0 = fisheye_fan()
        kw = dict(delta_s=2 * np.pi / 120, max_size=50)
        scen_name = "fisheye"
    j, t = run_both(op, scen_name, jm, tm,
                    mode="history" if op == "op6" else "metrics", pos0=pos0,
                    theta0=theta0, **kw)
    assert_same(j, t)


def test_hand_op6_matches_its_jvp():
    """The compensated hand step and torch.func.jvp of the op6 step are the
    same derivative: equal to roundoff at float64."""
    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    theta0 = torch.as_tensor(np.pi / 2 + np.linspace(-0.1, 0.1, 16))
    pos0 = torch.as_tensor(np.tile([[1.0, 0.0]], (16, 1)))
    args = (pos0, theta0, med, 1.0, 2 * np.pi / 300, 200, tuple(scen.box))
    hand = tdyn._build_dynamic_fn("op6", 201, "metrics", torch.float64)
    tdyn.HAND_TANGENT = False
    try:
        jvp = tdyn._build_dynamic_fn("op6", 201, "metrics", torch.float64)
    finally:
        tdyn.HAND_TANGENT = True
    a, b = hand(*args), jvp(*args)
    np.testing.assert_allclose(H.to_np(a.q), H.to_np(b.q), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(H.to_np(a.dtheta), H.to_np(b.dtheta),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(H.to_np(a.kmah), H.to_np(b.kmah))


@pytest.mark.parametrize("kind", ("strat", "c1_strat", "grid", "hermite",
                                  "c1_grid"))
def test_hand_op6_matches_its_jvp_on_sampled_media(kind, sampled):
    """On the sampled media the hand step reads the kernels' 9-channel
    evaluators and the jvp differentiates the medium's own n_and_grad: the
    two tangents agree to roundoff at float64, so the jvp run is an
    independent oracle for those channels."""
    tm = sampled[kind][1]
    if kind.endswith("strat"):
        scen = rtt.scenario("vert")
        pos0, theta0 = H.fan_vert(np.random.default_rng(4), 16)
        ds, steps = 0.05, 60
    else:
        scen = rtt.scenario("fisheye")
        pos0, theta0 = fisheye_fan(16)
        ds, steps = 2 * np.pi / 120, 80
    args = (torch.as_tensor(pos0), torch.as_tensor(theta0), tm, 1.0, ds,
            steps, tuple(scen.box))
    hand = tdyn._build_dynamic_fn("op6", steps + 1, "metrics", torch.float64)
    tdyn.HAND_TANGENT = False
    try:
        jvp = tdyn._build_dynamic_fn("op6", steps + 1, "metrics",
                                     torch.float64)
    finally:
        tdyn.HAND_TANGENT = True
    a, b = hand(*args), jvp(*args)
    np.testing.assert_allclose(H.to_np(a.pos), H.to_np(b.pos), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(H.to_np(a.q), H.to_np(b.q), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(H.to_np(a.dtheta), H.to_np(b.dtheta),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(H.to_np(a.kmah), H.to_np(b.kmah))


def test_crossing_records_match_jax():
    """cross_fan and cross_pick against JAX on a homogeneous fan whose
    axial ray lands exactly on x = 1.0 (50 compensated steps of 0.02)."""
    scen = dataclasses.replace(rt.scenario("interface"),
                               box=(-1.0, 3.0, -1.0, 1.0))
    tscen = dataclasses.replace(rtt.scenario("interface"),
                                box=(-1.0, 3.0, -1.0, 1.0))
    theta0 = np.linspace(-0.2, 0.2, 9)
    pos0 = np.zeros((9, 2))
    kw = dict(delta_s=0.02, max_size=120, pos0=pos0, theta0=theta0)
    ranges = np.array([1.0, 1.5, 2.0])
    jf = jdyn.trace_crossings_fan("op6", scen, homog_jax(), ranges=ranges,
                                  max_ord=2, dtype=F64, **kw)
    tf = tdyn.trace_crossings_fan("op6", tscen, homog(), ranges=ranges,
                                  max_ord=2, dtype=torch.float64,
                                  device="cpu", **kw)
    np.testing.assert_array_equal(H.to_np(tf.counts), np.asarray(jf.counts))
    np.testing.assert_allclose(H.to_np(tf.depths), np.asarray(jf.depths),
                               atol=ATOL, rtol=0)
    assert (H.to_np(tf.counts)[4] == 1).all()     # the exact landings
    xr = np.array([1.0, 1.5, 2.0, 1.0, 5.0, 1.5, 2.0, 1.0, 1.5])
    ordk = np.array([0, 0, 1, 3, 0, 0, 0, 0, 2], np.int32)
    jp = jdyn.trace_crossings_pick("op6", scen, homog_jax(), xr=xr,
                                   ordk=ordk, dtype=F64, **kw)
    tp = tdyn.trace_crossings_pick("op6", tscen, homog(), xr=xr, ordk=ordk,
                                   dtype=torch.float64, device="cpu", **kw)
    np.testing.assert_array_equal(H.to_np(tp.found), np.asarray(jp.found))
    np.testing.assert_allclose(H.to_np(tp.state), np.asarray(jp.state),
                               atol=ATOL, rtol=0)
    assert not H.to_np(tp.found)[4]               # x = 5 is never reached


def test_crossing_records_match_the_host_scans_of_the_history():
    """The on-device crossing records equal the eigenray module's host scans
    (``_crossing_depths``, ``_crossing_vals``, ``_pick_crossings``) of the
    same fan's history, exact landing included; the port's host scans equal
    the JAX package's on the same arrays."""
    from raytracing_tpu.engine import eigenray as jeig
    from raytracing_tpu_torch.engine import eigenray as teig
    tscen = dataclasses.replace(rtt.scenario("interface"),
                                box=(-1.0, 3.0, -1.0, 1.0))
    theta0 = np.linspace(-0.2, 0.2, 9)
    kw = dict(delta_s=0.02, max_size=120, pos0=np.zeros((9, 2)),
              theta0=theta0, dtype=torch.float64, device="cpu")
    res = tdyn.trace_dynamic("op6", tscen, homog(), mode="history", **kw)
    hist, last = H.to_np(res.history), H.to_np(res.exit_step)
    ranges = np.array([1.0, 1.5, 2.0])
    fan = tdyn.trace_crossings_fan("op6", tscen, homog(), ranges=ranges,
                                   max_ord=2, **kw)
    for j, xr in enumerate(ranges):
        d = teig._crossing_depths(hist, last, xr)
        np.testing.assert_allclose(H.to_np(fan.depths)[:, j, :d.shape[1]], d,
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(d, jeig._crossing_depths(hist, last, xr))
        cols = (tdyn.DYN_COLS.index("y"), tdyn.DYN_COLS.index("q"))
        np.testing.assert_array_equal(
            teig._crossing_vals(hist, last, xr, cols),
            jeig._crossing_vals(hist, last, xr, cols))
    xr = np.array([1.0, 1.5, 2.0, 1.0, 5.0, 1.5, 2.0, 1.0, 1.5])
    ordk = np.array([0, 0, 1, 3, 0, 0, 0, 0, 2], np.int32)
    pick = tdyn.trace_crossings_pick("op6", tscen, homog(), xr=xr, ordk=ordk,
                                     **kw)
    state, found = teig._pick_crossings(hist, last, xr, ordk)
    np.testing.assert_array_equal(H.to_np(pick.found), found)
    np.testing.assert_allclose(H.to_np(pick.state), state[:, 1:], atol=ATOL,
                               rtol=0)
    for got, want in zip((state, found),
                         jeig._pick_crossings(hist, last, xr, ordk)):
        np.testing.assert_array_equal(got, want)


def test_homogeneous_spreading_is_exact():
    """Straight rays: q(s) = s, dtheta = 1, no caustics, TL = 10 log10 s."""
    res = tdyn.trace_dynamic("op1", rtt.scenario("interface"), homog(),
                             delta_s=0.05, dtype=torch.float64, device="cpu",
                             max_size=60, pos0=np.zeros((3, 2)),
                             theta0=np.array([0.3, 0.8, 1.2]))
    s = H.to_np(res.dist_real)
    assert s.min() > 1.0
    np.testing.assert_allclose(H.to_np(res.q), s, rtol=0, atol=1e-12)
    np.testing.assert_allclose(H.to_np(res.dtheta), 1.0, atol=1e-12)
    assert (H.to_np(res.kmah) == 0).all()
    np.testing.assert_allclose(H.to_np(res.transmission_loss_db()),
                               10 * np.log10(s), atol=1e-10)
    one = torch.ones((), dtype=torch.float64)
    assert float(tdyn.spreading_amplitude(one, one, one)) == 1.0


def test_fisheye_refocus_caustic_and_kmah():
    """Perfect imaging: q crosses zero once near the antipode (s = pi) and
    collapses again at the source after the turn; KMAH 1."""
    div = 600
    res = tdyn.trace_dynamic("op6", rtt.scenario("fisheye"),
                             rtt.analytic_medium("fisheye"),
                             delta_s=2 * np.pi / div, divisor=div + 1,
                             n_turns=1, dtype=torch.float64, device="cpu",
                             pos0=np.array([[1.0, 0.0]] * 2),
                             theta0=np.array([np.pi / 2, np.pi / 2 + 0.3]))
    h = H.to_np(res.history)
    q = h[1:, 0, tdyn.DYN_COLS.index("q")]
    crossings = np.where(np.sign(q[:-1]) * np.sign(q[1:]) < 0)[0]
    assert len(crossings) == 1
    assert abs(int(crossings[0]) + 1 - div // 2) <= 2
    assert H.to_np(res.kmah).tolist() == [1, 1]
    assert abs(float(res.q[0])) < 1e-3 * np.abs(q).max()
    assert np.all(np.diff(h[:, 0, tdyn.DYN_COLS.index("kmah")]) >= 0)


def test_custom_medium_gradient_by_jvp():
    med = CustomMedium(lambda x, y: 1.5 - 0.5 * y * y + 0.1 * x * y)
    x = torch.tensor([0.3, -0.2], dtype=torch.float64)
    y = torch.tensor([0.5, 1.0], dtype=torch.float64)
    n, (gx, gy) = med.n_and_grad(x, y)
    np.testing.assert_allclose(H.to_np(gx), H.to_np(0.1 * y), atol=1e-15)
    np.testing.assert_allclose(H.to_np(gy), H.to_np(-y + 0.1 * x), atol=1e-15)
    np.testing.assert_array_equal(H.to_np(med.n(x, y)), H.to_np(n))


def test_bad_mode_and_amplitude_helpers():
    with pytest.raises(ValueError, match="mode"):
        tdyn.trace_dynamic("op1", rtt.scenario("interface"), homog(),
                           delta_s=0.1, mode="full", device="cpu")
    q = torch.tensor([0.5, 1.0, 2.0])
    tl = tdyn.transmission_loss_db(q, torch.ones(3), torch.ones(3))
    assert (np.diff(H.to_np(tl)) > 0).all()
    assert np.isfinite(float(tdyn.transmission_loss_db(
        torch.tensor(0.0), torch.tensor(1.0), torch.tensor(1.0))))


def test_inference_mode_gives_the_same_tangent():
    """trace_dynamic, fast_dynamic's scan route and find_eigenrays give the
    same q, dtheta and KMAH inside torch.inference_mode() as outside, to
    the bit (the tangent is computed with inference mode off, on ordinary
    copies of inference tensors): the float64 fisheye fan for one turn
    (KMAH 1 on every ray), op2's torch.func.jvp tangent on a C1 profile
    built inside inference mode, and an eigenray through it."""
    fish = rtt.scenario("fisheye")
    pos0, theta0 = fisheye_fan(r=32)
    kw = dict(delta_s=2 * np.pi / 200, device="cpu", mode="metrics",
              dtype=torch.float64, pos0=pos0, theta0=theta0, max_size=201)
    out = tdyn.trace_dynamic("op6", fish, rtt.analytic_medium("fisheye"),
                             **kw)
    samples, depth = H.munk_profile()
    cfg = dict(name="custom", key="-", field="", gamma=1.0, ray_count=8,
               theta0=np.zeros(1), pos0=np.zeros((1, 2)), s_max=0.0,
               box=(-1.0, 42.0, -3.0, 0.0))
    ch_pos, ch_th = H.channel_fan(8)
    ckw = dict(delta_s=0.01, device="cpu", mode="metrics",
               dtype=torch.float64, pos0=ch_pos, theta0=ch_th, max_size=120)
    ekw = dict(source=(0.0, -1.0), receivers=[(1.0, -1.0)], delta_s=0.01,
               max_size=150, box=(-1.0, 2.0, -3.0, 0.0), fan=(-0.1, 0.1, 9),
               device="cpu")
    prof = rtt.c1_stratified_from_samples(samples, depth, device="cpu",
                                          dtype=torch.float64)
    c_out = tdyn.trace_dynamic("op2", rtt.ScenarioConfig(**cfg), prof, **ckw)
    e_out = rtt.find_eigenrays("op6", prof, **ekw)
    f_out, engine = rtt.fast_dynamic(
        "op5", fish, rtt.analytic_medium("fisheye"), delta_s=0.05,
        pos0=pos0[:4], theta0=theta0[:4], steps=10, device="cpu")
    with torch.inference_mode():
        inside = tdyn.trace_dynamic(
            "op6", fish, rtt.analytic_medium("fisheye"),
            **{**kw, "pos0": torch.as_tensor(pos0),
               "theta0": torch.as_tensor(theta0)})
        iprof = rtt.c1_stratified_from_samples(samples, depth, device="cpu",
                                               dtype=torch.float64)
        c_in = tdyn.trace_dynamic("op2", rtt.ScenarioConfig(**cfg), iprof,
                                  **ckw)
        e_in = rtt.find_eigenrays("op6", iprof, **ekw)
        f_in, _ = rtt.fast_dynamic(
            "op5", fish, rtt.analytic_medium("fisheye"), delta_s=0.05,
            pos0=pos0[:4], theta0=theta0[:4], steps=10, device="cpu")
    assert engine == "dynamic-scan"
    for a, b in ((out, inside), (c_out, c_in), (f_out, f_in)):
        for f in ("q", "dtheta", "kmah"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert bool((out.kmah == 1).all())
    assert len(e_out.theta0) >= 1
    np.testing.assert_array_equal(np.asarray(e_out.q), np.asarray(e_in.q))
    np.testing.assert_array_equal(np.asarray(e_out.kmah),
                                  np.asarray(e_in.kmah))


def test_a_missing_launch_tangent_raises(monkeypatch):
    """Where torch.func.jvp records no tangent, the dynamic tier raises,
    naming the autograd mode, rather than count no caustic."""
    def no_tangent(fn, primals, tangents):
        out = fn(*primals)
        return out, tuple(torch.zeros_like(t) for t in out)

    monkeypatch.setattr(torch.func, "jvp", no_tangent)
    pos0, theta0 = fisheye_fan(r=4)
    with pytest.raises(RuntimeError, match="inference mode False"):
        tdyn.trace_dynamic("op6", rtt.scenario("fisheye"),
                           rtt.analytic_medium("fisheye"),
                           delta_s=0.05, device="cpu", mode="metrics",
                           dtype=torch.float64, pos0=pos0, theta0=theta0,
                           max_size=4)
