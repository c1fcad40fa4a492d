"""The port's scan tier (raytracing_tpu_torch.trace) against the JAX scan tier
at float64, for the fused-family ops, in both output modes; the oracles;
and the port's independence of jax."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine import oracles as joracles  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import oracles as toracles  # noqa: E402
from raytracing_tpu_torch.interop import (  # noqa: E402
    ray_state_from_numpy, trace_result_to_numpy)

ATOL = 1e-9
FUSED_FAMILY = ("op1", "op2", "op3", "op4", "op6", "op7", "op8", "op12")


def _case(scen_name, seed=0):
    """(scenario kwargs, delta_s, divisor, pos0, theta0) for a short run."""
    rng = np.random.default_rng(seed)
    if scen_name == "interface":
        pos0, theta0 = H.fan_near_interface(rng, 16)
        return dict(s_max=0.6, box=H.INTERFACE_BOX), 0.01, None, pos0, theta0
    if scen_name in ("vert", "aniso"):
        pos0, theta0 = H.fan_vert(rng, 16)
        return dict(s_max=3.0, box=H.VERT_BOX), 0.05, None, pos0, theta0
    # the fisheye's single ray, duplicated: XLA:CPU's f64 sin/cos take an
    # inaccurate path on 1-element arrays
    pos0 = np.array([[1.0, 0.0], [1.0, 0.0]])
    theta0 = np.array([np.pi / 2.0, np.pi / 2.0])
    return {}, 2.0 * np.pi / 40, 41, pos0, theta0


def run_both(op, scen_name, mode, s_max=None, seed=0):
    kw, ds, divisor, pos0, theta0 = _case(scen_name, seed)
    if s_max is not None:
        kw["s_max"] = s_max
    jscen = dataclasses.replace(rt.scenario(scen_name), **kw)
    tscen = dataclasses.replace(rtt.scenario(scen_name), **kw)
    jres = rt.trace(op, jscen, rt.analytic_medium(jscen.field), delta_s=ds,
                    divisor=divisor, n_turns=1, mode=mode, dtype=np.float64,
                    pos0=pos0, theta0=theta0)
    tres = rtt.trace(op, tscen, rtt.analytic_medium(tscen.field),
                     delta_s=ds, divisor=divisor, n_turns=1, mode=mode,
                     dtype=torch.float64, pos0=pos0, theta0=theta0,
                     device="cpu")
    return jres, tres, theta0, ds


def assert_parity(jres, tres, mode):
    t = trace_result_to_numpy(tres)
    for name in ("pos", "angle", "traveltime", "dist_sim", "dist_real", "m"):
        np.testing.assert_allclose(t["final"][name],
                                   np.asarray(getattr(jres.final, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(t["exit_step"], np.asarray(jres.exit_step))
    np.testing.assert_array_equal(t["final"]["active"],
                                  np.asarray(jres.final.active))
    if jres.final.mom_mean is not None:
        for name in ("mom_count", "mom_mean", "mom_m2"):
            np.testing.assert_allclose(t["final"][name],
                                       np.asarray(getattr(jres.final, name)),
                                       rtol=0, atol=ATOL, err_msg=name)
    if mode == "history":
        np.testing.assert_allclose(t["history"], np.asarray(jres.history),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(t["n_hist"], np.asarray(jres.n_hist),
                                   rtol=0, atol=ATOL)
    else:
        assert t["history"] is None and jres.history is None


@pytest.mark.parametrize("mode", ["history", "metrics"])
@pytest.mark.parametrize("scen_name", ["interface", "vert", "fisheye"])
@pytest.mark.parametrize("op", FUSED_FAMILY)
def test_scan_tier_matches_jax_f64(op, scen_name, mode):
    jres, tres, _, _ = run_both(op, scen_name, mode)
    assert_parity(jres, tres, mode)


def test_some_rays_exit_the_box():
    """The shrunken boxes make rays exit at different steps (the masked
    early exit is what the parity above exercises)."""
    _, tres, _, _ = run_both("op6", "vert", "metrics")
    ex = H.to_np(tres.exit_step)
    assert len(set(ex.tolist())) > 3 and not H.to_np(tres.final.active).all()


def test_oracles_match_jax():
    jres, tres, theta0, ds = run_both("op6", "interface", "history")
    np.testing.assert_allclose(
        H.to_np(toracles.snell_errors_deg(tres, theta0)),
        np.asarray(joracles.snell_errors_deg(jres, theta0)), atol=1e-6)
    np.testing.assert_allclose(
        toracles.snell_errors_from_tangent(H.to_np(tres.final.unitv), theta0),
        joracles.snell_errors_from_tangent(np.asarray(jres.final.unitv),
                                           theta0), atol=1e-9)
    jres, tres, _, _ = run_both("op8", "vert", "history")
    np.testing.assert_allclose(
        H.to_np(toracles.momentum_cv_pct_from_history(tres)),
        np.asarray(joracles.momentum_cv_pct_from_history(jres)), atol=1e-9)
    np.testing.assert_allclose(
        H.to_np(toracles.momentum_cv_pct_from_stats(tres)),
        np.asarray(joracles.momentum_cv_pct_from_stats(jres)), atol=1e-9)
    cv = toracles.momentum_cv_pct_from_welford(
        tres.final.mom_count, tres.final.mom_mean, tres.final.mom_m2)
    assert toracles.momentum_cv_summary(cv) == pytest.approx(
        joracles.momentum_cv_summary(joracles.momentum_cv_pct_from_welford(
            jres.final.mom_count, jres.final.mom_mean, jres.final.mom_m2)),
        abs=1e-9)
    jres, tres, _, ds = run_both("op1", "fisheye", "history")
    np.testing.assert_allclose(H.to_np(toracles.closure_error_pct(tres)),
                               np.asarray(joracles.closure_error_pct(jres)),
                               atol=1e-9)
    assert toracles.fisheye_rms_error(tres, ds) == pytest.approx(
        joracles.fisheye_rms_error(jres, ds), abs=1e-12)


@pytest.mark.parametrize("field", ["interface", "fisheye", "vert_heterogeneous"])
def test_fields_match_jax_f64(field):
    from raytracing_tpu.media import fields as jf
    from raytracing_tpu_torch.media import fields as tf

    rng = np.random.default_rng(5)
    x, y = rng.uniform(-2, 2, 64), rng.uniform(-0.5, 0.5, 64)
    jn, (jgx, jgy) = rt.analytic_medium(field).n_and_grad(x, y)
    tn, (tgx, tgy) = rtt.analytic_medium(field).n_and_grad(
        torch.as_tensor(x), torch.as_tensor(y))
    for a, b in ((tn, jn), (tgx, jgx), (tgy, jgy)):
        np.testing.assert_allclose(H.to_np(a), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)
    th = rng.uniform(-np.pi, np.pi, 64)
    np.testing.assert_allclose(
        H.to_np(tf.anisotropy(torch.as_tensor(th), 3.0)),
        np.asarray(jf.anisotropy(th, 3.0)), rtol=1e-14)
    np.testing.assert_allclose(
        H.to_np(tf.anisotropy_uv(torch.as_tensor(np.cos(th)),
                                 torch.as_tensor(np.sin(th)), 3.0)),
        np.asarray(jf.anisotropy_uv(np.cos(th), np.sin(th), 3.0)), rtol=1e-14)


def test_snell_report_and_reference_layout_match_jax():
    jres, tres, theta0, _ = run_both("op6", "interface", "history")
    jlines, tlines = [], []
    joracles.snell_report(jres, theta0, printer=jlines.append)
    toracles.snell_report(tres, theta0, printer=tlines.append)
    assert tlines == jlines
    for a, b in zip(tres.reference_layout(), jres.reference_layout()):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_ray_state_roundtrip_from_jax():
    """A JAX RayState crosses over through interop and equals the port's
    own initial state."""
    from raytracing_tpu.engine.trace import initial_state as jinit
    from raytracing_tpu_torch.engine.trace import initial_state as tinit

    _, _, _, pos0, theta0 = _case("vert")
    med = rt.analytic_medium("vert_heterogeneous")
    js = jinit(pos0, theta0, med, 3.0, with_window=True,
               with_momentum_stats=True, max_size=50)
    ts = ray_state_from_numpy(
        {k: (None if v is None else np.asarray(v))
         for k, v in js._asdict().items()}, device="cpu")
    own = tinit(torch.as_tensor(pos0), torch.as_tensor(theta0),
                rtt.analytic_medium("vert_heterogeneous"), 3.0,
                with_window=True, with_momentum_stats=True, max_size=50)
    for name, a in own._asdict().items():
        np.testing.assert_allclose(H.to_np(getattr(ts, name)), H.to_np(a),
                                   atol=1e-12, err_msg=name)


def test_bad_arguments_raise():
    scen = rtt.scenario("vert")
    med = rtt.analytic_medium("vert_heterogeneous")
    with pytest.raises(ValueError, match="mode"):
        rtt.trace("op1", scen, med, delta_s=0.1, mode="warp", device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        rtt.trace("op99", scen, med, delta_s=0.1, device="cpu")
    with pytest.raises(ValueError, match="divisor"):
        rtt.trace("op1", rtt.scenario("fisheye"), med, delta_s=0.1,
                  device="cpu")
    with pytest.raises(ValueError, match="unknown field"):
        rtt.analytic_medium("warp")
    with pytest.raises(ValueError, match="history"):
        res = rtt.trace("op1", scen, med, delta_s=1.0, mode="metrics",
                        device="cpu")
        toracles.snell_errors_deg(res, scen.theta0)


def test_aliases_resolve():
    from raytracing_tpu_torch.ops.registry import canonical
    assert [canonical(a) for a in ("AnDF", "HySA", "MxSA")] == \
        ["op2", "op6", "op7"]
    assert rtt.OP_NAMES == rt.OP_NAMES
    assert rtt.EXTENSION_OPS == rt.EXTENSION_OPS
    assert rtt.ANISO_OPS == rt.ANISO_OPS


def test_port_imports_no_jax():
    """Importing the port (every module) loads neither jax nor the JAX
    package."""
    code = (
        "import sys, importlib, pkgutil, raytracing_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'raytracing_tpu' or m.startswith('raytracing_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
