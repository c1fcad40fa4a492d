"""The port's model zoo (raytracing_tpu_torch/models.py) against the JAX
package's (raytracing_tpu/models.py): ``get`` on every (scenario, medium)
pair JAX builds, the tables equal to JAX's at the bars of
tests/test_torch_media.py (both packages' native spline libraries switched
off, so that both build with scipy), the calibrated steps equal, the pairs JAX
refuses refused; ``Model.run`` and ``Model.trace`` against JAX's at a few
hundred rays and at most 300 steps; the cache filled once under
concurrent calls."""
import concurrent.futures as cf
import threading

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

from raytracing_tpu import models as jmodels  # noqa: E402
from raytracing_tpu import native as jnative  # noqa: E402
from raytracing_tpu_torch import native as tnative  # noqa: E402

from raytracing_tpu_torch import models as tmodels  # noqa: E402

#: tests/test_torch_media.py's bar for tables built from the same samples
#: by the same FITPACK fit; float32 tables are the same float64 values
#: rounded once, so the bar holds for them as it is
TABLE_TOL = 1e-12
#: the pairs JAX builds: the fisheye varies in x, so it has no stratified form
PAIRS = [(s, m) for s in jmodels.MODEL_NAMES for m in jmodels.MEDIUM_KINDS
         if not (s == "fisheye" and m.endswith("stratified"))]
REFUSED = [("fisheye", "stratified"), ("fisheye", "c1-stratified"),
           ("vert", "banana"), ("warp", "analytic")]


@pytest.fixture(autouse=True)
def scipy_tables(monkeypatch):
    """Both packages build on scipy, each from an empty cache."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(jmodels, "_CACHE", {})
    monkeypatch.setattr(tmodels, "_CACHE", {})


def _np(v):
    return H.to_np(v) if torch.is_tensor(v) else np.asarray(v)


@pytest.mark.parametrize("name,medium", PAIRS)
def test_get_builds_jax_tables(name, medium):
    # the two builds at once: both spend their time in numpy and scipy,
    # outside the interpreter lock (the interface grid takes ~18 s each)
    with cf.ThreadPoolExecutor(2) as ex:
        jf = ex.submit(jmodels.get, name, medium)
        tf = ex.submit(tmodels.get, name, medium, device="cpu")
        jm, tm = jf.result(), tf.result()
    assert (tm.name, tm.medium_kind, tm.device) == (jm.name, medium, "cpu")
    assert type(tm.medium).__name__ == type(jm.medium).__name__
    for f, want in H.medium_fields(jm.medium).items():
        got = getattr(tm.medium, f)
        if isinstance(want, np.ndarray):
            assert _np(got).dtype == want.dtype, f
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=TABLE_TOL, err_msg=f)
        elif f not in ("n_min", "g_max", "kappa_max"):
            assert got == pytest.approx(want, rel=1e-15, abs=0), f
    for op in ("op1", "op6", "HySA", "op11", "op12", "op10n"):
        assert tm.delta_s(op) == jm.delta_s(op), op
    assert tm.scenario.box == jm.scenario.box
    assert tmodels.get(name, medium, device="cpu") is tm


@pytest.mark.parametrize("name,medium", REFUSED)
def test_get_refuses_what_jax_refuses(name, medium):
    with pytest.raises(ValueError) as jerr:
        jmodels.get(name, medium)
    with pytest.raises(ValueError) as terr:
        tmodels.get(name, medium, device="cpu")
    for word in ("fisheye", "medium", "scenario"):
        assert (word in str(jerr.value)) == (word in str(terr.value)), word


def test_cache_key_holds_device_dtype_and_turns():
    a = tmodels.get("vert", "stratified", device="cpu")
    assert tmodels.get("vert", "stratified", device=torch.device("cpu")) is a
    b = tmodels.get("vert", "stratified", dtype=torch.float64, device="cpu")
    assert b is not a and b.medium.Zy.dtype == torch.float64
    c = tmodels.get("fisheye", n_turns=1, device="cpu")
    assert c.scenario.s_max == pytest.approx(2 * np.pi)


def test_get_builds_once_under_concurrent_calls(monkeypatch):
    """Eight threads ask for the same sampled model at once: one build,
    one Model for all."""
    from raytracing_tpu_torch.media import spline
    calls, lock = [], threading.Lock()
    real = spline.build_stratified_medium

    def counting(*a, **kw):
        with lock:
            calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(spline, "build_stratified_medium", counting)
    with cf.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda _: tmodels.get("aniso", "stratified",
                                                device="cpu"), range(8)))
    assert len(calls) == 1
    assert all(m is got[0] for m in got)


def _fan(scen, rays, seed=0):
    rng = np.random.default_rng(seed)
    pos0 = np.tile(np.asarray(scen.pos0, np.float32)[:1], (rays, 1))
    theta0 = np.resize(np.asarray(scen.theta0, np.float32), rays)
    return pos0, (theta0 + rng.uniform(-0.02, 0.02, rays)).astype(np.float32)


#: (scenario, medium, op, coarse delta_s, position bar, traveltime bar): a
#: fused op 1e-5 and 5e-5 (tests/test_torch_fast.py, test_torch_strat.py,
#: test_torch_grid.py), a golden op 5e-4 both (the same files' golden
#: bar); every medium kind but the parity grid, which
#: tests/test_torch_serve.py's fisheye_grid case runs through the same
#: Model.medium and fast_trace.  The C1 grid at the model's full pitch
#: (511 x 511 nodes) is held to 2e-5: the two runtimes' float32 roundings
#: of its 16-float cell blend part by 1.1e-5 to 1.7e-5 over 60 steps on
#: this fan for every fused op (test_torch_grid.py's 1e-5 holds on its
#: 181 x 181 grid); the parity grid keeps 1e-5
FISHEYE_DS = 2 * np.pi / 60
RUN_CASES = [
    ("fisheye", "analytic", "op1", FISHEYE_DS, 1e-5, 5e-5),
    ("vert", "stratified", "op6", 0.3, 1e-5, 5e-5),
    ("fisheye", "c1", "op6", FISHEYE_DS, 2e-5, 5e-5),
    ("vert", "c1-stratified", "op8", 0.3, 1e-5, 5e-5),
    ("aniso", "stratified", "op11", 0.3, 5e-4, 5e-4),
]


@pytest.mark.parametrize("name,medium,op,ds,pos_tol,tt_tol", RUN_CASES)
def test_run_matches_jax(name, medium, op, ds, pos_tol, tt_tol):
    """Model.run: JAX's fast_trace (Pallas in interpret mode) against the
    port's (the kernels' plain versions here), 256 rays, one turn or at
    most 267 steps at an explicit coarse step."""
    jm = jmodels.get(name, medium)
    tm = tmodels.get(name, medium, device="cpu")
    pos0, theta0 = _fan(tm.scenario, 256)
    kw = dict(delta_s=ds, n_turns=1, pos0=pos0, theta0=theta0)
    j = jm.run(op, block_rays=256, **kw)
    t = tm.run(op, **kw)
    assert t.pos.device.type == "cpu"
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), rtol=0,
                               atol=pos_tol)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), rtol=0, atol=tt_tol)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))


#: (scenario, medium, op, coarse delta_s): the scan tier at float32, held
#: at tests/test_torch_fast_sampled.py's float32 bar, 5e-5
TRACE_CASES = [
    ("fisheye", "analytic", "op6", FISHEYE_DS),
    ("vert", "stratified", "op8", 0.3),
    ("fisheye", "c1", "op2", FISHEYE_DS),
]
SCAN_TOL = 5e-5


@pytest.mark.parametrize("name,medium,op,ds", TRACE_CASES)
def test_trace_matches_jax(name, medium, op, ds):
    """Model.trace: the two scan tiers in metrics mode at float32, 64
    rays."""
    jm = jmodels.get(name, medium)
    tm = tmodels.get(name, medium, device="cpu")
    pos0, theta0 = _fan(tm.scenario, 64, seed=1)
    kw = dict(delta_s=ds, n_turns=1, mode="metrics", pos0=pos0,
              theta0=theta0)
    j = jm.trace(op, dtype=np.float32, **kw)
    t = tm.trace(op, dtype=torch.float32, **kw)
    for f in ("pos", "angle", "traveltime"):
        np.testing.assert_allclose(H.to_np(getattr(t.final, f)),
                                   np.asarray(getattr(j.final, f)), rtol=0,
                                   atol=SCAN_TOL, err_msg=f)
    np.testing.assert_array_equal(H.to_np(t.exit_step),
                                  np.asarray(j.exit_step))


def test_run_uses_the_calibrated_step():
    """No delta_s: the calibrated (delta_s, divisor), as JAX resolves it;
    the fisheye's divisor + 1 sizing, one turn."""
    tm = tmodels.get("fisheye", n_turns=1, device="cpu")
    jm = jmodels.get("fisheye", n_turns=1)
    assert tm._resolve("op6", None) == jm._resolve("op6", None)
    assert tm._resolve("op6", FISHEYE_DS) == jm._resolve("op6", FISHEYE_DS)
    pos0, theta0 = _fan(tm.scenario, 8)
    t = tm.run("op6", pos0=pos0, theta0=theta0, n_turns=1)
    j = jm.run("op6", pos0=pos0, theta0=theta0, n_turns=1, block_rays=128)
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), rtol=0,
                               atol=1e-5)


@pytest.mark.slow
def test_sampled_medium_production_example():
    """examples/sampled_medium_production_torch.py at 4,096 rays on the CPU
    (tests/test_examples.py:55-58 runs JAX's at the same size): the
    stratified tables on the fused kernel, both searches, and the 2-D
    spline on the grid kernel."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, str(root / "examples" /
                             "sampled_medium_production_torch.py"), "4096",
         "--device", "cpu"], capture_output=True, text=True, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root)},
        timeout=1200)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[fused-strat]" in r.stdout and "[grid]" in r.stdout
    assert r.stdout.count("DELTA_S search") == 2


def test_models_default_to_the_card():
    """Without a CUDA device the default device raises at build: no model
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tmodels.get("vert").device == "cuda"    # analytic: no tables
    with pytest.raises((RuntimeError, AssertionError)):
        tmodels.get("vert", "stratified")
