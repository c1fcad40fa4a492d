"""The port's server (raytracing_tpu_torch/serve.py) against the JAX
package's (raytracing_tpu/serve.py), both running in this process on the
CPU: every request body of tests/test_serve.py, at its sizes or smaller
(an explicit coarse step where JAX's test takes a calibrated one, so that
no trace runs much beyond 300 steps), posted to both servers and answered
with the same status code, the same keys and the same numbers, each within
the bar stated beside it; the port's server under concurrent requests;
the fuzzed bodies; the refusal of a CUDA server without a card; and the
kernel library built once under concurrent first calls."""
import concurrent.futures as cf
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch_port_helpers  # noqa: F401  (torch on one thread)

torch = pytest.importorskip("torch")

from raytracing_tpu import models as jmodels  # noqa: E402
from raytracing_tpu import native as jnative  # noqa: E402
from raytracing_tpu_torch import native as tnative  # noqa: E402
from raytracing_tpu import serve as jserve  # noqa: E402

from raytracing_tpu_torch import models as tmodels  # noqa: E402
from raytracing_tpu_torch import serve as tserve  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402

#: keys whose values differ by design: timings, and the engine names
#: (the port's own, engine/fast.py)
UNCOMPARED = {"seconds", "ray_steps_per_sec", "engine"}

# The bars, each that of the port's tests of the function underneath:
#: fused-kernel positions and traveltimes, tests/test_torch_fast.py /
#: test_torch_strat.py / test_torch_grid.py (1e-5, 5e-5)
FUSED = 1e-5
#: golden ops, the same files' golden bar
GOLDEN = 5e-4
#: the df32 kernel against JAX's, tests/test_torch_df.py JAX_TOL["fisheye"]
DF32 = 1e-8
#: the closure error: 100 |p - (1, 0)| / 2 pi of a position within FUSED
CLOSURE = 100 * FUSED / (2 * np.pi)
#: a momentum or slowness CV in percent, float32 noise at these sizes:
#: tests/test_torch_strat.py::test_golden_strat_op11_cv_matches_jax's bar
CV = 1e-3
#: the Richardson halving error, tests/test_torch_sweep.py
HALVING = 2e-5
#: float64 eigenrays, tests/test_torch_eigenray.py::assert_same
EIGEN = {"theta0": 1e-9, "traveltime": 1e-9, "angle": 1e-9,
         "amplitude": 1e-7, "y_err": 1e-6}
#: the TL reductions, tests/test_torch_eigenray.py
TL = {"incoherent_tl_db": 1e-7, "coherent_tl_db": 1e-5}
#: float32 eigenrays through the split-word profile
#: (tests/test_torch_df_grid.py::test_df_eval_profile_carries_the_dynamic_scan:
#: positions and traveltime 1e-5; the amplitude's q within 2e-3 of its size)
EIGEN_F32 = {"theta0": 1e-5, "traveltime": 1e-5, "angle": 1e-5,
             "amplitude": 2e-3, "y_err": 1e-4}
#: 3-D float64 eigenrays, tests/test_torch_eigenray3d.py::assert_same
EIGEN3 = {"traveltime": 1e-9, "dir0": 1e-9, "amplitude": 1e-9, "miss": 1e-6}
#: the 3-D scan tier at float32, tests/test_torch_trace3d.py's float32 bar
SCAN3 = 5e-6


@pytest.fixture(scope="module")
def servers():
    """The JAX server and the port's on the CPU, each on a daemon thread;
    both build their sampled media with scipy (both native libraries off,
    so that the recorded bars hold), from empty model caches."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    mp.setattr(tnative, "available", lambda: False)
    mp.setattr(jmodels, "_CACHE", {})
    mp.setattr(tmodels, "_CACHE", {})
    srvs = [jserve.create_server("127.0.0.1", 0),
            tserve.create_server("127.0.0.1", 0, device="cpu")]
    for s in srvs:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield tuple(f"http://127.0.0.1:{s.server_address[1]}" for s in srvs)
    for s in srvs:
        s.shutdown()
        s.server_close()
    mp.undo()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_both(servers, path, body):
    """``body`` posted to both servers at once (each answers on its own
    request thread): [(JAX's code, body), (the port's code, body)]."""
    with cf.ThreadPoolExecutor(2) as ex:
        return list(ex.map(lambda u: _post(u + path, body), servers))


def _close(got, want, bar, where):
    if want is None or got is None:
        assert got is None and want is None, where
        return
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=0, atol=bar, err_msg=where)


def _arrivals(t, j, bars, where):
    assert len(t) == len(j), where
    # a symmetric pair's equal traveltimes may tie either way: compare in
    # (receiver, launch) order
    key = (lambda a: (a["receiver"], *np.atleast_1d(a.get("theta0",
                                                          a.get("dir0")))))
    for k, (a, b) in enumerate(zip(sorted(t, key=key), sorted(j, key=key))):
        assert set(a) == set(b), where
        for f in a:
            if f in bars:
                _close(a[f], b[f], bars[f], f"{where} arrival {k} {f}")
            else:
                assert a[f] == b[f], (where, k, f)


def assert_same(t, j, bars, where=""):
    """The port's response ``t`` equals JAX's ``j``: the same keys; every
    value equal, or within ``bars[key]`` (an atol; a callable takes
    (got, want) and asserts)."""
    assert set(t) == set(j), (where, sorted(set(t) ^ set(j)))
    for k in set(t) - UNCOMPARED:
        if k == "arrivals":
            _arrivals(t[k], j[k], bars["arrivals"], where)
        elif k in bars and callable(bars[k]):
            bars[k](t[k], j[k])
        elif k in bars:
            _close(t[k], j[k], bars[k], f"{where} {k}")
        else:
            assert t[k] == j[k], (where, k, t[k], j[k])


def both(servers, path, body, bars=None, code=None):
    """Post ``body`` to both servers: the same status (``code`` if given),
    and on 200 the same response within ``bars``; the port's answer."""
    (jc, j), (tc, t) = _post_both(servers, path, body)
    assert tc == jc, (path, body, t, j)
    if code is not None:
        assert tc == code, (path, t)
    if tc == 200:
        assert_same(t, j, bars or {}, path)
    else:
        assert "error" in t
    return t, j


# ---------------------------------------------------------------- /v1/trace

TWO_PI = 2 * 3.141592653589793
TRACE_FISHEYE = {"scenario": "fisheye", "op": "op6", "rays": 256,
                 "delta_s": TWO_PI / 64, "divisor": 64}
FUSED_TRACE = {"mean_final_pos": FUSED, "closure_error_pct": CLOSURE}

#: (case, body, bars, the port's engine): every /v1/trace body of
#: tests/test_serve.py that answers 200; calibrated interface and vert
#: steps (3854 and 4142 steps) replaced by 0.3 (267 steps), the calibrated
#: fisheye op6 grid and C1 runs kept (303 steps), and one calibrated
#: analytic run at 64 rays.  The engines are the port's: the headline
#: kernel for fisheye op1, the port's names for the sampled routes
TRACE_CASES = [
    ("fisheye_op6", TRACE_FISHEYE, FUSED_TRACE, "fused"),
    ("fisheye_op1_headline", dict(TRACE_FISHEYE, op="op1"), FUSED_TRACE,
     "fisheye"),
    ("fisheye_op6_calibrated", {"scenario": "fisheye", "op": "op6",
                                "rays": 64}, FUSED_TRACE, "fused"),
    ("high_precision", {"scenario": "fisheye", "op": "op12", "rays": 128,
                        "delta_s": TWO_PI / 200, "divisor": 200,
                        "precision": "high"},
     {"mean_final_pos": DF32, "closure_error_pct": 100 * DF32 / TWO_PI},
     "df32"),
    ("interface_stratified", {"scenario": "interface", "op": "op6",
                              "rays": 128, "medium": "stratified",
                              "delta_s": 0.3}, FUSED_TRACE, "fused-strat"),
    ("fisheye_grid", {"scenario": "fisheye", "op": "op6", "rays": 128,
                      "medium": "grid", "divisor": 100, "n_turns": 1},
     FUSED_TRACE, "grid"),
    ("fisheye_c1", {"scenario": "fisheye", "op": "op6", "rays": 128,
                    "medium": "c1", "divisor": 100, "n_turns": 1},
     FUSED_TRACE, "grid"),
    ("vert_c1_stratified", {"scenario": "vert", "op": "op8", "rays": 128,
                            "medium": "c1-stratified", "delta_s": 0.3},
     FUSED_TRACE, "fused-strat"),
    ("aniso_golden", {"scenario": "aniso", "op": "op11", "rays": 128,
                      "delta_s": 0.3},
     {"mean_final_pos": GOLDEN}, "golden"),
]


@pytest.mark.parametrize("case,body,bars,engine", TRACE_CASES,
                         ids=[c[0] for c in TRACE_CASES])
def test_trace_matches_jax(servers, case, body, bars, engine):
    t, _ = both(servers, "/v1/trace", body, bars, code=200)
    assert t["engine"] == engine
    assert t["ray_steps_per_sec"] > 0
    if "closure_error_pct" in t:
        assert t["closure_error_pct"] < (1e-4 if case == "high_precision"
                                         else 5.0)


#: every refused /v1/trace body of tests/test_serve.py
HOSTILE = [
    {"scenario": "warp"}, {"rays": -5},
    {"scenario": "fisheye", "op": "op1", "delta_s": 0.0},
    {"scenario": "interface", "op": "op1", "delta_s": 1e-9},
    {"scenario": "interface", "op": "op1", "delta_s": float("nan")},
    {"scenario": "interface", "op": "op1", "delta_s": -1.0},
    {"scenario": "fisheye", "op": "op1", "n_turns": 10 ** 9},
    {"rays": "many"},
    {"scenario": "fisheye", "medium": "stratified"},
    {"medium": "banana"},
    {"scenario": "fisheye", "medium": "c1-stratified"},
    {"scenario": "fisheye", "op": "op6", "precision": "high"},
    {"scenario": "interface", "op": "op12", "precision": "high",
     "medium": "stratified", "delta_s": 0.3},
]


@pytest.mark.parametrize("body", HOSTILE, ids=range(len(HOSTILE)))
def test_trace_refusals_match_jax(servers, body):
    t, j = both(servers, "/v1/trace", body, code=400)
    for word in ("warp", "delta_s", "steps", "n_turns", "x-independent",
                 "op12"):
        assert (word in t["error"]) == (word in j["error"]), (word, t, j)


def test_unknown_paths(servers):
    for u in servers:
        assert _post(u + "/v1/nope", {})[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(u + "/v1/nope")
        assert e.value.code == 404


def test_healthz_and_models(servers):
    (jc, j), (tc, t) = (_get(u + "/healthz") for u in servers)
    assert jc == tc == 200 and t["status"] == j["status"] == "ok"
    assert t["device"] == "cpu" and set(t) == set(j)
    (jc, j), (tc, t) = (_get(u + "/v1/models") for u in servers)
    assert jc == tc == 200 and t == j
    assert t == tserve.models_listing()


# -------------------------------------------------------- /v1/trace_samples

def _lens_samples():
    gx = np.linspace(-2.0, 2.0, 41)
    gy = np.linspace(-1.5, 1.5, 31)
    Z = 1.0 / (1.0 + 0.4 * gx[None, :] ** 2 + 0.6 * gy[:, None] ** 2)
    return Z.tolist(), gx.tolist(), gy.tolist()


def _profile(lo=-2.0, hi=1.0, n=61, f=lambda y: 1.0 + 0.3 * np.tanh(2 * y)):
    y = np.linspace(lo, hi, n)
    return f(y).tolist(), y.tolist()


def _waveguide(n=61):
    return _profile(-1.5, 1.5, n, lambda y: 1.2 - 0.25 * y * y)


def _grid_body(**kw):
    Z, gx, gy = _lens_samples()
    return dict({"samples": Z, "x": gx, "y": gy, "op": "op6",
                 "delta_s": 0.01, "steps": 60, "rays": 256,
                 "launch": {"x": -1.5, "y": [-0.3, 0.3], "theta": 0.0},
                 "return_positions": True}, **kw)


def _profile_body(**kw):
    col, y = _profile()
    return dict({"samples": col, "y": y, "op": "op6", "family": "c1",
                 "delta_s": 0.01, "steps": 80, "rays": 128,
                 "box": [-5.0, 5.0, -2.0, 1.0],
                 "launch": {"x": 0.0, "y": [-1.5, -0.5], "theta": 0.3}}, **kw)


def _conservation_body(theta=0.3):
    col, y = _waveguide()
    return {"samples": col, "y": y, "op": "op6", "family": "c1",
            "delta_s": 0.01, "steps": 80, "rays": 128,
            "box": [-1e6, 1e6, -1.5, 1.5], "report_conservation": True,
            "launch": {"x": 0.0, "y": [-0.1, 0.1], "theta": theta}}


SAMPLES_BARS = {"mean_final_pos": FUSED, "pos": FUSED,
                "momentum_cv_pct_mean": lambda g, w: _cv(g, w),
                "momentum_cv_pct_max": lambda g, w: _cv(g, w)}


def _cv(got, want):
    if want is None or got is None:
        assert got is None and want is None
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=CV)


SAMPLES_CASES = [
    ("grid_parity", _grid_body()),
    ("grid_c1", _grid_body(family="c1")),
    ("profile", _profile_body()),
    ("conservation", _conservation_body()),
    ("conservation_perpendicular", _conservation_body(1.5707963267948966)),
]


@pytest.mark.parametrize("case,body", SAMPLES_CASES,
                         ids=[c[0] for c in SAMPLES_CASES])
def test_trace_samples_matches_jax(servers, case, body):
    t, _ = both(servers, "/v1/trace_samples", body, SAMPLES_BARS, code=200)
    json.dumps(t, allow_nan=False)
    if case.startswith("grid"):
        assert len(t["pos"]) == 256 and t["medium_kind"] == "grid"
    if case == "conservation":
        assert t["momentum_cv_pct_max"] < 0.05


def test_trace_samples_families_agree(servers):
    """JAX's check: the same samples and fan through both families agree
    to interpolant grade (tests/test_serve.py:211-214)."""
    url = servers[1] + "/v1/trace_samples"
    a = np.asarray(_post(url, _grid_body())[1]["pos"])
    b = np.asarray(_post(url, _grid_body(family="c1"))[1]["pos"])
    assert np.abs(a - b).max() < 5e-3


def _rejected_samples():
    Z, gx, gy = _lens_samples()
    base = {"samples": Z, "x": gx, "y": gy, "delta_s": 0.01, "steps": 10,
            "launch": {"x": 0.0, "y": [-0.1, 0.1]}}
    out = [dict(base, **m) for m in (
        dict(family="cubic"),
        {"samples": [[1.0, float("nan")] * 2] * 4},
        dict(delta_s=-1.0), dict(steps=0), {"launch": None, "rays": 8},
        dict(steps=10, rays=0), dict(box=[0.0, 1.0]),
        {"samples": [1.0, 2.0, 3.0], "y": [0.0, 1.0, 2.0]},
        dict(rays=70000, return_positions=True),
        {"launch": {"x": 0.0, "y": []}}, {"y": list(reversed(gy))},
        dict(box=[0.0, 1.0, 5.0, -5.0]), dict(report_conservation=True))]
    out.append({k: v for k, v in base.items() if k != "delta_s"})
    return out


@pytest.mark.parametrize("body", _rejected_samples(),
                         ids=range(len(_rejected_samples())))
def test_trace_samples_refusals_match_jax(servers, body):
    t, j = both(servers, "/v1/trace_samples", body, code=400)
    for word in ("family", "finite", "delta_s", "steps", "pos0", "rays",
                 "box", "at least 4", "caps", "non-empty", "ascending",
                 "ordered", "profile"):
        assert (word in t["error"]) == (word in j["error"]), (word, t, j)


# ---------------------------------------------------- /v1/calibrate_samples

def _calibrate_body(**kw):
    return _profile_body(**dict({"arc_length": 1.0, "tol": 1e-2,
                                 "candidates": [0.1, 0.05, 0.025]}, **kw))


def test_calibrate_samples_matches_jax(servers):
    body = _calibrate_body()
    for k in ("delta_s", "steps"):
        body.pop(k)
    t, _ = both(servers, "/v1/calibrate_samples", body,
                {"halving_err": HALVING}, code=200)
    assert t["accepted"] and t["delta_s"] in body["candidates"]
    # trace at the calibrated step through the sibling endpoint
    tr, _ = both(servers, "/v1/trace_samples",
                 dict(body, delta_s=t["delta_s"], steps=t["steps"]),
                 SAMPLES_BARS, code=200)
    assert tr["ray_steps_per_sec"] > 0


@pytest.mark.parametrize("mutate", [
    dict(arc_length=-1.0), dict(tol=0.0), dict(candidates=[0.1] * 17),
    dict(candidates=[0.1, -0.2]), dict(rays=70000),
    dict(candidates=[0.05, 0.1])], ids=range(6))
def test_calibrate_refusals_match_jax(servers, mutate):
    t, j = both(servers, "/v1/calibrate_samples", _calibrate_body(**mutate),
                code=400)
    assert t["error"] == j["error"]


def test_calibrate_hostile_ray_count_rejected_cheaply(servers):
    y = np.linspace(-1.0, 1.0, 31)
    body = {"samples": (1.3 - 0.1 * y * y).tolist(), "y": y.tolist(),
            "rays": 16777216, "arc_length": 1.0,
            "launch": {"x": 0.0, "y": [-0.1, 0.1], "theta": 0.2}}
    t, j = both(servers, "/v1/calibrate_samples", body, code=400)
    assert "65536" in t["error"] and t["error"] == j["error"]


# ---------------------------------------------------------- /v1/eigenrays

def _eigen_body(**kw):
    """tests/test_serve.py:445-453's waveguide at a quarter of its fan and
    half its depth (delta_s 0.04, 260 steps: the same 10.4 units of
    range)."""
    col, y = _waveguide()
    return dict({"samples": col, "y": y, "op": "op6", "family": "c1",
                 "delta_s": 0.04, "steps": 260, "box": [-1.0, 10.0, -1.5, 1.5],
                 "source": [0.0, 0.0], "receivers": [[8.0, 0.0], [8.0, 0.3]],
                 "fan": {"theta": [-0.45, 0.45], "count": 24},
                 "omega": 40.0}, **kw)


def test_eigenrays_matches_jax(servers):
    t, _ = both(servers, "/v1/eigenrays", _eigen_body(),
                dict(TL, arrivals=EIGEN), code=200)
    arr = t["arrivals"]
    assert t["medium_kind"] == "profile" and len(arr) >= 2
    assert all(a["converged"] and abs(a["y_err"]) < 1e-6 for a in arr)
    assert {a["receiver"] for a in arr} == {0, 1}


def test_eigenrays_on_device_matches_jax(servers):
    """on_device: the split-word profile and a float32 solve (the server's
    device here is the CPU, where the df32 evaluator runs a few hundred
    torch calls a step: the fan is cut to 8 rays of 60 steps of 0.16)."""
    body = _eigen_body(on_device=True, delta_s=0.16, steps=60,
                       fan={"theta": [-0.45, 0.45], "count": 8})
    body.pop("family")
    t, _ = both(servers, "/v1/eigenrays", body,
                dict(arrivals=EIGEN_F32,
                     incoherent_tl_db=EIGEN_F32["amplitude"],
                     coherent_tl_db=EIGEN_F32["amplitude"]), code=200)
    assert t["medium_kind"] == "df32-profile"
    assert all(a["converged"] and abs(a["y_err"]) < 1e-4
               for a in t["arrivals"])


def _eigen_rejected():
    y = np.linspace(-1.0, 1.0, 21)
    base = {"samples": (1.2 - 0.1 * y * y).tolist(), "y": y.tolist(),
            "delta_s": 0.05, "steps": 40, "source": [0.0, 0.0],
            "receivers": [[1.0, 0.0]], "box": [-1, 2, -1, 1]}
    return [dict(base, op="op5"), dict(base, source=[0.0, 0.0, 1.0]),
            dict(base, receivers=[]), dict(base, fan={"theta": [0.5, -0.5]}),
            dict(base, steps=1000000, fan={"theta": [-0.3, 0.3],
                                           "count": 512}),
            dict(base, on_device=True, samples=np.ones((8, 9)).tolist(),
                 x=np.linspace(0, 1, 9).tolist(), y=np.linspace(0, 1, 8)
                 .tolist())]


@pytest.mark.parametrize("body", _eigen_rejected(), ids=range(6))
def test_eigenrays_refusals_match_jax(servers, body):
    t, j = both(servers, "/v1/eigenrays", body, code=400)
    for word in ("golden", "source", "receivers", "fan", "bound", "PROFILE"):
        assert (word in t["error"]) == (word in j["error"]), (word, t, j)


# --------------------------------------------------------- /v1/eigenrays3

def _eigen3_body(**kw):
    """tests/test_serve.py:474-481's lifted waveguide at a 9 x 9 fan and
    160 steps of 0.03 (the same 4.8 units of range)."""
    col, y = _waveguide()
    return dict({"samples": col, "y": y, "op": "op6", "family": "c1",
                 "delta_s": 0.03, "steps": 160,
                 "box": [-1.0, 10.0, -1.5, 1.5, -5.0, 5.0],
                 "source": [0.0, 0.0, 0.0],
                 "receivers": [[4.0, 0.0, 0.0], [4.0, 0.2, 0.1]],
                 "fan": {"alpha": [-0.35, 0.35], "beta": [-0.35, 0.35],
                         "count": [9, 9]}, "omega": 40.0}, **kw)


def test_eigenrays3_matches_jax(servers):
    t, _ = both(servers, "/v1/eigenrays3", _eigen3_body(),
                dict(TL, arrivals=EIGEN3), code=200)
    arr = t["arrivals"]
    assert t["medium_kind"] == "profile-3d" and t["fan_count"] == [9, 9]
    assert {a["receiver"] for a in arr} == {0, 1}
    assert all(a["converged"] and a["miss"] < 1e-6 for a in arr)


def _eigen3_rejected():
    y = np.linspace(-1.0, 1.0, 21)
    base = {"samples": (1.2 - 0.1 * y * y).tolist(), "y": y.tolist(),
            "delta_s": 0.05, "steps": 40, "source": [0.0, 0.0, 0.0],
            "receivers": [[1.0, 0.0, 0.0]], "box": [-1, 2, -1, 1, -1, 1]}
    return [dict(base, source=[0.0, 0.0]), dict(base, receivers=[[1.0, 0.0]]),
            dict(base, fan={"alpha": [0.5, -0.5]}),
            dict(base, samples=[[1.0, 1.1], [1.0, 1.1]]),
            dict(base, steps=100000, fan={"count": [32, 32]})]


@pytest.mark.parametrize("body", _eigen3_rejected(), ids=range(5))
def test_eigenrays3_refusals_match_jax(servers, body):
    t, j = both(servers, "/v1/eigenrays3", body, code=400)
    for word in ("source", "receivers", "PROFILES", "bound"):
        assert (word in t["error"]) == (word in j["error"]), (word, t, j)


# ------------------------------------------------------ /v1/trace3d_samples

def _trace3d_body(**kw):
    col, y = _waveguide()
    return dict({"samples": col, "y": y, "op": "op6", "family": "c1",
                 "delta_s": 0.02, "steps": 300, "rays": 128,
                 "box": [-1.0, 50.0, -1.5, 1.5, -50.0, 50.0],
                 "launch": {"pos": [0.0, 0.0, 0.0], "axis": [1.0, 0.0, 0.2],
                            "half_angle": 0.2},
                 "report_conservation": True}, **kw)


def _grid3_body(**kw):
    ax = np.linspace(-1.5, 1.5, 13)
    Zg, Yg, Xg = np.meshgrid(ax, ax, ax, indexing="ij")
    F = 1.2 - 0.1 * (Yg ** 2 + 0.3 * Xg * Zg)
    return dict({"samples": F.tolist(), "x": ax.tolist(), "y": ax.tolist(),
                 "z": ax.tolist(), "op": "op6", "delta_s": 0.02,
                 "steps": 120, "rays": 64,
                 "launch": {"pos": [-1.0, 0.0, 0.0], "axis": [1.0, 0.0, 0.1],
                            "half_angle": 0.15}}, **kw)


TRACE3_BARS = {"mean_final_pos": SCAN3,
               "slowness_cv_pct_max": lambda g, w: _cv(g, w)}


@pytest.mark.parametrize("case,body", [("profile", _trace3d_body()),
                                       ("grid3", _grid3_body())],
                         ids=["profile", "grid3"])
def test_trace3d_samples_matches_jax(servers, case, body):
    t, _ = both(servers, "/v1/trace3d_samples", body, TRACE3_BARS, code=200)
    if case == "profile":
        assert t["medium_kind"] == "profile-3d" and t["escaped_rays"] == 0
        assert t["slowness_cv_pct_max"] < 0.05
    else:
        assert t["medium_kind"] == "grid3" and t["rays"] == 64


def _trace3d_rejected():
    y = np.linspace(-1.0, 1.0, 21)
    base = {"samples": (1.2 - 0.1 * y * y).tolist(), "y": y.tolist(),
            "delta_s": 0.05, "steps": 20,
            "launch": {"pos": [0, 0, 0], "axis": [1, 0, 0],
                       "half_angle": 0.1}}
    bad3 = _grid3_body()
    del bad3["z"]
    return [dict(base, samples=[[1.0, 1.0], [1.0, 1.0]], x=[0, 1]),
            dict(base, op="op5"),
            dict(base, launch={"pos": [0, 0], "axis": [1, 0, 0]}),
            dict(base, box=[0, 1, 0, 1]), _grid3_body(family="parity"), bad3]


@pytest.mark.parametrize("body", _trace3d_rejected(), ids=range(6))
def test_trace3d_refusals_match_jax(servers, body):
    t, j = both(servers, "/v1/trace3d_samples", body, code=400)
    for word in ("got 2-D samples", "planar", "box", "c1"):
        assert (word in t["error"]) == (word in j["error"]), (word, t, j)


# ------------------------------------------------------------- concurrency

def _strip(resp):
    return {k: v for k, v in resp.items()
            if k not in ("seconds", "ray_steps_per_sec")}


def test_concurrent_requests(servers):
    """tests/test_serve.py::test_concurrent_requests on the port's server,
    8 threads across the endpoints: every response equals the same request
    answered alone."""
    col, y = _profile()
    jobs = [
        ("/v1/trace", TRACE_FISHEYE),
        ("/v1/trace", dict(TRACE_FISHEYE, op="op1")),
        ("/v1/trace_samples", _profile_body(steps=60)),
        ("/v1/trace", {"scenario": "interface", "op": "op6", "rays": 128,
                       "medium": "stratified", "delta_s": 0.3}),
        ("/v1/trace3d_samples", _trace3d_body(steps=100)),
        ("/v1/calibrate_samples", dict(_calibrate_body(), rays=64)),
        ("/v1/trace", {"scenario": "fisheye", "op": "op6", "rays": 64,
                       "medium": "grid", "delta_s": TWO_PI / 60}),
        ("/v1/trace", {"scenario": "aniso", "op": "op11", "rays": 64,
                       "delta_s": 0.3}),
    ]
    url = servers[1]
    alone = [_post(url + p, b) for p, b in jobs]
    with cf.ThreadPoolExecutor(8) as ex:
        together = list(ex.map(lambda j: _post(url + j[0], j[1]), jobs))
    for (p, _), (ca, a), (ct, t) in zip(jobs, alone, together):
        assert ca == ct == 200, (p, a, t)
        assert _strip(t) == _strip(a), p


# ---------------------------------------------------------------- the fuzz

def _fuzz_bodies(n=80, seed=42):
    """tests/test_serve.py::test_fuzzed_payloads_never_5xx's bodies, by its
    generator and seed: (endpoint, body)."""
    rng = np.random.default_rng(seed)
    scalars = [0, -1, 1e308, -1e308, float("inf"), float("nan"), "x",
               None, True, [], {}, "op6", 1e-300, 2**62]
    keys = ["scenario", "op", "rays", "delta_s", "divisor", "n_turns",
            "steps", "medium", "precision", "samples", "x", "y", "family",
            "launch", "pos0", "theta0", "box", "gamma", "tol",
            "arc_length", "candidates", "return_positions",
            "source", "receivers", "fan", "omega"]

    def rand_value(depth=0):
        r = rng.integers(0, 6 if depth < 2 else 4)
        if r == 0:
            return scalars[rng.integers(len(scalars))]
        if r == 1:
            return float(rng.normal(0, 10))
        if r == 2:
            return int(rng.integers(-5, 100))
        if r == 3:
            return [float(v) for v in rng.normal(0, 2, rng.integers(0, 5))]
        if r == 4:
            return [rand_value(depth + 1)
                    for _ in range(rng.integers(0, 4))]
        return {k: rand_value(depth + 1)
                for k in rng.choice(keys, rng.integers(0, 4),
                                    replace=False)}

    endpoints = ["/v1/trace", "/v1/trace_samples", "/v1/calibrate_samples",
                 "/v1/eigenrays", "/v1/trace3d_samples", "/v1/eigenrays3"]
    out = []
    for i in range(n):
        body = {k: rand_value()
                for k in rng.choice(keys, rng.integers(0, 6), replace=False)}
        body.setdefault("rays", 8)
        body["steps"] = min(int(body.get("steps", 8))
                            if isinstance(body.get("steps"), (int, float))
                            and np.isfinite(float(body.get("steps", 8)))
                            else 8, 64)
        out.append((endpoints[i % len(endpoints)], body))
    return out


def _fuzz(servers, bodies):
    for path, body in bodies:
        (jc, j), (tc, t) = _post_both(servers, path, body)
        assert tc in (200, 400), (path, body, t)
        assert tc == jc, (path, body, t, j)


def test_fuzzed_payloads_first_24(servers):
    """The first 24 fuzzed bodies: the port answers each 200 or 400, never
    a 5xx or a dropped connection, and with JAX's code."""
    _fuzz(servers, _fuzz_bodies()[:24])


@pytest.mark.slow
def test_fuzzed_payloads_never_5xx(servers):
    _fuzz(servers, _fuzz_bodies())


# --------------------------------------------------- the device, the build

def test_create_server_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.create_server("127.0.0.1", 0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--port", "0"])
    with pytest.raises(ValueError, match="device"):
        tserve.create_server("127.0.0.1", 0, device="meta")


def test_library_builds_once_under_concurrent_first_calls(monkeypatch):
    """Eight threads make the first call to kernels/build.py::library() at
    once: build() runs once, and every thread gets the one library."""
    calls, lock = [], threading.Lock()
    lib = object()

    def slow_build():
        with lock:
            calls.append(threading.get_ident())
        time.sleep(0.2)
        return "librt_kernels_test.so"

    monkeypatch.setattr(build, "_LIBRARY", [])
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build, "load", lambda path: lib)
    with cf.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda _: build.library(), range(8)))
    assert len(calls) == 1
    assert all(g is lib for g in got)


def test_build_tags_objects_by_process_and_thread(monkeypatch, tmp_path):
    """build() names its object files and its unlinked library by process
    and thread, so two concurrent builds never share a path."""
    seen = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd)
            if "-o" in cmd:
                out = cmd[cmd.index("-o") + 1]
                open(out, "w").close()

        def communicate(self):
            return ("",)

    def run(cmd, **kw):
        seen.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return Proc(cmd)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build.subprocess, "run", run)
    path = build.build()
    assert path.exists()
    import os
    tag = f".{os.getpid()}.{threading.get_ident()}"
    outs = [c[c.index("-o") + 1] for c in seen]
    assert outs and all(tag in o for o in outs), outs
    assert not list(tmp_path.glob("*.o"))
