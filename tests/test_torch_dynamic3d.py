"""The 3-D dynamic scan tier (engine/dynamic3d.py) against the JAX package's
at float64: trace_dynamic3 on the analytic fisheye, a Custom3D lens, a
Stratified3D waveguide, a Stratified3D over a C1 profile table and a 12^3
grid3 medium, every op, history and metrics (atol 1e-9, det Q rtol 1e-9);
both crossing-recording modes; and JAX's own oracles of
tests/test_dynamic3d.py run on the port (spherical spreading, the
fisheye's point focus, the astigmatic caustic count, finite differences,
the crossing records against the host scan)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

from raytracing_tpu.engine import dynamic3d as jd  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import fields3d as jf3  # noqa: E402
from raytracing_tpu.media import grid3 as jg3  # noqa: E402
from raytracing_tpu.media.medium import CustomMedium as JCustom  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import dynamic3d as td  # noqa: E402
from raytracing_tpu_torch.engine import eigenray as ter  # noqa: E402

CPU = dict(device="cpu")
F64 = dict(atol=1e-9, rtol=0)
BOX = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)


def _lens(lib):
    """The JAX test's Gaussian lens bump (tests/test_dynamic3d.py:87)."""
    def n_fn(x, y, z):
        return 1.2 - 0.3 * lib.exp(-((x - 1.5) ** 2 + y ** 2 + z ** 2))
    return n_fn


def _guide(x, y):
    return 1.5 - 0.5 * y * y + 0.0 * x


def _profile():
    """A 41-sample smooth profile in y (a C1 stratified table)."""
    y = np.linspace(-2.0, 2.0, 41)
    return 1.0 + 0.1 * np.tanh(y) + 0.02 * y * y, y


@pytest.fixture(scope="module")
def media():
    """name -> (JAX medium, port medium, launch): each case's pos0, dir0,
    delta_s, steps and box."""
    ax = np.linspace(-1.6, 1.6, 12)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    jg = jg3.c1_medium3_from_samples(1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2),
                                     ax, ax, ax, dtype=np.float64)
    samples, y = _profile()
    jprof = jc1.c1_stratified_from_samples(samples, y, dtype=np.float64)
    r = 6
    th = np.pi / 2 + np.linspace(-0.3, 0.3, r)
    fish = (np.tile([[1.0, 0.0, 0.0]], (r, 1)),
            np.stack([np.cos(th), np.sin(th), np.linspace(0, 0.5, r)], -1),
            0.02, 200, BOX)
    # the grid's gather is the slow medium on both sides: a shorter run
    fish_grid = fish[:3] + (120, BOX)
    a = np.linspace(-0.3, 0.3, r)
    flat = (np.zeros((r, 3)),
            np.stack([np.cos(a), np.sin(a), np.linspace(-0.1, 0.1, r)], -1),
            0.02, 150, (-1.0, 6.0, -1.5, 1.5, -2.0, 2.0))
    return {
        "fisheye": (jf3.analytic_medium3("fisheye"),
                    rtt.analytic_medium3("fisheye"), fish),
        "lens": (jf3.Custom3D(_lens(jnp)), rtt.Custom3D(_lens(torch)),
                 flat),
        "guide": (jf3.Stratified3D(JCustom(_guide)),
                  rtt.Stratified3D(rtt.CustomMedium(_guide)), flat),
        "profile": (jf3.Stratified3D(jprof),
                    rtt.Stratified3D(H.port_medium(jprof)), flat),
        "grid3": (jg, H.port_medium(jg), fish_grid),
    }


def _assert_result(t, j):
    for f in ("pos", "unitv", "n", "traveltime", "dist_real", "dist_sim",
              "Q", "min_absdet", "n0"):
        np.testing.assert_allclose(H.to_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), err_msg=f,
                                   **F64)
    np.testing.assert_allclose(H.to_np(t.detq), np.asarray(j.detq),
                               rtol=1e-9, atol=1e-9)
    for f in ("exit_step", "kmah", "min_absdet_step"):
        np.testing.assert_array_equal(H.to_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("op", ["op1", "op2", "op6", "op8"])
@pytest.mark.parametrize("name",
                         ["fisheye", "lens", "guide", "profile", "grid3"])
def test_trace_dynamic3_matches_jax(name, op, media):
    """History mode (the full 16-column rows) against JAX's jvp tangents:
    measured <= 2e-14 in every column."""
    jm, tm, (pos0, dir0, ds, steps, box) = media[name]
    kw = dict(pos0=pos0, dir0=dir0, delta_s=ds, steps=steps, box=box)
    j = jd.trace_dynamic3(op, jm, mode="history", full_history=True, **kw)
    t = td.trace_dynamic3(op, tm, mode="history", full_history=True, **kw,
                          **CPU)
    _assert_result(t, j)
    np.testing.assert_allclose(H.to_np(t.history), np.asarray(j.history),
                               **F64)
    assert t.history.shape == (steps + 1, len(pos0), len(td.DYN3_FULL_COLS))


@pytest.mark.parametrize("name", ["fisheye", "grid3"])
def test_metrics_mode_matches_jax_with_a_step_limit(name, media):
    jm, tm, (pos0, dir0, ds, steps, box) = media[name]
    kw = dict(pos0=pos0, dir0=dir0, delta_s=ds, steps=steps, box=box,
              step_limit=steps - 37)
    j = jd.trace_dynamic3("op6", jm, mode="metrics", **kw)
    t = td.trace_dynamic3("op6", tm, mode="metrics", **kw, **CPU)
    assert t.history is None
    _assert_result(t, j)


@pytest.mark.parametrize("name", ["guide", "profile"])
def test_crossing_records_match_jax(name, media):
    """trace_crossings_fan3 and trace_crossings_pick3 against JAX's, two
    receiver ranges, 24 rays that cross them once or twice."""
    jm, tm, _ = media[name]
    r = 24
    th = np.linspace(-0.4, 0.4, r)
    kw = dict(pos0=np.zeros((r, 3)),
              dir0=np.stack([np.cos(th), np.sin(th), np.full(r, 0.05)], -1),
              delta_s=0.02, steps=600, box=(-1, 14, -1.5, 1.5, -2, 2))
    ranges = np.array([4.0, 9.0])
    jf = jd.trace_crossings_fan3("op6", jm, ranges=ranges, max_ord=4, **kw)
    tf = td.trace_crossings_fan3("op6", tm, ranges=ranges, max_ord=4, **kw,
                                 **CPU)
    np.testing.assert_array_equal(H.to_np(tf.counts), np.asarray(jf.counts))
    np.testing.assert_allclose(H.to_np(tf.depths), np.asarray(jf.depths),
                               equal_nan=True, **F64)
    assert int(tf.counts.max()) >= 1
    xr = np.where(np.arange(r) % 2 == 0, 4.0, 9.0)
    ordk = (np.arange(r) % 3).astype(np.int32)
    jp = jd.trace_crossings_pick3("op6", jm, xr=xr, ordk=ordk, **kw)
    tp = td.trace_crossings_pick3("op6", tm, xr=xr, ordk=ordk, **kw, **CPU)
    np.testing.assert_array_equal(H.to_np(tp.found), np.asarray(jp.found))
    np.testing.assert_allclose(H.to_np(tp.state), np.asarray(jp.state),
                               **F64)


# -- JAX's oracles (tests/test_dynamic3d.py) on the port --------------------

def _homog3():
    return rtt.Custom3D(lambda x, y, z: torch.ones_like(x))


def test_homogeneous_spherical_spreading_exact():
    d = np.array([[1.0, 2.0, 2.0], [0.0, 0.0, 1.0], [3.0, -4.0, 0.0]])
    res = td.trace_dynamic3("op6", _homog3(), pos0=np.zeros((3, 3)), dir0=d,
                            delta_s=0.1, steps=50, **CPU)
    np.testing.assert_allclose(H.to_np(res.detq), 25.0, atol=1e-9)
    np.testing.assert_allclose(H.to_np(res.transmission_loss_db()),
                               20.0 * np.log10(5.0), atol=1e-9)
    assert np.all(H.to_np(res.kmah) == 0)
    np.testing.assert_allclose(
        H.to_np(res.Q), np.broadcast_to(5.0 * np.eye(2), (3, 2, 2)),
        atol=1e-9)
    np.testing.assert_allclose(H.to_np(res.amplitude()), 0.2, atol=1e-12)


def test_fisheye_point_focus_localized():
    """Perfect imaging: det Q collapses at the antipode without a sign
    change and the ray refocuses at the source after the full turn."""
    div = 600
    res = td.trace_dynamic3(
        "op6", rtt.analytic_medium3("fisheye"),
        pos0=np.tile([[1.0, 0, 0]], (2, 1)),
        dir0=np.array([[0, 1.0, 0], [0, np.cos(0.5), np.sin(0.5)]]),
        delta_s=2 * np.pi / div, steps=div, **CPU)
    h = H.to_np(res.history)[..., td.DYN3_COLS.index("detq")]
    interior = np.abs(h[div // 4: 3 * div // 4])
    antipode = np.argmin(interior, axis=0) + div // 4
    assert np.all(np.abs(antipode - div // 2) <= 1)
    assert interior.min() < 1e-8
    assert np.abs(h[1:]).max() > 1.0
    assert np.all(H.to_np(res.min_absdet_step) == div)
    assert H.to_np(res.min_absdet).max() < 1e-9
    assert np.all(H.to_np(res.kmah) == 0)


def test_astigmatic_caustic_flips_det_sign():
    med = rtt.Stratified3D(rtt.CustomMedium(_guide))
    tilt = 0.3
    res = td.trace_dynamic3("op6", med, pos0=np.zeros((1, 3)),
                            dir0=np.array([[np.cos(tilt), np.sin(tilt), 0.0]]),
                            delta_s=0.02, steps=1500, **CPU)
    h = H.to_np(res.history)[..., td.DYN3_COLS.index("detq")][:, 0]
    sign_changes = int(np.sum(np.sign(h[1:-1]) * np.sign(h[2:]) < 0))
    assert sign_changes >= 2
    assert int(res.kmah[0]) == sign_changes


def test_matches_finite_differences_on_3d_medium():
    """|det Q| equals the central-difference Jacobian determinant of the
    port's own float64 kinematic trace (trace3d) on the lens."""
    med = rtt.Custom3D(_lens(torch))
    pos0 = np.zeros((2, 3))
    dir0 = np.array([[1.0, 0.15, 0.1], [1.0, -0.1, 0.2]])
    ds, steps = 0.01, 300
    res = td.trace_dynamic3("op6", med, pos0=pos0, dir0=dir0, delta_s=ds,
                            steps=steps, mode="metrics", **CPU)
    u0 = dir0 / np.linalg.norm(dir0, axis=1, keepdims=True)
    e1, e2 = (H.to_np(v) for v in td._transverse_frame(torch.as_tensor(u0)))
    eps = 1e-6

    def kin(da, db):
        return H.to_np(rtt.trace3d(
            "op6", med, pos0=pos0, dir0=u0 + da * e1 + db * e2, delta_s=ds,
            steps=steps, dtype=torch.float64, mode="metrics",
            **CPU).final.pos)

    dpa = (kin(eps, 0) - kin(-eps, 0)) / (2 * eps)
    dpb = (kin(0, eps) - kin(0, -eps)) / (2 * eps)
    f1, f2 = (H.to_np(v) for v in td._transverse_frame(res.unitv))
    Qfd = np.stack([
        np.stack([np.sum(dpa * f1, 1), np.sum(dpb * f1, 1)], -1),
        np.stack([np.sum(dpa * f2, 1), np.sum(dpb * f2, 1)], -1)], -2)
    np.testing.assert_allclose(np.abs(H.to_np(res.detq)),
                               np.abs(np.linalg.det(Qfd)), rtol=1e-4)


def test_metrics_matches_history_and_errors():
    kw = dict(pos0=np.zeros((2, 3)), dir0=np.array([[1.0, 0, 0], [0, 1.0, 0]]),
              delta_s=0.1, steps=20, **CPU)
    a = td.trace_dynamic3("op8", _homog3(), mode="metrics", **kw)
    b = td.trace_dynamic3("op8", _homog3(), mode="history", **kw)
    assert a.history is None
    assert torch.equal(a.detq, b.detq)
    assert torch.equal(b.history[-1, :, td.DYN3_COLS.index("detq")], b.detq)
    with pytest.raises(ValueError, match="mode"):
        td.trace_dynamic3("op1", _homog3(), mode="full", **kw)
    with pytest.raises(ValueError, match="planar"):
        td.trace_dynamic3("op5", _homog3(), **kw)
    with pytest.raises(ValueError, match="box"):
        td.trace_dynamic3("op6", _homog3(), box=(0, 1, 0, 1), **kw)
    with pytest.raises(ValueError, match=r"\(rays, 3\)"):
        td.trace_dynamic3("op6", _homog3(), pos0=np.zeros((2, 2)),
                          dir0=np.zeros((2, 2)), delta_s=0.1, steps=2, **CPU)


def test_crossing_records_match_host_scan():
    """The crossing recorders reproduce the port's host-side full-history
    machinery (engine/eigenray.py::_crossing_vals, _pick_crossings):
    tests/test_dynamic3d.py:151-203 on the port."""
    med = rtt.Custom3D(lambda x, y, z: 1.5 - 0.5 * y * y + 0.0 * x)
    r = 24
    th = np.linspace(-0.4, 0.4, r)
    kw = dict(pos0=np.zeros((r, 3)),
              dir0=np.stack([np.cos(th), np.sin(th), np.full(r, 0.05)], -1),
              delta_s=0.02, steps=1200, box=(-1, 26, -1.5, 1.5, -2, 2),
              **CPU)
    res = td.trace_dynamic3("op6", med, mode="history", full_history=True,
                            **kw)
    hist, last = H.to_np(res.history), H.to_np(res.exit_step)
    fan = td.trace_crossings_fan3("op6", med, ranges=np.array([10.0, 20.0]),
                                  max_ord=8, **kw)
    yz_host = ter._crossing_vals(hist, last, 10.0, (1, 2), 0)
    d = H.to_np(fan.depths)[:, 0, :yz_host.shape[1], :]
    mask = np.isfinite(yz_host)
    np.testing.assert_array_equal(np.isfinite(yz_host), np.isfinite(d))
    np.testing.assert_allclose(np.where(mask, yz_host, 0.0),
                               np.where(mask, d, 0.0), rtol=1e-12,
                               atol=1e-14)
    xr = np.full(r, 10.0)
    ordk = np.zeros(r, np.int32)
    pick = td.trace_crossings_pick3("op6", med, xr=xr, ordk=ordk, **kw)
    st, found = H.to_np(pick.state), H.to_np(pick.found)
    hs, hf = ter._pick_crossings(hist, last, xr, ordk, 0,
                                 td.DYN3_FULL_COLS.index("kmah"))
    np.testing.assert_array_equal(found, hf)
    colmap = {"y": 1, "z": 2, "traveltime": 3, "n": 4, "detq": 5,
              "kmah": 6, "ux": 7, "uy": 8, "uz": 9, "dpax": 10,
              "dpay": 11, "dpaz": 12, "dpbx": 13, "dpby": 14, "dpbz": 15}
    for ci, name in enumerate(td.CROSS3_COLS):
        np.testing.assert_allclose(st[found, ci], hs[found, colmap[name]],
                                   rtol=1e-12, atol=1e-14, err_msg=name)


def test_inference_mode_gives_the_same_tangents():
    kw = dict(pos0=np.tile([[1.0, 0, 0]], (3, 1)),
              dir0=np.array([[0, 1.0, 0.1], [0, 1.0, 0.3], [0, 0.6, 1.0]]),
              delta_s=0.05, steps=40, **CPU)
    a = td.trace_dynamic3("op2", rtt.analytic_medium3("fisheye"), **kw)
    with torch.inference_mode():
        b = td.trace_dynamic3("op2", rtt.analytic_medium3("fisheye"), **kw)
    for f in ("detq", "Q", "kmah", "min_absdet_step"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
