"""The port's sampled media against the JAX package's at float64: the
build functions' tables (both with ``backend="scipy"`` where they have the
switch; the 1-D cells by the native library in both, where g++ builds it),
the stratified trims, ``medium_from_samples``, ``n_and_grad`` of all five
classes on seeded points (cell edges and points outside the grid included),
and the interop that carries a JAX medium across."""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import samples as jsamples  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402

from raytracing_tpu_torch.interop import medium_from_numpy  # noqa: E402
from raytracing_tpu_torch.media import c1 as tc1  # noqa: E402
from raytracing_tpu_torch.media import hermite as therm  # noqa: E402
from raytracing_tpu_torch.media import samples as tsamples  # noqa: E402
from raytracing_tpu_torch.media import spline as tspline  # noqa: E402

TABLE_TOL = 1e-12   # float64 tables: the same FITPACK fit in both packages
EVAL_TOL = 1e-12    # float64 n and grad n on the same tables
GRID_DELTA = 0.1    # a coarse 2-D grid (91 x 91 fisheye nodes) keeps it quick
F64 = dict(device="cpu", dtype=torch.float64)


def _np(t):
    return H.to_np(t) if torch.is_tensor(t) else np.asarray(t)


def assert_same_medium(tm, jm, tol=TABLE_TOL):
    """Every field of the port's medium equals the JAX medium's."""
    for name, want in H.medium_fields(jm).items():
        got = getattr(tm, name)
        if isinstance(want, np.ndarray):
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol,
                                       err_msg=name)
        elif name not in ("n_min", "g_max", "kappa_max"):
            assert got == pytest.approx(want, rel=1e-15, abs=0), name


def build_pair(kind):
    """(JAX medium, port medium) of one class, from the same builder."""
    if kind in ("StratifiedGridMedium", "C1StratifiedMedium"):
        scen = rt.scenario("interface")
        if kind == "StratifiedGridMedium":
            return (jspline.build_stratified_medium(
                        "interface", scen.box, dtype=np.float64),
                    tspline.build_stratified_medium("interface", scen.box,
                                                    **F64))
        return (jc1.build_c1_stratified("interface", scen.box,
                                        dtype=np.float64),
                tc1.build_c1_stratified("interface", scen.box, **F64))
    box = rt.scenario("fisheye").box
    if kind == "C1GridMedium":
        return (jc1.build_c1_medium("fisheye", box, GRID_DELTA,
                                    dtype=np.float64, backend="scipy"),
                tc1.build_c1_medium("fisheye", box, GRID_DELTA,
                                    backend="scipy", **F64))
    jg = jspline.build_grid_medium("fisheye", box, GRID_DELTA,
                                   dtype=np.float64, backend="scipy")
    tg = tspline.build_grid_medium("fisheye", box, GRID_DELTA,
                                   backend="scipy", **F64)
    if kind == "GridMedium":
        return jg, tg
    return (jherm.build_hermite_medium(jg, dtype=np.float64),
            therm.build_hermite_medium(tg, dtype=torch.float64))


KINDS = ("GridMedium", "StratifiedGridMedium", "HermiteGridMedium",
         "C1GridMedium", "C1StratifiedMedium")


@pytest.mark.parametrize("kind", KINDS)
def test_builders_match_jax(kind):
    jm, tm = build_pair(kind)
    assert type(tm).__name__ == kind
    assert_same_medium(tm, jm)


@pytest.mark.parametrize("field", ["vert_heterogeneous", "interface"])
def test_stratified_builders_match_jax_on_each_field(field):
    box = rt.scenario("vert" if field != "interface" else "interface").box
    assert_same_medium(
        tspline.build_stratified_medium(field, box, **F64),
        jspline.build_stratified_medium(field, box, dtype=np.float64))
    assert_same_medium(
        tc1.build_c1_stratified(field, box, **F64),
        jc1.build_c1_stratified(field, box, dtype=np.float64))


def _points(m, rng, n=256):
    """Seeded points over the grid, on cell edges and outside it."""
    nx = getattr(m, "nx", 2)
    x0 = getattr(m, "x0", -1.0)
    hx = 1.0 / getattr(m, "inv_hx", 1.0)
    hy = 1.0 / m.inv_hy
    xs = x0 + (nx - 1) * hx * rng.uniform(-0.1, 1.1, n)
    ys = m.y0 + (m.ny - 1) * hy * rng.uniform(-0.1, 1.1, n)
    kx = rng.integers(0, nx, 32)
    ky = rng.integers(0, m.ny, 32)
    xs[:32] = x0 + kx * hx              # exactly on cell edges (to rounding)
    ys[:32] = m.y0 + ky * hy
    return xs, ys


@pytest.mark.parametrize("kind", KINDS)
def test_n_and_grad_match_jax(kind):
    jm, tm = build_pair(kind)
    x, y = _points(jm, np.random.default_rng(3))
    jn, (jgx, jgy) = jm.n_and_grad(x, y)
    tn, (tgx, tgy) = tm.n_and_grad(torch.as_tensor(x), torch.as_tensor(y))
    for name, a, b in (("n", tn, jn), ("gx", tgx, jgx), ("gy", tgy, jgy)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(H.to_np(a), np.asarray(b), rtol=0,
                                   atol=EVAL_TOL, err_msg=name)


@pytest.mark.parametrize("family", ["parity", "c1"])
@pytest.mark.parametrize("name", ["interface", "vert"])
def test_compact_for_trace_matches_jax(family, name):
    scen = rt.scenario(name)
    if family == "parity":
        jm = jspline.build_stratified_medium(scen.field, scen.box,
                                             dtype=np.float64)
        tm = tspline.build_stratified_medium(scen.field, scen.box, **F64)
    else:
        jm = jc1.build_c1_stratified(scen.field, scen.box, dtype=np.float64)
        tm = tc1.build_c1_stratified(scen.field, scen.box, **F64)
    for ds in (0.02, 0.3):
        jc = jsamples.compact_for_trace(jm, scen.box, ds)
        tc = tsamples.compact_for_trace(tm, scen.box, ds)
        assert tc.ny < tm.ny          # the trim bites
        assert_same_medium(tc, jc)
    grid = tspline.build_grid_medium("fisheye", rt.scenario("fisheye").box,
                                     GRID_DELTA, **F64)
    assert tsamples.compact_for_trace(grid, scen.box, 0.1) is grid


@pytest.mark.parametrize("family", ["parity", "c1"])
def test_medium_from_samples_matches_jax(family):
    rng = np.random.default_rng(7)
    y = np.linspace(-1.0, 2.0, 40)
    profile = 1.2 + 0.1 * np.sin(2.0 * y) + 0.01 * rng.standard_normal(40)
    jm, jbox, jkind = jsamples.medium_from_samples(profile, y=y,
                                                   family=family,
                                                   dtype=np.float64)
    tm, tbox, tkind = tsamples.medium_from_samples(profile, y=y,
                                                   family=family, **F64)
    assert (tbox, tkind) == (jbox, jkind)
    assert_same_medium(tm, jm)
    x = np.linspace(-2.0, 1.0, 30)
    Z = 1.0 + 0.2 * np.exp(-(x[None, :] ** 2 + y[:, None] ** 2))
    jm, jbox, jkind = jsamples.medium_from_samples(Z, x, y, family=family,
                                                   dtype=np.float64)
    tm, tbox, tkind = tsamples.medium_from_samples(Z, x, y, family=family,
                                                   **F64)
    assert (tbox, tkind) == (jbox, jkind)
    # both packages' 2-D sample build functions take their native spline library
    # where g++ builds it (no backend switch in medium_from_samples): the
    # same C++ source and flags give the same bits, else both fall back to
    # FITPACK
    assert_same_medium(tm, jm, tol=0.0)


def test_samples_and_builders_refuse_bad_input():
    y = np.linspace(0.0, 1.0, 10)
    with pytest.raises(ValueError, match="family"):
        tsamples.medium_from_samples(np.ones(10), y=y, family="warp", **F64)
    with pytest.raises(ValueError, match="'y'"):
        tsamples.medium_from_samples(np.ones(10), **F64)
    with pytest.raises(ValueError, match="ascending"):
        tsamples.medium_from_samples(np.ones(10), y=y[::-1], **F64)
    with pytest.raises(ValueError, match="'x'"):
        tsamples.medium_from_samples(np.ones((10, 10)), y=y, **F64)
    with pytest.raises(ValueError, match="fisheye"):
        tspline.build_stratified_medium("fisheye", (-1, 1, -1, 1), **F64)
    with pytest.raises(ValueError, match="4x4"):
        tspline.grid_medium_from_samples(np.ones((3, 3)), y[:3], y[:3],
                                         **F64)


@pytest.mark.parametrize("kind", KINDS)
def test_interop_carries_a_jax_medium_across(kind):
    jm, _ = build_pair(kind)
    tm = H.port_medium(jm)
    assert type(tm).__name__ == kind
    for name, want in H.medium_fields(jm).items():
        got = getattr(tm, name)
        if isinstance(want, np.ndarray):
            assert torch.is_tensor(got) and got.dtype == torch.float64
            np.testing.assert_array_equal(H.to_np(got), want)
        else:
            assert got == want, name
    moved = tm.to(torch.float32).to("cpu")
    assert type(moved) is type(tm) and moved.ny == tm.ny
    x, y = _points(jm, np.random.default_rng(11), 64)
    jn, (_, jgy) = jm.n_and_grad(x, y)
    tn, (_, tgy) = tm.n_and_grad(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(H.to_np(tn), np.asarray(jn), atol=EVAL_TOL)
    np.testing.assert_allclose(H.to_np(tgy), np.asarray(jgy), atol=EVAL_TOL)


def test_interop_refuses_unknown_media():
    with pytest.raises(ValueError, match="unknown medium class"):
        medium_from_numpy("CustomMedium", {}, device="cpu")
    with pytest.raises(ValueError, match="needs field 'Zy'"):
        medium_from_numpy("StratifiedGridMedium", {"cy": np.zeros((3, 4))},
                          device="cpu")
