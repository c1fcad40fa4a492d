"""The port's native spline library (raytracing_tpu_torch/native) against
numpy, scipy and the JAX package's native library (raytracing_tpu/native).

Ports tests/test_native.py: ``gradient2`` against ``np.gradient`` (1e-12),
``bicubic_cells`` against FITPACK's RectBivariateSpline (rtol 1e-9, atol
1e-10), the native grid medium against the scipy one (n rtol 1e-12, the
gradients rtol 1e-7 / atol 1e-10) and the speed claim on the reference's
interface grid.  Adds: the port's library and JAX's compile the same
source with the same g++ command, so ``bicubic_cells``, ``gradient2``,
``cubic_cells_1d`` and the float64 tables of ``build_grid_medium``,
``grid_medium_from_samples`` and ``build_c1_medium`` with
``backend="native"``, the Hermite node tables of the native grid, and of ``build_stratified_medium`` (whose 1-D fit,
as JAX's, takes the native library where it builds), equal JAX's to the
bit on this host; and the library's failure modes (no g++, a foreign
build directory).  Every test needs g++
and skips, saying so, where there is none."""
import shutil
import time

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")
pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is not installed: the native "
                                       "library cannot be compiled here")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu import native as jnative  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402

from raytracing_tpu_torch import native  # noqa: E402
from raytracing_tpu_torch.media import c1 as tc1  # noqa: E402
from raytracing_tpu_torch.media import hermite as therm  # noqa: E402
from raytracing_tpu_torch.media import spline as tspline  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)


def seeded_grid(seed, ny=40, nx=55):
    rng = np.random.default_rng(seed)
    y = np.arange(ny) * 0.21
    x = np.arange(nx) * 0.17
    return (np.cos(y[:, None]) * np.sin(x[None, :])
            + 0.1 * rng.normal(size=(ny, nx))), x, y


def test_gradient2_matches_numpy():
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(57, 83))
    h = 0.13
    ddx, ddy = native.gradient2(Z, h)
    want_dy, want_dx = np.gradient(Z, h, edge_order=2)
    np.testing.assert_allclose(ddx, want_dx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ddy, want_dy, rtol=1e-12, atol=1e-12)


def test_bicubic_cells_match_scipy_spline():
    from scipy.interpolate import RectBivariateSpline

    rng = np.random.default_rng(1)
    ny, nx = 40, 55
    hy, hx = 0.21, 0.17
    y = np.arange(ny) * hy
    x = np.arange(nx) * hx
    Z = np.cos(y[:, None]) * np.sin(x[None, :]) + 0.1 * rng.normal(size=(ny, nx))

    C = native.bicubic_cells(Z)
    spl = RectBivariateSpline(y, x, Z, kx=3, ky=3)

    qy = rng.uniform(0, (ny - 1) * hy, 400)
    qx = rng.uniform(0, (nx - 1) * hx, 400)
    iy = np.minimum((qy / hy).astype(int), ny - 2)
    ix = np.minimum((qx / hx).astype(int), nx - 2)
    uy = qy / hy - iy
    ux = qx / hx - ix
    py = np.stack([np.ones_like(uy), uy, uy**2, uy**3], -1)
    px = np.stack([np.ones_like(ux), ux, ux**2, ux**3], -1)
    got = np.einsum("qab,qa,qb->q", C[iy, ix], py, px)
    want = spl(qy, qx, grid=False)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_native_grid_medium_matches_scipy_backend():
    box = (-1.5, 1.5, -1.5, 1.5)
    m_native = tspline.build_grid_medium("fisheye", box, backend="native",
                                         **F64)
    m_scipy = tspline.build_grid_medium("fisheye", box, backend="scipy",
                                        **F64)
    rng = np.random.default_rng(2)
    qx = torch.as_tensor(rng.uniform(-2, 2, 300))
    qy = torch.as_tensor(rng.uniform(-2, 2, 300))
    n1, (gx1, gy1) = m_native.n_and_grad(qx, qy)
    n2, (gx2, gy2) = m_scipy.n_and_grad(qx, qy)
    np.testing.assert_allclose(H.to_np(n1), H.to_np(n2), rtol=1e-12)
    np.testing.assert_allclose(H.to_np(gx1), H.to_np(gx2), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(H.to_np(gy1), H.to_np(gy2), rtol=1e-7,
                               atol=1e-10)


@pytest.mark.parametrize("family", ["parity", "c1"])
def test_native_samples_media_match_scipy(family):
    """The from-samples build functions of both families, native against scipy at
    the bars above, on a seeded lens."""
    Z, x, y = seeded_grid(3)
    build = (tspline.grid_medium_from_samples if family == "parity"
             else tc1.c1_medium_from_samples)
    a = build(Z, x, y, backend="native", **F64)
    b = build(Z, x, y, backend="scipy", **F64)
    rng = np.random.default_rng(4)
    qx = torch.as_tensor(rng.uniform(x[0], x[-1], 500))
    qy = torch.as_tensor(rng.uniform(y[0], y[-1], 500))
    (n1, g1), (n2, g2) = a.n_and_grad(qx, qy), b.n_and_grad(qx, qy)
    np.testing.assert_allclose(H.to_np(n1), H.to_np(n2), rtol=1e-12)
    for u, v in zip(g1, g2):
        np.testing.assert_allclose(H.to_np(u), H.to_np(v), rtol=1e-7,
                                   atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primitives_equal_jax_native_to_the_bit(seed):
    """The same source, flags and host: the same bits."""
    assert jnative.available()
    Z, x, y = seeded_grid(seed, ny=31 + seed, nx=47 - seed)
    np.testing.assert_array_equal(native.bicubic_cells(Z),
                                  jnative.bicubic_cells(Z))
    for got, want in zip(native.gradient2(Z, 0.07 + seed),
                         jnative.gradient2(Z, 0.07 + seed)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tspline.cubic_cells_1d(Z[:, 0]),
                                  jspline.cubic_cells_1d(Z[:, 0]))


def _table_builds():
    box = rt.scenario("fisheye").box
    Z, x, y = seeded_grid(5)
    return {
        "build_grid_medium": (
            lambda: jspline.build_grid_medium("fisheye", box, 0.05,
                                              dtype=np.float64,
                                              backend="native"),
            lambda: tspline.build_grid_medium("fisheye", box, 0.05,
                                              backend="native", **F64)),
        "grid_medium_from_samples": (
            lambda: jspline.grid_medium_from_samples(
                Z, x, y, dtype=np.float64, backend="native"),
            lambda: tspline.grid_medium_from_samples(
                Z, x, y, backend="native", **F64)),
        "build_stratified_medium": (
            lambda: jspline.build_stratified_medium(
                "vert_heterogeneous", rt.scenario("vert").box,
                dtype=np.float64),
            lambda: tspline.build_stratified_medium(
                "vert_heterogeneous", rt.scenario("vert").box, **F64)),
        "build_hermite_medium": (
            lambda: jherm.build_hermite_medium(
                jspline.build_grid_medium("fisheye", box, 0.05,
                                          dtype=np.float64, backend="native"),
                dtype=np.float64),
            lambda: therm.build_hermite_medium(
                tspline.build_grid_medium("fisheye", box, 0.05,
                                          backend="native", **F64),
                dtype=torch.float64)),
        "build_c1_medium": (
            lambda: jc1.build_c1_medium("fisheye", box, 0.05,
                                        dtype=np.float64, backend="native"),
            lambda: tc1.build_c1_medium("fisheye", box, 0.05,
                                        backend="native", **F64)),
    }


@pytest.mark.parametrize("build", sorted(_table_builds()))
def test_native_tables_equal_jax_native_to_the_bit(build):
    jax_build, port_build = _table_builds()[build]
    jm, tm = jax_build(), port_build()
    for name, want in H.medium_fields(jm).items():
        got = getattr(tm, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == torch.float64, name
            np.testing.assert_array_equal(H.to_np(got), want, err_msg=name)
        elif name not in ("n_min", "g_max", "kappa_max"):
            assert got == want, name


def test_auto_takes_native_where_it_builds():
    """backend="auto" is the native library wherever it builds, as JAX's."""
    Z, x, y = seeded_grid(6)
    auto = tspline.grid_medium_from_samples(Z, x, y, **F64)
    nat = tspline.grid_medium_from_samples(Z, x, y, backend="native", **F64)
    for name in ("Z", "cx", "cy"):
        assert torch.equal(getattr(auto, name), getattr(nat, name)), name
    with pytest.raises(ValueError, match="backend"):
        tspline.grid_medium_from_samples(Z, x, y, backend="fitpack", **F64)


@pytest.fixture
def fresh_build_dir(monkeypatch, tmp_path):
    """The native module with no library loaded and ``tmp_path/native`` as its
    build directory."""
    monkeypatch.setattr(native, "_LIB_CACHE", [])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    return tmp_path / "native"


def test_no_gxx_native_raises_and_auto_takes_scipy(fresh_build_dir,
                                                   monkeypatch):
    """Without g++, ``backend="native"`` raises (as JAX's does), and
    ``available()`` is False, so ``"auto"`` builds with scipy."""
    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native.subprocess, "run", no_gxx)
    assert not native.available()
    Z, x, y = seeded_grid(7)
    with pytest.raises(FileNotFoundError):
        tspline.grid_medium_from_samples(Z, x, y, backend="native", **F64)
    auto = tspline.grid_medium_from_samples(Z, x, y, **F64)
    sci = tspline.grid_medium_from_samples(Z, x, y, backend="scipy", **F64)
    assert torch.equal(auto.cx, sci.cx) and torch.equal(auto.cy, sci.cy)


def test_refuses_a_directory_others_can_write(fresh_build_dir):
    fresh_build_dir.mkdir(mode=0o700)
    fresh_build_dir.chmod(0o777)
    with pytest.raises(RuntimeError, match="group/world writable"):
        native.bicubic_cells(np.ones((5, 5)))
    assert not native.available()


def test_concurrent_first_builds_all_load(fresh_build_dir):
    """Three processes building into one empty directory at once: each
    compiles to its own file and renames it into place, and all load."""
    import subprocess
    import sys
    code = ("import sys; from pathlib import Path; "
            "import raytracing_tpu_torch.native as n; "
            f"n.BUILD_DIR = Path({str(fresh_build_dir)!r}); "
            "import numpy as np; "
            "c = n.bicubic_cells(np.arange(30.0).reshape(5, 6)); "
            "print(c.shape)")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("(4, 5, 4, 4)" in o for o in outs)
    assert [p.suffix for p in fresh_build_dir.iterdir()] == [".so"]


@pytest.mark.slow
def test_native_is_faster_on_reference_grid():
    """The point of going native: the interface-scenario grid (~1M points),
    best of 3 a backend."""
    box = (-2.0, 20.0, -2.0, 4.0)

    def best(backend):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            tspline.build_grid_medium("interface", box, device="cpu",
                                      backend=backend)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    assert best("native") < best("scipy")
