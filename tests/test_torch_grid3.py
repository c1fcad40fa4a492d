"""The port's sampled 3-D grid media (raytracing_tpu_torch.media.grid3)
against the JAX package's: node tables and the gather evaluator at float64
to 1e-12; the kernel's per-cell layout (cells64 against JAX's _cells64, bit
for bit) and its plain evaluator (tile_nag3_plain against JAX's window
evaluator _tile_nag3 given the full-grid window); and the JAX package's own
grid3 tests (tests/test_grid3.py) on the port: tricubic reproduction,
gradient consistency, clamping, validation, the sampled fisheye's
Bouguer and closure oracles."""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raytracing_tpu.engine import tiled3 as jtiled3  # noqa: E402
from raytracing_tpu.kernels import fused3d as jfused3d  # noqa: E402
from raytracing_tpu.media import grid3 as jg3  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine.tiled3 import (  # noqa: E402
    cells64, grid3_tables)
from raytracing_tpu_torch.engine.trace3d import (  # noqa: E402
    bouguer_invariant, trace3d)
from raytracing_tpu_torch.kernels.fused3d import tile_nag3_plain  # noqa: E402
from raytracing_tpu_torch.media import grid3 as tg3  # noqa: E402
from raytracing_tpu_torch.media.fields3d import analytic_medium3  # noqa: E402

CPU = dict(device="cpu")
F64 = torch.float64


def _grid(nx=9, ny=10, nz=11, span=1.5):
    x = np.linspace(-span, span, nx)
    y = np.linspace(-span, span, ny)
    z = np.linspace(-span, span, nz)
    return x, y, z, np.meshgrid(z, y, x, indexing="ij")


def _bump():
    x, y, z, (Zg, Yg, Xg) = _grid(12, 11, 10)
    F = 1.0 + 0.25 * np.exp(-(Xg ** 2 + 0.5 * Yg ** 2 + 2.0 * Zg ** 2))
    return F, x, y, z


def test_nodes_and_evaluator_match_jax_f64():
    """The node table equals JAX's to 1e-12, every static field equal, and
    n_and_grad3 (inside, on and beyond the grid's edges) to 1e-12."""
    F, x, y, z = _bump()
    jm = jg3.c1_medium3_from_samples(F, x, y, z, dtype=np.float64)
    tm = tg3.c1_medium3_from_samples(F, x, y, z, dtype=F64, **CPU)
    np.testing.assert_allclose(H.to_np(tm.nodes), np.asarray(jm.nodes),
                               atol=1e-12, rtol=0)
    for f in ("x0", "y0", "z0", "inv_hx", "inv_hy", "inv_hz", "nx", "ny",
              "nz", "n_min", "g_max"):
        assert getattr(tm, f) == pytest.approx(getattr(jm, f), rel=1e-15)
    q = np.random.default_rng(3).uniform(-1.8, 1.8, (500, 3))
    n_j, g_j = jm.n_and_grad3(q[:, 0], q[:, 1], q[:, 2])
    qt = torch.as_tensor(q)
    n_t, g_t = tm.n_and_grad3(qt[:, 0], qt[:, 1], qt[:, 2])
    np.testing.assert_allclose(H.to_np(n_t), np.asarray(n_j), atol=1e-12,
                               rtol=0)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(H.to_np(a), np.asarray(b), atol=1e-12,
                                   rtol=0)


def test_interop_carries_a_jax_grid3_medium():
    F, x, y, z = _bump()
    jm = jg3.c1_medium3_from_samples(F, x, y, z)
    tm = H.port_medium(jm)
    assert isinstance(tm, rtt.C1Grid3Medium)
    assert tm.nodes.dtype == torch.float32
    np.testing.assert_array_equal(H.to_np(tm.nodes), np.asarray(jm.nodes))
    assert torch.equal(tm.nodes, tg3.c1_medium3_from_samples(
        F, x, y, z, **CPU).nodes)


def test_cells64_equals_jax_bit_for_bit():
    F, x, y, z = _bump()
    jm = jg3.c1_medium3_from_samples(F, x, y, z)
    j = np.asarray(jtiled3._cells64(
        jnp.asarray(jm.nodes).reshape(jm.nz, jm.ny, jm.nx, 8)))
    tm = H.port_medium(jm)
    t = grid3_tables(tm)
    np.testing.assert_array_equal(H.to_np(t.table), j)
    assert t.table.shape == ((jm.nz - 1) * (jm.ny - 1) * (jm.nx - 1), 64)
    assert torch.equal(cells64(tm.nodes.reshape(jm.nz, jm.ny, jm.nx, 8)),
                       t.table)


def test_tile_nag3_plain_matches_jax_window_evaluator():
    """JAX's _tile_nag3 handed the window of the whole 5x5x5-cell grid
    (tests/test_tiled3.py:56-95) against the port's direct row read, at
    float32 on points inside and outside the grid: n and the gradient
    equal to the bit (the same products and sums in the same order)."""
    ax = np.linspace(-1.6, 1.6, 6)
    Zg, Yg, Xg = np.meshgrid(ax, ax, ax, indexing="ij")
    F = 1.0 / (1.0 + Xg ** 2 + Yg ** 2 + Zg ** 2)
    jm = jg3.c1_medium3_from_samples(F, ax, ax, ax, dtype=np.float32)
    lanes = jfused3d.LANES
    pts = np.random.default_rng(0).uniform(-1.9, 1.9, (3, 2, lanes)).astype(
        np.float32)
    c64 = np.asarray(jtiled3._cells64(
        jnp.asarray(jm.nodes).reshape(jm.nz, jm.ny, jm.nx, 8)))
    cells = np.zeros((lanes, 64), np.float32)
    cells[:c64.shape[0]] = c64
    T = [jnp.broadcast_to(jnp.asarray(cells[:, i])[None, :], (2, lanes))
         for i in range(64)]
    meta3 = (float(jm.x0), float(jm.y0), float(jm.z0), float(jm.inv_hx),
             float(jm.inv_hy), float(jm.inv_hz), jm.nx, jm.ny, jm.nz, 5, 5, 5)
    nag = jfused3d._tile_nag3(T, jnp.float32(0), jnp.float32(0),
                              jnp.float32(0), meta3)
    j = [np.asarray(v) for v in nag(*(jnp.asarray(p) for p in pts))]
    t = [H.to_np(v) for v in tile_nag3_plain(grid3_tables(H.port_medium(jm)))(
        *(torch.as_tensor(p) for p in pts))]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_tile_nag3_plain_matches_the_scan_tier_evaluator():
    """The kernel's row read and the scan tier's corner gather blend the
    same 64 values in the same order: equal to the bit at float32."""
    F, x, y, z = _bump()
    tm = tg3.c1_medium3_from_samples(F, x, y, z, **CPU)
    q = torch.as_tensor(np.random.default_rng(5).uniform(
        -1.8, 1.8, (3, 4096)).astype(np.float32))
    n_a, g_a = tm.n_and_grad3(*q)
    n_b, *g_b = tile_nag3_plain(grid3_tables(tm))(*q)
    assert torch.equal(n_a, n_b)
    for a, b in zip(g_a, g_b):
        assert torch.equal(a, b)


# -- the JAX package's grid3 tests (tests/test_grid3.py), on the port --------

def test_tricubic_polynomial_reproduction_exact():
    x, y, z, (Zg, Yg, Xg) = _grid()

    def f(X, Y, Z):
        return ((2.0 + 0.3 * X - 0.1 * X ** 3) * (1.0 + 0.2 * Y * Y)
                + 0.5 * Z + 0.07 * Z ** 3 - 0.11 * X * Y * Z)

    def grad_f(X, Y, Z):
        return ((0.3 - 0.3 * X * X) * (1.0 + 0.2 * Y * Y) - 0.11 * Y * Z,
                (2.0 + 0.3 * X - 0.1 * X ** 3) * 0.4 * Y - 0.11 * X * Z,
                0.5 + 0.21 * Z * Z - 0.11 * X * Y)

    med = tg3.c1_medium3_from_samples(f(Xg, Yg, Zg), x, y, z, dtype=F64,
                                      **CPU)
    q = np.random.default_rng(7).uniform(-1.45, 1.45, size=(200, 3))
    qt = torch.as_tensor(q)
    n, g = med.n_and_grad3(qt[:, 0], qt[:, 1], qt[:, 2])
    np.testing.assert_allclose(H.to_np(n), f(q[:, 0], q[:, 1], q[:, 2]),
                               rtol=0, atol=1e-11)
    for a, b in zip(g, grad_f(q[:, 0], q[:, 1], q[:, 2])):
        np.testing.assert_allclose(H.to_np(a), b, rtol=0, atol=1e-10)


def test_gradient_is_exact_derivative_of_n():
    """grad n is the analytic gradient of the n the integrator sees:
    against torch.func.jvp of n3 on a non-separable sampled field."""
    F, x, y, z = _bump()
    med = tg3.c1_medium3_from_samples(F, x, y, z, dtype=F64, **CPU)
    q = torch.as_tensor(np.random.default_rng(7).uniform(-1.4, 1.4, (64, 3)))
    qx, qy, qz = (q[:, k].contiguous() for k in range(3))
    _, g = med.n_and_grad3(qx, qy, qz)
    ones, zeros = torch.ones_like(qx), torch.zeros_like(qx)
    for gk, tang in zip(g, ((ones, zeros, zeros), (zeros, ones, zeros),
                            (zeros, zeros, ones))):
        _, jv = torch.func.jvp(med.n3, (qx, qy, qz), tang)
        np.testing.assert_allclose(H.to_np(gk), H.to_np(jv), rtol=0,
                                   atol=1e-11)


def test_mixed_tangent_order_commutes():
    F = np.random.default_rng(7).standard_normal((7, 8, 9))
    a = tg3._axis_tangents(tg3._axis_tangents(F, 2), 1)
    b = tg3._axis_tangents(tg3._axis_tangents(F, 1), 2)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_stratified_profile_agrees_with_1d_c1_family():
    """A y-only profile sampled as a 3-D grid reproduces the port's 1-D C1
    profile medium."""
    y = np.linspace(-2.0, 0.0, 17)
    prof = 1.5 - 0.3 * np.tanh(3.0 * (y + 1.0))
    x = np.linspace(-1.0, 1.0, 5)
    z = np.linspace(-1.0, 1.0, 6)
    F = np.broadcast_to(prof[None, :, None], (6, 17, 5))
    med3 = tg3.c1_medium3_from_samples(F, x, y, z, dtype=F64, **CPU)
    med1 = rtt.c1_stratified_from_samples(prof, y, dtype=F64, **CPU)
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.uniform(-0.9, 0.9, size=(50,)))
    qy = torch.as_tensor(rng.uniform(-1.9, -0.1, size=(50,)))
    n3, (gx3, gy3, gz3) = med3.n_and_grad3(q, qy, -q)
    n1, (_, gy1) = med1.n_and_grad(q, qy)
    np.testing.assert_allclose(H.to_np(n3), H.to_np(n1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(H.to_np(gy3), H.to_np(gy1), rtol=0,
                               atol=1e-11)
    assert float(gx3.abs().max()) < 1e-12
    assert float(gz3.abs().max()) < 1e-12


def test_clamping_matches_edge_queries():
    x, y, z, (Zg, Yg, Xg) = _grid(6, 7, 8, span=1.0)
    F = 1.0 + 0.1 * Xg + 0.2 * Yg * Yg + 0.05 * Zg
    med = tg3.c1_medium3_from_samples(F, x, y, z, **CPU)

    def at(*p):
        return med.n_and_grad3(*(torch.tensor([v], dtype=torch.float32)
                                 for v in p))

    n_out, g_out = at(5.0, -9.0, 2.0)
    n_edge, g_edge = at(1.0, -1.0, 1.0)
    assert torch.allclose(n_out, n_edge)
    for a, b in zip(g_out, g_edge):
        assert torch.allclose(a, b)


def test_validation_rejects_bad_grids():
    x = np.linspace(0, 1, 5)
    with pytest.raises(ValueError, match="shape"):
        tg3.c1_medium3_from_samples(np.zeros((4, 4, 4)), x, x, x, **CPU)
    with pytest.raises(ValueError, match="4x4x4"):
        tg3.c1_medium3_from_samples(np.zeros((3, 5, 5)), x, x,
                                    np.linspace(0, 1, 3), **CPU)
    with pytest.raises(ValueError, match="ascending"):
        tg3.c1_medium3_from_samples(np.zeros((5, 5, 5)), x, x, x[::-1],
                                    **CPU)
    F, *_ = tg3.check_uniform_grid3(np.zeros((5, 5, 5)), x, x, x)
    assert F.dtype == np.float64


def test_medium_moves_between_devices_as_a_whole():
    F, x, y, z = _bump()
    med = tg3.c1_medium3_from_samples(F, x, y, z, **CPU)
    moved = med.to("cpu")
    assert isinstance(moved, tg3.C1Grid3Medium) and moved.nx == med.nx
    assert torch.equal(moved.nodes, med.nodes)


def test_sampled_fisheye_bouguer_and_closure():
    """Trace through the sampled 3-D fisheye (33^3 nodes, float64) and hold
    JAX's oracles: Bouguer drift < 3e-5, within 2e-4 of the analytic
    medium's trajectory."""
    x = np.linspace(-1.7, 1.7, 33)
    Zg, Yg, Xg = np.meshgrid(x, x, x, indexing="ij")
    F = 1.0 / (1.0 + Xg ** 2 + Yg ** 2 + Zg ** 2)
    med = tg3.c1_medium3_from_samples(F, x, x, x, dtype=F64, **CPU)
    r = 24
    t = np.linspace(0.0, 2 * np.pi, r, endpoint=False)
    pos0 = np.zeros((r, 3))
    pos0[:, 0] = 0.7
    dir0 = np.stack([np.zeros(r), np.cos(t), np.sin(t)], -1)
    kw = dict(pos0=pos0, dir0=dir0, delta_s=2 * np.pi / 600, steps=600,
              dtype=F64, **CPU)
    out = trace3d("op6", med, **kw)
    ref = trace3d("op6", analytic_medium3("fisheye"), **kw)
    b = bouguer_invariant(out)
    assert np.abs(b - b[0]).max() / np.abs(b[0]).max() < 3e-5
    dev = np.abs(H.to_np(out.history)[..., :3]
                 - H.to_np(ref.history)[..., :3]).max()
    assert dev < 2e-4
