"""The 3-D dynamic kernel on sampled tri-Hermite media (dynamic3d_step_grid's
plain version, engine/tiled3.py::grid3_trace_dynamic_tiled) against the JAX
package: the patch Hessian (media/grid3.py::blend3_h) against autodiff and
against JAX's _tile_nag3_h; the plain version against JAX's tiled-window
dynamic kernel in interpret mode on a 12^3-node fisheye, 128 rays x 64
steps (PR 7's size for the kinematic grid kernel); fast_dynamic3's grid
route, its small-grid route and the dispersed batch, which the port keeps
on the kernel where JAX falls back to its scan tier."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

from raytracing_tpu.engine import dynamic3d as jd  # noqa: E402
from raytracing_tpu.engine import fast as jfast  # noqa: E402
from raytracing_tpu.engine import tiled3 as jt3  # noqa: E402
from raytracing_tpu.kernels import dynamic3d as jk3  # noqa: E402
from raytracing_tpu.kernels.fused3d import LANES  # noqa: E402
from raytracing_tpu.media import grid3 as jg3  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine.tiled3 import (  # noqa: E402
    grid3_tables, grid3_trace_dynamic_tiled)
from raytracing_tpu_torch.kernels import dynamic3d as tk3  # noqa: E402
from raytracing_tpu_torch.kernels import fused3d as tf3  # noqa: E402

BOX = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
CPU = dict(device="cpu")


def _fisheye(n, dtype=np.float32):
    ax = np.linspace(-1.6, 1.6, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    jm = jg3.c1_medium3_from_samples(1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2),
                                     ax, ax, ax, dtype=dtype)
    return jm, H.port_medium(jm)


def _fan(r, spread=0.05):
    """tests/test_dynamic_tiled3.py's fan."""
    th = np.pi / 2 + np.linspace(-spread, spread, r)
    return (np.tile(np.array([1.0, 0.0, 0.0], np.float32), (r, 1)),
            np.stack([np.cos(th), np.sin(th), np.full(r, 0.02)],
                     -1).astype(np.float32))


def test_patch_hessian_matches_autodiff_and_jax():
    """blend3_h (the scan tier's gather, float64) against torch.func.jacfwd
    of the port's n_and_grad3 and against JAX's window evaluator
    _tile_nag3_h at JAX's bars (rtol 1e-8, atol 1e-10,
    tests/test_dynamic_tiled3.py:53-102); the kernel's float32 row
    evaluator tile_nag3_h_plain on the same points within float32's
    rounding, its n and gradient equal to the kinematic tile_nag3_plain's
    to the bit."""
    jm, tm = _fisheye(33, np.float64)
    rng = np.random.default_rng(0)
    base = (3, 4, 5)
    pts = rng.uniform(0.0, 5.0, (3, 2, LANES))
    x, y, z = ((jm.x0, jm.y0, jm.z0)[k] + (base[k] + pts[k])
               / (jm.inv_hx, jm.inv_hy, jm.inv_hz)[k] for k in range(3))
    nodes4d = jnp.asarray(jm.nodes).reshape(jm.nz, jm.ny, jm.nx, 8)
    wid = jt3._window_ids3(np.array([base[0]]), np.array([base[1]]),
                           np.array([base[2]]), 5, 5, 5, LANES, jm.nx - 1,
                           jm.ny - 1)
    cells = np.asarray(jt3._cells64(nodes4d))[np.asarray(wid)[0]]
    T = [jnp.broadcast_to(jnp.asarray(cells[:, i])[None, :], (2, LANES))
         for i in range(64)]
    meta3 = (float(jm.x0), float(jm.y0), float(jm.z0), float(jm.inv_hx),
             float(jm.inv_hy), float(jm.inv_hz), jm.nx, jm.ny, jm.nz, 5, 5, 5)
    jout = jk3._tile_nag3_h(T, jnp.float64(base[0]), jnp.float64(base[1]),
                            jnp.float64(base[2]), meta3)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    q = [torch.as_tensor(v.ravel()) for v in (x, y, z)]
    n, g, h = tm.n_grad_hess3(*q)
    got = (n,) + tuple(g) + tuple(h)
    for a, b in zip(got, jout):
        np.testing.assert_allclose(H.to_np(a), np.asarray(b).ravel(),
                                   rtol=1e-8, atol=1e-10)

    def grad(x, y, z):
        return torch.stack(tm.n_and_grad3(x, y, z)[1])

    # the gradient is elementwise: its jvp along a unit axis is the Hessian's
    # column there, every query at once
    one, zero = torch.ones_like(q[0]), torch.zeros_like(q[0])
    J = torch.stack([torch.func.jvp(grad, tuple(q), tuple(
        one if k == c else zero for k in range(3)))[1] for c in range(3)], -1)
    for a, (i, k) in zip(h, ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
        np.testing.assert_allclose(H.to_np(a), H.to_np(J[i, :, k]),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(H.to_np(J[i, :, k]), H.to_np(J[k, :, i]),
                                   rtol=1e-8, atol=1e-10)
    n_m, g_m = tm.n_and_grad3(*q)
    assert torch.equal(n, n_m) and all(torch.equal(a, b)
                                       for a, b in zip(g, g_m))

    # float32: the kernel's row evaluator against JAX's window evaluator on
    # the same float32 table at JAX's float32 Hessian bar (rtol 2e-5, with
    # an absolute floor at 2e-5 of each component's largest value)
    j32, t32 = _fisheye(33)
    c32 = np.asarray(jt3._cells64(jnp.asarray(j32.nodes).reshape(
        j32.nz, j32.ny, j32.nx, 8)))[np.asarray(wid)[0]]
    T32 = [jnp.broadcast_to(jnp.asarray(c32[:, i])[None, :], (2, LANES))
           for i in range(64)]
    q32 = [v.float() for v in q]
    jout32 = jk3._tile_nag3_h(T32, jnp.float32(base[0]), jnp.float32(base[1]),
                              jnp.float32(base[2]), meta3)(
        *(jnp.asarray(H.to_np(v)).reshape(2, LANES) for v in q32))
    tab = grid3_tables(t32)
    h32 = tk3.tile_nag3_h_plain(tab)(*q32)
    for a, b in zip(h32, jout32):
        b = np.asarray(b).ravel()
        np.testing.assert_allclose(H.to_np(a), b, rtol=2e-5,
                                   atol=2e-5 * np.abs(b).max())
    for a, b in zip(h32[:4], tf3.tile_nag3_plain(tab)(*q32)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def fisheye12():
    return _fisheye(12)


@pytest.mark.parametrize("op", tk3.DYN3_FUSED_OPS)
def test_grid_plain_matches_pallas_tiled_interpret(op, fisheye12):
    """JAX's tiled dynamic kernel (windows, sort, replay) against the port's
    one launch on the same table: bars set before measuring as the analytic
    kernel's (pos and tangent 5e-6, traveltime 5e-5, det Q rtol 5e-5 / atol
    1e-8, KMAH equal, the locator within 2 steps); measured pos <= 3.6e-7,
    tangent <= 4.2e-7, det Q within 1.5e-6 relative."""
    jm, tm = fisheye12
    r = 128
    pos0, dirs = _fan(r)
    ds = np.float32(2 * np.pi / 600)
    j = jt3.grid3_trace_dynamic_tiled(op, pos0, dirs, ds, jm, steps=64,
                                      box=BOX, block_rays=r, interpret=True)
    t = grid3_trace_dynamic_tiled(op, pos0, dirs, ds, tm, steps=64, box=BOX,
                                  **CPU)
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=5e-6,
                               rtol=0)
    np.testing.assert_allclose(H.to_np(t.tangent), np.asarray(j.tangent),
                               atol=5e-6, rtol=0)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), atol=5e-5, rtol=0)
    np.testing.assert_allclose(H.to_np(t.detq), np.asarray(j.detq),
                               rtol=5e-5, atol=1e-8)
    np.testing.assert_array_equal(H.to_np(t.kmah), np.asarray(j.kmah))
    np.testing.assert_allclose(H.to_np(t.min_absdet_step),
                               np.asarray(j.min_absdet_step), atol=2)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))
    np.testing.assert_allclose(H.to_np(t.n), np.asarray(j.n), atol=5e-6)


def test_fast_dynamic3_grid_routes_match_jax(fisheye12):
    """The grid route ("dynamic3-kernel-grid"; JAX says
    "dynamic3-kernel-tiled") on the 12^3 fisheye against JAX's, any batch
    size; a grid of 4 cells an axis to the scan tier on both."""
    jm, tm = fisheye12
    pos0, dirs = _fan(200)
    kw = dict(pos0=pos0, dir0=dirs, delta_s=2 * np.pi / 600, steps=60,
              box=BOX)
    j, jeng = jfast.fast_dynamic3("op6", jm, block_rays=256, interpret=True,
                                  **kw)
    t, teng = rtt.fast_dynamic3("op6", tm, **kw, **CPU)
    assert (jeng, teng) == ("dynamic3-kernel-tiled", "dynamic3-kernel-grid")
    assert t.pos.shape == (200, 3)
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=5e-6)
    np.testing.assert_allclose(H.to_np(t.detq), np.asarray(j.detq),
                               rtol=5e-5, atol=1e-8)
    np.testing.assert_array_equal(H.to_np(t.kmah), np.asarray(j.kmah))
    js, ts = _fisheye(5)
    j, jeng = jfast.fast_dynamic3("op6", js, **kw)
    t, teng = rtt.fast_dynamic3("op6", ts, **kw, **CPU)
    assert jeng == teng == "dynamic3-scan"
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=5e-5)
    np.testing.assert_allclose(H.to_np(t.detq), np.asarray(j.detq),
                               rtol=5e-5, atol=1e-8)


def test_dispersed_batch_stays_on_the_kernel():
    """A dispersed batch on a 5-cell grid: JAX's window ladder rejects it
    and fast_dynamic3 falls back to its float32 scan tier, trace_dynamic3
    in metrics mode with containment as "active" (fast.py:586-595,
    tests/test_dynamic_tiled3.py:176-186; the ladder's attempts in
    interpret mode take a minute, so the test calls that fallback
    directly); the port has no window and keeps the batch on the kernel
    ("dynamic3-kernel-grid"), held to JAX's result within JAX's own
    kernel-against-scan bar, 1e-5 (positions, tangent, traveltime), det Q
    within JAX's 95th-percentile 1e-3, KMAH equal."""
    js, ts = _fisheye(6)
    rng = np.random.default_rng(7)
    pos_d = rng.uniform(-1.4, 1.4, (200, 3)).astype(np.float32)
    dir_d = rng.normal(size=(200, 3)).astype(np.float32)
    kw = dict(pos0=pos_d, dir0=dir_d, delta_s=0.01, steps=50, box=BOX)
    j = jd.trace_dynamic3("op6", js, mode="metrics", dtype=np.float32, **kw)
    p = np.asarray(j.pos)
    inside = np.all((p >= np.array(BOX[::2])) & (p <= np.array(BOX[1::2])),
                    axis=1)
    t, teng = rtt.fast_dynamic3("op6", ts, **kw, **CPU)
    assert teng == "dynamic3-kernel-grid"
    for f, jf in (("pos", j.pos), ("tangent", j.unitv),
                  ("traveltime", j.traveltime)):
        np.testing.assert_allclose(H.to_np(getattr(t, f)), np.asarray(jf),
                                   atol=1e-5, err_msg=f)
    m = np.asarray(j.detq) != 0
    rel = (np.abs(H.to_np(t.detq) - np.asarray(j.detq))[m]
           / np.abs(np.asarray(j.detq))[m])
    assert np.percentile(rel, 95) < 1e-3
    np.testing.assert_array_equal(H.to_np(t.kmah), np.asarray(j.kmah))
    np.testing.assert_array_equal(H.to_np(t.active), inside)
    assert not inside.all()


def test_grid3_trace_dynamic_tiled_errors(fisheye12):
    _, tm = fisheye12
    pos0, dirs = _fan(8)
    kw = dict(steps=2, box=BOX, **CPU)
    with pytest.raises(ValueError, match="C1Grid3Medium"):
        grid3_trace_dynamic_tiled("op6", pos0, dirs, 0.01,
                                  rtt.analytic_medium3("fisheye"), **kw)
    with pytest.raises(ValueError, match="planar"):
        grid3_trace_dynamic_tiled("op5", pos0, dirs, 0.01, tm, **kw)
    # mesh= (ROADMAP.md §1 item 18, done): a one-rank CPU mesh gives the
    # call without one, to the bit
    import torch_dist_helpers as D
    one = grid3_trace_dynamic_tiled("op6", pos0, dirs, 0.01, tm, **kw)
    with D.one_rank_mesh() as mesh:
        meshed = grid3_trace_dynamic_tiled("op6", pos0, dirs, 0.01, tm,
                                           mesh=mesh, block_rays=8, **kw)
    for f in one._fields:
        np.testing.assert_array_equal(H.to_np(getattr(meshed, f)
                                              .full_tensor()),
                                      H.to_np(getattr(one, f)), err_msg=f)
    g = grid3_tables(tm)
    st = tk3.initial_dyn3_state(pos0, dirs, **CPU)
    with pytest.raises(ValueError, match="grid3 table"):
        tk3.dynamic3d_step(st, field=g._replace(table=g.table.double()),
                           op="op6", steps=2, delta_s=0.01, step_limit=2,
                           box=BOX)


def test_the_scan_tier_on_the_grid_matches_jax_at_float32(fisheye12):
    """trace_dynamic3 at float32 on the grid against JAX's (the scan route's
    precision): JAX's kernel-against-scan bars (pos and traveltime 1e-5,
    KMAH equal)."""
    jm, tm = fisheye12
    pos0, dirs = _fan(64)
    kw = dict(pos0=pos0, dir0=dirs, delta_s=float(np.float32(2 * np.pi
                                                             / 600)),
              steps=60, box=BOX, mode="metrics")
    j = jd.trace_dynamic3("op6", jm, dtype=np.float32, **kw)
    t = rtt.trace_dynamic3("op6", tm, dtype=torch.float32, **kw, **CPU)
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=1e-5)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), atol=1e-5)
    np.testing.assert_array_equal(H.to_np(t.kmah), np.asarray(j.kmah))
    assert jax.config.jax_enable_x64
