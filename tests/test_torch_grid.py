"""The plain versions of the fused_step_grid and golden_step_grid kernels
against the JAX tiled grid kernel (``grid_trace_tiled`` in interpret mode)
on the same fisheye grids, parity and C1, at float32, 128 rays and 59
steps; the per-cell table layout; and the grid entry point's checks."""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine.segmented import (  # noqa: E402
    grid_trace_tiled as jgrid)
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402

from raytracing_tpu_torch.engine import segmented as tseg  # noqa: E402
from raytracing_tpu_torch.kernels import fused as tfused  # noqa: E402
from raytracing_tpu_torch.media import c1 as tc1  # noqa: E402
from raytracing_tpu_torch.media.medium import analytic_medium  # noqa: E402

R = 128
DIVISOR = 60
#: a coarse fisheye grid (181 x 181 nodes): the JAX tiled kernel needs at
#: least its 11 x 11-cell window, and a coarse pitch keeps the tables small
GRID_DELTA = 0.05


@pytest.fixture(scope="module")
def grids():
    box = rt.scenario("fisheye").box
    gm = jspline.build_grid_medium("fisheye", box, GRID_DELTA,
                                   dtype=np.float32, backend="scipy")
    return {"parity": jherm.build_hermite_medium(gm, dtype=np.float32),
            "c1": jc1.build_c1_medium("fisheye", box, GRID_DELTA,
                                      dtype=np.float32, backend="scipy")}


def fan():
    rng = np.random.default_rng(0)
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (R, 1))
    theta0 = (np.pi / 2 + rng.uniform(-0.02, 0.02, R)).astype(np.float32)
    return pos0, theta0


@pytest.mark.parametrize("family", ["parity", "c1"])
@pytest.mark.parametrize("op", ["op1", "op6", "op7", "op5", "op11"])
def test_grid_plain_matches_pallas(op, family, grids):
    """Fused ops within the analytic fused kernels' bars (1e-5, op7 2e-4;
    traveltime 5e-5; tests/test_torch_kernels.py).  Golden ops within the golden bar, 5e-4: the JAX tiled golden
    kernel re-derives the direction by exact cos/sin at each segment start
    (a ~1e-8-a-step cadence sensitivity, segmented.py:1193-1197), the
    port's one launch carries the tangent throughout."""
    jm = grids[family]
    pos0, theta0 = fan()
    ds = np.float32(2 * np.pi / DIVISOR)
    box = tuple(rt.scenario("fisheye").box)
    j = jgrid(op, pos0, theta0, ds, jm, steps=DIVISOR - 1, box=box,
              block_rays=R, interpret=True)
    t = tseg.grid_trace_tiled(op, pos0, theta0, ds, H.port_medium(jm),
                              steps=DIVISOR - 1, box=box, device="cpu")
    golden = op in ("op5", "op11")
    pos_tol = 5e-4 if golden else (2e-4 if op == "op7" else 1e-5)
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos),
                               atol=pos_tol)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime),
                               atol=5e-4 if golden else 5e-5)
    np.testing.assert_allclose(H.to_np(t.tangent), np.asarray(j.tangent),
                               atol=pos_tol)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))


def test_cells36_layout(grids):
    """Each cell row holds channel ch's corners (00, +x, +y, +xy) at
    ch * 4 + corner (segmented.py:449-467)."""
    tm = H.port_medium(grids["parity"])
    g = tseg.grid_tables(tm)
    nodes = tm.nodes.reshape(tm.ny, tm.nx, 9)
    assert g.cell_ch == 36 and g.table.shape == ((tm.ny - 1) * (tm.nx - 1), 36)
    iy, ix = 7, 11
    row = g.table[iy * (tm.nx - 1) + ix].reshape(9, 4)
    want = torch.stack([nodes[iy, ix], nodes[iy, ix + 1], nodes[iy + 1, ix],
                        nodes[iy + 1, ix + 1]], dim=-1)
    assert torch.equal(row, want)
    assert tseg.grid_tables(H.port_medium(grids["c1"])).cell_ch == 16


def test_any_grid_of_two_by_two_nodes_or_more():
    """No window: a 4 x 4-node user grid traces (the TPU tier needs 11 x 11
    cells), and its plain evaluator equals the medium's own at the
    launch points."""
    x = np.linspace(-2.0, 2.0, 4)
    Z = 1.0 + 0.1 * x[None, :] ** 2 + 0.05 * x[:, None]
    med = tc1.c1_medium_from_samples(Z, x, x, device="cpu")
    pos0 = np.zeros((8, 2), np.float32)
    theta0 = np.linspace(0.0, 3.0, 8).astype(np.float32)
    f = tseg.grid_trace_tiled("op6", pos0, theta0, 0.05, med, steps=30,
                              box=(-2.0, 2.0, -2.0, 2.0), device="cpu")
    assert torch.isfinite(f.pos).all()
    n, gx, gy = tfused.nag_fn(tseg.grid_tables(med))(
        torch.as_tensor(pos0[:, 0]), torch.as_tensor(pos0[:, 1]))
    mn, (mgx, mgy) = med.n_and_grad(torch.as_tensor(pos0[:, 0]),
                                    torch.as_tensor(pos0[:, 1]))
    for a, b in ((n, mn), (gx, mgx), (gy, mgy)):
        np.testing.assert_allclose(H.to_np(a), H.to_np(b), atol=1e-6)


def test_grid_trace_refuses_what_it_cannot_trace(grids):
    tm = H.port_medium(grids["parity"])
    pos0, theta0 = fan()
    kw = dict(steps=3, box=(-1.5, 1.5, -1.5, 1.5), device="cpu")
    with pytest.raises(ValueError, match="HermiteGridMedium"):
        tseg.grid_trace_tiled("op1", pos0, theta0, 0.1,
                              analytic_medium("fisheye"), **kw)
    with pytest.raises(ValueError, match="supports"):
        tseg.grid_trace_tiled("op99", pos0, theta0, 0.1, tm, **kw)
