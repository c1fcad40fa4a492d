"""The differentiable tier (raytracing_tpu_torch/engine/diff.py) against
the JAX package's engine/diff.py at float64, with the bars of
tests/test_diff.py: forward parity with the scan engine, gradients against
finite differences and against ``jax.grad``, the adjoint's sparsity,
rematerialization, launch and step gradients, the anisotropy gradient
through the Newton and golden ops, and the inverse problem."""
import functools
import math

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from raytracing_tpu.engine import diff as jdiff  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine.diff import (  # noqa: E402
    DiffTrace, ParametricMedium, parametric_grid_medium,
    parametric_profile_medium, trace_diff)

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _curv_fn(p, x, y):
    """n = 1 / (1 + p (x^2 + y^2)); p = 1 is the reference fisheye
    (RT_bench.py:110-112)."""
    return 1.0 / (1.0 + p * (x * x + y * y))


def _fisheye_pm(curv=1.0):
    return ParametricMedium(_curv_fn, torch.tensor(curv, dtype=F64))


def test_forward_matches_scan_engine():
    """The same op matrix: trace_diff's op1 fisheye circle equals the scan
    engine's to 1e-12, and unpacks like a 4-tuple."""
    scen = rtt.scenario("fisheye")
    div = 400
    ds = 2 * np.pi / div
    res = rtt.trace("op1", scen, rtt.analytic_medium("fisheye"), delta_s=ds,
                    divisor=div + 1, n_turns=1, dtype=F64, mode="metrics",
                    device="cpu")
    d = trace_diff("op1", _fisheye_pm(), _t(np.tile([[1.0, 0.0]], (8, 1))),
                   _t(np.full(8, np.pi / 2)), ds, steps=div,
                   box=tuple(scen.box), device="cpu")
    assert isinstance(d, DiffTrace)
    pos, ang, tt, act = d
    np.testing.assert_allclose(pos.detach().numpy(),
                               np.tile(res.final.pos.numpy()[:1], (8, 1)),
                               atol=1e-12)


@pytest.mark.parametrize("op", ["op2", "op3", "op4", "op5", "op7", "op8",
                                "op9"])
def test_forward_parity_iso_ops(op):
    """Every other isotropic op traces as the scan engine (atol 1e-12 on a
    third of a turn; op7's order ramp keys on the 1-based step index)."""
    scen = rtt.scenario("fisheye")
    div = 300
    ds = 2 * np.pi / div
    res = rtt.trace(op, scen, rtt.analytic_medium("fisheye"), delta_s=ds,
                    divisor=div + 1, n_turns=1, dtype=F64, mode="metrics",
                    device="cpu", max_size=101)
    d = trace_diff(op, _fisheye_pm(), _t([[1.0, 0.0]] * 2),
                   _t([np.pi / 2] * 2), ds, steps=100, box=tuple(scen.box),
                   device="cpu")
    np.testing.assert_allclose(d.pos.detach().numpy()[0],
                               res.final.pos.numpy()[0], atol=1e-12)


@pytest.mark.parametrize("op", ["op1", "op6", "op12"])
def test_grad_matches_finite_difference_and_jax(op):
    """d(closure miss)/d(lens curvature): central differences at rtol 5e-5
    (test_diff.py:56-74), and JAX's ``jax.grad`` at rtol 1e-9."""
    div = 200
    ds = 2 * np.pi / div
    pos0 = np.tile([[1.0, 0.0]], (4, 1))
    th0 = np.full(4, np.pi / 2)

    def miss(curv):
        pos, *_ = trace_diff(op, ParametricMedium(_curv_fn, curv),
                             _t(pos0), _t(th0), ds, steps=div, device="cpu")
        return torch.mean(torch.sum((pos - _t([1.0, 0.0])) ** 2, dim=-1))

    curv = torch.tensor(1.1, dtype=F64, requires_grad=True)
    g, = torch.autograd.grad(miss(curv), curv)
    h = 1e-6
    with torch.no_grad():
        fd = (miss(torch.tensor(1.1 + h, dtype=F64))
              - miss(torch.tensor(1.1 - h, dtype=F64))) / (2 * h)
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-5)

    def jmiss(c):
        pos, *_ = jdiff.trace_diff(op, jdiff.ParametricMedium(_curv_fn_j, c),
                                   jnp.asarray(pos0), jnp.asarray(th0),
                                   jnp.float64(ds), steps=div)
        return jnp.mean(jnp.sum((pos - jnp.asarray([1.0, 0.0])) ** 2, -1))
    np.testing.assert_allclose(float(g), float(jax.grad(jmiss)(
        jnp.float64(1.1))), rtol=1e-9)


def _curv_fn_j(p, x, y):
    return 1.0 / (1.0 + p * (x * x + y * y))


NG = 12


def _tomography_case(m):
    """Fans from two sides of the [-1, 1] box (tests/test_diff.py:190-204),
    ``m`` rays a side, and a seeded 12 x 12 grid around 1."""
    t = np.linspace(-0.9, 0.9, m)
    sp = np.linspace(-0.7, 0.7, m)
    pos0 = np.concatenate([np.stack([np.full(m, -1.0), t], 1),
                           np.stack([t, np.full(m, -1.0)], 1)])
    th0 = np.concatenate([sp, np.pi / 2 + sp])
    vals = 1.0 + 0.1 * np.random.default_rng(0).standard_normal((NG, NG))
    return pos0, th0, vals


@functools.lru_cache(maxsize=1)
def _jax_grid_gradient():
    """``jax.grad`` of the tomography loss at the seeded grid, once."""
    pos0, th0, vals = _tomography_case(8)
    h = 2.0 / (NG - 1)

    def jloss(grid):
        med = jdiff.parametric_grid_medium(grid, -1.0, -1.0, h, h)
        p, _, t, _ = jdiff.trace_diff("op6", med, jnp.asarray(pos0),
                                      jnp.asarray(th0), jnp.float64(0.015),
                                      steps=120, box=(-1.0, 1.0, -1.0, 1.0))
        return jnp.mean(t ** 2) + jnp.mean(jnp.sum(p ** 2, -1))
    return np.asarray(jax.grad(jloss)(jnp.asarray(vals)))


@pytest.mark.parametrize("remat", [1, 4])
def test_grid_gradient_matches_jax_grad(remat):
    """The 144-node tomography adjoint equals ``jax.grad``'s at rtol 1e-9
    (relative to its largest entry), nonzero on the same nodes, with and
    without rematerialization."""
    pos0, th0, vals = _tomography_case(8)
    h = 2.0 / (NG - 1)
    box = (-1.0, 1.0, -1.0, 1.0)
    v = torch.tensor(vals, requires_grad=True)
    pos, _, tt, _ = trace_diff(
        "op6", parametric_grid_medium(v, -1.0, -1.0, h, h, device="cpu"),
        _t(pos0), _t(th0), 0.015, steps=120, box=box, remat_segments=remat,
        device="cpu")
    g, = torch.autograd.grad((tt ** 2).mean() + (pos ** 2).sum(-1).mean(), v)

    gj = _jax_grid_gradient()
    np.testing.assert_array_equal(g.numpy() != 0, gj != 0)
    assert np.abs(g.numpy() - gj).max() <= 1e-9 * np.abs(gj).max()


def test_interop_builds_the_parametric_media():
    """``medium_from_numpy`` makes the port's parametric grid and profile
    from the arrays the JAX builders take."""
    from raytracing_tpu_torch.interop import medium_from_numpy
    vals = np.linspace(1.0, 2.0, 9)
    prof = medium_from_numpy("parametric_profile_medium",
                             dict(values=vals, y0=-1.0, hy=0.25),
                             device="cpu")
    y = np.array([-1.0, -0.3, 0.1, 1.0])
    want = jdiff.parametric_profile_medium(vals, -1.0, 0.25).n(
        jnp.zeros(4), jnp.asarray(y))
    np.testing.assert_array_equal(prof.n(_t(np.zeros(4)), _t(y)).detach()
                                  .numpy(), np.asarray(want))
    grid = medium_from_numpy(
        "parametric_grid_medium",
        dict(values=np.outer(vals, vals), x0=-1.0, y0=-1.0, hx=0.25,
             hy=0.25), device="cpu")
    assert isinstance(grid, ParametricMedium)
    assert [p.shape for p in grid.parameters()] == [(9, 9)]


def test_parametric_grid_medium_adjoint_sparsity():
    """A straight ray's travel-time gradient touches only the node rows
    bracketing its path (test_diff.py:279-299)."""
    h = 2.0 / 7
    v = torch.ones((8, 8), dtype=F64, requires_grad=True)
    *_, tt, _ = trace_diff("op6", parametric_grid_medium(
        v, -1.0, -1.0, h, h, device="cpu"), _t([[-1.0, 0.0]] * 2),
        _t([0.0, 0.0]), 0.02, steps=60, device="cpu")
    g, = torch.autograd.grad(tt.sum(), v)
    rows = set(np.unique(np.nonzero(g.numpy())[0]))
    assert rows <= {3, 4} and (g != 0).sum() > 0


def test_parametric_profile_medium_adjoint_and_fd():
    """The profile's gradient lives on samples 4 and 5 only and matches
    central differences at rel 1e-5 (test_diff.py:363-392); the same as
    JAX's at rtol 1e-9."""
    vals = np.full(9, 1.2)

    def loss(v):
        m = parametric_profile_medium(v, -1.0, 0.25, device="cpu")
        *_, tt, _ = trace_diff("op6", m, _t([[-0.5, 0.1]] * 2), _t([0, 0]),
                               0.02, steps=50, device="cpu")
        return tt.sum()

    v = torch.tensor(vals, requires_grad=True)
    g, = torch.autograd.grad(loss(v), v)
    g = g.numpy()
    assert set(np.nonzero(g)[0]) == {4, 5}
    eps = 1e-6
    for k in (4, 5):
        e = np.zeros(9)
        e[k] = eps
        with torch.no_grad():
            fd = (float(loss(_t(vals + e))) - float(loss(_t(vals - e)))) \
                / (2 * eps)
        assert fd == pytest.approx(float(g[k]), rel=1e-5)

    def jloss(vv):
        m = jdiff.parametric_profile_medium(vv, -1.0, 0.25)
        *_, tt, _ = jdiff.trace_diff("op6", m, jnp.asarray([[-0.5, 0.1]] * 2),
                                     jnp.zeros(2), jnp.float64(0.02),
                                     steps=50)
        return tt.sum()
    np.testing.assert_allclose(g, np.asarray(jax.grad(jloss)(
        jnp.asarray(vals))), rtol=1e-9, atol=0)


def test_remat_segments_identical():
    """Rematerialization changes neither the value nor the gradient, and a
    step count that does not divide raises (test_diff.py:302-320)."""
    def miss(k):
        curv = torch.tensor(1.1, dtype=F64, requires_grad=True)
        pos, *_ = trace_diff("op6", ParametricMedium(_curv_fn, curv),
                             _t([[1.0, 0.0]] * 2), _t([np.pi / 2] * 2),
                             0.02, steps=120, remat_segments=k,
                             device="cpu")
        v = torch.sum(pos ** 2)
        return float(v), float(torch.autograd.grad(v, curv)[0])

    (v1, g1), (v4, g4) = miss(1), miss(4)
    assert v1 == v4
    np.testing.assert_allclose(g1, g4, rtol=1e-13)
    with pytest.raises(ValueError, match="divide"):
        miss(7)


def test_grad_wrt_launch_and_step():
    """The launch angle and the step size are differentiable inputs: both
    gradients finite and nonzero (test_diff.py:113-127)."""
    th = torch.tensor(0.0, dtype=F64, requires_grad=True)
    ds = torch.tensor(0.01, dtype=F64, requires_grad=True)
    pos, *_ = trace_diff("op1", _fisheye_pm(), _t([[1.0, 0.0]] * 2),
                         _t([np.pi / 2] * 2) + th, ds, steps=50,
                         device="cpu")
    g_th, g_ds = torch.autograd.grad(pos[:, 0].sum(), (th, ds))
    for g in (g_th, g_ds):
        assert math.isfinite(float(g)) and abs(float(g)) > 0


def _vert_fn(p, x, y):
    return 1.0 / (18.0 + 2.0 * y) + 0.0 * x + 0.0 * p


@pytest.mark.parametrize("op", ["op10n", "op11n", "op10", "op11"])
def test_gamma_gradient_newton_and_golden(op):
    """The anisotropy gamma through the Newton ops (nested forward mode in
    ``ops/newton.py``, reverse mode over it) equals JAX's derivative at
    rtol 1e-9; through the golden ops it is exactly 0.0, as JAX's
    ``jax.grad`` (test_diff.py:130-158).  4 rays x 30 steps of 0.01 from
    (0, -1).  For the Newton ops JAX's derivative is taken by ``jax.jvp``
    (a scalar's gradient; ``jax.grad`` gives the same to ~1e-11 but takes
    over a minute to compile the nested forward modes' transpose)."""
    pos0 = np.array([[0.0, -1.0]] * 4)
    th0 = np.full(4, np.pi / 4)
    gam = torch.tensor(3.0, dtype=F64, requires_grad=True)
    pos, *_ = trace_diff(op, ParametricMedium(_vert_fn,
                                              torch.tensor(1.0, dtype=F64)),
                         _t(pos0), _t(th0), 0.01, steps=30, gamma=gam,
                         device="cpu")
    g, = torch.autograd.grad(pos.sum(), gam, allow_unused=True)
    g = 0.0 if g is None else float(g)

    def jend(v):
        p, *_ = jdiff.trace_diff(op, jdiff.ParametricMedium(
            _vert_fn, jnp.float64(1.0)), jnp.asarray(pos0),
            jnp.asarray(th0), jnp.float64(0.01), steps=30, gamma=v)
        return p.sum()
    if op in ("op10", "op11"):
        gj = float(jax.grad(jend)(jnp.float64(3.0)))
    else:
        gj = float(jax.jvp(jend, (jnp.float64(3.0),), (jnp.float64(1.0),))[1])
    if op in ("op10", "op11"):
        assert g == 0.0 and gj == 0.0
    else:
        assert abs(gj) > 1e-6
        np.testing.assert_allclose(g, gj, rtol=1e-9)


def test_inverse_problem_recovers_interface_thickness():
    """Recover the sigmoid interface's thickness from exit positions with
    ``torch.optim.Adam`` on the medium's parameters (the example twin,
    examples/inverse_medium_torch.py): JAX's bars, |thck - 0.12| < 1e-4
    and loss < 1e-7 after 150 steps (test_diff.py:77-110)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "inverse_medium_torch.py"
    spec = importlib.util.spec_from_file_location("inverse_medium_torch",
                                                  path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    thck, loss = ex.fit("cpu")
    assert abs(thck - ex.TRUE_THCK) < 1e-4, thck
    assert loss < 1e-7


def test_entry_points_default_to_the_card():
    """trace_diff and the parametric builders put their tensors on CUDA by
    default: without a card they raise, never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        parametric_grid_medium(np.ones((4, 4)), 0.0, 0.0, 1.0, 1.0)
    with pytest.raises((RuntimeError, AssertionError)):
        trace_diff("op1", rtt.analytic_medium("fisheye"), [[1.0, 0.0]],
                   [1.0], 0.1, steps=2)
    assert H.to_np(torch.zeros(1)).shape == (1,)
