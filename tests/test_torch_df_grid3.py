"""The 3-D df32 tier (raytracing_tpu_torch/engine/df_grid3.py) against the
float64 interpolant and against the JAX package's engine/df_grid3.py, on
tests/test_df_grid3.py's samples (a 17^3 or 21^3 fisheye)."""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from raytracing_tpu.engine import df_grid3 as J  # noqa: E402
from raytracing_tpu.engine.dynamic3d import (  # noqa: E402
    trace_dynamic3 as j_trace_dynamic3)

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import df_grid3 as T  # noqa: E402
from raytracing_tpu_torch.engine import dynamic3d as tdyn3  # noqa: E402
from raytracing_tpu_torch.media.grid3 import (  # noqa: E402
    check_uniform_grid3, nodes3_f64)

#: the float32 unit in the last place at 1
EPS32 = float(np.finfo(np.float32).eps)


def _samples(n=17, lim=1.6):
    """tests/test_df_grid3.py:19-24: the fisheye on an n^3 grid,
    F[iz, iy, ix]."""
    ax = np.linspace(-lim, lim, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    F = 1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2)
    return np.transpose(F, (2, 1, 0)), ax


def _points(seed, lim=1.45, m=400):
    """float32 query points (test_df_grid3.py:27-30), reaching past the
    grid's edges only with ``lim`` beyond 1.6."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-lim, lim, m).astype(np.float32)
                 for _ in range(3))


@pytest.fixture(scope="module")
def media17():
    F, ax = _samples()
    return (F, ax, T.df_c1_medium3_from_samples(F, ax, ax, ax, device="cpu"),
            J.df_c1_medium3_from_samples(F, ax, ax, ax))


def _comb(h, lo):
    return h.double() + lo.double()


def test_split_fidelity_and_words_match_jax(media17):
    """hi + lo reconstructs the float64 node table (< 2e-14), and the words
    and split scalars are JAX's to the bit."""
    F, ax, tm, jm = media17
    nodes = nodes3_f64(check_uniform_grid3(F, ax, ax, ax)[0]).reshape(-1, 8)
    assert np.abs(_comb(tm.Nh, tm.Nl).numpy() - nodes).max() < 2e-14
    np.testing.assert_array_equal(tm.Nh.numpy(), np.asarray(jm.Nh))
    np.testing.assert_array_equal(tm.Nl.numpy(), np.asarray(jm.Nl))
    port = H.port_medium(jm)
    assert isinstance(port, T.DfC1Medium3)
    for name in ("x0h", "x0l", "ihzh", "ihzl", "nx", "nz"):
        assert getattr(port, name) == getattr(tm, name) == getattr(jm, name)


def test_df_eval_matches_f64_interpolant(media17):
    """The df contraction is the float64 tricubic: n < 2e-12, the gradient
    < 2e-11 (the SAME float32 query points feed both sides)."""
    F, ax, tm, _ = media17
    xs, ys, zs = (torch.tensor(v) for v in _points(7))
    zero = torch.zeros_like(xs)
    out = tm.nag()(xs, zero, ys, zero, zs, zero)
    m64 = rtt.c1_medium3_from_samples(F, ax, ax, ax, device="cpu",
                                      dtype=torch.float64)
    n64, g64 = m64.n_and_grad3(xs.double(), ys.double(), zs.double())
    assert (_comb(*out[0]) - n64).abs().max() < 2e-12
    for got, want in zip(out[1:], g64):
        assert (_comb(*got) - want).abs().max() < 2e-11


@pytest.mark.parametrize("lim", [1.45, 1.75])
def test_df_words_bit_equal_jax_eager(media17, lim):
    """Every hi and lo word equals JAX's ``_make_df_nag3`` run op for op
    (``jax.disable_jit()``), inside the grid and past its clamped edges."""
    _, _, tm, jm = media17
    pts = _points(11, lim=lim)
    zero = np.zeros_like(pts[0])
    ours = tm.nag()(*(torch.tensor(a) for p in pts for a in (p, zero)))
    with jax.disable_jit():
        theirs = J._make_df_nag3(jm)(*(jnp.asarray(a) for p in pts
                                       for a in (p, zero)))
    for o, t in zip(ours, theirs):
        for w in (0, 1):
            np.testing.assert_array_equal(o[w].numpy(), np.asarray(t[w]))


def test_hess3_matches_jax(media17):
    """The closed-form float32 Hessian within 4 float32 ulps of each
    component's magnitude of JAX's ``_hess3`` (run op for op)."""
    _, _, tm, jm = media17
    pts = _points(13)
    ours = T._hess3(tm, *(torch.tensor(p) for p in pts))
    with jax.disable_jit():
        theirs = J._hess3(jm, *(jnp.asarray(p) for p in pts))
    for o, t in zip(ours, theirs):
        t = np.asarray(t, np.float64)
        tol = 4 * EPS32 * np.abs(t).max()
        assert np.abs(o.numpy().astype(np.float64) - t).max() <= tol


def test_facade_correctly_rounded(media17):
    """n and grad n within 1.2e-7 of the float64 interpolant, and n
    strictly closer than the float32 C1Grid3Medium's on the same points."""
    F, ax, tm, _ = media17
    m = T.DfEvalMedium3(med=tm)
    xs, ys, zs = (torch.tensor(v) for v in _points(11))
    n32, g32 = m.n_and_grad3(xs, ys, zs)
    assert n32.dtype == torch.float32 and m.dtype == torch.float32
    m64 = rtt.c1_medium3_from_samples(F, ax, ax, ax, device="cpu",
                                      dtype=torch.float64)
    n64, g64 = m64.n_and_grad3(xs.double(), ys.double(), zs.double())
    err_df = float((n32.double() - n64).abs().max())
    assert err_df < 1.2e-7
    assert float((g32[0].double() - g64[0]).abs().max()) < 1.2e-7
    mp = rtt.c1_medium3_from_samples(F, ax, ax, ax, device="cpu")
    err_f32 = float((mp.n_and_grad3(xs, ys, zs)[0].double() - n64).abs()
                    .max())
    assert err_df < err_f32
    # the JAX facade's values on the same points (run op for op), to the bit
    with jax.disable_jit():
        jn, jg = J.DfEvalMedium3(med=J.df_c1_medium3_from_samples(
            F, ax, ax, ax)).n_and_grad3(*(v.numpy() for v in (xs, ys, zs)))
    np.testing.assert_array_equal(n32.numpy(), np.asarray(jn))


def test_medium_lin3_branch_is_the_closed_form(media17, monkeypatch):
    """The facade's tangent comes from ``_hess3`` through ``_medium_lin3``'s
    DfEvalMedium3 branch, never from autodiff through the df contraction:
    with ``torch.func.jvp`` made to raise, the branch's (dn, dg) agree
    with jvp through the contraction within 3e-5 of their largest
    magnitude.  The closed form is JAX's own (``_hess3``, equal to the bit
    above); on these points it is 1.1e-5 off that jvp, and against the
    float64 Hessian of the same tricubic 2.7e-5 where the jvp is 6.2e-6
    (ROADMAP.md §3), so 1e-5 would fail the reference itself."""
    _, _, tm, _ = media17
    m = T.DfEvalMedium3(med=tm)
    rng = np.random.default_rng(5)
    pos = torch.tensor(rng.uniform(-1.4, 1.4, (64, 3)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(2, 64, 3)), dtype=torch.float32)

    def flat(x, y, z):
        n, g = m.n_and_grad3(x, y, z)
        return (n, *g)
    want = [torch.func.jvp(flat, tuple(pos.unbind(-1)),
                           tuple(d[k].unbind(-1)))[1] for k in range(2)]
    calls = []
    real = T._hess3
    monkeypatch.setattr(T, "_hess3",
                        lambda *a: calls.append(1) or real(*a))

    real_jvp = torch.func.jvp

    def no_jvp(*a, **k):
        raise AssertionError("autodiff through the df contraction")
    monkeypatch.setattr(torch.func, "jvp", no_jvp)
    n, g, lin = tdyn3._medium_lin3(m, torch.float32)(pos)
    dn, dg = lin(d)
    assert calls == [1]
    for k in range(2):
        got = torch.cat([dn[k][:, None], dg[k]], -1).double()
        ref = torch.stack(want[k], -1).double()
        assert float((got - ref).abs().max()) <= 3e-5 * float(
            ref.abs().max())
    # trace_dynamic3 on the facade runs through it: a Hessian every step,
    # and jvp only for the launch chart (its two tangents), once a trace
    calls.clear()
    jvps = []
    monkeypatch.setattr(torch.func, "jvp",
                        lambda *a, **k: jvps.append(1) or real_jvp(*a, **k))
    rtt.trace_dynamic3("op6", m, pos0=np.array([[1.0, 0.0, 0.0]] * 2),
                       dir0=np.array([[0.0, 1.0, 0.01]] * 2),
                       delta_s=0.01, steps=8, mode="metrics",
                       dtype=torch.float32, device="cpu")
    assert len(calls) >= 8 and len(jvps) <= 2


@pytest.fixture(scope="module")
def media21():
    F, ax = _samples(21)
    return (F, ax, rtt.df_eval_medium3_from_samples(F, ax, ax, ax,
                                                    device="cpu"))


def test_facade_drops_into_trace3d(media21):
    """trace3d at float32 on the facade tracks float64 on the float64
    C1Grid3Medium within 5e-6 over 250 steps (test_df_grid3.py:108-134)."""
    F, ax, m = media21
    r = 8
    th = np.pi / 2 + np.linspace(-0.02, 0.02, r)
    dir0 = np.stack([np.cos(th), np.sin(th), np.full(r, 1e-2)], -1)
    pos0 = np.tile([[1.0, 0.0, 0.0]], (r, 1))
    box = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
    kw = dict(delta_s=2 * np.pi / 600, steps=250, box=box, mode="metrics",
              device="cpu")
    res = rtt.trace3d("op6", m, pos0=pos0.astype(np.float32),
                      dir0=dir0.astype(np.float32), dtype=torch.float32,
                      **kw)
    m64 = rtt.c1_medium3_from_samples(F, ax, ax, ax, device="cpu",
                                      dtype=torch.float64)
    res64 = rtt.trace3d("op6", m64, pos0=pos0, dir0=dir0,
                        dtype=torch.float64, **kw)
    assert float((res.final.pos.double() - res64.final.pos).abs().max()) \
        < 5e-6


def test_trace_dynamic3_facade_matches_jax(media21):
    """trace_dynamic3 at float32 on the facade against JAX's on the same
    medium, at JAX's kernel-against-scan bars (tests/test_dynamic_tiled3.py:
    125-139): pos and traveltime atol 1e-5, det Q p95 relative 1e-3, KMAH
    and the focus locator's step equal, min |det Q| rtol 1e-2."""
    F, ax, m = media21
    r = 8
    th = np.linspace(-0.03, 0.03, r)
    dir0 = np.stack([-np.cos(th), np.sin(th), np.full(r, 0.01)],
                    -1).astype(np.float32)
    pos0 = np.tile([[1.0, 0.0, 0.0]], (r, 1)).astype(np.float32)
    kw = dict(pos0=pos0, dir0=dir0, delta_s=2 * np.pi / 500, steps=120,
              box=(-1.4, 1.4, -1.4, 1.4, -1.4, 1.4), mode="metrics")
    ours = rtt.trace_dynamic3("op6", m, dtype=torch.float32, device="cpu",
                              **kw)
    theirs = j_trace_dynamic3("op6", J.df_eval_medium3_from_samples(
        F, ax, ax, ax), dtype=np.float32, **kw)
    np.testing.assert_allclose(ours.pos.numpy(), np.asarray(theirs.pos),
                               atol=1e-5)
    np.testing.assert_allclose(ours.traveltime.numpy(),
                               np.asarray(theirs.traveltime), atol=1e-5)
    jd = np.asarray(theirs.detq)
    mask = jd != 0
    rel = np.abs(ours.detq.numpy() - jd)[mask] / np.abs(jd)[mask]
    assert np.percentile(rel, 95) < 1e-3
    np.testing.assert_array_equal(ours.kmah.numpy(), np.asarray(theirs.kmah))
    np.testing.assert_array_equal(ours.min_absdet_step.numpy(),
                                  np.asarray(theirs.min_absdet_step))
    np.testing.assert_allclose(ours.min_absdet.numpy(),
                               np.asarray(theirs.min_absdet), rtol=1e-2,
                               atol=1e-7)


def test_facade_moves_and_defaults_to_the_card(media21):
    """``to`` moves both word tables; the builders' default device is CUDA,
    which raises without a card rather than falling back."""
    _, _, m = media21
    moved = m.to("cpu")
    assert moved.med.Nh.device.type == "cpu" and moved.med.Nl is not None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    F, ax = _samples(6)
    with pytest.raises((RuntimeError, AssertionError)):
        rtt.df_eval_medium3_from_samples(F, ax, ax, ax)
