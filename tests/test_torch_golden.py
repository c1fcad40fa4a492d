"""The plain PyTorch version of the golden kernel against the JAX Pallas
golden kernel in interpret mode, at float32: every op, every schedule
(closed-form seed + Newton polish, the Newton solver, the golden bracket
with and without polish), resume, and a JAX state finishing in the port."""
import numpy as np
import pytest
import torch_port_helpers as H
from test_torch_kernels import R, case

torch = pytest.importorskip("torch")

from raytracing_tpu.engine.segmented import (  # noqa: E402
    _initial_comps, _run_segments)
from raytracing_tpu.kernels import golden as jgold  # noqa: E402
from raytracing_tpu.media.fields import FIELDS  # noqa: E402

from raytracing_tpu_torch.interop import (  # noqa: E402
    resume_state_from_numpy, resume_state_to_numpy)
from raytracing_tpu_torch.kernels import golden as tgold  # noqa: E402

#: the JAX package's golden kernel bars (tests/test_golden_kernel.py:36-41)
POS_TOL, ANG_TOL, TT_TOL = 5e-4, 5e-3, 5e-4

# (op, field, gamma, gold_iters, polish); None = the default schedule
CASES = (
    [(op, "vert_heterogeneous", 3.0, None, None)
     for op in ("op10", "op11", "op10n", "op11n")]
    + [(op, "vert_heterogeneous", 1.0, None, None) for op in ("op5", "op9")]
    + [("op5", "interface", 1.0, None, None), ("op11", "fisheye", 1.0, None, None),
       ("op10n", "interface", 1.0, None, None)]
    + [(op, "vert_heterogeneous", g, None, 0)
       for op, g in (("op5", 1.0), ("op9", 1.0), ("op10", 3.0), ("op11", 3.0))]
    + [("op11", "vert_heterogeneous", 3.0, 12, 2), ("op9", "fisheye", 1.0, 12, 2)]
)


@pytest.mark.parametrize("op,field,gamma,iters,polish", CASES)
def test_golden_plain_matches_pallas(op, field, gamma, iters, polish):
    pos0, theta0, ds, box = case(field)
    stats = field != "fisheye"
    jg = jgold.golden_trace_final(pos0, theta0, ds, np.float32(gamma),
                                  field=field, op=op, steps=20, box=box,
                                  block_rays=R, interpret=True,
                                  with_stats=stats, gold_iters=iters,
                                  polish=polish)
    tg = tgold.golden_trace_final(pos0, theta0, ds, gamma, field=field, op=op,
                                  steps=20, box=box, device="cpu",
                                  with_stats=stats, gold_iters=iters,
                                  polish=polish)
    np.testing.assert_allclose(H.to_np(tg.pos), np.asarray(jg.pos), atol=POS_TOL)
    np.testing.assert_allclose(H.to_np(tg.angle), np.asarray(jg.angle),
                               atol=ANG_TOL)
    np.testing.assert_allclose(H.to_np(tg.traveltime),
                               np.asarray(jg.traveltime), atol=TT_TOL)
    np.testing.assert_array_equal(H.to_np(tg.active), np.asarray(jg.active))
    if stats:
        np.testing.assert_allclose(H.to_np(tg.mom_mean),
                                   np.asarray(jg.mom_mean), atol=1e-5)


def test_default_schedule_is_seed_plus_polish():
    assert tgold.golden_schedule() == jgold.golden_schedule() == (0, 2)
    assert tgold.golden_schedule(0) == jgold.golden_schedule(0)
    got = H.to_np(tgold.golden_scalars(0.1, 3.0, 50, 7, 16, device="cpu"))
    want = np.asarray(jgold.golden_scalars(0.1, 3.0, 50, 7, 16))
    np.testing.assert_array_equal(got, want)


def test_dual_numbers_match_nested_jvp():
    """Dual2 carries what nested forward-mode jvp carries: the first and
    second derivative of the anisotropic cost."""
    from torch.func import jvp

    rng = np.random.default_rng(3)
    t = torch.as_tensor(rng.uniform(-1, 1, 64))
    k = [torch.as_tensor(rng.uniform(0.1, 1.0, 64)) for _ in range(5)]

    def cost(ct, st):
        gs = 3.0 * st
        s2 = gs * gs + ct * ct
        inv = tgold._rsqrt(s2)
        cf = s2 * inv
        rx = k[0] * ct * inv - k[1] - cf * k[2]
        ry = k[3] * st * inv - k[4] - cf * k[2]
        return rx * rx + ry * ry

    def f(d):
        sd, cd = tgold.rot_small(d)
        return cost(0.6 * cd - 0.8 * sd, 0.6 * sd + 0.8 * cd)

    def df(d):
        return jvp(f, (d,), (torch.ones_like(d),))[1]

    d1, d2 = jvp(df, (t,), (torch.ones_like(t),))
    dual = f(tgold.Dual2(t, torch.ones_like(t), torch.zeros_like(t)))
    np.testing.assert_allclose(H.to_np(dual.v), H.to_np(f(t)), rtol=1e-12)
    np.testing.assert_allclose(H.to_np(dual.d1), H.to_np(d1), rtol=1e-10)
    np.testing.assert_allclose(H.to_np(dual.d2), H.to_np(d2), rtol=1e-10)


@pytest.mark.parametrize("op,polish", [("op11", None), ("op10", 0),
                                       ("op11n", None)])
def test_golden_resume_equals_one_launch(op, polish):
    pos0, theta0, ds, box = case("vert_heterogeneous")
    it, pol = tgold.golden_schedule(polish)
    st = tgold.initial_state(op, pos0, theta0, 3.0, field="vert_heterogeneous",
                             with_stats=True, device="cpu")

    def run(s, n, off):
        scal = tgold.golden_scalars(ds, 3.0, 30, off, it, device="cpu")
        return tgold.golden_step(s, scal, field="vert_heterogeneous", op=op,
                                 steps=n, box=box, gold_iters=it, polish=pol)

    one = run(st, 30, 0)
    two = run(run(st, 11, 0), 19, 11)
    for a, b in zip(one, two):
        if a is not None:
            assert torch.equal(a, b)


def test_jax_golden_state_mid_trace_finishes_like_jax():
    op, field, gamma = "op11", "vert_heterogeneous", 3.0
    pos0, theta0, ds, box = case(field)
    n, k = 30, 12
    comps = _initial_comps(op, pos0, theta0, with_stats=True,
                           n0_fn=FIELDS[field][0], gamma=gamma)
    state = tuple(np.asarray(c, np.float32).reshape(-1, 128) for c in comps)
    kw = dict(field=field, op=op, box=box, block_rays=R, interpret=True,
              stats=True, strat=None, nch=0, n_state=len(state))
    mid = _run_segments(state, None, np.float32(ds), np.float32(n),
                        np.float32(0), 1, np.float32(gamma), segment=k, **kw)
    end = _run_segments(mid, None, np.float32(ds), np.float32(n),
                        np.float32(k), 1, np.float32(gamma), segment=n - k,
                        **kw)
    st = resume_state_from_numpy(mid, op, with_stats=True, device="cpu")
    it, pol = tgold.golden_schedule()
    scal = tgold.golden_scalars(ds, gamma, n, k, it, device="cpu")
    st = tgold.golden_step(st, scal, field=field, op=op, steps=n - k, box=box)
    got = resume_state_to_numpy(st, op)
    want = [np.asarray(c).reshape(-1) for c in end]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=POS_TOL, err_msg=f"component {i}")


def test_golden_wrapper_checks():
    pos0, theta0, ds, box = case("vert_heterogeneous")
    st = tgold.initial_state("op11", pos0, theta0, 3.0,
                             field="vert_heterogeneous", with_stats=False,
                             device="cpu")
    scal = tgold.golden_scalars(ds, 3.0, 5, 0, 0, device="cpu")
    kw = dict(field="vert_heterogeneous", op="op11", steps=5, box=box)
    with pytest.raises(ValueError, match="supports"):
        tgold.golden_step(st, scal, **{**kw, "op": "op6"})
    with pytest.raises(ValueError, match="lacks"):
        tgold.golden_step(st._replace(ang=None), scal, **kw)
    with pytest.raises(ValueError, match="bundle"):
        tgold.golden_step(st, scal, gold_iters=16, polish=0, **kw)
