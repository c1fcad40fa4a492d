"""The port's df32 tier on the analytic fields (raytracing_tpu_torch/kernels/
df.py) against the JAX package's (raytracing_tpu/kernels/df.py).

The double-word primitives and the RK4 body equal JAX's, op for op and bit
for bit, on seeded inputs (JAX evaluated one jnp call at a time).  The
whole traces are held to JAX's ``df_trace`` in Pallas interpret mode, whose
jitted body XLA:CPU compiles with its own rewrites (multiply-adds fused,
among others), and to the float64 op12 scan tier at the JAX package's own
bars (tests/test_df.py).  ``fast_trace(precision="high")`` routes and
refuses as JAX's does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine import df_grid as jdg  # noqa: E402
from raytracing_tpu.engine.fast import fast_trace as jax_fast_trace  # noqa: E402,E501
from raytracing_tpu.kernels import df as jdf  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import df_grid as tdg  # noqa: E402
from raytracing_tpu_torch.interop import df_state_from_numpy  # noqa: E402
from raytracing_tpu_torch.kernels import df as tdf  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402

#: port against JAX's interpret-mode df_trace.  The fisheye bar is the
#: tier's own; on vert (rays near their turning points amplify an
#: arithmetic difference) XLA's rewrites of the jitted body move JAX's
#: result by up to 2.7e-7 from the op-for-op evaluation the port performs
#: (measured, 128 rays, 500 steps; ROADMAP.md §3): held to 5e-7
JAX_TOL = {"fisheye": 1e-8, "vert_heterogeneous": 5e-7}
#: on a fisheye fan with +-0.3 rad of jitter the tangent's float32-only
#: rotation carries any low-word difference into the high word on some
#: rays, so JAX's eager roundings and its jitted body part by up to
#: 5.574e-7 (divisor 300) and 4.761e-7 (1000), 128 rays, one turn
#: (measured): held to 6e-7
JITTERED_BAR = 6e-7
#: the JAX package's bars against the float64 op12 scan tier
#: (tests/test_df.py:26-30, :92-95)
F64_BAR = {300: 2e-7, 1000: 4e-7, 4587: 6e-7}


def _same(jax_out, port_out):
    for j, t in zip(jax_out, port_out):
        np.testing.assert_array_equal(H.to_np(t), np.asarray(j))


PRIMITIVES = {
    "two_sum": (jdf._two_sum, tdf.two_sum),
    "two_prod": (jdf._two_prod, tdf.two_prod),
    "df_recip": (jdf._df_recip, tdf.df_recip),
    "df_add": (jdg._df_add, tdg.df_add),
    "df_mul": (jdg._df_mul, tdg.df_mul),
    "apply_rotation": (jdf._apply_rotation, tdf.apply_rotation),
}


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitives_equal_jax_bit_for_bit(name):
    jf, tf = PRIMITIVES[name]
    a, b = H.dekker_pairs()
    lo = (b * np.float32(1e-8)).astype(np.float32)    # a df low word
    if name in ("two_sum", "two_prod"):
        args = [a, b]
    elif name == "df_recip":
        args = [a, (a * np.float32(1e-8)).astype(np.float32)]
    elif name == "apply_rotation":
        # a unit df tangent turned by a small df angle
        th = a.astype(np.float64)
        args = [*tdg.split64(np.cos(th)), *tdg.split64(np.sin(th)),
                *tdg.split64(np.tanh(b.astype(np.float64)) * 1e-2)]
    else:
        c, d = H.dekker_pairs(seed=1)
        args = [a, lo, c, (d * np.float32(1e-8)).astype(np.float32)]
    _same(jf(*map(jnp.asarray, args)), tf(*map(torch.as_tensor, args)))


def test_fast_two_sum_and_the_constant_split_equal_jax():
    a, b = H.dekker_pairs()
    big = np.where(np.abs(a) >= np.abs(b), a, b)
    small = np.where(np.abs(a) >= np.abs(b), b, a)
    _same(jdf._fast_two_sum(jnp.asarray(big), jnp.asarray(small)),
          tdf.fast_two_sum(torch.as_tensor(big), torch.as_tensor(small)))
    # JAX splits a Python constant in float64: high word the constant
    _same(jdf._two_prod(jnp.asarray(a), jdf._SIXTH_HI),
          tdf.two_prod_const(torch.as_tensor(a), tdf._SIXTH_HI))
    assert float(tdf._SIXTH_HI) == jdf._SIXTH_HI
    assert float(tdf._SIXTH_LO) == jdf._SIXTH_LO


def _jax_df_k(field):
    """JAX's angle rate of ``_df_rk4_kernel`` (df.py:199-232), outside the
    kernel, as plain jnp."""
    if field == "fisheye":
        def df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl):
            ah, al = jdf._two_prod(vxh, pyh)
            al = al + (vxh * pyl + vxl * pyh)
            bh, bl = jdf._two_prod(vyh, pxh)
            bl = bl + (vyh * pxl + vyl * pxh)
            ch, ce = jdf._two_sum(ah, -bh)
            cl = ce + (al - bl)
            xxh, xxl = jdf._two_prod(pxh, pxh)
            xxl = xxl + 2.0 * pxh * pxl
            yyh, yyl = jdf._two_prod(pyh, pyh)
            yyl = yyl + 2.0 * pyh * pyl
            sh, se = jdf._two_sum(xxh, yyh)
            dh, de = jdf._two_sum(1.0, sh)
            dl = de + se + xxl + yyl
            n0, nl = jdf._df_recip(dh, dl)
            kh, ke = jdf._two_prod(-2.0 * n0, ch)
            return kh, ke + (-2.0) * (nl * ch + n0 * cl)
        return df_k

    def df_k(pxh, pxl, pyh, pyl, vxh, vxl, vyh, vyl):
        dh, de = jdf._two_sum(18.0, 2.0 * pyh)
        dl = de + 2.0 * pyl
        n0, nl = jdf._df_recip(dh, dl)
        kh, ke = jdf._two_prod(-2.0 * n0, vxh)
        return kh, ke + (-2.0) * (nl * vxh + n0 * vxl)
    return df_k


def _launch(field, r=128, seed=0):
    if field == "fisheye":
        return H.fisheye_df_fan(r, jitter=0.3, seed=seed), 2 * np.pi / 300
    rng = np.random.default_rng(seed)
    return ((np.tile([[-2.0, -2.0]], (r, 1)), rng.uniform(0.5, 1.3, r)),
            0.0193)


@pytest.mark.parametrize("field", tdf.DF_FIELDS)
def test_rk4_body_equals_jax_op_for_op(field):
    """The port's step in JAX's roundings (``jax_roundings``; the kernel runs
    the FMA form) is JAX's make_df_rk4_body, one jnp call at a time (no XLA
    fusion), to the bit over 12 steps of 128 seeded rays."""
    (pos0, theta0), ds = _launch(field)
    st = tdf.initial_df_state(pos0, theta0, device="cpu")
    carry = tuple(jnp.asarray(H.to_np(t)) for t in st)
    body = jdf.make_df_rk4_body(_jax_df_k(field), jnp.float32(ds))
    for _ in range(12):
        carry = body(0, carry)
    _same(carry, tdf.df_step_plain(st, field, ds, 12, jax_roundings=True))


@pytest.fixture(scope="module")
def f64_truth():
    """The float64 op12 scan tier (the port's) from (1, 0) at pi/2, cached
    by divisor: one turn at delta_s = f32(2 pi / div)."""
    cache = {}

    def truth(div):
        if div not in cache:
            ds = float(np.float32(2 * np.pi / div))
            pos0, theta0 = H.fisheye_df_fan(2)
            res = rtt.trace("op12", rtt.scenario("fisheye"),
                            rtt.analytic_medium("fisheye"), delta_s=ds,
                            max_size=div + 1, mode="metrics",
                            dtype=torch.float64, pos0=pos0, theta0=theta0,
                            device="cpu")
            cache[div] = H.to_np(res.final.pos)[0]
        return cache[div]
    return truth


@pytest.mark.parametrize("div", [300, 1000])
def test_df_trace_matches_jax_and_f64(div, f64_truth):
    """128 rays from (1, 0) at pi/2 for one turn (tests/test_df.py:19-30):
    measured |dpos| against JAX 6.8e-9 (300) and 3.3e-10 (1000)."""
    pos0, theta0 = H.fisheye_df_fan(128)
    ds = np.float32(2 * np.pi / div)
    want = jdf.df_trace(pos0, theta0, ds, steps=div, block_rays=128,
                        interpret=True)
    got = H.to_np(tdf.df_trace(pos0, theta0, ds, steps=div, device="cpu"))
    assert got.dtype == np.float64 and got.shape == (128, 2)
    assert np.abs(got - want).max() <= JAX_TOL["fisheye"]
    assert np.linalg.norm(got[0] - f64_truth(div)) < F64_BAR[div]


@pytest.mark.parametrize("div", [300, 1000])
def test_df_trace_on_a_jittered_fan_stays_within_jax_own_spread(div):
    """128 rays from (1, 0) at pi/2 +- 0.3 rad for one turn.  JAX's own two
    evaluations part here: its eager roundings (``jax_roundings``, JAX's
    eager body to the bit) and its interpret-mode df_trace differ by up to
    JITTERED_BAR.  The port's df_trace (the FMA form) stays within that of
    JAX's df_trace, and is as close to the float64 op12 scan tier as
    JAX's eager roundings: RMS error within 1 % of theirs."""
    pos0, theta0 = H.fisheye_df_fan(128, jitter=0.3)
    ds = np.float32(2 * np.pi / div)
    want = jdf.df_trace(pos0, theta0, ds, steps=div, block_rays=128,
                        interpret=True)
    got = H.to_np(tdf.df_trace(pos0, theta0, ds, steps=div, device="cpu"))
    st = tdf.initial_df_state(pos0, theta0, device="cpu")
    eager = H.to_np(tdf.df_positions(tdf.df_step_plain(
        st, "fisheye", ds, div, jax_roundings=True)))
    assert np.abs(eager - want).max() <= JITTERED_BAR
    assert np.abs(got - want).max() <= JITTERED_BAR
    ref = H.to_np(rtt.trace(
        "op12", rtt.scenario("fisheye"), rtt.analytic_medium("fisheye"),
        delta_s=float(ds), max_size=div + 1, mode="metrics",
        dtype=torch.float64, pos0=pos0, theta0=theta0,
        device="cpu").final.pos)

    def rms(x):
        return np.sqrt((np.linalg.norm(x - ref, axis=1) ** 2).mean())
    assert rms(got) <= 1.01 * rms(eager), (rms(got), rms(eager))


def test_df_vert_matches_jax_and_f64():
    """tests/test_df.py:73-95: 128 rays from (-2, -2) at angles in
    [0.5, 1.3], 500 steps at f32(0.0193), against JAX and against the
    float64 scan tier in an unbounded box (bar 1e-6)."""
    import dataclasses
    r, steps, ds = 128, 500, float(np.float32(0.0193))
    theta0 = np.linspace(0.5, 1.3, r).astype(np.float32).astype(np.float64)
    pos0 = np.tile(np.array([[-2.0, -2.0]]), (r, 1))
    field = "vert_heterogeneous"
    want = jdf.df_trace(pos0, theta0, np.float32(ds), steps=steps,
                        field=field, block_rays=128, interpret=True)
    got = H.to_np(tdf.df_trace(pos0, theta0, ds, steps=steps, field=field,
                               device="cpu"))
    assert np.abs(got - want).max() <= JAX_TOL[field]
    big = dataclasses.replace(rtt.scenario("vert"),
                              box=(-1e9, 1e9, -1e9, 1e9))
    ref = rtt.trace("op12", big, rtt.analytic_medium(field), delta_s=ds,
                    max_size=steps + 1, mode="metrics", dtype=torch.float64,
                    pos0=pos0, theta0=theta0, device="cpu")
    assert np.linalg.norm(got - H.to_np(ref.final.pos), axis=1).max() < 1e-6


def test_df_segmented_equals_one_shot():
    """tests/test_df.py:105-116: 230 steps in segments of 64 equal one
    launch to the bit."""
    pos0, theta0 = H.fisheye_df_fan(16, jitter=0.1)
    ds = np.float32(2 * np.pi / 100)
    one = tdf.df_trace(pos0, theta0, ds, steps=230, device="cpu")
    seg = tdf.df_trace(pos0, theta0, ds, steps=230, segment=64, device="cpu")
    assert torch.equal(one, seg)


def test_df_at_the_benchmark_divisor_beats_the_plain_kernel(f64_truth):
    """tests/test_df.py:26-30 and :55-70 at divisor 4587: within 6e-7 of
    the float64 op12 scan tier, and at least 3x tighter than the plain
    float32 fused op12 kernel's plain version."""
    div = 4587
    ds = np.float32(2 * np.pi / div)
    pos0, theta0 = H.fisheye_df_fan(2)
    truth = f64_truth(div)
    err_df = np.linalg.norm(H.to_np(tdf.df_trace(
        pos0, theta0, ds, steps=div, device="cpu"))[0] - truth)
    st = kfu.initial_state("op12", pos0, theta0, field="fisheye",
                           with_stats=False, device="cpu")
    plain = kfu.fused_step_plain(
        st, field="fisheye", op="op12", steps=div, delta_s=ds,
        step_limit=div, offset=0.0, box=tuple(rtt.scenario("fisheye").box))
    err_plain = np.linalg.norm(np.array([float(plain.x[0]),
                                         float(plain.y[0])]) - truth)
    assert err_df < F64_BAR[div]
    assert err_df < err_plain / 3, (err_df, err_plain)


def test_fast_trace_high_precision_routes_to_df32():
    scen = rtt.scenario("fisheye")
    pos0, theta0 = H.fisheye_df_fan(8, jitter=0.01)
    ds, div = 2 * np.pi / 150, 150
    res = rtt.fast_trace("op12", scen, rtt.analytic_medium("fisheye"),
                         delta_s=ds, pos0=pos0, theta0=theta0, divisor=div,
                         n_turns=1, precision="high", device="cpu")
    steps = scen.max_size(ds, div, 1) - 1
    assert res.engine == "df32" and res.traveltime is None
    assert res.dist_sim is None and bool(res.active.all())
    # launch data rounded to float32 first, as JAX's fast_trace does
    want = tdf.df_trace(pos0.astype(np.float32),
                        theta0.astype(np.float32), ds, steps=steps,
                        device="cpu")
    assert torch.equal(res.pos, want)
    jres = jax_fast_trace("op12", rt.scenario("fisheye"),
                         rt.analytic_medium("fisheye"), delta_s=ds,
                         pos0=pos0, theta0=theta0, divisor=div, n_turns=1,
                         precision="high", block_rays=128)
    assert jres.engine == res.engine


@pytest.mark.parametrize("case,match", [
    ("op6", "pass op12"),
    ("interface", "df32 kernel supports analytic"),
    ("sampled", "df32 kernel supports analytic"),
    ("stats", "Welford"),
])
def test_fast_trace_high_precision_refuses(case, match):
    kw = dict(delta_s=0.01, pos0=np.zeros((4, 2)), theta0=np.zeros(4),
              steps=2, precision="high", device="cpu")
    op, scen, med = "op12", rtt.scenario("vert"), rtt.analytic_medium(
        "vert_heterogeneous")
    if case == "op6":
        op = "op6"
    elif case == "interface":
        scen, med = rtt.scenario("interface"), rtt.analytic_medium(
            "interface")
    elif case == "sampled":
        med = rtt.build_c1_stratified("vert_heterogeneous", scen.box,
                                      device="cpu")
    else:
        kw["stats"] = True
    with pytest.raises(ValueError, match=match):
        rtt.fast_trace(op, scen, med, **kw)


def test_df_rejects_unknown_field_and_foreign_media():
    with pytest.raises(ValueError, match="df kernel supports"):
        tdf.df_trace(np.zeros((4, 2)), np.zeros(4), 0.01, steps=2,
                     field="interface", device="cpu")
    st = tdf.initial_df_state(np.zeros((4, 2)), np.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="split-word df medium"):
        tdf.df_step(st, rtt.analytic_medium("fisheye"), 0.01, 2)


def test_df_state_crosses_from_a_jax_state():
    """A JAX df resume tuple (df.py:326-329) becomes the port's 8 planes and
    steps on exactly as the port's own state."""
    pos0, theta0 = H.fisheye_df_fan(16, jitter=0.2)
    st = tdf.initial_df_state(pos0, theta0, device="cpu")
    comps = [np.asarray(H.to_np(t)).reshape(2, 8) for t in st]
    back = df_state_from_numpy(comps, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(st, back))
    a = tdf.df_step(back, "fisheye", 0.01, 5)
    b = tdf.df_step(st, "fisheye", 0.01, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="8 components"):
        df_state_from_numpy(comps[:7], device="cpu")
