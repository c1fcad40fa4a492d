"""The port's split-word sampled media (raytracing_tpu_torch/engine/
df_grid.py) against the JAX package's (raytracing_tpu/engine/df_grid.py).

The three build functions' split tables equal JAX's bit for bit (both packages'
FITPACK path, both ``native`` libraries off); the df evaluators reproduce the
float64 splines; the df RK4 step on each medium equals JAX's, one jnp call
at a time, to the bit, and ``df_grid_trace`` is held to JAX's jitted
tracer; ``DfEvalProfile`` equals JAX's facade bit for bit and carries the
dynamic scan tier.  Inputs are seeded numpy; media cross over through
interop.  The trajectories against the float64 scan tier are in
test_torch_df_grid_f64.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu import native as jnative  # noqa: E402
from raytracing_tpu.engine import df_grid as jdg  # noqa: E402
from raytracing_tpu.engine import dynamic as jdyn  # noqa: E402
from raytracing_tpu.kernels import df as jdf  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import df_grid as tdg  # noqa: E402
from raytracing_tpu_torch import native as tnative  # noqa: E402
from raytracing_tpu_torch.kernels import df as tdf  # noqa: E402

#: the coarse fisheye grid (177 x 177 nodes) keeps the plain version quick
DELTA = 0.05
KINDS = ("grid", "c1", "profile")
#: port against JAX's jitted df_grid_trace (300 steps, JAX's own fan):
#: XLA:CPU's rewrites of the jitted body (multiply-adds fused, among
#: others) move JAX's result from the op-for-op evaluation the port
#: performs by 4.1e-8 (parity) and 2.2e-7 (C1) on the fisheye grids and
#: 1.4e-10 on the profile (measured; ROADMAP.md §3).  The op-for-op
#: equality is test_rk4_step_equals_jax_op_for_op's, to the bit
JAX_TOL = {"grid": 1e-7, "c1": 5e-7, "profile": 1e-8}
#: evaluators against the float64 splines (tests/test_df_grid.py:28-51,
#: :189-201): n, gx, gy
EVAL_TOL = {"grid": (1e-10, 1e-9, 1e-9), "c1": (1e-10, 1e-9, 1e-9),
            "profile": (1e-12, 0.0, 1e-11)}


@pytest.fixture(scope="module")
def media():
    """{kind: (JAX medium, port medium)}: the fisheye parity and C1 grids
    at DELTA and the Munk profile, each package's tables built by its
    FITPACK path (both native libraries off, so that the recorded bars
    hold); the port's built by the port."""
    box = rt.scenario("fisheye").box
    samples, depth = H.munk_profile()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        jax_media = {"grid": jdg.build_df_grid_medium("fisheye", box, DELTA),
                     "c1": jdg.build_df_c1_medium("fisheye", box, DELTA),
                     "profile": jdg.df_c1_profile_from_samples(samples,
                                                               depth)}
        port = {"grid": tdg.build_df_grid_medium("fisheye", box, DELTA,
                                                 device="cpu"),
                "c1": tdg.build_df_c1_medium("fisheye", box, DELTA,
                                             device="cpu"),
                "profile": tdg.df_c1_profile_from_samples(samples, depth,
                                                          device="cpu")}
    return {k: (jax_media[k], port[k]) for k in KINDS}


def _launch(kind, r):
    if kind == "profile":
        return H.channel_fan(r), 0.01
    return H.fisheye_df_fan(r, jitter=0.2), 2 * np.pi / 300


@pytest.mark.parametrize("kind", KINDS)
def test_split_tables_equal_jax(kind, media):
    jm, tm = media[kind]
    for name, want in H.medium_fields(jm).items():
        got = getattr(tm, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(H.to_np(got), want, err_msg=name)
        else:
            assert got == want, name


def _f64_medium(kind):
    box = rt.scenario("fisheye").box
    if kind == "grid":
        return rtt.build_grid_medium("fisheye", box, DELTA, device="cpu",
                                     dtype=torch.float64)
    if kind == "c1":
        return rtt.build_c1_medium("fisheye", box, DELTA, device="cpu",
                                   dtype=torch.float64)
    return rtt.c1_stratified_from_samples(*H.munk_profile(), device="cpu",
                                          dtype=torch.float64)


@pytest.mark.parametrize("kind", KINDS)
def test_evaluators_match_the_f64_splines(kind, media):
    """n and grad n from the split tables, hi + lo, against the float64
    spline of the same samples at 512 seeded points (the grid's edge cells
    and points outside it included: both clamp like FITPACK)."""
    _, tm = media[kind]
    rng = np.random.default_rng(7)
    lo, hi = (-3.1, 0.1) if kind == "profile" else (-4.0, 4.0)
    x = rng.uniform(-4.0, 4.0, 512)
    y = rng.uniform(lo, hi, 512)
    nag = {"grid": tdg._make_df_nag, "c1": tdg._make_df_c1_nag,
           "profile": tdg._make_df_profile_nag}[kind](tm)
    words = [torch.as_tensor(w) for w in (*tdg.split64(x), *tdg.split64(y))]
    (nh, nl), (gxh, gxl), (gyh, gyl) = nag(*words)
    n64, (gx64, gy64) = _f64_medium(kind).n_and_grad(torch.as_tensor(x),
                                                     torch.as_tensor(y))

    def err(h, lo_, ref):
        return float((h.double() + lo_.double() - ref).abs().max())

    tn, tgx, tgy = EVAL_TOL[kind]
    assert err(nh, nl, n64) <= tn
    assert err(gxh, gxl, gx64) <= tgx
    assert err(gyh, gyl, gy64) <= tgy


@pytest.mark.parametrize("kind", KINDS)
def test_rk4_step_equals_jax_op_for_op(kind, media):
    """The df RK4 step with the medium's df angle rate, in JAX's roundings
    (``jax_roundings``: the grids' kernels run it; the profile's runs the FMA
    form), equals JAX's (make_df_rk4_body with _make_df_k), one jnp call
    at a time, to the bit on every plane: 3 steps of 64 seeded rays."""
    jm, tm = media[kind]
    (pos0, theta0), ds = _launch(kind, 64)
    st = tdg.split_state(pos0, theta0, device="cpu")
    carry = tuple(jnp.asarray(H.to_np(t)) for t in st)
    body = jdf.make_df_rk4_body(jdg._make_df_k(jm), jnp.float32(ds))
    for _ in range(3):
        carry = body(0, carry)
    got = tdf.df_step_plain(st, tm, ds, 3, jax_roundings=True)
    for j, t in zip(carry, got):
        np.testing.assert_array_equal(H.to_np(t), np.asarray(j))


@pytest.mark.parametrize("kind", KINDS)
def test_df_grid_trace_matches_jax(kind, media):
    """300 steps: JAX's own fan (tests/test_df_grid.py: 4 rays from (1, 0)
    at pi/2) on the grids, 4 rays in the channel on the profile."""
    jm, tm = media[kind]
    if kind == "profile":
        (pos0, theta0), ds = _launch(kind, 4)
    else:
        (pos0, theta0), ds = H.fisheye_df_fan(4), 2 * np.pi / 300
    ds = np.float32(ds)
    want = jdg.df_grid_trace(pos0, theta0, ds, jm, steps=300)
    got = H.to_np(rtt.df_grid_trace(pos0, theta0, ds, tm, steps=300,
                                    device="cpu"))
    assert got.dtype == np.float64 and got.shape == (4, 2)
    assert np.abs(got - want).max() <= JAX_TOL[kind]


def test_split_state_of_tensors_matches_numpy():
    """Tensor launch inputs are split on their own device: the position
    words equal numpy's split64 to the bit; the tangent's (cos and sin in
    float64 there, not numpy's) agree with numpy's to float64 rounding."""
    rng = np.random.default_rng(3)
    pos0 = rng.uniform(-1.0, 1.0, (4096, 2))
    theta0 = rng.uniform(-np.pi, np.pi, 4096)
    a = tdg.split_state(pos0, theta0, device="cpu")
    b = tdg.split_state(torch.as_tensor(pos0), torch.as_tensor(theta0),
                        device="cpu")
    for name in ("xh", "xl", "yh", "yl"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for h, lo in (("uxh", "uxl"), ("uyh", "uyl")):
        wa = getattr(a, h).double() + getattr(a, lo).double()
        wb = getattr(b, h).double() + getattr(b, lo).double()
        assert float((wa - wb).abs().max()) <= 2.3e-16


@pytest.mark.parametrize("kind", KINDS)
def test_df_grid_segmented_equals_one_shot(kind, media):
    _, tm = media[kind]
    (pos0, theta0), ds = _launch(kind, 4)
    one = rtt.df_grid_trace(pos0, theta0, ds, tm, steps=40, segment=None,
                            device="cpu")
    seg = rtt.df_grid_trace(pos0, theta0, ds, tm, steps=40, segment=16,
                            device="cpu")
    assert torch.equal(one, seg)


@pytest.mark.parametrize("kind", KINDS)
def test_df_media_cross_from_jax(kind, media):
    """interop.medium_from_numpy carries each JAX df medium across: the
    same tables and statics, and the same trace as the port's own."""
    jm, tm = media[kind]
    moved = H.port_df_medium(jm)
    assert type(moved) is type(tm)
    (pos0, theta0), ds = _launch(kind, 8)
    a = rtt.df_grid_trace(pos0, theta0, ds, moved, steps=5, device="cpu")
    b = rtt.df_grid_trace(pos0, theta0, ds, tm, steps=5, device="cpu")
    assert torch.equal(a, b)


def test_df_from_samples_validation():
    """tests/test_df_grid.py:149-159, and the medium type and device."""
    gx = np.linspace(0.0, 1.0, 8)
    gy = np.concatenate([np.linspace(0.0, 1.0, 7), [3.0]])  # non-uniform
    Z = np.ones((8, 8))
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="uniformly spaced"):
        rtt.df_c1_medium_from_samples(Z, gx, gy, **kw)
    with pytest.raises(ValueError, match="Z shape"):
        rtt.df_grid_medium_from_samples(Z[:5], gx, np.linspace(0, 1, 8), **kw)
    with pytest.raises(ValueError, match="4x4"):
        rtt.df_c1_medium_from_samples(np.ones((3, 8)), gx,
                                      np.linspace(0, 1, 3), **kw)
    with pytest.raises(ValueError, match="4 profile samples"):
        rtt.df_c1_profile_from_samples(np.ones(3), np.linspace(0, 1, 3), **kw)
    with pytest.raises(ValueError, match="df_grid_trace needs"):
        rtt.df_grid_trace(np.zeros((2, 2)), np.zeros(2), 0.01,
                          rtt.analytic_medium("fisheye"), steps=2,
                          device="cpu")
    prof = rtt.df_c1_profile_from_samples(*H.munk_profile(), **kw)
    st = tdg.split_state(np.zeros((2, 2)), np.zeros(2), device="cpu")
    with pytest.raises(ValueError, match="need float32 on cpu"):
        tdf.df_step(st, prof.to(torch.float64), 0.01, 2)


@pytest.fixture(scope="module")
def eval_profiles():
    samples, depth = H.munk_profile()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        jp = jdg.df_eval_profile_medium(samples, depth)
        return jp, rtt.df_eval_profile_medium(samples, depth, device="cpu")


def test_df_eval_profile_equals_jax_bit_for_bit(eval_profiles):
    """DfEvalProfile.n_and_grad is the correctly rounded float32 of the
    float64 interpolant on any backend: the port's equals JAX's on 65,536
    seeded depths (beyond the table's ends included), every value."""
    jp, tp = eval_profiles
    rng = np.random.default_rng(11)
    y = rng.uniform(-3.2, 0.2, 1 << 16).astype(np.float32)
    x = rng.uniform(-5.0, 5.0, 1 << 16).astype(np.float32)
    jn, (jgx, jgy) = jp.n_and_grad(x, y)
    tn, (tgx, tgy) = tp.n_and_grad(torch.as_tensor(x), torch.as_tensor(y))
    assert tn.dtype == torch.float32 and tp.dtype == torch.float32
    for j, t in ((jn, tn), (jgx, tgx), (jgy, tgy)):
        np.testing.assert_array_equal(H.to_np(t), np.asarray(j))
    assert bool((tgx == 0).all())
    moved = H.port_df_medium(jp)
    assert torch.equal(moved.n(torch.as_tensor(x), torch.as_tensor(y)), tn)


def test_df_eval_profile_carries_the_dynamic_scan(eval_profiles):
    """A float32 op6 trace_dynamic through the facade (the torch.func.jvp
    tangent of its df arithmetic) against JAX's: 16 rays in the channel,
    100 steps, at the JAX package's kernel-against-scan bars
    (tests/test_dynamic_kernel.py:93-100: positions and traveltime 1e-5, q
    and dtheta within 2e-3 of their largest magnitude, KMAH equal)."""
    jp, tp = eval_profiles
    cfg = dict(name="custom", key="-", field="", gamma=1.0, ray_count=16,
               theta0=np.zeros(1), pos0=np.zeros((1, 2)), s_max=0.0,
               box=(-1.0, 42.0, -3.0, 0.0))
    pos0, theta0 = H.channel_fan(16)
    kw = dict(delta_s=0.01, mode="metrics", pos0=pos0, theta0=theta0,
              max_size=101)
    j = jdyn.trace_dynamic("op6", rt.ScenarioConfig(**cfg), jp,
                           dtype=np.float32, **kw)
    t = rtt.trace_dynamic("op6", rtt.ScenarioConfig(**cfg), tp,
                          dtype=torch.float32, device="cpu", **kw)
    for f, bar in (("pos", 1e-5), ("traveltime", 1e-5)):
        np.testing.assert_allclose(H.to_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), atol=bar,
                                   rtol=0, err_msg=f)
    for f in ("q", "dtheta"):
        want = np.asarray(getattr(j, f))
        np.testing.assert_allclose(H.to_np(getattr(t, f)), want,
                                   atol=2e-3 * np.abs(want).max(), rtol=0,
                                   err_msg=f)
    np.testing.assert_array_equal(H.to_np(t.kmah), np.asarray(j.kmah))
