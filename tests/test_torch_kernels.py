"""The plain PyTorch versions of the fisheye and fused kernels against the JAX
Pallas kernels in interpret mode, at float32; the kernels' resume form; a JAX
state taken mid-trace finishing in the port; and the wrappers' checks."""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

from raytracing_tpu.engine.segmented import (  # noqa: E402
    _initial_comps, _run_segments)
from raytracing_tpu.kernels import fisheye as jfish  # noqa: E402
from raytracing_tpu.kernels import fused as jfused  # noqa: E402
from raytracing_tpu.media.fields import FIELDS  # noqa: E402

from raytracing_tpu_torch.interop import (  # noqa: E402
    resume_state_from_numpy, resume_state_to_numpy)
from raytracing_tpu_torch.kernels import fisheye as tfish  # noqa: E402
from raytracing_tpu_torch.kernels import fused as tfused  # noqa: E402

R = 128          # one Pallas block of rays
FISHEYE_BOX = (-1.5, 1.5, -1.5, 1.5)


def fisheye_fan(seed=0):
    rng = np.random.default_rng(seed)
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (R, 1))
    theta0 = (np.pi / 2 + rng.uniform(-0.01, 0.01, R)).astype(np.float32)
    return pos0, theta0


def case(field, seed=0):
    """(pos0, theta0, delta_s, box) in float32 for a field."""
    rng = np.random.default_rng(seed)
    if field == "fisheye":
        pos0, theta0 = fisheye_fan(seed)
        return pos0, theta0, np.float32(2 * np.pi / 101), FISHEYE_BOX
    if field == "interface":
        pos0, theta0 = H.fan_near_interface(rng, R)
        ds, box = np.float32(0.01), H.INTERFACE_BOX
    else:
        pos0, theta0 = H.fan_vert(rng, R)
        ds, box = np.float32(0.05), H.VERT_BOX
    return pos0.astype(np.float32), theta0.astype(np.float32), ds, box


def test_fisheye_plain_matches_pallas():
    pos0, theta0 = fisheye_fan()
    ds = np.float32(2 * np.pi / 97)
    jpos, jtt = jfish.fisheye_trace_final(pos0, theta0, ds, steps=97,
                                          block_rays=R, interpret=True)
    tpos, ttt = tfish.fisheye_trace_final(pos0, theta0, ds, steps=97,
                                          device="cpu")
    # the JAX package's fisheye kernel bar (tests/test_kernels.py:24-27)
    np.testing.assert_allclose(H.to_np(tpos), np.asarray(jpos), atol=5e-6)
    np.testing.assert_allclose(H.to_np(ttt), np.asarray(jtt), atol=5e-5)


def test_fisheye_runner_semantics():
    run = tfish.make_fisheye_runner(8, 64, 1, device="cpu")
    assert run.steps == 64           # n_turns * (divisor + 1) - 1
    p1 = H.to_np(run())
    np.testing.assert_array_equal(p1, H.to_np(run(3)))
    closure = 100 * np.linalg.norm(p1[0] - [1.0, 0.0]) / (2 * np.pi)
    assert closure < 5.0              # the reference closure bar


FUSED_CASES = ([(op, "fisheye") for op in tfused.FUSED_OPS]
               + [(op, "vert_heterogeneous") for op in ("op1", "op3", "op6",
                                                        "op7", "op12")]
               + [(op, "interface") for op in ("op2", "op4", "op6", "op8")])


@pytest.mark.parametrize("op,field", FUSED_CASES)
def test_fused_plain_matches_pallas(op, field):
    pos0, theta0, ds, box = case(field)
    stats = field != "fisheye"
    jf = jfused.fused_trace_final(pos0, theta0, ds, field=field, op=op,
                                  steps=50, box=box, block_rays=R,
                                  interpret=True, with_stats=stats)
    tf = tfused.fused_trace_final(pos0, theta0, ds, field=field, op=op,
                                  steps=50, box=box, device="cpu",
                                  with_stats=stats)
    # the JAX package's fused kernel bar (tests/test_fused.py:31-33): op7's
    # 11a-18b+9c-2d combination of near-equal positions amplifies rounding
    atol = 2e-4 if op == "op7" else 1e-5
    np.testing.assert_allclose(H.to_np(tf.pos), np.asarray(jf.pos), atol=atol)
    np.testing.assert_allclose(H.to_np(tf.traveltime),
                               np.asarray(jf.traveltime), atol=5e-5)
    np.testing.assert_array_equal(H.to_np(tf.active), np.asarray(jf.active))
    if stats:
        for name in ("mom_count", "mom_mean"):
            np.testing.assert_allclose(H.to_np(getattr(tf, name)),
                                       np.asarray(getattr(jf, name)),
                                       atol=1e-5, err_msg=name)
    if field != "fisheye":
        assert not H.to_np(tf.active).all()   # the box exit is exercised


@pytest.mark.parametrize("op,field,stats", [("op7", "fisheye", False),
                                            ("op6", "interface", True),
                                            ("op12", "vert_heterogeneous", True)])
def test_fused_resume_equals_one_launch(op, field, stats):
    pos0, theta0, ds, box = case(field)
    st = tfused.initial_state(op, pos0, theta0, field=field,
                              with_stats=stats, device="cpu")
    kw = dict(field=field, op=op, delta_s=ds, step_limit=40, box=box)
    one = tfused.fused_step(st, steps=40, offset=0, **kw)
    two = tfused.fused_step(tfused.fused_step(st, steps=13, offset=0, **kw),
                            steps=27, offset=13, **kw)
    for a, b in zip(one, two):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("op,field,stats", [("op7", "fisheye", False),
                                            ("op8", "vert_heterogeneous", True)])
def test_jax_state_mid_trace_finishes_like_jax(op, field, stats):
    """A resume state the JAX segmented tier reached after k steps, carried
    across through interop, finishes the remaining n - k steps in the port
    as it does in JAX."""
    pos0, theta0, ds, box = case(field)
    n, k = 40, 16
    comps = _initial_comps(op, pos0, theta0, with_stats=stats,
                           n0_fn=FIELDS[field][0])
    state = tuple(np.asarray(c, np.float32).reshape(-1, 128) for c in comps)
    kw = dict(field=field, op=op, box=box, block_rays=R, interpret=True,
              stats=stats, strat=None, nch=0, n_state=len(state))
    mid = _run_segments(state, None, np.float32(ds), np.float32(n),
                        np.float32(0), 1, segment=k, **kw)
    end = _run_segments(mid, None, np.float32(ds), np.float32(n),
                        np.float32(k), 1, segment=n - k, **kw)
    st = resume_state_from_numpy(mid, op, with_stats=stats, device="cpu")
    st = tfused.fused_step(st, field=field, op=op, steps=n - k, delta_s=ds,
                           step_limit=n, offset=k, box=box)
    got = resume_state_to_numpy(st, op)
    want = [np.asarray(c).reshape(-1) for c in end]
    assert len(got) == len(want)
    atol = 2e-4 if op == "op7" else 1e-5
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=f"component {i}")


def test_wrappers_check_their_inputs():
    pos0, theta0, ds, box = case("vert_heterogeneous")
    st = tfused.initial_state("op1", pos0, theta0, field="vert_heterogeneous",
                              with_stats=False, device="cpu")
    kw = dict(field="vert_heterogeneous", op="op1", steps=3, delta_s=ds,
              step_limit=3, box=box)
    with pytest.raises(ValueError, match="float32"):
        tfused.fused_step(st._replace(x=st.x.double()), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_step(st._replace(y=torch.zeros(2 * R)[::2]), **kw)
    with pytest.raises(ValueError, match="lacks"):
        tfused.fused_step(st, **{**kw, "op": "op7"})
    with pytest.raises(ValueError, match="supports ops"):
        tfused.fused_step(st, **{**kw, "op": "op5"})
    with pytest.raises(ValueError, match="supports fields"):
        tfused.fused_step(st, **{**kw, "field": "warp"})
    with pytest.raises(ValueError, match="pos0"):
        tfused.fused_trace_final(pos0[:, 0], theta0, ds, field="fisheye",
                                 op="op1", steps=1, box=box, device="cpu")
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="float32"):
        tfish.fisheye_op1(x, x, x, x.double(), 0.1, 1)


def test_cpu_path_launches_no_kernel():
    """On CPU tensors the wrappers run the plain versions; the kernels'
    launch counts stay put."""
    before = (tfish.KERNEL.launches, tfused.KERNEL.launches)
    pos0, theta0, ds, box = case("fisheye")
    tfish.fisheye_trace_final(pos0, theta0, ds, steps=2, device="cpu")
    tfused.fused_trace_final(pos0, theta0, ds, field="fisheye", op="op6",
                             steps=2, box=box, device="cpu")
    assert (tfish.KERNEL.launches, tfused.KERNEL.launches) == before
