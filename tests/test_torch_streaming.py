"""Chunk-streamed history and chunked metrics traces
(raytracing_tpu_torch/engine/streaming.py): the port's chunks against its
own one-shot ``trace`` to the bit, and against the JAX package's
``stream_history`` / ``trace_chunked`` at float64 (atol 1e-12)."""
import dataclasses

import numpy as np
import pytest
import torch_port_helpers  # noqa: F401  (one torch thread a worker)

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine import streaming as jstream  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine.streaming import (  # noqa: E402
    stream_history, trace_chunked)

#: the JAX package's streamed results against the port's, float64
JAX_ATOL = 1e-12
DTYPES = {"f32": (torch.float32, np.float32), "f64": (torch.float64,
                                                      np.float64)}


def _case(name):
    """(package -> scenario, field, op, kwargs) of the JAX tests' three
    streaming cases (tests/test_streaming.py): the fisheye at op6, vert in
    a box that rays leave at op8, and op7 with chunk 2, whose order ramp
    (steps 1 and 2) straddles the first chunk edges."""
    fan = dict(pos0=np.repeat([[1.0, 0.0]], 2, 0),
               theta0=np.repeat([np.pi / 2], 2))
    if name == "fisheye":
        return ("fisheye", {}, "fisheye", "op6",
                dict(delta_s=2 * np.pi / 100, divisor=101, n_turns=1,
                     chunk=17, **fan))
    if name == "vert_exits":
        return ("vert", dict(box=(-2.0, -1.0, -2.5, -1.5), s_max=3.0),
                "vert_heterogeneous", "op8", dict(delta_s=0.05, chunk=13))
    return ("fisheye", {}, "fisheye", "op7",
            dict(delta_s=2 * np.pi / 60, divisor=61, n_turns=1, chunk=2,
                 **fan))


def _scen(pkg, name, kw):
    return dataclasses.replace(pkg.scenario(name), **kw)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["fisheye", "vert_exits", "op7_ramp"])
def test_streamed_equals_oneshot(case, dtype):
    """The concatenated chunks are the one-shot history, bit for bit."""
    scen_name, skw, field, op, kw = _case(case)
    tdt = DTYPES[dtype][0]
    scen = _scen(rtt, scen_name, skw)
    med = rtt.analytic_medium(field)
    chunks = list(stream_history(op, scen, med, dtype=tdt, device="cpu",
                                 **kw))
    assert all(c.shape[0] <= kw["chunk"] + (i == 0)
               for i, c in enumerate(chunks))
    kw.pop("chunk")
    ref = rtt.trace(op, scen, med, dtype=tdt, device="cpu", **kw)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=0),
                                  ref.history.numpy())
    if case == "vert_exits":
        assert int(ref.exit_step.max()) > int(ref.exit_step.min()) > 0


@pytest.mark.parametrize("op", [f"op{i}" for i in range(1, 12)])
def test_all_eleven_ops_stream(op):
    """Every reference step method streams (chunk 7 across a 24-step turn)."""
    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    kw = dict(delta_s=2 * np.pi / 24, divisor=25, n_turns=1,
              dtype=torch.float64, device="cpu",
              pos0=np.repeat(scen.pos0, 2, 0),
              theta0=np.repeat(scen.theta0, 2))
    chunks = list(stream_history(op, scen, med, chunk=7, **kw))
    ref = rtt.trace(op, scen, med, **kw)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=0),
                                  ref.history.numpy())


@pytest.mark.parametrize("case", ["fisheye", "vert_exits", "op7_ramp"])
def test_streamed_matches_jax(case):
    scen_name, skw, field, op, kw = _case(case)
    ours = np.concatenate(list(stream_history(
        op, _scen(rtt, scen_name, skw), rtt.analytic_medium(field),
        dtype=torch.float64, device="cpu", **kw)), axis=0)
    theirs = np.concatenate(list(jstream.stream_history(
        op, _scen(rt, scen_name, skw), rt.analytic_medium(field),
        dtype=np.float64, **kw)), axis=0)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=JAX_ATOL)


def _vert_grid_case(pkg):
    scen = _scen(pkg, "vert", dict(box=(-2.0, 5.0, -2.5, 0.0)))
    return scen, dict(delta_s=0.05, chunk=13)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_trace_chunked_matches_oneshot_metrics(dtype):
    """Chunked metrics equal the one-shot trace, ``exit_step`` included,
    across segment re-arms, with rays leaving at different steps."""
    scen, kw = _vert_grid_case(rtt)
    med = rtt.analytic_medium("vert_heterogeneous")
    tdt = DTYPES[dtype][0]
    chunk = kw.pop("chunk")
    one = rtt.trace("op8", scen, med, mode="metrics", dtype=tdt,
                    device="cpu", **kw)
    chk = trace_chunked("op8", scen, med, chunk=chunk, dtype=tdt,
                        device="cpu", **kw)
    for name in ("pos", "traveltime", "dist_sim", "active", "mom_count",
                 "mom_mean", "mom_m2"):
        assert torch.equal(getattr(chk.final, name),
                           getattr(one.final, name)), name
    assert torch.equal(chk.exit_step, one.exit_step)
    assert 0 < int(one.exit_step.min()) < int(one.exit_step.max())


def test_trace_chunked_matches_jax():
    scen, kw = _vert_grid_case(rtt)
    jscen, _ = _vert_grid_case(rt)
    ours = trace_chunked("op8", scen, rtt.analytic_medium(
        "vert_heterogeneous"), dtype=torch.float64, device="cpu", **kw)
    theirs = jstream.trace_chunked("op8", jscen, rt.analytic_medium(
        "vert_heterogeneous"), dtype=np.float64, **kw)
    np.testing.assert_allclose(ours.final.pos.numpy(),
                               np.asarray(theirs.final.pos), rtol=0,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(ours.final.traveltime.numpy(),
                               np.asarray(theirs.final.traveltime), rtol=0,
                               atol=JAX_ATOL)
    np.testing.assert_array_equal(ours.exit_step.numpy(),
                                  np.asarray(theirs.exit_step))


def test_stream_history_runs_on_the_card_by_default():
    """With no device argument the rays go to CUDA: without a card that
    raises, never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is exercised "
                    "on the chip")
    scen = rtt.scenario("fisheye")
    with pytest.raises((RuntimeError, AssertionError)):
        next(stream_history("op1", scen, rtt.analytic_medium("fisheye"),
                            delta_s=0.1, divisor=10, n_turns=1))
