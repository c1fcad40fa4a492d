"""Checkpoint and resume in the port: ``utils/checkpoint.py`` (a copy of the
JAX package's numpy-only module, so the two read each other's sweep
checkpoints), the scan and kernel sweeps resuming from their chunks, and
``segmented_trace`` resuming bit-identically from its saved state, with the
JAX package's identity and horizon guards."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.parallel import sweep as jsw  # noqa: E402
from raytracing_tpu.utils import checkpoint as jck  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import config as tconfig  # noqa: E402
from raytracing_tpu_torch.engine.segmented import segmented_trace  # noqa: E402
from raytracing_tpu_torch.parallel import sweep as tsw  # noqa: E402
from raytracing_tpu_torch.utils.checkpoint import (  # noqa: E402
    SweepCheckpoint, TraceCheckpoint)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ck.npz")
    ck = SweepCheckpoint(p, meta={"op": "op1"})
    ck.add_chunk(0, {"m": np.arange(4.0)})
    ck.add_chunk(1, {"m": np.arange(4.0) + 10})
    ck2 = SweepCheckpoint(p, meta={"op": "op1"})
    assert ck2.has_chunk(0) and ck2.has_chunk(1)
    np.testing.assert_array_equal(
        ck2.assembled(2)["m"], np.concatenate([np.arange(4.0),
                                               np.arange(4.0) + 10]))
    assert ck2.assembled(3) is None
    with pytest.raises(ValueError, match="different sweep"):
        SweepCheckpoint(p, meta={"op": "op2"})


def test_sweep_checkpoints_cross_between_packages(tmp_path):
    """The module is a copy: a sweep store one package writes, the other
    reads, chunk for chunk; a trace store likewise."""
    p = str(tmp_path / "ck.npz")
    jck.SweepCheckpoint(p, meta={"op": "op6"}).add_chunk(
        0, {"closure_pct": np.array([1.5, 2.5])})
    got = SweepCheckpoint(p, meta={"op": "op6"})
    np.testing.assert_array_equal(got.chunk(0)["closure_pct"], [1.5, 2.5])
    got.add_chunk(1, {"closure_pct": np.array([3.5])})
    back = jck.SweepCheckpoint(p, meta={"op": "op6"}).assembled(2)
    np.testing.assert_array_equal(back["closure_pct"], [1.5, 2.5, 3.5])
    q = str(tmp_path / "tr.npz")
    TraceCheckpoint(q, meta={"op": "op6"}).save([np.ones(3)], 64, 96)
    arrays, done, horizon = jck.TraceCheckpoint(q, meta={"op": "op6"}).load()
    assert (done, horizon) == (64, 96)
    np.testing.assert_array_equal(arrays[0], np.ones(3))


def test_scan_sweep_resumes_from_checkpoint(tmp_path):
    scen = rtt.scenario("fisheye")
    med = rtt.analytic_medium("fisheye")
    divs = np.arange(40.0, 24.0, -1.0)
    ds = 2 * np.pi / divs
    sizes = (divs + 1).astype(np.int64)
    p = str(tmp_path / "sweep.npz")
    kw = dict(n_turns=1, dtype=np.float64, chunk=8, checkpoint=p,
              device="cpu")
    full = tsw.run_candidates("op1", scen, med, ds, sizes - 1,
                              int(sizes.max()), **kw)
    j = jsw.run_candidates("op1", rt.scenario("fisheye"),
                           rt.analytic_medium("fisheye"), ds, sizes - 1,
                           int(sizes.max()), n_turns=1, dtype=np.float64)
    np.testing.assert_allclose(full["closure_pct"], j["closure_pct"],
                               rtol=1e-9)
    # the second run must come purely from the checkpoint: poisoned inputs
    # would give other numbers
    resumed = tsw.run_candidates("op1", scen, med, ds * 1.7, sizes - 1,
                                 int(sizes.max()), **kw)
    np.testing.assert_array_equal(resumed["closure_pct"], full["closure_pct"])


def test_fused_sweep_checkpoint_resume(tmp_path):
    scen = dataclasses.replace(rtt.scenario("interface"), s_max=2.0)
    ds = tconfig.SIGMA / np.asarray([2.9, 2.8, 2.7, 2.6, 2.5])
    sizes = np.ceil(scen.s_max / ds).astype(np.int64) + 1
    path = str(tmp_path / "fsweep.npz")
    kw = dict(checkpoint=path, chunk=2, device="cpu")
    full = tsw.run_candidates_fused("op8", scen, ds, sizes - 1,
                                    int(sizes.max()) - 1, **kw)
    again = tsw.run_candidates_fused("op8", scen, ds * 1.3, sizes - 1,
                                     int(sizes.max()) - 1, **kw)
    for k in ("mean_err", "max_err"):
        np.testing.assert_array_equal(again[k], full[k])
    store = SweepCheckpoint(path)
    assert store.meta["engine"] == "fused" and store.assembled(3) is not None


def _fisheye(r=64):
    theta0 = (np.pi / 2 + np.linspace(-0.02, 0.02, r)).astype(np.float32)
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    return pos0, theta0, tuple(rtt.scenario("fisheye").box)


@pytest.mark.parametrize("op", ["op6", "op7", "op11"])
def test_trace_checkpoint_resume_bit_identical(op, tmp_path):
    """A preempted segmented trace resumed from its checkpoint equals the
    uninterrupted run bit for bit (the saved state is the kernels' resume
    state: Kahan compensations, tangent, accumulators, masks).
    ``skip_frozen`` changes no state, so it is not part of the checkpoint's
    identity: a run with it resumes one without it."""
    pos0, theta0, box = _fisheye()
    gamma = 3.0 if op == "op11" else 1.0
    kw = dict(box=box, field="fisheye", segment=64, device="cpu",
              gamma=gamma, with_stats=op == "op11")
    straight = segmented_trace(op, pos0, theta0, 0.01, steps=600, **kw)
    path = str(tmp_path / "trace.npz")
    segmented_trace(op, pos0, theta0, 0.01, steps=256, checkpoint=path,
                    checkpoint_every=2, **kw)
    resumed = segmented_trace(op, pos0, theta0, 0.01, steps=600,
                              checkpoint=path, checkpoint_every=2,
                              skip_frozen=True, **kw)
    for a, b in zip(straight, resumed):
        if a is not None:
            assert torch.equal(a, b)
    names = TraceCheckpoint(path).meta["state"]
    assert names[:2] == ["x", "y"] and ("ang" in names) == (op == "op11")


def test_trace_checkpoint_guards(tmp_path):
    """The JAX package's guards: a different configuration is refused; a
    checkpoint whose last segment was clamped at its horizon refuses any
    other ``steps``; an unclamped one refuses a shorter horizon; compaction
    does not compose; the fan and box are part of the identity."""
    pos0, theta0, box = _fisheye()
    base = dict(box=box, field="fisheye", segment=64, device="cpu",
                checkpoint_every=1)
    p1 = str(tmp_path / "clamped.npz")
    done = segmented_trace("op6", pos0, theta0, 0.01, steps=96,
                           checkpoint=p1, **base)
    with pytest.raises(ValueError, match="COMPLETED 96-step"):
        segmented_trace("op6", pos0, theta0, 0.01, steps=192, checkpoint=p1,
                        **base)
    again = segmented_trace("op6", pos0, theta0, 0.01, steps=96,
                            checkpoint=p1, **base)
    assert torch.equal(done.pos, again.pos)

    p2 = str(tmp_path / "long.npz")
    segmented_trace("op6", pos0, theta0, 0.01, steps=256, checkpoint=p2,
                    **base)
    with pytest.raises(ValueError, match="already integrated"):
        segmented_trace("op6", pos0, theta0, 0.01, steps=128, checkpoint=p2,
                        **base)
    with pytest.raises(ValueError, match="different trace"):
        segmented_trace("op1", pos0, theta0, 0.01, steps=256, checkpoint=p2,
                        **base)
    with pytest.raises(ValueError, match="different trace"):
        segmented_trace("op6", pos0, theta0 + np.float32(0.1), 0.01,
                        steps=256, checkpoint=p2, **base)
    with pytest.raises(ValueError, match="different trace"):
        segmented_trace("op6", pos0, theta0, 0.01, steps=256, checkpoint=p2,
                        **{**base, "box": (-2.0, 2.0, -2.0, 2.0)})
    with pytest.raises(ValueError, match="compact"):
        segmented_trace("op6", pos0, theta0, 0.01, steps=256,
                        checkpoint=str(tmp_path / "x.npz"), compact=True,
                        **base)


def test_trace_checkpoint_pins_medium_tables(tmp_path):
    """Two stratified media with the same shapes but other samples do not
    share a checkpoint (the manifest fingerprints the kernel's table)."""
    y = np.linspace(-1.5, 1.5, 41)
    m1 = rtt.stratified_medium_from_samples(1.3 - 0.1 * y * y, y,
                                            device="cpu")
    m2 = rtt.stratified_medium_from_samples(1.3 - 0.2 * y * y, y,
                                            device="cpu")
    r = 32
    theta0 = np.linspace(-0.2, 0.2, r).astype(np.float32)
    pos0 = np.stack([np.zeros(r), np.linspace(-0.5, 0.5, r)],
                    -1).astype(np.float32)
    p = str(tmp_path / "med.npz")
    kw = dict(steps=128, box=(-1e6, 1e6, -1.5, 1.5), segment=64,
              checkpoint=p, checkpoint_every=1, device="cpu")
    segmented_trace("op6", pos0, theta0, 0.01, medium=m1, **kw)
    with pytest.raises(ValueError, match="different trace"):
        segmented_trace("op6", pos0, theta0, 0.01, medium=m2, **kw)
