"""``segmented_trace`` and ``grid_trace`` of the port (engine/segmented.py).

A segmented trace is a chain of resume-form launches with the global step
offset, so it must equal one launch bit for bit: every fused op, the
stratified tables with the Welford stats, live-ray compaction, and the
golden family under every schedule (its resume state carries the tangent).
Against the JAX package's ``segmented_trace`` (Pallas in interpret mode) it
holds to the bars the kernel tests hold final states to, at their trace lengths
(about 50 steps for fused ops, 20 for golden ones): fused 1e-5 in position
and 5e-5 in traveltime, golden 5e-4 — the JAX golden kernels re-derive the
tangent from the angle at each segment start, so only the bracket schedule
(16, 0) is held to JAX's one-shot run.

``grid_trace`` reads the parity Hermite node table directly: it must equal
``grid_trace_tiled`` (the per-cell table) bit for bit, and the JAX
supercell kernel to 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine import segmented as jseg  # noqa: E402
from raytracing_tpu.kernels import golden as jgold  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402

from raytracing_tpu_torch.engine import segmented as tseg  # noqa: E402
from raytracing_tpu_torch.kernels import fused as tfused  # noqa: E402
from raytracing_tpu_torch.kernels import golden as tgold  # noqa: E402

R = 64


def fisheye_fan(r=R):
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = (np.pi / 2 + np.linspace(-0.02, 0.02, r)).astype(np.float32)
    return pos0, theta0


def scen_fan(name, r=R):
    scen = rt.scenario(name)
    theta0 = np.linspace(scen.theta0[0], scen.theta0[-1], r).astype(np.float32)
    return np.tile(scen.pos0[:1].astype(np.float32), (r, 1)), theta0


def assert_same(a, b):
    """Every field of two final bundles equal to the bit."""
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("op", ["op1", "op6", "op7", "op12"])
def test_segmented_equals_one_launch(op):
    box = tuple(rt.scenario("fisheye").box)
    pos0, theta0 = fisheye_fan()
    ds, steps = np.float32(2 * np.pi / 100), 230
    one = tfused.fused_trace_final(pos0, theta0, ds, field="fisheye", op=op,
                                   steps=steps, box=box, device="cpu")
    seg = tseg.segmented_trace(op, pos0, theta0, ds, steps=steps, box=box,
                               field="fisheye", segment=37, device="cpu")
    assert_same(seg, one)


def test_segmented_matches_jax():
    box = tuple(rt.scenario("fisheye").box)
    pos0, theta0 = fisheye_fan(128)
    ds, steps = np.float32(2 * np.pi / 100), 60
    j = jseg.segmented_trace("op6", pos0, theta0, ds, steps=steps, box=box,
                             field="fisheye", segment=23, block_rays=128,
                             interpret=True)
    t = tseg.segmented_trace("op6", pos0, theta0, ds, steps=steps, box=box,
                             field="fisheye", segment=23, device="cpu")
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=1e-5)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), atol=5e-5)
    np.testing.assert_allclose(H.to_np(t.tangent), np.asarray(j.tangent),
                               atol=1e-5)


def test_segmented_with_stats_and_strat():
    scen = rt.scenario("vert")
    jm = jspline.build_stratified_medium("vert_heterogeneous", scen.box,
                                         dtype=np.float32)
    tm = H.port_medium(jm)
    pos0, theta0 = scen_fan("vert", 128)
    ds, steps, box = np.float32(0.02), 150, tuple(scen.box)
    one = tfused.fused_trace_final_strat(pos0, theta0, ds, tm, op="op8",
                                         steps=steps, box=box, device="cpu",
                                         with_stats=True)
    seg = tseg.segmented_trace("op8", pos0, theta0, ds, steps=steps, box=box,
                               medium=tm, segment=40, with_stats=True,
                               device="cpu")
    assert_same(seg, one)
    j = jseg.segmented_trace("op8", pos0, theta0, ds, steps=steps, box=box,
                             medium=jm, segment=40, block_rays=128,
                             interpret=True, with_stats=True)
    np.testing.assert_allclose(H.to_np(seg.pos), np.asarray(j.pos), atol=1e-5)
    np.testing.assert_array_equal(H.to_np(seg.mom_count),
                                  np.asarray(j.mom_count))
    np.testing.assert_allclose(H.to_np(seg.mom_mean), np.asarray(j.mom_mean),
                               atol=1e-5)


def test_compaction_preserves_results(monkeypatch):
    """Live-ray compaction changes no ray's final state, and the later
    segments really run on fewer rays.  A shrunken vert box makes most rays
    exit early at staggered steps."""
    scen = dataclasses.replace(rt.scenario("vert"), box=(-2.0, 5.0, -2.5, 0.0))
    pos0, theta0 = scen_fan("vert", 256)
    kw = dict(steps=100, box=tuple(scen.box), field="vert_heterogeneous",
              segment=16, device="cpu")
    plain = tseg.segmented_trace("op8", pos0, theta0, 0.05, **kw)
    sizes = []
    step = tfused.fused_step

    def counting(st, **k):
        sizes.append(st.x.shape[0])
        return step(st, **k)

    monkeypatch.setattr(tfused, "fused_step", counting)
    comp = tseg.segmented_trace("op8", pos0, theta0, 0.05, compact=True,
                                compact_every=2, compact_threshold=0.9, **kw)
    assert 0 < int(plain.active.sum()) < 256
    assert sizes[0] == 256 and sizes[-1] < 256
    assert_same(comp, plain)
    j = jseg.segmented_trace("op8", pos0, theta0, np.float32(0.05),
                             block_rays=128, interpret=True, compact=True,
                             compact_every=2, compact_threshold=0.9,
                             **{k: v for k, v in kw.items() if k != "device"})
    np.testing.assert_allclose(H.to_np(comp.pos), np.asarray(j.pos), atol=1e-5)
    np.testing.assert_array_equal(H.to_np(comp.active), np.asarray(j.active))


def test_golden_segmented_equals_one_launch():
    """Every golden schedule chains bit-identically (the resume state
    carries the tangent), with compaction too; under the bracket schedule
    (16, 0) the result also matches JAX's one-shot golden kernel."""
    scen = rt.scenario("aniso")
    pos0, theta0 = scen_fan("aniso", 128)
    ds, steps, box = np.float32(0.0193), 200, tuple(scen.box)
    parity = (16, 0)
    for sched in (None, parity):
        it, pol = sched or tgold.golden_schedule()
        one = tgold.golden_trace_final(pos0, theta0, ds, 3.0,
                                       field="vert_heterogeneous",
                                       op="op11", steps=steps, box=box,
                                       device="cpu", with_stats=True,
                                       gold_iters=it, polish=pol)
        for kw in (dict(), dict(skip_frozen=True),
                   dict(compact=True, compact_every=1,
                        compact_threshold=0.99)):
            seg = tseg.segmented_trace(
                "op11", pos0, theta0, ds, steps=steps, box=box,
                field="vert_heterogeneous", segment=48, with_stats=True,
                gamma=3.0, gold_schedule=sched, device="cpu", **kw)
            for name in ("pos", "traveltime", "dist_sim", "active",
                         "mom_count", "mom_mean", "mom_m2"):
                assert torch.equal(getattr(seg, name), getattr(one, name))
            assert torch.equal(seg.tangent[:, 0], torch.cos(one.angle))
    steps = 20
    j = jgold.golden_trace_final(pos0, theta0, ds, np.float32(3.0),
                                 field="vert_heterogeneous", op="op11",
                                 steps=steps, box=box, block_rays=128,
                                 interpret=True, with_stats=True, polish=0)
    seg = tseg.segmented_trace("op11", pos0, theta0, ds, steps=steps, box=box,
                               field="vert_heterogeneous", segment=8,
                               with_stats=True, gamma=3.0,
                               gold_schedule=parity, device="cpu")
    np.testing.assert_allclose(H.to_np(seg.pos), np.asarray(j.pos), atol=5e-4)
    np.testing.assert_allclose(H.to_np(seg.mom_mean), np.asarray(j.mom_mean),
                               atol=5e-4)


def test_segmented_refuses_what_it_cannot_trace():
    pos0, theta0 = fisheye_fan(8)
    kw = dict(steps=10, box=(-1.5, 1.5, -1.5, 1.5), device="cpu")
    with pytest.raises(ValueError, match="supports ops"):
        tseg.segmented_trace("op99", pos0, theta0, 0.01, field="fisheye", **kw)
    with pytest.raises(ValueError, match="field="):
        tseg.segmented_trace("op6", pos0, theta0, 0.01, **kw)
    for bad in (dict(segment=0), dict(compact=True, compact_every=0),
                dict(checkpoint_every=0)):
        with pytest.raises(ValueError, match=">= 1"):
            tseg.segmented_trace("op6", pos0, theta0, 0.01, field="fisheye",
                                 **kw, **bad)


# -- grid_trace: the node table ---------------------------------------------
@pytest.fixture(scope="module")
def hermite_grid():
    box = rt.scenario("fisheye").box
    gm = jspline.build_grid_medium("fisheye", box, 0.05, dtype=np.float32,
                                   backend="scipy")
    hm = jherm.build_hermite_medium(gm, dtype=np.float32)
    return hm, H.port_medium(hm)


@pytest.mark.parametrize("op", tfused.FUSED_OPS)
def test_grid_trace_equals_grid_trace_tiled(op, hermite_grid):
    """The node-table blend reads the same corner values in the same order
    as the per-cell rows: bit-identical, with and without the stats."""
    _, tm = hermite_grid
    box = tuple(rt.scenario("fisheye").box)
    pos0, theta0 = fisheye_fan()
    ds = np.float32(2 * np.pi / 60)
    for stats in (False, True):
        a = tseg.grid_trace(op, pos0, theta0, ds, tm, steps=59, box=box,
                            device="cpu", with_stats=stats)
        b = tseg.grid_trace_tiled(op, pos0, theta0, ds, tm, steps=59,
                                  box=box, device="cpu", with_stats=stats)
        assert_same(a, b)


def test_grid_trace_matches_jax_supercell(hermite_grid):
    jm, tm = hermite_grid
    scen = rt.scenario("fisheye")
    theta0 = np.linspace(0.3, np.pi / 2, 128).astype(np.float32)
    pos0 = np.tile(np.array([[0.4, 0.1]], np.float32), (128, 1))
    ds, steps = np.float32(0.01), 60
    j = jseg.grid_trace("op6", pos0, theta0, ds, jm, steps=steps,
                        box=tuple(scen.box), block_rays=128, interpret=True,
                        with_stats=True)
    t = tseg.grid_trace("op6", pos0, theta0, ds, tm, steps=steps,
                        box=tuple(scen.box), device="cpu", with_stats=True)
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=1e-5)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), atol=5e-5)
    np.testing.assert_allclose(H.to_np(t.mom_mean), np.asarray(j.mom_mean),
                               atol=1e-5)


def test_node_tables_and_refusals(hermite_grid):
    _, tm = hermite_grid
    nt = tseg.node_tables(tm)
    assert nt.table.shape == (tm.ny * tm.nx, 9)
    assert nt.table.dtype == torch.float32 and nt.table.is_contiguous()
    x = torch.tensor([0.3, -0.7], dtype=torch.float32)
    y = torch.tensor([0.1, 0.9], dtype=torch.float32)
    for a, b in zip(tfused.nag_fn(nt)(x, y),
                    tfused.nag_fn(tseg.grid_tables(tm))(x, y)):
        assert torch.equal(a, b)
    pos0, theta0 = fisheye_fan(8)
    kw = dict(steps=3, box=(-1.5, 1.5, -1.5, 1.5), device="cpu")
    from raytracing_tpu_torch.media.c1 import build_c1_medium
    c1 = build_c1_medium("fisheye", (-1.5, 1.5, -1.5, 1.5), 0.25,
                         device="cpu")
    with pytest.raises(ValueError, match="HermiteGridMedium"):
        tseg.grid_trace("op1", pos0, theta0, 0.1, c1, **kw)
    with pytest.raises(ValueError, match="supports"):
        tseg.grid_trace("op5", pos0, theta0, 0.1, tm, **kw)
    st = tgold.initial_state("op5", pos0, theta0, 1.0, field="fisheye",
                             with_stats=False, device="cpu")
    scal = tgold.golden_scalars(0.1, 1.0, 3, 0.0, 0, device="cpu")
    with pytest.raises(ValueError, match="node table"):
        tgold.golden_step(st, scal, field=nt, op="op5", steps=3,
                          box=kw["box"])
