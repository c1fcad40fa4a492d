"""The CUDA kernels against their plain PyTorch versions on the card: the
analytic-media kernels, the sampled-media ones (stratified tables and the
2-D grid, parity and C1), the grid sweep (per-ray step sizes) and the
node-table kernel; segmented_trace and the DELTA_S search on the card; the
three dynamic kernels, fast_dynamic and the eigenray solver on the card;
the four df32 kernels on their five media, with the df32 entry points;
the custom-medium kernels (a CustomMedium traced into its own library) and
fast_trace on a CustomMedium; the plain versions replayed from a CUDA
graph against their eager loops; the refill loop of fused_step and
fused_step_strat on the interface fan (1 to 8,209 rays, op6 and op7 with
the stats, a short step limit, a resume chain); the fused 3-D kernels (analytic and
grid3) with fast_trace3's routes; the 3-D dynamic kernels (analytic and
grid3) against their plain version, also where their shared-reciprocal
quotients leave the fast path, with fast_dynamic3's routes and the 3-D
eigenray solver on the card; and that division (csrc/common.cuh div_by)
against IEEE division on all 2^32 numerators of 60 and 360 and 2^28
seeded pairs.

Marked ``cuda``; every test skips where there is no CUDA device.  The file
imports neither jax nor the JAX package, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch_port_helpers as H
from torch_port_helpers import cuda_device  # noqa: F401  (fixture)

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import df_grid as tdg  # noqa: E402
from raytracing_tpu_torch.engine import segmented as seg  # noqa: E402
from raytracing_tpu_torch.bench import replay  # noqa: E402
from raytracing_tpu_torch.kernels import custom as kc  # noqa: E402
from raytracing_tpu_torch.kernels import df as kdf  # noqa: E402
from raytracing_tpu_torch.kernels import dynamic as kd  # noqa: E402
from raytracing_tpu_torch.kernels import dynamic3d as kd3  # noqa: E402
from raytracing_tpu_torch.kernels import fisheye as kf  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402
from raytracing_tpu_torch.kernels import fused3d as kf3  # noqa: E402
from raytracing_tpu_torch.kernels import golden as kg  # noqa: E402

pytestmark = pytest.mark.cuda
R = 3000          # not a multiple of the 128-thread block: the ragged edge


def _fan(field):
    rng = np.random.default_rng(1)
    if field == "fisheye":
        pos0 = np.tile(np.array([[1.0, 0.0]]), (R, 1))
        return pos0, np.pi / 2 + rng.uniform(-0.01, 0.01, R), 0.05, \
            (-1.5, 1.5, -1.5, 1.5)
    if field == "interface":
        pos0, theta0 = H.fan_near_interface(rng, R)
        return pos0, theta0, 0.01, H.INTERFACE_BOX
    pos0, theta0 = H.fan_vert(rng, R)
    return pos0, theta0, 0.05, H.VERT_BOX


def _same(a, b, atol):
    for x, y in zip(a, b):
        if x is None:
            continue
        if x.dtype == torch.bool:
            assert torch.equal(x, y)
        else:
            assert float((x - y).abs().max()) <= atol


def test_fisheye_kernel_matches_plain(cuda_device):
    pos0, theta0, ds, _ = _fan("fisheye")
    x, y, th = kfu._vectors(pos0, theta0, cuda_device)
    ux, uy = torch.cos(th), torch.sin(th)
    before = kf.KERNEL.launches
    got = kf.fisheye_op1(x, y, ux, uy, ds, 200)
    assert kf.KERNEL.launches == before + 1
    _same(got, kf.fisheye_op1_plain(x, y, ux, uy, ds, 200), 1e-5)


@pytest.mark.parametrize("field", kfu.FUSED_FIELDS)
@pytest.mark.parametrize("op", kfu.FUSED_OPS)
def test_fused_kernel_matches_plain(op, field, cuda_device):
    pos0, theta0, ds, box = _fan(field)
    st = kfu.initial_state(op, pos0, theta0, field=field,
                           with_stats=field != "fisheye", device=cuda_device)
    kw = dict(field=field, op=op, steps=120, delta_s=ds, step_limit=120,
              offset=0.0, box=box)
    before = kfu.KERNEL.launches
    got = kfu.fused_step(st, **kw)
    assert kfu.KERNEL.launches == before + 1
    _same(got, kfu.fused_step_plain(st, **kw),
          2e-4 if op == "op7" or field == "interface" else 1e-5)
    # k + (n - k) steps equal n steps
    part = kfu.fused_step(st, **{**kw, "steps": 50})
    _same(got, kfu.fused_step(part, **{**kw, "steps": 70, "offset": 50.0}), 0.0)


@pytest.mark.parametrize("field", kfu.FUSED_FIELDS)
@pytest.mark.parametrize("op", tuple(kg.GOLDEN_OPS))
def test_golden_kernel_matches_plain(op, field, cuda_device):
    pos0, theta0, ds, box = _fan(field)
    gamma = 3.0 if field == "vert_heterogeneous" else 1.0
    for iters, polish in ((None, None), (None, 0), (12, 2)):
        it, pol = kg.golden_schedule(polish, iters)
        st = kg.initial_state(op, pos0, theta0, gamma, field=field,
                              with_stats=True, device=cuda_device)
        scal = kg.golden_scalars(ds, gamma, 60, 0.0, it, device=cuda_device)
        got = kg.golden_step(st, scal, field=field, op=op, steps=60, box=box,
                             gold_iters=it, polish=pol)
        want = kg.golden_step_plain(st, scal, field=field, op=op, steps=60,
                                    box=box, iters=it, polish=pol)
        _same(got, want, 5e-4)


def test_fast_trace_runs_on_the_card(cuda_device):
    scen = rtt.scenario("aniso")
    res = rtt.fast_trace("op11", scen, rtt.analytic_medium(scen.field),
                         delta_s=0.05, pos0=scen.pos0, theta0=scen.theta0,
                         stats=True, device=cuda_device)
    assert res.pos.is_cuda and res.engine == "golden"
    assert torch.isfinite(res.pos).all() and not res.active.any()


def test_wrapper_refuses_mixed_devices(cuda_device):
    pos0, theta0, ds, box = _fan("vert_heterogeneous")
    st = kg.initial_state("op11", pos0, theta0, 3.0,
                          field="vert_heterogeneous", with_stats=False,
                          device=cuda_device)
    scal = kg.golden_scalars(ds, 3.0, 5, 0.0, 0, device="cpu")
    with pytest.raises(ValueError, match="bundle"):
        kg.golden_step(st, scal, field="vert_heterogeneous", op="op11",
                       steps=5, box=box)
    with pytest.raises(ValueError, match="contiguous"):
        kfu.fused_step(st._replace(x=st.x.cpu()), field="vert_heterogeneous",
                       op="op1", steps=1, delta_s=ds, step_limit=1, box=box)


def _strat_tables(field, family, device):
    scen = rtt.scenario("interface" if field == "interface" else "vert")
    build = (rtt.build_stratified_medium if family == "parity"
             else rtt.build_c1_stratified)
    med = build(field, scen.box, device=device)
    box = H.INTERFACE_BOX if field == "interface" else H.VERT_BOX
    med = rtt.compact_for_trace(med, box, 0.05)
    return kfu.strat_tables(med)


def _grid_tables(family, device):
    box = rtt.scenario("fisheye").box
    if family == "parity":
        med = rtt.build_hermite_medium(
            rtt.build_grid_medium("fisheye", box, 0.05, device=device))
    else:
        med = rtt.build_c1_medium("fisheye", box, 0.05, device=device)
    return seg.grid_tables(med)


MEDIA = [("strat", "interface", "parity"), ("strat", "interface", "c1"),
         ("strat", "vert_heterogeneous", "parity"),
         ("strat", "vert_heterogeneous", "c1"),
         ("grid", "fisheye", "parity"), ("grid", "fisheye", "c1")]


def _tables(kind, field, family, device):
    if kind == "strat":
        return _strat_tables(field, family, device)
    return _grid_tables(family, device)


@pytest.mark.parametrize("kind,field,family", MEDIA)
@pytest.mark.parametrize("op", kfu.FUSED_OPS)
def test_fused_sampled_kernels_match_plain(op, kind, field, family,
                                           cuda_device):
    tables = _tables(kind, field, family, cuda_device)
    pos0, theta0, ds, box = _fan(field)
    st = kfu.initial_state(op, pos0, theta0, field=tables,
                           with_stats=kind == "strat", device=cuda_device)
    kw = dict(field=tables, op=op, steps=120, delta_s=ds, step_limit=120,
              offset=0.0, box=box)
    info = kfu.KERNEL_STRAT if kind == "strat" else kfu.KERNEL_GRID
    before = info.launches
    got = kfu.fused_step(st, **kw)
    assert info.launches == before + 1
    _same(got, kfu.fused_step_plain(st, **kw),
          2e-4 if op == "op7" or field == "interface" else 1e-5)
    part = kfu.fused_step(st, **{**kw, "steps": 50})
    _same(got, kfu.fused_step(part, **{**kw, "steps": 70, "offset": 50.0}), 0.0)


@pytest.mark.parametrize("kind,field,family",
                         [m for m in MEDIA if m[1] != "interface"])
@pytest.mark.parametrize("op", tuple(kg.GOLDEN_OPS))
def test_golden_sampled_kernels_match_plain(op, kind, field, family,
                                            cuda_device):
    tables = _tables(kind, field, family, cuda_device)
    pos0, theta0, ds, box = _fan(field)
    gamma = 3.0 if field == "vert_heterogeneous" else 1.0
    info = kg.KERNEL_STRAT if kind == "strat" else kg.KERNEL_GRID
    it, pol = kg.golden_schedule()
    st = kg.initial_state(op, pos0, theta0, gamma, field=tables,
                          with_stats=True, device=cuda_device)
    scal = kg.golden_scalars(ds, gamma, 60, 0.0, it, device=cuda_device)
    before = info.launches
    got = kg.golden_step(st, scal, field=tables, op=op, steps=60, box=box)
    assert info.launches == before + 1
    _same(got, kg.golden_step_plain(st, scal, field=tables, op=op, steps=60,
                                    box=box, iters=it, polish=pol), 5e-4)


def test_cuda_state_on_a_cpu_medium_raises(cuda_device):
    tables = _strat_tables("vert_heterogeneous", "parity", "cpu")
    pos0, theta0, ds, box = _fan("vert_heterogeneous")
    st = kfu.initial_state("op1", pos0, theta0, field="vert_heterogeneous",
                           with_stats=False, device=cuda_device)
    with pytest.raises(ValueError, match="medium table"):
        kfu.fused_step(st, field=tables, op="op1", steps=1, delta_s=ds,
                       step_limit=1, box=box)


@pytest.mark.parametrize("family", ["parity", "c1"])
def test_fast_trace_runs_sampled_media_on_the_card(family, cuda_device):
    vert = rtt.scenario("vert")
    fish = rtt.scenario("fisheye")
    if family == "parity":
        strat = rtt.build_stratified_medium(vert.field, vert.box,
                                            device=cuda_device)
        grid = rtt.build_grid_medium("fisheye", fish.box, 0.05,
                                     device=cuda_device)
    else:
        strat = rtt.build_c1_stratified(vert.field, vert.box,
                                        device=cuda_device)
        grid = rtt.build_c1_medium("fisheye", fish.box, 0.05,
                                   device=cuda_device)
    before = [k.launches for k in (kfu.KERNEL_STRAT, kfu.KERNEL_GRID,
                                   kg.KERNEL_STRAT, kg.KERNEL_GRID)]
    kw = dict(delta_s=0.05, pos0=vert.pos0, theta0=vert.theta0,
              device=cuda_device)
    f = rtt.fast_trace("op8", vert, strat, stats=True, **kw)
    g = rtt.fast_trace("op11", vert, strat, stats=True, **kw)
    kw = dict(delta_s=2 * np.pi / 300, pos0=fish.pos0, theta0=fish.theta0,
              steps=299, device=cuda_device)
    h = rtt.fast_trace("op1", fish, grid, **kw)
    k = rtt.fast_trace("op5", fish, grid, **kw)
    assert (f.engine, g.engine, h.engine, k.engine) == (
        "fused-strat", "golden-strat", "grid", "grid")
    after = [k_.launches for k_ in (kfu.KERNEL_STRAT, kfu.KERNEL_GRID,
                                    kg.KERNEL_STRAT, kg.KERNEL_GRID)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    for r in (f, g, h, k):
        assert r.pos.is_cuda and torch.isfinite(r.pos).all()


def test_fused_sweep_grid_matches_plain(cuda_device):
    """One ray a candidate, each at its own step size and step limit: the
    sweep kernel against its plain version to the bit, every fused op, on
    both grid forms; and each candidate equals its own one-ray launch."""
    fish = rtt.scenario("fisheye")
    divs = np.arange(120.0, 20.0, -1.0)
    ds = torch.tensor(2 * np.pi / divs, dtype=torch.float32,
                      device=cuda_device)
    lim = torch.tensor(divs - 1, dtype=torch.float32, device=cuda_device)
    n = len(divs)
    pos0 = np.tile(np.array([[1.0, 0.0]]), (n, 1))
    theta0 = np.full(n, np.pi / 2)
    for family in ("parity", "c1"):
        tables = _grid_tables(family, cuda_device)
        for op in kfu.FUSED_OPS:
            st = kfu.initial_state(op, pos0, theta0, field=tables,
                                   with_stats=False, device=cuda_device)
            before = kfu.KERNEL_SWEEP_GRID.launches
            got = kfu.fused_sweep_grid(st, ds, lim, field=tables, op=op,
                                       steps=int(divs.max()), box=fish.box)
            assert kfu.KERNEL_SWEEP_GRID.launches == before + 1
            want = kfu.fused_step_plain(st, field=tables, op=op,
                                        steps=int(divs.max()), delta_s=ds,
                                        step_limit=lim, offset=0.0,
                                        box=fish.box)
            _same(got, want, 0.0)
            for i in (0, n // 2, n - 1):
                one = kfu.fused_step(
                    type(st)(*(None if t is None else t[i:i + 1].contiguous()
                               for t in st)),
                    field=tables, op=op, steps=int(divs.max()),
                    delta_s=float(ds[i]), step_limit=float(lim[i]),
                    box=fish.box)
                assert torch.equal(one.x, got.x[i:i + 1])
                assert torch.equal(one.y, got.y[i:i + 1])


@pytest.mark.parametrize("op", kfu.FUSED_OPS)
def test_fused_step_nodes_matches_plain(op, cuda_device):
    """The node-table kernel against its plain version to the bit, with
    and without stats, and against the per-cell grid kernel."""
    box = rtt.scenario("fisheye").box
    med = rtt.build_hermite_medium(
        rtt.build_grid_medium("fisheye", box, 0.05, device=cuda_device))
    nodes, cells = seg.node_tables(med), seg.grid_tables(med)
    pos0, theta0, ds, fbox = _fan("fisheye")
    for stats in (False, True):
        st = kfu.initial_state(op, pos0, theta0, field=nodes,
                               with_stats=stats, device=cuda_device)
        kw = dict(op=op, steps=120, delta_s=ds, step_limit=120, offset=0.0,
                  box=fbox)
        before = kfu.KERNEL_NODES.launches
        got = kfu.fused_step(st, field=nodes, **kw)
        assert kfu.KERNEL_NODES.launches == before + 1
        _same(got, kfu.fused_step_plain(st, field=nodes, **kw), 0.0)
        _same(got, kfu.fused_step(st, field=cells, **kw), 0.0)


def test_segmented_trace_and_search_on_the_card(cuda_device):
    """segmented_trace with compaction equals one launch on the card; a
    small grid search goes through fused_sweep_grid by default."""
    from raytracing_tpu_torch.parallel import sweep

    vert = rtt.scenario("vert")
    pos0, theta0, ds, box = _fan("vert_heterogeneous")
    one = kfu.fused_trace_final(pos0, theta0, ds, field=vert.field,
                                op="op8", steps=300, box=box,
                                device=cuda_device)
    part = seg.segmented_trace("op8", pos0, theta0, ds, steps=300, box=box,
                               field=vert.field, segment=32, compact=True,
                               compact_every=1, device=cuda_device)
    _same(part, one, 0.0)
    fish = rtt.scenario("fisheye")
    grid = rtt.build_grid_medium("fisheye", fish.box, 0.05,
                                 device=cuda_device)
    before = kfu.KERNEL_SWEEP_GRID.launches
    res = sweep.delta_s_search("op1", fish, grid, n_turns=1,
                               divisors=np.arange(40.0, 15.0, -1.0),
                               device=cuda_device)
    assert res.engine == "fused" and res.index is not None
    assert kfu.KERNEL_SWEEP_GRID.launches == before + 1


# -- the dynamic kernels ------------------------------------------------------
DYN_MEDIA = [("analytic", f, None) for f in kd.DYN_FUSED_FIELDS] + [
    m for m in MEDIA if m != ("strat", "interface", "c1")]


def _dyn_field(kind, field, family, device):
    return field if kind == "analytic" else _tables(kind, field, family,
                                                    device)


@pytest.mark.parametrize("kind,field,family", DYN_MEDIA)
@pytest.mark.parametrize("op", kd.DYN_FUSED_OPS)
def test_dynamic_kernels_match_plain(op, kind, field, family, cuda_device):
    """Each dynamic kernel equals its plain version in all 18 planes to the
    bit, and k + (n - k) steps equal n."""
    tab = _dyn_field(kind, field, family, cuda_device)
    pos0, theta0, ds, box = _fan(field)
    st = kd.initial_dyn_state(pos0, theta0, device=cuda_device)
    kw = dict(field=tab, op=op, steps=120, delta_s=ds, step_limit=120,
              offset=0.0, box=box)
    info = kd.KERNELS[("analytic", "strat", "grid").index(kind)]
    before = info.launches
    got = kd.dynamic_step(st, **kw)
    assert info.launches == before + 1
    want = kd.dynamic_step_plain(st, **kw)
    for name, a, b in zip(kd.DynState._fields, got, want):
        assert torch.equal(a, b), name
    part = kd.dynamic_step(st, **{**kw, "steps": 50})
    two = kd.dynamic_step(part, **{**kw, "steps": 70, "offset": 50.0})
    for name, a, b in zip(kd.DynState._fields, got, two):
        assert torch.equal(a, b), name


def test_fast_dynamic_and_eigenrays_on_the_card(cuda_device):
    """fast_dynamic launches the three kernels (golden ops run the scan
    tier), and the eigenray solver runs on the card at float64."""
    fish = rtt.scenario("fisheye")
    vert = rtt.scenario("vert")
    before = [k.launches for k in kd.KERNELS]
    fkw = dict(delta_s=2 * np.pi / 300, pos0=fish.pos0, theta0=fish.theta0,
               steps=299, device=cuda_device)
    engines = [
        rtt.fast_dynamic("op6", fish, rtt.analytic_medium("fisheye"),
                         **fkw)[1],
        rtt.fast_dynamic("op6", vert, rtt.build_c1_stratified(
            vert.field, vert.box, device=cuda_device), delta_s=0.05,
            pos0=vert.pos0, theta0=vert.theta0, device=cuda_device)[1],
        rtt.fast_dynamic("op6", fish, rtt.build_grid_medium(
            "fisheye", fish.box, 0.05, device=cuda_device), **fkw)[1],
        rtt.fast_dynamic("op5", fish, rtt.analytic_medium("fisheye"),
                         **{**fkw, "steps": 20})[1]]
    assert engines == ["dynamic-kernel", "dynamic-kernel-strat",
                       "dynamic-kernel-grid", "dynamic-scan"]
    assert [k.launches - b for k, b in zip(kd.KERNELS, before)] == [1, 1, 1]
    eig = rtt.find_eigenrays(
        "op6", rtt.analytic_medium("vert_heterogeneous"), source=(0, 0),
        receivers=[(3, -1)], delta_s=0.005, max_size=2000,
        box=(-2, 5, -2.5, 1), fan=(-1.2, 0.6, 128), tol=1e-12,
        device=cuda_device)
    t_exact = np.arccosh(1 + 4.0 * 10.0 / (2 * 18.0 * 16.0)) / 2.0
    assert len(eig.theta0) == 1 and bool(eig.converged[0])
    assert abs(eig.traveltime[0] / t_exact - 1) < 2e-7


# -- the df32 kernels ---------------------------------------------------------
DF_MEDIA = kdf.DF_FIELDS + ("grid", "c1", "profile")


def _df_case(kind, device):
    """(medium, launch state, delta_s) of one df32 kernel test: the analytic
    fields from their launch state, the split-word media (the coarse
    fisheye grids, the Munk profile) from their split one."""
    box = rtt.scenario("fisheye").box
    fish = H.fisheye_df_fan(R, jitter=0.2, seed=2)
    if kind in kdf.DF_FIELDS:
        (pos0, theta0), ds = ((fish, 2 * np.pi / 300) if kind == "fisheye"
                              else (H.fan_vert(np.random.default_rng(2), R),
                                    0.0193))
        return kind, kdf.initial_df_state(pos0, theta0, device=device), ds
    if kind == "profile":
        med = tdg.df_c1_profile_from_samples(*H.munk_profile(), device=device)
        (pos0, theta0), ds = H.channel_fan(R, seed=2), 0.01
    else:
        build = (tdg.build_df_grid_medium if kind == "grid"
                 else tdg.build_df_c1_medium)
        med = build("fisheye", box, 0.05, device=device)
        (pos0, theta0), ds = fish, 2 * np.pi / 300
    return med, tdg.split_state(pos0, theta0, device=device), ds


@pytest.mark.parametrize("kind", DF_MEDIA)
def test_df_kernels_match_plain(kind, cuda_device):
    """Each df32 kernel equals its plain version in all 8 planes to the bit,
    and k + (n - k) steps equal n."""
    med, st, ds = _df_case(kind, cuda_device)
    info = kdf.KERNELS[0 if kind in kdf.DF_FIELDS
                       else ("grid", "c1", "profile").index(kind) + 1]
    before = info.launches
    got = kdf.df_step(st, med, ds, 60)
    assert info.launches == before + 1
    want = kdf.df_step_plain(st, med, ds, 60)
    for name, a, b in zip(kdf.DfState._fields, got, want):
        assert torch.equal(a, b), name
    two = kdf.df_step(kdf.df_step(st, med, ds, 25), med, ds, 35)
    for name, a, b in zip(kdf.DfState._fields, got, two):
        assert torch.equal(a, b), name


def test_df_entry_points_on_the_card(cuda_device):
    """fast_trace(precision="high") and df_grid_trace launch the df32
    kernels; DfEvalProfile evaluates on the card as on the CPU, bit for bit;
    trace_dynamic gives the same tangent inside torch.inference_mode()."""
    fish = rtt.scenario("fisheye")
    pos0, theta0 = H.fisheye_df_fan(R, jitter=0.01)
    before = [k.launches for k in kdf.KERNELS]
    res = rtt.fast_trace("op12", fish, rtt.analytic_medium("fisheye"),
                         delta_s=2 * np.pi / 300, pos0=pos0, theta0=theta0,
                         divisor=300, n_turns=1, precision="high",
                         device=cuda_device)
    assert res.engine == "df32" and res.pos.dtype == torch.float64
    for kind in ("grid", "c1", "profile"):
        med, _, ds = _df_case(kind, cuda_device)
        rtt.df_grid_trace(pos0[:64], theta0[:64], ds, med, steps=30,
                          segment=16, device=cuda_device)
    assert [k.launches - b for k, b in zip(kdf.KERNELS, before)] == [
        1, 2, 2, 2]
    samples, depth = H.munk_profile()
    y = np.random.default_rng(5).uniform(-3.2, 0.2, 1 << 16)
    x = np.zeros_like(y)
    on_card = rtt.df_eval_profile_medium(samples, depth, device=cuda_device)
    on_cpu = rtt.df_eval_profile_medium(samples, depth, device="cpu")
    a = on_card.n_and_grad(torch.as_tensor(x, device=cuda_device),
                           torch.as_tensor(y, device=cuda_device))
    b = on_cpu.n_and_grad(torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(a[0].cpu(), b[0])
    assert torch.equal(a[1][1].cpu(), b[1][1])
    kw = dict(delta_s=2 * np.pi / 300, device=cuda_device, mode="metrics",
              dtype=torch.float64, pos0=pos0[:256], theta0=theta0[:256],
              max_size=301)
    out = rtt.trace_dynamic("op6", fish, rtt.analytic_medium("fisheye"), **kw)
    with torch.inference_mode():
        inside = rtt.trace_dynamic("op6", fish,
                                   rtt.analytic_medium("fisheye"), **kw)
    for f in ("q", "dtheta", "kmah"):
        assert torch.equal(getattr(out, f), getattr(inside, f)), f
    assert bool((out.kmah == 1).all())


def _custom_media():
    """A dual-number field and a grad_fn field (the interface logistic)."""
    sq2, thck = 1.4142135623730951, 0.005

    def grad(x, y):
        s = torch.sigmoid(y / thck)
        return torch.zeros_like(x), -(sq2 - 1.0) * s * (1.0 - s) / thck

    return {"fisheye": rtt.CustomMedium(
                lambda x, y: 1.2 + 0.1 * torch.sin(x) * torch.cos(y)),
            "interface": rtt.CustomMedium(
                lambda x, y: sq2 - (sq2 - 1.0) * torch.sigmoid(y / thck),
                grad_fn=grad)}


def _planes_equal(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("field", ("fisheye", "interface"))
def test_custom_kernels_match_plain(field, cuda_device):
    """The generated fused (op6, op7) and golden (op11, op5 in the
    bracket-parity schedule) kernels equal their plain version to the bit."""
    pos0, theta0, ds, box = _fan(field)
    cf = kc.trace_custom(_custom_media()[field])
    for op in ("op6", "op7"):
        st = kfu.initial_state(op, pos0, theta0, field=cf,
                               with_stats=field != "fisheye",
                               device=cuda_device)
        kw = dict(field=cf, op=op, steps=120, delta_s=ds, step_limit=120,
                  offset=0.0, box=box)
        before = kc.KERNEL_FUSED.launches
        got = kfu.fused_step(st, **kw)
        assert kc.KERNEL_FUSED.launches == before + 1
        _planes_equal(got, kfu.fused_step_plain(st, **kw))
    for op, polish in (("op11", None), ("op5", 0)):
        it, pol = kg.golden_schedule(polish)
        st = kg.initial_state(op, pos0, theta0, 1.0, field=cf,
                              with_stats=True, device=cuda_device)
        scal = kg.golden_scalars(ds, 1.0, 60, 0.0, it, device=cuda_device)
        before = kc.KERNEL_GOLDEN.launches
        got = kg.golden_step(st, scal, field=cf, op=op, steps=60, box=box,
                             gold_iters=it, polish=pol)
        assert kc.KERNEL_GOLDEN.launches == before + 1
        _planes_equal(got, kg.golden_step_plain(st, scal, field=cf, op=op,
                                                steps=60, box=box, iters=it,
                                                polish=pol))


#: one field a primitive of kernels/custom.py (dual numbers): the kernel
#: calls the libdevice function PyTorch's CUDA kernel calls
PRIMITIVE_FIELDS = {
    "sin": lambda x, y: 1.5 + 0.1 * torch.sin(3.0 * x + y),
    "cos": lambda x, y: 1.5 + 0.1 * torch.cos(x * y + 2.0),
    "tan": lambda x, y: 1.5 + 0.1 * torch.tan(0.3 * x - 0.2 * y),
    "tanh": lambda x, y: 1.5 + 0.1 * torch.tanh(2.0 * x + y),
    "atan": lambda x, y: 1.5 + 0.1 * torch.atan(3.0 * x - y),
    "atan2": lambda x, y: 1.5 + 0.1 * torch.atan2(y, x + 2.5),
    "exp": lambda x, y: 1.5 + 0.1 * torch.exp(0.5 * x - y),
    "expm1": lambda x, y: 1.5 + 0.1 * torch.expm1(x * y),
    "log": lambda x, y: 1.5 + 0.1 * torch.log(x + 3.0 + y * y),
    "log1p": lambda x, y: 1.5 + 0.1 * torch.log1p(x * x + y * y),
    "sqrt_rsqrt": lambda x, y: torch.sqrt(x + 3.0) * torch.rsqrt(y + 3.0),
    "sigmoid": lambda x, y: 1.5 - 0.4 * torch.sigmoid(y / 0.05),
    "div_pow": lambda x, y: ((x + 3.0) / (y + 4.0) + x / 7.0 + y ** 2
                             + (x + 3.0) ** -0.5 + (y + 3.0) ** -2),
    "selects": lambda x, y: (6.0 + torch.where(x > y, x * 0.5, y)
                             + torch.clamp(x, -0.5, 0.5) + abs(y - 0.2)
                             + torch.minimum(x, y) + torch.maximum(x, y)),
}


def test_custom_primitives_match_plain(cuda_device):
    """Every primitive of the rule table through the fused op6 kernel for
    50 steps on 3,000 rays against its plain version, every plane to the
    bit (the libraries built together, one nvcc each)."""
    fields = {k: kc.trace_custom(rtt.CustomMedium(f))
              for k, f in PRIMITIVE_FIELDS.items()}
    kc.build_libraries([(f, "fused", "op6") for f in fields.values()])
    rng = np.random.default_rng(5)
    pos0 = rng.uniform(-1.0, 1.0, (R, 2))
    theta0 = rng.uniform(0.0, 2.0 * np.pi, R)
    box = (-1.5, 1.5, -1.5, 1.5)
    for name, cf in fields.items():
        st = kfu.initial_state("op6", pos0, theta0, field=cf,
                               with_stats=False, device=cuda_device)
        kw = dict(field=cf, op="op6", steps=50, delta_s=0.01, step_limit=50,
                  offset=0.0, box=box)
        _planes_equal(kfu.fused_step(st, **kw), kfu.fused_step_plain(st, **kw))


def test_fast_trace_custom_on_the_card(cuda_device):
    """One launch a trace, the engines JAX names, and the refusals."""
    scen = rtt.scenario("aniso")
    med = rtt.CustomMedium(lambda x, y: 1.0 / (18.0 + 2.0 * y))
    kw = dict(delta_s=0.05, pos0=scen.pos0, theta0=scen.theta0,
              device=cuda_device)
    for op, engine, info in (("op11", "golden-custom", kc.KERNEL_GOLDEN),
                             ("op6", "fused-custom", kc.KERNEL_FUSED)):
        before = info.launches
        res = rtt.fast_trace(op, scen, med, **kw)
        assert res.engine == engine and info.launches == before + 1
        ref = rtt.fast_trace(op, scen, rtt.analytic_medium(scen.field), **kw)
        assert torch.equal(res.pos, ref.pos)   # the same rounding as vert's
    with pytest.raises(ValueError, match="stats"):
        rtt.fast_trace("op11", scen, med, stats=True, **kw)
    with pytest.raises(ValueError, match="erf"):
        rtt.fast_trace("op6", scen, rtt.CustomMedium(
            lambda x, y: 1.0 + torch.erf(y)), **kw)


@pytest.mark.parametrize("field", ("interface", "vert_heterogeneous"))
def test_replayed_plain_equals_eager(field, cuda_device):
    """The plain versions replayed from a CUDA graph (bench/replay.py)
    equal their eager loops to the bit: golden op11 (default schedule) and
    op5 (bracket parity), and op7 with its order ramp from offsets 0 and
    1; a step limit below the step count."""
    pos0, theta0, ds, box = _fan(field)
    for op, polish in (("op11", None), ("op5", 0)):
        it, pol = kg.golden_schedule(polish)
        st = kg.initial_state(op, pos0, theta0, 3.0, field=field,
                              with_stats=True, device=cuda_device)
        scal = kg.golden_scalars(ds, 3.0, 30, 0.0, it, device=cuda_device)
        kw = dict(field=field, op=op, steps=40, box=box, iters=it,
                  polish=pol)
        _planes_equal(replay.golden_plain(st, scal, **kw),
                      kg.golden_step_plain(st, scal, **kw))
    st = kfu.initial_state("op7", pos0, theta0, field=field, with_stats=True,
                           device=cuda_device)
    for offset in (0.0, 1.0):
        kw = dict(field=field, op="op7", steps=40, delta_s=ds,
                  step_limit=35, offset=offset, box=box)
        _planes_equal(replay.fused_plain(st, **kw),
                      kfu.fused_step_plain(st, **kw))


# -- the refill loop of fused_step and fused_step_strat (csrc/fused.cuh) -------

def _interface_fan(n, media, device, seed=4):
    """The interface scenario's launch angles resized to ``n`` rays, with
    +-1e-3 rad of jitter, and the medium of ``media``: the analytic field at
    SIGMA/5 (rays live 561-2168 steps) or the parity table at the reference
    table's op6 step (288-1120)."""
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.bench import jittered, launch_fan
    from raytracing_tpu_torch.calibrated import calibrated_with_fallback
    scen = rtt.scenario("interface")
    pos0, theta0 = launch_fan(scen, n)
    theta0 = jittered(theta0, np.random.default_rng(seed))
    if media == "analytic":
        ds = config.SIGMA / 5.0
        return "interface", pos0, theta0, ds, scen.max_size(ds) - 1, \
            tuple(scen.box)
    ds, div = calibrated_with_fallback("op6", "interface")
    med = rtt.compact_for_trace(rtt.build_stratified_medium(
        "interface", scen.box, device=device), scen.box, ds)
    return kfu.strat_tables(med), pos0, theta0, float(ds), \
        scen.max_size(ds, div, 1) - 1, tuple(scen.box)


@pytest.mark.parametrize("media", ("analytic", "strat"))
@pytest.mark.parametrize("n", (1, 42, 4097))
def test_refill_kernels_match_plain(n, media, cuda_device):
    """fused_step and fused_step_strat, whose persistent loop refills the
    lanes of frozen rays, against the plain version at full depth on the
    interface fan, every plane to the bit; each ray frozen by the box; the
    grid no larger than the rays fill."""
    field, pos0, theta0, ds, steps, box = _interface_fan(n, media,
                                                         cuda_device)
    kernel = kfu.KERNEL if media == "analytic" else kfu.KERNEL_STRAT
    st = kfu.initial_state("op6", pos0, theta0, field=field,
                           with_stats=False, device=cuda_device)
    kw = dict(field=field, op="op6", steps=steps, delta_s=ds,
              step_limit=steps, offset=0.0, box=box)
    before = kernel.launches
    out = kfu.fused_step(st, **kw)
    assert kernel.launches == before + 1
    _planes_equal(out, replay.fused_plain(st, **kw))
    assert not bool(out.active.any())
    assert 1 <= kfu.refill_grid(field, "op6", n) <= -(-n // 128)


@pytest.mark.parametrize("media", ("analytic", "strat"))
def test_refill_window_stats_limit_and_resume(media, cuda_device):
    """op7's window and the Welford stats carried across refills, a step
    limit shorter than most lifetimes, and a resume chain of uneven
    segments, all equal to the plain version and to one launch."""
    field, pos0, theta0, ds, steps, box = _interface_fan(2 * 4096 + 17,
                                                         media, cuda_device)
    st = kfu.initial_state("op7", pos0, theta0, field=field,
                           with_stats=True, device=cuda_device)
    kw = dict(field=field, op="op7", delta_s=ds, box=box)
    one = kfu.fused_step(st, steps=steps, step_limit=steps, offset=0.0, **kw)
    _planes_equal(one, replay.fused_plain(st, steps=steps, step_limit=steps,
                                          offset=0.0, **kw))
    chain, done = st, 0
    for seg in (1, 300, 37, 2000, steps):
        seg = min(seg, steps - done)
        chain = kfu.fused_step(chain, steps=seg, step_limit=steps,
                               offset=float(done), **kw)
        done += seg
    _planes_equal(chain, one)
    short = dict(steps=steps, step_limit=250.0, offset=0.0, **kw)
    _planes_equal(kfu.fused_step(st, **short), replay.fused_plain(st, **short))


def test_refill_grid_is_persistent(cuda_device):
    """At 2^20 rays the refill loop's grid is what the SMs hold at once:
    a whole number of blocks a SM, fewer blocks than the rays fill; the
    fisheye and vert fields run one ray a thread (no refill grid)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    strat = _interface_fan(1, "strat", cuda_device)[0]
    for field in ("interface", strat):
        for stats in (False, True):
            blocks = kfu.refill_grid(field, "op6", 1 << 20, stats=stats)
            assert blocks % sms == 0 and 0 < blocks < (1 << 20) // 128
    for field in ("fisheye", "vert_heterogeneous"):
        assert kfu.refill_grid(field, "op6", 1 << 20) == 0
    with pytest.raises(ValueError, match="refill loop"):
        kfu.refill_grid(kfu.GridTables(None, 36, 0, 0, 1, 1, 2, 2), "op6", 10)


# -- the fused 3-D kernels (csrc/fused3d.cu) ----------------------------------

def _fan3(r=R, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.8, 0.8, (r, 3)).astype(np.float32),
            rng.normal(size=(r, 3)).astype(np.float32))


def _grid3(device):
    ax = np.linspace(-1.6, 1.6, 14)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    return rtt.c1_medium3_from_samples(1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2),
                                       ax, ax, ax, device=device)


@pytest.mark.parametrize("field", kf3.FUSED3_FIELDS + ("grid",))
@pytest.mark.parametrize("op", kf3.FUSED3_OPS)
def test_fused3d_kernels_match_plain(op, field, cuda_device):
    """fused3d_step (analytic fields) and fused3d_step_grid (a 14^3-node
    grid3 table) against fused3d_step_plain on the card, every plane to
    the bit, rays leaving the box on the way; and resume: 40 then 80 steps
    equal 120."""
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    pos0, dir0 = _fan3()
    if field == "interface":
        pos0[:, 1] *= 0.05
    med = grid3_tables(_grid3(cuda_device)) if field == "grid" else field
    st = kf3.initial_state3(pos0, dir0, device=cuda_device)
    box = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
    kw = dict(field=med, op=op, delta_s=0.01, step_limit=110.0, box=box)
    kernel = (kf3.KERNEL_GRID if field == "grid" else kf3.KERNEL)
    before = kernel.launches
    out = kf3.fused3d_step(st, steps=120, offset=0.0, **kw)
    assert kernel.launches == before + 1
    _planes_equal(out, replay.fused3d_plain(st, steps=120, offset=0.0, **kw))
    assert 0 < int((~out.active).sum()) < R
    two = kf3.fused3d_step(kf3.fused3d_step(st, steps=40, offset=0.0, **kw),
                           steps=80, offset=40.0, **kw)
    _planes_equal(out, two)


def test_fast_trace3_runs_on_the_card(cuda_device):
    """fast_trace3's three routes on the card, each against the same call
    on the CPU within 1e-5 (not to the bit: PyTorch's CPU sqrt is not
    correctly rounded, the card's is)."""
    pos0, dir0 = _fan3(r=512)
    box = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
    kw = dict(pos0=pos0, dir0=dir0, delta_s=0.01, steps=150, box=box)
    for med_cpu, med_gpu, engine in (
            (rtt.analytic_medium3("fisheye"), rtt.analytic_medium3("fisheye"),
             "fused3d"),
            (_grid3("cpu"), _grid3(cuda_device), "grid3"),
            (rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous")),
             rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous")),
             "scan3d")):
        g, eng = rtt.fast_trace3("op6", med_gpu, device=cuda_device, **kw)
        c, _ = rtt.fast_trace3("op6", med_cpu, device="cpu", **kw)
        assert eng == engine and g.pos.device.type == "cuda"
        assert float((g.pos.cpu() - c.pos).abs().max()) <= 1e-5
        assert torch.equal(g.active.cpu(), c.active)


# -- the 3-D dynamic kernels (csrc/dynamic3d.cu) ----------------------------

def _focus_fan3(r=R):
    """Rays from (1, 0, 0) in planes tilted by [-0.4, 0.4] rad, spread by
    +-0.3 rad: through the fisheye's antipodal focus at step 300 of 600 a
    turn, where det Q collapses and changes sign on some rays."""
    th = np.pi / 2 + np.linspace(-0.3, 0.3, r)
    return (np.tile([[1.0, 0.0, 0.0]], (r, 1)),
            np.stack([np.cos(th), np.sin(th), np.linspace(-0.4, 0.4, r)],
                     -1))


@pytest.mark.parametrize("field", kd3.DYN3_FUSED_FIELDS + ("grid",))
@pytest.mark.parametrize("op", kd3.DYN3_FUSED_OPS)
def test_dynamic3d_kernels_match_plain(op, field, cuda_device):
    """dynamic3d_step (analytic fields) and dynamic3d_step_grid (a 14^3-node
    grid3 table) against dynamic3d_step_plain, replayed from a CUDA graph,
    every one of the 25 planes to the bit: random rays that leave the box
    on the way, and on the fisheye and the grid a fan through the focus
    (KMAH and the focus locator at work); resume: 150 then 250 steps equal
    400; the replayed plain version equals the eager one."""
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    med = grid3_tables(_grid3(cuda_device)) if field == "grid" else field
    kernel = kd3.KERNEL_GRID if field == "grid" else kd3.KERNEL
    box = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
    pos0, dir0 = _fan3()
    if field == "interface":
        pos0[:, 1] *= 0.05
    launches = [(pos0, dir0, 0.01, 120, 110.0)]
    if field in ("fisheye", "grid"):
        launches.append(_focus_fan3() + (2 * np.pi / 600, 400, 390.0))
    for p0, d0, ds, steps, limit in launches:
        st = kd3.initial_dyn3_state(p0, d0, device=cuda_device)
        kw = dict(field=med, op=op, delta_s=ds, step_limit=limit, box=box)
        before = kernel.launches
        out = kd3.dynamic3d_step(st, steps=steps, offset=0.0, **kw)
        assert kernel.launches == before + 1
        _planes_equal(out, replay.dynamic3d_plain(st, steps=steps,
                                                  offset=0.0, **kw))
        cut = steps * 3 // 8
        two = kd3.dynamic3d_step(
            kd3.dynamic3d_step(st, steps=cut, offset=0.0, **kw),
            steps=steps - cut, offset=float(cut), **kw)
        _planes_equal(out, two)
    if field in ("fisheye", "grid"):
        assert float(out.kmah.max()) > 0 and float(out.minstep.max()) > 5
    else:
        assert 0 < int((~out.active).sum()) < R
    if op == "op6":
        kw = dict(field=med, op=op, steps=60, delta_s=0.01, step_limit=50.0,
                  offset=2.0, box=box)
        st = kd3.initial_dyn3_state(pos0[:256], dir0[:256],
                                    device=cuda_device)
        _planes_equal(replay.dynamic3d_plain(st, **kw),
                      kd3.dynamic3d_step_plain(st, **kw))


@pytest.mark.parametrize("op", ["op2", "op6", "op8"])
@pytest.mark.parametrize("field", ["fisheye", "grid"])
def test_dynamic3d_kernels_off_the_division_fast_path(op, field,
                                                      cuda_device):
    """Both 3-D dynamic kernels where their quotients (common.cuh div_by)
    leave the fast path, against dynamic3d_step_plain, every plane to the
    bit: rays launched at the fisheye's centre (zero numerators) and within
    1e-30 to 1e-12 of it (subnormal and tiny numerators), in and out of
    the z = 0 plane."""
    from raytracing_tpu_torch.engine.tiled3 import grid3_tables
    med = grid3_tables(_grid3(cuda_device)) if field == "grid" else field
    rng = np.random.default_rng(4)
    pos0 = rng.normal(size=(R, 3)) * 10.0 ** rng.uniform(-30, -12, (R, 1))
    dir0 = rng.normal(size=(R, 3))
    pos0[:64] = 0.0
    pos0[64:512, 2] = dir0[64:512, 2] = 0.0
    st = kd3.initial_dyn3_state(pos0, dir0, device=cuda_device)
    kw = dict(field=med, op=op, steps=60, delta_s=2 * np.pi / 600,
              step_limit=60.0, offset=0.0,
              box=(-1.5, 1.5, -1.5, 1.5, -1.5, 1.5))
    _planes_equal(kd3.dynamic3d_step(st, **kw), replay.dynamic3d_plain(st,
                                                                       **kw))


@pytest.mark.parametrize("denominator", [60.0, 360.0, None])
def test_div_by_equals_fdiv_rn(denominator, cuda_device):
    """common.cuh's div_by against the card's IEEE division (__fdiv_rn):
    every one of the 2^32 float32 numerators over the 3-D loop's constant
    denominators 60 and 360, and 2^28 seeded pairs (half over every bit
    pattern, half around the guard's thresholds); no pair may differ."""
    from raytracing_tpu_torch.kernels.divide import div_check
    if denominator is None:
        bad, pair = div_check(count=1 << 28, seed=11, device=cuda_device)
    else:
        bad, pair = div_check(denominator=denominator, count=1 << 32,
                              device=cuda_device)
    assert bad == 0, pair


def test_fast_dynamic3_and_eigenrays3_on_the_card(cuda_device):
    """fast_dynamic3's three routes on the card against the same call on
    the CPU (not to the bit: PyTorch's CPU sqrt is not correctly rounded,
    the card's is); find_eigenrays3's exact homogeneous arrival at float64
    on the card (tests/test_eigenray3d.py:27-42)."""
    pos0, dir0 = _focus_fan3(r=512)
    box = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
    kw = dict(pos0=pos0, dir0=dir0, delta_s=2 * np.pi / 600, steps=200,
              box=box)
    for med_cpu, med_gpu, engine in (
            (rtt.analytic_medium3("fisheye"), rtt.analytic_medium3("fisheye"),
             "dynamic3-kernel"),
            (_grid3("cpu"), _grid3(cuda_device), "dynamic3-kernel-grid"),
            (rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous")),
             rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous")),
             "dynamic3-scan")):
        g, eng = rtt.fast_dynamic3("op6", med_gpu, device=cuda_device, **kw)
        c, _ = rtt.fast_dynamic3("op6", med_cpu, device="cpu", **kw)
        assert eng == engine and g.pos.device.type == "cuda"
        assert float((g.pos.cpu() - c.pos).abs().max()) <= 1e-5
        assert float((g.detq.cpu() - c.detq).abs().max()) <= 1e-4
        assert torch.equal(g.active.cpu(), c.active)
    r = np.array([3.0, 1.0, -0.5])
    eig = rtt.find_eigenrays3(
        "op1", rtt.Custom3D(lambda x, y, z: torch.ones_like(x)),
        source=(0, 0, 0), receivers=[r], delta_s=0.02, max_size=250,
        box=(-1, 5, -3, 3, -3, 3), fan=(-0.5, 0.5, 17, -0.5, 0.5, 17),
        device=cuda_device)
    d = np.linalg.norm(r)
    assert len(eig.traveltime) == 1 and bool(eig.converged[0])
    np.testing.assert_allclose(eig.dir0[0], r / d, atol=1e-12)
    assert abs(eig.traveltime[0] - d) < 1e-12
    assert abs(eig.amplitude[0] - 1 / d) < 2e-6 and eig.miss[0] < 1e-12
