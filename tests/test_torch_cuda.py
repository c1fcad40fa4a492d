"""The CUDA kernels against their plain PyTorch versions on the card.

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
from raytracing_tpu_torch.kernels import fisheye as kf  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402
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
