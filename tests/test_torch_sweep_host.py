"""The candidate sweep's loop (raytracing_tpu_torch/csrc/fused.cuh: what
``sweep_kernel`` runs for ``fused_sweep_grid``, the grid loop ``run_ray``
with a step size and a step limit a ray read from ``FusedArgs::ds_ray`` and
``limit_ray``) built for the host with g++ (-ffp-contract=off, the CUDA
qualifiers stubbed), against the plain PyTorch version with per-ray
``delta_s`` and ``step_limit``, every plane to the bit.

The cases: the fisheye search's candidate grid narrowed to divisors 40 ->
4 (ten turns) on a coarse fisheye grid (delta 0.05), parity and C1, op1,
op6 and op7, and two candidates of their own: a step of a fifth of a cell
(many steps in one cell) and a ray launched near the box's edge that
leaves it; the coarsest candidates cross 21-31 cells a step.  PyTorch's
CPU ``sqrt`` is not correctly rounded, so the plain version runs with an
IEEE square root and ``rsqrt`` as one division by it, as the header's host
build computes them.  Skipped where g++ is missing."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import config  # noqa: E402
from raytracing_tpu_torch.engine import fast  # noqa: E402
from raytracing_tpu_torch.engine import segmented as seg  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402
from raytracing_tpu_torch.parallel import sweep  # noqa: E402

CPU = dict(device="cpu")

_SRC = r"""#define __host__
#define __device__
#define __forceinline__ inline
#include "fused.cuh"

template <int CH>
static void cands(int op, const rt::FusedArgs& a, const rt::Grid<CH>& m) {
  for (int r = 0; r < a.n; ++r) {
    switch (op) {
      case 1: rt::run_ray<rt::Grid<CH>, 1>(a, m, r); break;
      case 6: rt::run_ray<rt::Grid<CH>, 6>(a, m, r); break;
      case 7: rt::run_ray<rt::Grid<CH>, 7>(a, m, r); break;
    }
  }
}

// rt_fused_sweep_grid's arguments less the stream
extern "C" void host_sweep(int cell_ch, RT_FUSED_PARAMS, const void* ds_ray,
                           const void* limit_ray, RT_TABLE_PARAMS) {
  rt::FusedArgs a = RT_FUSED_ARGS;
  a.ds_ray = static_cast<const float*>(ds_ray);
  a.limit_ray = static_cast<const float*>(limit_ray);
  if (cell_ch == 36) cands(op, a, rt::Grid<36>{RT_TABLE});
  if (cell_ch == 16) cands(op, a, rt::Grid<16>{RT_TABLE});
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/fused.cuh built for the host by g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/fused.cuh")
    tmp = tmp_path_factory.mktemp("sweep_host")
    src, lib = tmp / "sweep_host.cpp", tmp / "sweep_host.so"
    src.write_text(_SRC)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.host_sweep.argtypes = list(
        build._SIGNATURES["rt_fused_sweep_grid"][:-1])
    so.host_sweep.restype = None
    return so


@pytest.fixture
def ieee(monkeypatch):
    """torch.sqrt correctly rounded and torch.rsqrt as one division by it,
    as the header's host build computes them."""
    sqrt = torch.sqrt

    def ieee_sqrt(t):
        return sqrt(t.double()).float()

    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    monkeypatch.setattr(torch, "rsqrt",
                        lambda t: kfu.div_exact(1.0, ieee_sqrt(t)))


@pytest.fixture(scope="module")
def grids():
    """A coarse fisheye grid (delta 0.05, 61 x 61 nodes) as the sweep reads
    it: the parity and the C1 per-cell tables."""
    box = rtt.scenario("fisheye").box
    herm = fast._as_hermite(rtt.build_grid_medium("fisheye", box, 0.05,
                                                  **CPU))
    c1 = rtt.build_c1_medium("fisheye", box, 0.05, **CPU)
    return {"grid": seg.grid_tables(herm), "c1_grid": seg.grid_tables(c1)}


#: the two candidates of the tests' own: (x, y, heading, delta_s, limit)
EXTRA = ((1.0, 0.0, np.pi / 2.0, 0.01, 300.0),     # a fifth of a cell a step
         (1.3, 0.5, 0.4, 0.07, 400.0))              # leaves by the box's edge


@pytest.fixture(scope="module")
def candidates():
    """(pos0, theta0, delta_s, step_limit, steps): the fisheye search's
    candidates at divisors 40 -> 4 (ten turns, one ray each at (1, 0)
    heading pi/2, as the search launches them), then EXTRA."""
    scen = rtt.scenario("fisheye")
    old = config.DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT
    config.DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT = 40.0
    try:
        _, ds, tdivs = sweep.candidates(scen)
        limits = sweep._max_sizes(scen, ds, tdivs, config.N_TURNS) - 1
    finally:
        config.DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT = old
    n = len(ds)
    pos0 = np.concatenate([np.tile([[1.0, 0.0]], (n, 1)),
                           [[x, y] for x, y, *_ in EXTRA]])
    theta0 = np.concatenate([np.full(n, np.pi / 2.0),
                             [t for _, _, t, *_ in EXTRA]])
    d = torch.as_tensor(np.concatenate([ds, [e[3] for e in EXTRA]]),
                        dtype=torch.float32)
    lim = torch.as_tensor(np.concatenate([limits, [e[4] for e in EXTRA]]),
                          dtype=torch.float32)
    return pos0, theta0, d, lim, int(lim.max())


def host_sweep(so, st, ds, lim, *, field, op, steps, box):
    """The sweep's candidates on the host: run_ray on each, with its own
    step size and step limit; the output state."""
    out = kfu.ResumeState(*(None if v is None else
                            (torch.full_like(v, float("nan"))
                             if v.is_floating_point() else ~v) for v in st))
    so.host_sweep(field.cell_ch, int(op[2:]), int(st.mom_count is not None),
                  build.pointer_array(st), build.pointer_array(out),
                  st.x.shape[0], int(steps), 0.0, 0.0, 0.0,
                  *(float(b) for b in box), kfu.CURV_TOL, ds.data_ptr(),
                  lim.data_ptr(), field.table.data_ptr(), float(field.x0),
                  float(field.y0), float(field.inv_hx), float(field.inv_hy),
                  int(field.nx), int(field.ny))
    return out


def same(a, b):
    """Two resume states equal in every plane, to the bit."""
    for name, x, y in zip(kfu.ResumeState._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            view = torch.uint8 if x.dtype == torch.bool else torch.int32
            assert torch.equal(x.view(view), y.view(view)), name


@pytest.mark.parametrize("op", ["op1", "op6", "op7"])
@pytest.mark.parametrize("kind", ["grid", "c1_grid"])
def test_sweep_loop_on_the_host_equals_plain(kind, op, host, ieee, grids,
                                             candidates):
    """The sweep's loop on every candidate against fused_step_plain with
    per-ray step sizes and step limits; every plane to the bit."""
    field = grids[kind]
    pos0, theta0, ds, lim, steps = candidates
    box = tuple(rtt.scenario("fisheye").box)
    st = kfu.initial_state(op, pos0, theta0, field=field, with_stats=False,
                           **CPU)
    plain = kfu.fused_step_plain(st, field=field, op=op, steps=steps,
                                 delta_s=ds, step_limit=lim, offset=0.0,
                                 box=box)
    same(host_sweep(host, st, ds, lim, field=field, op=op, steps=steps,
                    box=box), plain)
    # the ray near the edge and some of the coarsest candidates leave the
    # box; the finest candidates stay in it for their ten turns
    assert not bool(plain.active[-1]) and bool(plain.active[:5].all())


def test_sweep_loop_alone_equals_its_row(host, ieee, grids, candidates):
    """The coarsest candidates (divisors 4 -> 6: steps of 21-31 cells, a
    turn in 4-6 steps), the finest one and the ray that leaves by the
    box's edge, launched on their own, equal their rows of the whole sweep
    and the plain version, to the bit."""
    field = grids["grid"]
    pos0, theta0, ds, lim, steps = candidates
    box = tuple(rtt.scenario("fisheye").box)
    st = kfu.initial_state("op1", pos0, theta0, field=field,
                           with_stats=False, **CPU)
    every = host_sweep(host, st, ds, lim, field=field, op="op1",
                       steps=steps, box=box)
    pick = [len(ds) - 5, len(ds) - 4, len(ds) - 3, 0, len(ds) - 1]
    assert float(ds[pick[0]]) > 20 * 0.05
    sub = type(st)(*(None if t is None else t[pick].contiguous()
                     for t in st))
    d, m = ds[pick].contiguous(), lim[pick].contiguous()
    alone = host_sweep(host, sub, d, m, field=field, op="op1",
                       steps=int(m.max()), box=box)
    same(alone, type(st)(*(None if t is None else t[pick] for t in every)))
    same(alone, kfu.fused_step_plain(sub, field=field, op="op1",
                                     steps=int(m.max()), delta_s=d,
                                     step_limit=m, offset=0.0, box=box))
