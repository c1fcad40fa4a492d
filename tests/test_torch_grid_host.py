"""The sampled-table kernels' headers built for the host with g++
(-ffp-contract=off, the CUDA qualifiers stubbed), against their plain
PyTorch versions, to the bit:

* csrc/media.cuh's 2-D grid blend ``hermite_blend`` (the FMA form) on a
  per-cell row (``CellCorners``) and on four node rows (``NodeCorners``)
  against kernels/fused.py::hermite_blend, on random corners and (u, v);
* csrc/fused.cuh's one-ray loop ``run_ray`` on the parity grid's cells
  (``Grid<36>``: fused_step_grid, fused_sweep_grid), its node table
  (``Nodes``: fused_step_nodes) and the C1 grid (``Grid<16>``), every op,
  against fused_step_plain;
* csrc/fused3d.cuh's ``Grid3::nag`` (the row read as it is blended)
  against tile_nag3_plain, and the 3-D step's fast forms (``step3`` in
  ``FAST3`` and ``LOCAL3``) against its IEEE step (``IEEE3``) on the grid3
  table and the analytic fisheye, every op, every plane; a table scaled
  past the guards' range, where every step of run3 takes the IEEE step,
  against the plain version.

PyTorch's CPU ``sqrt`` is not correctly rounded (an ulp off on ~1 % of
float32 inputs), so the plain versions run with an IEEE square root and
``rsqrt`` as one division by it, as the headers' host builds compute them.
Skipped where g++ is missing."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import fast  # noqa: E402
from raytracing_tpu_torch.engine import segmented as seg  # noqa: E402
from raytracing_tpu_torch.engine.tiled3 import grid3_tables  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402
from raytracing_tpu_torch.kernels import fused3d as kf3  # noqa: E402

CPU = dict(device="cpu")

_SRC = r"""#define __host__
#define __device__
#define __forceinline__ inline
#include "fused.cuh"
#include "fused3d.cuh"

// rows: n per-cell rows of 36 floats
extern "C" void host_blend_cells(const float* rows, const float* u,
                                 const float* v, int n, float* out) {
  for (int i = 0; i < n; ++i)
    rt::hermite_blend(rt::CellCorners{rows + 36 * i}, u[i], v[i],
                      out[3 * i], out[3 * i + 1], out[3 * i + 2]);
}

// nodes: n groups of four node rows (00, +x, +y, +xy) of 9 floats
extern "C" void host_blend_nodes(const float* nodes, const float* u,
                                 const float* v, int n, float* out) {
  for (int i = 0; i < n; ++i) {
    const float* c = nodes + 36 * i;
    rt::hermite_blend(rt::NodeCorners{c, c + 9, c + 18, c + 27}, u[i], v[i],
                      out[3 * i], out[3 * i + 1], out[3 * i + 2]);
  }
}

template <class M>
static void rays(int op, const rt::FusedArgs& a, const M& m) {
  for (int r = 0; r < a.n; ++r) {
    switch (op) {
      case 1: rt::run_ray<M, 1>(a, m, r); break;
      case 2: rt::run_ray<M, 2>(a, m, r); break;
      case 3: rt::run_ray<M, 3>(a, m, r); break;
      case 4: rt::run_ray<M, 4>(a, m, r); break;
      case 6: rt::run_ray<M, 6>(a, m, r); break;
      case 7: rt::run_ray<M, 7>(a, m, r); break;
      case 8: rt::run_ray<M, 8>(a, m, r); break;
      case 12: rt::run_ray<M, 12>(a, m, r); break;
    }
  }
}

// kind 36, 16: the per-cell tables; 9: the node table
extern "C" void host_fused_grid(int kind, RT_FUSED_PARAMS, RT_TABLE_PARAMS) {
  const rt::FusedArgs a = RT_FUSED_ARGS;
  if (kind == 36) rays(op, a, rt::Grid<36>{RT_TABLE});
  if (kind == 16) rays(op, a, rt::Grid<16>{RT_TABLE});
  if (kind == 9) rays(op, a, rt::Nodes{RT_TABLE});
}

extern "C" void host_nag3(const float* table, const float* geo,
                          const int* nodes, const float* x, const float* y,
                          const float* z, int n, float* out) {
  const rt3::Grid3 m{table, geo[0], geo[1], geo[2], geo[3], geo[4], geo[5],
                     nodes[0], nodes[1], nodes[2]};
  for (int i = 0; i < n; ++i)
    m.nag(x[i], y[i], z[i], out[4 * i], out[4 * i + 1], out[4 * i + 2],
          out[4 * i + 3]);
}

// `steps` steps of step3<M, OP, MODE> on each ray (no box, no limit):
// the 11 state values and n, grad n, 1 / n of the carry after them into
// out (16 a ray); ok[r] 0 where a guard failed
template <class M, int OP, int MODE>
static void adv(const M& m, const float* s0, int n, int steps, float ds,
                float* out, int* ok) {
  for (int r = 0; r < n; ++r) {
    const float* p = s0 + 11 * r;
    rt3::Carry3 c;
    c.s = rt3::Ray3{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                    p[9], p[10], true};
    rt3::load3<M, OP>(m, c);
    bool good = true;
    for (int i = 0; i < steps; ++i)
      rt3::step3<M, OP, MODE>(c, ds, ds * ds * 0.5f, ds * 0.5f, m, good);
    const float v[16] = {c.s.x, c.s.y, c.s.z, c.s.cx, c.s.cy, c.s.cz,
                         c.s.ux, c.s.uy, c.s.uz, c.s.tt, c.s.dsim, c.n,
                         c.gx, c.gy, c.gz, c.rny};
    for (int k = 0; k < 16; ++k) out[16 * r + k] = v[k];
    ok[r] = good;
  }
}

template <class M, int MODE>
static void adv_ops(int op, const M& m, const float* s0, int n, int steps,
                    float ds, float* out, int* ok) {
  if (op == 1) adv<M, 1, MODE>(m, s0, n, steps, ds, out, ok);
  if (op == 2) adv<M, 2, MODE>(m, s0, n, steps, ds, out, ok);
  if (op == 6) adv<M, 6, MODE>(m, s0, n, steps, ds, out, ok);
  if (op == 8) adv<M, 8, MODE>(m, s0, n, steps, ds, out, ok);
}

template <class M>
static void adv_modes(int mode, int op, const M& m, const float* s0, int n,
                      int steps, float ds, float* out, int* ok) {
  if (mode == rt3::IEEE3)
    adv_ops<M, rt3::IEEE3>(op, m, s0, n, steps, ds, out, ok);
  if (mode == rt3::FAST3)
    adv_ops<M, rt3::FAST3>(op, m, s0, n, steps, ds, out, ok);
  if (mode == rt3::LOCAL3)
    adv_ops<M, rt3::LOCAL3>(op, m, s0, n, steps, ds, out, ok);
}

// field 0: the analytic fisheye; 3: the grid3 table; mode: rt3::Mode3
extern "C" void host_advance3(int field, int mode, int op, const float* s0,
                              int n, int steps, float ds, const float* table,
                              const float* geo, const int* nodes, float* out,
                              int* ok) {
  if (field == 0) {
    adv_modes(mode, op, rt3::Analytic3<0>{}, s0, n, steps, ds, out, ok);
  } else {
    const rt3::Grid3 m{table, geo[0], geo[1], geo[2], geo[3], geo[4],
                       geo[5], nodes[0], nodes[1], nodes[2]};
    adv_modes(mode, op, m, s0, n, steps, ds, out, ok);
  }
}

// run3 (the kernel's loop: fast steps, the IEEE step where a guard fails)
extern "C" void host_run3(int op, float* s, int n, int steps, float ds,
                          float limit, const float* box, const float* table,
                          const float* geo, const int* nodes) {
  const rt3::Grid3 m{table, geo[0], geo[1], geo[2], geo[3], geo[4], geo[5],
                     nodes[0], nodes[1], nodes[2]};
  for (int r = 0; r < n; ++r) {
    float* p = s + 12 * r;
    rt3::Ray3 q{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9],
                p[10], p[11] != 0.0f};
    switch (op) {
      case 1:
        rt3::run3<rt3::Grid3, 1>(q, steps, ds, limit, 0.0f, box, m);
        break;
      case 2:
        rt3::run3<rt3::Grid3, 2>(q, steps, ds, limit, 0.0f, box, m);
        break;
      case 6:
        rt3::run3<rt3::Grid3, 6>(q, steps, ds, limit, 0.0f, box, m);
        break;
      case 8:
        rt3::run3<rt3::Grid3, 8>(q, steps, ds, limit, 0.0f, box, m);
        break;
    }
    const float v[12] = {q.x, q.y, q.z, q.cx, q.cy, q.cz, q.ux, q.uy, q.uz,
                         q.tt, q.dsim, q.active ? 1.0f : 0.0f};
    for (int k = 0; k < 12; ++k) p[k] = v[k];
  }
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/fused.cuh and csrc/fused3d.cuh built for the host by g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/fused.cuh")
    tmp = tmp_path_factory.mktemp("grid_host")
    src, lib = tmp / "grid_host.cpp", tmp / "grid_host.so"
    src.write_text(_SRC)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    for name in ("host_blend_cells", "host_blend_nodes"):
        getattr(so, name).argtypes = [_P, _P, _P, _I, _P]
    so.host_fused_grid.argtypes = (
        [_I] + list(build._SIGNATURES["rt_fused_step"][1:-2])
        + [_P, _F, _F, _F, _F, _I, _I])
    so.host_nag3.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P]
    so.host_advance3.argtypes = [_I, _I, _I, _P, _I, _I, _F, _P, _P, _P, _P,
                                 _P]
    so.host_run3.argtypes = [_I, _P, _I, _I, _F, _F, _P, _P, _P, _P]
    return so


@pytest.fixture
def ieee(monkeypatch):
    """torch.sqrt correctly rounded and torch.rsqrt as one division by it,
    as the headers' host builds compute them."""
    sqrt = torch.sqrt

    def ieee_sqrt(t):
        return sqrt(t.double()).float()

    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    monkeypatch.setattr(torch, "rsqrt",
                        lambda t: kfu.div_exact(1.0, ieee_sqrt(t)))


def bits(t):
    return t.contiguous().view(torch.int32)


# -- the 2-D blend ------------------------------------------------------------
def _corners_and_offsets(rng, n):
    """n cells' 36 corner values (9 channels x 4 corners: value-like,
    gradient-like and derivative-like magnitudes) and offsets in [0, 1],
    the ends included."""
    scale = np.array([1.0] + [0.5] * 8, np.float32)
    rows = (rng.standard_normal((n, 9, 4)) * scale[:, None]).astype(
        np.float32)
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    v = rng.uniform(0.0, 1.0, n).astype(np.float32)
    u[:4], v[:4] = [0.0, 1.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0]
    return rows, u, v


@pytest.mark.parametrize("corners", ["cells", "nodes"])
def test_hermite_blend_on_the_host_equals_plain(corners, host):
    rng = np.random.default_rng(11)
    n = 1 << 16
    rows, u, v = _corners_and_offsets(rng, n)
    if corners == "cells":
        data = np.ascontiguousarray(rows.reshape(n, 36))
        fn = host.host_blend_cells
    else:
        # node rows (00, +x, +y, +xy), each its 9 channels
        data = np.ascontiguousarray(rows.transpose(0, 2, 1).reshape(n, 36))
        fn = host.host_blend_nodes
    out = np.empty((n, 3), np.float32)
    fn(data.ctypes.data, u.ctypes.data, v.ctypes.data, n, out.ctypes.data)
    rt_ = torch.as_tensor(rows)
    plain = kfu.hermite_blend(lambda ch: tuple(rt_[:, ch, c]
                                               for c in range(4)),
                              torch.as_tensor(u), torch.as_tensor(v))
    for k in range(3):
        assert torch.equal(bits(torch.as_tensor(out[:, k])), bits(plain[k]))


# -- the 2-D grid loop --------------------------------------------------------
@pytest.fixture(scope="module")
def grids():
    """A coarse fisheye grid (delta 0.1) as the kernels read it: the parity
    per-cell table, its node table and the C1 per-cell table."""
    box = rtt.scenario("fisheye").box
    herm = fast._as_hermite(rtt.build_grid_medium("fisheye", box, 0.1,
                                                  **CPU))
    c1 = rtt.build_c1_medium("fisheye", box, 0.1, **CPU)
    return {36: seg.grid_tables(herm), 9: seg.node_tables(herm),
            16: seg.grid_tables(c1)}


def _host_grid(so, kind, t, st, *, op, steps, delta_s, step_limit, box):
    out = kfu.ResumeState(*(None if v is None else
                            (torch.full_like(v, float("nan"))
                             if v.is_floating_point() else ~v) for v in st))
    so.host_fused_grid(kind, int(op[2:]), int(st.mom_count is not None),
                       build.pointer_array(st), build.pointer_array(out),
                       st.x.shape[0], steps, float(np.float32(delta_s)),
                       float(step_limit), 0.0, *(float(b) for b in box),
                       kfu.CURV_TOL, t.table.data_ptr(), float(t.x0),
                       float(t.y0), float(t.inv_hx), float(t.inv_hy),
                       int(t.nx), int(t.ny))
    return out


@pytest.mark.parametrize("op", kfu.FUSED_OPS)
@pytest.mark.parametrize("kind", [36, 9, 16])
def test_grid_loop_on_the_host_equals_plain(kind, op, host, ieee, grids):
    """run_ray against fused_step_plain on 128 rays over the grid, 60 steps
    under a step limit of 50, with the stats; every plane to the bit."""
    t = grids[kind]
    rng = np.random.default_rng(4)
    pos0 = rng.uniform(-1.0, 1.0, (128, 2))
    theta0 = rng.uniform(0.0, 2.0 * np.pi, 128)
    box = (-1.3, 1.3, -1.3, 1.3)
    st = kfu.initial_state(op, pos0, theta0, field=t, with_stats=True, **CPU)
    kw = dict(op=op, steps=60, delta_s=0.03, step_limit=50.0, box=box)
    plain = kfu.fused_step_plain(st, field=t, offset=0.0, **kw)
    got = _host_grid(host, kind, t, st, **kw)
    for name, a, b in zip(kfu.ResumeState._fields, got, plain):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool
                               else bits(a),
                               b.view(torch.uint8) if b.dtype == torch.bool
                               else bits(b)), name
    assert 0 < int((~plain.active).sum()) < 128


# -- the 3-D row and step -----------------------------------------------------
@pytest.fixture(scope="module")
def grid3():
    """A 12^3-node sampled fisheye's per-cell table."""
    ax = np.linspace(-1.6, 1.6, 12)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    return grid3_tables(rtt.c1_medium3_from_samples(
        1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2), ax, ax, ax, **CPU))


def _geo(t):
    return ((ctypes.c_float * 6)(t.x0, t.y0, t.z0, t.inv_hx, t.inv_hy,
                                 t.inv_hz),
            (ctypes.c_int * 3)(t.nx, t.ny, t.nz))


def test_grid3_streamed_nag_equals_tile_nag3_plain(host, grid3):
    """Points inside and outside the grid (the edge cells' rows)."""
    q = np.random.default_rng(6).uniform(-1.9, 1.9, (3, 1 << 15)).astype(
        np.float32)
    n = q.shape[1]
    out = np.empty((n, 4), np.float32)
    geo, nodes = _geo(grid3)
    host.host_nag3(grid3.table.data_ptr(), geo, nodes, q[0].ctypes.data,
                   q[1].ctypes.data, q[2].ctypes.data, n, out.ctypes.data)
    plain = kf3.tile_nag3_plain(grid3)(*(torch.as_tensor(v) for v in q))
    for k in range(4):
        assert torch.equal(bits(torch.as_tensor(out[:, k])), bits(plain[k]))


def _state3(rng, n):
    pos = rng.uniform(-1.0, 1.0, (n, 3))
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = np.zeros((n, 11), np.float32)
    s[:, 0:3], s[:, 6:9] = pos, d
    return np.ascontiguousarray(s)


#: rt3::Mode3
IEEE3, FAST3, LOCAL3 = 0, 1, 2


def _advance3(host, field, mode, op, s0, steps, t):
    n = s0.shape[0]
    out = np.empty((n, 16), np.float32)
    ok = np.zeros(n, np.int32)
    geo, nodes = _geo(t)
    host.host_advance3(0 if field == "fisheye" else 3, mode, int(op[2:]),
                       s0.ctypes.data, n, steps, 0.02, t.table.data_ptr(),
                       geo, nodes, out.ctypes.data, ok.ctypes.data)
    return out, ok


@pytest.mark.parametrize("op", kf3.FUSED3_OPS)
@pytest.mark.parametrize("field", ["fisheye", "grid", "grid_off_range"])
def test_fast_step3_equals_ieee_step3(field, op, host, grid3):
    """step3's fast forms (the carried 1 / n, the quotient from it, the
    square roots and op1/op8's 1 / sqrt), with every guard ANDed into one
    flag (FAST3, the grid3 table's) and with each operation's own IEEE
    fallback (LOCAL3, the analytic fields'), against the IEEE step (IEEE3),
    40 steps of 0.02 from 512 states, the carry's state and n, grad n to
    the bit: on the fisheye and the grid every guard holds; on the grid
    scaled by 2^20 (n beyond recip_pos's 2^16) the guards of the ops that
    divide by n fail on every step, where LOCAL3 falls back at once."""
    t = grid3._replace(table=grid3.table * 2.0 ** 20) \
        if field == "grid_off_range" else grid3
    kind = "fisheye" if field == "fisheye" else "grid"
    s0 = _state3(np.random.default_rng(8), 512)
    ieee_out, _ = _advance3(host, kind, IEEE3, op, s0, 40, t)
    fast_out, fast_ok = _advance3(host, kind, FAST3, op, s0, 40, t)
    local_out, local_ok = _advance3(host, kind, LOCAL3, op, s0, 40, t)
    np.testing.assert_array_equal(fast_ok, local_ok)
    divides = op != "op1"
    if field == "grid_off_range" and divides:
        assert not local_ok.any()
    else:
        assert local_ok.all()
        # the carried reciprocal is the fast forms' alone
        np.testing.assert_array_equal(fast_out[:, :15].view(np.uint32),
                                      ieee_out[:, :15].view(np.uint32))
    np.testing.assert_array_equal(local_out[:, :15].view(np.uint32),
                                  ieee_out[:, :15].view(np.uint32))


def test_run3_off_the_guard_range_equals_plain(host, grid3, ieee):
    """A grid3 table scaled by 2^20, so that n lies beyond recip_pos's 2^16:
    every fast step's guard fails and run3 takes the IEEE step; against
    fused3d_step_plain, every plane to the bit."""
    big = grid3._replace(table=grid3.table * 2.0 ** 20)
    rng = np.random.default_rng(9)
    st = kf3.initial_state3(rng.uniform(-1, 1, (256, 3)),
                            rng.normal(size=(256, 3)), **CPU)
    box = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
    geo, nodes = _geo(big)
    for op in kf3.FUSED3_OPS:
        plain = kf3.fused3d_step_plain(st, field=big, op=op, steps=30,
                                       delta_s=0.01, step_limit=25.0,
                                       offset=0.0, box=box)
        s = torch.stack([t.float() for t in st], -1).contiguous()
        host.host_run3(int(op[2:]), s.data_ptr(), 256, 30, 0.01, 25.0,
                       (ctypes.c_float * 6)(*box), big.table.data_ptr(), geo,
                       nodes)
        for k, name in enumerate(kf3.Fused3State._fields[:11]):
            assert torch.equal(bits(s[:, k]), bits(getattr(plain, name))), \
                (op, name)
        assert torch.equal(s[:, 11] != 0, plain.active), op
