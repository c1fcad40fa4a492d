"""The plain version of the fused 3-D kernels (fused3d_step_plain) against
the JAX package's Pallas kernels in interpret mode at float32: the analytic
kernel (fused3d_trace_final) for every op on every field, 256 rays x 300
steps, and the tiled grid3 kernel (grid3_trace_tiled) on a 12^3-node
sampled fisheye, 128 rays x 64 steps; the resume contract; fast_trace3's
routes, engine names and "active" semantics against JAX's; the kernel
header's step loop built for the host with g++ against the plain version;
and the 3-D state's interop."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

from raytracing_tpu.engine import fast as jfast  # noqa: E402
from raytracing_tpu.engine import tiled3 as jtiled3  # noqa: E402
from raytracing_tpu.engine import trace3d as jt3  # noqa: E402
from raytracing_tpu.kernels import fused3d as jfused3d  # noqa: E402
from raytracing_tpu.media import fields3d as jf3  # noqa: E402
from raytracing_tpu.media import grid3 as jg3  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine.fast import fast_trace3  # noqa: E402
from raytracing_tpu_torch.engine.tiled3 import (  # noqa: E402
    grid3_tables, grid3_trace_tiled)
from raytracing_tpu_torch.interop import (  # noqa: E402
    fused3_state_from_numpy, fused3_state_to_numpy)
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import fused3d as tf3  # noqa: E402

R = 256
BOX = (-2.0, 2.0, -2.0, 2.0, -2.0, 2.0)
GRID_BOX = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
#: the analytic fused kernels' bars (tests/test_kernels.py:24-27)
POS_TOL, TT_TOL = 5e-6, 5e-5
CPU = dict(device="cpu")


def _fan(field, r=R, seed=1):
    """The JAX test's tilted fisheye fan (tests/test_fused3d.py:27); for vert
    and the interface, random points and directions that leave the box at
    different steps (near the interface for its field)."""
    if field == "fisheye":
        tilt = np.linspace(0.0, 1.0, r).astype(np.float32)
        return (np.tile([[1.0, 0.0, 0.0]], (r, 1)).astype(np.float32),
                np.stack([np.zeros(r, np.float32), np.cos(tilt),
                          np.sin(tilt)], -1).astype(np.float32))
    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(-1, 1, (r, 3))
    if field == "interface":
        pos0[:, 1] = rng.uniform(-0.05, 0.05, r)
    return (pos0.astype(np.float32),
            rng.normal(size=(r, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def fisheye12():
    """A 12^3-node sampled fisheye, (JAX medium, port medium)."""
    ax = np.linspace(-1.6, 1.6, 12)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    jm = jg3.c1_medium3_from_samples(1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2),
                                     ax, ax, ax, dtype=np.float32)
    return jm, H.port_medium(jm)


def _close(t, j, tol=POS_TOL, tt_tol=TT_TOL):
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(H.to_np(t.tangent), np.asarray(j.tangent),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), atol=tt_tol, rtol=0)
    np.testing.assert_allclose(H.to_np(t.dist_sim), np.asarray(j.dist_sim),
                               atol=tt_tol, rtol=0)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))


@pytest.mark.parametrize("op", tf3.FUSED3_OPS)
@pytest.mark.parametrize("field", tf3.FUSED3_FIELDS)
def test_plain_matches_pallas_interpret(field, op):
    """Measured on these fans: pos <= 2.4e-6, tangent <= 2.5e-6, traveltime
    <= 1.7e-6, every `active` flag equal (the ops without the impulse's
    1 / sqrt differ as much as those with it: XLA:CPU and ATen round the
    same step apart by an ulp here and there, ROADMAP.md §3)."""
    pos0, dir0 = _fan(field)
    ds = np.float32(2 * np.pi / 300 if field == "fisheye" else 0.01)
    j = jfused3d.fused3d_trace_final(pos0, dir0, ds, field=field, op=op,
                                     steps=300, box=BOX, block_rays=R,
                                     interpret=True)
    t = tf3.fused3d_trace_final(pos0, dir0, ds, field=field, op=op,
                                steps=300, box=BOX, **CPU)
    _close(t, j)
    if field != "fisheye":
        assert 0 < int((~t.active).sum()) < R


@pytest.mark.parametrize("op", tf3.FUSED3_OPS)
def test_grid_plain_matches_pallas_tiled_interpret(op, fisheye12):
    """JAX's tiled grid3 kernel (windows, sort, replay) against the port's
    one launch on the same 12^3-node table: measured pos <= 1.2e-7,
    tangent <= 4.2e-7, traveltime <= 1.2e-7."""
    jm, tm = fisheye12
    r = 128
    th = np.pi / 2 + np.linspace(-0.05, 0.05, r)
    dirs = np.stack([np.cos(th), np.sin(th), np.full(r, 0.02)],
                    -1).astype(np.float32)
    pos0 = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (r, 1))
    ds = np.float32(2 * np.pi / 600)
    j = jtiled3.grid3_trace_tiled(op, pos0, dirs, ds, jm, steps=64,
                                  box=GRID_BOX, block_rays=r, interpret=True)
    t = grid3_trace_tiled(op, pos0, dirs, ds, tm, steps=64, box=GRID_BOX,
                          **CPU)
    _close(t, j, tol=1e-6, tt_tol=1e-6)


@pytest.mark.parametrize("field", ["fisheye", "grid"])
def test_resume_equals_one_launch(field, fisheye12):
    """k steps, then n - k with offset k, equal n steps to the bit, with a
    step limit inside the second launch."""
    med = grid3_tables(fisheye12[1]) if field == "grid" else field
    pos0, dir0 = _fan("vert", r=64)
    st = tf3.initial_state3(pos0 * 0.5, dir0, **CPU)
    kw = dict(field=med, op="op6", delta_s=0.02, step_limit=70,
              box=GRID_BOX)
    one = tf3.fused3d_step(st, steps=90, offset=0.0, **kw)
    two = tf3.fused3d_step(tf3.fused3d_step(st, steps=30, offset=0.0, **kw),
                           steps=60, offset=30.0, **kw)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    limited = tf3.fused3d_step(st, steps=70, offset=0.0, **kw)
    for a, b in zip(one, limited):
        assert torch.equal(a, b)


def test_step_limit_padding():
    """step_limit freezes rays mid-launch: equal to a launch of that many
    steps (tests/test_fused3d.py:129)."""
    pos0, dir0 = _fan("fisheye")
    ds = np.float32(2 * np.pi / 300)
    a = tf3.fused3d_trace_final(pos0, dir0, ds, field="fisheye", op="op6",
                                steps=300, box=BOX, step_limit=150, **CPU)
    b = tf3.fused3d_trace_final(pos0, dir0, ds, field="fisheye", op="op6",
                                steps=150, box=BOX, **CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_step_limit_rounds_to_float32():
    """The kernel compares the step count with a float32 limit, so the plain
    version does too: 150 + 1e-6 rounds to 150 and freezes at step 150."""
    pos0, dir0 = _fan("fisheye")
    ds = np.float32(2 * np.pi / 300)
    kw = dict(field="fisheye", op="op6", steps=300, box=BOX, **CPU)
    a = tf3.fused3d_trace_final(pos0, dir0, ds, step_limit=150 + 1e-6, **kw)
    b = tf3.fused3d_trace_final(pos0, dir0, ds, step_limit=150, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_named_errors(fisheye12):
    pos0, dir0 = _fan("fisheye", r=8)
    kw = dict(steps=8, box=BOX, **CPU)
    with pytest.raises(ValueError, match="fields"):
        tf3.fused3d_trace_final(pos0, dir0, 0.01, field="warp", op="op6",
                                **kw)
    with pytest.raises(ValueError, match="ops"):
        tf3.fused3d_trace_final(pos0, dir0, 0.01, field="fisheye",
                                op="op5", **kw)
    with pytest.raises(ValueError, match="box"):
        tf3.fused3d_trace_final(pos0, dir0, 0.01, field="fisheye", op="op6",
                                steps=8, box=BOX[:4], **CPU)
    with pytest.raises(ValueError, match=r"\(R, 3\)"):
        tf3.fused3d_trace_final(pos0[:, :2], dir0[:, :2], 0.01,
                                field="fisheye", op="op6", **kw)
    st = tf3.initial_state3(pos0, dir0, **CPU)
    with pytest.raises(ValueError, match="state.tt"):
        tf3.fused3d_step(st._replace(tt=st.tt.double()), field="fisheye",
                         op="op6", steps=2, delta_s=0.01, step_limit=2,
                         box=BOX)
    g = grid3_tables(fisheye12[1])
    with pytest.raises(ValueError, match="grid3 table"):
        tf3.fused3d_step(st, field=g._replace(table=g.table.double()),
                         op="op6", steps=2, delta_s=0.01, step_limit=2,
                         box=BOX)
    with pytest.raises(ValueError, match="C1Grid3Medium"):
        grid3_trace_tiled("op6", pos0, dir0, 0.01,
                          rtt.analytic_medium3("fisheye"), steps=2, box=BOX,
                          **CPU)
    with pytest.raises(ValueError, match="planar"):
        grid3_trace_tiled("op5", pos0, dir0, 0.01, fisheye12[1], steps=2,
                          box=BOX, **CPU)
    # mesh= (ROADMAP.md §1 item 18, done): a one-rank CPU mesh gives the
    # call without one, to the bit, and refuses a batch that does not
    # divide by devices x block
    import torch_dist_helpers as D
    one = grid3_trace_tiled("op6", pos0, dir0, 0.01, fisheye12[1], steps=2,
                            box=BOX, **CPU)
    with D.one_rank_mesh() as mesh:
        meshed = grid3_trace_tiled("op6", pos0, dir0, 0.01, fisheye12[1],
                                   steps=2, box=BOX, mesh=mesh,
                                   block_rays=len(pos0), **CPU)
        with pytest.raises(ValueError, match="must divide by devices"):
            grid3_trace_tiled("op6", pos0, dir0, 0.01, fisheye12[1],
                              steps=2, box=BOX, mesh=mesh,
                              block_rays=len(pos0) + 1, **CPU)
    for f in one._fields:
        np.testing.assert_array_equal(H.to_np(getattr(meshed, f)
                                              .full_tensor()),
                                      H.to_np(getattr(one, f)), err_msg=f)


# -- fast_trace3 (engine/fast.py:601-690) -------------------------------------

def test_fast_trace3_dispatch():
    """As JAX's test_fast_trace3_dispatch (tests/test_fused3d.py:154): the
    analytic fisheye to the fused kernel, within 5e-6 of the float32 scan
    tier; a Custom3D and a Stratified3D to the scan tier; any batch size;
    a box of 6 faces."""
    pos0, dir0 = _fan("fisheye")
    med = rtt.analytic_medium3("fisheye")
    kw = dict(pos0=pos0, dir0=dir0, delta_s=0.02, steps=200, box=BOX, **CPU)
    res, eng = fast_trace3("op6", med, **kw)
    assert eng == "fused3d"
    t = rtt.trace3d("op6", med, mode="metrics", **kw)
    np.testing.assert_allclose(H.to_np(res.pos), H.to_np(t.final.pos),
                               atol=5e-6)
    homog = rtt.Custom3D(lambda x, y, z: 1.0 + 0.0 * x)
    res2, eng2 = fast_trace3("op6", homog, **kw)
    assert eng2 == "scan3d" and isinstance(res2, type(res))
    res3, eng3 = fast_trace3("op6", rtt.analytic_medium3("fisheye"),
                             pos0=pos0[:100], dir0=dir0[:100], delta_s=0.02,
                             steps=200, box=BOX, **CPU)
    assert eng3 == "fused3d" and res3.pos.shape == (100, 3)
    assert torch.equal(res3.pos, res.pos[:100])
    s3 = rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous"))
    assert fast_trace3("HySA", s3, **kw)[1] == "scan3d"
    with pytest.raises(ValueError, match="box"):
        fast_trace3("op6", med, pos0=pos0, dir0=dir0, delta_s=0.02,
                    steps=8, box=BOX[:4], **CPU)
    with pytest.raises(ValueError, match="planar"):
        fast_trace3("op5", med, **kw)


def test_fast_trace3_matches_jax_engines_and_results(fisheye12):
    """The routes of JAX's fast_trace3 with the port's engine names
    ("fused3d", "grid3" for JAX's "grid3-tiled", "scan3d") on the same
    media and rays, each result within its bar of JAX's.  Measured: fused3d
    pos 1.2e-7, grid3 1.8e-7; the float32 scan tiers 3.2e-6 (tangent
    6.0e-6: their exact sin/cos round apart by an ulp, XLA:CPU against
    ATen), held to JAX's kernel-against-scan bar, 5e-5."""
    jm, tm = fisheye12
    pos0, dir0 = _fan("fisheye", r=128)
    pos0 = pos0 * 0.8
    kw = dict(pos0=pos0, dir0=dir0, delta_s=2 * np.pi / 600, steps=100,
              box=GRID_BOX)
    cases = (
        (jf3.analytic_medium3("fisheye"), rtt.analytic_medium3("fisheye"),
         "fused3d", POS_TOL),
        (jm, tm, "grid3", 1e-6),
        (jf3.Stratified3D(__import__("raytracing_tpu").analytic_medium(
            "vert_heterogeneous")),
         rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous")),
         "scan3d", 5e-5),
    )
    for jmed, tmed, engine, tol in cases:
        j, jeng = jfast.fast_trace3("op6", jmed, block_rays=128,
                                    interpret=True, **kw)
        t, teng = fast_trace3("op6", tmed, **kw, **CPU)
        assert teng == engine
        assert jeng == {"grid3": "grid3-tiled"}.get(engine, engine)
        _close(t, j, tol=tol, tt_tol=max(tol, 1e-6))


def test_fast_trace3_small_grid_and_dispersed_batch():
    """A grid with fewer than 5 cells an axis goes to the scan tier, as in
    JAX.  A dispersed batch on a 5-cell grid stays on the kernel
    ("grid3"): JAX's window ladder rejects it and falls back to its scan
    tier (tests/test_tiled3.py:211), the port has no window.  Both are held
    to what JAX returns, its float32 scan tier with containment as
    `active`, within JAX's own kernel-against-scan bar, 1e-5."""
    rng = np.random.default_rng(7)
    pos_d = rng.uniform(-1.4, 1.4, (200, 3)).astype(np.float32)
    dir_d = rng.normal(size=(200, 3)).astype(np.float32)
    kw = dict(pos0=pos_d, dir0=dir_d, delta_s=0.01, steps=50, box=GRID_BOX)
    for n, engine in ((5, "scan3d"), (6, "grid3")):
        ax = np.linspace(-1.6, 1.6, n)
        Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
        jm = jg3.c1_medium3_from_samples(
            1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2), ax, ax, ax,
            dtype=np.float32)
        j = jt3.trace3d("op6", jm, mode="metrics", dtype=np.float32, **kw)
        t, teng = fast_trace3("op6", H.port_medium(jm), **kw, **CPU)
        assert teng == engine
        p = np.asarray(j.final.pos)
        b = GRID_BOX
        inside = ((p[:, 0] >= b[0]) & (p[:, 0] <= b[1]) & (p[:, 1] >= b[2])
                  & (p[:, 1] <= b[3]) & (p[:, 2] >= b[4]) & (p[:, 2] <= b[5]))
        np.testing.assert_allclose(H.to_np(t.pos), p, atol=1e-5, rtol=0)
        np.testing.assert_allclose(H.to_np(t.tangent),
                                   np.asarray(j.final.unitv), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(H.to_np(t.traveltime),
                                   np.asarray(j.final.traveltime), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(H.to_np(t.active), inside)
        assert not inside.all()


@pytest.mark.parametrize("route", ["fused3d", "scan3d"])
def test_active_means_never_left_the_box(route):
    """A ray that leaves the box on its last step is inactive on both
    routes, though the scan tier's exit_step (== steps) cannot tell it from
    a ray that never left (fast.py:680-686)."""
    pos0 = np.zeros((2, 3), np.float32)
    dir0 = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    box = (-1.0, 2.05, -1.0, 1.0, -1.0, 9.0)
    vert = rtt.analytic_medium("vert_heterogeneous")
    med = (rtt.analytic_medium3("vert_heterogeneous") if route == "fused3d"
           else rtt.Stratified3D(vert))
    res, eng = fast_trace3("op8", med, pos0=pos0, dir0=dir0, delta_s=0.1,
                           steps=21, box=box, **CPU)
    assert eng == route
    assert H.to_np(res.active).tolist() == [False, True]
    assert 2.05 < float(res.pos[0, 0]) < 2.15
    scan = rtt.trace3d("op8", rtt.Stratified3D(vert), pos0=pos0, dir0=dir0,
                       delta_s=0.1, steps=21, box=box, mode="metrics", **CPU)
    assert H.to_np(scan.exit_step).tolist() == [21, 21]


# -- the kernel header on the host --------------------------------------------

_STUBS = """#define __host__
#define __device__
#define __forceinline__ inline
#include "fused3d.cuh"
"""
_HOST_LOOP = """
template <class M, int OP>
static void go(float* const* p, int n, int steps, float ds, float limit,
               float offset, const float* box, const M& m) {
  for (int r = 0; r < n; ++r) {
    rt3::Ray3 s{p[0][r], p[1][r], p[2][r], p[3][r], p[4][r], p[5][r],
                p[6][r], p[7][r], p[8][r], p[9][r], p[10][r],
                reinterpret_cast<bool*>(p[11])[r]};
    rt3::run3<M, OP>(s, steps, ds, limit, offset, box, m);
    const float v[11] = {s.x, s.y, s.z, s.cx, s.cy, s.cz, s.ux, s.uy, s.uz,
                         s.tt, s.dsim};
    for (int k = 0; k < 11; ++k) p[k][r] = v[k];
    reinterpret_cast<bool*>(p[11])[r] = s.active;
  }
}
template <class M>
static void ops(int op, float* const* p, int n, int steps, float ds,
                float limit, float offset, const float* box, const M& m) {
  if (op == 1) go<M, 1>(p, n, steps, ds, limit, offset, box, m);
  if (op == 2) go<M, 2>(p, n, steps, ds, limit, offset, box, m);
  if (op == 6) go<M, 6>(p, n, steps, ds, limit, offset, box, m);
  if (op == 8) go<M, 8>(p, n, steps, ds, limit, offset, box, m);
}
extern "C" void host_step(int field, int op, float* const* p, int n,
                          int steps, float ds, float limit, float offset,
                          const float* box, const float* table,
                          const float* geo, const int* nodes) {
  if (field == 0) ops(op, p, n, steps, ds, limit, offset, box,
                      rt3::Analytic3<0>{});
  if (field == 1) ops(op, p, n, steps, ds, limit, offset, box,
                      rt3::Analytic3<1>{});
  if (field == 3)
    ops(op, p, n, steps, ds, limit, offset, box,
        rt3::Grid3{table, geo[0], geo[1], geo[2], geo[3], geo[4], geo[5],
                   nodes[0], nodes[1], nodes[2]});
}
"""


@pytest.fixture(scope="module")
def host_loop(tmp_path_factory):
    """csrc/fused3d.cuh's run3 built for the host by g++ (-ffp-contract=off,
    the CUDA qualifiers stubbed)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/fused3d.cuh")
    tmp = tmp_path_factory.mktemp("fused3d_host")
    src, lib = tmp / "fused3d_host.cpp", tmp / "fused3d_host.so"
    src.write_text(_STUBS + _HOST_LOOP)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.host_step.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p]
                             + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                             + [ctypes.c_void_p] * 4)

    def run(st, field, op, steps, ds, limit, box):
        out = tf3.Fused3State(*(t.clone() for t in st))
        geo, nodes, table = (ctypes.c_float * 6)(), (ctypes.c_int * 3)(), None
        if isinstance(field, tf3.Grid3Tables):
            code, table = 3, field.table.data_ptr()
            geo = (ctypes.c_float * 6)(field.x0, field.y0, field.z0,
                                       field.inv_hx, field.inv_hy,
                                       field.inv_hz)
            nodes = (ctypes.c_int * 3)(field.nx, field.ny, field.nz)
        else:
            code = tf3.FIELD_CODES[field]
        so.host_step(code, int(op[2:]), build.pointer_array(out),
                     st.x.shape[0], steps, float(np.float32(ds)), limit, 0.0,
                     (ctypes.c_float * 6)(*box), table, geo, nodes)
        return out
    return run


@pytest.mark.parametrize("op", tf3.FUSED3_OPS)
@pytest.mark.parametrize("field", ["fisheye", "vert_heterogeneous", "grid"])
def test_header_step_loop_on_the_host_equals_plain(field, op, host_loop,
                                                   fisheye12, monkeypatch):
    """run3 on the host against fused3d_step_plain, every plane to the bit.

    PyTorch's CPU sqrt is not correctly rounded (its vectorized path is an
    ulp off on ~1 % of float32 inputs); the card's, like the host's sqrtf,
    is IEEE.  So the plain version runs here with an IEEE square root
    (float64 then rounded, which is exact for float32).  The interface is
    left to the card: glibc's expf and PyTorch's CPU exp differ by an ulp,
    where on the card both are libdevice's expf.  On the analytic fields
    both are in the FMA form (csrc/fused3d.cuh Fma3): the same step rounded
    as JAX rounds it differs from them in some plane."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda t: sqrt(t.double()).float())
    med = grid3_tables(fisheye12[1]) if field == "grid" else field
    rng = np.random.default_rng(0)
    st = tf3.initial_state3(rng.uniform(-1, 1, (512, 3)),
                            rng.normal(size=(512, 3)), **CPU)
    box = GRID_BOX
    plain = tf3.fused3d_step_plain(st, field=med, op=op, steps=200,
                                   delta_s=0.01, step_limit=150.0,
                                   offset=0.0, box=box)
    host = host_loop(st, med, op, 200, 0.01, 150.0, box)
    for name, a, b in zip(tf3.Fused3State._fields, plain, host):
        assert torch.equal(a, b), name
    assert 0 < int((~plain.active).sum()) < 512
    if field != "grid":
        H.jax_order_forms(monkeypatch)
        apart = tf3.fused3d_step_plain(st, field=med, op=op, steps=200,
                                       delta_s=0.01, step_limit=150.0,
                                       offset=0.0, box=box)
        assert not all(torch.equal(a, b) for a, b in zip(apart, plain))


def test_state_interop_round_trip():
    """The JAX tiled3 layout (x, y, z, cx, cy, cz, ux, uy, uz, tt, dsim,
    active as 0/1) to the port's state and back."""
    rng = np.random.default_rng(4)
    comps = [rng.normal(size=(8, 128)).astype(np.float32) for _ in range(11)]
    comps.append((rng.uniform(size=(8, 128)) > 0.5).astype(np.float32))
    st = fused3_state_from_numpy(comps, **CPU)
    assert st.active.dtype == torch.bool and st.x.shape == (1024,)
    back = fused3_state_to_numpy(st)
    for a, b in zip(back, comps):
        np.testing.assert_array_equal(a, b.reshape(-1))
    with pytest.raises(ValueError, match="12"):
        fused3_state_from_numpy(comps[:11], **CPU)


def test_kernel_infos():
    assert [k.name for k in tf3.KERNELS] == ["fused3d_step",
                                             "fused3d_step_grid"]
    for k in tf3.KERNELS:
        assert k.source == "raytracing_tpu_torch/csrc/fused3d.cu"
        assert k.replaces.startswith("raytracing_tpu/kernels/fused3d.py:")
    assert {"rt_fused3d_step", "rt_fused3d_step_grid"} <= set(
        build.MAIN_ENTRIES)
    # JAX's scan tier and the kernel share the op matrix
    assert set(tf3.FUSED3_OPS) == set(jt3.METHODS3)
