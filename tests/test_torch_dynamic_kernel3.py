"""The plain version of the 3-D dynamic kernels (dynamic3d_step_plain)
against the JAX package's fused 3-D dynamic Pallas kernel in interpret mode
at float32: every op on every analytic field, on the launches of JAX's own
kernel-against-scan tests (tests/test_dynamic_kernel3.py: the fisheye fan
for 500 steps, vert and the interface for 250); the inlined Hessians against
autodiff and against JAX's; the focus locator; the resume contract; the
replay form of the step; the kernel header's loop built for the host with
g++ against the plain version, every plane to the bit; the 3-D dynamic
state's interop; fast_dynamic3's routes and errors."""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

from raytracing_tpu.engine import dynamic3d as jd  # noqa: E402
from raytracing_tpu.engine import fast as jfast  # noqa: E402
from raytracing_tpu.kernels import dynamic3d as jk3  # noqa: E402
from raytracing_tpu.media import fields3d as jf3  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine.tiled3 import grid3_tables  # noqa: E402
from raytracing_tpu_torch.interop import (  # noqa: E402
    dyn3_state_from_numpy, dyn3_state_to_numpy)
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import dynamic3d as tk3  # noqa: E402
from raytracing_tpu_torch.kernels.fused import FIELD_CODES  # noqa: E402

R = 256
BOX = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
CPU = dict(device="cpu")
#: the bars, set before measuring: the analytic fused kernels' plain
#: versions against JAX's interpret kernels (tests/test_kernels.py:24-27)
#: and JAX's own 3-D dynamic kernel-against-scan bars for det Q and KMAH
#: (tests/test_dynamic_kernel3.py:79-84)
POS_TOL, TT_TOL = 5e-6, 5e-5
DET_RTOL, DET_ATOL = 5e-5, 1e-8
#: the interface: JAX's own bars on this launch (tests/test_dynamic_kernel3.
#: py:107-112).  Its rays run straight below the interface, where XLA:CPU
#: contracts JAX's ``pos + u ds`` into one fused multiply-add: the sum rounds
#: once instead of twice and the positions drift apart by an ulp a step
#: (1.6e-5 after 250 steps, reproduced by a float32 emulation of both forms);
#: the port and its CUDA kernel round the product and the sum apart
#: (-fmad=false), as JAX's body is written
INTERFACE_TOL, INTERFACE_DET = 2e-4, (2e-4, 1e-6)


def launch(field, r=R, spread=0.05):
    """(pos0, dir0, delta_s, steps, box) of JAX's kernel tests: the fisheye
    fan of tests/test_dynamic_kernel3.py:55-75, the vert and interface
    launches of :86-99."""
    if field == "fisheye":
        th = np.pi / 2 + np.linspace(-spread, spread, r)
        return (np.tile(np.array([1.0, 0.0, 0.0], np.float32), (r, 1)),
                np.stack([np.cos(th), np.sin(th), np.full(r, 0.02)],
                         -1).astype(np.float32),
                np.float32(2 * np.pi / 600), 500, BOX)
    a = np.linspace(0.1, 0.9, r)
    dirs = np.stack([np.cos(a), np.sin(a), np.full(r, 0.01)],
                    -1).astype(np.float32)
    if field == "vert_heterogeneous":
        return (np.tile(np.array([0.0, -1.0, 0.0], np.float32), (r, 1)), dirs,
                np.float32(0.01), 250, (-2.0, 5.0, -2.5, 1.0, -2.0, 2.0))
    return (np.tile(np.array([-2.0, -2.0, 0.0], np.float32), (r, 1)), dirs,
            np.float32(0.01), 250, (-2.0, 20.0, -2.0, 4.0, -4.0, 4.0))


def assert_close(t, j, pos_tol=POS_TOL, det=(DET_RTOL, DET_ATOL),
                 kmah_share=1.0, locator=2):
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos),
                               atol=pos_tol, rtol=0)
    np.testing.assert_allclose(H.to_np(t.tangent), np.asarray(j.tangent),
                               atol=pos_tol, rtol=0)
    np.testing.assert_allclose(H.to_np(t.traveltime),
                               np.asarray(j.traveltime), atol=TT_TOL, rtol=0)
    np.testing.assert_allclose(H.to_np(t.detq), np.asarray(j.detq),
                               rtol=det[0], atol=det[1])
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))
    kmah_same = H.to_np(t.kmah) == np.asarray(j.kmah)
    assert kmah_same.mean() >= kmah_share
    steps_close = np.abs(H.to_np(t.min_absdet_step)
                         - np.asarray(j.min_absdet_step)) <= locator
    assert steps_close.mean() >= kmah_share
    np.testing.assert_allclose(H.to_np(t.n), np.asarray(j.n), atol=5e-6,
                               rtol=0)


@pytest.mark.parametrize("op", tk3.DYN3_FUSED_OPS)
@pytest.mark.parametrize("field", tk3.DYN3_FUSED_FIELDS)
def test_plain_matches_pallas_interpret(field, op):
    """Measured: fisheye pos <= 2.4e-6, det Q within 1.2e-5 of rtol 5e-5's
    allowance; vert pos <= 2.1e-6; the interface 1.6e-5 (its bar above).
    Every fisheye ray passes the fisheye's point focus at step 300, where
    det Q touches zero to within float32's rounding, so its sign there is
    the rounding's: on op6 one ray of 256 counts two sign changes where
    JAX's kernel and the float64 scan tier count none.  So on the fisheye
    KMAH and the focus locator (within 2 steps, JAX's :130) are held on 99 %
    of the rays, on vert and the interface (no focus) on every ray."""
    pos0, dir0, ds, steps, box = launch(field)
    j = jk3.dynamic3d_trace_final(pos0, dir0, ds, field=field, op=op,
                                  steps=steps, box=box, block_rays=R,
                                  interpret=True)
    t = tk3.dynamic3d_trace_final(pos0, dir0, ds, field=field, op=op,
                                  steps=steps, box=box, **CPU)
    if field == "interface":
        assert_close(t, j, pos_tol=INTERFACE_TOL, det=INTERFACE_DET)
    else:
        assert_close(t, j, kmah_share=0.99 if field == "fisheye" else 1.0)


def test_focus_locator_matches_pallas_interpret():
    """JAX's focus test (tests/test_dynamic_kernel3.py:115-131): the
    fisheye fan of spread 0.02 for one whole turn; min |det Q| collapses
    and the locator's step agrees with JAX's kernel within 2 steps on every
    ray."""
    pos0, dir0, ds, _, box = launch("fisheye", spread=0.02)
    kw = dict(field="fisheye", op="op6", steps=600, box=box)
    j = jk3.dynamic3d_trace_final(pos0, dir0, ds, block_rays=R,
                                  interpret=True, **kw)
    t = tk3.dynamic3d_trace_final(pos0, dir0, ds, **kw, **CPU)
    np.testing.assert_allclose(H.to_np(t.min_absdet_step),
                               np.asarray(j.min_absdet_step), atol=2)
    assert H.to_np(t.min_absdet).max() < 1e-4


@pytest.mark.parametrize("field", tk3.DYN3_FUSED_FIELDS)
def test_inlined_hessians(field):
    """field3_fn_h against torch.func.hessian of the port's Analytic3D n at
    float64 (JAX's bars: rtol 2e-5, atol 1e-7, tests/test_dynamic_kernel3.
    py:30-50) and against JAX's _field3_fn_h on the same points."""
    med = rtt.analytic_medium3(field)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.2, 1.2, (16, 3))
    if field == "interface":
        pts[:, 1] *= 0.01
    p = torch.as_tensor(pts)
    out = tk3.field3_fn_h(field)(p[:, 0], p[:, 1], p[:, 2])
    hess = torch.func.vmap(torch.func.hessian(
        lambda v: med.n3(v[0], v[1], v[2])))(p)
    n, g = med.n_and_grad3(p[:, 0], p[:, 1], p[:, 2])
    np.testing.assert_allclose(H.to_np(out[0]), H.to_np(n), rtol=1e-6)
    for a, b in zip(out[1:4], g):
        np.testing.assert_allclose(H.to_np(a), H.to_np(b), rtol=1e-6,
                                   atol=1e-12)
    idx = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    jout = jk3._field3_fn_h(field)(*(jnp.asarray(pts[:, k])
                                     for k in range(3)))
    for a, ij, jv in zip(out[4:], idx, jout[4:]):
        np.testing.assert_allclose(H.to_np(a), H.to_np(hess[:, ij[0], ij[1]]),
                                   rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(H.to_np(a), np.asarray(jv), rtol=2e-5,
                                   atol=1e-8)


def test_rotation_differential_is_the_derivative():
    """drodrigues3 is the exact derivative of rodrigues3v: against
    torch.func.jvp of the polynomial rotation at float64."""
    rng = np.random.default_rng(3)
    u, r, du, dr = (tuple(torch.as_tensor(c) for c in rng.normal(size=(3, 64)))
                    for _ in range(4))

    def rot(*v):
        return torch.stack(tk3.rodrigues3v(tk3._rot(v[:3], v[3:])))

    _, want = torch.func.jvp(rot, u + r, du + dr)
    got = tk3.drodrigues3(tk3._rot(u, r), du, dr)
    for k in range(3):
        np.testing.assert_allclose(H.to_np(got[k]), H.to_np(want[k]),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("medium", ["fisheye", "grid"])
def test_resume_equals_one_launch(medium):
    """k steps, then n - k with offset k, equal n steps to the bit, with a
    step limit inside the second launch and the focus locator at work; so
    does the replay form of the step, with its step index a 0-d tensor."""
    med = grid3_tables(_grid(12)) if medium == "grid" else "fisheye"
    pos0, dir0, _, _, box = launch("fisheye", r=64, spread=0.3)
    # a turn of 400 steps: the focus at step 200
    ds, steps, cut = 2 * np.pi / 400, 230, 90
    st = tk3.initial_dyn3_state(pos0, dir0, **CPU)
    kw = dict(field=med, op="op6", delta_s=ds, step_limit=220, box=box)
    one = tk3.dynamic3d_step(st, steps=steps, offset=0.0, **kw)
    two = tk3.dynamic3d_step(tk3.dynamic3d_step(st, steps=cut, offset=0.0,
                                                **kw),
                             steps=steps - cut, offset=float(cut), **kw)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert float(one.minstep.max()) > 5
    gi, rep = torch.tensor(3.0), st
    kw = dict(field=med, op="op6", delta_s=ds, step_limit=40.0, box=box)
    for _ in range(50):
        rep = tk3.dynamic3d_plain_step(rep, gi, **kw)
        gi += 1.0
    for a, b in zip(rep, tk3.dynamic3d_step_plain(st, steps=50, offset=3.0,
                                                  **kw)):
        assert torch.equal(a, b)


def test_step_limit_rounds_to_float32():
    pos0, dir0, ds, _, box = launch("fisheye", r=32)
    kw = dict(field="fisheye", op="op6", steps=300, box=box, **CPU)
    a = tk3.dynamic3d_trace_final(pos0, dir0, ds, step_limit=150 + 1e-6,
                                  **kw)
    b = tk3.dynamic3d_trace_final(pos0, dir0, ds, step_limit=150, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- the kernel header on the host --------------------------------------------

def _grid(n):
    ax = np.linspace(-1.6, 1.6, n)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    return rtt.c1_medium3_from_samples(1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2),
                                       ax, ax, ax, **CPU)


_STUBS = """#define __host__
#define __device__
#define __forceinline__ inline
#include "dynamic3d.cuh"
"""
_HOST_LOOP = """
template <class M, int OP>
static void go(float* const* p, int n, int steps, float ds, float limit,
               float offset, const float* box, const M& m) {
  for (int r = 0; r < n; ++r) {
    auto v3 = [&](int k) {
      return rt3::V3{p[k][r], p[k + 1][r], p[k + 2][r]};
    };
    rt3::Dyn3 s{v3(0), v3(3), v3(6), v3(9), v3(12), v3(15), p[18][r],
                p[19][r], reinterpret_cast<bool*>(p[20])[r], p[21][r],
                p[22][r], p[23][r], p[24][r]};
    rt3::run_dyn3<M, OP>(s, steps, ds, limit, offset, box, m);
    const rt3::V3 vs[6] = {s.pos, s.u, s.dpa, s.dua, s.dpb, s.dub};
    for (int k = 0; k < 6; ++k) {
      p[3 * k][r] = vs[k].x;
      p[3 * k + 1][r] = vs[k].y;
      p[3 * k + 2][r] = vs[k].z;
    }
    p[18][r] = s.tt;
    p[19][r] = s.dsim;
    reinterpret_cast<bool*>(p[20])[r] = s.active;
    p[21][r] = s.sgn;
    p[22][r] = s.kmah;
    p[23][r] = s.mind;
    p[24][r] = s.minstep;
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
    """csrc/dynamic3d.cuh's run_dyn3 built for the host by g++
    (-ffp-contract=off, the CUDA qualifiers stubbed)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/dynamic3d.cuh")
    tmp = tmp_path_factory.mktemp("dynamic3d_host")
    src, lib = tmp / "dynamic3d_host.cpp", tmp / "dynamic3d_host.so"
    src.write_text(_STUBS + _HOST_LOOP)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.host_step.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p]
                             + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                             + [ctypes.c_void_p] * 4)

    def run(st, field, op, steps, ds, limit, box):
        out = tk3.Dyn3State(*(t.clone() for t in st))
        geo, nodes, table = (ctypes.c_float * 6)(), (ctypes.c_int * 3)(), None
        if isinstance(field, tk3.Grid3Tables):
            code, table = 3, field.table.data_ptr()
            geo = (ctypes.c_float * 6)(field.x0, field.y0, field.z0,
                                       field.inv_hx, field.inv_hy,
                                       field.inv_hz)
            nodes = (ctypes.c_int * 3)(field.nx, field.ny, field.nz)
        else:
            code = FIELD_CODES[field]
        so.host_step(code, int(op[2:]), build.pointer_array(out),
                     st.x.shape[0], steps, float(np.float32(ds)), limit, 0.0,
                     (ctypes.c_float * 6)(*box), table, geo, nodes)
        return out
    return run


@pytest.mark.parametrize("op", tk3.DYN3_FUSED_OPS)
@pytest.mark.parametrize("field", ["fisheye", "vert_heterogeneous", "grid"])
def test_header_step_loop_on_the_host_equals_plain(field, op, host_loop,
                                                   monkeypatch):
    """run_dyn3 on the host against dynamic3d_step_plain, all 25 planes to
    the bit: random rays that leave the box, and a fan through the
    fisheye's focus (KMAH and the locator at work).

    As for the kinematic header (tests/test_torch_fused3d.py): PyTorch's
    CPU sqrt is not correctly rounded, so the plain version runs with an
    IEEE square root here, and the interface (glibc's expf against
    PyTorch's CPU exp) is left to the card."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda t: sqrt(t.double()).float())
    med = grid3_tables(_grid(12)) if field == "grid" else field
    rng = np.random.default_rng(0)
    th = np.pi / 2 + np.linspace(-0.3, 0.3, 256)
    pos0 = np.concatenate([rng.uniform(-1, 1, (256, 3)),
                           np.tile([[1.0, 0.0, 0.0]], (256, 1))])
    dir0 = np.concatenate([rng.normal(size=(256, 3)),
                           np.stack([np.cos(th), np.sin(th),
                                     np.linspace(-0.4, 0.4, 256)], -1)])
    st = tk3.initial_dyn3_state(pos0, dir0, **CPU)
    ds, steps, limit = 2 * np.pi / 600, 420, 410.0
    plain = tk3.dynamic3d_step_plain(st, field=med, op=op, steps=steps,
                                     delta_s=ds, step_limit=limit,
                                     offset=0.0, box=BOX)
    host = host_loop(st, med, op, steps, ds, limit, BOX)
    for name, a, b in zip(tk3.Dyn3State._fields, plain, host):
        assert torch.equal(a, b), name
    assert int((~plain.active).sum()) > 0
    if field != "vert_heterogeneous":
        assert float(plain.kmah.max()) > 0 and float(plain.minstep.max()) > 5


# -- interop, routes, errors ------------------------------------------------

def test_state_interop_and_a_jax_launch_state_resumed():
    """The JAX tiled3 dynamic layout (25 components, ``active`` as 0/1) to
    the port's state and back; JAX's launch state (engine/tiled3.py:
    555-566: its normalization and transverse frame) equals the port's to
    an ulp (JAX normalizes by ``jnp.linalg.norm``, the port by the square
    root of the sum), and the port's run resumed from it stays within 2e-6
    of the port's own run after 200 steps."""
    rng = np.random.default_rng(4)
    comps = [rng.normal(size=(4, 128)).astype(np.float32) for _ in range(25)]
    comps[20] = (rng.uniform(size=(4, 128)) > 0.5).astype(np.float32)
    st = dyn3_state_from_numpy(comps, **CPU)
    assert st.active.dtype == torch.bool and st.x.shape == (512,)
    for a, b in zip(dyn3_state_to_numpy(st), comps):
        np.testing.assert_array_equal(a, b.reshape(-1))
    with pytest.raises(ValueError, match="25"):
        dyn3_state_from_numpy(comps[:24], **CPU)

    pos0, dir0, ds, _, box = launch("fisheye", r=128, spread=0.3)
    from raytracing_tpu.engine.tiled3 import _as_f32_rays
    p, d = _as_f32_rays(pos0, dir0)
    e1, e2 = jd._transverse_frame(d)
    z = np.zeros(128, np.float32)
    jcomps = ([np.asarray(p[:, k]) for k in range(3)]
              + [np.asarray(d[:, k]) for k in range(3)] + [z] * 3
              + [np.asarray(e1[:, k]) for k in range(3)] + [z] * 3
              + [np.asarray(e2[:, k]) for k in range(3)]
              + [z, z, z + 1, z, z, z + np.finfo(np.float32).max, z])
    jst = dyn3_state_from_numpy(jcomps, **CPU)
    own = tk3.initial_dyn3_state(pos0, dir0, **CPU)
    for name, a, b in zip(tk3.Dyn3State._fields, jst, own):
        torch.testing.assert_close(a, b, rtol=0, atol=1.2e-7, msg=name)
    kw = dict(field="fisheye", op="op6", steps=200, delta_s=ds,
              step_limit=200, offset=0.0, box=box)
    a, b = tk3.dynamic3d_step(jst, **kw), tk3.dynamic3d_step(own, **kw)
    for name, x, y in zip(tk3.Dyn3State._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=2e-6, msg=name)


def test_fast_dynamic3_routes_match_jax():
    """fast_dynamic3's routes against JAX's on the same media and rays:
    "dynamic3-kernel" (the plain version against JAX's interpret kernel,
    the analytic bars above) and "dynamic3-scan" (a Stratified3D, the
    float32 scan tiers against each other within JAX's kernel-against-scan
    bar, 5e-5); "active" is containment on both; any batch size."""
    pos0, dir0, ds, _, box = launch("fisheye", r=200)
    kw = dict(pos0=pos0, dir0=dir0, delta_s=float(ds), steps=120, box=box)
    j, jeng = jfast.fast_dynamic3("op6", jf3.analytic_medium3("fisheye"),
                                  block_rays=256, interpret=True, **kw)
    t, teng = rtt.fast_dynamic3("op6", rtt.analytic_medium3("fisheye"),
                                **kw, **CPU)
    assert teng == jeng == "dynamic3-kernel" and t.pos.shape == (200, 3)
    assert_close(t, j)
    vert = __import__("raytracing_tpu").analytic_medium("vert_heterogeneous")
    j, jeng = jfast.fast_dynamic3("op8", jf3.Stratified3D(vert), **kw)
    t, teng = rtt.fast_dynamic3(
        "op8", rtt.Stratified3D(rtt.analytic_medium("vert_heterogeneous")),
        **kw, **CPU)
    assert teng == jeng == "dynamic3-scan"
    assert_close(t, j, pos_tol=5e-5, det=(5e-5, 1e-8))


def test_named_errors():
    pos0, dir0, ds, _, box = launch("fisheye", r=8)
    kw = dict(steps=8, box=box, **CPU)
    with pytest.raises(ValueError, match="fields"):
        tk3.dynamic3d_trace_final(pos0, dir0, ds, field="warp", op="op6",
                                  **kw)
    with pytest.raises(ValueError, match="ops"):
        tk3.dynamic3d_trace_final(pos0, dir0, ds, field="fisheye", op="op5",
                                  **kw)
    with pytest.raises(ValueError, match="box"):
        tk3.dynamic3d_trace_final(pos0, dir0, ds, field="fisheye", op="op6",
                                  steps=8, box=box[:4], **CPU)
    st = tk3.initial_dyn3_state(pos0, dir0, **CPU)
    with pytest.raises(ValueError, match="state.kmah"):
        tk3.dynamic3d_step(st._replace(kmah=st.kmah.double()),
                           field="fisheye", op="op6", steps=2, delta_s=0.01,
                           step_limit=2, box=box)
    with pytest.raises(ValueError, match="fast_dynamic3 needs a 6-face box"):
        rtt.fast_dynamic3("op6", rtt.analytic_medium3("fisheye"), pos0=pos0,
                          dir0=dir0, delta_s=0.01, steps=2, box=box[:4],
                          **CPU)
    with pytest.raises(ValueError, match="planar"):
        rtt.fast_dynamic3("op5", rtt.analytic_medium3("fisheye"), pos0=pos0,
                          dir0=dir0, delta_s=0.01, steps=2, box=box, **CPU)


def test_kernel_infos():
    assert [k.name for k in tk3.KERNELS] == ["dynamic3d_step",
                                             "dynamic3d_step_grid"]
    assert tk3.KERNEL.replaces == "raytracing_tpu/kernels/dynamic3d.py:546"
    assert tk3.KERNEL_GRID.replaces == "raytracing_tpu/engine/tiled3.py:233"
    for k in tk3.KERNELS:
        assert k.source == "raytracing_tpu_torch/csrc/dynamic3d.cu"
    assert {"rt_dynamic3d_step", "rt_dynamic3d_step_grid"} <= set(
        build.MAIN_ENTRIES)
    assert tk3.DYN3_FUSED_OPS == jk3.DYN3_FUSED_OPS
    assert tk3.DYN3_FUSED_FIELDS == jk3.DYN3_FUSED_FIELDS
