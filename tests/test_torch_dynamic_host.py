"""The 2-D dynamic kernels' header (raytracing_tpu_torch/csrc/dynamic.cuh)
built for the host with g++, against the plain PyTorch version, and the
division by a shared reciprocal (csrc/common.cuh ``recip``, ``div_by``)
against IEEE division.

dynamic.cuh holds one ray's work as ``__host__ __device__`` functions on
its carry (``load_dyn``, ``run_dyn``, ``store_dyn``) on the media of
media.cuh; with the CUDA qualifiers stubbed and contraction off
(-ffp-contract=off) g++ builds the same loop on the CPU.  The tests hold it
to ``dynamic_step_plain`` on all 18 planes, to the bit: op1, op2, op6 and
op8 on the analytic fisheye and vert fields, both stratified forms and both
2-D grid forms, under a step limit shorter than the launch and as a chain of
two launches (k + (n - k) steps = n).  The analytic interface is left to
the card: glibc's ``expf`` and PyTorch's CPU ``exp`` differ by an ulp.
PyTorch's CPU ``sqrt`` is not correctly rounded, so the plain version runs
here with an IEEE square root, and ``rsqrt`` as one division by it, which
is what the header's host build computes (on the card the kernel and
``torch.rsqrt`` share ``rsqrtf``).

``div_by`` forms a quotient from its denominator's reciprocal by
Markstein's correction, with explicit FMAs, where the operands are in its
guard's ranges, and divides otherwise; it must give the IEEE quotient's
bits for every pair: 10^6 seeded pairs over every exponent and around the
guard's thresholds, a stride through all 2^32 numerators over the 3-D
loop's constant denominators 60 and 360, and the edges (signed zeros,
subnormals, the 2^-126 boundary, the thresholds and their neighbours, the
largest finite numbers, infinities, NaN).  glibc's ``fmaf`` is correctly
rounded, as the card's FFMA is.  The card-only tests check all 2^32
numerators and 2^28 pairs against ``__fdiv_rn`` (tests/test_torch_cuda.py).
Skipped where g++ is missing."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import segmented as seg  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import dynamic as kd  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402

CPU = dict(device="cpu")

_STUBS = """#define __host__
#define __device__
#define __forceinline__ inline
#include "dynamic.cuh"
"""
# dynamic.cu's entry points, one ray after another, without the stream:
# medium 0 an analytic field (code rt::Field), 1 a stratified table (code =
# ch), 2 a 2-D grid (code = cell_ch)
_HOST_LOOP = """
template <class M>
static void ops(int op, const rt::DynArgs& a, const M& m) {
  for (int r = 0; r < a.n; ++r) {
    rt::Dyn s = rt::load_dyn(a, r);
    if (op == 1) rt::run_dyn<M, 1>(a, m, s);
    if (op == 2) rt::run_dyn<M, 2>(a, m, s);
    if (op == 6) rt::run_dyn<M, 6>(a, m, s);
    if (op == 8) rt::run_dyn<M, 8>(a, m, s);
    rt::store_dyn(a, r, s);
  }
}
extern "C" void host_dynamic(int medium, int code, int op, void* const* in,
                             void* const* out, int n, int steps, float ds,
                             float limit, float offset, float bx0, float bx1,
                             float by0, float by1, RT_TABLE_PARAMS) {
  rt::DynArgs a;
  for (int k = 0; k < rt::NDSLOTS; ++k) {
    a.in.p[k] = in[k];
    a.out.p[k] = out[k];
  }
  a.n = n;
  a.steps = steps;
  a.ds = ds;
  a.limit = limit;
  a.offset = offset;
  a.box[0] = bx0;
  a.box[1] = bx1;
  a.box[2] = by0;
  a.box[3] = by1;
  if (medium == 0 && code == 0) ops(op, a, rt::Analytic<rt::FISHEYE>{});
  if (medium == 0 && code == 1) ops(op, a, rt::Analytic<rt::VERT>{});
  if (medium == 1 && code == 6) ops(op, a, rt::Strat<6>{RT_TABLE});
  if (medium == 1 && code == 4) ops(op, a, rt::Strat<4>{RT_TABLE});
  if (medium == 2 && code == 36) ops(op, a, rt::Grid<36>{RT_TABLE});
  if (medium == 2 && code == 16) ops(op, a, rt::Grid<16>{RT_TABLE});
}
extern "C" void host_div_by(const float* a, const float* b, float* q,
                            long long n) {
  for (long long i = 0; i < n; ++i) q[i] = rt::div_by(a[i], rt::recip(b[i]));
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/dynamic.cuh built for the host by g++ (-O2 -ffp-contract=off,
    the CUDA qualifiers stubbed)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/dynamic.cuh")
    tmp = tmp_path_factory.mktemp("dynamic_host")
    src, lib = tmp / "dynamic_host.cpp", tmp / "dynamic_host.so"
    src.write_text(_STUBS + _HOST_LOOP)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    # medium, code, then rt_dynamic_step's arguments after field, less the
    # stream, then the table's
    so.host_dynamic.argtypes = ([_I, _I]
                                + list(build._SIGNATURES["rt_dynamic_step"]
                                       [1:-1])
                                + [_P, _F, _F, _F, _F, _I, _I])
    so.host_dynamic.restype = None
    so.host_div_by.argtypes = [_P, _P, _P, ctypes.c_longlong]
    so.host_div_by.restype = None
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


def host_step(so, st, *, field, op, steps, delta_s, step_limit, offset=0.0,
              box):
    """dynamic.cuh's loop on the host, on a copy of ``st``'s planes."""
    out = kd.DynState(*(torch.full_like(t, float("nan"))
                        if t.is_floating_point() else ~t for t in st))
    if isinstance(field, kfu.StratTables):
        medium, code = 1, field.ch
        table = (field.table.data_ptr(), 0.0, field.y0, 0.0, field.inv_hy, 0,
                 field.ny)
    elif isinstance(field, kfu.GridTables):
        medium, code = 2, field.cell_ch
        table = (field.table.data_ptr(), field.x0, field.y0, field.inv_hx,
                 field.inv_hy, field.nx, field.ny)
    else:
        medium, code = 0, kfu.FIELD_CODES[field]
        table = (None, 0.0, 0.0, 0.0, 0.0, 0, 0)
    so.host_dynamic(medium, code, int(op[2:]), build.pointer_array(st),
                    build.pointer_array(out), st.x.shape[0], int(steps),
                    float(np.float32(delta_s)), float(step_limit),
                    float(offset), *(float(v) for v in box), *table)
    return out


def same(a, b):
    """Two dynamic states equal in every plane, to the bit."""
    for name, x, y in zip(kd.DynState._fields, a, b):
        view = torch.uint8 if x.dtype == torch.bool else torch.int32
        assert torch.equal(x.view(view), y.view(view)), name


@pytest.fixture(scope="module")
def tables():
    """The vert stratified tables and a coarse fisheye grid (delta 0.05),
    both forms of each, on the CPU."""
    vert, fish = rtt.scenario("vert"), rtt.scenario("fisheye")
    parity = rtt.build_hermite_medium(
        rtt.build_grid_medium("fisheye", fish.box, 0.05, **CPU))
    return {
        "strat6": kfu.strat_tables(rtt.build_stratified_medium(
            "vert_heterogeneous", vert.box, **CPU)),
        "strat4": kfu.strat_tables(rtt.build_c1_stratified(
            "vert_heterogeneous", vert.box, **CPU)),
        "grid36": seg.grid_tables(parity),
        "grid16": seg.grid_tables(rtt.build_c1_medium(
            "fisheye", fish.box, 0.05, **CPU)),
    }


RAYS = 200


def _case(kind, tables):
    """(field, pos0, theta0, delta_s, box) of one medium: fisheye rays over
    the unit square leaving a box of half-width 1.2 (analytic and grids),
    the vert fan in its box (analytic and stratified)."""
    rng = np.random.default_rng(3)
    if kind in ("fisheye", "grid36", "grid16"):
        pos0 = rng.uniform(-1.0, 1.0, (RAYS, 2))
        theta0 = rng.uniform(0.0, 2.0 * np.pi, RAYS)
        field = tables[kind] if kind in tables else kind
        return field, pos0, theta0, 0.05, (-1.2, 1.2, -1.2, 1.2)
    pos0, theta0 = H.fan_vert(rng, RAYS)
    field = tables[kind] if kind in tables else "vert_heterogeneous"
    return field, pos0, theta0, 0.05, H.VERT_BOX


@pytest.mark.parametrize("op", kd.DYN_FUSED_OPS)
@pytest.mark.parametrize("kind", ["fisheye", "vert", "strat6", "strat4",
                                  "grid36", "grid16"])
def test_header_loop_on_the_host_equals_plain(kind, op, host, ieee, tables):
    """run_dyn against dynamic_step_plain, all 18 planes to the bit: one
    launch under a step limit shorter than the launch, and a chain of two
    launches (offset k) under the same limit; some rays leave the box, and
    on the fisheye some pass a caustic."""
    field, pos0, theta0, ds, box = _case(kind, tables)
    st = kd.initial_dyn_state(pos0, theta0, **CPU)
    steps, limit, cut = 90, 70.0, 23
    kw = dict(field=field, op=op, delta_s=ds, step_limit=limit, box=box)
    plain = kd.dynamic_step_plain(st, steps=steps, offset=0.0, **kw)
    same(host_step(host, st, steps=steps, **kw), plain)
    first = host_step(host, st, steps=cut, **kw)
    same(host_step(host, first, steps=steps - cut, offset=float(cut), **kw),
         plain)
    assert int((~plain.active).sum()) > 0
    if kind == "fisheye":
        assert float(plain.kmah.max()) > 0


def header_div(so, a, b):
    """div_by(a, recip(b)) of the header, elementwise on float32 arrays."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(np.broadcast_to(np.float32(b), a.shape)
                             if np.ndim(b) == 0 else b, np.float32)
    q = np.empty_like(a)
    so.host_div_by(a.ctypes.data, b.ctypes.data, q.ctypes.data, a.size)
    return q


def assert_ieee(q, a, b):
    """q has the bits of the IEEE quotient a / b (numpy's float32 division)
    on every pair, NaN where it is NaN."""
    with np.errstate(all="ignore"):
        want = np.divide(a, b, dtype=np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(q), nan)
    bad = np.flatnonzero(q.view(np.uint32)[~nan] != want.view(np.uint32)[~nan])
    assert bad.size == 0, [(float(a[~nan][i]), float(np.broadcast_to(
        b, a.shape)[~nan][i])) for i in bad[:5]]


def _with_exponent(rng, n, lo, hi):
    """n float32 numbers of random mantissa and sign, exponents uniform in
    [lo, hi]."""
    bits = (rng.integers(0, 1 << 23, n, dtype=np.uint32)
            | ((rng.integers(lo, hi + 1, n) + 127).astype(np.uint32) << 23)
            | (rng.integers(0, 2, n, dtype=np.uint32) << 31))
    return bits.view(np.float32)


def test_div_by_equals_ieee_on_seeded_pairs(host):
    """10^6 seeded pairs: half random bit patterns (every exponent, zeros,
    subnormals, infinities, NaN), half random mantissas with exponents
    spanning the guard's thresholds (|a| 2^-66 .. 2^66, |b| 2^-34 .. 2^34)."""
    rng = np.random.default_rng(2024)
    n = 500_000
    a = np.concatenate([rng.integers(0, 1 << 32, n, dtype=np.uint64)
                        .astype(np.uint32).view(np.float32),
                        _with_exponent(rng, n, -66, 66)])
    b = np.concatenate([rng.integers(0, 1 << 32, n, dtype=np.uint64)
                        .astype(np.uint32).view(np.float32),
                        _with_exponent(rng, n, -34, 34)])
    assert_ieee(header_div(host, a, b), a, b)


@pytest.mark.parametrize("b", [60.0, 360.0])
def test_div_by_constant_denominators(host, b):
    """Every 4099th float32 bit pattern (about 10^6 numerators of every
    exponent and sign) over the 3-D loop's constant denominators."""
    a = np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    assert_ieee(header_div(host, a, np.float32(b)), a, np.float32(b))


def test_div_by_edges(host):
    """Every pair of edge values: signed zeros, the smallest and largest
    subnormals, the 2^-126 boundary, the guard's thresholds 2^+-32 (b) and
    2^+-64 (a) with their neighbours, the largest finite numbers,
    infinities, NaN, and ordinary values; each with both signs."""
    def near(x):
        x = np.float32(x)
        return [np.nextafter(x, np.float32(0)), x,
                np.nextafter(x, np.float32(np.inf))]

    f32 = np.finfo(np.float32)
    base = ([0.0, f32.smallest_subnormal, np.float32(2.0 ** -126)
             - f32.smallest_subnormal, np.inf, np.nan, 1.0, 3.0, 60.0, 360.0,
             0.1, f32.max] + near(2.0 ** -126) + near(2.0 ** -32)
            + near(2.0 ** 32) + near(2.0 ** -64) + near(2.0 ** 64)
            + near(2.0 ** -96) + near(2.0 ** 96) + near(f32.max / 2))
    edges = np.array(base, np.float32)
    edges = np.concatenate([edges, -edges])
    a, b = (m.ravel() for m in np.meshgrid(edges, edges))
    q = header_div(host, a, b)
    assert_ieee(q, a, b)
    # the signed zeros of a zero numerator: -0 / b is -0 for b > 0
    zero = (a == 0) & np.isfinite(b) & (b != 0)
    assert np.array_equal(np.signbit(q[zero]),
                          np.signbit(a[zero]) ^ np.signbit(b[zero]))
