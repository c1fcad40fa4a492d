"""fisheye_op1's loop (raytracing_tpu_torch/csrc/fisheye.cuh) and the
fast-path arithmetic of csrc/common.cuh, built for the host with g++.

* ``rcp_fix``, the correction that turns the card's approximate reciprocal
  into the correctly rounded one: from each seed within an ulp of 1/b (the
  floats just below and just above it) it gives IEEE ``1/b`` for all 2^23
  mantissas at exponents across ``rcp_in_range``'s guard, save the one
  case Markstein's theorem leaves out (b's mantissa all ones and the seed
  the power of two below 1/b, where the correction is a tie); beyond the
  guard's upper end it would fail, and the guard refuses those b.  Which
  seed the card's MUFU.RCP gives is checked on the card against
  ``__frcp_rn`` for all 2^32 denominators (tests/test_torch_cuda.py,
  chip_smoke.py ``[div_by]``).
* ``div_fast_pos``, the fused step's quotient from a carried positive
  reciprocal: the IEEE quotient's bits on seeded pairs and the edges,
  zero numerators of both signs on its fast path.
* ``fisheye_op1_run``, the loop of the ``fisheye_op1`` kernel, against the
  unchanged ``fisheye_op1_plain``: x, y and tt to the bit, at an even and
  an odd step count, with the traveltime increment as ``half * (n + n2)``
  (rays near the origin) and as ``ds * (n + n2) * 0.5`` (rays whose reach
  leaves the range where the two round alike).

The plain version runs with an IEEE square root, and ``torch.rsqrt`` as
one division by it, which is what the header's host build computes (on the
card the kernel's ``rsqrt_fast`` and ``torch.rsqrt`` share ``rsqrtf``'s
bits).  glibc's ``fmaf`` is correctly rounded, as the card's FFMA is.
Skipped where g++ is missing."""
import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import fisheye as kf  # noqa: E402
from raytracing_tpu_torch.kernels import fused as kfu  # noqa: E402

_SOURCE = r"""#define __host__
#define __device__
#define __forceinline__ inline
#include <string.h>
#include "fisheye.cuh"

static float bits_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
static uint32_t float_bits(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }

// For b = (1 + m 2^-23) 2^e, every mantissa m: the seeds within an ulp of
// 1/b (the floats just below and just above it, RN(1/b) alone where 1/b is
// a float); counts[0] the seeds tried, counts[1] those whose correction is
// not 1.0f / b, counts[2] those of them that are the documented tie (m all
// ones, the seed the power of two below 1/b, the result the seed);
// counts[3] the b outside rcp_in_range
extern "C" void host_rcp_sweep(int e, long long* counts) {
  for (uint32_t m = 0; m < (1u << 23); ++m) {
    const float b = bits_float((uint32_t)(e + 127) << 23 | m);
    const float rn = 1.0f / b;
    if (!rt::rcp_in_range(b)) ++counts[3];
    // 1 - b rn, exact in double (b rn has at most 48 significant bits)
    const double r = 1.0 - (double)b * (double)rn;
    float seeds[2] = {rn, rn};
    int k = 1;
    if (r > 0.0) seeds[k++] = nextafterf(rn, INFINITY);   // rn below 1/b
    if (r < 0.0) seeds[k++] = nextafterf(rn, -INFINITY);  // rn above 1/b
    for (int j = 0; j < k; ++j) {
      ++counts[0];
      const float y = rt::rcp_fix(b, seeds[j]);
      if (float_bits(y) == float_bits(rn)) continue;
      ++counts[1];
      const bool pow2 = (float_bits(seeds[j]) & 0x7fffffu) == 0u;
      if (m == 0x7fffffu && pow2 && seeds[j] < rn && y == seeds[j])
        ++counts[2];
    }
  }
}

// div_fast_pos(a, recip_pos(b)), the IEEE division where its guard fails
// (as the fused step takes it), and whether the fast path held
extern "C" void host_div_pos(const float* a, const float* b, float* q,
                             unsigned char* fast, long long n) {
  for (long long i = 0; i < n; ++i) {
    const rt::Recip d = rt::recip_pos(b[i]);
    bool ok = true;
    const float f = rt::div_fast_pos(a[i], d, ok);
    q[i] = ok ? f : a[i] / b[i];
    fast[i] = ok;
  }
}

extern "C" void host_fisheye(const float* x, const float* y, const float* ux,
                             const float* uy, float* ox, float* oy,
                             float* ott, unsigned char* by_half, int n,
                             int steps, float ds) {
  for (int r = 0; r < n; ++r) {
    rt::fisheye_op1_run(x[r], y[r], ux[r], uy[r], steps, ds, ox[r], oy[r],
                        ott[r]);
    by_half[r] = rt::tt_by_half(x[r], y[r], ux[r], uy[r], ds, steps);
  }
}
"""

_P = ctypes.c_void_p


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """fisheye.cuh and common.cuh built for the host by g++ (-O2
    -ffp-contract=off, the CUDA qualifiers stubbed)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/fisheye.cuh")
    tmp = tmp_path_factory.mktemp("fisheye_host")
    src, lib = tmp / "fisheye_host.cpp", tmp / "fisheye_host.so"
    src.write_text(_SOURCE)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.host_rcp_sweep.argtypes = [ctypes.c_int, _P]
    so.host_rcp_sweep.restype = None
    so.host_div_pos.argtypes = [_P] * 4 + [ctypes.c_longlong]
    so.host_div_pos.restype = None
    so.host_fisheye.argtypes = [_P] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float]
    so.host_fisheye.restype = None
    return so


@pytest.mark.parametrize("e", [-126, -125, -33, -32, -1, 0, 31, 32, 124,
                               125])
def test_rcp_correction_from_every_faithful_seed(host, e):
    """Every mantissa at exponent e (b in [2^e, 2^(e+1)), inside the guard):
    from both seeds within an ulp of 1/b the correction gives 1.0f / b,
    save the one documented tie."""
    counts = (ctypes.c_longlong * 4)()
    host.host_rcp_sweep(e, counts)
    tried, wrong, tie, outside = counts
    assert outside == 0
    assert tried > (1 << 23)          # two seeds wherever 1/b is no float
    assert wrong == tie == 1


@pytest.mark.parametrize("e", [126, 127])
def test_rcp_guard_refuses_where_the_correction_fails(host, e):
    """At exponents 126 and 127 1/b is subnormal or nearly so and the
    correction fails for some seeds; rcp_in_range refuses every such b."""
    counts = (ctypes.c_longlong * 4)()
    host.host_rcp_sweep(e, counts)
    tried, wrong, tie, outside = counts
    assert outside == 1 << 23
    assert wrong > tie


def div_pos(so, a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(np.broadcast_to(np.float32(b), a.shape)
                             if np.ndim(b) == 0 else b, np.float32)
    q, fast = np.empty_like(a), np.zeros(a.shape, np.uint8)
    so.host_div_pos(a.ctypes.data, b.ctypes.data, q.ctypes.data,
                    fast.ctypes.data, a.size)
    return q, fast.astype(bool)


def assert_ieee(q, a, b):
    with np.errstate(all="ignore"):
        want = np.divide(a, b, dtype=np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(q), nan)
    bad = np.flatnonzero(q.view(np.uint32)[~nan] != want.view(np.uint32)[~nan])
    assert bad.size == 0, [(float(a[~nan][i]), float(np.broadcast_to(
        b, a.shape)[~nan][i])) for i in bad[:5]]


def test_div_fast_pos_equals_ieee(host):
    """10^6 seeded pairs (random bit patterns of every exponent and sign,
    and random mantissas around the guard's thresholds with positive
    denominators), a stride through all numerators over the fused step's
    typical n, and the edges with both signs: the IEEE quotient's bits;
    zero numerators over positive b stay on the fast path with the signed
    zero a / b."""
    rng = np.random.default_rng(12)
    n = 500_000

    def with_exponent(lo, hi, signed=True):
        bits = (rng.integers(0, 1 << 23, n, dtype=np.uint32)
                | ((rng.integers(lo, hi + 1, n) + 127).astype(np.uint32)
                   << 23)
                | (rng.integers(0, 2, n, dtype=np.uint32) << 31
                   if signed else np.uint32(0)))
        return bits.view(np.float32)

    a = np.concatenate([rng.integers(0, 1 << 32, n, dtype=np.uint64)
                        .astype(np.uint32).view(np.float32),
                        with_exponent(-102, 102)])
    b = np.concatenate([rng.integers(0, 1 << 32, n, dtype=np.uint64)
                        .astype(np.uint32).view(np.float32),
                        with_exponent(-18, 18, signed=False)])
    q, fast = div_pos(host, a, b)
    assert_ieee(q, a, b)
    assert fast[n:].mean() > 0.5
    stride = np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    for d in (1.0, 0.5, 0.0555555559694767, 1.2071068286895752):
        assert_ieee(div_pos(host, stride, d)[0], stride, np.float32(d))
    f32 = np.finfo(np.float32)
    def near(x):
        x = np.float32(x)
        return [np.nextafter(x, np.float32(0)), x,
                np.nextafter(x, np.float32(np.inf))]

    base = np.array([0.0, f32.smallest_subnormal, 2.0 ** -126, 1.0, 3.0,
                     0.1, f32.max, np.inf, np.nan] + near(2.0 ** -100)
                    + near(2.0 ** 100) + near(2.0 ** -16) + near(2.0 ** 16),
                    np.float32)
    edges = np.concatenate([base, -base])
    a, b = (m.ravel() for m in np.meshgrid(edges, edges))
    q, fast = div_pos(host, a, b)
    assert_ieee(q, a, b)
    zero = (a == 0) & (b >= 2.0 ** -16) & (b <= 2.0 ** 16)
    assert zero.sum() == 2 * 7 and fast[zero].all()
    assert np.array_equal(np.signbit(q[zero]), np.signbit(a[zero]))


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


def host_fisheye(so, x, y, ux, uy, steps, ds):
    n = x.shape[0]
    out = [torch.empty(n) for _ in range(3)]
    half = np.zeros(n, np.uint8)
    so.host_fisheye(*(t.data_ptr() for t in (x, y, ux, uy, *out)),
                    half.ctypes.data, n, steps, float(np.float32(ds)))
    return out, half.astype(bool)


@pytest.mark.parametrize("steps", [90, 91])
def test_fisheye_loop_on_the_host_equals_plain(host, ieee, steps):
    """fisheye_op1_run against fisheye_op1_plain, x, y and tt to the bit:
    the headline's ray and 300 rays over the unit disk in every direction
    (the traveltime by half * (n + n2)), and 40 rays launched far out,
    whose reach passes 2^30 (by ds * (n + n2) * 0.5), at an even and an odd
    step count."""
    rng = np.random.default_rng(5)
    far = rng.uniform(1.0, 2.0, (40, 2)) * rng.choice([-3e9, 3e9], (40, 2))
    pos = np.concatenate([[[1.0, 0.0]], rng.uniform(-1.0, 1.0, (300, 2)),
                          far])
    th = np.concatenate([[math.pi / 2.0], rng.uniform(0.0, 2 * math.pi,
                                                      340)])
    x, y = (torch.tensor(pos[:, k], dtype=torch.float32) for k in (0, 1))
    th = torch.tensor(th, dtype=torch.float32)
    ux, uy = torch.cos(th), torch.sin(th)
    ds = 2.0 * math.pi / 301
    (hx, hy, htt), by_half = host_fisheye(host, x, y, ux, uy, steps, ds)
    px, py, ptt = kf.fisheye_op1_plain(x, y, ux, uy, ds, steps)
    for got, want in ((hx, px), (hy, py), (htt, ptt)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert by_half[:301].all() and not by_half[301:].any()
    assert torch.isfinite(htt).all() and float(htt[0]) > 0.0
