"""utils/fma.py::fma32, the plain versions' float32 fused multiply-add,
against the kernels' own: csrc/common.cuh's ``fma_rn`` (``fmaf``) built for
the host with g++ (-ffp-contract=off, the CUDA qualifiers stubbed), whose
C library ``fmaf`` is correctly rounded.  Every result bit for bit (NaN
against NaN): random triples over every bit pattern and over moderate
exponents with cancelling sums, the constructed cases where p + c rounds
in float64 onto a float32 midpoint with an error of either sign (where
narrowing the float64 sum would round twice, and does round the other
way: the test checks that it would), signed zeros, subnormal results and
exact cancellation.  On the card, chip_smoke.py's [fma32] phase holds the
card's fmaf to fma32 on the card.  Skipped where g++ is missing."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracing_tpu_torch.bench import fma_triples  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.utils.fma import fma32  # noqa: E402

_SRC = r"""#define __host__
#define __device__
#define __forceinline__ inline
#include "common.cuh"
extern "C" void host_fma(const float* a, const float* b, const float* c,
                         float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = rt::fma_rn(a[i], b[i], c[i]);
}
"""


@pytest.fixture(scope="module")
def host_fma(tmp_path_factory):
    """common.cuh's fma_rn built for the host: (a, b, c) float32 numpy
    arrays -> float32 numpy array."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/common.cuh")
    tmp = tmp_path_factory.mktemp("fma_host")
    src, lib = tmp / "fma_host.cpp", tmp / "fma_host.so"
    src.write_text(_SRC)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.host_fma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long]
    so.host_fma.restype = None

    def run(a, b, c):
        a, b, c = (np.ascontiguousarray(v, np.float32) for v in (a, b, c))
        out = np.empty_like(a)
        so.host_fma(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                    out.ctypes.data, a.size)
        return out
    return run


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def assert_same_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    both_nan = np.isnan(got) & np.isnan(want)
    diff = (got.view(np.uint32) != want.view(np.uint32)) & ~both_nan
    assert not diff.any(), (
        f"{int(diff.sum())} of {got.size} differ, e.g. index "
        f"{int(np.argmax(diff))}")


def _fma32(a, b, c):
    return fma32(*(torch.as_tensor(np.asarray(v, np.float32))
                   for v in (a, b, c))).numpy()


@pytest.mark.parametrize("kind", ["bits", "moderate"])
def test_fma32_equals_host_fmaf_on_random_triples(kind, host_fma):
    """2^20 seeded triples a family (2^21 in all)."""
    rng = np.random.default_rng({"bits": 1, "moderate": 2}[kind])
    a, b, c = fma_triples(kind, 1 << 20, rng)
    assert_same_bits(_fma32(a, b, c), host_fma(a, b, c))


@pytest.mark.parametrize("subnormal", [False, True])
def test_fma32_on_float64_midpoints(subnormal, host_fma):
    """Where p + c rounds onto a float32 midpoint in float64, with errors of
    both signs: narrowing the float64 sum would round the wrong way on
    about half of them (checked), fma32 on none."""
    rng = np.random.default_rng(3 + subnormal)
    a, b, c = fma_triples("midpoint-subnormal" if subnormal else "midpoint",
                          1 << 16, rng)
    want = host_fma(a, b, c)
    s = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    twice = s.astype(np.float32)
    assert (twice != want).mean() > 0.3
    assert_same_bits(_fma32(a, b, c), want)


def test_fma32_zeros_subnormals_and_cancellation(host_fma):
    zeros = np.array([0.0, -0.0], np.float32)
    a, b, c = (v.ravel() for v in np.meshgrid(zeros, zeros, zeros))
    assert_same_bits(_fma32(a, b, c), host_fma(a, b, c))
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32)
    y = rng.standard_normal(4096).astype(np.float32)
    # exact cancellation: a b = -c exactly (b a power of two)
    p2 = (2.0 ** rng.integers(-5, 5, 4096)).astype(np.float32)
    exact = -(x * p2)
    for a, b, c in ((x, p2, exact), (-x, p2, -exact),
                    # subnormal results: tiny products, tiny sums
                    (x * np.float32(2 ** -70), y * np.float32(2 ** -70),
                     _f32(rng.integers(0, 1 << 23, 4096, dtype=np.uint64))),
                    (x, y, -(x.astype(np.float64) * y).astype(np.float32))):
        assert_same_bits(_fma32(a, b, c), host_fma(a, b, c))


def test_fma32_takes_scalars_as_float32():
    t = torch.tensor([0.1, 0.7, 1.3], dtype=torch.float32)
    want = fma32(torch.full_like(t, 2.0), t, torch.full_like(t, -3.0))
    assert torch.equal(fma32(2.0, t, -3.0), want)
    assert fma32(t, 0.1, t).dtype == torch.float32
    assert torch.equal(fma32(t, 0.1, t),
                       fma32(t, torch.full_like(t, 0.1), t))
