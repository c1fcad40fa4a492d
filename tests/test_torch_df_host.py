"""The df32 kernels' header (raytracing_tpu_torch/csrc/df.cuh) built for the
host with g++, against the plain PyTorch version.

df.cuh holds the df32 step loop and its five media as ``__host__
__device__`` code; with the CUDA qualifiers stubbed and contraction off
(-ffp-contract=off) g++ builds the same loop on the CPU.  Its exact product
is one product and one fused multiply-add, ``fmaf(a, b, -a * b)``, where the
plain version (kernels/df.py::two_prod, JAX's ``_two_prod``) runs Dekker's
split chain: the two give the same bits wherever the product's error is a
float32 number, which the tests below map.  The loop is then held to
``df_step_plain`` on all five media, every one of the 8 planes to the bit,
in the form the kernel runs there: the FMA form (each low-word sum of
products one ``fmaf``, the plain version's ``fma32``) on the analytic
fields and the profile, JAX's roundings on the two grids.  glibc's
``fmaf`` is correctly rounded, as the card's FFMA is.  Skipped where g++ is
missing."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch_port_helpers as H
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.engine import df_grid as tdg  # noqa: E402
from raytracing_tpu_torch.kernels import build  # noqa: E402
from raytracing_tpu_torch.kernels import df as tdf  # noqa: E402

#: the coarse fisheye grid (177 x 177 nodes) keeps the plain version quick
DELTA = 0.05
RAYS, STEPS = 512, 200
#: the media whose kernel runs the FMA form (kernels/df.py fma_form)
FMA_KINDS = ("fisheye", "vert_heterogeneous", "profile")
#: the largest |dpos| between the FMA form and JAX's roundings after STEPS
#: steps of _launch's rays, measured 7.07e-8, 3.64e-12 and 2.84e-14: the
#: forms part in the low words, and on the fisheye's jittered fan, where a
#: low word flips the rounding of the angle's high word, the float32-only
#: rotation carries one float32 ulp of the angle into the tangent on a few
#: rays, whose positions then drift apart.  JAX's eager and jitted bodies
#: part the same way, by more (tests/df_form_spread.py)
FORM_GAP = {"fisheye": 1e-7, "vert_heterogeneous": 1e-11, "profile": 1e-13}

_STUBS = """#define __host__
#define __device__
#define __forceinline__ inline
#include "df.cuh"
"""
# the C entry points of df.cu, one ray after another, without the stream
_HOST_LOOP = """
#define RT_DF_PARAMS \\
  void *const *in, void *const *out, int n, int steps, float ds
#define RT_DF_GEOMETRY \\
  float x0h, float x0l, float y0h, float y0l, float ihxh, float ihxl, \\
      float ihyh, float ihyl, int nx, int ny

template <class M>
static void go(RT_DF_PARAMS, const M& m) {
  for (int r = 0; r < n; ++r) {
    float s[8];
    for (int j = 0; j < 8; ++j) s[j] = static_cast<const float*>(in[j])[r];
    rt::df::run_df(m, ds, steps, s);
    for (int j = 0; j < 8; ++j) static_cast<float*>(out[j])[r] = s[j];
  }
}
extern "C" void host_df_step(int field, RT_DF_PARAMS) {
  if (field == 0)
    go(in, out, n, steps, ds, rt::df::DfAnalytic<rt::df::DF_FISHEYE>{});
  if (field == 1)
    go(in, out, n, steps, ds, rt::df::DfAnalytic<rt::df::DF_VERT>{});
}
extern "C" void host_df_step_grid(RT_DF_PARAMS, const float* nodes,
                                  const float* cells, RT_DF_GEOMETRY) {
  go(in, out, n, steps, ds, rt::df::DfGrid{nodes, cells, x0h, x0l, y0h, y0l,
                                           ihxh, ihxl, ihyh, ihyl, nx, ny});
}
extern "C" void host_df_step_c1(RT_DF_PARAMS, const float* cells,
                                RT_DF_GEOMETRY) {
  go(in, out, n, steps, ds, rt::df::DfC1{cells, x0h, x0l, y0h, y0l, ihxh,
                                         ihxl, ihyh, ihyl, nx, ny});
}
extern "C" void host_df_step_profile(RT_DF_PARAMS, const float* cells,
                                     float y0h, float y0l, float ihyh,
                                     float ihyl, int ny) {
  go(in, out, n, steps, ds, rt::df::DfProfile{cells, y0h, y0l, ihyh, ihyl,
                                              ny});
}
extern "C" void host_two_prod(const float* a, const float* b, float* p,
                              float* e, int n) {
  for (int i = 0; i < n; ++i) {
    const rt::df::DF t = rt::df::two_prod(a[i], b[i]);
    p[i] = t.h;
    e[i] = t.l;
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/df.cuh built for the host by g++ (-O2 -ffp-contract=off, the
    CUDA qualifiers stubbed); its entry points take df.cu's arguments less
    the stream."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile csrc/df.cuh")
    tmp = tmp_path_factory.mktemp("df_host")
    src, lib = tmp / "df_host.cpp", tmp / "df_host.so"
    src.write_text(_STUBS + _HOST_LOOP)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{build.CSRC}", "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    for name in ("df_step", "df_step_grid", "df_step_c1", "df_step_profile"):
        fn = getattr(so, f"host_{name}")
        fn.argtypes = list(build._SIGNATURES[f"rt_{name}"][:-1])
        fn.restype = None
    so.host_two_prod.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    so.host_two_prod.restype = None
    return so


def _bits(t):
    return t.contiguous().view(torch.int32)


def header_two_prod(so, a, b):
    """(p, e) of df.cuh's two_prod on float32 arrays."""
    a = torch.as_tensor(np.asarray(a, np.float32)).contiguous()
    b = torch.as_tensor(np.asarray(b, np.float32)).contiguous()
    p, e = torch.empty_like(a), torch.empty_like(a)
    so.host_two_prod(a.data_ptr(), b.data_ptr(), p.data_ptr(), e.data_ptr(),
                     a.numel())
    return p, e


def dekker(a, b):
    """The plain version's two_prod (Dekker's split chain)."""
    return tdf.two_prod(torch.as_tensor(np.asarray(a, np.float32)),
                        torch.as_tensor(np.asarray(b, np.float32)))


def exact_error(a, b):
    """a * b - fl(a * b) rounded once to float32 (float64 holds the 48-bit
    product and the difference exactly): what one FMA computes."""
    a64 = np.asarray(a, np.float32).astype(np.float64)
    b64 = np.asarray(b, np.float32).astype(np.float64)
    p = (np.asarray(a, np.float32) * np.asarray(b, np.float32)).astype(
        np.float64)
    return (a64 * b64 - p).astype(np.float32)


def _equal_bits(x, y):
    return torch.equal(_bits(x), _bits(y))


# -- the exact product --------------------------------------------------------
def test_two_prod_equals_dekker_on_the_primitive_pairs(host):
    """On the pairs the primitives' JAX parity test uses (16 decades, splits
    that carry, values next to powers of two, equal and opposite pairs):
    p and e to the bit, signed zeros included."""
    a, b = H.dekker_pairs()
    for x, y in zip(header_two_prod(host, a, b), dekker(a, b)):
        assert _equal_bits(x, y)


_MAG = st.floats(min_value=2.0 ** -50, max_value=2.0 ** 50, width=32)
_VAL = st.one_of(st.sampled_from([0.0, -0.0]),
                 st.tuples(_MAG, st.booleans()).map(
                     lambda t: -t[0] if t[1] else t[0]))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_VAL, _VAL), min_size=1, max_size=64))
def test_two_prod_equals_dekker_on_the_domain(host, pairs):
    """|a|, |b| in [2^-50, 2^50], both signs, and zeros: the product's error
    is a float32 number (a multiple of 2^-146, below 2^-23 |a b|), so the
    FMA and Dekker's chain both give it, to the bit."""
    a, b = np.array(pairs, np.float32).T
    for x, y in zip(header_two_prod(host, a, b), dekker(a, b)):
        assert _equal_bits(x, y)


def test_two_prod_domain_edges(host):
    """Where the two part, mapped.  Inside: an exponent sum of -100 (the
    domain's floor) and above, every error exact and both equal.  Below
    |a b| ~ 2^-103 the error needs bits under the smallest subnormal
    (2^-149): the FMA rounds it once, correctly; Dekker's partial products
    round on their own, and from ~2^-115 their sum differs on some pairs.
    Above |a| ~ 8.3e34, 4097 a overflows and Dekker's split gives NaN,
    where the FMA still gives the exact error.  Zeros of either sign give
    the same signed zeros.  The df path's magnitudes (positions O(1), low
    words ~1e-8, rates O(1-100)) lie far inside."""
    rng = np.random.default_rng(3)
    n = 4096

    def pairs(ea, eb):
        return ((rng.uniform(1, 2, n) * 2.0 ** ea).astype(np.float32),
                (rng.uniform(1, 2, n) * 2.0 ** eb).astype(np.float32))

    for ea, eb in ((-50, -50), (50, 50), (-50, 50), (-100, 0), (-70, -30)):
        a, b = pairs(ea, eb)
        pf, ef = header_two_prod(host, a, b)
        pd, ed = dekker(a, b)
        assert _equal_bits(pf, pd) and _equal_bits(ef, ed), (ea, eb)
        np.testing.assert_array_equal(ef.numpy(), exact_error(a, b))
    # the subnormal edge: the FMA is the correctly rounded error, Dekker not
    a, b = pairs(-60, -65)
    _, ef = header_two_prod(host, a, b)
    _, ed = dekker(a, b)
    np.testing.assert_array_equal(ef.numpy(), exact_error(a, b))
    assert not _equal_bits(ef, ed)
    # the overflow edge
    a = np.array([1e35, -3e35, 9e34], np.float32)
    b = np.array([1.5, 1.25, -1.0000001], np.float32)
    pf, ef = header_two_prod(host, a, b)
    pd, ed = dekker(a, b)
    assert _equal_bits(pf, pd)
    assert torch.isnan(ed).all() and torch.isfinite(ef).all()
    np.testing.assert_array_equal(ef.numpy(), exact_error(a, b))
    # zeros
    z = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -60, -(2.0 ** -60)],
                 np.float32)
    a, b = (v.ravel() for v in np.meshgrid(z, z))
    for x, y in zip(header_two_prod(host, a, b), dekker(a, b)):
        assert _equal_bits(x, y)


# -- the step loop on the five media ------------------------------------------
@pytest.fixture(scope="module")
def media():
    box = rtt.scenario("fisheye").box
    samples, depth = H.munk_profile()
    return {"grid": tdg.build_df_grid_medium("fisheye", box, DELTA,
                                             device="cpu"),
            "c1": tdg.build_df_c1_medium("fisheye", box, DELTA, device="cpu"),
            "profile": tdg.df_c1_profile_from_samples(samples, depth,
                                                      device="cpu")}


def _launch(kind):
    """(launch state, delta_s) of RAYS rays on a medium: the fisheye's ray
    with +-0.3 rad of jitter (the grids' too), vert from (-2, -2) at
    U[0.5, 1.3], the Munk channel's axis fan."""
    if kind == "vert_heterogeneous":
        rng = np.random.default_rng(0)
        pos0, theta0 = (np.tile([[-2.0, -2.0]], (RAYS, 1)),
                        rng.uniform(0.5, 1.3, RAYS))
        return tdf.initial_df_state(pos0, theta0, device="cpu"), 0.0193
    if kind == "profile":
        return tdg.split_state(*H.channel_fan(RAYS), device="cpu"), 0.01
    pos0, theta0 = H.fisheye_df_fan(RAYS, jitter=0.3)
    ds = 2 * np.pi / 300
    if kind == "fisheye":
        return tdf.initial_df_state(pos0, theta0, device="cpu"), ds
    return tdg.split_state(pos0, theta0, device="cpu"), ds


@pytest.fixture(scope="module")
def plain(media):
    """``plain(kind, jax_roundings=False)``: df_step_plain of _launch's rays
    for STEPS steps, in the kernel's form or in JAX's roundings, computed
    once."""
    runs = {}

    def run(kind, jax_roundings=False):
        if (kind, jax_roundings) not in runs:
            st0, ds = _launch(kind)
            runs[kind, jax_roundings] = tdf.df_step_plain(
                st0, media.get(kind, kind), ds, STEPS,
                jax_roundings=jax_roundings)
        return runs[kind, jax_roundings]
    return run


def host_run(host, medium, st0, ds, steps):
    """The header's run_df on the host: ``steps`` steps of ``st0``."""
    out = tdf.DfState(*(torch.empty_like(t) for t in st0))
    common = (build.pointer_array(st0), build.pointer_array(out),
              st0.xh.shape[0], steps, float(np.float32(ds)))
    if isinstance(medium, str):
        host.host_df_step(tdf.DF_FIELDS.index(medium), *common)
    else:
        getattr(host, f"host_{medium.KERNEL.name}")(*common,
                                                    *medium.kernel_args())
    return out


@pytest.mark.parametrize(
    "kind", ["fisheye", "vert_heterogeneous", "grid", "c1", "profile"])
def test_header_step_loop_on_the_host_equals_plain(kind, host, media, plain):
    """run_df on the host against df_step_plain in the kernel's form (the
    FMA form on FMA_KINDS, JAX's roundings on the grids), RAYS rays x STEPS
    steps, all 8 planes to the bit (signed zeros included): the FMA
    products of the header and the plain version's Dekker chains, and the
    header's fmaf and the plain version's fma32, agree along the whole
    path."""
    medium = media.get(kind, kind)
    assert tdf.fma_form(medium) == (kind in FMA_KINDS)
    st0, ds = _launch(kind)
    out = host_run(host, medium, st0, ds, STEPS)
    for name, a, b in zip(tdf.DfState._fields, plain(kind), out):
        assert _equal_bits(a, b), name
    moved = tdf.df_positions(out) - tdf.df_positions(st0)
    assert bool(torch.isfinite(moved).all()) and float(moved.abs().max()) > 0.1


@pytest.mark.parametrize("kind", FMA_KINDS)
def test_fma_form_chain_equals_one_shot(kind, host, media, plain):
    """The FMA form resumes: the header's run_df in three segments (60, 1,
    139 steps) equals the plain version's STEPS steps in one, all 8 planes
    to the bit."""
    medium = media.get(kind, kind)
    st, ds = _launch(kind)
    for n in (60, 1, STEPS - 61):
        st = host_run(host, medium, st, ds, n)
    for name, a, b in zip(tdf.DfState._fields, plain(kind), st):
        assert _equal_bits(a, b), name


@pytest.mark.parametrize("kind", FMA_KINDS)
def test_fma_form_and_jax_roundings_part_by_a_measured_amount(kind, plain):
    """The FMA form and JAX's roundings (``jax_roundings``) differ, and by
    no more than FORM_GAP in the positions after STEPS steps."""
    a, b = plain(kind), plain(kind, jax_roundings=True)
    assert not all(_equal_bits(x, y) for x, y in zip(a, b))
    gap = float((tdf.df_positions(a) - tdf.df_positions(b)).abs().max())
    assert gap <= FORM_GAP[kind], gap


def test_fma_form_follows_the_medium(media):
    """The analytic fields and the profile run the FMA form; the grids
    round as JAX, so asking for JAX's roundings changes nothing there."""
    assert [tdf.fma_form(media.get(k, k)) for k in (*FMA_KINDS, "grid", "c1")
            ] == [True, True, True, False, False]
    st0, ds = _launch("grid")
    for kind in ("grid", "c1"):
        a = tdf.df_step_plain(st0, media[kind], ds, 3)
        b = tdf.df_step_plain(st0, media[kind], ds, 3, jax_roundings=True)
        assert all(_equal_bits(x, y) for x, y in zip(a, b))
