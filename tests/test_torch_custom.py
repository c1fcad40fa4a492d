"""User-defined media in the port's fused and golden kernels
(kernels/custom.py): the traced field's plain evaluator against the
medium's own autodiff gradient for every class of the rule table; the
port's fast_trace on a CustomMedium (plain versions on the CPU) against
the JAX package's (Pallas kernels in interpret mode) on JAX's own two test
fields and on a grad_fn medium; the refusals; and the emitted C++ compiled
for the host with g++ against the plain evaluator."""
import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine.fast import fast_trace as jfast  # noqa: E402
from raytracing_tpu.media.medium import CustomMedium as JCustom  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.kernels import custom  # noqa: E402

T = torch
SQ2, THCK = math.sqrt(2.0), 0.005

#: one field a class of the rule table; the constants are dyadic, so the
#: traced field (float32 constants) equals the function itself at float64
FIELDS = {
    "arith": lambda x, y: (x * y - 0.5 * x + y / 4.0 + 2.0 / (x + 3.0)
                           - (y - 1.5) * (x + y) / (2.0 + y * y)),
    "rsub_neg_recip": lambda x, y: 1.0 - x + (-y) + T.reciprocal(x + 4.0),
    "pow": lambda x, y: ((x + 3.0) ** 2 + (y + 3.0) ** 3 + (x + 3.0) ** 0.5
                         + (y + 3.0) ** -0.5 + (x + 3.0) ** -1
                         + (y + 3.0) ** -2 + x ** 1 + y ** 0),
    "sqrt_rsqrt": lambda x, y: T.sqrt(x * x + 1.0) + T.rsqrt(y * y + 2.0),
    "exp_log": lambda x, y: (T.exp(0.5 * x) + T.expm1(y * 0.25)
                             + T.log(x + 4.0) + T.log1p(y * y)),
    "trig": lambda x, y: T.sin(x) * T.cos(y) + T.tan(0.5 * x + 0.25 * y),
    "tanh_sigmoid_atan": lambda x, y: (T.tanh(x - y) + T.sigmoid(2.0 * y)
                                       + T.atan(x * y) + T.atan2(y, x + 4.0)),
    "selects": lambda x, y: (T.where(x > y, x * 2.0, y) + T.clamp(x, -0.5, 0.5)
                             + T.minimum(x, y * 0.5) + T.maximum(x, y * 0.25)
                             + T.where(y <= 0.25, x, y) + abs(x - 0.25)
                             + T.clamp(y, min=-0.25) + T.clamp(x, max=0.75)),
    "constants": lambda x, y: (T.ones_like(x) * 2.0 + T.full_like(y, 0.5) * y
                               + T.tensor(0.25) * x + T.zeros_like(y)
                               + T.scalar_tensor(1.5)),
}


def _points(dtype, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.0, 1.0, (2, n))
    return (torch.as_tensor(xy[0], dtype=dtype),
            torch.as_tensor(xy[1], dtype=dtype))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dual_plain_matches_autodiff(name):
    """The traced field's plain evaluator (forward mode in the rule table)
    against CustomMedium.n_and_grad (torch.func.jvp): 1e-12 relative at
    float64; at float32 a few ulp (rtol 1e-6, about 8 ulp; atol 5e-7
    where the terms of a sum cancel): division by a constant rounds
    through its float32 reciprocal, as PyTorch's tensor / scalar does, and
    the rule table's sigmoid and tangent formulas are not PyTorch's CPU
    kernels' (measured: 3 ulp at most where no terms cancel, 2.4e-7
    absolute where they do)."""
    med = rtt.CustomMedium(FIELDS[name])
    field = custom.trace_custom(med)
    nag = custom.custom_nag_plain(field)
    for dtype, rtol, atol in ((torch.float64, 1e-12, 1e-14),
                              (torch.float32, 1e-6, 5e-7)):
        x, y = _points(dtype)
        n, gx, gy = nag(x, y)
        rn, (rgx, rgy) = med.n_and_grad(x, y)
        for got, want in ((n, rn), (gx, rgx), (gy, rgy)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                       atol=atol)


def test_grad_fn_medium_takes_the_hand_gradient():
    """With a grad_fn the field's gradient is that function's graph, on
    plain values: the logistic's closed-form derivative, not autodiff (its
    constants dyadic, so float64 holds to 1e-12)."""
    def grad(x, y):
        s = torch.sigmoid(y * 128.0)
        return torch.zeros_like(x), -64.0 * s * (1.0 - s)

    med = rtt.CustomMedium(lambda x, y: 1.5 - 0.5 * torch.sigmoid(y * 128.0),
                           grad_fn=grad)
    field = custom.trace_custom(med)
    assert not field.dual and "exp" in field.ops()
    x, y = _points(torch.float64)
    y = y * 0.05                        # inside the logistic's band
    n, gx, gy = custom.custom_nag_plain(field)(x, y)
    rn, (rgx, rgy) = med.n_and_grad(x, y)
    for got, want in ((n, rn), (gy, rgy)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-14)
    assert not gx.any()
    assert custom.trace_custom(med) is field     # cached per medium


def test_fused_custom_matches_jax():
    """JAX's test_fast_trace_custom_medium_kernel (tests/test_fast.py:143):
    op6 on 1.2 + 0.1 sin x cos y, engine "fused-custom", at JAX's bar."""
    r = 128
    pos0 = np.tile(np.array([[0.2, -0.1]], np.float32), (r, 1))
    theta0 = np.linspace(0.0, np.pi, r).astype(np.float32)
    kw = dict(delta_s=0.01, steps=200, pos0=pos0, theta0=theta0)
    j = jfast("op6", rt.scenario("fisheye"), JCustom(
        n_fn=lambda x, y: 1.2 + 0.1 * jnp.sin(x) * jnp.cos(y)),
        block_rays=128, interpret=True, **kw)
    t = rtt.fast_trace("op6", rtt.scenario("fisheye"), rtt.CustomMedium(
        lambda x, y: 1.2 + 0.1 * torch.sin(x) * torch.cos(y)), device="cpu",
        **kw)
    assert j.engine == t.engine == "fused-custom"
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=2e-5)
    np.testing.assert_array_equal(H.to_np(t.active), np.asarray(j.active))


def test_golden_custom_matches_jax():
    """JAX's test_fast_trace_custom_medium_golden (tests/test_fast.py:224):
    op5 on 1/(18 + 2y) in the vert scenario, engine "golden-custom", held
    to the port's golden kernel bar (chip_smoke.py POS_TOL_GOLDEN)."""
    js, ts = rt.scenario("vert"), rtt.scenario("vert")
    r = 128
    pos0 = np.tile(js.pos0[:1].astype(np.float32), (r, 1))
    theta0 = np.linspace(0.2, 1.2, r).astype(np.float32)
    kw = dict(delta_s=0.02, steps=150, pos0=pos0, theta0=theta0)
    j = jfast("op5", js, JCustom(n_fn=lambda x, y: 1.0 / (18.0 + 2.0 * y)),
              block_rays=128, interpret=True, **kw)
    t = rtt.fast_trace("op5", ts, rtt.CustomMedium(
        lambda x, y: 1.0 / (18.0 + 2.0 * y)), device="cpu", **kw)
    assert j.engine == t.engine == "golden-custom"
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=5e-4)
    # the traced field rounds as the analytic vert field: the analytic
    # golden kernel's plain version gives the same bits
    a = rtt.fast_trace("op5", ts, rtt.analytic_medium("vert_heterogeneous"),
                       device="cpu", **kw)
    assert torch.equal(t.pos, a.pos) and torch.equal(t.traveltime,
                                                     a.traveltime)


def test_grad_fn_custom_matches_jax():
    """A grad_fn medium (the interface logistic with its closed-form
    derivative) through op6, port against JAX, at the fused interface bar
    of chip_smoke.py (2e-4)."""
    def jgrad(x, y):
        s = 1.0 / (1.0 + jnp.exp(-y / THCK))
        return jnp.zeros_like(x), -(SQ2 - 1.0) * s * (1.0 - s) / THCK

    def tgrad(x, y):
        s = torch.sigmoid(y / THCK)
        return torch.zeros_like(x), -(SQ2 - 1.0) * s * (1.0 - s) / THCK

    rng = np.random.default_rng(4)
    pos0, theta0 = H.fan_near_interface(rng, 128)
    pos0, theta0 = pos0.astype(np.float32), theta0.astype(np.float32)
    scen = "interface"
    kw = dict(delta_s=0.01, steps=150, pos0=pos0, theta0=theta0)
    import dataclasses
    js = dataclasses.replace(rt.scenario(scen), box=H.INTERFACE_BOX)
    ts = dataclasses.replace(rtt.scenario(scen), box=H.INTERFACE_BOX)
    j = jfast("op6", js, JCustom(
        n_fn=lambda x, y: SQ2 - (SQ2 - 1.0) / (1.0 + jnp.exp(-y / THCK)),
        grad_fn=jgrad), block_rays=128, interpret=True, **kw)
    t = rtt.fast_trace("op6", ts, rtt.CustomMedium(
        lambda x, y: SQ2 - (SQ2 - 1.0) * torch.sigmoid(y / THCK),
        grad_fn=tgrad), device="cpu", **kw)
    assert j.engine == t.engine == "fused-custom"
    np.testing.assert_allclose(H.to_np(t.pos), np.asarray(j.pos), atol=2e-4)


def test_custom_refusals():
    """An operation outside the table, a captured non-scalar tensor, an
    exponent outside ATen's special cases, value-dependent control flow and
    stats=True raise ValueError, naming the cause, before any launch."""
    scen = rtt.scenario("fisheye")
    kw = dict(delta_s=0.05, pos0=np.zeros((4, 2), np.float32),
              theta0=np.zeros(4, np.float32), steps=3, device="cpu")
    table = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    bad = {"aten.erf": lambda x, y: 1.0 + torch.erf(x),
           "shape \\(5,\\)": lambda x, y: 1.0 + table * x,
           "exponent 1.5": lambda x, y: (x + 3.0) ** 1.5,
           "control flow": lambda x, y: x + 1.0 if (x > 0).all() else y}
    for match, fn in bad.items():
        with pytest.raises(ValueError, match=match) as err:
            rtt.fast_trace("op6", scen, rtt.CustomMedium(fn), **kw)
        assert "rtt.trace" in str(err.value)
    with pytest.raises(ValueError, match="stats"):
        rtt.fast_trace("op11", scen, rtt.CustomMedium(
            lambda x, y: 1.0 / (18.0 + 2.0 * y)), stats=True, **kw)
    # the scan tier takes what the kernels refuse
    res = rtt.trace("op6", scen, rtt.CustomMedium(bad["aten.erf"]),
                    delta_s=0.05, mode="metrics", max_size=4,
                    pos0=kw["pos0"], theta0=kw["theta0"], device="cpu")
    assert torch.isfinite(res.final.pos).all()


def test_fast_trace_custom_routes_every_op():
    """fused ops to "fused-custom", golden and Newton ops to
    "golden-custom", and supports() says so."""
    from raytracing_tpu_torch.engine.fast import supports
    from raytracing_tpu_torch.kernels.fused import FUSED_OPS
    from raytracing_tpu_torch.kernels.golden import GOLDEN_OPS
    scen = rtt.scenario("aniso")
    med = rtt.CustomMedium(lambda x, y: 1.0 / (18.0 + 2.0 * y))
    kw = dict(delta_s=0.05, pos0=scen.pos0[:4], theta0=scen.theta0[:4],
              steps=2, device="cpu")
    for op in FUSED_OPS + tuple(GOLDEN_OPS):
        assert supports(op, med)
        engine = "golden-custom" if op in GOLDEN_OPS else "fused-custom"
        assert rtt.fast_trace(op, scen, med, **kw).engine == engine


_STUBS = """#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
#include "common.cuh"
"""
_EVAL = """
extern "C" void eval(const float* x, const float* y, float* n, float* gx,
                     float* gy, int count) {
  for (int i = 0; i < count; ++i) custom_nag(x[i], y[i], n[i], gx[i], gy[i]);
}
extern "C" void eval_fast(const float* x, const float* y, float* n,
                          float* gx, float* gy, unsigned char* ok,
                          int count) {
  for (int i = 0; i < count; ++i) {
    bool k = true;
    custom_nag_fast(x[i], y[i], n[i], gx[i], gy[i], k);
    ok[i] = k;
  }
}
"""


def _host_eval(field, tmp_path):
    src = tmp_path / "custom_host.cpp"
    lib = tmp_path / "custom_host.so"
    src.write_text(_STUBS + custom.emit_source(field) + _EVAL)
    from raytracing_tpu_torch.kernels import build
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{build.CSRC}", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.eval.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    so.eval_fast.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]

    def run(x, y, fast=False):
        outs = [torch.empty_like(x) for _ in range(3)]
        if not fast:
            so.eval(x.data_ptr(), y.data_ptr(),
                    *(o.data_ptr() for o in outs), x.numel())
            return outs
        ok = torch.zeros(x.shape, dtype=torch.uint8)
        so.eval_fast(x.data_ptr(), y.data_ptr(),
                     *(o.data_ptr() for o in outs), ok.data_ptr(), x.numel())
        return outs, ok.bool()
    return run


#: a field whose value and tangents divide several numerators by one
#: value, and by another through 1 / (...)
SHARED = (lambda x, y: (x + y) / (2.0 + x * x) - (x - 2.0 * y) / (2.0 + x * x)
          + 1.0 / (3.0 + y * y))


def test_emitted_divisions_share_a_reciprocal():
    """A division whose numerator is 1 is emitted as rt::rcp_rn; the
    divisions of other numerators by one value share one rt::Recip, each
    quotient rt::div_by (csrc/common.cuh, the IEEE quotient's bits); a
    value divided once stays an IEEE division."""
    src = custom.trace_custom(rtt.CustomMedium(SHARED)).source
    body, fast = src.split("void custom_nag(", 1)[1].split(
        "void custom_nag_fast(")
    assert body.count("rt::recip(") == 1
    assert body.count("rt::div_by(") >= 4     # value and tangents
    assert "rt::rcp_rn(" in body and " / " not in body
    # the fast function: the same, each reciprocal by rt::rcp_fast
    lines = [ln for ln in body.splitlines() if ln.startswith("  const")]
    assert [ln.replace("rt::rcp_fast(", "rt::rcp_rn(").replace(", ok)", ")")
            for ln in fast.splitlines() if ln.startswith("  const")] == lines
    once = custom.trace_custom(rtt.CustomMedium(
        lambda x, y: x / (2.0 + y * y),
        grad_fn=lambda x, y: (torch.zeros_like(x), torch.zeros_like(y))
    )).source
    assert "rt::recip(" not in once and "rt::div_by(" not in once
    assert " = x / t" in once


@pytest.mark.parametrize("name", ["rational", "shared", "sqrt_rsqrt",
                                  "exp_log"])
def test_emitted_fast_function_equals_the_exact_one(name, tmp_path):
    """custom_nag_fast, the fused step's fast path through the generated
    field (each reciprocal by rt::rcp_fast), against custom_nag on the
    host, bit for bit with its guard holding on 4096 points (on the host
    both divide as IEEE; the card's fast reciprocal is checked against
    __frcp_rn on all 2^32 denominators, tests/test_torch_cuda.py)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile the emitted source")
    fn = {"rational": lambda x, y: 1.0 / (1.0 + x * x + y * y),
          "shared": SHARED}.get(name) or FIELDS[name]
    field = custom.trace_custom(rtt.CustomMedium(fn))
    assert "custom_nag_fast(" in field.source
    x, y = _points(torch.float32)
    run = _host_eval(field, tmp_path)
    (fn_, fgx, fgy), ok = run(x, y, fast=True)
    for got, want in zip((fn_, fgx, fgy), run(x, y)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(ok.all())


def _ulps(a, b):
    """Distance in float32 ulps, element by element."""
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("name,ulps", [
    ("rational", 0), ("shared", 0), ("arith", 0), ("selects", 0), ("sin", 2),
    ("exp", 2), ("log", 2), ("atan2", 2), ("sigmoid_grad_fn", 3)])
def test_emitted_source_matches_plain_on_the_host(name, ulps, tmp_path):
    """The emitted custom_nag compiled by g++ (-ffp-contract=off, CUDA
    qualifiers stubbed) against the plain evaluator on 4096 points:
    bit-equal where only + - * / and selects enter; within 2 ulp where one
    transcendental enters an output, which glibc (the host build) and
    PyTorch's CPU kernels round apart by an ulp or two (on the card both
    sides call the same libdevice function); 3 for the logistic, whose exp
    is followed by a division and two products before it is an output."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to compile the emitted source")
    media = {
        "rational": lambda x, y: 1.0 / (1.0 + x * x + y * y) + x / 3.0
        - 0.1 * y,
        "shared": SHARED,
        "sin": lambda x, y: 1.0 + 0.25 * torch.sin(x + y),
        "exp": lambda x, y: 1.0 + 0.25 * torch.exp(x - y),
        "log": lambda x, y: 1.0 + 0.25 * torch.log(x * x + y + 3.0),
        "atan2": lambda x, y: 1.0 + 0.25 * torch.atan2(y, x + 4.0),
    }
    if name == "sigmoid_grad_fn":
        med = rtt.CustomMedium(
            lambda x, y: SQ2 - (SQ2 - 1.0) * torch.sigmoid(y / 0.05),
            grad_fn=lambda x, y: (torch.zeros_like(x), -(SQ2 - 1.0) * 20.0
                                  * torch.sigmoid(y / 0.05)))
    else:
        med = rtt.CustomMedium(media.get(name) or FIELDS[name])
    field = custom.trace_custom(med)
    x, y = _points(torch.float32)
    host = _host_eval(field, tmp_path)(x, y)
    plain = custom.custom_nag_plain(field)(x, y)
    for h, p in zip(host, plain):
        assert int(_ulps(h, p).max()) <= ulps


_FAKE_NVCC = """import sys
from pathlib import Path
args = sys.argv[1:]
out, unit = Path(args[args.index("-o") + 1]), Path(args[-1])
print(f"fake nvcc on {unit.name}")
if "FAIL" in unit.read_text():
    print("error: the unit asked to fail")
    sys.exit(2)
out.write_bytes(unit.read_bytes())
"""


@pytest.mark.parametrize("fails", [False, True])
def test_build_libraries_writes_its_own_files(fails, tmp_path, monkeypatch):
    """Each build writes its unit, log and library under this process's own
    names and renames them into place after nvcc (so two processes building
    one library share no file); a failed nvcc raises with its output and
    leaves its log where build_log reads it."""
    import os
    import sys
    from raytracing_tpu_torch.kernels import build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + _FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(custom, "CUSTOM_DIR", tmp_path / "custom")
    field = custom.trace_custom(rtt.CustomMedium(
        lambda x, y: 1.0 / (18.0 + 2.0 * y)))
    if fails:
        monkeypatch.setattr(custom, "emit_source", lambda f: "// FAIL\n")
        field = custom.CustomField(dag=field.dag, outputs=field.outputs,
                                   schedule=field.schedule, dual=field.dual)
    spec = (field, "fused", "op6")
    lib = custom._library_path(custom._unit(*spec)[0])
    if fails:
        with pytest.raises(RuntimeError, match="the unit asked to fail"):
            custom.build_libraries([spec])
    else:
        assert list(custom.build_libraries([spec])) == [spec]
        assert lib.read_bytes() == lib.with_suffix(".cu").read_bytes()
    log = custom.build_log(*spec)
    assert f"{lib.stem}.{os.getpid()}.cu" in log
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        lib.with_suffix(s).name for s in (".cu", ".log")
        + (() if fails else (".so",)))


def test_library_digest_covers_every_header(tmp_path, monkeypatch):
    """A custom library's name moves with any header in csrc/, the same
    set that names the main library (build._sources)."""
    from raytracing_tpu_torch.kernels import build
    field = custom.trace_custom(rtt.CustomMedium(
        lambda x, y: 1.0 / (18.0 + 2.0 * y)))
    source = custom._unit(field, "golden", "op11")[0]
    before = custom._library_path(source)
    extra = tmp_path / "extra.cuh"
    extra.write_text("// a header added later\n")
    cu, cuh = build._sources(build.CSRC)
    monkeypatch.setattr(build, "_sources", lambda csrc: (cu, cuh + [extra]))
    custom._headers_digest.cache_clear()
    try:
        assert custom._library_path(source) != before
    finally:
        custom._headers_digest.cache_clear()
