"""User-defined media in the fused and golden CUDA kernels.

Port of ``raytracing_tpu/kernels/fused.py::_custom_nag`` (fused.py:321-334),
which the JAX package injects into the fused kernel (fused.py:740, wrapper
``fused_trace_final_custom`` :809) and the golden kernel (golden.py:160,
the custom branch of ``golden_trace_final`` :620-651); ``engine/fast.py``
routes a ``CustomMedium`` to them (fast.py:330-343, engines
``"fused-custom"`` and ``"golden-custom"``).

JAX inlines the user's ``n_fn`` into the Pallas body and takes the gradient
by ``jax.jvp`` there (media/medium.py:70-76).  Here the same happens in
three steps:

1. :func:`trace_custom` traces ``n_fn`` (and ``grad_fn`` if given) once with
   ``torch.fx.experimental.proxy_tensor.make_fx`` on small float32 CPU
   tensors into a graph of elementwise aten operations, and turns it into a
   :class:`CustomField`: a DAG of primitive operations built from
   :data:`RULES`.  Each supported aten operation has one rule, written as
   data: its value and its forward-mode tangent in primitives.  Without a
   ``grad_fn`` every value carries two tangents (d/dx, d/dy), so the
   gradient is forward mode inside the kernel, as ``jax.jvp`` is in the
   Pallas body; a tangent that is zero by construction is dropped.  With a
   ``grad_fn`` its graph is taken as it is, on plain values.
2. :func:`emit_source` prints the DAG as a ``__host__ __device__`` C++
   function ``custom_nag(x, y, n, gx, gy)``, one float32 operation a line.
   :func:`library_for` writes a translation unit that includes
   ``csrc/fused.cuh`` or ``csrc/golden.cuh``, wraps the function in a
   ``Custom`` medium and instantiates only the loop asked for (one fused op,
   or one golden variant), compiles it with nvcc and the main library's
   flags (``-fmad=false``) into ``_build/custom/`` and loads it with ctypes,
   once a process.  The library's name is the SHA-256 of its source, the
   headers and the flags.
3. :func:`custom_nag_plain` runs the same DAG, in the same order, as torch
   operations: the kernels' plain version (``kernels/fused.py::nag_fn``).

Rounding.  Every constant is rounded to float32 when it is traced (PyTorch
rounds a Python scalar to a float32 tensor's type the same way), and the
kernel reads it as a hexadecimal float32 literal.  A division by a
constant is a product with the constant's float32 reciprocal, as PyTorch
computes ``tensor / scalar`` on the card; so is ``aten.div`` by a captured
0-d tensor.  A division by a value (``tensor / tensor``, ``scalar /
tensor``, and ``reciprocal``, which Python's ``c / t`` traces to before a
product with ``c``) is one IEEE division.  ``pow`` takes ATen's special
cases (exponents 0, 1, 2, 3, 0.5, -0.5, -1, -2 as products, ``sqrt``,
``rsqrt`` and divisions); any other exponent is refused.  ``sigmoid`` is
``1 / (1 + exp(-a))``, the formula of PyTorch's CUDA kernel.  So the plain
version does the same float32 operations on the CPU and on the card, and
the kernel does them on the card: ``+ - * /`` and ``sqrt`` round alike
everywhere, ``sinf``, ``expf`` and the other transcendentals are the same
libdevice calls in the kernel and in PyTorch's CUDA kernels, and
``rsqrt`` is ``rsqrtf`` on both sides.  (On the CPU the emitted function,
built by a host compiler with ``rsqrtf`` as ``1 / sqrtf``, and PyTorch's
CPU kernels call different libms, an ulp or two apart.)  Against JAX's
true divisions the result differs by at most an ulp an operation.

Constant subexpressions are folded when the field is traced: in float32
for ``+ - * /``, ``sqrt`` and the selects, and for a transcendental of a
constant in float64 rounded to float32; the kernel and the plain version
read the same folded value.

Anything outside :data:`RULES` raises ``ValueError`` before any launch,
naming the operation and pointing to the scan tier (``rtt.trace``), as
JAX's docstring does (fused.py:322-328): an unsupported aten operation, a
non-scalar captured tensor, a type other than float32, and Python control
flow that depends on the values (``make_fx`` cannot trace it).

What bounds the kernels is unchanged from fused.cu and golden.cu: FP32
issue, one thread a ray; the field is a few dozen operations a call in
registers.  Building a library costs one nvcc run (a user's first call of
a (medium, op) pair; ``PERF.md`` has the seconds).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import os
import struct
import subprocess
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from raytracing_tpu_torch.kernels import build

#: where the generated translation units and their libraries go
CUSTOM_DIR = build.BUILD_DIR / "custom"

KERNEL_FUSED = build.KernelInfo(
    name="fused_step_custom",
    source="raytracing_tpu_torch/kernels/custom.py",
    replaces="raytracing_tpu/kernels/fused.py:321")
KERNEL_GOLDEN = build.KernelInfo(
    name="golden_step_custom",
    source="raytracing_tpu_torch/kernels/custom.py",
    replaces="raytracing_tpu/kernels/golden.py:160")

_FUSED_OPS = ("op1", "op2", "op3", "op4", "op6", "op7", "op8", "op12")
#: golden op -> the (CURV, NEWTON, ISO) instantiation of csrc/golden.cuh
GOLDEN_VARIANTS = {"op5": (1, 0, 1), "op9": (0, 0, 1), "op10": (1, 0, 0),
                   "op11": (0, 0, 0), "op10n": (1, 1, 0), "op11n": (0, 1, 0)}


# -- primitives ---------------------------------------------------------------
# name -> (C++ spelling, torch function, float32 fold).  Every primitive is
# one float32 operation (or a select, or a comparison giving a bool).

def _fdiv(a, b):
    from raytracing_tpu_torch.kernels.fused import div_exact
    if torch.is_tensor(a) and torch.is_tensor(b):
        return torch.div(a, b)
    return div_exact(a, b)        # one IEEE division with a Python float


def _tensors(fn):
    """``fn`` on tensors: a Python number operand becomes a full float32
    tensor."""
    def run(*args):
        ref = next(a for a in args if torch.is_tensor(a))
        return fn(*(a if torch.is_tensor(a) else
                    torch.full(ref.shape, a, dtype=torch.float32,
                               device=ref.device) for a in args))
    return run


def _f32(fn):
    def fold(*args):
        with np.errstate(all="ignore"):
            return fn(*(np.float32(a) for a in args))
    return fold


def _f64(fn):
    def fold(*args):
        try:
            return fn(*(float(a) for a in args))
        except (ValueError, OverflowError):
            return math.nan
    return fold


PRIMS = {
    "add": ("{0} + {1}", lambda a, b: a + b, _f32(lambda a, b: a + b)),
    "sub": ("{0} - {1}", lambda a, b: a - b, _f32(lambda a, b: a - b)),
    "mul": ("{0} * {1}", lambda a, b: a * b, _f32(lambda a, b: a * b)),
    "div": ("{0} / {1}", _fdiv, _f32(lambda a, b: a / b)),
    "neg": ("-{0}", torch.neg, _f32(lambda a: -a)),
    "abs": ("fabsf({0})", torch.abs, _f32(abs)),
    "sqrt": ("sqrtf({0})", torch.sqrt, _f32(np.sqrt)),
    "rsqrt": ("RT_CUSTOM_RSQRTF({0})", torch.rsqrt,
              _f32(lambda a: np.float32(1.0) / np.sqrt(a))),
    "exp": ("expf({0})", torch.exp, _f64(math.exp)),
    "expm1": ("expm1f({0})", torch.expm1, _f64(math.expm1)),
    "log": ("logf({0})", torch.log, _f64(math.log)),
    "log1p": ("log1pf({0})", torch.log1p, _f64(math.log1p)),
    "sin": ("sinf({0})", torch.sin, _f64(math.sin)),
    "cos": ("cosf({0})", torch.cos, _f64(math.cos)),
    "tan": ("tanf({0})", torch.tan, _f64(math.tan)),
    "tanh": ("tanhf({0})", torch.tanh, _f64(math.tanh)),
    "atan": ("atanf({0})", torch.atan, _f64(math.atan)),
    "atan2": ("atan2f({0}, {1})", _tensors(torch.atan2), _f64(math.atan2)),
    "min": ("fminf({0}, {1})", _tensors(torch.minimum), _f32(min)),
    "max": ("fmaxf({0}, {1})", _tensors(torch.maximum), _f32(max)),
    "select": ("{0} ? {1} : {2}", _tensors(torch.where),
               lambda c, a, b: a if c else b),
    "gt": ("{0} > {1}", _tensors(torch.gt), _f32(lambda a, b: a > b)),
    "lt": ("{0} < {1}", _tensors(torch.lt), _f32(lambda a, b: a < b)),
    "ge": ("{0} >= {1}", _tensors(torch.ge), _f32(lambda a, b: a >= b)),
    "le": ("{0} <= {1}", _tensors(torch.le), _f32(lambda a, b: a <= b)),
}
_BOOL_PRIMS = ("gt", "lt", "ge", "le")


# -- the rule table -------------------------------------------------------------
# aten op -> (value, tangent), each a template in the primitives: a tuple
# (prim, arg, ...), an operand "a" / "b" (the node's tensor arguments in
# order), its tangent "ta" / "tb" along one direction, the value "v", or a
# number.  A tangent template is evaluated once for each direction; a zero
# tangent (a constant's) drops out of it.  Comparisons carry no tangent.

_UNARY = {
    "neg": (("neg", "a"), ("neg", "ta")),
    "abs": (("abs", "a"), ("select", ("lt", "a", 0.0), ("neg", "ta"), "ta")),
    "sqrt": (("sqrt", "a"), ("div", ("mul", "ta", 0.5), "v")),
    "rsqrt": (("rsqrt", "a"), ("div", ("mul", ("mul", "v", -0.5), "ta"),
                               "a")),
    "reciprocal": (("div", 1.0, "a"), ("neg", ("mul", ("mul", "v", "v"),
                                                "ta"))),
    "exp": (("exp", "a"), ("mul", "v", "ta")),
    "expm1": (("expm1", "a"), ("mul", ("add", "v", 1.0), "ta")),
    "log": (("log", "a"), ("div", "ta", "a")),
    "log1p": (("log1p", "a"), ("div", "ta", ("add", "a", 1.0))),
    "sin": (("sin", "a"), ("mul", ("cos", "a"), "ta")),
    "cos": (("cos", "a"), ("neg", ("mul", ("sin", "a"), "ta"))),
    "tan": (("tan", "a"), ("mul", ("add", ("mul", "v", "v"), 1.0), "ta")),
    "tanh": (("tanh", "a"), ("mul", ("sub", 1.0, ("mul", "v", "v")), "ta")),
    "sigmoid": (("div", 1.0, ("add", ("exp", ("neg", "a")), 1.0)),
                ("mul", ("mul", "v", ("sub", 1.0, "v")), "ta")),
    "atan": (("atan", "a"), ("div", "ta", ("add", ("mul", "a", "a"), 1.0))),
}
_BINARY = {
    "add": (("add", "a", "b"), ("add", "ta", "tb")),
    "sub": (("sub", "a", "b"), ("sub", "ta", "tb")),
    "rsub": (("sub", "b", "a"), ("sub", "tb", "ta")),
    "mul": (("mul", "a", "b"), ("add", ("mul", "ta", "b"), ("mul", "a",
                                                              "tb"))),
    "div": (("div", "a", "b"), ("div", ("sub", "ta", ("mul", "v", "tb")),
                                "b")),
    "atan2": (("atan2", "a", "b"),
              ("div", ("sub", ("mul", "b", "ta"), ("mul", "a", "tb")),
               ("add", ("mul", "a", "a"), ("mul", "b", "b")))),
    "minimum": (("min", "a", "b"), ("select", ("lt", "a", "b"), "ta", "tb")),
    "maximum": (("max", "a", "b"), ("select", ("gt", "a", "b"), "ta", "tb")),
    "gt": (("gt", "a", "b"), None),
    "lt": (("lt", "a", "b"), None),
    "ge": (("ge", "a", "b"), None),
    "le": (("le", "a", "b"), None),
}
#: pow(a, e): ATen's special exponents (the CPU and CUDA kernels alike)
_POW = {
    0.0: (1.0, None),
    1.0: ("a", "ta"),
    2.0: (("mul", "a", "a"), ("mul", ("mul", "a", 2.0), "ta")),
    3.0: (("mul", ("mul", "a", "a"), "a"),
          ("mul", ("mul", ("mul", "a", "a"), 3.0), "ta")),
    0.5: _UNARY["sqrt"],
    -0.5: _UNARY["rsqrt"],
    -1.0: _UNARY["reciprocal"],
    -2.0: (("div", 1.0, ("mul", "a", "a")),
           ("mul", ("div", ("mul", "v", -2.0), "a"), "ta")),
}
#: clamp(a, lo, hi): the bounds as selects, the tangent zero outside them
_CLAMP = (("min", ("max", "a", "b"), "c"),
          ("select", ("lt", "a", "b"), 0.0,
           ("select", ("gt", "a", "c"), 0.0, "ta")))
_CLAMP_MIN = (("max", "a", "b"), ("select", ("lt", "a", "b"), 0.0, "ta"))
_CLAMP_MAX = (("min", "a", "b"), ("select", ("gt", "a", "b"), 0.0, "ta"))
_WHERE = (("select", "a", "b", "c"), ("select", "a", "tb", "tc"))
#: value-free operations: a constant, or the operand itself
_CONSTANT_OPS = ("ones_like", "zeros_like", "full_like", "scalar_tensor",
                 "full")
_IDENTITY_OPS = ("lift_fresh_copy", "alias", "detach", "clone", "_to_copy",
                 "contiguous")

#: the aten operation names the table covers (overloads are matched below)
RULES = {**{k: v for k, v in _UNARY.items()},
         **{k: v for k, v in _BINARY.items()},
         "pow": _POW, "clamp": _CLAMP, "clamp_min": _CLAMP_MIN,
         "clamp_max": _CLAMP_MAX, "where": _WHERE,
         **{k: "constant" for k in _CONSTANT_OPS},
         **{k: "identity" for k in _IDENTITY_OPS}}


def _refuse(what: str):
    raise ValueError(
        f"CustomMedium: {what} has no CUDA form; the fused and golden "
        "kernels take elementwise float32 fields built from "
        f"{sorted(RULES)} (kernels/custom.py RULES). Trace this medium on "
        "the scan tier instead: rtt.trace(op, scen, medium, ...)")


# -- the DAG ----------------------------------------------------------------------

def f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def _bits(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", v))[0]


class _Dag:
    """Interned primitive operations.  A node is an int: ("x",), ("y",),
    ("c", value) or (prim, arg node, ...); a zero tangent is ``None``."""

    def __init__(self):
        self.nodes: list = []
        self._ids: dict = {}
        self.x = self._intern(("x",))
        self.y = self._intern(("y",))

    def _intern(self, key):
        if key not in self._ids:
            self._ids[key] = len(self.nodes)
            self.nodes.append(key)
        return self._ids[key]

    def const(self, v) -> int:
        v = f32(v)
        return self._intern(("c", v, _bits(v)))

    def value_of(self, node):
        """A constant node's value, else None."""
        key = self.nodes[node]
        return key[1] if key[0] == "c" else None

    def is_bool(self, node) -> bool:
        key = self.nodes[node]
        return key[0] in _BOOL_PRIMS or (key[0] == "c" and len(key) == 4)

    def bool_const(self, v: bool) -> int:
        return self._intern(("c", bool(v), int(v), "bool"))

    def op(self, prim, *args):
        """The node of ``prim`` on ``args`` (nodes, or None for a zero
        tangent), simplified: zero tangents drop out, a product with the
        constant 1 is the other operand (exactly), constant operands fold,
        and a division by a constant is a product with its float32
        reciprocal."""
        if prim in ("add", "sub", "mul", "div", "neg", "select") \
                and any(a is None for a in args):
            return self._zero_op(prim, *args)
        if prim == "select" and not self.is_bool(args[0]):
            _refuse("a select whose condition is not a comparison")
        if any(self.is_bool(a) for a in args[prim == "select":]):
            _refuse("a comparison (bool) used as a number")
        vals = [self.value_of(a) for a in args]
        if all(v is not None for v in vals):
            out = PRIMS[prim][2](*vals)
            return (self.bool_const(out) if prim in _BOOL_PRIMS
                    else self.const(out))
        if prim == "div" and vals[1] is not None:
            return self.op("mul", args[0],
                           self.const(np.float32(1.0) / np.float32(vals[1])))
        if prim == "mul":
            if vals[0] == 1.0:
                return args[1]
            if vals[1] == 1.0:
                return args[0]
        if prim == "select" and vals[0] is not None:
            return args[1] if vals[0] else args[2]
        return self._intern((prim, *args))

    def _zero_op(self, prim, *args):
        a = args[0]
        if prim == "add":
            b = args[1]
            return b if a is None else a
        if prim == "sub":
            b = args[1]
            if b is None:
                return a
            return None if a is None and b is None else self.op("neg", b)
        if prim in ("mul", "neg", "div"):   # no template divides by a tangent
            return None
        c, t, e = args                  # select
        if t is None and e is None:
            return None
        zero = self.const(0.0)
        return self.op("select", c, zero if t is None else t,
                       zero if e is None else e)

    def template(self, tpl, env):
        """Evaluate a rule template in ``env`` (operand names -> nodes)."""
        if isinstance(tpl, str):
            return env[tpl]
        if isinstance(tpl, (int, float)):
            return self.const(tpl)
        return self.op(tpl[0], *(self.template(a, env) for a in tpl[1:]))


# -- tracing --------------------------------------------------------------------

def _trace_graph(fn, n_out: int):
    """``fn`` traced by make_fx on float32 CPU tensors: (graph module,
    output nodes)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    x = torch.linspace(0.25, 0.75, 5, dtype=torch.float32)
    y = torch.linspace(-0.5, 0.5, 5, dtype=torch.float32)
    try:
        gm = make_fx(fn)(x, y)
    except Exception as err:    # data-dependent control flow and the like
        _refuse(f"a function make_fx cannot trace (Python control flow "
                f"that reads the values, or: {type(err).__name__}: "
                f"{str(err).splitlines()[0][:160]})")
    out = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if len(outs) != n_out:
        _refuse(f"a function returning {len(outs)} values where {n_out} "
                "were expected")
    return gm, outs


def _lower(dag: _Dag, gm, outs, dual: bool):
    """The graph's output nodes as DAG nodes: (value, tx, ty) each (the
    tangents None without ``dual``)."""
    env = {}
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            base = dag.x if not env else dag.y
            one = dag.const(1.0)
            env[node] = (base, one if base == dag.x else None,
                         one if base == dag.y else None) if dual \
                else (base, None, None)
            continue
        if node.op == "output":
            break
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            if t.numel() != 1 or t.dim() != 0 or not t.is_floating_point():
                _refuse(f"a captured tensor of shape {tuple(t.shape)} "
                        f"and type {t.dtype} (only 0-d float constants "
                        "are inlined)")
            env[node] = (dag.const(float(t)), None, None)
            continue
        if node.op != "call_function":
            _refuse(f"the graph node {node.op} {node.target}")
        env[node] = _apply(dag, node, env, dual)
    return [env[o] if isinstance(o, torch.fx.Node) else _refuse(
        f"an output {o!r} that is not a tensor") for o in outs]


def _apply(dag, node, env, dual):
    target = node.target
    name = getattr(target, "__name__", str(target))
    base, _, overload = name.partition(".")
    val = node.meta.get("val")
    if torch.is_tensor(val) and val.dtype not in (torch.float32, torch.bool):
        _refuse(f"aten.{name} giving {val.dtype} (the kernels are float32)")
    if base not in RULES:
        _refuse(f"the operation aten.{name}")
    rule = RULES[base]
    kwargs = dict(node.kwargs)

    def operand(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            _refuse(f"aten.{name} with the argument {a!r}")
        return (dag.const(a), None, None)

    if rule == "constant":
        fill = {"ones_like": 1.0, "zeros_like": 0.0}.get(base)
        if fill is None:
            fill = node.args[1] if base in ("full_like", "full") \
                else node.args[0]
        return (dag.const(fill), None, None)
    if rule == "identity":
        return env[node.args[0]]
    if base in ("add", "sub", "rsub") and kwargs.pop("alpha", 1) != 1:
        _refuse(f"aten.{name} with alpha != 1")
    if kwargs:
        _refuse(f"aten.{name} with the arguments {sorted(kwargs)}")
    args = list(node.args)
    if base == "pow":
        if overload != "Tensor_Scalar" or float(args[1]) not in _POW:
            _refuse(f"aten.{name} with the exponent {args[1]!r} (the table "
                    f"has {sorted(_POW)})")
        rule, args = _POW[float(args[1])], args[:1]
    if base == "clamp":
        lo, hi = (list(args[1:]) + [None, None])[:2]
        rule, args = ((_CLAMP, [args[0], lo, hi]) if lo is not None
                      and hi is not None else
                      (_CLAMP_MIN, [args[0], lo]) if lo is not None else
                      (_CLAMP_MAX, [args[0], hi]) if hi is not None else
                      (("a", "ta"), args[:1]))
    ops = [operand(a) for a in args]
    names = "abc"
    env_v = {names[k]: o[0] for k, o in enumerate(ops)}
    value_tpl, tangent_tpl = rule
    v = dag.template(value_tpl, env_v)
    if not dual or tangent_tpl is None:
        return (v, None, None)
    tangents = []
    for d in (1, 2):
        env_t = {**env_v, "v": v,
                 **{"t" + names[k]: o[d] for k, o in enumerate(ops)}}
        tangents.append(dag.template(tangent_tpl, env_t))
    return (v, *tangents)


@dataclasses.dataclass(frozen=True, eq=False)
class CustomField:
    """A ``CustomMedium`` traced for the kernels: its DAG, the output nodes
    (n, gx, gy), the schedule (nodes in evaluation order) and whether the
    gradient is forward mode (``dual``) or the medium's ``grad_fn``."""

    dag: Any
    outputs: tuple
    schedule: tuple
    dual: bool

    @functools.cached_property
    def source(self) -> str:
        return emit_source(self)

    def ops(self) -> dict:
        """Primitive operations a call performs, by name."""
        counts: dict = {}
        for k in self.schedule:
            p = self.dag.nodes[k][0]
            counts[p] = counts.get(p, 0) + 1
        return counts


def _schedule(dag, outputs):
    order, seen = [], set()

    def visit(k):
        if k in seen:
            return
        seen.add(k)
        key = dag.nodes[k]
        if key[0] in ("x", "y", "c"):
            return
        for a in key[1:]:
            visit(a)
        order.append(k)

    for k in outputs:
        visit(k)
    return tuple(order)


def _trace(medium) -> CustomField:
    dag = _Dag()
    gm, outs = _trace_graph(medium.n_fn, 1)
    dual = medium.grad_fn is None
    (n, gx, gy), = _lower(dag, gm, outs, dual)
    if not dual:
        ggm, gouts = _trace_graph(medium.grad_fn, 2)
        (gx, _, _), (gy, _, _) = _lower(dag, ggm, gouts, False)
    zero = dag.const(0.0)
    outputs = tuple(zero if k is None else k for k in (n, gx, gy))
    if any(dag.is_bool(k) for k in outputs):
        _refuse("a field or gradient that is a comparison (bool)")
    return CustomField(dag=dag, outputs=outputs,
                       schedule=_schedule(dag, outputs), dual=dual)


# CustomMedium -> CustomField, cached by the medium object (CustomMedium is
# eq=False: it hashes by identity).  LRU-bounded like engine/fast.py's
# _as_hermite cache; an entry holds the medium, so an id is never reused
# while its entry lives.
_CACHE: dict = {}
_CACHE_MAX = 16


def trace_custom(medium) -> CustomField:
    """The kernels' form of a ``CustomMedium`` (traced once per medium
    object); raises ValueError for a field outside :data:`RULES`."""
    key = id(medium)
    hit = _CACHE.pop(key, None)
    if hit is None or hit[0] is not medium:
        hit = (medium, _trace(medium))
    _CACHE[key] = hit
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.pop(next(iter(_CACHE)))
    return hit[1]


# -- the two backends -------------------------------------------------------------

def _literal(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "-INFINITY"
    if v == 0.0:
        return "-0.0f" if math.copysign(1.0, v) < 0 else "0.0f"
    mant, _, exp = float.hex(v).partition("p")
    return f"{mant.rstrip('0').rstrip('.')}p{exp}f"


def emit_source(field: CustomField) -> str:
    """The field as C++: ``custom_nag(x, y, n, gx, gy)``, one float32
    operation a line in :attr:`CustomField.schedule`'s order.

    A division whose numerator is the constant 1 is ``rt::rcp_rn`` (the
    correctly rounded reciprocal's fast path, csrc/common.cuh); where
    several other divisions share a denominator, its ``rt::Recip`` is
    formed once and each quotient is ``rt::div_by``.  Both round as the
    IEEE division, so the plain evaluator is unchanged; the function needs
    common.cuh (fused.cuh and golden.cuh include it).  A second function,
    ``custom_nag_fast(x, y, n, gx, gy, ok)``, is the same with each
    reciprocal by ``rt::rcp_fast``, its guard ANDed into ``ok`` (the fused
    step's fast path tests it once with its own guards)."""
    dag = field.dag
    names = {dag.x: "x", dag.y: "y"}

    def ref(k):
        key = dag.nodes[k]
        return _literal(key[1]) if key[0] == "c" else names[k]

    def is_one(k):
        return dag.nodes[k][0] == "c" and dag.value_of(k) == 1.0

    # denominators of two or more divisions other than reciprocals
    uses: dict = {}
    for k in field.schedule:
        prim, *args = dag.nodes[k]
        if prim == "div" and not is_one(args[0]):
            uses[args[1]] = uses.get(args[1], 0) + 1
    shared = {b for b, count in uses.items() if count > 1}
    recips: dict = {}

    lines, fast_lines = [], []
    for i, k in enumerate(field.schedule):
        prim, *args = dag.nodes[k]
        names[k] = f"t{i}"
        kind = "bool" if prim in _BOOL_PRIMS else "float"
        if prim == "div" and is_one(args[0]):
            lines.append(f"  const float t{i} = rt::rcp_rn({ref(args[1])});")
            fast_lines.append(f"  const float t{i} = "
                              f"rt::rcp_fast({ref(args[1])}, ok);")
            continue
        if prim == "div" and args[1] in shared:
            if args[1] not in recips:
                recips[args[1]] = f"r{len(recips)}"
                line = (f"  const rt::Recip {recips[args[1]]} = "
                        f"rt::recip({ref(args[1])});")
                lines.append(line)
                fast_lines.append(line)
            expr = f"rt::div_by({ref(args[0])}, {recips[args[1]]})"
        else:
            expr = PRIMS[prim][0].format(*map(ref, args))
        lines.append(f"  const {kind} t{i} = {expr};")
        fast_lines.append(lines[-1])
    n, gx, gy = map(ref, field.outputs)
    mode = ("gradient by forward mode (two tangents a value)" if field.dual
            else "gradient from the medium's grad_fn")
    return (
        "#ifndef RT_CUSTOM_RSQRTF\n"
        "#ifdef __CUDA_ARCH__\n"
        "#define RT_CUSTOM_RSQRTF(v) rsqrtf(v)\n"
        "#else\n"
        "#define RT_CUSTOM_RSQRTF(v) (1.0f / sqrtf(v))\n"
        "#endif\n"
        "#endif\n"
        f"// a CustomMedium traced by raytracing_tpu_torch/kernels/custom.py; "
        f"{mode}\n"
        "__host__ __device__ __forceinline__ void custom_nag(float x, "
        "float y, float& n, float& gx, float& gy) {\n"
        + "\n".join(lines) + ("\n" if lines else "")
        + f"  n = {n};\n  gx = {gx};\n  gy = {gy};\n}}\n"
        "__host__ __device__ __forceinline__ void custom_nag_fast(float x, "
        "float y, float& n, float& gx, float& gy, bool& ok) {\n"
        + ("  (void)ok;\n" if fast_lines == lines else "")
        + "\n".join(fast_lines) + ("\n" if fast_lines else "")
        + f"  n = {n};\n  gx = {gx};\n  gy = {gy};\n}}\n")


def custom_nag_plain(field: CustomField):
    """The plain evaluator (x, y) -> (n, gx, gy): the schedule's operations
    as torch calls, in the kernel's order (the kernels' plain version)."""
    dag = field.dag

    def nag(x, y):
        vals = {dag.x: x, dag.y: y}

        def get(k):
            key = dag.nodes[k]
            return key[1] if key[0] == "c" else vals[k]

        for k in field.schedule:
            prim, *args = dag.nodes[k]
            vals[k] = PRIMS[prim][1](*map(get, args))
        out = []
        for k in field.outputs:
            v = get(k)
            out.append(v if torch.is_tensor(v) else torch.full_like(x, v))
        return tuple(out)

    return nag


# -- the generated libraries ------------------------------------------------------

def _unit(field: CustomField, family: str, op: str) -> tuple[str, str]:
    """(source, entry point) of the translation unit of ``field`` and one
    fused op or golden variant."""
    head = ("// Generated by raytracing_tpu_torch/kernels/custom.py: one "
            f"{family} loop on a CustomMedium ({op}).\n")
    medium = ("namespace rt {\n" + field.source + """
struct Custom {
  __host__ __device__ __forceinline__ void nag(float x, float y, float& n,
                                               float& gx, float& gy) const {
    custom_nag(x, y, n, gx, gy);
  }
  __host__ __device__ __forceinline__ void nag_fast(float x, float y,
                                                    float& n, float& gx,
                                                    float& gy,
                                                    bool& ok) const {
    custom_nag_fast(x, y, n, gx, gy, ok);
  }
};
}  // namespace rt
""")
    if family == "fused":
        if op not in _FUSED_OPS:
            raise ValueError(f"fused kernel supports ops {_FUSED_OPS}, got "
                             f"{op!r}")
        return (head + '#include "fused.cuh"\n' + medium + f"""
extern "C" int rt_fused_step_custom(RT_FUSED_PARAMS, void* stream) {{
  if (n <= 0) return 0;
  if (op != {op[2:]}) return static_cast<int>(cudaErrorInvalidValue);
  return rt::launch_fused_op<rt::Custom, {op[2:]}>(
      RT_FUSED_ARGS, rt::Custom{{}}, static_cast<cudaStream_t>(stream));
}}
""", "rt_fused_step_custom")
    if family != "golden" or op not in GOLDEN_VARIANTS:
        raise ValueError(f"no {family!r} custom kernel for {op!r}")
    curv, newton, iso = GOLDEN_VARIANTS[op]
    tf = ("false", "true")
    return (head + '#include "golden.cuh"\n' + medium + f"""
extern "C" int rt_golden_step_custom(RT_GOLDEN_PARAMS, void* stream) {{
  if (n <= 0) return 0;
  if (curv != {curv} || newton != {newton} || iso != {iso})
    return static_cast<int>(cudaErrorInvalidValue);
  return rt::launch_golden_variant<rt::Custom, {tf[curv]}, {tf[newton]},
                                   {tf[iso]}>(
      RT_GOLDEN_ARGS, rt::Custom{{}}, static_cast<cudaStream_t>(stream));
}}
""", "rt_golden_step_custom")


@functools.cache
def _headers_digest(csrc=build.CSRC) -> bytes:
    """The flags and every header in ``csrc`` (the headers that build.py
    hashes), read once a process as build.library() reads its sources."""
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for p in build._sources(csrc)[1]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.digest()


def _library_path(source: str, csrc=build.CSRC) -> Path:
    """The library of a generated unit built against the headers in
    ``csrc``, named by a digest of the unit, the flags and the headers."""
    h = hashlib.sha256(_headers_digest(csrc))
    h.update(source.encode())
    return CUSTOM_DIR / f"librt_custom_{h.hexdigest()[:16]}.so"


#: library path (a content hash) -> its loaded entry point
_LOADED: dict = {}


def build_libraries(specs) -> dict:
    """Build the libraries of ``specs`` ((field, family, op) each) that are
    not built yet, one nvcc each, all started together; a failed build
    raises with nvcc's output.  Returns {spec: seconds} of the builds run
    (a library found on disk is not built again and not listed)."""
    return build_units({spec: _unit(*spec)[0] for spec in specs})


def build_units(units: dict, csrc=build.CSRC) -> dict:
    """:func:`build_libraries` on generated units ({key: source}) against
    the headers in ``csrc`` (another checkout's, for a comparison of two
    builds); {key: seconds} of the builds run."""
    jobs, seconds, failed = [], {}, []
    for spec, source in units.items():
        lib = _library_path(source, csrc)
        if lib.exists() or any(j[1] == lib for j in jobs):
            continue
        CUSTOM_DIR.mkdir(parents=True, exist_ok=True)
        # this process's own unit, log and library, renamed into place after
        # nvcc: two processes building the same library never share a file
        tmp = {ext: lib.with_name(f"{lib.stem}.{os.getpid()}{ext}")
               for ext in (".cu", ".log", ".so")}
        tmp[".cu"].write_text(source)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc),
               "-shared", "-o", str(tmp[".so"]), str(tmp[".cu"])]
        log = tmp[".log"].open("w")
        log.write(f"$ {' '.join(cmd)}\n")
        log.flush()
        jobs.append([spec, lib, tmp, log, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)])
    while jobs:
        for job in [j for j in jobs if j[5].poll() is not None]:
            jobs.remove(job)
            spec, lib, tmp, log, t0, proc = job
            log.close()
            os.replace(tmp[".cu"], lib.with_suffix(".cu"))
            os.replace(tmp[".log"], lib.with_suffix(".log"))
            if proc.returncode != 0:
                out = lib.with_suffix(".log").read_text()
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{out[-8000:]}")
                continue
            os.replace(tmp[".so"], lib)   # atomic, as build.build
            seconds[spec] = time.perf_counter() - t0
        time.sleep(0.02)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(field: CustomField, family: str, op: str) -> str:
    """nvcc's output (ptxas's registers, stack and spills) for the library
    of ``field``'s ``family`` loop for ``op``; empty before its build."""
    log = _library_path(_unit(field, family, op)[0]).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library_for(field: CustomField, family: str, op: str):
    """The entry point of ``field``'s ``family`` ("fused" or "golden") loop
    for ``op`` from its library, built on first use and loaded once a
    process; (ctypes function, its name)."""
    source, entry = _unit(field, family, op)
    lib = _library_path(source)
    fn = _LOADED.get(lib)
    if fn is None:
        if not lib.exists():
            build_libraries([(field, family, op)])
        fn = _LOADED[lib] = getattr(build.load(lib, (entry,)), entry)
    return fn, fn.__name__


def specs_of(field: CustomField, family: str) -> list:
    """Every (field, family, op) library of a family."""
    ops = _FUSED_OPS if family == "fused" else tuple(GOLDEN_VARIANTS)
    return [(field, family, op) for op in ops]

