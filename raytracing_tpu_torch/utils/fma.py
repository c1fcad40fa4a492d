"""A correctly rounded float32 fused multiply-add from PyTorch operations.

The 2-D grid blend of ``csrc/media.cuh`` (``hermite_blend``), the 2-D
dynamic step on the analytic fields and the 2-D grids with its channels
(``csrc/dynamic.cuh``; ``Analytic::field_h``, ``hermite_blend_h``,
``c1_blend_h``) and the analytic 3-D step (``csrc/fused3d.cuh``)
form their sums of products with ``fmaf``: a * b + c rounded once.  Their
plain versions (``kernels/fused.py::hermite_blend``,
``kernels/dynamic.py::dynamic_step_plain`` with ``field_fn_h`` and
``tile_nag_h``, ``kernels/fused3d.py::fused3d_step_plain``) compute the
same rounding with :func:`fma32` (those steps through :func:`mads`), on
the CPU and on the card alike, so that the kernels and their plain
versions stay equal to the bit.

How: the float32 operands are widened to float64, where a * b is exact (24
+ 24 significant bits fit in 53) and p + c rounds once to s, with TwoSum's
exact error e (p + c = s + e).  Narrowing s to float32 would round twice.
So s is first rounded to odd: where e is not 0 and the last bit of s is 0,
s moves one float64 ulp toward e (the other float64 neighbour of p + c,
whose last bit is 1).  A float64 number with an odd last bit is never a
float32 number nor a midpoint between two (those have at least 29 trailing
zero bits in float64), so p + c and the odd s lie strictly between the same
two neighbouring float32 midpoints, and narrowing the odd s rounds as
narrowing p + c would: one correct rounding to float32 (Boldo and
Melquiond, "Emulation of FMA and correctly rounded sums: proved algorithms
using rounding to odd", IEEE Trans. Computers 57(4), 2008; 53 >= 24 + 2
bits).  That holds in float32's subnormal range too, and wherever p and c
are finite (p is exact there: |a b| lies in [2^-298, 2^256)).  An infinite
or NaN operand gives the float32 result of its float64 sum.
"""
from __future__ import annotations

import numpy as np
import torch


def _f64(v):
    """A tensor widened to float64; a Python number rounded to float32 and
    kept a Python float (a float64 scalar, so that no host-to-device copy
    is made: the plain versions run inside CUDA graph captures)."""
    if torch.is_tensor(v):
        return v.to(torch.float64)
    return float(np.float32(v))


def fma32(a, b, c, neg_ab=False, neg_c=False):
    """a * b + c rounded once to float32, elementwise (fmaf's bits);
    -(a * b) for a * b where ``neg_ab``, -c for c where ``neg_c`` (the
    negated operands of the kernels' FFMA: exact, so c - a b and a b - c
    round once too).

    ``a``, ``b``, ``c``: float32 tensors or Python numbers (each number is
    taken as the float32 it rounds to), broadcast together; at least one of
    a, b is a tensor, or c is.  Returns a float32 tensor on the tensors'
    device.
    """
    a, b, c = _f64(a), _f64(b), _f64(c)
    p = -(a * b) if neg_ab else a * b        # exact
    if neg_c:
        c = -c
    s = p + c
    # TwoSum: p + c = s + e exactly
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    # round to odd: where e != 0 and s's last bit is 0, the neighbour of s
    # toward e
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.copysign(torch.full_like(s, float("inf")),
                                            e))
    return torch.where((e != 0) & even, odd, s).to(torch.float32)


def mads(fused: bool):
    """``mad(a, b, c, sub=False, neg_c=False)``: a[k] * b[k] + c[k] for each
    k of equal-length tuples of tensors or Python numbers, as a tuple; c[k]
    - a[k] * b[k] where ``sub``, a[k] * b[k] - c[k] where ``neg_c``.  Where
    ``fused`` (the 2-D dynamic, analytic 3-D and df32 steps' FMA form,
    csrc/common.cuh ``mad<true>`` with a negated operand) each rounded
    once by :func:`fma32`, the tuple's terms stacked into one call (the
    same roundings in fewer torch calls; a single term passed as it is)
    and the negation inside it, as the kernel's FFMA negates its
    operand; else each product and sum rounded apart, JAX's roundings term
    for term (``mad<false>``: (-a) * b + c is c - a * b, and a sum's
    operands commute)."""
    def apart(a, b, c, sub=False, neg_c=False):
        if sub:
            return tuple(z - x * y for x, y, z in zip(a, b, c))
        if neg_c:
            return tuple(x * y - z for x, y, z in zip(a, b, c))
        return tuple(x * y + z for x, y, z in zip(a, b, c))

    def fused_(a, b, c, sub=False, neg_c=False):
        if len(a) == 1:
            return (fma32(a[0], b[0], c[0], neg_ab=sub, neg_c=neg_c),)
        ref = next(v for v in (*a, *b, *c) if torch.is_tensor(v))

        def column(vs):
            if not any(torch.is_tensor(v) for v in vs) and len(set(vs)) == 1:
                return vs[0]
            return torch.stack([v if torch.is_tensor(v) else torch.full_like(
                ref, float(np.float32(v))) for v in vs])
        return tuple(fma32(column(a), column(b), column(c), neg_ab=sub,
                           neg_c=neg_c).unbind(0))

    return fused_ if fused else apart
