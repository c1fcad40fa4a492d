"""A correctly rounded float32 fused multiply-add from PyTorch operations.

The 2-D grid blend of ``csrc/media.cuh`` (``hermite_blend``) forms its sums
of products with ``fmaf``: a * b + c rounded once.  Its plain version
(``kernels/fused.py::hermite_blend``) computes the same rounding with
:func:`fma32`, on the CPU and on the card alike, so that the kernels and
their plain versions stay equal to the bit.

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


def fma32(a, b, c):
    """a * b + c rounded once to float32, elementwise (fmaf's bits).

    ``a``, ``b``, ``c``: float32 tensors or Python numbers (each number is
    taken as the float32 it rounds to), broadcast together; at least one of
    a, b is a tensor, or c is.  Returns a float32 tensor on the tensors'
    device.
    """
    a, b, c = _f64(a), _f64(b), _f64(c)
    p = a * b                       # exact
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
