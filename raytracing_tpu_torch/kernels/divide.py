"""The correctly rounded operations of ``csrc/common.cuh`` that start from a
shared or approximate reciprocal (``div_by``, ``div_fast_pos``,
``rcp_rn``, ``sqrt_fast``, ``rsqrt_fast``) held to the card's own
operations.

The 3-D dynamic loop (``csrc/dynamic3d.cuh``) forms the quotients of its
five denominators (n, 2n, 2n * n, 60, 360) from each denominator's
reciprocal, one multiply and two FMAs a quotient, instead of one IEEE
division each; the fused step (``csrc/fused.cuh``) divides by n and the
next n from a carried reciprocal (``div_fast_pos``) and takes its step
length's square root by ``sqrt_fast``; the analytic fields and the
generated custom fields take their reciprocals by ``rcp_rn``, and
``fisheye_op1`` its normalization by ``rsqrt_fast``.  The kernels are
bit-equal to their plain versions only if each of these has the card's
IEEE operation's bits (``rsqrtf``'s for ``rsqrt_fast``).
:func:`div_check` launches ``csrc/divide.cu``'s check kernel: all 2^32
float32 numerators over one denominator, or seeded random pairs, each
against ``__fdiv_rn``; all 2^32 operands of the reciprocal, square root
and rsqrt against ``__frcp_rn``, ``__fsqrt_rn`` and ``rsqrtf``.  It is a
check, not a port of a TPU kernel, and it needs the card; the CPU tests
hold the same header functions, built by g++, to numpy.

:func:`fma_card` gives the card's ``fmaf`` (``fma_rn``, one FFMA: the 2-D
grid blend's sums of products, csrc/media.cuh ``hermite_blend``) on
float32 tensors, which chip_smoke.py's ``[fma32]`` phase holds to the plain
versions' :func:`raytracing_tpu_torch.utils.fma.fma32` on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from raytracing_tpu_torch.kernels import build


#: div_check's kinds -> csrc/divide.cu's modes: (with a denominator, without)
MODES = {"div_by": (0, 1), "div_pos": (5, 6), "rcp": (2, None),
         "sqrt": (3, None), "rsqrt": (4, None)}


def div_check(*, denominator: float | None = None, count: int,
              first: int = 0, seed: int = 0, kind: str = "div_by",
              device="cuda"):
    """(differing operands, one differing (a, b) or None) of one of
    common.cuh's operations against the card's own on the card.

    ``kind`` "div_by" (``div_by``) or "div_pos" (``div_fast_pos``, the
    IEEE division where its guard fails): with ``denominator``, the
    numerators whose float32 bit patterns are ``first`` .. ``first +
    count - 1``; without, ``count`` pairs drawn from ``seed`` (half over
    every bit pattern, half around the helper's fast-path ranges;
    csrc/divide.cu).  "rcp", "sqrt", "rsqrt": ``rcp_rn``, ``sqrt_fast``
    and ``rsqrt_fast`` (the card's operation where the guard fails) on the
    operands whose bit patterns are ``first`` .. ``first + count - 1``,
    against ``__frcp_rn``, ``__fsqrt_rn`` and ``rsqrtf``; their ``b`` is
    0."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("div_check runs on the card: pass a CUDA device")
    if kind not in MODES:
        raise ValueError(f"div_check kinds are {sorted(MODES)}, not {kind!r}")
    with_b, without_b = MODES[kind]
    if without_b is None and denominator is not None:
        raise ValueError(f"{kind} takes no denominator")
    out = torch.zeros(3, dtype=torch.int64, device=device)
    mode, b = ((without_b, 0.0) if denominator is None and without_b is not None
               else (with_b, 0.0 if denominator is None else float(denominator)))
    with torch.cuda.device(device):
        build.check(build.library().rt_div_check(
            mode, b, int(first), int(count), int(seed), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "rt_div_check")
    bad, a_bits, b_bits = (int(v) for v in out.cpu())
    if bad == 0:
        return 0, None
    pair = np.array([a_bits, b_bits], np.uint32).view(np.float32)
    return bad, (float(pair[0]), float(pair[1]))


def fma_card(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """a * b + c rounded once, by the card's ``fmaf`` (csrc/divide.cu
    ``rt_fma``), elementwise on float32 CUDA tensors of one shape."""
    if not (a.is_cuda and b.is_cuda and c.is_cuda):
        raise ValueError("fma_card runs on the card: pass CUDA tensors")
    if not (a.shape == b.shape == c.shape) or any(
            t.dtype != torch.float32 for t in (a, b, c)):
        raise ValueError("fma_card takes three float32 tensors of one shape")
    a, b, c = (t.contiguous() for t in (a, b, c))
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        build.check(build.library().rt_fma(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
            a.numel(), torch.cuda.current_stream().cuda_stream), "rt_fma")
    return out
