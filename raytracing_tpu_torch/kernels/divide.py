"""The division by a shared reciprocal (``csrc/common.cuh``: ``recip``,
``div_by``) held to IEEE division on the card.

The 3-D dynamic loop (``csrc/dynamic3d.cuh``) forms the quotients of its
five denominators (n, 2n, 2n * n, 60, 360) from each denominator's
reciprocal, one multiply and two FMAs a quotient, instead of one IEEE
division each; its kernels are bit-equal to their plain versions only if
every such quotient has the IEEE quotient's bits.  :func:`div_check`
launches ``csrc/divide.cu``'s check kernel: all 2^32 float32 numerators
over one denominator, or seeded random pairs, each against ``__fdiv_rn``.
It is a check, not a port of a TPU kernel, and it needs the card; the CPU
tests hold the same header function, built by g++, to numpy's division.
"""
from __future__ import annotations

import numpy as np
import torch

from raytracing_tpu_torch.kernels import build


def div_check(*, denominator: float | None = None, count: int,
              first: int = 0, seed: int = 0, device="cuda"):
    """(differing pairs, one differing (a, b) or None) of ``div_by`` against
    ``__fdiv_rn`` on the card: with ``denominator``, the numerators whose
    float32 bit patterns are ``first`` .. ``first + count - 1``; without,
    ``count`` pairs drawn from ``seed`` (half over every bit pattern, half
    around the helper's fast-path ranges; csrc/divide.cu)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("div_check runs on the card: pass a CUDA device")
    out = torch.zeros(3, dtype=torch.int64, device=device)
    mode, b = (1, 0.0) if denominator is None else (0, float(denominator))
    with torch.cuda.device(device):
        build.check(build.library().rt_div_check(
            mode, b, int(first), int(count), int(seed), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "rt_div_check")
    bad, a_bits, b_bits = (int(v) for v in out.cpu())
    if bad == 0:
        return 0, None
    pair = np.array([a_bits, b_bits], np.uint32).view(np.float32)
    return bad, (float(pair[0]), float(pair[1]))
