"""Fused fisheye op1 integrator: the headline workload.

Port of ``raytracing_tpu/kernels/fisheye.py``: ``_fisheye_kernel``
(fisheye.py:33), ``fisheye_trace_final`` (:84) and ``make_fisheye_runner``
(:121).  op1 (RT_bench.py:469-491) on the analytic Maxwell fisheye:
first-order Kahan-compensated positions and the momentum-impulse tangent
update written trig-free, ``normalize(n u + (grad n0 + grad n1) ds/2)``
(RT_bench.py:393-407), with a trapezoid traveltime.

The kernel is ``csrc/fisheye.cu`` (``fisheye_op1``); :func:`fisheye_op1_plain`
is its plain PyTorch version and :func:`fisheye_op1` the wrapper, which runs
the plain version for CPU tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels.fused import _kahan, _vectors, field_fn

KERNEL = build.KernelInfo(
    name="fisheye_op1", source="raytracing_tpu_torch/csrc/fisheye.cu",
    replaces="raytracing_tpu/kernels/fisheye.py:33")


def fisheye_op1_plain(x, y, ux, uy, delta_s, steps: int):
    """Plain PyTorch version of the ``fisheye_op1`` kernel (fisheye.py:33-80):
    returns the final (x, y, traveltime)."""
    nag = field_fn("fisheye")
    ds = float(np.float32(delta_s))
    cx = torch.zeros_like(x)
    cy = torch.zeros_like(y)
    tt = torch.zeros_like(x)
    n, gx, gy = nag(x, y)
    half = ds * 0.5
    for _ in range(steps):
        x, cx = _kahan(x, cx, ux * ds)
        y, cy = _kahan(y, cy, uy * ds)
        n2, gx2, gy2 = nag(x, y)
        sx = n * ux + (gx + gx2) * half
        sy = n * uy + (gy + gy2) * half
        inv = torch.rsqrt(sx * sx + sy * sy)
        ux = sx * inv
        uy = sy * inv
        tt = tt + ds * (n + n2) * 0.5
        n, gx, gy = n2, gx2, gy2
    return x, y, tt


def fisheye_op1(x, y, ux, uy, delta_s, steps: int):
    """The kernel's wrapper: ``steps`` op1 steps from (x, y, ux, uy).

    Takes four contiguous float32 (R,) tensors on one device and returns
    the final (x, y, traveltime).  CPU tensors run
    :func:`fisheye_op1_plain`; CUDA tensors launch the kernel or raise.
    """
    r = x.shape[0]
    for name, t in (("x", x), ("y", y), ("ux", ux), ("uy", uy)):
        if (t.dtype != torch.float32 or t.shape != (r,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous ({r},) float32 tensor "
                             f"on {x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if x.device.type == "cpu":
        return fisheye_op1_plain(x, y, ux, uy, delta_s, int(steps))
    if x.device.type != "cuda":
        raise ValueError(f"fisheye_op1 runs on cpu or cuda, not {x.device}")
    ox, oy, ott = (torch.empty_like(x) for _ in range(3))
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rt_fisheye_op1(
            x.data_ptr(), y.data_ptr(), ux.data_ptr(), uy.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), ott.data_ptr(), r, int(steps),
            float(delta_s), torch.cuda.current_stream().cuda_stream)
    build.check(err, "rt_fisheye_op1")
    KERNEL.launches += 1
    return ox, oy, ott


def fisheye_trace_final(pos0, theta0, delta_s, *, steps: int, device):
    """Integrate ``steps`` op1 fisheye steps; return final (pos, traveltime).

    ``pos0`` is (R, 2), ``theta0`` (R,); any R (no block padding).
    """
    x, y, th = _vectors(pos0, theta0, device)
    fx, fy, tt = fisheye_op1(x, y, torch.cos(th), torch.sin(th), delta_s,
                             steps)
    return torch.stack([fx, fy], dim=-1), tt


def make_fisheye_runner(rays: int, divisor: int, n_turns: int, *, device):
    """The headline adapter: a callable that runs the benchmark launch and
    waits for it, returning the final positions (R, 2).

    Reference step-count semantics: steps = n_turns * (divisor + 1) - 1
    (RT_bench.py:797, 1388), at delta_s = 2 pi / divisor; every ray starts
    at (1, 0) heading pi/2.  The launch batch is made on the device once.
    """
    steps = n_turns * (divisor + 1) - 1
    pos0 = torch.zeros((rays, 2), dtype=torch.float32, device=device)
    pos0[:, 0] = 1.0
    theta0 = torch.full((rays,), math.pi / 2.0, dtype=torch.float32,
                        device=device)
    ds = float(np.float32(2.0 * math.pi / divisor))

    def run(pipeline: int = 1):
        """``pipeline`` back-to-back launches, then one completion wait."""
        pos = None
        for _ in range(pipeline):
            pos, _ = fisheye_trace_final(pos0, theta0, ds, steps=steps,
                                         device=device)
        if pos.is_cuda:
            torch.cuda.synchronize(pos.device)
        return pos

    run.steps = steps
    return run
