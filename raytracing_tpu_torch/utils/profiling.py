"""Tracing and profiling utilities (SURVEY.md 5.1).

Port of ``raytracing_tpu/utils/profiling.py``: ``StepRate`` (profiling.py:17),
``step_timer`` (:23) and ``device_trace`` (:40).  The reference's
observability is ``perf_counter`` brackets around each ray loop
(RT_bench.py:831, 881-882); here a ray-step rate counted from the steps
times the rays, and ``torch.profiler`` traces of the host and the card.

``step_timer`` takes an optional ``device``: on a CUDA device it
synchronizes at both edges of the block, so that the rate counts the
card's work and not its enqueue (JAX's callers get the same effect from
``block_until_ready``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, NamedTuple

import torch


class StepRate(NamedTuple):
    seconds: float
    ray_steps: int
    rate: float  # ray-steps/sec


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def step_timer(ray_steps: int, sink: list | None = None,
               device=None) -> Iterator[None]:
    """Time a block that performs ``ray_steps`` ray-steps; append a
    :class:`StepRate` to ``sink`` (or print).  With a CUDA ``device`` the
    card is synchronized before the clock starts and before it stops."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    r = StepRate(seconds=dt, ray_steps=ray_steps, rate=ray_steps / dt)
    if sink is not None:
        sink.append(r)
    else:
        print(f"{r.ray_steps} ray-steps in {r.seconds:.4f}s "
              f"-> {r.rate:.3e} ray-steps/s")


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace of the enclosed block, written to ``logdir``
    as a Chrome trace (``*.pt.trace.json``: TensorBoard's profiler plugin
    and Perfetto open it).  CUDA activity is traced when a card is there;
    the block's launches are waited for before the trace closes.  Yields
    the profiler (``key_averages()`` sums the events by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    with prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
