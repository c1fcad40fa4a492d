# Verbatim copy of raytracing_tpu/bench/harness.py (numpy only; importing
# raytracing_tpu would import jax).
"""Benchmark harness: the reference's measurement protocol, device-timed.

Reproduces the statistical hygiene of RT_bench.py's benchmark block
(SURVEY.md 2.14): IQR outlier filtering (RT_bench.py:123-138), median of the
last 30 % of each round (1531), rounds repeated until the last two medians
agree within 0.5 % (1533-1536), final result the mean of the last two
(1538).  What is timed differs by design: the reference sums per-ray Python
``perf_counter`` brackets across process replicas; here a round times whole
device executions (``block_until_ready``) and reports throughput in
ray-steps/sec — the metric that transfers across hardware (SURVEY.md 5.1).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np


def remove_outliers_iqr(data: np.ndarray) -> np.ndarray:
    """IQR outlier filter (RT_bench.py:123-138)."""
    q1, q3 = np.percentile(data, 25), np.percentile(data, 75)
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    return data[(data >= lo) & (data <= hi)]


class BenchResult(NamedTuple):
    seconds: float            # converged completion time per execution
    rounds: int               # convergence rounds used
    samples: np.ndarray       # raw per-execution timings (all rounds)
    ray_steps_per_sec: float  # throughput at the converged time


def benchmark(fn: Callable[[], None], ray_steps: int, *,
              trials: int = 30, warmup: int = 3,
              converge_pct: float = 0.5, max_rounds: int = 12) -> BenchResult:
    """Time ``fn`` under the reference's convergence protocol.

    ``fn`` must execute one full workload and block until the device is done.
    ``ray_steps`` is the number of ray-steps one execution performs, for the
    throughput figure.  The reference's warmup loop is commented out
    (RT_bench.py:1509-1511); ours is real but short — on TPU the first call
    pays compilation, which must never be timed.
    """
    for _ in range(warmup):
        fn()

    all_samples: list[float] = []
    medians: list[float] = []
    rounds = 0
    while True:
        rounds += 1
        arr = np.empty(trials)
        for j in range(trials):
            t0 = time.perf_counter()
            fn()
            arr[j] = time.perf_counter() - t0
        all_samples.extend(arr.tolist())
        cleaned = remove_outliers_iqr(arr)
        medians.append(float(np.median(cleaned[int(-0.3 * len(cleaned)):])))
        if len(medians) >= 2:
            a, b = medians[-1], medians[-2]
            if 100.0 * abs(a - b) / max(a, b) < converge_pct:
                break
        if rounds >= max_rounds:
            break

    seconds = float(np.mean(medians[-2:]))
    return BenchResult(seconds=seconds, rounds=rounds,
                       samples=np.asarray(all_samples),
                       ray_steps_per_sec=ray_steps / seconds)
