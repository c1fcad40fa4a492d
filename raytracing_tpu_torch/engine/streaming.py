"""Chunk-streamed trajectory history (SURVEY.md 5.7).

Port of ``raytracing_tpu/engine/streaming.py``: ``stream_history``
(streaming.py:23) and ``trace_chunked`` (:85).  Full histories scale as
rays x steps x 6 values: a 2^20-ray fisheye history over one turn of the
headline divisor is 2^20 x 4588 x 6 x 4 B ~ 115 GB, more than a card
holds.  Here the scan tier (``engine/trace.py::run_steps``) runs in
segments of at most ``chunk`` steps, the ray state stays on the device
between segments, and each segment's history rows go to the host before
the next one runs, so the device holds O(rays x chunk) rows, never the
whole history.

``run_steps``' ``step_offset`` makes the step indices global: op7's order
ramp (keyed on the step number, ``ops/registry.py``) never re-primes and
``exit_step`` records global indices.  The step limit is global too, so a
segment deactivates every surviving ray at its end; rays that truly left
the box sit strictly outside it, so "inside the box" re-arms exactly the
survivors (streaming.py:76-81, 127-133).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from raytracing_tpu_torch import config
from raytracing_tpu_torch.engine.trace import (
    TraceResult, _outside, prepare, run_steps)


def _segments(op_name, scen, medium, *, delta_s, device, max_size, dtype,
              pos0, theta0, chunk, history):
    """Run ``max_size - 1`` steps in segments of at most ``chunk``; yield
    each segment's :class:`TraceResult`, its first global step index and
    its length.  Survivors are re-armed between segments; a ray's recorded
    exit step is kept, a still-inside ray's reset to the global limit."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    op, st, gamma, ds = prepare(op_name, scen, medium, delta_s=delta_s,
                                device=device, max_size=max_size,
                                dtype=dtype, pos0=pos0, theta0=theta0)
    total = max_size - 1
    box = tuple(scen.box)
    done = 0
    while done < total:
        seg = min(chunk, total - done)
        res = run_steps(op, st, medium, gamma, ds, max_size=seg + 1,
                        step_limit=done + seg, box=box, history=history,
                        step_offset=done)
        yield res, done, seg
        done += seg
        # the rows of a history segment are released before the next runs
        final = res.final
        del res
        out = _outside(final.pos, box)
        st = final._replace(
            active=~out,
            exit_step=torch.where(out, final.exit_step,
                                  torch.full_like(final.exit_step, total)))


def _to_host(rows) -> np.ndarray:
    """A segment's rows as a numpy array: from the card through page-locked
    memory (PyTorch's host allocator reuses a chunk's block once the caller
    drops the array), several times the rate of a pageable copy."""
    if not rows.is_cuda:
        return rows.numpy()
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    host.copy_(rows)
    return host.numpy()


def stream_history(op_name: str, scen: config.ScenarioConfig, medium, *,
                   delta_s: float, device="cuda", divisor: int | None = None,
                   n_turns: int = config.N_TURNS, chunk: int = 512,
                   dtype=torch.float32, pos0=None, theta0=None
                   ) -> Iterator[np.ndarray]:
    """Yield history chunks of shape (<= chunk, R, 6) as host numpy arrays.

    Concatenating all chunks equals ``trace(..., mode="history")``'s
    history (row 0 once, at the start of the first chunk).  The rays are
    traced on ``device`` at ``dtype``; a segment's rows are copied to the
    host and released on the device before the next segment runs.
    """
    max_size = scen.max_size(delta_s, divisor, n_turns)
    for res, done, seg in _segments(
            op_name, scen, medium, delta_s=delta_s, device=device,
            max_size=int(max_size), dtype=dtype, pos0=pos0, theta0=theta0,
            chunk=chunk, history=True):
        rows = res.history[(0 if done == 0 else 1):]
        del res
        yield _to_host(rows)
        del rows


def trace_chunked(op_name: str, scen: config.ScenarioConfig, medium, *,
                  delta_s: float, device="cuda", divisor: int | None = None,
                  n_turns: int = config.N_TURNS, chunk: int = 128,
                  dtype=torch.float32, pos0=None, theta0=None,
                  max_size: int | None = None) -> TraceResult:
    """Metrics-mode trace through segments of at most ``chunk`` steps.

    The result equals ``trace(..., mode="metrics")``, ``exit_step``
    included.  JAX bounds its compile time this way (one bounded scan
    serves any length); in the port it is the same trace with the state
    handed from one segment to the next, on ``device`` at ``dtype``.
    """
    if max_size is None:
        max_size = scen.max_size(delta_s, divisor, n_turns)
    res = None
    for res, _, _ in _segments(
            op_name, scen, medium, delta_s=delta_s, device=device,
            max_size=int(max_size), dtype=dtype, pos0=pos0, theta0=theta0,
            chunk=chunk, history=False):
        pass
    return res
