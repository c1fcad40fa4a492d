"""CUDA-graph replay of the plain versions' steps, for comparing kernels
with their plain versions on the card in less time.

A plain version (``fused_step_plain``, ``golden_step_plain``,
``fused3d_step_plain``) performs one
torch call an operation, so on the card its time is the host's dispatch of
some hundreds of small kernels a step.  :func:`replay_steps` captures one
step, with its output copied back into the input buffers, in a
``torch.cuda.CUDAGraph`` and replays it: the same kernels on the same
inputs in the same order, so the result equals the eager loop's to the bit.

A graph bakes in every Python value of the captured step.  The plain
versions read the step number in two places: the step limit
(``float(i + offset) < limit``, the same for every step before the limit
and no step after it changes the state) and op7's order ramp (global steps
1 and 2 differ from the rest).  :func:`fused_plain` and
:func:`golden_plain` run the steps where those differ eagerly and replay
only a run of steps over which they are constant; :func:`fused3d_plain`
has no order ramp, so it replays every step before the limit.
"""
from __future__ import annotations

import numpy as np
import torch


def replay_steps(step, st, steps: int):
    """``steps`` applications of ``step(state) -> state`` to the CUDA state
    ``st`` (a NamedTuple of tensors and None), by one capture and
    ``steps`` replays; a new state, ``st`` is not changed."""
    if steps <= 0:
        return st
    static = type(st)(*(None if t is None else t.clone() for t in st))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static)             # warm-up: lazy initialisation off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(static)
        for dst, src in zip(static, out):
            if dst is not None:
                dst.copy_(src)
    for _ in range(steps):
        graph.replay()
    return type(st)(*(None if t is None else t.clone() for t in static))


def live_steps(steps: int, offset, limit) -> int:
    """How many of the ``steps`` steps from global step ``offset`` come
    before the step limit, as the plain versions test it in float32."""
    off = np.float32(offset)
    return sum(1 for i in range(steps) if float(np.float32(i) + off) < limit)


def fused_plain(st, *, field, op: str, steps: int, delta_s, step_limit,
                offset: float, box):
    """``fused_step_plain`` with the same arguments, its steady steps
    replayed from a CUDA graph; equal to it to the bit."""
    from raytracing_tpu_torch.kernels.fused import fused_step_plain

    def run(s, n, off):
        return fused_step_plain(s, field=field, op=op, steps=n,
                                delta_s=delta_s, step_limit=step_limit,
                                offset=off, box=box)

    live = live_steps(steps, offset, float(step_limit))
    # op7's order ramp: global steps 1 and 2 (offset + i + 1) run eagerly
    head = min(live, max(0, 2 - int(offset))) if op == "op7" else 0
    st = run(st, head, offset)
    off = float(offset) + head
    return replay_steps(lambda s: run(s, 1, off), st, live - head)


def golden_plain(st, scal, *, field, op: str, steps: int, box, iters: int,
                 polish: int):
    """``golden_step_plain`` with the same arguments, replayed from a CUDA
    graph; equal to it to the bit.  The plain version reads the scalar
    bundle on the host, so the captured step gets a host copy of it."""
    from raytracing_tpu_torch.kernels.golden import golden_step_plain
    host = scal.cpu()
    limit, offset = float(host[2]), float(host[3])
    return replay_steps(
        lambda s: golden_step_plain(s, host, field=field, op=op, steps=1,
                                    box=box, iters=iters, polish=polish),
        st, live_steps(steps, offset, limit))


def fused3d_plain(st, *, field, op: str, steps: int, delta_s, step_limit,
                  offset: float, box):
    """``fused3d_step_plain`` with the same arguments, its steps before the
    step limit replayed from a CUDA graph (the steps after it change
    nothing); equal to it to the bit."""
    from raytracing_tpu_torch.kernels.fused3d import fused3d_step_plain

    return replay_steps(
        lambda s: fused3d_step_plain(s, field=field, op=op, steps=1,
                                     delta_s=delta_s, step_limit=step_limit,
                                     offset=float(offset), box=box),
        st, live_steps(steps, offset, float(step_limit)))
