"""CUDA-graph replay of the plain versions' steps, for comparing kernels
with their plain versions on the card in less time.

A plain version (``fused_step_plain``, also with a step size and limit a
ray, ``golden_step_plain``,
``fused3d_step_plain``, ``dynamic_step_plain``, ``dynamic3d_step_plain``,
``df_step_plain``) performs one
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
only a run of steps over which they are constant; :func:`sweep_plain`
(a step limit a ray) keeps the steps left before each ray's limit in a
device tensor that the captured step lowers; :func:`fused3d_plain`
and :func:`dynamic_plain` have no order ramp, so they replay every step
before the limit; :func:`df_plain`'s step reads no step number at all.  The 3-D
dynamic step reads its global step number in the focus locator too (the
past-source guard and the recorded step), so :func:`dynamic3d_plain`
keeps it in a device tensor that the captured step advances.
"""
from __future__ import annotations

import numpy as np
import torch


def replay_steps(step, st, steps: int, before_replay=None):
    """``steps`` applications of ``step(state) -> state`` to the CUDA state
    ``st`` (a NamedTuple of tensors and None), by one capture and
    ``steps`` replays; a new state, ``st`` is not changed.
    ``before_replay()``, if given, runs after the capture and before the
    first replay (to reset what the warm-up step changed outside the
    state)."""
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
    if before_replay is not None:
        before_replay()
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


def sweep_plain(st, *, field, op: str, steps: int, delta_s, step_limit,
                box):
    """``fused_step_plain`` with a step size and a step limit a ray (``delta_s``
    and ``step_limit`` (R,) float32 tensors: the sweep's plain version) from
    global step 0, its steady steps replayed from a CUDA graph; equal to
    the eager loop to the bit.  The eager loop tests each ray's limit as
    ``i < step_limit`` with the step number i a Python value, which a graph
    would bake in; the captured step instead tests ``head < left`` on a
    device tensor ``left`` that starts at ``step_limit`` and that the step
    lowers by one (exact: whole numbers below 2**24), which is the same
    test at every step i = head + k.  op7's first two steps (its order
    ramp) run eagerly, as in :func:`fused_plain`."""
    from raytracing_tpu_torch.kernels.fused import fused_step_plain

    def run(s, n, limit, off):
        return fused_step_plain(s, field=field, op=op, steps=n,
                                delta_s=delta_s, step_limit=limit,
                                offset=off, box=box)

    head = min(steps, 2) if op == "op7" else 0
    st = run(st, head, step_limit, 0.0)
    left = step_limit.clone()

    def step(s):
        out = run(s, 1, left, float(head))
        left.sub_(1.0)
        return out

    return replay_steps(step, st, live_steps(steps - head, head,
                                             float(step_limit.max())),
                        before_replay=lambda: left.copy_(step_limit))


def golden_plain(st, scal, *, field, op: str, steps: int, box, iters: int,
                 polish: int, guards=None):
    """``golden_step_plain`` with the same arguments, replayed from a CUDA
    graph; equal to it to the bit.  The plain version reads the scalar
    bundle on the host, so the captured step gets a host copy of it.
    ``guards`` counts as there, the warm-up step's count taken back before
    the first replay."""
    from raytracing_tpu_torch.kernels.golden import golden_step_plain
    host = scal.cpu()
    limit, offset = float(host[2]), float(host[3])
    return replay_steps(
        lambda s: golden_step_plain(s, host, field=field, op=op, steps=1,
                                    box=box, iters=iters, polish=polish,
                                    guards=guards),
        st, live_steps(steps, offset, limit),
        before_replay=None if guards is None else guards.zero_)


def df_plain(st, medium, delta_s, steps: int):
    """``df_step_plain`` with the same arguments, every step replayed from a
    CUDA graph; equal to it to the bit."""
    from raytracing_tpu_torch.kernels.df import df_step_plain

    return replay_steps(
        lambda s: df_step_plain(s, medium, delta_s, 1), st,
        int(steps))


def fused3d_plain(st, *, field, op: str, steps: int, delta_s, step_limit,
                  offset: float, box, guards=None):
    """``fused3d_step_plain`` with the same arguments, its steps before the
    step limit replayed from a CUDA graph (the steps after it change
    nothing); equal to it to the bit.  ``guards`` counts as there, the
    warm-up step's count taken back before the first replay."""
    from raytracing_tpu_torch.kernels.fused3d import fused3d_step_plain

    return replay_steps(
        lambda s: fused3d_step_plain(s, field=field, op=op, steps=1,
                                     delta_s=delta_s, step_limit=step_limit,
                                     offset=float(offset), box=box,
                                     guards=guards),
        st, live_steps(steps, offset, float(step_limit)),
        before_replay=None if guards is None else guards.zero_)


def dynamic_plain(st, *, field, op: str, steps: int, delta_s, step_limit,
                  offset: float, box, guards=None):
    """``dynamic_step_plain`` with the same arguments, its steps before the
    step limit replayed from a CUDA graph (the steps after it change
    nothing); equal to it to the bit: each replayed step evaluates the
    field at the state's position, which is the channels the eager loop
    carries.  ``guards`` counts as there, the warm-up step's count taken
    back before the first replay."""
    from raytracing_tpu_torch.kernels.dynamic import dynamic_step_plain

    return replay_steps(
        lambda s: dynamic_step_plain(s, field=field, op=op, steps=1,
                                     delta_s=delta_s, step_limit=step_limit,
                                     offset=float(offset), box=box,
                                     guards=guards),
        st, live_steps(steps, offset, float(step_limit)),
        before_replay=None if guards is None else guards.zero_)


def dynamic3d_plain(st, *, field, op: str, steps: int, delta_s, step_limit,
                    offset: float, box):
    """``dynamic3d_step_plain`` with the same arguments, its steps before the
    step limit replayed from a CUDA graph (the steps after it change
    nothing); equal to it to the bit.  The global step index is a float32
    device tensor that the captured step advances by 1, from ``offset``
    (exact in float32 for every step count below 2**24)."""
    from raytracing_tpu_torch.kernels.dynamic3d import dynamic3d_plain_step

    gi = torch.zeros((), dtype=torch.float32, device=st.x.device)

    def step(s):
        out = dynamic3d_plain_step(s, gi, field=field, op=op,
                                   delta_s=delta_s, step_limit=step_limit,
                                   box=box)
        gi.add_(1.0)
        return out

    return replay_steps(step, st, live_steps(steps, offset, float(step_limit)),
                        before_replay=lambda: gi.fill_(float(np.float32(
                            offset))))
