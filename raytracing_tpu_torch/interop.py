"""Carry ray state across from the JAX package, and back, as numpy.

New in the port (nothing in ``raytracing_tpu`` to mirror).  The JAX
package's state objects are pytrees of arrays; their numpy form is the
interchange format, so neither package imports the other:

* :func:`ray_state_from_numpy` builds the scan tier's
  :class:`~raytracing_tpu_torch.engine.state.RayState` from a dict of
  arrays (e.g. ``jax_state._asdict()`` converted with ``np.asarray``);
* :func:`trace_result_to_numpy` turns a port :class:`TraceResult` into
  nested dicts of numpy arrays, in the JAX result's field names;
* :func:`resume_state_from_numpy` / :func:`resume_state_to_numpy` convert
  the kernels' resume state from / to the flat component list of the JAX
  segmented tier (``engine/segmented.py::_initial_comps`` layout, which the
  JAX checkpoint format also stores): golden (x, y, cx, cy, ang, tt, dsim,
  active) [+ count, mean, M2]; fused (x, y, ux, uy, cx, cy, tt, dsim,
  active) [+ count, mean, M2] [+ op7 window wax, way, wbx, wby], with
  ``active`` as 0/1 floats;
* :func:`dynamic_state_from_numpy` / :func:`dynamic_state_to_numpy` convert
  the dynamic kernels' state from / to the JAX dynamic tier's 18-component
  resume list (``engine/segmented.py:1844-1850``: x, y, cx, cy, ux, uy, tt,
  dsim, active, dpx, dpy, dth, sgn, kmah, kdx, kdy, kdt, ktt), ``active``
  as 0/1 floats;
* :func:`fused3_state_from_numpy` / :func:`fused3_state_to_numpy` convert
  the fused 3-D kernels' 12-plane state from / to the JAX tiled3 tier's
  component list (``engine/tiled3.py:375-377``: x, y, z, cx, cy, cz, ux,
  uy, uz, tt, dsim, active), ``active`` as 0/1 floats;
* :func:`medium_from_numpy` builds any of the six sampled media
  (``GridMedium``, ``StratifiedGridMedium``, ``HermiteGridMedium``,
  ``C1GridMedium``, ``C1StratifiedMedium``, the 3-D ``C1Grid3Medium``) and
  the four df32 media
  (``DfGridMedium``, ``DfC1Medium``, ``DfC1Profile``, ``DfEvalProfile``,
  whose ``prof`` comes as a nested dict of its ``DfC1Profile``'s fields)
  from the JAX medium's class name, its arrays as numpy and its static
  fields, so both packages trace the same tables;
* :func:`df_state_from_numpy` builds the df32 kernels' 8-plane
  :class:`~raytracing_tpu_torch.kernels.df.DfState` from the JAX df tier's
  resume tuple (``kernels/df.py:326-329``: xh, xl, yh, yl, uxh, uxl, uyh,
  uyl).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_tpu_torch.engine.state import RayState
from raytracing_tpu_torch.engine.trace import TraceResult
from raytracing_tpu_torch.engine.df_grid import (
    DfC1Medium, DfC1Profile, DfEvalProfile, DfGridMedium)
from raytracing_tpu_torch.kernels.df import DfState
from raytracing_tpu_torch.kernels.dynamic import DynState
from raytracing_tpu_torch.kernels.fused import ResumeState
from raytracing_tpu_torch.kernels.fused3d import Fused3State
from raytracing_tpu_torch.kernels.golden import GOLDEN_OPS
from raytracing_tpu_torch.media.c1 import C1GridMedium, C1StratifiedMedium
from raytracing_tpu_torch.media.grid3 import C1Grid3Medium
from raytracing_tpu_torch.media.hermite import HermiteGridMedium
from raytracing_tpu_torch.media.spline import GridMedium, StratifiedGridMedium

#: the sampled media by class name, the same in both packages
MEDIUM_CLASSES = {cls.__name__: cls for cls in (
    GridMedium, StratifiedGridMedium, HermiteGridMedium, C1GridMedium,
    C1StratifiedMedium, C1Grid3Medium, DfGridMedium, DfC1Medium,
    DfC1Profile, DfEvalProfile)}
#: fields that hold a medium of their own, by the class they hold
_NESTED = {"prof": "DfC1Profile"}


def _to_numpy(t):
    return None if t is None else t.detach().cpu().numpy()


def ray_state_from_numpy(d: dict, *, device) -> RayState:
    """A :class:`RayState` from a dict of arrays keyed by its field names.

    Missing or ``None`` entries stay ``None``; ``active`` becomes bool and
    ``exit_step`` int32; float fields keep their dtype.
    """
    unknown = set(d) - set(RayState._fields)
    if unknown:
        raise ValueError(f"not RayState fields: {sorted(unknown)}")
    vals = {}
    for name in RayState._fields:
        a = d.get(name)
        if a is None:
            vals[name] = None
            continue
        a = np.array(a)   # a writable copy: JAX's exported arrays are read-only
        if name == "active":
            t = torch.as_tensor(a.astype(bool), device=device)
        elif name == "exit_step":
            t = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            t = torch.as_tensor(a, device=device)
        vals[name] = t
    return RayState(**vals)


def trace_result_to_numpy(res: TraceResult) -> dict:
    """Nested dict of numpy arrays: ``final`` (a dict of the RayState
    fields), ``exit_step``, ``dist_real``, ``dist_sim``, ``history`` and
    ``n_hist`` (None in metrics mode)."""
    return {
        "final": {k: _to_numpy(v) for k, v in res.final._asdict().items()},
        "exit_step": _to_numpy(res.exit_step),
        "dist_real": _to_numpy(res.dist_real),
        "dist_sim": _to_numpy(res.dist_sim),
        "history": _to_numpy(res.history),
        "n_hist": _to_numpy(res.n_hist),
    }


def resume_state_from_numpy(comps, op: str, *, with_stats: bool,
                            device) -> ResumeState:
    """A kernel :class:`ResumeState` from the JAX segmented tier's component
    list (any shapes; each component is flattened to (R,)).

    The golden kernels carry the tangent beside the angle; from a JAX state
    it is (cos, sin) of the angle, which is what the JAX golden kernel
    itself re-derives at every segment start (golden.py:458).
    """
    def vec(a):
        # a writable float32 copy: JAX's exported arrays are read-only
        return torch.as_tensor(np.array(a, np.float32).reshape(-1),
                               device=device)

    comps = [vec(c) for c in comps]
    golden = op in GOLDEN_OPS
    n_base = 8 if golden else 9
    want = n_base + (3 if with_stats else 0) + (4 if op == "op7" else 0)
    if len(comps) != want:
        raise ValueError(f"{op} with_stats={with_stats} has {want} resume "
                         f"components, got {len(comps)}")
    stats = dict(zip(("mom_count", "mom_mean", "mom_m2"),
                     comps[n_base:n_base + 3])) if with_stats else {}
    if golden:
        x, y, cx, cy, ang, tt, dsim, act = comps[:8]
        return ResumeState(x=x, y=y, ux=torch.cos(ang), uy=torch.sin(ang),
                           cx=cx, cy=cy, tt=tt, dsim=dsim, active=act > 0.5,
                           ang=ang, **stats)
    x, y, ux, uy, cx, cy, tt, dsim, act = comps[:9]
    window = {}
    if op == "op7":
        window = dict(zip(("wax", "way", "wbx", "wby"), comps[-4:]))
    return ResumeState(x=x, y=y, ux=ux, uy=uy, cx=cx, cy=cy, tt=tt, dsim=dsim,
                       active=act > 0.5, **stats, **window)


def resume_state_to_numpy(st: ResumeState, op: str) -> list:
    """The JAX segmented tier's component list of float32 (R,) arrays."""
    act = _to_numpy(st.active).astype(np.float32)
    if op in GOLDEN_OPS:
        comps = [st.x, st.y, st.cx, st.cy, st.ang, st.tt, st.dsim, act]
    else:
        comps = [st.x, st.y, st.ux, st.uy, st.cx, st.cy, st.tt, st.dsim, act]
    if st.mom_count is not None:
        comps += [st.mom_count, st.mom_mean, st.mom_m2]
    if op == "op7":
        comps += [st.wax, st.way, st.wbx, st.wby]
    return [c if isinstance(c, np.ndarray) else _to_numpy(c) for c in comps]


def dynamic_state_from_numpy(comps, *, device) -> DynState:
    """A dynamic kernel :class:`DynState` from the JAX dynamic tier's 18
    components (any shapes; each flattened to (R,) float32)."""
    if len(comps) != len(DynState._fields):
        raise ValueError(f"a dynamic state has {len(DynState._fields)} "
                         f"components, got {len(comps)}")
    vals = [torch.as_tensor(np.array(c, np.float32).reshape(-1),
                            device=device) for c in comps]
    st = DynState(*vals)
    return st._replace(active=st.active > 0.5)


def dynamic_state_to_numpy(st: DynState) -> list:
    """The JAX dynamic tier's 18-component list of float32 (R,) arrays."""
    return [_to_numpy(t).astype(np.float32) for t in st]


def df_state_from_numpy(comps, *, device) -> DfState:
    """A df32 :class:`DfState` from the JAX df tier's 8 components (any
    shapes; each flattened to (R,) float32)."""
    if len(comps) != len(DfState._fields):
        raise ValueError(f"a df state has {len(DfState._fields)} components, "
                         f"got {len(comps)}")
    return DfState(*(torch.as_tensor(np.array(c, np.float32).reshape(-1),
                                     device=device) for c in comps))


def fused3_state_from_numpy(comps, *, device) -> Fused3State:
    """A fused 3-D kernel :class:`Fused3State` from the JAX tiled3 tier's 12
    components (any shapes; each flattened to (R,) float32)."""
    if len(comps) != len(Fused3State._fields):
        raise ValueError(f"a 3-D state has {len(Fused3State._fields)} "
                         f"components, got {len(comps)}")
    st = Fused3State(*(torch.as_tensor(np.array(c, np.float32).reshape(-1),
                                       device=device) for c in comps))
    return st._replace(active=st.active > 0.5)


def fused3_state_to_numpy(st: Fused3State) -> list:
    """The JAX tiled3 tier's 12-component list of float32 (R,) arrays."""
    return [_to_numpy(t).astype(np.float32) for t in st]


def medium_from_numpy(kind: str, fields: dict, *, device):
    """The port's sampled medium of class name ``kind`` from a dict of its
    fields: arrays (numpy, e.g. ``np.asarray`` of a JAX medium's tables)
    become tensors on ``device`` in their own dtype, static fields are
    copied.  Fields with defaults (the Hermite and C1 grids' window bounds)
    may be missing."""
    if kind not in MEDIUM_CLASSES:
        raise ValueError(f"unknown medium class {kind!r}; have "
                         f"{sorted(MEDIUM_CLASSES)}")
    vals = {}
    for f in dataclasses.fields(MEDIUM_CLASSES[kind]):
        if f.name not in fields:
            if f.default is dataclasses.MISSING:
                raise ValueError(f"{kind} needs field {f.name!r}")
            continue
        v = fields[f.name]
        if isinstance(v, dict):   # a medium within the medium
            v = medium_from_numpy(_NESTED[f.name], v, device=device)
        elif isinstance(v, np.ndarray):
            # a writable copy: JAX's exported arrays are read-only
            v = torch.as_tensor(np.array(v), device=device)
        vals[f.name] = v
    return MEDIUM_CLASSES[kind](**vals)
