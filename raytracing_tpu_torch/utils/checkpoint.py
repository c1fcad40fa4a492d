# Verbatim copy of raytracing_tpu/utils/checkpoint.py: that module is
# numpy-only, but importing it runs raytracing_tpu/__init__.py, which imports
# jax.
"""Checkpoint/resume for long DELTA_S sweeps.

The reference has no persistence at all: a failed search exits the process
and every result lives in memory (SURVEY.md 5.3-5.4).  Here chunked sweeps
write each finished chunk of per-candidate metrics to an .npz next to a
small JSON manifest; an interrupted search resumes at the first unfinished
chunk.  Plain numpy archives keep this dependency-free and
inspectable; the arrays are tiny (one scalar per candidate).
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _replace_atomic(path: str, write_fn) -> None:
    """Write via mkstemp + os.replace so a preemption mid-write can never
    leave a truncated file — the whole point of checkpointing."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    # suffix must keep the real extension or np.savez silently appends one
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp" + os.path.splitext(path)[1])
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _adopt_meta(path: str, meta_path: str, meta: dict | None,
                kind: str = "run") -> dict:
    """Validate-or-create the identity manifest, atomically, ONCE.

    The manifest never changes over a run's life, so it is written at
    construction (not re-serialized on every save — a kill mid-rewrite
    used to be able to corrupt the very file that guards identity).
    """
    out = dict(meta or {})
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            stored = json.load(f)
        if meta is not None and stored != out:
            raise ValueError(
                f"checkpoint {path} belongs to a different {kind}: "
                f"{stored} != {out}")
        return stored

    def _dump(tmp):
        with open(tmp, "w") as f:
            json.dump(out, f)

    _replace_atomic(meta_path, _dump)
    return out


class SweepCheckpoint:
    """Append-only store of per-chunk sweep metrics keyed by chunk index."""

    def __init__(self, path: str, *, meta: dict | None = None):
        self.path = path
        self._meta_path = path + ".json"
        self._chunks: dict[int, dict[str, np.ndarray]] = {}
        self.meta = _adopt_meta(path, self._meta_path, meta, "sweep")
        if os.path.exists(self.path):
            with np.load(self.path, allow_pickle=False) as z:
                for key in z.files:
                    idx_s, name = key.split("/", 1)
                    self._chunks.setdefault(int(idx_s), {})[name] = z[key]

    def has_chunk(self, idx: int) -> bool:
        return idx in self._chunks

    def chunk(self, idx: int) -> dict[str, np.ndarray]:
        return self._chunks[idx]

    def add_chunk(self, idx: int, metrics: dict[str, np.ndarray]) -> None:
        self._chunks[idx] = {k: np.asarray(v) for k, v in metrics.items()}
        self._flush()

    def _flush(self) -> None:
        flat = {f"{i}/{k}": v for i, m in self._chunks.items()
                for k, v in m.items()}
        _replace_atomic(self.path, lambda tmp: np.savez(tmp, **flat))

    def assembled(self, n_chunks: int) -> dict[str, np.ndarray] | None:
        """Concatenated metrics if every chunk is present, else None."""
        if any(i not in self._chunks for i in range(n_chunks)):
            return None
        keys = self._chunks[0].keys()
        return {k: np.concatenate([self._chunks[i][k] for i in range(n_chunks)])
                for k in keys}


class TraceCheckpoint:
    """Checkpoint/resume for long segmented TRACES (SURVEY.md 5.3-5.4).

    Stores the full resumable integration state (the exact segment-kernel
    carry: positions, Kahan compensations, tangent/angle, accumulators,
    masks) plus the applied step count AND the run's step horizon,
    atomically, so a multi-hour run survives preemption and resumes
    bit-identically.  The horizon travels with the progress (not the
    identity meta) because a resumed run may legally extend it — but only
    while no saved segment has been limit-clamped at the old horizon
    (engine/segmented.segmented_trace enforces this on resume).  Same
    .npz + JSON manifest conventions as :class:`SweepCheckpoint`.
    """

    def __init__(self, path: str, *, meta: dict | None = None):
        self.path = path
        self._meta_path = path + ".json"
        self.meta = _adopt_meta(path, self._meta_path, meta, "trace")

    def load(self):
        """(state_arrays, done_steps, horizon) from disk, or None."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            done = int(z["done_steps"])
            horizon = int(z["horizon"]) if "horizon" in z.files else done
            n = int(z["n_state"])
            state = [z[f"s{i}"] for i in range(n)]
        return state, done, horizon

    def save(self, state_arrays, done_steps: int, horizon: int) -> None:
        _replace_atomic(self.path, lambda tmp: np.savez(
            tmp, done_steps=np.int64(done_steps),
            horizon=np.int64(horizon),
            n_state=np.int64(len(state_arrays)),
            **{f"s{i}": np.asarray(a)
               for i, a in enumerate(state_arrays)}))
