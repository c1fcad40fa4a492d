"""Native (C++) spline library: the sampled media's spline fits without scipy.

Port of ``raytracing_tpu/native/__init__.py:1-118`` over the port's own
copy of ``spline_builder.cpp``: the derivative grids (np.gradient,
edge_order=2) and the not-a-knot bicubic coefficient tables of the media
pipeline (RT_bench.py:450-462), compiled on first use with g++ (``-O3
-march=native -shared -fPIC``, the JAX package's command, so on one host
both libraries compute the same bits) and bound with ctypes.

The library lands in ``raytracing_tpu_torch/_build/native/`` (a 0700
directory of the checkout) under a name that carries a SHA-256 of the
source and the flags.  Concurrent first calls each compile to a
pid-suffixed file and rename it into place.  Before loading, the directory
and the library must belong to this user and be writable by no one else.

scipy stays the test-time oracle (tests/test_torch_native.py) and the
``backend="scipy"`` path of ``media/spline.py`` and ``media/c1.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import stat
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "spline_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LIB_CACHE: list = []
_LOCK = threading.Lock()


def _check_owned(path: Path, what: str) -> None:
    """Refuse ``path`` unless this user owns it and no one else can write
    it: a library planted there by another user must never be loaded."""
    st = os.stat(path)
    if st.st_uid != os.getuid() or (st.st_mode & (stat.S_IWGRP | stat.S_IWOTH)):
        raise RuntimeError(
            f"refusing native {what} {path}: not owned by uid {os.getuid()} "
            f"or group/world writable (mode {oct(st.st_mode)})")


def _build_dir() -> Path:
    BUILD_DIR.mkdir(mode=0o700, parents=True, exist_ok=True)
    _check_owned(BUILD_DIR, "build dir")
    return BUILD_DIR


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return _build_dir() / f"spline_builder_{digest}.so"


def _build_library() -> Path:
    """Compile spline_builder.cpp to a shared object, unless it is there."""
    so = library_path()
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    _check_owned(so, "library")
    return so


def _lib():
    with _LOCK:
        if not _LIB_CACHE:
            lib = ctypes.CDLL(str(_build_library()))
            lib.rt_bicubic_cells.restype = ctypes.c_int
            lib.rt_bicubic_cells.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
            lib.rt_gradient2.restype = ctypes.c_int
            lib.rt_gradient2.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double)]
            _LIB_CACHE.append(lib)
    return _LIB_CACHE[0]


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def bicubic_cells(grid: np.ndarray) -> np.ndarray:
    """Per-cell not-a-knot bicubic coefficients of a uniform (ny, nx) grid.

    Returns (ny-1, nx-1, 4, 4) float64 with S = sum C[a,b] uy^a ux^b over
    normalized cell offsets: the layout ``media/spline.py`` builds through
    scipy, and the same spline (FITPACK's s=0 knot vector is not-a-knot).
    """
    grid = np.ascontiguousarray(grid, dtype=np.float64)
    ny, nx = grid.shape
    out = np.empty((ny - 1, nx - 1, 4, 4), dtype=np.float64)
    rc = _lib().rt_bicubic_cells(_dptr(grid), ny, nx, _dptr(out))
    if rc != 0:
        raise ValueError(f"rt_bicubic_cells failed (grid {ny}x{nx})")
    return out


def gradient2(grid: np.ndarray, h: float):
    """(d/dx, d/dy) grids, np.gradient(edge_order=2) semantics
    (RT_bench.py:450)."""
    grid = np.ascontiguousarray(grid, dtype=np.float64)
    ny, nx = grid.shape
    ddx = np.empty_like(grid)
    ddy = np.empty_like(grid)
    rc = _lib().rt_gradient2(_dptr(grid), ny, nx, float(h), _dptr(ddx),
                             _dptr(ddy))
    if rc != 0:
        raise ValueError(f"rt_gradient2 failed (grid {ny}x{nx})")
    return ddx, ddy


def available() -> bool:
    """True when the native library can be built or loaded on this host."""
    try:
        _lib()
        return True
    except Exception:
        return False
