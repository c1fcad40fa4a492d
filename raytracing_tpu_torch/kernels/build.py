"""Build and load the CUDA kernels of ``raytracing_tpu_torch/csrc``.

The sources (``*.cu``, ``*.cuh``) are compiled at first use with ``nvcc``
into one shared library with a plain C interface, loaded with ``ctypes``:
one ``nvcc -c`` for each ``.cu`` file, all started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o _build/<name>-<hash>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/librt_kernels_<hash>.so _build/*-<hash>.o

The library lands in ``raytracing_tpu_torch/_build/`` under a name that
carries the SHA-256 of every source and of the flags, so an edited source
builds anew and an unchanged one loads the existing file.  A failed build raises with the
compiler's output; nothing falls back to another path.  ptxas's register
report goes to ``_build/ptxas-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: -fmad=false: no FMA contraction, so every kernel rounds each operation as
#: its plain PyTorch version does and the two agree to the last bits
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
#: a sampled medium's table and geometry: table, x0, y0, inv_hx, inv_hy,
#: nx, ny (csrc/media.cuh RT_TABLE_PARAMS)
_TABLE = (_P, _F, _F, _F, _F, _I, _I)
#: a split-word medium's geometry: the (hi, lo) words of x0, y0, 1/hx,
#: 1/hy, then nx, ny (csrc/df.cu RT_DF_GEOMETRY)
_DF_GEOMETRY = (_F,) * 8 + (_I, _I)
#: C entry points and their argument types (see csrc/*.cu)
_SIGNATURES = {
    # x, y, ux, uy, out_x, out_y, out_tt, n, steps, ds, stream
    "rt_fisheye_op1": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # field, op, stats, in_planes, out_planes, n, steps, ds, limit, offset,
    # limx_i, limx_s, limy_i, limy_s, curv_tol, counter (the refill loop's
    # int, on the card), stream
    "rt_fused_step": (_I, _I, _I, _P, _P, _I, _I, _F, _F, _F,
                      _F, _F, _F, _F, _F, _P, _P),
    # medium (0 analytic, 1 stratified), field or ch, op, stats, n, out:
    # blocks of the refill loop's grid (a host int)
    "rt_fused_refill_blocks": (_I, _I, _I, _I, _I, _P),
    # field, curv, newton, iso, stats, in_planes, out_planes, n, steps,
    # scal (device), iters, polish, limx_i, limx_s, limy_i, limy_s,
    # curv_tol, cos_c0, sin_c0, cos_d0, sin_d0, cos_m, sin_m, l_final,
    # counter (the refill loop's int, on the card), stream
    "rt_golden_step": (_I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _I, _I,
                       _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P,
                       _P),
    # medium (0 analytic, 1 stratified, 2 grid), field, ch or cell_ch, curv,
    # newton, iso, n, out: blocks of the golden refill loop's grid
    "rt_golden_refill_blocks": (_I, _I, _I, _I, _I, _I, _P),
    # rt_fused_step's arguments after field, without the counter (a
    # generated custom-medium library, kernels/custom.py: one op on one
    # medium)
    "rt_fused_step_custom": (_I, _I, _P, _P, _I, _I, _F, _F, _F,
                             _F, _F, _F, _F, _F, _P),
    # ch (6 | 4), then rt_fused_step's arguments after field up to
    # curv_tol, the table, counter, stream
    "rt_fused_step_strat": (_I, _I, _I, _P, _P, _I, _I, _F, _F, _F,
                            _F, _F, _F, _F, _F, *_TABLE, _P, _P),
    # cell_ch (36 | 16), the same without the counter
    "rt_fused_step_grid": (_I, _I, _I, _P, _P, _I, _I, _F, _F, _F,
                           _F, _F, _F, _F, _F, *_TABLE, _P),
    # node_ch (9), the same
    "rt_fused_step_nodes": (_I, _I, _I, _P, _P, _I, _I, _F, _F, _F,
                            _F, _F, _F, _F, _F, *_TABLE, _P),
    # cell_ch (36 | 16), rt_fused_step's arguments after field, ds_ray,
    # limit_ray (device), the table, stream
    "rt_fused_sweep_grid": (_I, _I, _I, _P, _P, _I, _I, _F, _F, _F,
                            _F, _F, _F, _F, _F, _P, _P, *_TABLE, _P),
    # rt_golden_step's arguments after field (a generated custom-medium
    # library: one variant on one medium)
    "rt_golden_step_custom": (_I, _I, _I, _I, _P, _P, _I, _I, _P, _I, _I,
                              _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                              _F, _P, _P),
    # ch, then rt_golden_step's arguments after field up to the counter,
    # the table, stream
    "rt_golden_step_strat": (_I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _I, _I,
                             _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                             _P, *_TABLE, _P),
    "rt_golden_step_grid": (_I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _I, _I,
                            _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                            _P, *_TABLE, _P),
    # field, op, in_planes, out_planes, n, steps, ds, limit, offset,
    # limx_i, limx_s, limy_i, limy_s, stream (csrc/dynamic.cu)
    "rt_dynamic_step": (_I, _I, _P, _P, _I, _I, _F, _F, _F,
                        _F, _F, _F, _F, _P),
    # ch (6 | 4), then rt_dynamic_step's arguments after field, the table,
    # counter (the refill loop's int, on the card), stream
    "rt_dynamic_step_strat": (_I, _I, _P, _P, _I, _I, _F, _F, _F,
                              _F, _F, _F, _F, *_TABLE, _P, _P),
    # ch (6 | 4), op, n, out: blocks of the dynamic refill loop's grid
    "rt_dynamic_refill_blocks": (_I, _I, _I, _P),
    # cell_ch (36 | 16), the same
    "rt_dynamic_step_grid": (_I, _I, _P, _P, _I, _I, _F, _F, _F,
                             _F, _F, _F, _F, *_TABLE, _P),
    # field, op, in_planes, out_planes, n, steps, ds, limit, offset, the
    # box's 6 faces, stream (csrc/fused3d.cu)
    "rt_fused3d_step": (_I, _I, _P, _P, _I, _I, _F, _F, _F, *(_F,) * 6, _P),
    # rt_fused3d_step's arguments after field, then the per-cell table, x0,
    # y0, z0, inv_hx, inv_hy, inv_hz, nx, ny, nz, stream
    "rt_fused3d_step_grid": (_I, _P, _P, _I, _I, _F, _F, _F, *(_F,) * 6,
                             _P, *(_F,) * 6, _I, _I, _I, _P),
    # field, op, in_planes, out_planes, n, steps, ds, limit, offset, the
    # box's 6 faces, stream (csrc/dynamic3d.cu, the 25 planes of Dyn3State)
    "rt_dynamic3d_step": (_I, _I, _P, _P, _I, _I, _F, _F, _F, *(_F,) * 6,
                          _P),
    # rt_dynamic3d_step's arguments after field, then the grid3 table and
    # geometry of rt_fused3d_step_grid, stream
    "rt_dynamic3d_step_grid": (_I, _P, _P, _I, _I, _F, _F, _F, *(_F,) * 6,
                               _P, *(_F,) * 6, _I, _I, _I, _P),
    # field, in_planes, out_planes, n, steps, ds, stream (csrc/df.cu)
    "rt_df_step": (_I, _P, _P, _I, _I, _F, _P),
    # in_planes, out_planes, n, steps, ds, nodes, cells, x0h, x0l, y0h, y0l,
    # ihxh, ihxl, ihyh, ihyl, nx, ny, stream
    "rt_df_step_grid": (_P, _P, _I, _I, _F, _P, _P, *_DF_GEOMETRY, _P),
    # the same without nodes
    "rt_df_step_c1": (_P, _P, _I, _I, _F, _P, *_DF_GEOMETRY, _P),
    # in_planes, out_planes, n, steps, ds, cells, y0h, y0l, ihyh, ihyl, ny,
    # stream
    "rt_df_step_profile": (_P, _P, _I, _I, _F, _P, _F, _F, _F, _F, _I, _P),
    # mode, denominator, first, count, seed, out (3 int64 on the card),
    # stream (csrc/divide.cu: the shared-reciprocal division's check)
    "rt_div_check": (_I, _F, _U64, _U64, _U64, _P, _P),
    # a, b, c, out (float32 on the card), n, stream (csrc/divide.cu: the
    # card's fmaf, against utils/fma.py::fma32)
    "rt_fma": (_P, _P, _P, _P, ctypes.c_longlong, _P),
}


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel: its name, source, and launch count.

    ``launches`` is a plain integer that the kernel's wrapper raises by one
    each time it launches the kernel on the card, and nowhere else.
    """

    name: str
    source: str          # path in the repository
    replaces: str        # file:line of the TPU kernel it ports
    launches: int = 0


def _sources(csrc=CSRC):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def source_digest(flags=NVCC_FLAGS, csrc=CSRC) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    cu, cuh = _sources(csrc)
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def build(flags=NVCC_FLAGS, csrc=CSRC) -> Path:
    """Compile the library of the sources in ``csrc`` with ``flags`` if this
    digest of the sources and flags has none yet; its path.  Every ``.cu``
    file compiles in its own ``nvcc`` process, all at once; a failed compile
    raises."""
    digest = source_digest(flags, csrc)
    lib = BUILD_DIR / f"librt_kernels_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    cu, _ = _sources(csrc)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in cu]
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *flags, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(cu, objs))]
    logs, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{out[-8000:]}")
    (BUILD_DIR / f"ptxas-{digest}.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *_LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-8000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent process never loads a torn file
    return lib


#: the entry points a generated custom-medium library has (kernels/custom.py)
CUSTOM_ENTRIES = ("rt_fused_step_custom", "rt_golden_step_custom")
#: the entry points of the library built from csrc/*.cu
MAIN_ENTRIES = tuple(n for n in _SIGNATURES if n not in CUSTOM_ENTRIES)


def load(path: Path, names=MAIN_ENTRIES) -> ctypes.CDLL:
    """A built library, loaded, with the signatures of its entry points
    ``names`` set."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        args = _SIGNATURES[name]
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The library every kernel wrapper launches from, built on first call."""
    return load(build())


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def pointer_array(tensors) -> ctypes.Array:
    """A host array of device pointers (NULL for ``None``)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
