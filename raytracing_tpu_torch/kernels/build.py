"""Build and load the CUDA kernels of ``raytracing_tpu_torch/csrc``.

The sources (``*.cu``, ``*.cuh``) are compiled at first use with ``nvcc``
into one shared library with a plain C interface, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -Xptxas -v \
         -o _build/librt_kernels_<hash>.so csrc/*.cu

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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry points and their argument types (see csrc/*.cu)
_SIGNATURES = {
    # x, y, ux, uy, out_x, out_y, out_tt, n, steps, ds, stream
    "rt_fisheye_op1": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # field, op, stats, in_planes, out_planes, n, steps, ds, limit, offset,
    # limx_i, limx_s, limy_i, limy_s, curv_tol, stream
    "rt_fused_step": (_I, _I, _I, _P, _P, _I, _I, _F, _F, _F,
                      _F, _F, _F, _F, _F, _P),
    # field, curv, newton, iso, stats, in_planes, out_planes, n, steps,
    # scal (device), iters, polish, limx_i, limx_s, limy_i, limy_s,
    # curv_tol, cos_c0, sin_c0, cos_d0, sin_d0, cos_m, sin_m, l_final, stream
    "rt_golden_step": (_I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _I, _I,
                       _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P),
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


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_digest(flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    cu, cuh = _sources()
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


def build(flags=NVCC_FLAGS) -> Path:
    """Compile the library with ``flags`` if this digest of the sources and
    flags has none yet; its path."""
    digest = source_digest(flags)
    lib = BUILD_DIR / f"librt_kernels_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    cu, _ = _sources()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"ptxas-{digest}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stderr[-8000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent process never loads a torn file
    return lib


def load(path: Path) -> ctypes.CDLL:
    """A built library, loaded, with its entry points' signatures set."""
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
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
