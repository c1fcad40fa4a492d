"""Fused 3-D integrators op1/op2/op6/op8 on analytic and tri-Hermite media.

Port of ``raytracing_tpu/kernels/fused3d.py``: ``FUSED3_FIELDS`` and
``FUSED3_OPS`` (fused3d.py:40-41), the analytic ``_field3_fn`` (:45),
``_rot_coeffs`` (:68), ``_rodrigues3`` (:79), the step ``_step_body3``
(:93) of ``_make_kernel3`` (:191) and of the tiled grid3 kernel
``_make_tile_kernel3`` (:370), the grid3 evaluator ``_tile_nag3`` (:223)
with ``_tile_cell_locate3`` (:265) without its window, ``CELL3_CH``
(:220), ``Fused3Final`` (:431) and ``fused3d_trace_final`` (:443).

One step loop, ``csrc/fused3d.cuh``, is instantiated on two media in
``csrc/fused3d.cu``, as two kernels with their own launch counts:
``fused3d_step`` (the three analytic 3-D fields) and ``fused3d_step_grid``
(a ``C1Grid3Medium``'s per-cell table, :class:`Grid3Tables`: each
evaluation reads the ray's own 64-float cell row).  The state is the
12-plane resume layout of JAX's tiled3 tier (``engine/tiled3.py:375-377``),
:class:`Fused3State`; n and grad n are evaluated again at every launch's
start, as ``_make_tile_kernel3`` does (:417), so one state serves both
media and chained launches equal one.  :func:`fused3d_step_plain` is the
plain PyTorch version of both kernels and :func:`fused3d_step` the wrapper
that dispatches on the device of the state: a CPU state runs the plain
version, a CUDA state launches the kernel or raises.

The impulse update normalizes by ``1 / sqrt(s)`` (IEEE square root, then
one rounded division) where JAX writes ``lax.rsqrt`` (fused3d.py:162):
ATen's CUDA ``rsqrt`` is the approximate ``rsqrtf``, and its CPU one a
different function again, so the two-operation form is the one that both
the kernel and the plain version round alike on every device.  What the
TPU kernels carried only for Mosaic is gone: no zeros buffer, the active
mask is a bool, the scalars are arguments, the state is plain (R,)
vectors (no lanes, no padding to a block), and no window, sort or
containment flag.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from raytracing_tpu_torch.kernels import build
from raytracing_tpu_torch.kernels.fused import (
    FIELD_CODES, _kahan, div_exact, field_fn)
from raytracing_tpu_torch.media.grid3 import blend3

FUSED3_FIELDS = ("fisheye", "vert_heterogeneous", "interface")
FUSED3_OPS = ("op1", "op2", "op6", "op8")
#: floats a packed 3-D cell: 8 tri-Hermite channels x 8 corner nodes
#: (media/grid3.C1Grid3Medium's channels, corner index dx + 2*dy + 4*dz)
CELL3_CH = 64

KERNEL = build.KernelInfo(
    name="fused3d_step", source="raytracing_tpu_torch/csrc/fused3d.cu",
    replaces="raytracing_tpu/kernels/fused3d.py:191")
KERNEL_GRID = build.KernelInfo(
    name="fused3d_step_grid", source="raytracing_tpu_torch/csrc/fused3d.cu",
    replaces="raytracing_tpu/kernels/fused3d.py:370")
#: the family's kernels: analytic, grid3
KERNELS = (KERNEL, KERNEL_GRID)


class Grid3Tables(NamedTuple):
    """A ``C1Grid3Medium`` laid out for the kernel (``Grid3`` in
    csrc/fused3d.cuh): the per-cell rows of ``engine/tiled3.py::cells64``,
    one row of 64 float32 a cell, index ``ch * 8 + corner``; ``nx``, ``ny``,
    ``nz`` count nodes."""

    table: Any       # ((nz-1) * (ny-1) * (nx-1), 64) float32
    x0: float
    y0: float
    z0: float
    inv_hx: float
    inv_hy: float
    inv_hz: float
    nx: int
    ny: int
    nz: int


class Fused3State(NamedTuple):
    """Resumable state of the fused 3-D kernels, (R,) each: float32 except
    ``active`` (bool: never left the box).  The slot order of
    ``rt3::Slot3`` in csrc/fused3d.cu and of JAX's tiled3 state."""

    x: Any
    y: Any
    z: Any
    cx: Any
    cy: Any
    cz: Any
    ux: Any
    uy: Any
    uz: Any
    tt: Any
    dsim: Any
    active: Any


class Fused3Final(NamedTuple):
    """Final-state bundle of a fused 3-D kernel run (tensors length R)."""

    pos: Any          # (R, 3)
    tangent: Any      # (R, 3) unit tangent at exit
    traveltime: Any   # (R,)
    dist_sim: Any     # (R,)
    active: Any       # (R,) bool: never left the box


def field3_fn(field: str):
    """n and its 3-D gradient as the kernel evaluates them
    (fused3d.py:45-65): the fisheye in x, y, z; vert and interface are the
    2-D fields' expressions (``kernels/fused.py::field_fn``) with
    dn/dz = 0."""
    if field == "fisheye":
        def f(x, y, z):
            n = 1.0 / (1.0 + x * x + y * y + z * z)
            c = -2.0 * n * n
            return n, c * x, c * y, c * z
    elif field in FUSED3_FIELDS:
        f2 = field_fn(field)

        def f(x, y, z):
            n, gx, gy = f2(x, y)
            return n, gx, gy, torch.zeros_like(x)
    else:
        raise ValueError(f"fused 3-D kernel supports fields {FUSED3_FIELDS}, "
                         f"got {field!r}")
    return f


def tile_nag3_plain(t: Grid3Tables):
    """n/grad from the per-cell rows: the ray's cell located by JAX's
    clip/floor/min sequence (fused3d.py:284-293) in float32, its row read
    directly by an integer cell index (no window), blended by
    ``media.grid3.blend3`` (the w-collapse in ``_tile_cell_locate3``'s
    summation order, :322-328, then the 2-D C1 blend)."""
    def nag(x, y, z):
        fx = torch.clamp((x - t.x0) * t.inv_hx, 0.0, float(t.nx - 1))
        fy = torch.clamp((y - t.y0) * t.inv_hy, 0.0, float(t.ny - 1))
        fz = torch.clamp((z - t.z0) * t.inv_hz, 0.0, float(t.nz - 1))
        ix = torch.clamp(torch.floor(fx), max=float(t.nx - 2))
        iy = torch.clamp(torch.floor(fy), max=float(t.ny - 2))
        iz = torch.clamp(torch.floor(fz), max=float(t.nz - 2))
        cell = ((iz.long() * (t.ny - 1) + iy.long()) * (t.nx - 1)
                + ix.long())
        row = t.table[cell]
        return blend3(lambda ch, k: row[..., ch * 8 + k], fx - ix, fy - iy,
                      fz - iz, t.inv_hx, t.inv_hy, t.inv_hz)

    return nag


def nag3_fn(field):
    """The plain evaluator (x, y, z) -> (n, gx, gy, gz) of a step's
    medium: an analytic field name or a :class:`Grid3Tables`."""
    if isinstance(field, Grid3Tables):
        return tile_nag3_plain(field)
    return field3_fn(field)


def rot_coeffs(a2):
    """(cos a, sin a / a, (1 - cos a) / a^2) as polynomials in a^2
    (fused3d.py:68-76); each Python constant rounds to float32 as JAX
    folds it."""
    sinc = 1.0 - a2 * (1.0 / 6.0) * (1.0 - a2 * 0.05)
    vers = 0.5 * (1.0 - a2 * (1.0 / 12.0) * (1.0 - a2 * (1.0 / 30.0)))
    return 1.0 - a2 * vers, sinc, vers


def rodrigues3(ux, uy, uz, rx, ry, rz):
    """Rotate unit (ux, uy, uz) by the rotation vector (rx, ry, rz), in the
    polynomial form (fused3d.py:79-90)."""
    a2 = rx * rx + ry * ry + rz * rz
    cos, sinc, vers = rot_coeffs(a2)
    cx = ry * uz - rz * uy
    cy = rz * ux - rx * uz
    cz = rx * uy - ry * ux
    rdotu = rx * ux + ry * uy + rz * uz
    return (ux * cos + cx * sinc + rx * rdotu * vers,
            uy * cos + cy * sinc + ry * rdotu * vers,
            uz * cos + cz * sinc + rz * rdotu * vers)


def initial_state3(pos0, dir0, *, device) -> Fused3State:
    """Launch state (JAX's ``grid3_trace_tiled`` comps, tiled3.py:373-377):
    float32 positions, the direction normalized in float32, zero Kahan
    compensations and accumulators, every ray active."""
    pos0 = torch.as_tensor(np.asarray(pos0), dtype=torch.float32,
                           device=device)
    dir0 = torch.as_tensor(np.asarray(dir0), dtype=torch.float32,
                           device=device)
    if pos0.dim() != 2 or pos0.shape[1] != 3 or dir0.shape != pos0.shape:
        raise ValueError(f"pos0 and dir0 must be (R, 3), got "
                         f"{tuple(pos0.shape)} and {tuple(dir0.shape)}")
    dx, dy, dz = dir0[:, 0], dir0[:, 1], dir0[:, 2]
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    zeros = torch.zeros_like(dx)
    return Fused3State(
        x=pos0[:, 0].contiguous(), y=pos0[:, 1].contiguous(),
        z=pos0[:, 2].contiguous(), cx=zeros, cy=zeros.clone(),
        cz=zeros.clone(), ux=dx / norm, uy=dy / norm, uz=dz / norm,
        tt=zeros.clone(), dsim=zeros.clone(),
        active=torch.ones_like(dx, dtype=torch.bool))


def final_from_state3(st: Fused3State) -> Fused3Final:
    return Fused3Final(pos=torch.stack([st.x, st.y, st.z], dim=-1),
                       tangent=torch.stack([st.ux, st.uy, st.uz], dim=-1),
                       traveltime=st.tt, dist_sim=st.dsim, active=st.active)


def fused3d_step_plain(st: Fused3State, *, field, op: str, steps: int,
                       delta_s, step_limit, offset: float,
                       box) -> Fused3State:
    """Plain PyTorch version of ``fused3d_step`` and ``fused3d_step_grid``.

    ``_step_body3`` (fused3d.py:93-188) on every ray at once, one torch
    call an operation in its order, with a frozen ray's state kept by
    selects instead of leaving the loop.  ``offset`` is the global step
    count before this launch (the step limit reads it).
    """
    nag = nag3_fn(field)
    second = op in ("op6", "op8")
    rk2 = op in ("op2", "op6")
    ds32 = np.float32(delta_s)
    ds = float(ds32)
    dsds_half = float(ds32 * ds32 * np.float32(0.5))   # (ds * ds) * 0.5
    half = float(ds32 * np.float32(0.5))
    limx_i, limx_s, limy_i, limy_s, limz_i, limz_s = (float(v) for v in box)
    x, y, z, cx, cy, cz, ux, uy, uz, tt, dsim, active = st
    n, gx, gy, gz = nag(x, y, z)

    lim32 = float(np.float32(step_limit))   # the kernel's float limit

    for i in range(steps):
        in_limit = float(np.float32(i) + np.float32(offset)) < lim32
        if second or rk2:
            gdotu = gx * ux + gy * uy + gz * uz
        if second:
            half_fac = div_exact(dsds_half, n)
            ddx = ux * ds + (gx - gdotu * ux) * half_fac
            ddy = uy * ds + (gy - gdotu * uy) * half_fac
            ddz = uz * ds + (gz - gdotu * uz) * half_fac
        else:
            ddx, ddy, ddz = ux * ds, uy * ds, uz * ds
        nx2, cx2 = _kahan(x, cx, ddx)
        ny2, cy2 = _kahan(y, cy, ddy)
        nz2, cz2 = _kahan(z, cz, ddz)
        n2, gx2, gy2, gz2 = nag(nx2, ny2, nz2)

        if rk2:
            # rotation-vector Heun, polynomial rotations
            inv_n = 1.0 / n
            k1x = ds * (gx - gdotu * ux) * inv_n
            k1y = ds * (gy - gdotu * uy) * inv_n
            k1z = ds * (gz - gdotu * uz) * inv_n
            r1x = uy * k1z - uz * k1y
            r1y = uz * k1x - ux * k1z
            r1z = ux * k1y - uy * k1x
            umx, umy, umz = rodrigues3(ux, uy, uz, r1x, r1y, r1z)
            inv_n2 = 1.0 / n2
            gdotm = gx2 * umx + gy2 * umy + gz2 * umz
            k2x = ds * (gx2 - gdotm * umx) * inv_n2
            k2y = ds * (gy2 - gdotm * umy) * inv_n2
            k2z = ds * (gz2 - gdotm * umz) * inv_n2
            rx = (r1x + (umy * k2z - umz * k2y)) * 0.5
            ry = (r1y + (umz * k2x - umx * k2z)) * 0.5
            rz = (r1z + (umx * k2y - umy * k2x)) * 0.5
            nux, nuy, nuz = rodrigues3(ux, uy, uz, rx, ry, rz)
        else:
            # trapezoidal impulse on p = n u; 1 / sqrt, not rsqrt
            sx = n * ux + (gx + gx2) * half
            sy = n * uy + (gy + gy2) * half
            sz = n * uz + (gz + gz2) * half
            inv = 1.0 / torch.sqrt(sx * sx + sy * sy + sz * sz)
            nux, nuy, nuz = sx * inv, sy * inv, sz * inv

        if second:
            dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
            ntt = tt + dist * (n + n2) * 0.5
            ndsim = dsim + dist
        else:
            ntt = tt + ds * (n + n2) * 0.5
            ndsim = dsim + ds

        out = ((nx2 > limx_s) | (nx2 < limx_i) | (ny2 > limy_s)
               | (ny2 < limy_i) | (nz2 > limz_s) | (nz2 < limz_i))
        keep = active & in_limit

        def sel(new, old):
            return torch.where(keep, new, old)

        active = active & ~(keep & out)
        x, y, z = sel(nx2, x), sel(ny2, y), sel(nz2, z)
        cx, cy, cz = sel(cx2, cx), sel(cy2, cy), sel(cz2, cz)
        ux, uy, uz = sel(nux, ux), sel(nuy, uy), sel(nuz, uz)
        n, gx, gy, gz = sel(n2, n), sel(gx2, gx), sel(gy2, gy), sel(gz2, gz)
        tt, dsim = sel(ntt, tt), sel(ndsim, dsim)

    return Fused3State(x=x, y=y, z=z, cx=cx, cy=cy, cz=cz, ux=ux, uy=uy,
                       uz=uz, tt=tt, dsim=dsim, active=active)


def check_state3(st: Fused3State) -> None:
    """Device, dtype, shape and contiguity checks of a 3-D resume state."""
    dev = st.x.device
    r = st.x.shape[0]
    for name, t in st._asdict().items():
        want = torch.bool if name == "active" else torch.float32
        if not torch.is_tensor(t) or t.dtype != want or t.shape != (r,) \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"state.{name}: need a contiguous ({r},) {want} tensor on "
                f"{dev}")


def _check_medium3(field, device) -> None:
    if isinstance(field, str):
        if field not in FUSED3_FIELDS:
            raise ValueError(f"fused 3-D kernel supports fields "
                             f"{FUSED3_FIELDS}, got {field!r}")
        return
    if not isinstance(field, Grid3Tables):
        raise ValueError("a 3-D step's medium is a field name or "
                         f"Grid3Tables, got {type(field).__name__}")
    t = field.table
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous() or t.shape[-1] != CELL3_CH:
        raise ValueError(f"grid3 table: need contiguous (cells, 64) float32 "
                         f"on {device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}; move the medium with .to(device)")


def fused3d_step(st: Fused3State, *, field, op: str, steps: int, delta_s,
                 step_limit, offset=0.0, box) -> Fused3State:
    """Advance a 3-D resume state ``steps`` steps: the kernels' wrapper.

    ``field`` is an analytic field name (kernel ``fused3d_step``) or a
    :class:`Grid3Tables` (``fused3d_step_grid``); ``box`` the 6 faces
    (x0, x1, y0, y1, z0, z1).  ``offset`` is the number of steps applied
    before this launch, so k steps then n - k with offset k equal n steps.
    A CPU state runs :func:`fused3d_step_plain`; a CUDA state launches the
    kernel.
    """
    if op not in FUSED3_OPS:
        raise ValueError(f"fused 3-D kernel supports ops {FUSED3_OPS}, "
                         f"got {op!r}")
    box = tuple(float(v) for v in box)
    if len(box) != 6:
        raise ValueError(f"box must be 6 floats, got {box!r}")
    check_state3(st)
    _check_medium3(field, st.x.device)
    if st.x.device.type == "cpu":
        return fused3d_step_plain(st, field=field, op=op, steps=int(steps),
                                  delta_s=delta_s,
                                  step_limit=float(step_limit),
                                  offset=float(offset), box=box)
    if st.x.device.type != "cuda":
        raise ValueError(f"fused3d_step runs on cpu or cuda, not {st.x.device}")
    out = Fused3State(*(torch.empty_like(t) for t in st))
    lib = build.library()
    args = (int(op[2:]), build.pointer_array(st), build.pointer_array(out),
            st.x.shape[0], int(steps), float(np.float32(delta_s)),
            float(step_limit), float(offset), *box)
    with torch.cuda.device(st.x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if isinstance(field, Grid3Tables):
            kernel, name = KERNEL_GRID, "rt_fused3d_step_grid"
            err = lib.rt_fused3d_step_grid(
                *args, field.table.data_ptr(), field.x0, field.y0, field.z0,
                field.inv_hx, field.inv_hy, field.inv_hz, field.nx, field.ny,
                field.nz, stream)
        else:
            kernel, name = KERNEL, "rt_fused3d_step"
            err = lib.rt_fused3d_step(FIELD_CODES[field], *args, stream)
    build.check(err, name)
    kernel.launches += 1
    return out


def fused3d_trace_final(pos0, dir0, delta_s, *, field: str, op: str,
                        steps: int, box, step_limit=None,
                        device="cuda") -> Fused3Final:
    """Run ``steps`` fused 3-D steps on an analytic field; return a
    :class:`Fused3Final` (fused3d.py:443).  ``dir0`` (R, 3) is normalized
    here; ``step_limit`` (default ``steps``) freezes every ray after that
    many steps.  JAX's ``block_rays`` and ``interpret`` are gone: a thread
    is one ray."""
    if field not in FUSED3_FIELDS:
        raise ValueError(f"fused 3-D kernel supports fields {FUSED3_FIELDS}, "
                         f"got {field!r}")
    st = initial_state3(pos0, dir0, device=device)
    st = fused3d_step(st, field=field, op=op, steps=steps, delta_s=delta_s,
                      step_limit=steps if step_limit is None else step_limit,
                      offset=0.0, box=box)
    return final_from_state3(st)
