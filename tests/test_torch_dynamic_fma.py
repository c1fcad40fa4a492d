"""The FMA forms of the 2-D dynamic step on the analytic fields and the 2-D
grids (kernels/dynamic.py::dynamic_step_plain on a field name or
GridTables, the plain version of csrc/dynamic.cuh's ``DynFma`` step,
media.cuh's ``Analytic::field_h`` and the grids' blends
``hermite_blend_h``, ``c1_blend_h``) and of the analytic 3-D
step (kernels/fused3d.py::fused3d_step_plain, csrc/fused3d.cuh ``Fma3``),
which no longer follow JAX's kernels operation for operation (ROADMAP.md
section 3), against JAX's Pallas kernels in interpret mode, on the fans of
tests/test_torch_dynamic_kernel.py (128 rays, 300, 250 or, on the grids,
120 steps) and tests/test_torch_fused3d.py (256 rays, 300 steps): the FMA
form, and the same step rounded as JAX rounds it (every product and sum on
its own), each held to those tests' bars.

Measured, FMA form against the JAX-order form, largest over the four ops
of each field:
* 2-D (pos, traveltime, q and dtheta of their largest): fisheye 1.9e-6,
  9.5e-7, 6.6e-5, 3.6e-6 against 7.4e-6, 2.4e-6, 6.9e-5, 5.6e-6; vert
  9.5e-7, 1.5e-8, 3.1e-6, 6.3e-6 against 5.5e-6, 2.8e-7, 5.4e-6, 6.6e-6;
  interface 4.8e-7, 4.8e-7, 1.9e-5, 1.0e-5 against 4.8e-7, 4.8e-7,
  1.9e-5, 2.5e-6; KMAH and `active` equal to JAX's on every ray.
* 2-D grids (the same four): parity 1.1e-6, 4.8e-7, 6.4e-6, 3.9e-6
  against 1.4e-6, 7.2e-7, 5.9e-6, 4.2e-6; C1 1.4e-6, 4.8e-7, 3.7e-5,
  3.4e-5 against 1.7e-6, 7.2e-7, 4.7e-5, 4.1e-5; KMAH equal.
* 3-D (pos, tangent, traveltime): fisheye 2.1e-6, 2.6e-6, 1.4e-6 against
  2.4e-6, 2.5e-6, 1.7e-6; vert 2.5e-6, 1.1e-6, 4.5e-8 against 2.2e-6,
  1.4e-6, 4.5e-8; interface 3.6e-6, 4.8e-7, 1.9e-6 against 3.2e-6,
  4.2e-7, 1.9e-6; `active` equal.
"""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_dynamic_kernel import (  # noqa: E402
    F32, R as R2, assert_close, fisheye_grids, launch)
from test_torch_fused3d import BOX, R as R3, _close, _fan  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine import segmented as jseg  # noqa: E402
from raytracing_tpu.kernels import dynamic as jkd  # noqa: E402
from raytracing_tpu.kernels import fused3d as jfused3d  # noqa: E402

from raytracing_tpu_torch.engine import segmented as tseg  # noqa: E402
from raytracing_tpu_torch.kernels import dynamic as tkd  # noqa: E402
from raytracing_tpu_torch.kernels import fused3d as tf3  # noqa: E402
from raytracing_tpu_torch.utils import fma  # noqa: E402

#: float32's unit roundoff
U32 = 2.0 ** -24


@pytest.mark.parametrize("op", tkd.DYN_FUSED_OPS)
@pytest.mark.parametrize("field", tkd.DYN_FUSED_FIELDS)
def test_dynamic_forms_within_jax_bars(field, op, monkeypatch):
    """Both forms of the 2-D analytic dynamic step within
    test_analytic_plain_matches_pallas's bars of JAX's kernel: position
    1e-5, traveltime 5e-6, q and dtheta 1e-4 of their largest, KMAH and
    `active` equal."""
    pos0, theta0, ds, steps, box = launch(field)
    j = jkd.dynamic_trace_final(jnp.asarray(pos0), jnp.asarray(theta0), ds,
                                field=field, op=op, steps=steps, box=box,
                                block_rays=R2, interpret=True)

    def port():
        return tkd.dynamic_trace_final(pos0, theta0, float(ds), field=field,
                                       op=op, steps=steps, box=box,
                                       device="cpu")
    fused = port()
    assert_close(fused, j)
    H.jax_order_forms(monkeypatch)
    apart = port()
    assert_close(apart, j)
    assert not torch.equal(fused.pos, apart.pos)


@pytest.mark.parametrize("op", tkd.DYN_FUSED_OPS)
@pytest.mark.parametrize("family", ["parity", "c1"])
def test_grid_forms_within_jax_bars(family, op, fisheye_grids, monkeypatch):
    """Both forms of the 2-D grid dynamic step (the step and the grid's
    blends: kernels/dynamic.py::tile_nag_h) within
    test_grid_plain_matches_pallas's bars of JAX's grid_trace_dynamic_tiled
    in interpret mode, on its fan: position 1e-5, traveltime 5e-6, q and
    dtheta 1e-4 of their largest, KMAH and `active` equal."""
    jm = fisheye_grids[family]
    rng = np.random.default_rng(0)
    pos0 = np.tile(np.array([[1.0, 0.0]], F32), (R2, 1))
    theta0 = (np.pi / 2 + rng.uniform(-0.05, 0.05, R2)).astype(F32)
    ds, steps = F32(2 * np.pi / 300), 120
    box = tuple(rt.scenario("fisheye").box)
    j = jseg.grid_trace_dynamic_tiled(op, pos0, theta0, ds, jm, steps=steps,
                                      box=box, block_rays=R2, interpret=True)

    def port():
        return tseg.grid_trace_dynamic_tiled(op, pos0, theta0, float(ds),
                                             H.port_medium(jm), steps=steps,
                                             box=box, device="cpu")
    fused = port()
    assert_close(fused, j)
    H.jax_order_forms(monkeypatch)
    apart = port()
    assert_close(apart, j)
    assert not torch.equal(fused.pos, apart.pos)


def _jax_tile_channels32(jm, xs, ys):
    """JAX's _tile_nag_h / _tile_nag_c1_h at float32, with a window over
    the whole grid (base 0, every cell)."""
    ch = int(jm.nodes.shape[-1])
    c36 = np.asarray(jseg._cells36(jnp.asarray(jm.nodes).reshape(
        jm.ny, jm.nx, ch)))
    nch = -(-c36.shape[0] // 128)
    c36 = np.concatenate([c36, np.zeros((nch * 128 - c36.shape[0], 4 * ch),
                                        c36.dtype)]).reshape(nch, 128, 4 * ch)
    T = [jnp.asarray(c36[k, :, j][None]) for k in range(nch)
         for j in range(4 * ch)]
    meta = (float(jm.x0), float(jm.y0), float(jm.inv_hx), float(jm.inv_hy),
            int(jm.nx), int(jm.ny), int(jm.ny) - 1, int(jm.nx) - 1)
    nag = (jkd._tile_nag_h if ch == 9 else jkd._tile_nag_c1_h)(
        T, 0.0, 0.0, meta)
    return [np.asarray(c)[0] for c in nag(jnp.asarray(xs[None]),
                                          jnp.asarray(ys[None]))]


def _blend_scales(g, x, y):
    """For each of the 9 channels at (x, y), an upper bound of the sum of
    the magnitudes of the products it sums: the magnitudes of the corner
    values it blends (channel 0's four for the parity n and its gradient,
    channels 1-4's or 5-8's sixteen for the parity gradients and their
    Jacobian, the C1 patch's sixteen for all), times the largest basis
    weights (1 for a value, 1.5 for a first derivative, 6 for a second) and
    the cell scales of its derivatives."""
    ix, iy, _, _ = tseg._cells(x, y, g)
    row = g.table[iy.long() * (g.nx - 1) + ix.long()].double().abs()
    hx, hy = g.inv_hx, g.inv_hy
    if g.cell_ch == 16:
        s = row.sum(-1)
        return (s, 1.5 * hx * s, 1.5 * hy * s, 1.5 * hx * s, 1.5 * hy * s,
                6 * hx * hx * s, 2.25 * hx * hy * s, 2.25 * hx * hy * s,
                6 * hy * hy * s)
    z, gx, gy = row[:, :4].sum(-1), row[:, 4:20].sum(-1), row[:, 20:].sum(-1)
    return (z, gx, gy, hx * z, hy * z, 1.5 * hx * gx, 1.5 * hy * gx,
            1.5 * hx * gy, 1.5 * hy * gy)


@pytest.mark.parametrize("family", ["parity", "c1"])
def test_fma_grid_channels_within_ulps_of_jax(family, fisheye_grids):
    """The FMA form of tile_nag_h at float32 (the dynamic grid kernel's
    blends) against JAX's _tile_nag_h / _tile_nag_c1_h at float32 on 8,192
    seeded points over the fisheye grid (delta 0.05): each channel within 4
    u s of JAX's, u = 2^-24 and s :func:`_blend_scales`' bound of the sum
    of the magnitudes it blends; the JAX-order form (the default) equal to
    JAX's to the bit.  Measured: at most 1.05 u s (parity) and 1.09 u s
    (C1); relative to each channel's largest magnitude, up to 6e-6 on the
    parity's Jacobian and 2e-4 on the C1 Hessian, whose cell sums cancel
    to about a thousandth of their terms."""
    jm = fisheye_grids[family]
    box = rt.scenario("fisheye").box
    rng = np.random.default_rng(4)
    xs = rng.uniform(box[0], box[1], 8192).astype(np.float32)
    ys = rng.uniform(box[2], box[3], 8192).astype(np.float32)
    want = _jax_tile_channels32(jm, xs, ys)
    g = tseg.grid_tables(H.port_medium(jm))
    x, y = torch.as_tensor(xs), torch.as_tensor(ys)
    scales = _blend_scales(g, x, y)
    for got, w in zip(tkd.tile_nag_h(g)(x, y), want):
        np.testing.assert_array_equal(H.to_np(got), w)
    worst = 0.0
    for got, w, s in zip(tkd.tile_nag_h(g, fma.mads(True))(x, y), want,
                         scales):
        off = np.abs(H.to_np(got).astype(np.float64) - w) / (U32 * H.to_np(s))
        worst = max(worst, float(off.max()))
    assert worst <= 4.0, worst
    print(f"{family}: at most {worst:.3f} u s")


@pytest.mark.parametrize("op", tf3.FUSED3_OPS)
@pytest.mark.parametrize("field", tf3.FUSED3_FIELDS)
def test_fused3d_forms_within_jax_bars(field, op, monkeypatch):
    """Both forms of the analytic 3-D step within
    test_plain_matches_pallas_interpret's bars of JAX's kernel: position
    and tangent 5e-6, traveltime and dist_sim 5e-5, `active` equal."""
    pos0, dir0 = _fan(field)
    ds = np.float32(2 * np.pi / 300 if field == "fisheye" else 0.01)
    j = jfused3d.fused3d_trace_final(pos0, dir0, ds, field=field, op=op,
                                     steps=300, box=BOX, block_rays=R3,
                                     interpret=True)

    def port():
        return tf3.fused3d_trace_final(pos0, dir0, ds, field=field, op=op,
                                       steps=300, box=BOX, device="cpu")
    fused = port()
    _close(fused, j)
    H.jax_order_forms(monkeypatch)
    apart = port()
    _close(apart, j)
    assert not torch.equal(fused.pos, apart.pos)


@pytest.mark.parametrize("field", tkd.DYN_FUSED_FIELDS)
def test_trace_final_n_is_the_steps_own(field, monkeypatch):
    """dynamic_trace_final's n is, to the bit, channel 0 of the channels
    that dynamic_step_plain evaluated at the final positions in its last
    step (the kernel's carried n: the FMA form), not the JAX-order
    field's, which differs from it on the fisheye's rays."""
    seen = []
    nag_h_fn = tkd.nag_h_fn

    def recording(field):
        f = nag_h_fn(field)

        def g(x, y):
            ch = f(x, y)
            seen.append(ch[0])
            return ch
        return g
    monkeypatch.setattr(tkd, "nag_h_fn", recording)
    pos0, theta0, ds, steps, _ = launch(field)
    out = tkd.dynamic_trace_final(pos0, theta0, float(ds), field=field,
                                  op="op6", steps=40, device="cpu",
                                  box=(-3e38, 3e38) * 2)
    assert bool(out.active.all()) and len(seen) == 40 + 2
    assert torch.equal(out.n, seen[-2])
    if field == "fisheye":
        jax_n = tkd.field_fn_h(field)(out.pos[:, 0], out.pos[:, 1])[0]
        assert not torch.equal(out.n, jax_n)


def test_mads_rounds_each_term_once():
    """utils/fma.py::mads: the fused form stacks a tuple's terms into one
    fma32 call, each term's bits those of its own fma32 (Python numbers
    taken as float32); the unfused form rounds the product and the sum
    apart, as ``a * b + c``."""
    rng = np.random.default_rng(5)
    a, b, c = (torch.as_tensor(rng.standard_normal((3, 4096)),
                               dtype=torch.float32) for _ in range(3))
    fused = fma.mads(True)((a[0], a[1], 0.1), (b[0], 3.0, b[2]),
                           (c[0], c[1], 1.0))
    want = (fma.fma32(a[0], b[0], c[0]), fma.fma32(a[1], 3.0, c[1]),
            fma.fma32(0.1, b[2], 1.0))
    for got, w in zip(fused, want):
        assert torch.equal(got, w)
    apart = fma.mads(False)((a[0],), (b[0],), (c[0],))
    assert torch.equal(apart[0], a[0] * b[0] + c[0])
    assert not torch.equal(fused[0], apart[0])


@pytest.mark.parametrize("dim,field,where,op", [
    (2, "fisheye", "fan", "op6"), (3, "fisheye", "fan", "op6")]
    + H.BEYOND_GUARD_CASES)
def test_plain_versions_count_guard_failures(dim, field, where, op):
    """The plain versions' ``guards``: every step adds the rays it moves,
    and among them those at which a fast path of the analytic kernels
    fails its guard.  The JAX tests' fans never leave the fast paths; on
    the launches of torch_port_helpers.beyond_guards every ray-step does
    (tests/test_torch_cuda.py::test_kernels_beyond_their_guards_equal_plain
    holds the kernels to the plain versions there), and every plane stays
    finite."""
    steps = 10
    if where == "fan":
        pos0, aim, ds, _, box = (launch(field) if dim == 2
                                 else (*_fan(field), 0.02, None, BOX))
    else:
        pos0, aim, ds, box = H.beyond_guards(dim, field, where, 64)
    r = len(pos0)
    g = torch.zeros(2, dtype=torch.float64)
    kw = dict(field=field, op=op, steps=steps, delta_s=float(ds),
              step_limit=steps, offset=0.0, box=box, guards=g)
    if dim == 2:
        out = tkd.dynamic_step_plain(
            tkd.initial_dyn_state(pos0, aim, device="cpu"), **kw)
    else:
        out = tf3.fused3d_step_plain(
            tf3.initial_state3(pos0, aim, device="cpu"), **kw)
    moved = float(r * steps)
    assert g.tolist() == [0.0 if where == "fan" else moved, moved]
    assert bool(out.active.all())
    for name, v in zip(type(out)._fields, out):
        if v is not None and v.is_floating_point():
            assert bool(torch.isfinite(v).all()), name
