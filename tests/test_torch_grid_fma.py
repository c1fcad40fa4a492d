"""The 2-D grid blend's FMA form (kernels/fused.py::hermite_blend, the
plain version of csrc/media.cuh's) against JAX's separately rounded
``_hermite_blend`` (raytracing_tpu/kernels/fused.py:108), which the port no
longer follows operation for operation (ROADMAP.md section 3): on random
cells, each of n, gx, gy within a few float32 ulps of the size of the
corner values it blends; on tests/test_torch_grid.py's fisheye fan
(parity grid, 128 rays, 59 steps), grid_trace_tiled no farther from JAX's
than the same trace with the blend rounded as JAX rounds it (every
product and sum on its own).
Measured: positions 6.3e-7 (op1), 2.2e-6 (op6), 3.4e-5 (op7), 2.8e-6
(op5), 4.7e-6 (op11) from JAX, against 7.2e-7, 3.3e-6, 3.8e-5, 3.0e-6
and 4.8e-6 with the separately rounded blend."""
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.engine.segmented import (  # noqa: E402
    grid_trace_tiled as jgrid)
from raytracing_tpu.kernels import fused as jfused  # noqa: E402
from raytracing_tpu.media import hermite as jherm  # noqa: E402
from raytracing_tpu.media import spline as jspline  # noqa: E402

from raytracing_tpu_torch.engine import segmented as tseg  # noqa: E402
from raytracing_tpu_torch.kernels import fused as tfused  # noqa: E402

#: float32's unit roundoff
U32 = 2.0 ** -24


def separately_rounded_blend(corners, u, v):
    """JAX's _hermite_blend in torch: every product and sum rounded on its
    own, in its order (the port's blend before the FMA form)."""
    z00, z01, z10, z11 = corners(0)
    n = ((1.0 - v) * ((1.0 - u) * z00 + u * z01)
         + v * ((1.0 - u) * z10 + u * z11))
    v2, u2 = v * v, u * u
    v3, u3 = v2 * v, u2 * u
    hv0, gv0 = 2.0 * v3 - 3.0 * v2 + 1.0, v3 - 2.0 * v2 + v
    hv1, gv1 = -2.0 * v3 + 3.0 * v2, v3 - v2
    hu0, gu0 = 2.0 * u3 - 3.0 * u2 + 1.0, u3 - 2.0 * u2 + u
    hu1, gu1 = -2.0 * u3 + 3.0 * u2, u3 - u2

    def hermite(ch0):
        f00, f01, f10, f11 = corners(ch0)
        fv00, fv01, fv10, fv11 = corners(ch0 + 1)
        fu00, fu01, fu10, fu11 = corners(ch0 + 2)
        fw00, fw01, fw10, fw11 = corners(ch0 + 3)
        return ((f00 * hv0 + fv00 * gv0 + f10 * hv1 + fv10 * gv1) * hu0
                + (f01 * hv0 + fv01 * gv0 + f11 * hv1 + fv11 * gv1) * hu1
                + (fu00 * hv0 + fw00 * gv0 + fu10 * hv1 + fw10 * gv1) * gu0
                + (fu01 * hv0 + fw01 * gv0 + fu11 * hv1 + fw11 * gv1) * gu1)

    return n, hermite(1), hermite(5)


def test_fma_blend_within_ulps_of_jax_blend():
    """65,536 seeded cells of standard normal corners: |port - JAX| <= 8 u
    s for n, gx and gy, u = 2^-24 and s the sum of the magnitudes of the
    corner values the output blends (channel 0's four for n, channels
    1-4's or 5-8's sixteen for gx, gy; every basis weight is at most 1).
    Measured: 2.43, 1.42 and 1.19 u s at most."""
    rng = np.random.default_rng(12)
    n = 1 << 16
    rows = rng.standard_normal((n, 9, 4)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    v = rng.uniform(0.0, 1.0, n).astype(np.float32)
    t = torch.as_tensor(rows)
    port = tfused.hermite_blend(lambda ch: tuple(t[:, ch, c]
                                                 for c in range(4)),
                                torch.as_tensor(u), torch.as_tensor(v))
    jr = jnp.asarray(rows)
    jax_ = jfused._hermite_blend(lambda ch: tuple(jr[:, ch, c]
                                                  for c in range(4)),
                                 jnp.asarray(u), jnp.asarray(v))
    a = np.abs(rows).astype(np.float64)
    for k, chs in ((0, slice(0, 1)), (1, slice(1, 5)), (2, slice(5, 9))):
        d = np.abs(port[k].double().numpy() - np.asarray(jax_[k], np.float64))
        assert (d <= 8 * U32 * a[:, chs, :].sum((1, 2))).all(), k


@pytest.fixture(scope="module")
def parity_grid():
    box = rt.scenario("fisheye").box
    gm = jspline.build_grid_medium("fisheye", box, 0.05, dtype=np.float32,
                                   backend="scipy")
    jm = jherm.build_hermite_medium(gm, dtype=np.float32)
    return jm, H.port_medium(jm)


@pytest.mark.parametrize("op", ["op1", "op6", "op7", "op5", "op11"])
def test_fma_blend_traces_no_farther_from_jax(op, parity_grid, monkeypatch):
    """tests/test_torch_grid.py's fan and depth: the FMA blend's final
    positions lie no farther from JAX's than 1.25 times the separately
    rounded blend's (module docstring: the measured distances)."""
    jm, tm = parity_grid
    box = tuple(rt.scenario("fisheye").box)
    r = 128
    rng = np.random.default_rng(0)
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (r, 1))
    theta0 = (np.pi / 2 + rng.uniform(-0.02, 0.02, r)).astype(np.float32)
    ds = np.float32(2 * np.pi / 60)
    kw = dict(steps=59, box=box)
    j = np.asarray(jgrid(op, pos0, theta0, ds, jm, block_rays=r,
                         interpret=True, **kw).pos)
    fma = H.to_np(tseg.grid_trace_tiled(op, pos0, theta0, ds, tm,
                                        device="cpu", **kw).pos)
    monkeypatch.setattr(tfused, "hermite_blend", separately_rounded_blend)
    sep = H.to_np(tseg.grid_trace_tiled(op, pos0, theta0, ds, tm,
                                        device="cpu", **kw).pos)
    d_fma, d_sep = np.abs(fma - j).max(), np.abs(sep - j).max()
    assert d_fma <= 1.25 * d_sep, (d_fma, d_sep)
