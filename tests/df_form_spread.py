"""How far the df32 tier's two roundings part, on the CPU.

Prints, for a fan of rays on an analytic field, the largest and RMS
per-ray |dpos| between three evaluations of the same df32 RK4 steps:

- the port's FMA form (``df_step_plain``, the kernel's form on the card);
- JAX's roundings (``df_step_plain(..., jax_roundings=True)``, JAX's eager
  body to the bit, ``test_rk4_body_equals_jax_op_for_op``);
- JAX's jitted body (``raytracing_tpu.kernels.df.df_trace`` in Pallas
  interpret mode, which XLA:CPU compiles with its own rewrites).

Then the FMA form's part split in two: the angle rate's fused terms alone
(``df_k_fisheye`` / ``df_k_vert`` with ``fused``, ``df_recip``'s residual
among them) and the step's alone (rx, ry, the angle's pe and low word).

    python tests/df_form_spread.py --field fisheye --rays 128 --divisor 300 \\
        --jitter 0.3
    python tests/df_form_spread.py --rays 512 --divisor 4587 --jitter 1e-3
    python tests/df_form_spread.py --field vert_heterogeneous --rays 512

The fisheye fan starts at (1, 0) at pi/2 with uniform jitter (numpy seed
0) and runs ``divisor`` steps of 2 pi / divisor (``--steps`` overrides);
vert starts at (-2, -2) at U[0.5, 1.3] and runs 500 steps of 0.0193.
"""
import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_port_helpers as H  # noqa: E402
from raytracing_tpu.kernels import df as jdf  # noqa: E402
from raytracing_tpu_torch.kernels import df as tdf  # noqa: E402


def launch(field, rays, divisor, jitter, steps):
    """(pos0, theta0, float32 delta_s, steps) of the fan."""
    if field == "fisheye":
        pos0, theta0 = H.fisheye_df_fan(rays, jitter=jitter)
        return (pos0, theta0, np.float32(2 * np.pi / divisor),
                steps or divisor)
    rng = np.random.default_rng(0)
    return (np.tile([[-2.0, -2.0]], (rays, 1)), rng.uniform(0.5, 1.3, rays),
            np.float32(0.0193), steps or 500)


def positions(st, field, ds, steps, rate_fused, step_fused):
    body = tdf.make_df_rk4_body(tdf.df_k_of(field, rate_fused),
                                tdf._f32(ds), step_fused)
    carry = tuple(st)
    for _ in range(steps):
        carry = body(carry)
    return H.to_np(tdf.df_positions(tdf.DfState(*carry)))


def part(a, b):
    d = np.abs(a - b).max(axis=1)
    return (f"max {d.max():.4e} rms {np.sqrt((d ** 2).mean()):.4e} "
            f"rays past 1e-8: {(d > 1e-8).sum()} of {d.size}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--field", default="fisheye", choices=tdf.DF_FIELDS)
    ap.add_argument("--rays", type=int, default=128)
    ap.add_argument("--divisor", type=int, default=300)
    ap.add_argument("--jitter", type=float, default=0.3)
    ap.add_argument("--steps", type=int, default=None)
    a = ap.parse_args()
    pos0, theta0, ds, steps = launch(a.field, a.rays, a.divisor, a.jitter,
                                     a.steps)
    jitted = jdf.df_trace(pos0, theta0, ds, steps=steps, field=a.field,
                          block_rays=a.rays, interpret=True)
    st = tdf.initial_df_state(pos0, theta0, device="cpu")
    fma = positions(st, a.field, ds, steps, True, True)
    jax_order = positions(st, a.field, ds, steps, False, False)
    fan = f", jitter {a.jitter}" if a.field == "fisheye" else ""
    print(f"{a.field}, {a.rays} rays, {steps} steps of {float(ds)!r}{fan}")
    print("FMA form against JAX's roundings:  ", part(fma, jax_order))
    print("JAX's roundings against JAX jitted:", part(jax_order, jitted))
    print("FMA form against JAX jitted:       ", part(fma, jitted))
    print("the rate's fused terms alone:      ",
          part(positions(st, a.field, ds, steps, True, False), jax_order))
    print("the step's fused terms alone:      ",
          part(positions(st, a.field, ds, steps, False, True), jax_order))


if __name__ == "__main__":
    main()
