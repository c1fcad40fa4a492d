"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the port see the same numbers.  Torch runs on one thread:
the suite runs under several pytest-xdist workers, and torch's own thread
pool would oversubscribe the machine.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none.

    Decided when the test runs, never at import, so every pytest worker
    collects the same tests.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (and nvcc to build the "
                    "kernels); this machine has none")
    return torch.device("cuda", 0)


def fan_near_interface(rng, r):
    """Launch points just below the interface, heading up into it."""
    pos0 = np.stack([-2.0 + rng.uniform(0.0, 0.5, r),
                     -0.06 + rng.uniform(0.0, 0.03, r)], -1)
    return pos0, rng.uniform(0.3, 1.4, r)


def fan_vert(rng, r):
    """Launch points near the vert/aniso scenarios' launch corner."""
    pos0 = np.stack([-2.0 + rng.uniform(0.0, 0.5, r),
                     -2.0 + rng.uniform(0.0, 0.5, r)], -1)
    return pos0, rng.uniform(0.0, 1.5, r)


#: shrunken boxes: rays leave them at different steps within a short run.
#: The interface box keeps rays inside the sigmoid's gradient band, where
#: the golden-section cost has a well-defined minimum; far from the
#: interface the medium is uniform, the bracket's first comparison is a
#: roundoff tie, and float64 golden results differ by the search
#: tolerance (~3e-8 rad) between any two libms.
INTERFACE_BOX = (-2.0, 20.0, -0.07, 0.07)
VERT_BOX = (-2.0, -0.5, -2.5, -1.0)


def to_np(t):
    return t.detach().cpu().numpy()


def medium_fields(jm) -> dict:
    """A JAX medium's fields as numpy arrays and Python statics."""
    return {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
            for f in dataclasses.fields(jm)
            for v in (getattr(jm, f.name),)}


def port_medium(jm, device="cpu"):
    """The port's twin of a JAX sampled medium, carried across by interop."""
    from raytracing_tpu_torch.interop import medium_from_numpy
    return medium_from_numpy(type(jm).__name__, medium_fields(jm),
                             device=device)


def fisheye_df_fan(r, jitter=0.0, seed=0):
    """The fisheye's one launch ray (1, 0) at pi/2, repeated ``r`` times,
    with uniform jitter of +-``jitter`` rad on the angle."""
    rng = np.random.default_rng(seed)
    return (np.tile([[1.0, 0.0]], (r, 1)),
            np.pi / 2 + rng.uniform(-jitter, jitter, r))


def munk_profile():
    """(samples, depth) of a Munk-style channel (axis at depth -1), 121
    samples on [-3, 0]: the refractive index c_min / c of
    examples/tl_field_map.py's sound speed (``bench.munk_profile``)."""
    from raytracing_tpu_torch.bench import munk_profile as depth_and_speed
    depth, c = depth_and_speed()
    return c.min() / c, depth


def dekker_pairs(n=4096, seed=0):
    """Seeded float32 pairs across 16 decades, signs mixed, with the
    magnitudes Dekker splitting finds hard: values near powers of two,
    splits that carry into the high word, and equal and opposite pairs."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
    b = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
    k = n // 8
    a[:k] = np.ldexp(1.0, rng.integers(-20, 20, k)) * (1 + 2.0 ** -23)
    b[:k] = np.ldexp(1.0, rng.integers(-20, 20, k)) * (1 - 2.0 ** -24)
    a[k:2 * k] = (2.0 ** 12 + 1) * rng.uniform(0.5, 1.0, k)   # split carry
    b[2 * k:3 * k] = -a[2 * k:3 * k]
    return a.astype(np.float32), b.astype(np.float32)


def channel_fan(r, seed=0):
    """Rays launched near the Munk channel's axis at small angles: they stay
    trapped between depth -3 and 0 (the df tier has no box)."""
    rng = np.random.default_rng(seed)
    return (np.stack([np.zeros(r), -1.0 + rng.uniform(-0.2, 0.2, r)], -1),
            rng.uniform(-0.08, 0.08, r))


def port_df_medium(jm, device="cpu"):
    """The port's twin of a JAX df32 medium (``DfGridMedium``,
    ``DfC1Medium``, ``DfC1Profile``, ``DfEvalProfile``), carried across by
    interop; a ``DfEvalProfile``'s profile goes as a nested dict."""
    from raytracing_tpu_torch.interop import medium_from_numpy
    fields = medium_fields(jm)
    if "prof" in fields:
        fields["prof"] = medium_fields(fields["prof"])
    return medium_from_numpy(type(jm).__name__, fields, device=device)


def jax_order_forms(monkeypatch):
    """Make the 2-D dynamic (analytic fields and grids, the grids' blends
    too) and analytic 3-D plain versions round as JAX rounds (every product
    and sum on its own) instead of in their kernels' FMA form:
    ``utils/fma.py::mads`` unfused."""
    from raytracing_tpu_torch.utils import fma
    mads = fma.mads
    monkeypatch.setattr(fma, "mads", lambda fused: mads(False))


#: (dimension, field, where, op): launches whose every ray-step leaves a
#: fast path of the analytic dynamic (2-D) or 3-D kernel (see
#: :func:`beyond_guards`); every state plane stays finite on each
BEYOND_GUARD_CASES = (
    [(2, f, "far", op) for f in ("fisheye", "vert_heterogeneous")
     for op in ("op2", "op6")]
    + [(2, "fisheye", "tiny", op) for op in ("op6", "op8")]
    + [(3, "fisheye", "far", op) for op in ("op1", "op2", "op6", "op8")]
    + [(3, "fisheye", "tiny", op) for op in ("op6", "op8")])


def beyond_guards(dim, field, where, r, seed=6):
    """(pos0, theta0 or dir0, delta_s, box) of rays beyond a fast path's
    guard at every step, with finite values throughout.

    2-D far: the fisheye's 1 + x^2 + y^2 (x in [9.3e18, 1.4e19]) or vert's
    18 + 2 y (y in [4.3e37, 9e37]) above 2^126, so the field's reciprocal
    fails its guard and n, and with it the next step's 1 / n2, is
    subnormal.  3-D far: x in [1e8, 1e9], n within [1e-18, 1e-16], below
    the carried reciprocal's 2^-16 and with |p|^2 below the impulse's
    2^-100.  Tiny: delta_s = 1e-17, the chord's square (and in 3-D
    delta_s^2 / 2) below 2^-100.  The box holds every ray."""
    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(-1.0, 1.0, (r, dim))
    ds, box = (1e-17, 1.5) if where == "tiny" else (0.05, 3e38)
    if where == "far":
        if dim == 3:
            pos0[:, 0] = rng.uniform(1e8, 1e9, r)
            box = 1e10
        elif field == "fisheye":
            pos0[:, 0] = rng.uniform(9.3e18, 1.4e19, r)
        else:
            pos0[:, 1] = rng.uniform(4.3e37, 9e37, r)
    aim = (rng.uniform(0.0, 2 * np.pi, r) if dim == 2
           else rng.normal(size=(r, 3)))
    return pos0, aim, ds, (-box, box) * dim
