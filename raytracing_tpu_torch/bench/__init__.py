"""Benchmark helpers of the port: ``harness`` (timing), ``fma_probe``,
:func:`launch_fan`, the numpy port of ``bench.py::_fan`` (bench.py:37-44),
the sampled main path's runs (:data:`SAMPLED_RUNS`, :func:`sampled_media`)
that ``chip_smoke.py`` and ``fma_probe --profile-sampled`` drive, the
fisheye search's candidate sweep (:func:`sweep_inputs`), the float32 FMA
checks' triples (:func:`fma_triples`, ``chip_smoke.py`` and the tests),
:func:`warp_efficiency` (``chip_smoke.py`` and ``lifetimes``), and the
df32 tier's depths, media and launch fans (:func:`df_media`,
:func:`df_launch`, :func:`dispersed_fan`) that ``chip_smoke.py`` and
``fma_probe`` share; the 3-D runs' grid and fans (:func:`grid3_medium`,
:func:`fan3`, :func:`fan3_dyn`) that ``chip_smoke.py`` and ``fma_probe``
share."""
import math

import numpy as np

#: the headline's divisor (bench.py:641-657): one fisheye turn in 4587 steps
HEADLINE_DIVISOR = 4587
#: the df32 vert runs' depth: from (-2, -2) at U[0.5, 1.3] the rays stay
#: above -3 for 500 steps (tests/test_df.py:73-95); deeper ones cross the
#: field's pole at y = -9, which the df tier (no box) would integrate through
DF_VERT_STEPS = 500
#: the df32 Munk profile run's depth
DF_PROFILE_STEPS = 1500

#: the sampled main path: (run, scenario, medium, op) under the JAX
#: package's cell names (BENCH_SUITE.json, benchmarks/kernel_matrix.json);
#: the medium is what the JAX CLI's --medium auto builds (cli.py:404-416),
#: C1 where the cell says so; each run steps at the reference table's
#: delta_s (calibrated_with_fallback)
SAMPLED_RUNS = (
    ("interface_strat", "interface", "strat", "op6"),
    ("vert_strat", "vert", "strat", "op8"),
    ("vert_c1_strat", "vert", "c1_strat", "op8"),
    ("golden_strat_op11", "aniso", "strat", "op11"),
    ("fisheye_grid", "fisheye", "grid", "op1"),
    ("fisheye_c1_grid", "fisheye", "c1_grid", "op1"),
    ("tiled_grid_op5", "fisheye", "grid", "op5"),
)


def launch_fan(scen, rays: int):
    """The scenario's reference launch fan resized to ``rays`` rays, as
    float32 numpy (pos0 (R, 2), theta0 (R,)); the fisheye fan is every ray
    at (1, 0) heading pi/2."""
    if scen.is_fisheye:
        return (np.tile(np.array([[1.0, 0.0]], np.float32), (rays, 1)),
                np.full(rays, np.pi / 2.0, np.float32))
    return (np.tile(scen.pos0[:1].astype(np.float32), (rays, 1)),
            np.resize(np.asarray(scen.theta0, np.float32), rays))


def warp_efficiency(life) -> float:
    """Share of the lane-steps of a one-ray-a-thread launch that step a live
    ray: the rays' lifetimes (steps before each froze, in ray order, as
    numpy) over 32 times the longest lifetime of each 32-ray warp."""
    life = np.asarray(life, np.float64)
    warps = np.concatenate([life, np.zeros(-len(life) % 32)]).reshape(-1, 32)
    return float(life.sum() / (32.0 * warps.max(1)).sum())


def sampled_media(device):
    """The sampled runs' media on ``device``, keyed by (medium, scenario):
    parity stratified tables of interface and vert (aniso shares vert's
    field and box), the C1 vert table, and the parity and C1 fisheye
    grids, all at the reference's pitch."""
    import raytracing_tpu_torch as rtt

    iface, vert, fish = (rtt.scenario(n) for n in ("interface", "vert",
                                                   "fisheye"))
    media = {
        ("strat", "interface"): rtt.build_stratified_medium(
            "interface", iface.box, device=device),
        ("strat", "vert"): rtt.build_stratified_medium(
            "vert_heterogeneous", vert.box, device=device),
        ("c1_strat", "vert"): rtt.build_c1_stratified(
            "vert_heterogeneous", vert.box, device=device),
        ("grid", "fisheye"): rtt.build_grid_medium("fisheye", fish.box,
                                                   device=device),
        ("c1_grid", "fisheye"): rtt.build_c1_medium("fisheye", fish.box,
                                                    device=device),
    }
    media[("strat", "aniso")] = media[("strat", "vert")]
    media[("c1_strat", "aniso")] = media[("c1_strat", "vert")]
    return media


def sweep_inputs(device):
    """The reference's full fisheye candidate grid (divisor 303 -> 4, ten
    turns, buffers sized at divisor + 1) as the search runs it: one ray a
    candidate at (1, 0) heading pi/2, its step size and step limit."""
    import torch

    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch import config
    from raytracing_tpu_torch.parallel import sweep
    scen = rtt.scenario("fisheye")
    divs, ds, tdivs = sweep.candidates(scen)
    limits = sweep._max_sizes(scen, ds, tdivs, config.N_TURNS) - 1
    n = len(ds)
    pos0 = np.tile(np.array([[1.0, 0.0]], np.float32), (n, 1))
    theta0 = np.full(n, np.pi / 2.0, np.float32)
    return (scen, divs, pos0, theta0,
            torch.as_tensor(ds.astype(np.float32), device=device),
            torch.as_tensor(limits.astype(np.float32), device=device))


def munk_profile():
    """(depth, sound speed) of the TL field map's Munk-style profile
    (examples/tl_field_map.py), 121 samples, channel axis at depth -1."""
    depth = np.linspace(-3.0, 0.0, 121)
    eta = 2.0 * (depth + 1.0)
    return depth, 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))


def df_media(device):
    """The split-word media of the df32 main path on ``device``, keyed
    "grid", "c1" and "profile": the parity and C1 fisheye grids at the
    reference's pitch (511 x 511 nodes) and the Munk profile."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.engine import df_grid as dg

    box = rtt.scenario("fisheye").box
    depth, c = munk_profile()
    return {"grid": dg.build_df_grid_medium("fisheye", box, device=device),
            "c1": dg.build_df_c1_medium("fisheye", box, device=device),
            "profile": dg.df_c1_profile_from_samples(c.min() / c, depth,
                                                     device=device)}


def jittered(theta0, rng):
    """Launch angles with uniform jitter of +-1e-3 rad, as float32."""
    return (theta0 + rng.uniform(-1e-3, 1e-3, len(theta0))).astype(
        np.float32)


def df_launch(kind, rays, rng):
    """(pos0, theta0, delta_s) of a df run: the fisheye's one ray with
    +-1e-3 rad of jitter (the tables' too) at the headline's step, vert from
    (-2, -2) at U[0.5, 1.3], the profile's rays near the Munk channel's
    axis at U[-0.08, 0.08] rad (they stay between depth -3 and 0)."""
    import raytracing_tpu_torch as rtt

    if kind == "vert_heterogeneous":
        return (np.full((rays, 2), -2.0),
                rng.uniform(0.5, 1.3, rays).astype(np.float32).astype(
                    np.float64), float(np.float32(0.0193)))
    if kind == "profile":
        return (np.stack([np.zeros(rays), -1.0 + rng.uniform(-0.2, 0.2,
                                                             rays)], -1),
                rng.uniform(-0.08, 0.08, rays), float(np.float32(0.01)))
    pos0, theta0 = launch_fan(rtt.scenario("fisheye"), rays)
    return pos0, jittered(theta0, rng), float(np.float32(2.0 * math.pi / HEADLINE_DIVISOR))


def dispersed_fan(box, rays, rng):
    """(pos0, theta0) of a dispersed fan: launch points uniform over the
    box (x0, x1, y0, y1), launch angles uniform on [0, 2 pi), so that
    neighbouring rays read unrelated cell rows."""
    pos0 = np.stack([rng.uniform(box[0], box[1], rays),
                     rng.uniform(box[2], box[3], rays)], -1)
    return pos0, rng.uniform(0.0, 2.0 * math.pi, rays)


def df_state(kind, pos0, theta0, device):
    """The launch state of a df run: an analytic field's (float32 words,
    zero low words) or a split-word medium's (hi and lo of the float64
    launch)."""
    from raytracing_tpu_torch.engine import df_grid as dg
    from raytracing_tpu_torch.kernels import df as kdf

    if kind in kdf.DF_FIELDS:
        return kdf.initial_df_state(pos0, theta0, device=device)
    return dg.split_state(pos0, theta0, device=device)


# -- the 3-D runs -------------------------------------------------------------
#: one turn of the fisheye's unit circle (benchmarks/kernel_matrix.py:194)
DIV3 = 600
BOX3 = (-1.5, 1.5, -1.5, 1.5, -1.5, 1.5)
#: the benchmark's grid3 axis: 71 nodes at pitch 0.05
#: (benchmarks/kernel_matrix.py:220-224); its per-cell table is 87.8 MB
AX3 = np.arange(-1.75, 1.7501, 0.05)
#: the JAX launches of vert op8 and interface op6
#: (tests/test_dynamic_kernel3.py:92-99)
DYN3_FIELD_LAUNCH = {
    "vert": ((0.0, -1.0, 0.0), (-2.0, 5.0, -2.5, 1.0, -2.0, 2.0)),
    "interface": ((-2.0, -2.0, 0.0), (-2.0, 20.0, -2.0, 4.0, -4.0, 4.0)),
}


def grid3_medium(device):
    """The benchmark's sampled 3-D fisheye (71^3 nodes), built on the host
    and uploaded to ``device``."""
    import raytracing_tpu_torch as rtt
    X, Y, Z = np.meshgrid(AX3, AX3, AX3, indexing="ij")
    return rtt.c1_medium3_from_samples(
        1.0 / (1.0 + X ** 2 + Y ** 2 + Z ** 2), AX3, AX3, AX3, device=device)


def fan3(kind, rays, seed):
    """(pos0, dir0, delta_s, steps, box) of the 3-D runs: ``tilted`` the
    fisheye's ray (1, 0, 0) launched in planes tilted by [0, 1] rad (every
    ray distinct; one turn); ``matrix`` the benchmark's 2^20 identical rays
    (kernel_matrix.py:191-194); ``vert`` and ``interface`` random points
    and directions in a box that some rays leave; ``dispersed`` points
    all over the grid with random directions, so that the rays read rows
    all over the 87.8 MB table."""
    rng = np.random.default_rng(seed)
    if kind in ("tilted", "matrix"):
        if kind == "tilted":
            tilt = np.linspace(0.0, 1.0, rays)
            d = np.stack([np.zeros(rays), np.cos(tilt), np.sin(tilt)], -1)
        else:
            d = np.tile([[0.0, 1.0, 1e-3]], (rays, 1))
        return (np.tile([[1.0, 0.0, 0.0]], (rays, 1)).astype(np.float32),
                d.astype(np.float32), 2.0 * math.pi / DIV3, DIV3, BOX3)
    if kind == "dispersed":
        return (rng.uniform(-1.4, 1.4, (rays, 3)).astype(np.float32),
                rng.normal(size=(rays, 3)).astype(np.float32),
                2.0 * math.pi / DIV3, DIV3, BOX3)
    pos0 = rng.uniform(-1.0, 1.0, (rays, 3))
    ds, steps, box = 0.01, 200, (-2.0, 2.0, -2.0, 2.0, -2.0, 2.0)
    if kind == "interface":
        pos0[:, 1] = rng.uniform(-0.05, 0.05, rays)
        ds, steps = 0.002, 1000
    return (pos0.astype(np.float32),
            rng.normal(size=(rays, 3)).astype(np.float32), ds, steps, box)


def fan3_dyn(kind, rays, seed):
    """(pos0, dir0, delta_s, steps, box) of the [dyn3] runs: the 3-D
    phase's fans (``tilted``, ``matrix``, ``dispersed``: one turn of 600
    steps) and JAX's ``vert`` and ``interface`` launches (directions at
    [0.1, 0.9] rad with a 0.01 z-component, 250 steps of 0.01)."""
    if kind not in DYN3_FIELD_LAUNCH:
        return fan3(kind, rays, seed)
    pos, box = DYN3_FIELD_LAUNCH[kind]
    a = np.linspace(0.1, 0.9, rays)
    return (np.tile([pos], (rays, 1)).astype(np.float32),
            np.stack([np.cos(a), np.sin(a), np.full(rays, 0.01)],
                     -1).astype(np.float32), 0.01, 250, box)


# -- the FMA checks -----------------------------------------------------------
def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def fma_triples(kind, n, rng):
    """(a, b, c), float32 numpy arrays of n triples that test a float32 FMA
    against a reference: ``bits`` every bit pattern (zeros, subnormals,
    infinities and NaN included); ``moderate`` exponents in +-30 and +-60,
    c near -a b half the time, so that the sum cancels most of the
    product's bits; ``midpoint`` and ``midpoint-subnormal`` triples where p
    + c = m + t, m a float32 midpoint (of normal or subnormal neighbours)
    and |t| far below float64's half ulp of m, so that p + c rounds in
    float64 to m exactly with an error of sign(t), either sign: c = y or
    its upper neighbour, a b = +-2^(E - 24) (1 - 2^-46) where 2^E <= |y| <
    2^(E + 1) (2^-150 (1 - 2^-46) for a subnormal y), a = 2^ka (1 + 2^-23),
    b = 2^kb (1 - 2^-23), signs drawn."""
    if kind == "bits":
        return tuple(_f32(rng.integers(0, 2 ** 32, n, dtype=np.uint64))
                     for _ in range(3))
    if kind == "moderate":
        a = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
             ).astype(np.float32)
        b = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
             ).astype(np.float32)
        c = (rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
             ).astype(np.float32)
        near = rng.random(n) < 0.5
        c[near] = (-(a[near].astype(np.float64) * b[near])
                   * (1.0 + rng.standard_normal(int(near.sum())) * 2.0 ** -20)
                   ).astype(np.float32)
        return a, b, c
    if kind == "midpoint-subnormal":
        y = _f32(rng.integers(1, 1 << 23, n, dtype=np.uint64))
        e = np.full(n, -126)
    elif kind == "midpoint":
        y = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-100, 100, n)
             ).astype(np.float32)
        e = np.floor(np.log2(y.astype(np.float64))).astype(np.int64)
    else:
        raise ValueError(f"fma_triples kinds: bits, moderate, midpoint, "
                         f"midpoint-subnormal; not {kind!r}")
    up = rng.random(n) < 0.5
    c = np.where(up, np.nextafter(y, np.float32(np.inf)), y)
    sign = np.where(up, -1.0, 1.0)
    # the midpoint's half ulp, 2^(e - 24), split between a and b
    k = e - 24
    ka = k // 2
    a = (sign * 2.0 ** ka * (1.0 + 2.0 ** -23)).astype(np.float32)
    b = (2.0 ** (k - ka) * (1.0 - 2.0 ** -23)).astype(np.float32)
    neg = rng.random(n) < 0.5
    return np.where(neg, -a, a), b, np.where(neg, -c, c)
