"""Benchmark helpers of the port: ``harness`` (timing), ``fma_probe``,
:func:`launch_fan`, the numpy port of ``bench.py::_fan`` (bench.py:37-44),
and the sampled main path's runs (:data:`SAMPLED_RUNS`, :func:`sampled_media`)
that ``chip_smoke.py`` and ``fma_probe --profile-sampled`` drive."""
import numpy as np

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
