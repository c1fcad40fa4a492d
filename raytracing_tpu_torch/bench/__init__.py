"""Benchmark helpers of the port: ``harness`` (timing), ``fma_probe``, and
:func:`launch_fan`, the numpy port of ``bench.py::_fan`` (bench.py:37-44)."""
import numpy as np


def launch_fan(scen, rays: int):
    """The scenario's reference launch fan resized to ``rays`` rays, as
    float32 numpy (pos0 (R, 2), theta0 (R,)); the fisheye fan is every ray
    at (1, 0) heading pi/2."""
    if scen.is_fisheye:
        return (np.tile(np.array([[1.0, 0.0]], np.float32), (rays, 1)),
                np.full(rays, np.pi / 2.0, np.float32))
    return (np.tile(scen.pos0[:1].astype(np.float32), (rays, 1)),
            np.resize(np.asarray(scen.theta0, np.float32), rays))
