"""The example twins (examples/*_torch.py) run on the CPU: each twin's
``main([..., "--device", "cpu"])`` in this process, at the argv of
tests/test_examples.py (or smaller where the CPU needs it), with the
marker lines and numeric asserts of that file.  This file: the 3-D eddy,
the DELTA_S search, the million-ray benchmark, the wavefront movie and the
ocean waveguide; tests/test_torch_examples_media.py and
tests/test_torch_examples_tl_map.py hold the others."""
import re

import pytest
from torch_examples_helpers import twin

torch = pytest.importorskip("torch")


def test_eddy_3d_example(capsys):
    # enough steps to pass the 20 km eddy with runway for the deflection
    twin("eddy_3d").main(["32", "2300", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip().endswith("ok")
    assert "out-of-plane" in out
    assert "from raw samples" in out     # the tri-Hermite measured-grid leg


def test_delta_s_search_example(capsys, tmp_path, monkeypatch):
    """The checkpoint lands in the working directory.  The candidate grid
    is narrowed to the divisors 172-180 around the selection (176, as JAX's
    full sweep selects): the CPU scan tier takes minutes a hundred
    candidates."""
    import raytracing_tpu_torch.config as tcfg
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcfg, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 180.0)
    monkeypatch.setattr(tcfg, "DELTA_S_DIVISOR_FISHEYE_LOWER_LIMIT", 172.0)
    res = twin("delta_s_search").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "selected divisor" in out
    assert res.divisor == 176.0
    assert (tmp_path / "fisheye_sweep.npz").exists()
    # the same search over a 2-rank gloo world (a mesh, as under torchrun):
    # both ranks select 176 on the scan tier, and rank 0 wrote the file
    import os
    import torch_dist_helpers as D
    work = tmp_path / "mesh"
    work.mkdir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    world = D.run_world(2, [("example_search", (root, str(work), 180.0,
                                                172.0))], tmp_path)
    got = D.result(world, "example_search")
    assert [g[:2] for g in got] == [(176.0, "scan")] * 2 and got[0][2]
    assert (work / "fisheye_sweep.npz").exists()


def test_million_ray_benchmark_example(capsys):
    """At 64 rays (the kernel's plain version on the CPU): the full turn of
    4587 steps and its closure."""
    _, _, closure = twin("million_ray_benchmark").main(["64", "--device",
                                                        "cpu"])
    out = capsys.readouterr().out
    assert "64 rays x 4587 steps" in out and "engine=fused" in out
    assert closure < 5.0 and "closure error" in out


def test_wavefront_movie_example(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)          # the movie lands in the cwd
    _, path, fronts = twin("wavefront_movie").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"wrote {path}" in out and (tmp_path / path).stat().st_size > 0
    # the report's travel times 0.1, 0.3, 0.5: the fan has left the plot's
    # window before 0.5, as in JAX's run, so two fronts are reported
    assert len(fronts) == out.count("Travel Time") == 2


def test_ocean_waveguide_example(capsys):
    twin("ocean_waveguide").main(["4096", "400", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trapped in the channel" in out
    m = re.search(r"max (\d+\.\d+e-\d+) %", out)
    assert m and float(m[1]) < 0.05     # p_x conservation on the kernel fan
    assert "tomography adjoint" in out
