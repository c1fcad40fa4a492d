"""The port's CLI (``raytracing_tpu_torch/cli.py``) against the JAX
package's, flow by flow, on the CPU (``--device cpu``): the display run at
float64 (the same oracle value to 1e-9), the DELTA_S search (the same
divisor), the ``--rays`` batch, a measured medium from an ``.npz`` file
(final positions to 1e-5) and its ``--calibrate`` search (the same step);
and the parser's refusals of what is not ported yet."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu.config as jcfg  # noqa: E402
from raytracing_tpu import cli as jcli  # noqa: E402

import raytracing_tpu_torch.config as tcfg  # noqa: E402
from raytracing_tpu_torch import cli as tcli  # noqa: E402


def both(capsys, args):
    """(port output, JAX output) of one command line."""
    assert tcli.main(args + ["--device", "cpu"]) is not None
    tout = capsys.readouterr().out
    assert jcli.main(args) is not None
    return tout, capsys.readouterr().out


def number(pattern, text):
    m = re.search(pattern, text)
    assert m, text
    return float(m[1])


@pytest.mark.parametrize("op,mode", [("1", "default"), ("12", "calibrated")])
def test_display_run_matches_jax(op, mode, capsys):
    """The fisheye display run (one turn; the other scenarios' tens of
    thousands of scan steps are too long for the CPU suite); op12 takes
    op8's calibrated entry (calibrated_with_fallback)."""
    t, j = both(capsys, ["--scenario", "fisheye", "--op", op, "--n-turns",
                         "1", "--delta-s", mode, "--medium", "analytic",
                         "--dtype", "float64"])
    assert "RESULTS" in t
    closure = r"Closure error\s+(\S+) %"
    assert number(closure, t) == pytest.approx(number(closure, j), rel=1e-9)
    dist = r"Total travelled distance:\s+(\S+)"
    assert number(dist, t) == pytest.approx(number(dist, j), rel=1e-9)


def test_search_flow_selects_as_jax(capsys, monkeypatch):
    monkeypatch.setattr(jcfg, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 40.0)
    monkeypatch.setattr(tcfg, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 40.0)
    t, j = both(capsys, ["--scenario", "fisheye", "--op", "1", "--delta-s",
                         "search", "--medium", "analytic", "--dtype",
                         "float64", "--n-turns", "1"])
    assert "FINDING SUITABLE DIVISOR" in t
    found = r"Found best divisor! Using DELTA_S = 2\*pi / (\d+)"
    assert number(found, t) == number(found, j) == 23


def test_rays_batch_flow(capsys):
    t, j = both(capsys, ["--scenario", "fisheye", "--op", "6", "--rays",
                         "256", "--medium", "analytic", "--n-turns", "1",
                         "--delta-s", "default"])
    assert "ray-steps/s" in t and "via the fused engine" in t
    closure = r"Closure error\s+(\S+) %"
    assert number(closure, t) == pytest.approx(number(closure, j), abs=2e-4)
    assert re.search(r"Escaped rays: 0 / 256", t)


def _profile(tmp_path):
    y = np.linspace(-2.0, 1.0, 61)
    path = tmp_path / "prof.npz"
    np.savez(path, samples=1.0 + 0.3 * np.tanh(2.0 * y), y=y)
    return str(path)


def test_medium_file_flow(capsys, tmp_path):
    prof = _profile(tmp_path)
    common = ["--medium-file", prof, "--op", "op6", "--delta-s-value", "0.01",
              "--steps", "80", "--rays", "128", "--family", "c1",
              "--box", "-5", "5", "-2", "1",
              "--launch", "0.0", "-1.5", "-0.5", "0.3"]
    tpos, jpos = tmp_path / "t.npy", tmp_path / "j.npy"
    assert tcli.main(common + ["--save-pos", str(tpos), "--device", "cpu"])
    text = capsys.readouterr().out
    assert jcli.main(common + ["--save-pos", str(jpos)]) is not None
    capsys.readouterr()
    assert "profile (c1)" in text and "fused-strat" in text
    np.testing.assert_allclose(np.load(tpos), np.load(jpos), atol=1e-5)
    assert number(r"CV\(p_x\).*max (\d+\.\d+) %", text) < 0.05

    with pytest.raises(SystemExit):
        tcli.main(["--medium-file", prof, "--device", "cpu"])
    assert "--delta-s-value" in capsys.readouterr().err


def test_medium_file_calibrate_flow(capsys, tmp_path):
    prof = _profile(tmp_path)
    t, j = both(capsys, ["--medium-file", prof, "--op", "op6", "--calibrate",
                         "1e-2", "--arc-length", "1.0", "--rays", "128",
                         "--family", "c1", "--box", "-5", "5", "-2", "1",
                         "--launch", "0.0", "-1.5", "-0.5", "0.3"])
    step = r"calibrated \(61-sample profile\): delta_s = (\S+)"
    assert number(step, t) == number(step, j)
    with pytest.raises(SystemExit):
        tcli.main(["--medium-file", prof, "--op", "op6", "--calibrate",
                   "1e-2", "--launch", "0.0", "-1.5", "-0.5", "0.3",
                   "--device", "cpu"])
    assert "--arc-length" in capsys.readouterr().err


def test_op_for_choice_matches_jax():
    for scen in ("interface", "fisheye", "vert"):
        for k in range(1, 10):
            assert (tcli.op_for_choice(scen, str(k))
                    == jcli.op_for_choice(scen, str(k)))
    assert tcli.op_for_choice("aniso", "1") == "op10"
    assert tcli.op_for_choice("aniso", "2") == "op11"


@pytest.mark.parametrize("args,item", [
    (["--scenario", "vert", "--plot", "static"], "item 12"),
    (["--scenario", "vert", "--plot", "movie"], "item 12"),
    ([], "item 12"),
])
def test_parser_refuses_what_is_not_ported(args, item, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(args + ["--device", "cpu"])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_eigenrays3_flag_parses_as_jax(capsys):
    """--eigenrays3, --receiver3 and --fan3 are the JAX parser's flags: the
    same errors for a missing --medium-file and a missing --receiver3
    (the working flag is tested in tests/test_torch_eigenray3d.py)."""
    for argv, msg in ((["--eigenrays3", "0", "0", "0", "--fan3", "-0.1",
                        "0.1", "3", "-0.1", "0.1", "3"],
                       "--eigenrays3 needs --medium-file"),
                      (["--medium-file", "x.npz", "--eigenrays3", "0", "0",
                        "0", "--op", "6", "--delta-s-value", "0.1",
                        "--steps", "5"], "--eigenrays3 needs --receiver3")):
        for main, dev in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
            with pytest.raises(SystemExit) as e:
                main(argv + dev)
            assert e.value.code == 2
            assert msg in capsys.readouterr().err
