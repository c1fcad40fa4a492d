"""The port's plots and CLI display path (raytracing_tpu_torch/viz/plots.py,
raytracing_tpu_torch/cli.py) against the JAX package's: one twin of each
test of tests/test_viz_cli.py, on the CPU (``--device cpu``) at float64.

Each twin runs the same seeded fans through both packages and holds the
port to JAX: wavefront points and normals within 1e-9; the data of every
``Line2D`` that ``plot_static``, ``plot_momentum``, ``plot_eigenrays``,
``plot_transmission_loss`` and ``plot_rays3d`` draw within 1e-9 of JAX's
figure, with the same number of lines; the CLI's printed oracle lines
within the same; the menus driven by a scripted ``input_fn`` (or stdin);
the wavefront movie's 45 GIF frames.  matplotlib runs on the Agg backend
and every figure is closed after use."""
import dataclasses
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
import raytracing_tpu.config as jcfg  # noqa: E402
from raytracing_tpu import cli as jcli  # noqa: E402
from raytracing_tpu.viz import plots as jplots  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
import raytracing_tpu_torch.config as tcfg  # noqa: E402
from raytracing_tpu_torch import cli as tcli  # noqa: E402
from raytracing_tpu_torch.viz import plots as tplots  # noqa: E402

TOL = 1e-9


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def vert_results():
    """(JAX result, port result, scenario): tests/test_viz_cli.py's vert
    fan (op8, s_max 6, delta_s 0.01) in float64."""
    jscen = dataclasses.replace(rt.scenario("vert"), s_max=6.0)
    tscen = dataclasses.replace(rtt.scenario("vert"), s_max=6.0)
    j = rt.trace("op8", jscen, rt.analytic_medium("vert_heterogeneous"),
                 delta_s=0.01, dtype=np.float64)
    t = rtt.trace("op8", tscen, rtt.analytic_medium("vert_heterogeneous"),
                  delta_s=0.01, dtype=torch.float64, device="cpu")
    return j, t, tscen


def lines_of(fig):
    """The data of every line of every axes of ``fig``, in drawing order."""
    out = []
    for ax in fig.axes:
        for ln in ax.get_lines():
            data = (ln.get_data_3d() if hasattr(ln, "get_data_3d")
                    else ln.get_data())
            out.append(np.stack([np.asarray(d, np.float64) for d in data]))
    return out


def assert_same_lines(tfig, jfig, tol=TOL):
    tl, jl = lines_of(tfig), lines_of(jfig)
    assert len(tl) == len(jl) and len(tl) > 0
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def assert_same_front(t, j, tol=TOL):
    for name in ("points", "ray_angles", "normal_angles", "angle_diffs",
                 "curve"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=0, atol=tol, err_msg=name)


def number(pattern, text):
    m = re.search(pattern, text)
    assert m, text
    return float(m[1])


def test_wavefront_normals_match_ray_angles(vert_results):
    """The reference's physical cross-check (RT_bench.py:1024-1039):
    wavefront normals agree with the rays' group angles, and the port's
    front is JAX's."""
    j, t, _ = vert_results
    wf, jwf = tplots.wavefront(t, 0.3), jplots.wavefront(j, 0.3)
    assert wf is not None and wf.points.shape[0] > 5
    assert np.median(wf.angle_diffs[2:-2]) < 0.05, wf.angle_diffs
    assert_same_front(wf, jwf)
    x, y, ang, tt = tplots.ray_xy(t, 3)
    for a, b in zip((x, y, ang, tt), jplots.ray_xy(j, 3)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_wavefront_none_when_too_early(vert_results):
    j, t, _ = vert_results
    assert tplots.wavefront(t, 1e9) is None
    assert jplots.wavefront(j, 1e9) is None


def test_plot_static_and_momentum(tmp_path, vert_results):
    j, t, scen = vert_results
    jscen = dataclasses.replace(rt.scenario("vert"), s_max=6.0)
    fig, fronts = tplots.plot_static(t, scen,
                                     save=str(tmp_path / "static.png"))
    jfig, jfronts = jplots.plot_static(j, jscen)
    assert (tmp_path / "static.png").stat().st_size > 0
    assert len(fronts) == len(jfronts) > 0
    assert_same_lines(fig, jfig)
    mom = tplots.plot_momentum(t, scen, delta_s=0.01,
                               save=str(tmp_path / "mom.png"))
    assert (tmp_path / "mom.png").stat().st_size > 0
    jmom = jplots.plot_momentum(j, jscen, delta_s=0.01)
    assert_same_lines(mom, jmom)
    assert ([a.get_text() for a in mom.axes[0].texts]
            == [a.get_text() for a in jmom.axes[0].texts])


def test_cli_noninteractive_fisheye(capsys):
    args = ["--scenario", "fisheye", "--op", "1", "--delta-s", "default",
            "--medium", "analytic", "--dtype", "float64", "--n-turns", "1"]
    assert tcli.main(args + ["--device", "cpu"]) is not None
    t = capsys.readouterr().out
    assert jcli.main(args) is not None
    j = capsys.readouterr().out
    assert "RESULTS" in t and "Closure error" in t
    closure = r"Closure error\s+(\S+) %"
    assert number(closure, t) == pytest.approx(number(closure, j), abs=TOL)


def scripted(answers):
    it = iter(answers)
    return lambda _: next(it)


@pytest.fixture
def menus_at_float64(monkeypatch):
    """The menus' pipeline in both packages at float64 (the menus ask for
    no dtype; the reference's default is float32), so that the oracle
    lines compare at 1e-9."""
    import functools
    monkeypatch.setattr(tcli, "run_pipeline", functools.partial(
        tcli.run_pipeline, dtype=torch.float64))
    monkeypatch.setattr(jcli, "run_pipeline", functools.partial(
        jcli.run_pipeline, dtype=np.float64))


def test_cli_interactive_flow(capsys, menus_at_float64):
    """The reference's menus: scenario 2, algorithm 1, no search, no
    calibrated step (the default: 91 steps a turn), no benchmark; then the
    static plot."""
    answers = ["2", "1", "n", "n", "n"]
    assert tcli.interactive(input_fn=scripted(answers),
                            device="cpu") is not None
    t = capsys.readouterr().out
    assert jcli.interactive(input_fn=scripted(answers)) is not None
    j = capsys.readouterr().out
    assert "Choose a Test Option" in t and "Closure error" in t
    closure = r"Closure error\s+(\S+) %"
    assert number(closure, t) == pytest.approx(number(closure, j), abs=TOL)
    # the menus print what JAX's print, up to the results
    assert t.split("RESULTS")[0] == j.split("RESULTS")[0]


def test_cli_op_aliases():
    for scen, key in (("aniso", "1"), ("aniso", "2"), ("vert", "7")):
        assert tcli.op_for_choice(scen, key) == jcli.op_for_choice(scen, key)
    assert tcli.op_for_choice("aniso", "1") == "op10"


def test_animate_wavefronts_saves_gif(tmp_path, vert_results):
    """The movie's 45 frames, saved as a GIF where ffmpeg is missing, each
    frame's front equal to JAX's."""
    from PIL import Image, ImageSequence

    j, t, scen = vert_results
    jscen = dataclasses.replace(rt.scenario("vert"), s_max=6.0)
    ani, path = tplots.animate_wavefronts(t, scen,
                                          save=str(tmp_path / "wf.mp4"))
    assert path.endswith(".gif") or path.endswith(".mp4")
    assert (tmp_path / path.rsplit("/", 1)[-1]).stat().st_size > 0
    if path.endswith(".gif"):
        # Pillow merges equal consecutive frames and adds their durations:
        # 45 frames of 200 ms (matplotlib's 5 frames a second)
        with Image.open(path) as im:
            ms = [f.info["duration"] for f in ImageSequence.Iterator(im)]
        assert sum(ms) == 45 * 200 and len(ms) <= 45
    jani, jpath = jplots.animate_wavefronts(j, jscen)
    assert jpath is None
    for frame in (0, 11, 29, 44):
        ani._func(frame)
        jani._func(frame)
        assert_same_lines(ani._fig, jani._fig)


def test_cli_interactive_vert_static(capsys, tmp_path, monkeypatch,
                                     menus_at_float64):
    """Scenario 3 through the menus, answered on stdin as ``main`` with no
    flags reads them: calibrated step, static plot and wavefront report."""
    monkeypatch.chdir(tmp_path)
    answers = "3\n8\nn\ny\nn\n1\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(answers))
    assert tcli.main(["--device", "cpu"]) is not None
    t = capsys.readouterr().out
    assert jcli.interactive(input_fn=scripted(answers.split())) is not None
    j = capsys.readouterr().out
    assert "Coefficient of Variation" in t and "Travel Time" in t
    cv = r"Coefficient of Variation:\s+(\S+)"
    assert number(cv, t) == pytest.approx(number(cv, j), abs=TOL)
    angle = r"Ray Angle = \s*(\S+),"
    got = [float(v) for v in re.findall(angle, t)]
    want = [float(v) for v in re.findall(angle, j)]
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_cli_rays_batch_mode(capsys):
    args = ["--scenario", "fisheye", "--op", "6", "--rays", "256",
            "--medium", "analytic", "--n-turns", "1", "--delta-s", "default"]
    assert tcli.main(args + ["--device", "cpu"]) is not None
    t = capsys.readouterr().out
    jcli.main(args)
    j = capsys.readouterr().out
    assert "ray-steps/s" in t and "Closure error" in t
    closure = r"Closure error\s+(\S+) %"
    assert number(closure, t) == pytest.approx(number(closure, j), abs=2e-4)


def _media_files(tmp_path):
    y = np.linspace(-2.0, 1.0, 61)
    np.savez(tmp_path / "prof.npz", samples=1.0 + 0.3 * np.tanh(2.0 * y),
             y=y)
    gx = np.linspace(-2.0, 2.0, 41)
    gy = np.linspace(-1.5, 1.5, 31)
    np.savez(tmp_path / "lens.npz",
             samples=1.0 / (1.0 + 0.4 * gx[None, :] ** 2
                            + 0.6 * gy[:, None] ** 2), x=gx, y=gy)
    return str(tmp_path / "prof.npz"), str(tmp_path / "lens.npz")


def test_cli_medium_file_mode(capsys, tmp_path, monkeypatch):
    """--medium-file with --plot static: the subset's trajectories over the
    medium, drawn as JAX draws them; the required flags demanded."""
    prof, lens = _media_files(tmp_path)
    drawn = {}
    for name, mod in (("t", tplots), ("j", jplots)):
        real = mod.plot_static

        def keep(*a, _real=real, _name=name, **k):
            drawn[_name] = _real(*a, **k)[0]
            return drawn[_name], []
        monkeypatch.setattr(mod, "plot_static", keep)
    png = tmp_path / "rays.png"
    args = ["--medium-file", lens, "--op", "6", "--delta-s-value", "0.01",
            "--steps", "60", "--rays", "256",
            "--launch", "-1.5", "-0.3", "0.3", "0.0", "--plot", "static"]
    assert tcli.main(args + ["--save-plot", str(png), "--device",
                             "cpu"]) is not None
    t = capsys.readouterr().out
    assert jcli.main(args) is not None
    j = capsys.readouterr().out
    assert "41 grid (parity)" in t and "CV(p_x)" not in t
    assert png.exists() and png.stat().st_size > 1000
    assert f"Plot saved to {png}" in t
    mean = r"Mean final position: \((\S+),"
    assert number(mean, t) == pytest.approx(number(mean, j), abs=1e-5)
    # float32 subset traces: JAX's scan and the port's, to float32 rounding
    assert_same_lines(drawn["t"], drawn["j"], tol=1e-5)

    with pytest.raises(SystemExit):
        tcli.main(["--medium-file", lens, "--device", "cpu"])
    assert "--delta-s-value" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tcli.main(args[:-1] + ["movie", "--device", "cpu"])
    assert "--plot movie is not supported" in capsys.readouterr().err


def test_cli_medium_file_calibrate(capsys, tmp_path):
    prof, _ = _media_files(tmp_path)
    args = ["--medium-file", prof, "--op", "op6", "--calibrate", "1e-2",
            "--arc-length", "1.0", "--rays", "128", "--family", "c1",
            "--box", "-5", "5", "-2", "1",
            "--launch", "0.0", "-1.5", "-0.5", "0.3"]
    assert tcli.main(args + ["--device", "cpu"]) is not None
    t = capsys.readouterr().out
    assert jcli.main(args) is not None
    j = capsys.readouterr().out
    step = r"calibrated \(61-sample profile\): delta_s = (\S+)"
    assert number(step, t) == number(step, j)
    assert "profile (c1)" in t


def test_cli_search_flow(capsys, monkeypatch):
    monkeypatch.setattr(jcfg, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 40.0)
    monkeypatch.setattr(tcfg, "DELTA_S_DIVISOR_FISHEYE_UPPER_LIMIT", 40.0)
    args = ["--scenario", "fisheye", "--op", "1", "--delta-s", "search",
            "--medium", "analytic", "--dtype", "float64", "--n-turns", "1"]
    assert tcli.main(args + ["--device", "cpu"]) is not None
    t = capsys.readouterr().out
    assert jcli.main(args) is not None
    j = capsys.readouterr().out
    found = r"Found best divisor! Using DELTA_S = 2\*pi / (\d+)"
    assert "FINDING SUITABLE DIVISOR" in t
    assert number(found, t) == number(found, j)


def test_cli_aniso_flow(capsys, monkeypatch):
    """The aniso scenario's first unit of arc (378 steps; its full 80
    take the port's float64 scan tier minutes on the CPU)."""
    for mod in (tcfg, jcfg):
        real = mod.scenario
        monkeypatch.setattr(mod, "scenario", lambda name, *a, _real=real, **k:
                            dataclasses.replace(_real(name, *a, **k),
                                                s_max=1.0))
    args = ["--scenario", "aniso", "--op", "2", "--delta-s", "default",
            "--medium", "analytic", "--dtype", "float64"]
    assert tcli.main(args + ["--device", "cpu"]) is not None
    t = capsys.readouterr().out
    assert jcli.main(args) is not None
    j = capsys.readouterr().out
    cv = r"Coefficient of Variation:\s+(\S+)"
    assert number(cv, t) == pytest.approx(number(cv, j), abs=TOL)


def test_cli_calibrated_fallback_extension_ops():
    """run_pipeline('calibrated') takes op8's entry for op12, as JAX's."""
    res = tcli.run_pipeline(tcfg.scenario("fisheye"), "op12",
                            delta_s_mode="calibrated", medium_kind="analytic",
                            n_turns=1, dtype=torch.float64, device="cpu",
                            printer=lambda *a, **k: None)
    jres = jcli.run_pipeline(jcfg.scenario("fisheye"), "op12",
                             delta_s_mode="calibrated",
                             medium_kind="analytic", n_turns=1,
                             dtype=np.float64, printer=lambda *a, **k: None)
    np.testing.assert_allclose(res.final.pos.numpy(),
                               np.asarray(jres.final.pos), atol=TOL)


def _waveguide(tmp_path):
    y = np.linspace(-1.5, 1.5, 61)
    np.savez(tmp_path / "wg.npz", samples=1.2 - 0.25 * y * y, y=y)
    return str(tmp_path / "wg.npz")


def _arrival_lines(text):
    return [[float(v) for v in ln.split(")")[1].split()]
            for ln in text.splitlines()
            if ln.startswith("(") and "no arrivals" not in ln]


#: the waveguide's eigenray solve: source, receivers, step, steps, box
EIG = dict(source=(0.0, 0.0), receivers=[[8.0, 0.0], [8.0, 0.3]],
           delta_s=0.04, steps=260, box=(-1.0, 10.0, -1.5, 1.5))


@pytest.fixture(scope="module")
def waveguide_eigenrays(tmp_path_factory):
    """Both CLIs' ``--eigenrays`` on the parabolic waveguide profile (fan
    48, float64 tables): (port output, JAX output, port result, JAX
    result, the file).  Shared by the CLI twin and the plot twin."""
    wg = _waveguide(tmp_path_factory.mktemp("wg"))
    args = ["--medium-file", wg, "--op", "op6", "--delta-s-value",
            str(EIG["delta_s"]), "--steps", str(EIG["steps"]), "--family",
            "c1", "--box", *map(str, EIG["box"]), "--eigenrays", "0", "0",
            "--fan", "-0.45", "0.45", "48", "--omega", "40"]
    for rx, ry in EIG["receivers"]:
        args += ["--receiver", str(rx), str(ry)]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", out)
        res = tcli.main(args + ["--device", "cpu"])
        t = out.getvalue()
        out.seek(0)
        out.truncate()
        jres = jcli.main(args)
        j = out.getvalue()
    return t, j, res, jres, wg


def test_cli_eigenrays(capsys, waveguide_eigenrays):
    """--eigenrays through a measured profile: JAX's arrivals (theta0,
    traveltime, amplitude, KMAH) and TL lines; the golden op and a missing
    receiver refused."""
    t, j, res, jres, wg = waveguide_eigenrays
    assert "TL incoherent" in t and "coherent" in t and "WARNING" not in t
    assert len(res.theta0) >= 2 and bool(np.all(res.converged))
    np.testing.assert_allclose(res.theta0, np.asarray(jres.theta0), atol=TOL)
    got, want = _arrival_lines(t), _arrival_lines(j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:4], b[:4], atol=1e-6)
    tl = r"TL incoherent\s+(\S+) dB"
    assert number(tl, t) == pytest.approx(number(tl, j), abs=0.01)

    with pytest.raises(SystemExit):
        tcli.main(["--medium-file", wg, "--op", "op5", "--delta-s-value",
                   "0.02", "--steps", "40", "--eigenrays", "0", "0",
                   "--receiver", "1", "0", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(["--medium-file", wg, "--op", "op6", "--delta-s-value",
                   "0.02", "--steps", "40", "--eigenrays", "0", "0",
                   "--device", "cpu"])


def test_plot_eigenrays_and_tl(tmp_path, waveguide_eigenrays):
    """The eigenray paths (re-traced by the dynamic tier at float64,
    caustics marked) and the TL curve of the waveguide's arrivals: JAX's
    figures, line for line."""
    _, _, eig, jeig, wg = waveguide_eigenrays
    tmed = tcli.load_samples_medium(wg, "c1", dtype=torch.float64,
                                    device="cpu")[0]
    jmed = jcli.load_samples_medium(wg, "c1", dtype=np.float64)[0]
    pk = dict(EIG, steps=EIG["steps"] + 1)
    fig = tplots.plot_eigenrays(eig, "op6", tmed,
                                save=str(tmp_path / "eig.png"), **pk)
    assert (tmp_path / "eig.png").stat().st_size > 0
    assert_same_lines(fig, jplots.plot_eigenrays(jeig, "op6", jmed, **pk))
    receivers = EIG["receivers"]
    fig2 = tplots.plot_transmission_loss(eig, receivers, omega=40.0,
                                         save=str(tmp_path / "tl.png"))
    assert (tmp_path / "tl.png").stat().st_size > 0
    assert_same_lines(fig2, jplots.plot_transmission_loss(
        jeig, receivers, omega=40.0), tol=1e-7)


def test_plot_rays3d(tmp_path):
    from raytracing_tpu.engine.trace3d import trace3d as jtrace3d
    from raytracing_tpu.media.fields3d import Custom3D as JCustom3D

    th = np.linspace(-0.3, 0.3, 6)
    kw = dict(pos0=np.zeros((6, 3)),
              dir0=np.stack([np.cos(th), np.sin(th), np.full(6, 0.1)], -1),
              delta_s=0.05, steps=200, box=(-1, 12, -2, 2, -2, 2))
    jres = jtrace3d("op6", JCustom3D(lambda x, y, z: 1.5 - 0.5 * y * y
                                     + 0.0 * x * z), dtype=np.float64, **kw)
    res = rtt.trace3d("op6", rtt.Custom3D(lambda x, y, z: 1.5 - 0.5 * y * y
                                          + 0.0 * x * z),
                      dtype=torch.float64, device="cpu", **kw)
    fig = tplots.plot_rays3d(res, box=(-1, 12, -2, 2, -2, 2),
                             save=str(tmp_path / "r3.png"))
    assert (tmp_path / "r3.png").stat().st_size > 0
    assert_same_lines(fig, jplots.plot_rays3d(jres,
                                              box=(-1, 12, -2, 2, -2, 2)))
    with pytest.raises(ValueError, match="history"):
        tplots.plot_rays3d(res._replace(history=None))


def test_cli_eigenrays3(capsys, tmp_path):
    """--eigenrays3 lifts the measured profile to 3-D: JAX's arrivals and
    TL lines; a 2-D grid file and a missing receiver refused."""
    wg = _waveguide(tmp_path)
    args = ["--medium-file", wg, "--op", "6", "--delta-s-value", "0.04",
            "--steps", "210", "--family", "c1", "--eigenrays3", "0", "0", "0",
            "--receiver3", "6", "0", "0.3", "--fan3", "-0.4", "0.4", "7",
            "-0.4", "0.4", "7", "--omega", "40"]
    res = tcli.main(args + ["--device", "cpu"])
    t = capsys.readouterr().out
    jres = jcli.main(args)
    j = capsys.readouterr().out
    assert "lifted to 3-D" in t and "TL incoherent" in t
    assert len(np.asarray(res.traveltime)) >= 1
    assert bool(np.all(np.asarray(res.converged)))
    np.testing.assert_allclose(np.asarray(res.traveltime),
                               np.asarray(jres.traveltime), atol=TOL)
    tl = r"TL incoherent\s+(\S+) dB"
    assert number(tl, t) == pytest.approx(number(tl, j), abs=0.01)

    np.savez(tmp_path / "grid.npz", samples=np.ones((8, 9)),
             x=np.linspace(0, 1, 9), y=np.linspace(0, 1, 8))
    with pytest.raises(SystemExit):
        tcli.main(["--medium-file", str(tmp_path / "grid.npz"), "--op", "6",
                   "--delta-s-value", "0.02", "--steps", "40",
                   "--eigenrays3", "0", "0.5", "0", "--receiver3", "1",
                   "0.5", "0", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(["--medium-file", wg, "--op", "6", "--delta-s-value",
                   "0.02", "--steps", "40", "--eigenrays3", "0", "0", "0",
                   "--device", "cpu"])
