"""The 3-D eigenray solver (engine/eigenray3d.py) against the JAX package's
at float64: the homogeneous single arrival and the empty case of
tests/test_eigenray3d.py, a short stratified waveguide with several
arrivals, the CLI's --eigenrays3 on a measured profile lifted to 3-D, its
refusal of a 2-D grid file and its parser errors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers  # noqa: F401  (one torch thread)

torch = pytest.importorskip("torch")

from raytracing_tpu import cli as jcli  # noqa: E402
from raytracing_tpu.engine import eigenray3d as jeig3  # noqa: E402
from raytracing_tpu.media import fields3d as jf3  # noqa: E402
from raytracing_tpu.media.medium import CustomMedium as JCustom  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import cli as tcli  # noqa: E402
from raytracing_tpu_torch.engine import eigenray as teig  # noqa: E402
from raytracing_tpu_torch.engine import eigenray3d as teig3  # noqa: E402

CPU = dict(device="cpu")


def homog3():
    return (jf3.Custom3D(lambda x, y, z: jnp.ones_like(x)),
            rtt.Custom3D(lambda x, y, z: torch.ones_like(x)))


def guide3():
    def n2(lib):
        return lambda x, y: 1.5 - 0.5 * y * y + 0.0 * x
    return (jf3.Stratified3D(JCustom(n2(jnp))),
            rtt.Stratified3D(rtt.CustomMedium(n2(torch))))


def assert_same(t, j, n_min=1):
    """Same arrivals, traveltime and launch direction within 1e-9 (the
    amplitudes, det Q and KMAH too)."""
    assert len(t.traveltime) == len(j.traveltime) >= n_min
    np.testing.assert_array_equal(t.receiver, np.asarray(j.receiver))
    for f in ("traveltime", "dir0", "detq", "amplitude", "n", "n0"):
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(j, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(t.kmah, np.asarray(j.kmah))
    np.testing.assert_array_equal(t.converged, np.asarray(j.converged))


def test_homogeneous_single_arrival_exact():
    """tests/test_eigenray3d.py:27-42 on the port, and against JAX."""
    r = np.array([3.0, 1.0, -0.5])
    kw = dict(source=(0, 0, 0), receivers=[r], delta_s=0.02, max_size=250,
              box=(-1, 5, -3, 3, -3, 3), fan=(-0.5, 0.5, 17, -0.5, 0.5, 17))
    jm, tm = homog3()
    eig = teig3.find_eigenrays3("op1", tm, **kw, **CPU)
    assert len(eig.traveltime) == 1 and bool(eig.converged[0])
    d = np.linalg.norm(r)
    np.testing.assert_allclose(eig.dir0[0], r / d, atol=1e-12)
    assert abs(eig.traveltime[0] - d) < 1e-12
    assert abs(eig.amplitude[0] - 1 / d) < 2e-6
    assert eig.miss[0] < 1e-12 and eig.kmah[0] == 0
    assert np.isfinite(teig.incoherent_tl(eig, n_receivers=1)).all()
    assert_same(eig, jeig3.find_eigenrays3("op1", jm, **kw))


def test_no_arrivals_is_empty():
    jm, tm = homog3()
    kw = dict(source=(0, 0, 0), receivers=[(-5.0, 0.0, 0.0)], delta_s=0.1,
              max_size=50, box=(-6, 6, -6, 6, -6, 6),
              fan=(-0.2, 0.2, 7, -0.2, 0.2, 7))
    eig = teig3.find_eigenrays3("op1", tm, **kw, **CPU)
    assert len(eig.traveltime) == 0 and eig.dir0.shape == (0, 3)
    assert np.isinf(teig.incoherent_tl(eig, n_receivers=1)).all()
    assert len(jeig3.find_eigenrays3("op1", jm, **kw).traveltime) == 0


def test_stratified_waveguide_matches_jax():
    """A parabolic waveguide lifted to 3-D, two receivers off the source
    plane, 400 steps and a 9 x 9 fan: the same arrivals as JAX's solver,
    traveltime and direction within 1e-9; coherent and incoherent TL
    finite."""
    jm, tm = guide3()
    rec = np.array([[6.0, 0.3, 0.4], [5.0, -0.2, -0.3]])
    kw = dict(source=(0.0, 0.0, 0.0), receivers=rec, delta_s=0.02,
              max_size=400, box=(-1, 9, -1.5, 1.5, -2, 2),
              center_dir=(1.0, 0.0, 0.0), fan=(-0.6, 0.6, 9, -0.6, 0.6, 9))
    t = teig3.find_eigenrays3("op6", tm, **kw, **CPU)
    j = jeig3.find_eigenrays3("op6", jm, **kw)
    assert_same(t, j, n_min=2)
    assert set(t.receiver.tolist()) == {0, 1} and bool(t.converged.all())
    assert np.isfinite(teig.incoherent_tl(t, n_receivers=2)).all()
    assert np.isfinite(teig.coherent_tl(t, 40.0, n_receivers=2)).all()
    # mesh= (ROADMAP.md §1 item 18, done): on a one-rank CPU mesh the
    # solver gives the call without one, to the bit
    import torch_dist_helpers as D
    with D.one_rank_mesh() as mesh:
        meshed = teig3.find_eigenrays3("op6", tm, mesh=mesh, **kw, **CPU)
    for f in t._fields:
        np.testing.assert_array_equal(getattr(meshed, f), getattr(t, f),
                                      err_msg=f)


# -- the CLI's --eigenrays3 (cli.py:336-394, :627-658) ---------------------

@pytest.fixture
def profile_file(tmp_path):
    """The Munk-style profile of examples/tl_field_map.py as an .npz."""
    depth = np.linspace(-3.0, 0.0, 121)
    eta = 2.0 * (depth + 1.0)
    c = 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))
    path = tmp_path / "munk.npz"
    np.savez(path, samples=c.min() / c, y=depth)
    return str(path)


def test_cli_eigenrays3_matches_jax(profile_file):
    """The working flag: the same arrivals as JAX's CLI on the Munk profile
    lifted to 3-D, two receivers off the source plane; TL lines printed."""
    args = ["--medium-file", profile_file, "--family", "c1", "--op", "6",
            "--delta-s-value", "0.01", "--steps", "500", "--eigenrays3", "0",
            "-1", "0", "--receiver3", "4", "-1", "0.3", "--receiver3", "4.5",
            "-1.3", "-0.4", "--fan3", "-0.3", "0.3", "7", "-0.3", "0.3", "7",
            "--omega", "40"]
    t = tcli.main(args + ["--device", "cpu"])
    j = jcli.main(args)
    assert_same(t, j, n_min=2)
    lines = []
    tcli.run_eigenrays3_file(profile_file, "op6", delta_s=0.01, steps=500,
                             source=(0, -1, 0), receivers=[(4, -1, 0.3)],
                             fan=(-0.3, 0.3, 7, -0.3, 0.3, 7), omega=40.0,
                             family="c1", device="cpu", printer=lines.append)
    assert any("lifted to 3-D" in s for s in lines)
    assert any("TL incoherent" in s and "coherent" in s for s in lines)


def test_cli_eigenrays3_refuses_a_2d_grid(tmp_path):
    """JAX's refusal of a 2-D grid file (cli.py:357-360)."""
    x = np.linspace(-2.0, 2.0, 9)
    y = np.linspace(-2.0, 2.0, 9)
    path = tmp_path / "grid.npz"
    np.savez(path, samples=1.0 + 0.01 * np.add.outer(y, x), x=x, y=y)
    args = ["--medium-file", str(path), "--op", "6", "--delta-s-value",
            "0.01", "--steps", "10", "--eigenrays3", "0", "0", "0",
            "--receiver3", "1", "0", "0"]
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit, match="lifts 1-D PROFILES"):
            main(args + extra)


@pytest.mark.parametrize("extra,msg", [
    (["--eigenrays3", "0", "0", "0"], "--eigenrays3 needs --medium-file"),
    (["--medium-file", "x.npz", "--eigenrays3", "0", "0", "-1"],
     "--eigenrays3 needs --op, --delta-s-value, --steps, --receiver3"),
    (["--medium-file", "x.npz", "--eigenrays3", "0", "0", "-1", "--op", "6",
      "--delta-s-value", "0.01", "--steps", "10"],
     "--eigenrays3 needs --receiver3"),
])
def test_cli_eigenrays3_parser_errors_match_jax(extra, msg, capsys):
    for main, dev in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit) as e:
            main(extra + dev)
        assert e.value.code == 2
        assert msg in capsys.readouterr().err


def test_cli_eigenrays3_refuses_a_planar_op(profile_file):
    with pytest.raises(ValueError, match="planar"):
        tcli.main(["--medium-file", profile_file, "--op", "5",
                   "--delta-s-value", "0.01", "--steps", "10",
                   "--eigenrays3", "0", "-1", "0", "--receiver3", "4", "-1",
                   "0", "--device", "cpu"])
