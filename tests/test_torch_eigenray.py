"""The port's eigenray solver (raytracing_tpu_torch.engine.eigenray) against
the JAX package's find_eigenrays at float64: the homogeneous medium (one
straight arrival), the Slotnick two-point traveltime on the linear-velocity
field, the parabolic waveguide's multipath, a reduced transmission-loss map
on the Munk profile; the field reductions; the empty case; and the CLI's
``--eigenrays`` path with its parser errors.  A custom medium cannot cross
between the packages (it is a function), so each package's formula is
written here once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers as H

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu import cli as jcli  # noqa: E402
from raytracing_tpu.engine import eigenray as jeig  # noqa: E402
from raytracing_tpu.media import c1 as jc1  # noqa: E402
from raytracing_tpu.media.medium import CustomMedium as JCustom  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import cli as tcli  # noqa: E402
from raytracing_tpu_torch.engine import eigenray as teig  # noqa: E402


def homog():
    return (JCustom(lambda x, y: jnp.ones_like(x) + 0.0 * y),
            rtt.CustomMedium(lambda x, y: torch.ones_like(x) + 0.0 * y,
                             lambda x, y: (0.0 * x, 0.0 * y)))


def waveguide():
    return (JCustom(lambda x, y: 1.5 - 0.5 * y * y + 0.0 * x),
            rtt.CustomMedium(lambda x, y: 1.5 - 0.5 * y * y + 0.0 * x,
                             lambda x, y: (0.0 * x, -y)))


def munk():
    """The Munk-style sound-speed profile of examples/tl_field_map.py, as an
    index profile (121 samples over 3 depth units)."""
    depth = np.linspace(-3.0, 0.0, 121)
    eta = 2.0 * (depth + 1.0)
    c = 1.49 * (1.0 + 0.0057 * (eta - 1.0 + np.exp(-eta)))
    return c.min() / c, depth


def solve_both(op, media, **kw):
    jm, tm = media
    j = jeig.find_eigenrays(op, jm, **kw)
    t = teig.find_eigenrays(op, tm, device="cpu", **kw)
    return j, t


def assert_same(j, t):
    """Equal arrival sets: counts, receivers and KMAH exactly; launch angle
    and traveltime to 1e-9, amplitude to 1e-7."""
    assert len(t.theta0) == len(j.theta0)
    # both come sorted by receiver, then traveltime; a symmetric pair's
    # equal traveltimes may tie either way, so compare in launch-angle order
    jo = np.lexsort((np.asarray(j.theta0), np.asarray(j.receiver)))
    to = np.lexsort((t.theta0, t.receiver))
    for f in ("receiver", "kmah", "converged"):
        np.testing.assert_array_equal(getattr(t, f)[to],
                                      np.asarray(getattr(j, f))[jo],
                                      err_msg=f)
    for f, tol in (("theta0", 1e-9), ("traveltime", 1e-9), ("q", 1e-7),
                   ("angle", 1e-9), ("n", 1e-9), ("n0", 1e-12),
                   ("amplitude", 1e-7)):
        np.testing.assert_allclose(getattr(t, f)[to],
                                   np.asarray(getattr(j, f))[jo],
                                   atol=tol, rtol=0, err_msg=f)
    assert len(t.theta0) == 0 or np.abs(t.y_err).max() < 1e-6


def test_homogeneous_single_eigenray_exact():
    j, t = solve_both("op6", homog(), source=(0, 0), receivers=[(3, 1)],
                      delta_s=0.02, max_size=200, box=(-1, 5, -2, 3),
                      fan=(0.0, 1.2, 64), tol=1e-12)
    assert_same(j, t)
    assert len(t.theta0) == 1 and bool(t.converged[0])
    assert t.theta0[0] == pytest.approx(np.arctan2(1, 3), abs=1e-11)
    assert t.traveltime[0] == pytest.approx(np.sqrt(10), abs=1e-11)
    assert t.amplitude[0] == pytest.approx(10 ** -0.25, abs=1e-11)
    assert t.kmah[0] == 0


def test_linear_velocity_slotnick_traveltime():
    """v = 18 + 2y: the arccosh two-point formula, to integrator accuracy."""
    j, t = solve_both("op6", (rt.analytic_medium("vert_heterogeneous"),
                              rtt.analytic_medium("vert_heterogeneous")),
                      source=(0, 0), receivers=[(3, -1)], delta_s=0.005,
                      max_size=2000, box=(-2, 5, -2.5, 1),
                      fan=(-1.2, 0.6, 128), tol=1e-12)
    assert_same(j, t)
    vA, vB, d, g = 18.0, 16.0, np.sqrt(10.0), 2.0
    t_exact = np.arccosh(1 + g * g * d * d / (2 * vA * vB)) / g
    assert t.traveltime[0] == pytest.approx(t_exact, rel=2e-7)
    assert abs(t.y_err[0]) < 1e-10


def test_parabolic_waveguide_multipath():
    """On-axis source and receiver at range 60: the axial arrival and two
    symmetric pairs, some through caustics (a coarse step keeps the run
    short; the arrival structure is that of the 0.02 step)."""
    j, t = solve_both("op6", waveguide(), source=(0, 0),
                      receivers=[(60.0, 0.0)], delta_s=0.2, max_size=430,
                      box=(-1, 63, -1.5, 1.5), fan=(-0.6, 0.6, 192))
    assert_same(j, t)
    assert len(t.theta0) == 5 and t.converged.all()
    off = np.abs(t.theta0) > 1e-6
    taus = np.sort(t.traveltime[off])
    np.testing.assert_allclose(taus[0::2], taus[1::2], rtol=1e-9)
    assert (t.kmah > 0).any()


@pytest.fixture(scope="module")
def tl_map():
    """A reduced TL field map: 4 ranges x 3 depths, fan 64, on the C1
    Munk profile at float64, source on the channel axis."""
    samples, depth = munk()
    jm = jc1.c1_stratified_from_samples(samples, depth, dtype=np.float64)
    ranges = np.linspace(4.0, 10.0, 4)
    depths = np.linspace(-2.0, -0.4, 3)
    receivers = np.stack(np.meshgrid(ranges, depths, indexing="ij"),
                         -1).reshape(-1, 2)
    kw = dict(source=(0.0, -1.0), receivers=receivers, delta_s=0.01,
              max_size=int(ranges.max() / 0.01 * 1.2),
              box=(-1.0, ranges.max() + 2.0, -3.0, 0.0),
              fan=(-0.3, 0.3, 64), tol=1e-7)
    return solve_both("op6", (jm, H.port_medium(jm)), **kw), len(receivers)


def test_tl_map_matches_jax(tl_map):
    (j, t), k = tl_map
    assert_same(j, t)
    assert len(np.unique(t.receiver)) > k // 2


def test_field_reductions_match_jax(tl_map):
    (j, t), k = tl_map
    np.testing.assert_allclose(teig.pressure(t, 50.0, k),
                               jeig.pressure(j, 50.0, k), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(teig.coherent_tl(t, 50.0, k),
                               jeig.coherent_tl(j, 50.0, k), atol=1e-5)
    np.testing.assert_allclose(teig.incoherent_tl(t, k),
                               jeig.incoherent_tl(j, k), atol=1e-7)
    e0 = t.for_receiver(int(t.receiver[0]))
    assert (e0.receiver == t.receiver[0]).all()


def test_no_arrivals_is_empty_not_error():
    eig = teig.find_eigenrays("op6", homog()[1], source=(0, 0),
                              receivers=[(-3.0, 0.0)], delta_s=0.05,
                              max_size=60, box=(-5, 5, -5, 5),
                              fan=(0.0, 1.0, 16), device="cpu")
    assert len(eig.theta0) == 0
    assert np.isinf(teig.incoherent_tl(eig, n_receivers=1)).all()
    # mesh= (ROADMAP.md §1 item 18, done): on a one-rank CPU mesh the
    # solver gives the call without one, to the bit
    import torch_dist_helpers as D

    kw = dict(source=(0, 0), receivers=[(1.0, 0.5), (-3.0, 0.0)],
              delta_s=0.05, max_size=60, box=(-5, 5, -5, 5),
              fan=(0.0, 1.0, 16), device="cpu")
    one = teig.find_eigenrays("op6", homog()[1], **kw)
    with D.one_rank_mesh() as mesh:
        meshed = teig.find_eigenrays("op6", homog()[1], mesh=mesh, **kw)
    assert len(one.theta0) == 1
    for f in one._fields:
        np.testing.assert_array_equal(getattr(meshed, f), getattr(one, f),
                                      err_msg=f)


@pytest.fixture
def profile_file(tmp_path):
    samples, depth = munk()
    path = tmp_path / "munk.npz"
    np.savez(path, samples=samples, y=depth)
    return str(path)


def test_cli_eigenrays_matches_jax(profile_file):
    args = ["--medium-file", profile_file, "--family", "c1", "--op", "6",
            "--delta-s-value", "0.01", "--steps", "600", "--eigenrays", "0",
            "-1", "--receiver", "4", "-1", "--receiver", "5", "-1.5",
            "--fan", "-0.3", "0.3", "48", "--box", "-1", "7", "-3", "0",
            "--omega", "40"]
    lines = []
    t = tcli.main(args + ["--device", "cpu"])
    j = jcli.main(args)
    assert_same(j, t)
    assert len(t.theta0) >= 2
    tcli.run_eigenrays_file(profile_file, "op6", delta_s=0.01, steps=600,
                            source=(0, -1), receivers=[(4, -1)],
                            fan=(-0.3, 0.3, 48), box=(-1, 7, -3, 0),
                            omega=40.0, family="c1", device="cpu",
                            printer=lines.append)
    assert any("TL incoherent" in s and "coherent" in s for s in lines)


@pytest.mark.parametrize("extra,msg", [
    (["--scenario", "vert", "--eigenrays", "0", "-1"], "needs --medium-file"),
    (["--medium-file", "x.npz", "--eigenrays", "0", "-1", "--calibrate",
      "1e-3"], "mutually exclusive"),
    (["--medium-file", "x.npz", "--eigenrays", "0", "-1", "--op", "6",
      "--delta-s-value", "0.01", "--steps", "10"], "needs --receiver"),
    (["--medium-file", "x.npz", "--eigenrays3", "0", "0", "-1"],
     "--eigenrays3 needs --op"),
])
def test_cli_parser_errors(extra, msg, capsys):
    with pytest.raises(SystemExit):
        tcli.main(extra + ["--device", "cpu"])
    assert msg in capsys.readouterr().err


def test_cli_refuses_golden_ops(profile_file):
    with pytest.raises(SystemExit, match="golden-section"):
        tcli.main(["--medium-file", profile_file, "--op", "5",
                   "--delta-s-value", "0.01", "--steps", "10",
                   "--eigenrays", "0", "-1", "--receiver", "5", "-1",
                   "--device", "cpu"])
