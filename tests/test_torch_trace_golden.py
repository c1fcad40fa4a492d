"""The port's scan tier against the JAX scan tier at float64 for the
golden-section and Newton ops: op5/op9 on the isotropic scenarios and
op10/op11/op10n/op11n on the anisotropic one, in both output modes."""
import pytest
from test_torch_trace import assert_parity, run_both


@pytest.mark.parametrize("mode", ["history", "metrics"])
@pytest.mark.parametrize("scen_name", ["interface", "vert", "fisheye"])
@pytest.mark.parametrize("op", ["op5", "op9"])
def test_golden_scan_tier_matches_jax_f64(op, scen_name, mode):
    jres, tres, _, _ = run_both(op, scen_name, mode)
    assert_parity(jres, tres, mode)


@pytest.mark.parametrize("mode", ["history", "metrics"])
@pytest.mark.parametrize("op", ["op10", "op11", "op10n", "op11n"])
def test_aniso_scan_tier_matches_jax_f64(op, mode):
    # the Newton ops take three nested-jvp solves a step: a shorter run
    s_max = 1.0 if op.endswith("n") else None
    jres, tres, _, _ = run_both(op, "aniso", mode, s_max=s_max)
    assert_parity(jres, tres, mode)
