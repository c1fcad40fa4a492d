"""The example twins of measured media (examples/measured_medium_torch.py,
examples/transmission_loss_torch.py) on the CPU, called in this process at
the argv of tests/test_examples.py, with that file's markers and asserts
(the port's grid engine is ``grid`` where JAX's is ``grid-tiled``)."""
import re

import pytest
from torch_examples_helpers import twin

torch = pytest.importorskip("torch")


def test_measured_medium_example(capsys):
    twin("measured_medium").main(["4096", "150", "--device", "cpu"])
    out = capsys.readouterr().out
    # both media take the grid kernel, and the C1 medium tracks the smooth
    # truth at least as well as the parity pipeline
    assert out.count("[grid]") == 2, out
    devs = {m[1]: float(m[2]) for m in
            re.finditer(r"(\w+)\s+max trajectory deviation.*?: ([\d.e+-]+)",
                        out)}
    assert devs["c1"] <= devs["parity"], devs
    assert "df32+c1 deviation" in out


def test_transmission_loss_example(capsys):
    twin("transmission_loss").main(["6", "160", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip().endswith("ok")
    assert "free cylindrical would be" in out
