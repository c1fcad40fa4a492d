"""The TL field map's twin (examples/tl_field_map_torch.py) on the CPU,
called in this process at the argv of tests/test_examples.py, with that
file's markers and asserts and the map's figure."""
import pytest
from torch_examples_helpers import twin

torch = pytest.importorskip("torch")


def test_tl_field_map_example(capsys, tmp_path):
    pytest.importorskip("matplotlib")
    twin("tl_field_map").main(["9", "7", "128", str(tmp_path / "m.png"),
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip().endswith("ok")
    assert "duct trapping" in out
    assert (tmp_path / "m.png").stat().st_size > 0
