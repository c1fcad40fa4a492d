"""Loading the example twins (examples/*_torch.py) as modules, so that the
tests call each twin's ``main(argv)`` in the test's own process."""
import importlib.util
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def twin(name):
    """The module of ``examples/<name>_torch.py``."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
