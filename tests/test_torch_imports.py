"""The port imports nothing of JAX: every ``raytracing_tpu_torch/**/*.py`` and
``chip_smoke.py``, parsed with ``ast``, has no ``import`` or ``from ...
import`` of jax, jaxlib, flax or the JAX package ``raytracing_tpu`` (the
package or any submodule).  Names in comments and strings do not count."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_tpu")


def port_files():
    return sorted((ROOT / "raytracing_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def forbidden_imports(source: str) -> list:
    """Module names of the forbidden imports in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_the_guard_sees_what_it_must():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jaxlib import x\n"
           "from flax import struct\nimport raytracing_tpu\n"
           "from raytracing_tpu.media import grid\n"
           "import raytracing_tpu_torch\n"
           "from raytracing_tpu_torch.media import grid as g\n"
           "# import jax\nx = 'import raytracing_tpu'\n"
           "from . import fused\n")
    assert forbidden_imports(src) == [
        "jax", "jax.numpy", "jaxlib", "flax", "raytracing_tpu",
        "raytracing_tpu.media"]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


#: the search path's modules and the dynamic path's (the guard above parses
#: every port file; this pins that they exist and that importing them loads
#: no JAX module)
SEARCH_PATH = ("raytracing_tpu_torch.utils.checkpoint",
               "raytracing_tpu_torch.parallel.sweep",
               "raytracing_tpu_torch.cli",
               "raytracing_tpu_torch.engine.segmented",
               "raytracing_tpu_torch.engine.dynamic",
               "raytracing_tpu_torch.engine.eigenray",
               "raytracing_tpu_torch.kernels.dynamic",
               "raytracing_tpu_torch.interop")


def _import_without_jax(modules):
    """The modules exist, and importing them in a fresh process loads no
    JAX module."""
    import subprocess
    import sys

    names = {str(p.relative_to(ROOT)) for p in port_files()}
    for mod in modules:
        assert mod.replace(".", "/") + ".py" in names
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_search_path_modules_import_without_jax():
    _import_without_jax(SEARCH_PATH)


#: the 3-D kinematic tier's modules (fast.py routes fast_trace3)
PATH_3D = ("raytracing_tpu_torch.media.fields3d",
           "raytracing_tpu_torch.media.grid3",
           "raytracing_tpu_torch.engine.trace3d",
           "raytracing_tpu_torch.engine.tiled3",
           "raytracing_tpu_torch.kernels.fused3d",
           "raytracing_tpu_torch.engine.fast")


def test_3d_modules_import_without_jax():
    _import_without_jax(PATH_3D)


#: the 3-D dynamic tier's modules (fast.py routes fast_dynamic3, cli.py
#: runs --eigenrays3, bench/replay.py replays its plain step)
PATH_DYN3 = ("raytracing_tpu_torch.kernels.dynamic3d",
             "raytracing_tpu_torch.engine.dynamic3d",
             "raytracing_tpu_torch.engine.eigenray3d",
             "raytracing_tpu_torch.bench.replay")


def test_3d_dynamic_modules_import_without_jax():
    _import_without_jax(PATH_DYN3)


#: the differentiable tier, the 3-D df32 media, history streaming and
#: profiling, and the two example twins (examples/*_torch.py)
PATH_API = ("raytracing_tpu_torch.utils.profiling",
            "raytracing_tpu_torch.engine.streaming",
            "raytracing_tpu_torch.engine.df_grid3",
            "raytracing_tpu_torch.engine.diff")
EXAMPLE_TWINS = ("examples/inverse_medium_torch.py",
                 "examples/tomography_torch.py",
                 "examples/sampled_medium_production_torch.py",
                 "examples/eddy_3d_torch.py",
                 "examples/delta_s_search_torch.py",
                 "examples/million_ray_benchmark_torch.py",
                 "examples/measured_medium_torch.py",
                 "examples/wavefront_movie_torch.py",
                 "examples/ocean_waveguide_torch.py",
                 "examples/transmission_loss_torch.py",
                 "examples/tl_field_map_torch.py")


def test_api_modules_import_without_jax():
    _import_without_jax(PATH_API)


#: the serving layer: the model zoo and the HTTP server
PATH_SERVE = ("raytracing_tpu_torch.models", "raytracing_tpu_torch.serve")


def test_serve_modules_import_without_jax():
    _import_without_jax(PATH_SERVE)


#: the native spline library and the plots (matplotlib is imported only
#: when something is drawn)
PATH_DISPLAY = ("raytracing_tpu_torch.native.__init__",
                "raytracing_tpu_torch.viz.plots")


def test_native_and_viz_modules_import_without_jax():
    _import_without_jax(PATH_DISPLAY)
    code = ("import sys\nimport raytracing_tpu_torch.viz.plots\n"
            "assert 'matplotlib' not in sys.modules\n")
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", EXAMPLE_TWINS)
def test_example_twin_imports_no_jax(path):
    """The twins parse clean of JAX imports, and importing one loads no JAX
    module."""
    import subprocess
    import sys
    assert forbidden_imports((ROOT / path).read_text()) == []
    code = (f"import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('twin', "
            f"{str(ROOT / path)!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_jax_public_api_is_a_subset_of_the_port():
    """Every name of the JAX package's ``__all__`` is in the port's: the
    port's public API is whole."""
    import raytracing_tpu as rt
    import raytracing_tpu_torch as rtt
    assert sorted(set(rt.__all__) - set(rtt.__all__)) == []
    for name in rt.__all__:
        assert hasattr(rtt, name), name


#: the sharded path: the mesh over torch.distributed and data-parallel
#: tracing (fast.py's fast_trace_sharded and every mesh= entry point use
#: them), and the mesh tests' rank-side helper, which the ranks import
PATH_MESH = ("raytracing_tpu_torch.parallel.mesh",
             "raytracing_tpu_torch.parallel.distributed")


def test_mesh_modules_import_without_jax():
    _import_without_jax(PATH_MESH)
    helper = ROOT / "tests" / "torch_dist_helpers.py"
    assert forbidden_imports(helper.read_text()) == []
