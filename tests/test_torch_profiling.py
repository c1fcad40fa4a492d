"""The port's profiling utilities (raytracing_tpu_torch/utils/profiling.py)
against the JAX package's tests/test_profiling.py, and ``device_trace``
writing a trace on the CPU."""
import json

import pytest
import torch_port_helpers  # noqa: F401  (one torch thread a worker)

torch = pytest.importorskip("torch")

from raytracing_tpu.utils import profiling as jprof  # noqa: E402

from raytracing_tpu_torch.utils.profiling import (  # noqa: E402
    StepRate, device_trace, step_timer)


def test_step_timer_sink():
    sink = []
    with step_timer(1000, sink=sink):
        sum(range(10000))
    assert len(sink) == 1
    r = sink[0]
    assert isinstance(r, StepRate)
    assert r.ray_steps == 1000 and r.seconds > 0
    assert abs(r.rate - 1000 / r.seconds) < 1e-6


def test_step_timer_prints(capsys):
    with step_timer(500):
        pass
    out = capsys.readouterr().out
    assert "ray-steps/s" in out


def test_step_rate_and_output_match_jax(capsys):
    """The same fields, and the same printed line up to the seconds."""
    assert StepRate._fields == jprof.StepRate._fields
    with step_timer(500, device="cpu"):
        pass
    with jprof.step_timer(500):
        pass
    ours, theirs = capsys.readouterr().out.splitlines()
    assert ours.split(" in ")[0] == theirs.split(" in ")[0]
    assert ours.split("->")[1].split()[1] == theirs.split("->")[1].split()[1]


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    """A Chrome trace (TensorBoard's and Perfetto's format) naming the
    block's operations, and the profiler's event table."""
    a = torch.arange(1000, dtype=torch.float32)
    with device_trace(str(tmp_path)) as prof:
        b = torch.sin(a) * 2.0
    assert float(b[1]) == pytest.approx(2.0 * 0.8414709848)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::sin" in names and "aten::mul" in names
    assert any(e.key == "aten::sin" for e in prof.key_averages())
