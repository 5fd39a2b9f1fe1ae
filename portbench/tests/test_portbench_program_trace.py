"""The readers of the port's own tracer (``portbench/program_trace.py``):
on the tiny CPU cells the host-span metrics come back as numbers and the
device-stage metrics (no graph, no stamps on the CPU) are left out; the
traced stretch runs once a run, whatever number of readers call it; and a
port without the tracer gives None."""

import builtins
import types

import pytest

from portbench import program_trace
from portbench.bench import run_cell
from portbench.tests import tiny

HOST = {"tinyfleet.tiny": ["fleet_scalars_host_ms.fleet"],
        "tinyfleet2.tiny": ["fleet_scalars_host_ms.fleet", "summary_wait_ms.cards"],
        "tinylive.tiny": ["prep_host_ms.live", "fetch_wait_ms.vehicle"],
        "tinyreplay.tiny": ["fetch_wait_ms.vehicle"],
        "tinyfleet-sorted.tiny-sorted": ["fleet_scalars_host_ms.fleet"]}
DEVICE = ["spiral_device_ms.vehicle", "spiral_device_ms.fleet", "raster_device_ms.fleet",
          "sort_device_ms.fleet"]


@pytest.mark.parametrize("workload", sorted(HOST))
def test_traced_run_reports_the_host_spans_and_no_device_stage(tmp_path, workload):
    root = tiny.write(tmp_path)
    result = run_cell(root, workload, 2**31 + 3, 2.0, True, "cpu", log=lambda line: None)
    assert result["correct"] is True
    for name in HOST[workload]:
        assert result["metrics"][name]["value"] > 0 and result["metrics"][name]["unit"] == "ms"
    assert not set(DEVICE) & set(result["metrics"])
    from groundgrid_torch import trace

    assert not trace.enabled()


class _Loop:
    """A stand-in for a loop of ``portbench/loops.py``: each unit one
    ``runtime.prep`` span of the port's tracer."""

    unit_name = "scan"

    def __init__(self):
        self.calls = []

    def run(self, seconds, keep=True):
        from groundgrid_torch import trace

        self.calls.append((seconds, keep, trace.enabled()))
        with trace.span("runtime.prep"):
            pass
        return types.SimpleNamespace(units=1, scans=1, elapsed=seconds)


def _context():
    import torch

    return types.SimpleNamespace(loop=_Loop(), device=torch.device("cpu"))


def test_the_stretch_runs_once_a_context():
    cx = _context()
    first = program_trace.host_ms(cx, "runtime.prep")
    assert first is not None and first >= 0
    assert program_trace.host_ms(cx, "runtime.fetch.wait") is None  # no such span
    assert program_trace.device_ms(cx, "spiral") is None
    assert program_trace.host_ms(cx, "runtime.prep") == first
    # untraced, then warm-up and the measured stretch with tracing on
    assert cx.loop.calls == [(program_trace.SECONDS, False, False),
                             (program_trace.WARMUP_SECONDS, False, True),
                             (program_trace.SECONDS, False, True)]
    assert cx.program_trace["snapshot"]["spans"]["runtime.prep"]["count"] == 1
    from groundgrid_torch import trace

    assert not trace.enabled()


def test_a_port_without_the_tracer_gives_none(monkeypatch):
    real = builtins.__import__

    def no_tracer(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "groundgrid_torch" and fromlist and "trace" in fromlist:
            raise ImportError("cannot import name 'trace'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    cx = _context()
    assert program_trace.host_ms(cx, "runtime.prep") is None
    assert program_trace.device_ms(cx, "raster") is None
    assert cx.loop.calls == []
