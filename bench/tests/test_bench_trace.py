"""Reading a profiler trace: spans, launch correlation, busy time and idle
gaps, on a hand-made Chrome trace."""
import json

import pytest

from bench import trace


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ph": "X", "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def tr(tmp_path):
    events = [
        _ev("user_annotation", "bench.window", 100.0, 1000.0),
        _ev("user_annotation", "bench.pump", 100.0, 600.0),
        _ev("user_annotation", "bench.traverse", 110.0, 50.0),
        _ev("user_annotation", "bench.project", 300.0, 350.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 120.0, 2.0, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 130.0, 2.0, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 200.0, 2.0, corr=3),
        _ev("kernel", "hop", 150.0, 100.0, corr=1),
        _ev("kernel", "hop", 250.0, 50.0, corr=2),
        _ev("gpu_memcpy", "copy", 320.0, 30.0, corr=3),
        _ev("kernel", "outside", 2000.0, 10.0, corr=9),
        _ev("user_annotation", "other", 0.0, 5.0),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return trace.read_trace(str(p))


def test_window_spans_and_busy(tr):
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.span_count("traverse") == 1 and tr.span_count("project") == 1
    assert "other" not in tr.spans
    assert tr.busy_s() == pytest.approx((150 + 30) * 1e-6)
    assert [o.name for o in tr.ops] == ["hop", "hop", "copy"]


def test_device_time_follows_the_launch_not_the_kernel_time(tr):
    # both kernels were launched inside traverse, though they ran after it
    assert tr.device_s("traverse") == pytest.approx(150e-6)
    # the copy was launched in pump, outside traverse and project
    assert tr.device_s("pump") == pytest.approx(30e-6)
    assert tr.device_s("project") == 0


def test_idle_gaps_named_by_the_host_span(tr):
    gaps = tr.idle_gaps()
    assert gaps[0] == ["project", pytest.approx(750e-6)]
    assert sum(g for _, g in gaps) == pytest.approx(1000e-6 - tr.busy_s())
    names = dict((round(s * 1e6), n) for n, s in gaps)
    assert names[50] == "pump"              # before the first kernel
    assert tr.top_ops()[0] == ("hop", pytest.approx(150e-6))


def test_a_trace_without_a_window_is_refused(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError):
        trace.read_trace(str(p))


def test_spans_wrap_and_restore():
    class Box:
        def f(self, x):
            return x + 1
    import sys
    import types
    mod = types.ModuleType("bench_span_target")
    mod.Box = Box
    sys.modules["bench_span_target"] = mod
    try:
        orig = Box.__dict__["f"]
        s = trace.Spans({"f": "bench_span_target:Box.f"})
        assert Box.__dict__["f"] is not orig and Box().f(1) == 2
        s.restore()
        assert Box.__dict__["f"] is orig
    finally:
        del sys.modules["bench_span_target"]
