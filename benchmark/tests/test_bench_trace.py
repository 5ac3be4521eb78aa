"""The reduction of a profiler trace: busy time as the union of device
intervals inside the window, idle gaps named by the host call that
overlaps them most, the runtime calls summed by name, and the readers
that take their metrics from it."""

import json

from benchmark.harness.spec import load_reader
from benchmark.harness.trace import WINDOW, summarize


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_summary_of_a_small_trace(tmp_path):
    events = [
        _ev(WINDOW, "user_annotation", 1000.0, 1000.0),            # the window: 1 ms
        _ev("k1", "kernel", 900.0, 300.0),                         # clipped to 1000..1200
        _ev("k2", "kernel", 1100.0, 200.0),                        # overlaps k1: union to 1300
        _ev("copy", "gpu_memcpy", 1600.0, 150.0),                   # then a gap 1750..2000
        _ev("cudaFree", "cuda_runtime", 1300.0, 250.0),            # the gap 1300..1600
        _ev("aten::mul", "cpu_op", 1290.0, 200.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 1750.0, 10.0),
        _ev("k3", "kernel", 2500.0, 100.0),                        # outside the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(path))
    assert abs(s["busy_s"] - 450e-6) < 1e-12 and abs(s["window_s"] - 1e-3) < 1e-12
    assert s["kernels"] == 2
    assert s["idle_gaps"][0][0] == "cudaFree" and abs(s["idle_gaps"][0][1] - 300e-6) < 1e-12
    assert s["idle_gaps"][1][0] == "cudaLaunchKernel" and len(s["idle_gaps"]) == 2
    assert abs(s["runtime_s"]["cudaFree"] - 250e-6) < 1e-12
    assert abs(s["runtime_s"]["cudaLaunchKernel"] - 10e-6) < 1e-12
    obs = {"trace": s, "calls": 2, "entry": "serve"}
    assert abs(load_reader("synthesis.cuda_free_ms").read(obs) - 0.125) < 1e-9
    assert abs(load_reader("device.idle_pct").read(obs) - 55.0) < 1e-9


def test_a_trace_without_device_work_gives_nothing(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_ev(WINDOW, "user_annotation", 0.0, 10.0),
                                                _ev("cudaFree", "cuda_runtime", 1.0, 2.0)]}))
    assert summarize(str(path)) is None
    assert load_reader("synthesis.cuda_free_ms").read({"trace": None, "calls": 3}) is None
