"""Each per-layer reader on a small canned Chrome trace, against values
worked out by hand."""

from __future__ import annotations

import importlib

import pytest

from portbench.tracefile import Trace


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


# Two calls of 100 us.  The port's kernel of the first launch span is
# recorded (10 us), the second launch's record is lost; one torch kernel
# (10 us) is launched outside any launch span.  Copies: H->D 20 + 30 us,
# D->H 10 us.  Busy: 20 + 10 + 10 + 30 + 10 = 80 of 200 us.
CANNED = {"traceEvents": [
    _x("portbench.call", "user_annotation", 0, 100),
    _x("portbench.call", "user_annotation", 100, 100),
    _x("portbench.call", "gpu_user_annotation", 0, 200, tid=7),
    _x("vlc_fused4_launch", "user_annotation", 10, 10),
    _x("vlc_fused4_launch", "user_annotation", 110, 10),
    _x("cudaLaunchKernel", "cuda_runtime", 12, 2, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 112, 2, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 45, 2, correlation=3),
    _x("vlc_slots_kernel", "kernel", 30, 10, tid=7, correlation=1),
    _x("elementwise_kernel", "kernel", 50, 10, tid=7, correlation=3),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 20, tid=7),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 100, 30, tid=7),
    _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 180, 10, tid=7),
    _x("aten::copy_", "cpu_op", 130, 45),
    {"ph": "i", "name": "instant", "ts": 5},
]}
CTX = {"calls": 2, "least_s": 6e-6}


@pytest.mark.parametrize("metric,value", [
    ("device_idle_pct", 60.0),
    ("kernels_roofline_pct", 20.0),   # 6 us of least time against 10 + 10 + 10 (lost) us
    ("h2d_ms", 0.025),
    ("d2h_ms", 0.005),
])
def test_reader_on_canned_trace(metric, value):
    read = importlib.import_module(f"portbench.layer_metrics.{metric}").read
    assert read(Trace(CANNED), CTX) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("metric", ["device_idle_pct", "kernels_roofline_pct", "h2d_ms", "d2h_ms"])
def test_reader_finds_nothing_in_a_host_only_trace(metric):
    doc = {"traceEvents": [e for e in CANNED["traceEvents"]
                           if e.get("cat") not in ("kernel", "gpu_memcpy")]}
    read = importlib.import_module(f"portbench.layer_metrics.{metric}").read
    assert read(Trace(doc), CTX) is None


def test_launch_accounting_and_breakdown():
    tr = Trace(CANNED)
    assert tr.calls == 2 and tr.window_us == 200
    assert tr.port_kernels() == {"vlc_fused4_launch": {"launches": 2, "recorded": 1, "us": 10.0}}
    scaled, recorded, _ = tr.kernel_us()
    assert (scaled, recorded) == (30.0, 20.0)
    assert tr.top_device_ops(2) == [["Memcpy HtoD (Pageable -> Device)", 50e-6],
                                    ["vlc_slots_kernel", 10e-6]]
    assert tr.idle_by_host_span() == [["portbench.call", 70e-6], ["aten::copy_", 45e-6 + 5e-6]]
