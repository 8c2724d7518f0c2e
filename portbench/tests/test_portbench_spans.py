"""`spans.span_us`, `spans.span_device_us` and the five readers built on
them, on a small canned Chrome trace, against values worked out by hand."""

from __future__ import annotations

import importlib

import pytest

from portbench.spans import span_device_us, span_us
from portbench.tests.test_portbench_layer_metrics import CANNED as NO_ENCODE_SPANS
from portbench.tracefile import Trace


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


# Two calls of 100 us on thread 1.  In each, `encode.pad`, then
# `encode.enqueue` with `encode.levels` inside it, then `encode.assemble`.
# Launched inside `encode.levels`: a kernel of 12 us and a copy of 5 us
# (first call), a kernel of 8 us (second call); inside `encode.enqueue` but
# outside `encode.levels`: a kernel of 7 us.  Thread 2 has its own
# `encode.levels` and `encode.assemble` spans and a kernel of 20 us launched
# inside them, which must not count; an `encode.pad` that starts after the
# window must not count either.
CANNED = {"traceEvents": [
    _x("portbench.call", "user_annotation", 0, 100),
    _x("portbench.call", "user_annotation", 100, 100),
    _x("encode.pad", "user_annotation", 1, 9),
    _x("encode.pad", "user_annotation", 101, 10),
    _x("encode.enqueue", "user_annotation", 20, 40),
    _x("encode.levels", "user_annotation", 25, 20),
    _x("encode.enqueue", "user_annotation", 115, 40),
    _x("encode.levels", "user_annotation", 120, 20),
    _x("encode.assemble", "user_annotation", 70, 20),
    _x("encode.assemble", "user_annotation", 170, 25),
    _x("encode.pad", "user_annotation", 250, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 30, 2, correlation=1),
    _x("cudaMemcpyAsync", "cuda_runtime", 40, 2, correlation=3),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 2, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 125, 2, correlation=5),
    _x("dct_kernel", "kernel", 33, 12, tid=7, correlation=1),
    _x("pack_kernel", "kernel", 52, 7, tid=7, correlation=2),
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 46, 5, tid=7, correlation=3),
    _x("dct_kernel", "kernel", 128, 8, tid=7, correlation=5),
    _x("encode.levels", "user_annotation", 0, 200, tid=2),
    _x("encode.assemble", "user_annotation", 60, 30, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 70, 2, tid=2, correlation=4),
    _x("dct_kernel", "kernel", 72, 20, tid=7, correlation=4),
    _x("portbench.call", "gpu_user_annotation", 0, 200, tid=7),
]}
CTX = {"calls": 2, "least_s": 6e-6}


def test_span_us_on_the_calling_thread_in_the_window():
    tr = Trace(CANNED)
    assert span_us(tr, "encode.pad") == 19
    assert span_us(tr, "encode.assemble") == 45
    assert span_us(tr, "encode.levels") == 40
    assert span_us(tr, "encode.intake") is None


def test_span_device_us_counts_what_was_launched_inside():
    tr = Trace(CANNED)
    assert span_device_us(tr, "encode.levels") == 12 + 5 + 8
    assert span_device_us(tr, "encode.enqueue") == 12 + 5 + 7 + 8
    assert span_device_us(tr, "encode.pad") == 0
    assert span_device_us(tr, "encode.intake") is None


@pytest.mark.parametrize("metric,value", [
    ("host_pad_ms", 0.0095),
    ("assemble_ms", 0.0225),
    ("levels_ms", 0.0125),
    ("host_color_ms", None),
    ("intake_ms", None),
])
def test_reader_on_canned_trace(metric, value):
    got = importlib.import_module(f"portbench.layer_metrics.{metric}").read(Trace(CANNED), CTX)
    assert got == (None if value is None else pytest.approx(value, rel=1e-12))


def test_intake_and_color_readers_on_their_spans():
    events = [e for e in CANNED["traceEvents"] if e["name"] not in ("encode.levels",)]
    events += [_x("encode.intake", "user_annotation", 22, 30),
               _x("encode.color", "user_annotation", 110, 4)]
    tr = Trace({"traceEvents": events})

    def read(metric):
        return importlib.import_module(f"portbench.layer_metrics.{metric}").read(tr, CTX)

    assert read("intake_ms") == pytest.approx((12 + 5 + 7) / 1e3 / 2, rel=1e-12)
    assert read("host_color_ms") == pytest.approx(4 / 1e3 / 2, rel=1e-12)
    assert read("levels_ms") is None


@pytest.mark.parametrize("metric", ["host_pad_ms", "assemble_ms", "host_color_ms", "levels_ms",
                                    "intake_ms"])
def test_reader_finds_nothing_in_a_program_without_the_spans(metric):
    """A trace of a program that writes no `encode.*` span (the port before
    the spans) reads None, and nothing raises."""
    read = importlib.import_module(f"portbench.layer_metrics.{metric}").read
    assert read(Trace(NO_ENCODE_SPANS), CTX) is None
    assert read(Trace({"traceEvents": []}), {"calls": 0, "least_s": None}) is None
