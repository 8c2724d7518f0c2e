"""The pieces of `cbr1080.b50m.rgb`: the cached reference entry
(`reference/entries/encode_cbr.py`) against a whole recode of stamped
calls by `reference/rate.py`, the control not correct, the rehearsal,
`rate_ms` and `bit_count_roofline_pct` on a canned trace, the
configuration file and the entries.  The tests that take every cell of
`BENCHMARK.json` cover the rest (fresh inputs and undo, the control in
every cell, faults caught); `tests/test_torch_rate.py` holds the port's
CPU bytes to `reference/rate.py`."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.harness import Inline, stamp_keys
from portbench.reference import color, rate
from portbench.reference.entries import encode_cbr
from portbench.tests.helpers import PB, bench, rehearse
from portbench.tracefile import Trace
from portbench.traffic import fixture_rgb
from portbench.work import encode_cbr as work


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _rehearsal():
    conf = json.loads((PB / "configs" / "cbr1080.json").read_text())
    return {**conf, **conf["rehearse"]}, json.loads((PB / "mixes" / "b50m.rgb.json").read_text())


@pytest.mark.parametrize("control", [False, True])
def test_cached_reference_equals_a_whole_recode_of_stamped_calls(control):
    """Twelve stamped calls of one batch through prepare / submit /
    expected, each against `rate.encode_planes` of the whole stamped
    frames, the pictures at several scales; frame 0's cache emptied first,
    so that its first call codes it anew and fills it."""
    config, mix = _rehearsal()
    batch = fixture_rgb.make(config, mix, np.random.default_rng(2**31 + 61))
    precision = {**encode_cbr.nominal(mix), **(mix["control"] if control else {})}
    state = encode_cbr.prepare(batch, config, mix, precision, Inline())
    key = stamp_keys(2**31 + 61, 1, config["frames_per_call"])[0]
    state["slices"][0].clear()
    scales = set()
    for k in range(12):
        st = fixture_rgb.stamp(config, key, k)
        undo = fixture_rgb.apply(batch, config, st)
        try:
            part = encode_cbr.submit(Inline(), batch, config, mix, precision, st).result()
            got = encode_cbr.expected(state, config, mix, 15 * k, st, part)
            y, cb, cr = color.planes_420(batch["rgb"])
            if control:
                continue
            want = rate.encode_planes(y, cb, cr, 50, config["frame_rate_code"], config["gop_size"],
                                      config["bit_rate"], 15 * k,
                                      (config["width"], config["height"]))
            assert got == want, k
            for f in range(len(y)):
                scales.add(rate.choose(rate.slice_bits(y[f:f + 1], cb[f:f + 1], cr[f:f + 1],
                                                       50)[0], state["budget"]))
        finally:
            undo()
    if control:
        assert all(set(d) == {8} for d in state["slices"])
    else:
        assert len(scales) >= 2 and len(state["slices"][0]) == 1


def test_rehearsal_is_correct_and_the_control_is_not():
    code, result, err = rehearse("cbr1080.b50m.rgb", seconds=0.5)
    assert code == 0 and result["correct"] and result["calls_checked"] >= 1, err
    code, result, err = rehearse("cbr1080.b50m.rgb", seconds=0.5, control=True)
    assert code == 0 and not result["correct"], err
    assert result["checks"]["calls_wrong"]["value"] == result["calls_checked"] >= 1


# Two calls: `encode.rate` inside `encode.enqueue`, the count kernel inside
# its launch span (30 us, then 34 us) and the choice's kernel (2 us each);
# a kernel of 7 us after it.
RATE_TRACE = {"traceEvents": [
    _x("portbench.call", "user_annotation", 0, 100),
    _x("portbench.call", "user_annotation", 100, 100),
    _x("encode.enqueue", "user_annotation", 10, 60),
    _x("encode.rate", "user_annotation", 12, 30),
    _x("bit_count_launch", "user_annotation", 13, 5),
    _x("encode.enqueue", "user_annotation", 110, 60),
    _x("encode.rate", "user_annotation", 112, 30),
    _x("bit_count_launch", "user_annotation", 113, 5),
    _x("cuLaunchKernel", "cuda_driver", 14, 2, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 30, 2, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 2, correlation=3),
    _x("cuLaunchKernel", "cuda_driver", 114, 2, correlation=4),
    _x("cudaLaunchKernel", "cuda_runtime", 130, 2, correlation=5),
    _x("bit_count_kernel", "kernel", 18, 30, tid=7, correlation=1),
    _x("reduce_kernel", "kernel", 50, 2, tid=7, correlation=2),
    _x("vlc_slots_kernel", "kernel", 53, 7, tid=7, correlation=3),
    _x("bit_count_kernel", "kernel", 118, 34, tid=7, correlation=4),
    _x("reduce_kernel", "kernel", 153, 2, tid=7, correlation=5),
]}


def test_rate_metrics_on_a_canned_trace():
    from portbench.layer_metrics import bit_count_roofline_pct, rate_ms

    tr = Trace(RATE_TRACE)
    assert rate_ms.read(tr, {"calls": 2}) == pytest.approx((30 + 2 + 34 + 2) / 2e3)
    least = 40e-6  # the two calls' least time
    assert bit_count_roofline_pct.read(tr, {"calls": 2, "least_s": least}) == pytest.approx(
        100 * least * work.COUNT_SHARE / 64e-6)
    # a program without the span or the kernel (the parent): nothing to read
    doc = {"traceEvents": [e for e in RATE_TRACE["traceEvents"]
                           if e["name"] not in ("encode.rate", "bit_count_launch")]}
    assert rate_ms.read(Trace(doc), {"calls": 2}) is None
    assert bit_count_roofline_pct.read(Trace(doc), {"calls": 2, "least_s": least}) is None


def test_work_counts_the_count_once_per_call():
    config, mix = json.loads((PB / "configs" / "cbr1080.json").read_text()), {"quality": 50}
    least, by = work.least(config, mix, 1, 16 * 250_000)
    blocks = 16 * 68 * 120 * 6
    assert by == "int_ops" and work.C_COUNT == 8
    assert least == pytest.approx(blocks * work.OPS_CALL_BLOCK / (64 * 132 * 1.98e9))
    # the count kernel's own least time at 16 x 1080p: ~0.80 ms
    assert least * work.COUNT_SHARE == pytest.approx(
        blocks * (1280 + 31 * 64 * 8) / (64 * 132 * 1.98e9))


def test_cbr1080_configuration_file_and_entries():
    spec = bench()
    entry = next(c for c in spec["configs"] if c["name"] == "cbr1080")
    data = json.loads((PB / "configs" / "cbr1080.json").read_text())
    assert entry["file"] == "portbench/configs/cbr1080.json" and entry["reduced"] == []
    assert data["source"] == entry["source"] and len(entry["source"]) <= 200
    assert (data["width"], data["height"], data["chroma_format"]) == (1920, 1080, "4:2:0")
    assert (data["gop_size"], data["frame_rate_code"], data["frames_per_call"]) == (15, 3, 16)
    assert data["bit_rate"] == 50_000_000 and data["reduced"] == []
    assert rate.budget_bytes(data["bit_rate"], 3) == data["picture_bytes"] == 250_000
    assert rate.vbv_buffer_size(250_000) == data["vbv_buffer_size"] == 123
    assert set(data["assumed"]) == {"input", "content", "frames_per_call", "vbv_delay",
                                    "gop_size"}
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells["cbr1080.b50m.rgb"] == {**cells["cbr1080.b50m.rgb"], "config": "cbr1080",
                                         "traffic": "b50m.rgb", "chips": 1}
    for name in ("rate_ms", "bit_count_roofline_pct"):
        metric = next(m for m in spec["per_layer"] if m["name"] == name)
        assert metric["workloads"] == ["cbr1080.b50m.rgb"] and metric["layer"] == "rate control"
    mix = json.loads((PB / "mixes" / "b50m.rgb.json").read_text())
    assert (mix["entry"], mix["generator"], mix["quality"]) == ("encode_cbr", "fixture_rgb", 50)
    assert mix["checked_share"] == 0.125 and mix["control"] == {"rate": "fixed8"}
