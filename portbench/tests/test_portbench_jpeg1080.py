"""The pieces of `jpeg1080.q50.auto`: the `jpeg_restart` files and their
stamps (in place, the same length, undone bit for bit, every stamp a new
decoded frame), `jpeg_decode_ms` on a canned trace, the configuration
file and the entries.  The tests that take every cell of `BENCHMARK.json`
cover the rest: fresh inputs and undo (`test_portbench_traffic.py`), its
rehearsal correct and its control not correct
(`test_portbench_control.py`), faults caught (`test_portbench_faults.py`);
`tests/test_torch_jpeg_bytes.py` holds the port's decoder to the
generator's coefficients and the reference to the port's CPU bytes."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.harness import stamp_keys
from portbench.tests.helpers import PB, bench
from portbench.tracefile import Trace
from portbench.traffic import jpeg_restart


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _rehearsal():
    conf = json.loads((PB / "configs" / "jpeg1080.json").read_text())
    return {**conf, **conf["rehearse"]}, json.loads((PB / "mixes" / "q50.auto.json").read_text())


@pytest.fixture(scope="module")
def batch():
    config, mix = _rehearsal()
    return jpeg_restart.make(config, mix, np.random.default_rng(2**31 + 53))


def test_stamp_moves_three_segments_in_place_with_the_same_length(batch):
    config, _ = _rehearsal()
    before = {k: v.copy() for k, v in batch.items()}
    key = stamp_keys(2**31 + 53, 1, config["frames_per_call"])[0]
    for k in range(40):
        st = jpeg_restart.stamp(config, key, k)
        jpeg_view = batch["jpeg"]
        undo = jpeg_restart.apply(batch, config, st)
        assert batch["jpeg"] is jpeg_view and batch["jpeg"].shape == before["jpeg"].shape
        for f, (a, b, c) in enumerate(jpeg_restart.cycles(config, st)):
            n, s, e = batch["length"][f], batch["seg_start"][f], batch["seg_end"][f]
            row, old = batch["jpeg"][f], before["jpeg"][f]
            assert len({a, b, c}) == 3 and max(a, b, c) < config["height"] // 16
            assert not np.array_equal(row[:n], old[:n])
            assert np.array_equal(row[n:], old[n:]) and np.array_equal(row[:s[0]], old[:s[0]])
            # the file rebuilt segment by segment: the segment of a where
            # b's was, b's where c's was, c's where a's was
            src = {b: a, c: b, a: c}
            parts = [old[:s[0]]]
            for q in range(len(s)):
                r = src.get(q, q)
                parts += [old[s[r]:e[r]], old[e[q]:s[q + 1] if q + 1 < len(s) else n]]
            assert np.array_equal(row[:n], np.concatenate(parts))
        undo()
        assert all(np.array_equal(batch[k], before[k]) for k in batch)


def test_every_stamp_changes_the_decoded_frame(batch):
    """Through the port's native decoder: every stamp gives every frame
    other planes, the moved MCU rows in their new places, and the last,
    partial MCU row where it was."""
    from ec504_imageencoder_tpu_torch.io import jpeg

    config, _ = _rehearsal()
    files = lambda: [row[:n].copy() for row, n in zip(batch["jpeg"], batch["length"])]  # noqa: E731
    geom = jpeg.probe_jpeg(files()[0])
    y0, cb0, _ = jpeg.decode_planes_batch(files(), geom)
    full = config["height"] // 16
    key = stamp_keys(2**31 + 59, 1, config["frames_per_call"])[0]
    for k in range(full * (full - 1)):
        st = jpeg_restart.stamp(config, key, k)
        undo = jpeg_restart.apply(batch, config, st)
        y, cb, _ = jpeg.decode_planes_batch(files(), geom)
        undo()
        for f, (a, b, c) in enumerate(jpeg_restart.cycles(config, st)):
            assert not np.array_equal(y[f], y0[f])
            for src, dst in ((a, b), (b, c), (c, a)):
                assert np.array_equal(y[f, 16 * dst:16 * dst + 16], y0[f, 16 * src:16 * src + 16])
                assert np.array_equal(cb[f, 8 * dst:8 * dst + 8], cb0[f, 8 * src:8 * src + 8])
            assert np.array_equal(y[f, 16 * full:], y0[f, 16 * full:])


def test_no_two_full_mcu_rows_of_a_frame_are_alike():
    """At the configuration's own size too (the tiles repeat every 600
    rows; each tile row has its own shift)."""
    config, mix = _rehearsal()
    full = json.loads((PB / "configs" / "jpeg1080.json").read_text())
    for conf in (config, {**full, "frames_per_call": 2}):
        rgb = jpeg_restart.rgb_frames(np.random.default_rng(61), conf["frames_per_call"],
                                      conf["height"], conf["width"])
        for frame in rgb:
            rows = {frame[16 * r:16 * r + 16].tobytes() for r in range(conf["height"] // 16)}
            assert len(rows) == conf["height"] // 16


def test_the_rows_must_be_prime_to_6():
    config, _ = _rehearsal()
    with pytest.raises(ValueError, match="prime to 6"):
        jpeg_restart.stamp({**config, "height": 144}, stamp_keys(1, 1, 3)[0], 0)


# Two calls.  `encode.jpeg_decode` of 30 us and of 50 us on the calling
# thread, one of 70 us on another thread (not counted).
DECODE_TRACE = {"traceEvents": [
    _x("portbench.call", "user_annotation", 0, 100),
    _x("portbench.call", "user_annotation", 100, 100),
    _x("encode.jpeg_decode", "user_annotation", 2, 30),
    _x("encode.pad", "user_annotation", 40, 10),
    _x("encode.jpeg_decode", "user_annotation", 102, 50),
    _x("encode.jpeg_decode", "user_annotation", 110, 70, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 45, 2, correlation=1),
    _x("vlc_fused4_kernel", "kernel", 60, 7, tid=7, correlation=1),
    _x("portbench.call", "gpu_user_annotation", 0, 200, tid=7),
]}


def test_jpeg_decode_ms_on_a_canned_trace():
    from portbench.layer_metrics import jpeg_decode_ms

    assert jpeg_decode_ms.read(Trace(DECODE_TRACE), {"calls": 2}) == pytest.approx((30 + 50) / 2e3)
    # a program without the span (the other intakes, or a port before it): nothing to read
    doc = {"traceEvents": [e for e in DECODE_TRACE["traceEvents"]
                           if e["name"] != "encode.jpeg_decode"]}
    assert jpeg_decode_ms.read(Trace(doc), {"calls": 2}) is None


def test_jpeg1080_configuration_file():
    spec = bench()
    entry = next(c for c in spec["configs"] if c["name"] == "jpeg1080")
    data = json.loads((PB / "configs" / "jpeg1080.json").read_text())
    assert entry["file"] == "portbench/configs/jpeg1080.json" and entry["reduced"] == []
    assert data["source"] == entry["source"] and "cjpeg -quality 75 -restart 1" in data["source"]
    assert (data["width"], data["height"], data["frames_per_call"]) == (1920, 1080, 16)
    assert (data["gop_size"], data["frame_rate_code"]) == (15, 3)
    assert (data["jpeg_quality"], data["sampling"], data["restart_rows"]) == (75, "4:2:0 (h2v2)", 1)
    assert data["reduced"] == [] and data["mode"].startswith("correct")
    assert {"content", "restart_rows", "decode_threads"} <= set(data["assumed"])
    assert data["rehearse"] == {"width": 256, "height": 184, "frames_per_call": 3}
    # the stamps' cycles: full MCU rows prime to 6 at both sizes
    assert jpeg_restart.full_rows(data) == 67 and jpeg_restart.full_rows(_rehearsal()[0]) == 11


def test_new_cell_metric_and_mix():
    spec = bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells["jpeg1080.q50.auto"] == {**cells["jpeg1080.q50.auto"], "config": "jpeg1080",
                                          "traffic": "q50.auto", "chips": 1}
    metric = next(m for m in spec["per_layer"] if m["name"] == "jpeg_decode_ms")
    assert metric["workloads"] == ["jpeg1080.q50.auto"] and metric["layer"] == "JPEG intake"
    assert metric["moves"] == "frames_per_s"
    _, mix = _rehearsal()
    assert (mix["entry"], mix["quality"], mix["intake"], mix["generator"]) == (
        "encode_from_jpegs", 50, "auto", "jpeg_restart")
    assert mix["checked_share"] == 0.125 and mix["control"] == {"idct": "islow"}
