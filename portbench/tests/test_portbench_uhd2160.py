"""The pieces of `uhd2160.q50.rgb` and of the mix `q50.noise` (the cell
`hd1080.q50.noise`, which `BENCHMARK.json` does not hold: PERF.md, Open
questions): the two new generators' stamps and undo, the noise's hash, the
noise's reference against the port's CPU bytes, `rgb420_ms` on a canned
trace, the new configuration file and entries.  The tests that take every
cell of `BENCHMARK.json` cover the rest of `uhd2160.q50.rgb`: fresh inputs
and undo (`test_portbench_traffic.py`), its rehearsal correct and its
control not correct (`test_portbench_control.py`), faults caught
(`test_portbench_faults.py`); `tests/test_torch_rgb_intake.py` holds the
RGB reference against the port's CPU bytes, stamped rows included."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.harness import Inline, stamp_keys
from portbench.reference.entries import encode_from_planes
from portbench.tests.helpers import PB, bench
from portbench.tracefile import Trace
from portbench.traffic import fixture_rgb, hash_noise


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _rehearsal(config, traffic):
    """-> (the configuration at its rehearsal's size, the mix)."""
    conf = json.loads((PB / "configs" / f"{config}.json").read_text())
    return {**conf, **conf["rehearse"]}, json.loads((PB / "mixes" / f"{traffic}.json").read_text())


def _hash_of(batch):
    return {k: v.tobytes() for k, v in batch.items()}


GENERATORS = [(fixture_rgb, "uhd2160", "q50.rgb"), (hash_noise, "hd1080", "q50.noise")]


@pytest.mark.parametrize("gen,config,traffic", GENERATORS)
def test_every_row_and_shift_comes_once_before_any_comes_again(gen, config, traffic):
    """At the rehearsal's size, a frame's first rows x shifts stamps are
    every (row, even shift) pair once; the next repeats the first."""
    config, _ = _rehearsal(config, traffic)
    rows, shifts = config["height"] // 16, config["width"] // 2 - 1
    key = stamp_keys(2**31 + 21, 1, config["frames_per_call"])[0]
    stamps = [gen.stamp(config, key, k) for k in range(rows * shifts + 1)]
    for f in range(config["frames_per_call"]):
        pairs = [(s["rows"][f], s["shifts"][f]) for s in stamps]
        assert len(set(pairs[:-1])) == rows * shifts and pairs[-1] == pairs[0]
        assert {s for _, s in pairs} == set(range(2, config["width"] - 1, 2))


def test_noise_stamps_undo_bit_for_bit_and_every_input_is_new():
    config, mix = _rehearsal("hd1080", "q50.noise")
    rng = np.random.default_rng(2**31 + 23)
    pool = [hash_noise.make(config, mix, rng) for _ in range(2)]
    assert _hash_of(pool[0]) != _hash_of(pool[1])
    key = stamp_keys(2**31 + 23, 1, config["frames_per_call"])[0]
    before, seen = _hash_of(pool[0]), set()
    for k in range(100):
        undo = hash_noise.apply(pool[0], config, hash_noise.stamp(config, key, k))
        seen.add(b"".join(_hash_of(pool[0]).values()))
        undo()
        assert _hash_of(pool[0]) == before
    assert len(seen) == 100


@pytest.mark.parametrize("control", [False, True])
def test_noise_reference_against_the_ports_cpu_bytes(control):
    """The noise, stamped, through `encode_from_planes`' reference: the
    port's CPU bytes at the configuration's precision, other bytes under
    the control's."""
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    config, mix = _rehearsal("hd1080", "q50.noise")
    batch = hash_noise.make(config, mix, np.random.default_rng(2**31 + 29))
    precision = {**encode_from_planes.nominal(mix), **(mix["control"] if control else {})}
    state = encode_from_planes.prepare(batch, config, mix, precision, Inline())
    st = hash_noise.stamp(config, stamp_keys(29, 1, config["frames_per_call"])[0], 4)
    undo = hash_noise.apply(batch, config, st)
    part = encode_from_planes.submit(Inline(), batch, config, mix, precision, st).result()
    got = TorchMPEG1IntraEncoder(quality=mix["quality"], device="cpu").encode_from_planes(
        batch["y"], batch["cb"], batch["cr"], first_frame_index=32)
    undo()
    assert (got == encode_from_planes.expected(state, config, mix, 32, st, part)) != control


def test_fixture_rgb_stamp_rolls_one_macroblock_row_of_each_frame():
    config, mix = _rehearsal("uhd2160", "q50.rgb")
    batch = fixture_rgb.make(config, mix, np.random.default_rng(5))
    rgb = batch["rgb"].copy()
    st = fixture_rgb.stamp(config, stamp_keys(5, 1, config["frames_per_call"])[0], 3)
    fixture_rgb.apply(batch, config, st)
    for f, (r, s) in enumerate(zip(st["rows"], st["shifts"])):
        want = rgb[f].copy()
        want[16 * r:16 * r + 16] = np.roll(rgb[f, 16 * r:16 * r + 16], s, axis=1)
        np.testing.assert_array_equal(batch["rgb"][f], want)


def test_hash_noise_is_bench_pys_hash():
    """bench.py's multiply-xorshift of the u32 iota, worked in Python ints."""
    def one(i):
        x = (i * 2654435761) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 2246822519) & 0xFFFFFFFF
        x ^= x >> 13
        return x & 0xFF

    start = 2**32 - 5  # wraps at 2**32 as the u32 iota would
    assert hash_noise.hash_u8(start, 12).tolist() == [one((start + i) % 2**32)
                                                      for i in range(12)]
    config, mix = _rehearsal("hd1080", "q50.noise")
    batch = hash_noise.make(config, mix, np.random.default_rng(1))
    n, h, w = config["frames_per_call"], config["height"], config["width"]
    assert batch["y"].shape == (n, h, w) and batch["cb"].shape == (n, h // 2, w // 2)
    # white noise: every byte value, none much more often than the rest
    counts = np.bincount(batch["y"].reshape(-1), minlength=256)
    assert counts.min() > 0 and counts.max() < 3 * counts.mean()


# Two calls.  `encode.rgb420` inside `encode.enqueue` in each; launched
# inside it a kernel of 30 us (first call) and a kernel of 10 us and a copy
# of 4 us (second call); inside `encode.enqueue` after it a kernel of 7 us.
RGB_TRACE = {"traceEvents": [
    _x("portbench.call", "user_annotation", 0, 100),
    _x("portbench.call", "user_annotation", 100, 100),
    _x("encode.enqueue", "user_annotation", 10, 60),
    _x("encode.rgb420", "user_annotation", 12, 30),
    _x("encode.enqueue", "user_annotation", 110, 60),
    _x("encode.rgb420", "user_annotation", 112, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 15, 2, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 2, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 115, 2, correlation=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 120, 2, correlation=4),
    _x("elementwise_kernel", "kernel", 18, 30, tid=7, correlation=1),
    _x("vlc_slots_kernel", "kernel", 52, 7, tid=7, correlation=2),
    _x("elementwise_kernel", "kernel", 118, 10, tid=7, correlation=3),
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 130, 4, tid=7, correlation=4),
    _x("portbench.call", "gpu_user_annotation", 0, 200, tid=7),
]}


def test_rgb420_ms_on_a_canned_trace():
    from portbench.layer_metrics import rgb420_ms

    assert rgb420_ms.read(Trace(RGB_TRACE), {"calls": 2}) == pytest.approx((30 + 10 + 4) / 2e3)
    # a program without the span (the planes intake, or a port before it): nothing to read
    doc = {"traceEvents": [e for e in RGB_TRACE["traceEvents"] if e["name"] != "encode.rgb420"]}
    assert rgb420_ms.read(Trace(doc), {"calls": 2}) is None


def test_uhd2160_configuration_file():
    spec = bench()
    entry = next(c for c in spec["configs"] if c["name"] == "uhd2160")
    data = json.loads((PB / "configs" / "uhd2160.json").read_text())
    assert entry["file"] == "portbench/configs/uhd2160.json" and entry["reduced"] == []
    assert data["source"] == entry["source"] and "JVET-T2010" in data["source"]
    assert (data["width"], data["height"], data["chroma_format"]) == (3840, 2160, "4:2:0")
    assert (data["gop_size"], data["frame_rate_code"], data["frames_per_call"]) == (15, 8, 16)
    assert data["reduced"] == [] and data["mode"].startswith("correct")
    assert set(data["assumed"]) == {"input", "content", "frames_per_call", "gop_size"}
    assert "8-bit RGB" in data["assumed"]["input"]
    assert data["rehearse"] == {"width": 256, "height": 144, "frames_per_call": 2}
    # the largest frame the port takes: 12-bit widths, slice codes up to 0xAF
    assert data["width"] <= 4095 and data["height"] <= 175 * 16


def test_new_cell_metric_and_mixes():
    spec = bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells["uhd2160.q50.rgb"] == {**cells["uhd2160.q50.rgb"], "config": "uhd2160",
                                        "traffic": "q50.rgb", "chips": 1}
    metric = next(m for m in spec["per_layer"] if m["name"] == "rgb420_ms")
    assert metric["workloads"] == ["uhd2160.q50.rgb"] and metric["layer"] == "RGB intake"
    mixes = {t: json.loads((PB / "mixes" / f"{t}.json").read_text())
             for t in ("q50.rgb", "q50.noise")}
    assert mixes["q50.rgb"]["entry"] == "encode" and mixes["q50.rgb"]["generator"] == "fixture_rgb"
    assert mixes["q50.noise"]["entry"] == "encode_from_planes"
    assert mixes["q50.noise"]["generator"] == "hash_noise"
    assert all(m["quality"] == 50 and m["checked_share"] == 0.125 for m in mixes.values())
