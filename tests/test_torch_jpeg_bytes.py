"""JPEG bytes as an intake (`io/jpeg.py::decode_batch`,
`TorchMPEG1IntraEncoder.encode_from_jpegs`, `api.encode_jpegs`), on the
CPU.

* The batch decode of JPEGs in memory equals that of the same files by
  path, byte for byte (planes, coefficients, RGB), on the fixtures of
  `tests/data/torch_jpegs/` and on a file with a restart marker after
  every MCU row (`portbench/traffic/jpeg_restart.py`); the port's
  coefficients of the generator's files are the generator's own.
* `encode_from_jpegs` equals `encode_from_planes` of the decoded planes,
  and the benchmark's plain reference at the rehearsal size of
  `jpeg1080`, stamped calls included (libjpeg's IDCT, the control, gives
  other bytes); `api.encode_jpegs` writes what it returns.
* The intake rule is one: `encode_from_jpegs`, `api.encode_jpeg_folder`
  and the CLI's `--stream` answer alike for every layout and intake.
* Errors name the path or the index; the span `encode.jpeg_decode` comes
  before `encode.pad`, and the stream's lookahead waits run in it; the
  counters `frames_decoded`, `bytes_in`, `restart_intervals` and
  `decode_threads` count.

The native decoder builds with g++: without it these tests skip.
Tolerance: exact everywhere (integer decode, equal bytes).
"""

import json
import shutil
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest

from ec504_imageencoder_tpu_torch import api, cli
from ec504_imageencoder_tpu_torch.io import jpeg
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.syntax import headers
from ec504_imageencoder_tpu_torch.utils import profiling
from portbench.harness import stamp_keys
from portbench.reference.entries import encode_from_jpegs as reference
from portbench.traffic import jpeg_restart

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the native JPEG decoder builds with g++")

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = sorted((ROOT / "tests" / "data" / "torch_jpegs").glob("*.jpg"))
CONFIG = json.loads((ROOT / "portbench" / "configs" / "jpeg1080.json").read_text())
MIX = json.loads((ROOT / "portbench" / "mixes" / "q50.auto.json").read_text())
REHEARSAL = {**CONFIG, **CONFIG["rehearse"]}


class Inline:
    def submit(self, fn, *args):
        fut = Future()
        fut.set_result(fn(*args))
        return fut


@pytest.fixture(scope="module")
def batch():
    """The generator's batch at the rehearsal size: 3 files of 256 x 184
    (11 full MCU rows and a half one), a restart marker every MCU row."""
    return jpeg_restart.make(REHEARSAL, MIX, np.random.default_rng(2**31 + 41))


def _files(batch):
    return [bytes(row[:n]) for row, n in zip(batch["jpeg"], batch["length"])]


@pytest.fixture(scope="module")
def restart_path(batch, tmp_path_factory):
    path = tmp_path_factory.mktemp("restart") / "restart.jpg"
    path.write_bytes(_files(batch)[0])
    return path


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["planes", "coeffs", "rgb"])
def test_buffer_decode_equals_path_decode(kind, restart_path):
    for group in ([p for p in FIXTURES if p.name.startswith("frame")],
                  [p for p in FIXTURES if p.name.startswith("hd")], [restart_path]):
        paths = [str(p) for p in group]
        geom = jpeg.probe_jpeg(paths[0])
        data = [p.read_bytes() for p in group]
        assert jpeg.probe_jpeg(data[0]) == geom
        want = jpeg.decode_batch(paths, geom, kind)
        # bytes, a bytearray, a memoryview and a u8 array: the same decode
        for buffers in (data, [bytearray(d) for d in data], [memoryview(d) for d in data],
                        [np.frombuffer(d, np.uint8) for d in data]):
            _equal(jpeg.decode_batch(buffers, geom, kind, n_threads=2), want)
    _equal(jpeg.decode_planes_batch(data, geom), jpeg.decode_batch(paths, geom, "planes"))
    _equal(jpeg.decode_coeffs_batch(data, geom), jpeg.decode_batch(paths, geom, "coeffs"))


def test_coefficients_of_the_generators_files_are_its_own(batch):
    files = _files(batch)
    geom = jpeg.probe_jpeg(files[0])
    assert (geom["width"], geom["height"], geom["hsamp"], geom["vsamp"]) == (256, 184, 2, 2)
    _equal(jpeg.decode_coeffs_batch(files, geom), (batch["yc"], batch["cbc"], batch["crc"]))
    # a stamp moves whole segments: the same coefficients, MCU rows in a new order
    st = jpeg_restart.stamp(REHEARSAL, stamp_keys(41, 1, 3)[0], 5)
    undo = jpeg_restart.apply(batch, REHEARSAL, st)
    try:
        yc, _, _ = jpeg.decode_coeffs_batch(_files(batch), geom)
    finally:
        undo()
    for f, (a, b, c) in enumerate(jpeg_restart.cycles(REHEARSAL, st)):
        rows = lambda y, r: y[f].reshape(-1, 64 * 32)[2 * r:2 * r + 2]  # noqa: E731
        for dst, src in ((b, a), (c, b), (a, c)):
            assert np.array_equal(rows(yc, dst), rows(batch["yc"], src))


def test_encode_from_jpegs_is_encode_from_planes_of_the_decode():
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    paths = [str(p) for p in FIXTURES if p.name.startswith("frame")]
    planes = jpeg.decode_planes_batch(paths, jpeg.probe_jpeg(paths[0]))
    want = enc.encode_from_planes(*planes, first_frame_index=7)
    assert enc.encode_from_jpegs(paths, 7) == want
    assert enc.encode_from_jpegs([Path(p).read_bytes() for p in paths], 7) == want


def _reference(batch, first_frame_index, stamp, precision):
    state = reference.prepare(batch, REHEARSAL, MIX, precision, Inline())
    part = reference.submit(Inline(), batch, REHEARSAL, MIX, precision, stamp).result()
    return reference.expected(state, REHEARSAL, MIX, first_frame_index, stamp, part)


@pytest.mark.parametrize("k", [0, 3])
def test_encode_from_jpegs_equals_the_plain_reference(batch, k):
    """At the rehearsal size, stamped: the port's CPU bytes are the
    reference's with stb's IDCT, and not with libjpeg's (the control)."""
    st = jpeg_restart.stamp(REHEARSAL, stamp_keys(2**31 + 43, 1, 3)[0], k)
    undo = jpeg_restart.apply(batch, REHEARSAL, st)
    try:
        got = TorchMPEG1IntraEncoder(quality=MIX["quality"], device="cpu").encode_from_jpegs(
            [row[:n] for row, n in zip(batch["jpeg"], batch["length"])], 48, intake="auto")
    finally:
        undo()
    nominal = reference.nominal(MIX)
    assert got == _reference(batch, 48, st, nominal)
    assert got != _reference(batch, 48, st, {**nominal, **MIX["control"]})


def test_api_encode_jpegs_writes_what_encode_from_jpegs_returns(batch, tmp_path):
    files = _files(batch)
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    want = enc.encode_from_jpegs(files[:2]) + enc.encode_from_jpegs(files[2:], 2)
    n = api.encode_jpegs(files, str(tmp_path / "out" / "v.mpg"), batch_size=2, device="cpu")
    assert (tmp_path / "out" / "v.mpg").read_bytes() == want + headers.sequence_end()
    assert n == len(want) + len(headers.sequence_end())


def _save_folder(folder, layout, n=3, h=48, w=64):
    from PIL import Image

    folder.mkdir()
    rng = np.random.default_rng(17)
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([(yy * 3 + xx + 9 * i) % 256, (xx * 5) % 256, (yy * 7) % 256], -1)
        rgb = np.clip(rgb + rng.integers(-20, 21, rgb.shape), 0, 255).astype(np.uint8)
        if layout == "gray":
            Image.fromarray(rgb[..., 0]).save(folder / f"f{i}.jpg", quality=90)
        else:
            Image.fromarray(rgb).save(folder / f"f{i}.jpg", quality=90,
                                      subsampling=2 if layout == "420" else 0)
    return sorted(str(p) for p in folder.glob("*.jpg"))


def _outcome(fn):
    try:
        return fn()
    except (ValueError, SystemExit) as e:
        return "needs 3-component" in str(e.args[0])


@pytest.mark.parametrize("layout", ["420", "444", "gray"])
@pytest.mark.parametrize("intake", ["auto", "ycbcr", "coeffs", "rgb"])
def test_one_intake_rule(tmp_path, layout, intake):
    """The same answer from `encode_from_jpegs`, `api.encode_jpeg_folder`
    and the CLI's `--stream`: the same bytes, or the same refusal."""
    paths = _save_folder(tmp_path / "in", layout)

    def port():
        enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
        return enc.encode_from_jpegs(paths, intake=intake) + headers.sequence_end()

    def folder():
        api.encode_jpeg_folder(str(tmp_path / "in"), str(tmp_path / "a.mpg"), intake=intake,
                               device="cpu")
        return (tmp_path / "a.mpg").read_bytes()

    def command():
        cli.main([str(tmp_path / "in"), "-o", str(tmp_path / "c.mpg"), "--stream",
                  "--intake", intake, "--device", "cpu"])
        return (tmp_path / "c.mpg").read_bytes()

    got = [_outcome(fn) for fn in (port, folder, command)]
    assert got[0] == got[1] == got[2]
    refused = layout != "420" and intake in ("ycbcr", "coeffs")
    assert (got[0] is True) == refused
    want = {"auto": "planes", "ycbcr": "planes", "coeffs": "coeffs"}.get(intake, "rgb")
    if not refused:
        assert jpeg.intake_kind(jpeg.probe_jpeg(paths[0]), intake) == (
            want if layout == "420" else "rgb")


def test_errors_name_the_path_or_the_index(batch, tmp_path):
    files = _files(batch)
    geom = jpeg.probe_jpeg(files[0])
    with pytest.raises(ValueError, match="decode failure: JPEG 1 of the batch"):
        jpeg.decode_batch([files[0], b"\xff\xd8garbage", files[2]], geom, "planes")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8garbage")
    with pytest.raises(ValueError, match=f"decode failure: {bad}"):
        jpeg.decode_batch([files[0], str(bad)], geom, "coeffs")
    other = (ROOT / "tests" / "data" / "torch_jpegs" / "frame_0.jpg").read_bytes()
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    with pytest.raises(ValueError, match="dimension mismatch: JPEG 2 of the batch"):
        enc.encode_from_jpegs([files[0], files[1], other])
    with pytest.raises(ValueError, match="decode failure: JPEG 0 of the batch"):
        enc.encode_from_jpegs([b"not a jpeg"])
    with pytest.raises(ValueError, match="unknown intake 'yuv'"):
        enc.encode_from_jpegs(files, intake="yuv")


def _span_names(tmp_path, fn):
    with profiling.device_trace(str(tmp_path)):
        fn()
    (trace,) = tmp_path.glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("encode.")]
    return [e["name"] for e in sorted(spans, key=lambda e: e["ts"])]


def test_decode_span_comes_before_the_pad(batch, tmp_path):
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    names = _span_names(tmp_path / "one", lambda: enc.encode_from_jpegs(_files(batch)))
    assert names[:2] == ["encode.jpeg_decode", "encode.pad"]
    assert names.count("encode.jpeg_decode") == 1
    # the stream: one wait for each lookahead batch, in the calling thread
    _save_folder(tmp_path / "in", "420", n=5)
    names = _span_names(tmp_path / "stream", lambda: api.encode_jpeg_folder(
        str(tmp_path / "in"), str(tmp_path / "o.mpg"), batch_size=2, device="cpu"))
    assert names.count("encode.jpeg_decode") == 3 and names[0] == "encode.jpeg_decode"


def test_counters_count(batch, monkeypatch):
    for name, value in (("bytes_in", 0), ("restart_intervals", 0), ("decode_threads", 0)):
        monkeypatch.setattr(jpeg, name, value)
    monkeypatch.setattr(jpeg, "frames_decoded", jpeg.Counter())
    files = _files(batch)
    geom = jpeg.probe_jpeg(files[0])
    jpeg.decode_batch(files, geom, "planes", n_threads=2)
    # 12 MCU rows a file: 12 entropy-coded segments, 11 restart markers between them
    assert (jpeg.frames_decoded, jpeg.bytes_in, jpeg.restart_intervals, jpeg.decode_threads) == (
        {"planes": 3}, sum(map(len, files)), 36, 2)
    TorchMPEG1IntraEncoder(quality=50, device="cpu").encode_from_jpegs(files[:2], intake="coeffs")
    assert jpeg.frames_decoded == {"planes": 3, "coeffs": 2} and jpeg.restart_intervals == 60
    assert jpeg.decode_threads == 2  # the API's default: one a hardware thread, at most a frame each
    with pytest.raises(ValueError):
        jpeg.decode_batch([files[0], b"\xff\xd8"], geom, "rgb", n_threads=1)
    assert jpeg.frames_decoded["rgb"] == 1 and jpeg.decode_threads == 1
    # a file without restart markers is one segment
    path = str(FIXTURES[0])
    jpeg.decode_batch([path], jpeg.probe_jpeg(path), "rgb")
    assert jpeg.restart_intervals == 60 + 12 + 1
