"""The plain reference: the C encoder's golden output, and the port's
CPU bytes (`device="cpu"`, the kernels' plain twins) on small batches."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from portbench.reference import compat, jpeg, mpeg1
from portbench.tests.helpers import GOLDEN
from portbench.harness import Inline, stamp_keys
from portbench.reference.entries import encode_from_coeffs, encode_from_planes
from portbench.traffic import fixture_shift, fixture_tiles, jpeg_coeffs


def _golden_frames():
    order = json.loads((GOLDEN / "frame_order.json").read_text())["unique_ids"]
    with np.load(GOLDEN / "fixture_rgb.npz") as z:
        return np.stack([z[k] for k in order])


def test_compat_equals_the_c_encoders_golden_stream_and_dumps():
    stream, dumps = compat.encode_compat(_golden_frames(), 12)
    assert stream == (GOLDEN / "awesome_video.mpeg").read_bytes()
    md5 = json.loads((GOLDEN / "bit_dump_md5.json").read_text())
    assert [hashlib.md5(d).hexdigest() for d in dumps] == [md5[f"image_{i + 1}.bit"]
                                                          for i in range(len(dumps))]


def _planes(seed, n=3, height=72, width=136):
    config = {"frames_per_call": n, "height": height, "width": width}
    return fixture_tiles.make(config, {}, np.random.default_rng(seed)), config


def _expected(planes, config, quality, ffi, dct):
    payloads = mpeg1.picture_payloads(*mpeg1.pad_planes(*planes), quality, dct)
    return mpeg1.assemble(payloads, config["width"], config["height"], quality, 3, 15, ffi)


@pytest.mark.parametrize("quality,dct", [(50, "int32"), (85, "f32"), (5, "int32"), (100, "f32")])
@pytest.mark.parametrize("height,width", [(72, 136), (64, 1920)])
def test_planes_equal_the_ports_cpu_bytes(quality, dct, height, width):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    batch, config = _planes(2**31 + quality, height=height, width=width)
    got = TorchMPEG1IntraEncoder(quality=quality, device="cpu").encode_from_planes(
        batch["y"], batch["cb"], batch["cr"], first_frame_index=13)
    assert got == _expected((batch["y"], batch["cb"], batch["cr"]), config, quality, 13, dct)


@pytest.mark.parametrize("quality,dct", [(50, "int32"), (85, "f32")])
def test_coefficients_equal_the_ports_cpu_bytes(quality, dct):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    batch, config = _planes(7, n=2, height=40, width=72)
    yc, cbc, crc = jpeg_coeffs.coefficients((batch["y"], batch["cb"], batch["cr"]), 40, 72,
                                            np.random.default_rng(3))
    got = TorchMPEG1IntraEncoder(quality=quality, device="cpu").encode_from_coeffs(
        yc, cbc, crc, 40, 72, first_frame_index=29)
    planes = jpeg.planes_from_coeffs(yc, cbc, crc, 40, 72)
    assert got == _expected(planes, config, quality, 29, dct)


def test_compat_equals_the_ports_cpu_bytes():
    from ec504_imageencoder_tpu_torch.models.encoder import encode_compat

    config = {"frames_per_call": 5, "height": 600, "width": 400}
    frames = fixture_shift.make(config, {}, np.random.default_rng(2**33 + 1))["rgb"]
    assert encode_compat(frames, 12, device="cpu") == compat.encode_compat(frames, 12)


def test_each_control_changes_the_output():
    batch, config = _planes(5, n=2)
    planes = (batch["y"], batch["cb"], batch["cr"])
    assert _expected(planes, config, 50, 0, "int16") != _expected(planes, config, 50, 0, "int32")
    assert _expected(planes, config, 85, 0, "bf16") != _expected(planes, config, 85, 0, "f32")
    yc, cbc, crc = jpeg_coeffs.coefficients(planes, 72, 136, np.random.default_rng(1))
    p32 = jpeg.planes_from_coeffs(yc, cbc, crc, 72, 136)
    p16 = jpeg.planes_from_coeffs(yc, cbc, crc, 72, 136, np.int16)
    assert any(not np.array_equal(a, b) for a, b in zip(p32, p16))
    frames = _golden_frames()[:3]
    assert compat.encode_compat(frames, 12, "f32") != compat.encode_compat(frames, 12)


def test_bit_packer_against_a_scalar_one():
    from portbench.reference.bits import pack_slices

    rng = np.random.default_rng(0)
    lens = rng.integers(0, 33, 500)
    codes = np.array([int(rng.integers(0, 2**int(n))) if n else 0 for n in lens], np.uint64)
    slice_of = np.sort(rng.integers(0, 7, 500))
    data, bits = pack_slices(codes, lens, slice_of, 8)
    want = b""
    for s in range(8):
        acc, n = 0, 0
        for c, k in zip(codes[slice_of == s], lens[slice_of == s]):
            acc, n = (acc << int(k)) | int(c), n + int(k)
        assert bits[s] == n
        want += (acc << (-n % 8)).to_bytes((n + 7) // 8, "big") if n else b""
    assert data.tobytes() == want


@pytest.mark.parametrize("k", [0, 5])
@pytest.mark.parametrize("entry,gen,quality", [
    (encode_from_planes, fixture_tiles, 50), (encode_from_planes, fixture_tiles, 85),
    (encode_from_coeffs, jpeg_coeffs, 50)])
def test_a_stamped_call_equals_the_whole_reference(entry, gen, quality, k):
    """The reference of a stamped call (the pool batch prepared once, the
    stamped rows coded anew) equals the reference run whole on the stamped
    batch, and differs from the unstamped batch's."""
    config = {"frames_per_call": 3, "height": 72, "width": 136, "frame_rate_code": 3,
              "gop_size": 15}
    mix = {"quality": quality}
    batch = gen.make(config, mix, np.random.default_rng(2**31 + k))
    precision = entry.nominal(mix)
    state = entry.prepare(batch, config, mix, precision, Inline())
    stamp = gen.stamp(config, stamp_keys(2**31 + k, 1, 3)[0], k)
    plain = entry.expected(state, config, mix, 14, {"rows": []}, [])
    undo = gen.apply(batch, config, stamp)
    try:
        part = entry.submit(Inline(), batch, config, mix, precision, stamp).result()
        whole = entry.prepare(batch, config, mix, precision, Inline())
    finally:
        undo()
    got = entry.expected(state, config, mix, 14, stamp, part)
    assert got == entry.expected(whole, config, mix, 14, {"rows": []}, [])
    assert got != plain
