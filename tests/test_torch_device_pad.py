"""Macroblock edge padding on the device, on the CPU.

A single-device encode copies the caller's unpadded frames or planes to
its device and edge-pads them there (`models/mpeg1.py::edge_pad`,
`edge_pad_planes`, `edge_pad_frames`), where the JAX package pads on the
host with `np.pad`.  So:

* the padding helpers equal the host helpers `pad_to_macroblocks` /
  `pad_planes_to_macroblocks` for rows-only, both (odd chroma included)
  and no padding (`edge_pad` against `np.pad`: tests/test_torch_jpeg.py);
  an aligned tensor is returned as it is;
* `encode_from_planes`, `encode` and `encode_from_jpegs` (its planes and
  RGB kinds) give the JAX package's stream at 40 x 64 (rows padded),
  35 x 50 (rows and columns, odd chroma) and 32 x 48 (aligned);
* `pad_sites["device"]` counts one for each call that padded and none for
  an aligned one; `pad_sites["host"]` stays 0 on one device;
* a regrow re-runs on the same padded tensors: one pad a call.

Tolerance: exact (equal values, equal bytes).
"""

import shutil

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.io import jpeg
from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

SIZES = {"rows": (40, 64), "rows and columns": (35, 50), "aligned": (32, 48)}
QUALITY = 50


def _frames(h, w, seed=11, b=2):
    """Smooth RGB frames with noise: every block codes some AC."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 5 + xx * 3) % 256, (xx * 7) % 256, (yy * 9) % 256], -1)
    return np.stack([np.clip(base + 13 * i + rng.integers(-24, 25, base.shape), 0, 255)
                     for i in range(b)]).astype(np.uint8)


def _planes(frames):
    """4:2:0 planes as a JPEG decoder gives them: chroma ceil(H/2) x ceil(W/2)."""
    return (np.ascontiguousarray(frames[..., 0]),
            np.ascontiguousarray(frames[:, ::2, ::2, 1]),
            np.ascontiguousarray(frames[:, ::2, ::2, 2]))


@pytest.fixture
def sites():
    """`pad_sites`, cleared for the test."""
    mpeg1.pad_sites.clear()
    yield mpeg1.pad_sites
    mpeg1.pad_sites.clear()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's stream of (entry, arrays), one compile a shape."""
    enc = MPEG1IntraEncoder(quality=QUALITY, backend="jax")
    cache = {}

    def get(entry, *arrays):
        key = (entry, *(a.tobytes() for a in arrays), *(a.shape for a in arrays))
        if key not in cache:
            cache[key] = getattr(enc, entry)(*arrays)
        return cache[key]

    return get


def test_edge_pad_returns_an_aligned_tensor_itself():
    x = torch.arange(2 * 32 * 48, dtype=torch.uint8).reshape(2, 32, 48)
    assert mpeg1.edge_pad(x, 32, 48) is x
    assert mpeg1.edge_pad(x.unsqueeze(-1), 32, 48, dims=(1, 2)).data_ptr() == x.data_ptr()


@pytest.mark.parametrize("size", list(SIZES))
def test_device_helpers_equal_the_host_helpers(size):
    frames = _frames(*SIZES[size])
    got = mpeg1.edge_pad_frames(torch.from_numpy(frames)).numpy()
    assert np.array_equal(got, mpeg1.pad_to_macroblocks(frames))
    planes = _planes(frames)
    got = mpeg1.edge_pad_planes(*(torch.from_numpy(p) for p in planes))
    for g, want in zip(got, mpeg1.pad_planes_to_macroblocks(*planes)):
        assert np.array_equal(g.numpy(), want)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("entry", ["encode_from_planes", "encode"])
def test_entry_equals_the_jax_package(reference, sites, entry, size):
    frames = _frames(*SIZES[size])
    arrays = (frames,) if entry == "encode" else _planes(frames)
    enc = TorchMPEG1IntraEncoder(quality=QUALITY, device="cpu")
    for calls in (1, 2):
        assert getattr(enc, entry)(*arrays) == reference(entry, *arrays)
        assert sites == {"device": calls} if size != "aligned" else not sites


def _jpegs(tmp_path, h, w, subsampling):
    from PIL import Image

    paths = []
    for i, frame in enumerate(_frames(h, w, seed=5)):
        paths.append(str(tmp_path / f"f{i}.jpg"))
        Image.fromarray(frame).save(paths[-1], quality=90, subsampling=subsampling)
    return paths


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="the native JPEG decoder builds with g++")
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("intake", ["auto", "rgb"])
def test_encode_from_jpegs_equals_the_jax_package(reference, sites, tmp_path, intake, size):
    """"auto" decodes 4:2:0 files to planes, "rgb" to frames; both pad on
    the device and give the JAX package's stream of the decoded arrays."""
    paths = _jpegs(tmp_path, *SIZES[size], subsampling=2)
    geom = jpeg.probe_jpeg(paths[0])
    kind = jpeg.intake_kind(geom, intake)
    assert kind == {"auto": "planes", "rgb": "rgb"}[intake]
    arrays = jpeg.decode_batch(paths, geom, kind)
    enc = TorchMPEG1IntraEncoder(quality=QUALITY, device="cpu")
    got = enc.encode_from_jpegs(paths, intake=intake)
    assert got == reference("encode" if kind == "rgb" else "encode_from_planes", *arrays)
    assert sites == {"device": 1} if size != "aligned" else not sites


@pytest.mark.parametrize("entry", ["encode_from_planes", "encode"])
def test_regrow_pads_once_a_call(reference, sites, monkeypatch, entry):
    """From an 8-byte slice buffer the first call overflows and re-runs on
    the padded tensors of its one copy; the second starts grown."""
    pads = []
    for name in ("edge_pad_planes", "edge_pad_frames"):
        fn = getattr(mpeg1, name)
        monkeypatch.setattr(mpeg1, name, lambda *a, fn=fn: pads.append(1) or fn(*a))
    frames = _frames(*SIZES["rows and columns"])
    arrays = (frames,) if entry == "encode" else _planes(frames)
    enc = TorchMPEG1IntraEncoder(quality=QUALITY, device="cpu", max_slice_bytes=8)
    for calls in (1, 2):
        assert getattr(enc, entry)(*arrays) == reference(entry, *arrays)
        assert len(pads) == calls and sites == {"device": calls}
    assert enc.max_slice_bytes > 8


def test_coefficients_intake_counts_its_device_pad(sites):
    """The coefficients intake pads on the device too (`coeffs_to_planes`)."""
    enc = TorchMPEG1IntraEncoder(quality=QUALITY, device="cpu")
    for h, w, count in ((35, 50, 1), (32, 48, 1), (40, 64, 2)):
        ny, nc = -(-h // 8) * -(-w // 8), -(-h // 16) * -(-w // 16)
        coeffs = [np.zeros((1, n, 64), np.int16) for n in (ny, nc, nc)]
        enc.encode_from_coeffs(*coeffs, h, w)
        assert sites == {"device": count}
