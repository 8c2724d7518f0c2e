"""The compat colour (`ops/cuda_vlc_compat.py::compat_color`) against the
host f64 colour it replaces, `ops/color.py::rgb_to_ycbcr_exact`.

On the CPU the plain twin runs; on the card the kernel
(`compat_color_launch`).  Both must give `rgb_to_ycbcr_exact`'s bytes for
every one of the 2^24 RGB triples: an operation in another order, in
another precision or contracted into an FMA rounds some value across an
integer.  On the card besides: ragged pixel counts (the scalar path and
its tail), an unaligned input view, and `encode_compat` on the card
against the golden stream and dumps, with the host colour out of its
route.  The card tests skip without a CUDA card (decided in a fixture);
this file imports nothing of the JAX package, so on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_compat_color.py

Tolerance: exact (0).
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.models import encoder
from ec504_imageencoder_tpu_torch.models.encoder import encode_compat
from ec504_imageencoder_tpu_torch.ops import _build, color
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_compat import compat_color

GOLDEN = Path(__file__).resolve().parent / "golden"
CHUNKS = 4  # the 2^24 triples on the CPU, 64 red values a test


def _all_triples(reds=range(256)) -> np.ndarray:
    """Every (r, g, b) with r in `reds`, as (1, len(reds) * 256, 256, 3) u8
    frames: r the row band, g the row within it, b the column."""
    r, g, b = np.meshgrid(np.asarray(reds, np.uint8), np.arange(256, dtype=np.uint8),
                          np.arange(256, dtype=np.uint8), indexing="ij")
    return np.stack([r, g, b], axis=-1).reshape(1, -1, 256, 3)


def _check_planes(got: torch.Tensor, rgb: np.ndarray) -> None:
    want = color.rgb_to_ycbcr_exact(rgb)
    assert got.shape == (3, *rgb.shape[:3]) and got.dtype == torch.uint8
    for name, g, w in zip(("y", "cb", "cr"), got.cpu().numpy(), want):
        bad = np.flatnonzero(g != w)
        assert bad.size == 0, f"{name}: {bad.size} values differ, first at {bad[:4]}"


def _golden():
    order = json.loads((GOLDEN / "frame_order.json").read_text())["unique_ids"]
    with np.load(GOLDEN / "fixture_rgb.npz") as z:
        frames = np.stack([z[k] for k in order])
    md5s = json.loads((GOLDEN / "bit_dump_md5.json").read_text())
    return frames, (GOLDEN / "awesome_video.mpeg").read_bytes(), md5s


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_twin_equals_host_colour_on_every_triple(chunk):
    n = 256 // CHUNKS
    rgb = _all_triples(range(chunk * n, (chunk + 1) * n))
    _check_planes(compat_color(torch.from_numpy(rgb)), rgb)


@pytest.mark.parametrize("shape", [(2, 150, 101), (1, 1, 1), (3, 7, 5)])
def test_twin_returns_one_buffer_of_three_planes(shape):
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    planes = compat_color(torch.from_numpy(rgb))
    y, cb, cr = planes
    assert y.shape == cb.shape == cr.shape == shape
    assert cb.data_ptr() - y.data_ptr() == cr.data_ptr() - cb.data_ptr() == y.numel()
    _check_planes(planes, rgb)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros((2, 4, 4, 3), dtype=torch.int16), TypeError),
    (torch.zeros((2, 4, 4), dtype=torch.uint8), ValueError),
    (torch.zeros((4, 4, 3), dtype=torch.uint8), ValueError),
    (torch.zeros((1, 4, 4, 4), dtype=torch.uint8), ValueError),
], ids=["int16", "no-channels", "no-batch", "four-channels"])
def test_bad_frames_raise(bad, err):
    with pytest.raises(err):
        compat_color(bad)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_compat_color.py`")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
def test_kernel_equals_host_colour_on_every_triple(cuda):
    rgb = _all_triples()
    before = _build.launches["compat_color"]
    planes = compat_color(torch.from_numpy(rgb).to(cuda))
    torch.cuda.synchronize()
    assert _build.launches["compat_color"] == before + 1
    _check_planes(planes, rgb)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [
    (1, 1, 1), (1, 1, 15), (1, 1, 16), (1, 1, 17), (1, 64, 64), (1, 80, 80), (1, 4097, 1),
    (2, 150, 101), (3, 37, 41), (30, 150, 101),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_on_ragged_pixel_counts(cuda, shape):
    """Pixel counts with tails of 1-15 pixels past a multiple of 16 (the
    scalar path) and whole multiples (the wide path), each with a whole or
    a partial last CUDA block of 4096 pixels."""
    rng = np.random.default_rng(sum(shape) * 31 + shape[0])
    rgb = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    _check_planes(compat_color(torch.from_numpy(rgb).to(cuda)), rgb)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("shape", [(2, 64, 32), (2, 150, 101)], ids=["n%16=0", "ragged"])
def test_kernel_on_an_unaligned_view(cuda, offset, shape):
    """Frames that start `offset` bytes into a buffer: the scalar path, even
    where the pixel count would take the wide one."""
    rng = np.random.default_rng(offset)
    n = int(np.prod(shape)) * 3
    flat = torch.from_numpy(rng.integers(0, 256, n + offset, dtype=np.uint8)).to(cuda)
    view = flat[offset:].view(*shape, 3)
    assert view.data_ptr() % 16 == offset % 16
    _check_planes(compat_color(view), view.cpu().numpy())


@pytest.mark.requires_cuda
def test_kernel_runs_on_the_current_stream(cuda):
    rgb = np.random.default_rng(7).integers(0, 256, (4, 96, 160, 3), dtype=np.uint8)
    src = torch.from_numpy(rgb).to(cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        planes = compat_color(src)
        got = planes.cpu()
    _check_planes(got, rgb)


@pytest.mark.requires_cuda
def test_launch_leaves_the_current_device(cuda):
    """The launch runs on the frames' card and leaves the caller's current
    device as it was (with one card, only that it stays current)."""
    n = torch.cuda.device_count()
    rgb = np.random.default_rng(9).integers(0, 256, (1, 16, 24, 3), dtype=np.uint8)
    for index in range(n):
        src = torch.from_numpy(rgb).to(torch.device("cuda", index))
        current = (index + 1) % n
        with torch.cuda.device(current):
            planes = compat_color(src)
            assert torch.cuda.current_device() == current
        assert planes.device == src.device
        _check_planes(planes, rgb)


@pytest.mark.requires_cuda
def test_kernel_rejects_a_strided_view(cuda):
    rgb = torch.zeros((2, 16, 32, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        compat_color(rgb[:, :, ::2])


@pytest.mark.requires_cuda
def test_encode_compat_on_the_card_is_golden(cuda):
    frames, mpeg, md5s = _golden()
    before = _build.launches["compat_color"]
    got, dumps = encode_compat(frames, 12, device=cuda)
    assert _build.launches["compat_color"] == before + 1
    assert got == mpeg
    assert [hashlib.md5(d).hexdigest() for d in dumps] == [
        md5s[f"image_{i + 1}.bit"] for i in range(len(frames))]
    assert (got, dumps) == encode_compat(frames, 12, device="cpu")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("debug_checks", [False, True], ids=["fused", "raw-slots"])
def test_encode_compat_counts_one_colour_launch_a_call(cuda, debug_checks):
    frames = np.random.default_rng(11).integers(0, 256, (3, 150, 101, 3), dtype=np.uint8)
    want = encode_compat(frames, 12, device="cpu", debug_checks=debug_checks)
    before = _build.launches["compat_color"]
    for i in range(3):
        assert encode_compat(frames, 12, device=cuda, debug_checks=debug_checks) == want
        assert _build.launches["compat_color"] == before + i + 1


@pytest.mark.requires_cuda
def test_encode_compat_on_the_card_never_calls_the_host_colour(cuda, monkeypatch):
    def forbidden(rgb):
        raise AssertionError("the host colour ran on the card's route")

    frames = np.random.default_rng(5).integers(0, 256, (2, 150, 101, 3), dtype=np.uint8)
    want = encode_compat(frames, 12, device="cpu")
    monkeypatch.setattr(color, "rgb_to_ycbcr_exact", forbidden)
    monkeypatch.setattr(encoder, "rgb_to_ycbcr_exact", forbidden, raising=False)
    assert encode_compat(frames, 12, device=cuda) == want
