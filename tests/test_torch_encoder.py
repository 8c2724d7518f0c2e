"""The port's encoder as a whole against the JAX encoder, on the CPU.

`TorchMPEG1IntraEncoder.from_reference(MPEG1IntraEncoder(backend="jax"),
"cpu")` runs the kernels' plain twins; its byte stream must equal the JAX
encoder's for the same frames.  Tolerance: exact (byte-identical).
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models.decoder import decode_es, psnr
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu.syntax import headers
from ec504_imageencoder_tpu_torch.device import resolve_device
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder


def _pair(**kw):
    ref = MPEG1IntraEncoder(backend="jax", **kw)
    return ref, TorchMPEG1IntraEncoder.from_reference(MPEG1IntraEncoder(backend="jax", **kw), "cpu")


@pytest.fixture(scope="module")
def odd_frames(fixture_frames):
    """Two natural frames of an odd size (75 x 101: padded to 80 x 112)."""
    return np.stack([fixture_frames["0"][100:175, 50:151], fixture_frames["2"][:75, 200:301]])


def _planes(frames):
    """JPEG-style 4:2:0 planes of odd size: chroma is ceil(H/2) x ceil(W/2)."""
    return (np.ascontiguousarray(frames[..., 0]),
            np.ascontiguousarray(frames[:, ::2, ::2, 1]),
            np.ascontiguousarray(frames[:, ::2, ::2, 2]))


@pytest.mark.parametrize("quality", [5, 12, 50, 69])
def test_encode_matches_jax(odd_frames, quality):
    ref, port = _pair(quality=quality)
    assert port.encode(odd_frames) == ref.encode(odd_frames)


@pytest.mark.parametrize("quality", [5, 12, 50, 69])
def test_encode_from_planes_matches_jax(odd_frames, quality):
    ref, port = _pair(quality=quality)
    planes = _planes(odd_frames)
    assert port.encode_from_planes(*planes) == ref.encode_from_planes(*planes)


def test_first_frame_index_across_gop(odd_frames):
    ref, port = _pair(quality=50, gop_size=2)
    got = port.encode(odd_frames, first_frame_index=1)
    assert got == ref.encode(odd_frames, first_frame_index=1)
    # frames 1 and 2: frame 2 opens a GOP (one sequence + GOP header)
    assert got.count(headers.SEQUENCE_START) == 1 and got.count(headers.GOP_START) == 1


def test_forced_regrow_matches_jax():
    frames = np.random.default_rng(5).integers(0, 256, (1, 16, 512, 3), dtype=np.uint8)
    ref, port = _pair(quality=50, max_slice_bytes=2560)
    got = port.encode(frames)
    assert got == ref.encode(frames)
    assert port.max_slice_bytes > 2560 and port.max_slice_bytes == ref.max_slice_bytes


def test_grow_slices_false_raises():
    frames = np.random.default_rng(5).integers(0, 256, (1, 16, 512, 3), dtype=np.uint8)
    _, port = _pair(quality=50, max_slice_bytes=2560, grow_slices=False)
    with pytest.raises(OverflowError):
        port.encode(frames)


def test_output_decodes(odd_frames):
    _, port = _pair(quality=50)
    dec = decode_es(port.encode(odd_frames) + headers.sequence_end())
    assert len(dec) == len(odd_frames)
    for f, d in zip(odd_frames, dec):
        assert d.shape == f.shape
        assert psnr(f, d) > 30.0


def test_encode_to_file(tmp_path, odd_frames):
    _, port = _pair(quality=50)
    path = tmp_path / "out.mpeg"
    n = port.encode_to_file(odd_frames, str(path))
    data = path.read_bytes()
    assert n == len(data) and data == port.encode(odd_frames) + headers.sequence_end()


def test_from_reference_copies_state():
    ref = MPEG1IntraEncoder(quality=37, frame_rate_code=5, gop_size=4, max_slice_bytes=3072,
                            backend="numpy", color_range="full", grow_slices=False)
    port = TorchMPEG1IntraEncoder.from_reference(ref, "cpu")
    for name in ("quality", "qscale", "dct_impl", "color_range", "frame_rate_code",
                 "gop_size", "max_slice_bytes", "grow_slices"):
        assert getattr(port, name) == getattr(ref, name), name
    assert np.array_equal(port.intra_q, ref.intra_q)
    assert torch.equal(port.core.qw, torch.from_numpy(ref.intra_q * ref.qscale).int())


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="A5"):
        TorchMPEG1IntraEncoder(quality=50, dct_impl="f32", device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        TorchMPEG1IntraEncoder(quality=80, device="cpu")  # auto picks f32
    port = TorchMPEG1IntraEncoder(quality=80, dct_impl="aan", device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        port.encode_from_coeffs(None, None, None, 16, 16)


def test_cuda_device_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test checks its absence")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchMPEG1IntraEncoder(quality=50, device="cuda")
    with pytest.raises(TypeError):
        TorchMPEG1IntraEncoder(quality=50)  # no default device
