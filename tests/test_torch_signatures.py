"""The port's entry points take the reference's calls (ROADMAP C-p4), on
the CPU.

- `encode_compat(..., batch_size=...)` is accepted and ignored, as the
  reference's is: the same bytes with it as without it.
- `TorchMPEG1IntraEncoder` takes quality, frame_rate_code, gop_size and
  max_slice_bytes positionally, as the reference does; everything after
  them is keyword-only, so the reference's fifth positional argument
  (`backend`) raises TypeError instead of landing on another keyword.
"""

import numpy as np
import pytest

from ec504_imageencoder_tpu.models.encoder import encode_compat as reference_encode_compat
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.models.encoder import encode_compat
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder


@pytest.fixture(scope="module")
def compat_frames():
    return np.random.default_rng(46).integers(0, 256, (5, 144, 96, 3), dtype=np.uint8)


@pytest.mark.parametrize("batch_size", [None, 1, 4, 64])
def test_encode_compat_ignores_batch_size(compat_frames, batch_size):
    got = encode_compat(compat_frames, 12, device="cpu", batch_size=batch_size)
    assert got == encode_compat(compat_frames, 12, device="cpu")
    want = reference_encode_compat(compat_frames, 12, backend="numpy", batch_size=batch_size)
    assert got == want


@pytest.mark.parametrize("fifth", ["jax", "numpy", "aan", "f32"])
def test_fifth_positional_argument_raises(fifth):
    with pytest.raises(TypeError):
        TorchMPEG1IntraEncoder(50, 3, 15, None, fifth, device="cpu")


def test_leading_positional_arguments_match_the_reference():
    frames = np.random.default_rng(47).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    port = TorchMPEG1IntraEncoder(50, 3, 15, 2560, device="cpu")
    assert (port.quality, port.frame_rate_code, port.gop_size, port.max_slice_bytes) == (
        50, 3, 15, 2560)
    ref = MPEG1IntraEncoder(50, 3, 15, 2560, backend="numpy")
    assert port.encode(frames) == ref.encode(frames)
    again = TorchMPEG1IntraEncoder.from_reference(MPEG1IntraEncoder(50, 3, 15, 2560), device="cpu")
    assert again.encode(frames) == port.encode(frames)
