"""The port's compat-mode encoder against the reference C encoder's golden
stream and the JAX package's numpy compat path, on the CPU.

`encode_compat(frames, quality, device="cpu")` runs the kernels' plain
twins (B4b, or B4a with debug_checks, then B2).  Tolerance: exact
(byte-identical streams, identical .bit dump md5s).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models.encoder import encode_compat as reference_encode_compat
from ec504_imageencoder_tpu_torch.models.encoder import CompatCore, encode_compat


@pytest.fixture(scope="module")
def golden_frames(fixture_frames, frame_order):
    return np.stack([fixture_frames[k] for k in frame_order])


@pytest.mark.parametrize("debug_checks", [False, True], ids=["fused", "raw-slots"])
def test_golden_stream_and_dumps(golden_frames, golden_mpeg, golden_dir, debug_checks):
    mpeg, dumps = encode_compat(golden_frames, 12, device="cpu", debug_checks=debug_checks)
    assert mpeg == golden_mpeg
    md5s = json.loads((golden_dir / "bit_dump_md5.json").read_text())
    assert len(dumps) == len(md5s)
    for i, dump in enumerate(dumps):
        assert hashlib.md5(dump).hexdigest() == md5s[f"image_{i + 1}.bit"], i


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_odd_width_matches_numpy_reference(quality):
    """Width 401: the chroma half-stride view (quirk Q3) at an odd width."""
    rng = np.random.default_rng(quality)
    frames = rng.integers(0, 256, (2, 151, 401, 3), dtype=np.uint8)
    frames[1] = np.linspace(0, 255, 401, dtype=np.uint8)[None, :, None]  # smooth
    got, got_dumps = encode_compat(frames, quality, device="cpu")
    want, want_dumps = reference_encode_compat(frames, quality, backend="numpy")
    assert got == want
    assert got_dumps == want_dumps


@pytest.mark.parametrize("shape", [(1, 143, 200, 3), (1, 200, 95, 3), (2, 144, 96)])
def test_bad_frames_raise(shape):
    with pytest.raises(ValueError):
        encode_compat(np.zeros(shape, np.uint8), 12, device="cpu")


def test_debug_checks_count_violations(golden_frames):
    """The raw-slot checks (the reference's EC504_DEBUG_CHECKS) count code
    bits above the length and lengths over 30, and stay silent on real
    slots."""
    from ec504_imageencoder_tpu_torch.ops.vlc_device import slot_violations

    codes = torch.tensor([[[0b101, 0b1], [7, 0]], [[0, 0], [1, 1]]])
    lens = torch.tensor([[[2, 1], [31, 0]], [[0, 0], [1, 1]]])
    assert slot_violations(codes, lens).tolist() == [2, 0]  # bits above length; len 31
    core = CompatCore(12)
    y = torch.from_numpy(golden_frames[:1, ..., 0].copy())
    _, nbits = core(y, y, y, debug_checks=True)
    assert (nbits > 0).all()
