"""The port's RGB intake (`TorchMPEG1IntraEncoder.encode`) against the
benchmark's plain reference of it, and that reference's colour and
subsampling against the JAX package's.

On the CPU the port runs its kernels' plain twins; its bytes equal those
of `portbench/reference/entries/encode.py` (studio-range colour and the
truncating 4:2:0 mean in plain torch, then the plain numpy chain), for
ragged frames that need padding, at both DCTs, whole and with one
macroblock row of every frame stamped as the benchmark stamps it.  The
reference's colour equals `rgb_to_ycbcr_studio` on every RGB triple and
its subsampling equals `subsample_420` on odd and even sizes.
"""

from concurrent.futures import Future

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.ops import color as jax_color
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from portbench.reference import color
from portbench.reference.entries import encode as reference
from portbench.traffic import fixture_rgb


class _Inline:
    def submit(self, fn, *args):
        fut = Future()
        fut.set_result(fn(*args))
        return fut


def _config(b, h, w):
    return {"width": w, "height": h, "frames_per_call": b, "gop_size": 15,
            "frame_rate_code": 8}


def _expected(rgb, config, mix, first_frame_index, stamp=None):
    """The reference's stream of `rgb`, with `stamp` applied to it."""
    precision = reference.nominal(mix)
    batch = {"rgb": rgb}
    state = reference.prepare(batch, config, mix, precision, _Inline())
    if stamp is None:
        return reference.expected(state, config, mix, first_frame_index, {"rows": []}, [])
    undo = fixture_rgb.apply(batch, config, stamp)
    try:
        part = reference.submit(_Inline(), batch, config, mix, precision, stamp).result()
        stamped = rgb.copy()
    finally:
        undo()
    return reference.expected(state, config, mix, first_frame_index, stamp, part), stamped


@pytest.mark.parametrize("quality", [50, 85])
@pytest.mark.parametrize("b,h,w", [(2, 70, 130), (1, 144, 256), (3, 48, 64)])
def test_encode_equals_the_reference(quality, b, h, w):
    rgb = np.random.default_rng([quality, b, h, w]).integers(0, 256, (b, h, w, 3), np.uint8)
    config, mix = _config(b, h, w), {"quality": quality}
    enc = TorchMPEG1IntraEncoder(quality=quality, frame_rate_code=8, device="cpu")
    assert enc.encode(rgb, first_frame_index=14) == _expected(rgb, config, mix, 14)


@pytest.mark.parametrize("quality", [50, 85])
@pytest.mark.parametrize("k", [0, 5])
def test_stamped_rows_recoded_equal_the_port(quality, k):
    """The reference's per-call path (each frame's stamped macroblock row
    coded anew from its 16 RGB rows) gives the port's bytes of the stamped
    frames."""
    b, h, w = 3, 80, 96
    rng = np.random.default_rng([7, quality, k])
    rgb = fixture_rgb.make(_config(b, h, w), {}, rng)["rgb"]
    config, mix = _config(b, h, w), {"quality": quality}
    stamp = fixture_rgb.stamp(config, rng.integers(0, 2**62, (b, 2)), k)
    want, stamped = _expected(rgb, config, mix, 30, stamp)
    assert not np.array_equal(stamped, rgb)
    enc = TorchMPEG1IntraEncoder(quality=quality, frame_rate_code=8, device="cpu")
    assert enc.encode(stamped, first_frame_index=30) == want


@pytest.mark.parametrize("quarter", range(4))
def test_colour_equals_the_jax_package_on_every_triple(quarter):
    """A quarter of the 2**24 RGB triples a case (red's top two bits)."""
    v = np.arange(quarter << 22, (quarter + 1) << 22, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF], -1).astype(np.uint8)
    got = color.studio_ycbcr(torch.from_numpy(rgb))
    want = jax_color.rgb_to_ycbcr_studio(rgb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_control_colour_is_the_textbook_8_bit_rows():
    rows, bits = color.coefficients("fixed8")
    assert bits == 8 and rows == ((66, 129, 25), (-38, -74, 112), (112, -94, -18))
    rgb = np.random.default_rng(1).integers(0, 256, (64, 64, 3), np.uint8)
    a = color.studio_ycbcr(torch.from_numpy(rgb), "fixed16")
    c = color.studio_ycbcr(torch.from_numpy(rgb), "fixed8")
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    with pytest.raises(ValueError):
        color.coefficients("fixed4")


@pytest.mark.parametrize("h,w", [(7, 9), (8, 10), (15, 16), (16, 15), (33, 64), (1, 3)])
def test_subsample_equals_the_jax_package(h, w):
    plane = np.random.default_rng([h, w]).integers(0, 256, (2, h, w), np.uint8)
    got = color.subsample(torch.from_numpy(plane)).numpy()
    np.testing.assert_array_equal(got, jax_color.subsample_420(plane))


@pytest.mark.parametrize("h,w", [(70, 130), (16, 16), (17, 33)])
def test_padding_is_the_encoders(h, w):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import pad_to_macroblocks

    rgb = np.random.default_rng([h, w]).integers(0, 256, (2, h, w, 3), np.uint8)
    np.testing.assert_array_equal(color.pad_to_macroblocks(rgb), pad_to_macroblocks(rgb))
