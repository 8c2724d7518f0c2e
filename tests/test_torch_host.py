"""The port's own copies of the reference's host code, held to the reference.

The port imports nothing of the JAX package, so it keeps copies of the
host code it needs: the tables and packed lookup tables, the f32 DCT
basis, the compat colour, the decoder's upsampling and colour, quality to quantizer, slice sizing, padding, the
header builders and the compat constants.  Each is compared here with the
reference's own, for every quality 1..100 and a range of sizes.
Tolerance: exact (0).
"""

import numpy as np
import pytest

from ec504_imageencoder_tpu.models import encoder as ref_encoder
from ec504_imageencoder_tpu.models import mpeg1 as ref_mpeg1
from ec504_imageencoder_tpu.ops import color as ref_color
from ec504_imageencoder_tpu.ops import dct as ref_dct
from ec504_imageencoder_tpu.ops import mxu_lut as ref_mxu_lut
from ec504_imageencoder_tpu.syntax import bitwriter as ref_bitwriter
from ec504_imageencoder_tpu.syntax import headers as ref_headers
from ec504_imageencoder_tpu.utils import tables as ref_tables
from ec504_imageencoder_tpu_torch.models import encoder, mpeg1
from ec504_imageencoder_tpu_torch.ops import color, dct
from ec504_imageencoder_tpu_torch.syntax import bitwriter, headers
from ec504_imageencoder_tpu_torch.utils import tables

QUALITIES = list(range(1, 101))
WIDTHS = [16, 96, 101, 720, 1280, 1920, 2048, 3840, 4095]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", [
    "INTRA_Q_MATRIX", "ZIGZAG_INDEX", "ZIGZAG_GATHER", "DC_SIZE_LUMA_CODE", "DC_SIZE_LUMA_LEN",
    "DC_SIZE_CHROMA_CODE", "DC_SIZE_CHROMA_LEN", "AC_CODE_COMPAT", "AC_LEN_COMPAT",
    "AC_CODE_CORRECT", "AC_LEN_CORRECT", "MAX_RUN", "MAX_AC_LEVEL",
    "MB_ADDRESS_CODE", "MB_ADDRESS_LEN", "MB_STUFFING", "MB_ESCAPE",
])
def test_table(name):
    assert _same(getattr(tables, name), getattr(ref_tables, name))


def test_packed_tables():
    assert _same(tables.ac_packed_table(), ref_mxu_lut.ac_packed_table())
    assert _same(tables._dc_packed(), ref_mxu_lut._dc_packed())
    assert _same(tables.AC_RANK_CODE, ref_mxu_lut.AC_RANK_CODE)
    assert _same(tables.AC_RANK_LEN, ref_mxu_lut.AC_RANK_LEN)
    # the (16, 2) typo of the compat table, and the ISO code beside it
    assert tables.AC_LEN_COMPAT[16, 2] == 15 and tables.AC_LEN_CORRECT[16, 2] == 16


def test_dct_basis():
    assert _same(dct.dct_matrix_f32(), ref_dct.dct_matrix_f32())


def test_compat_colour():
    rgb = np.random.default_rng(0).integers(0, 256, (3, 37, 53, 3), dtype=np.uint8)
    for got, want in zip(color.rgb_to_ycbcr_exact(rgb), ref_color.rgb_to_ycbcr_exact(rgb)):
        assert _same(got, want)


@pytest.mark.parametrize("shape", [(4, 3), (2, 5, 7), (3, 8, 8)])
def test_upsample_420(shape):
    p = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    assert _same(color.upsample_420(p), ref_color.upsample_420(p, np))


@pytest.mark.parametrize("color_range", ["studio", "full"])
def test_ycbcr_to_rgb_f32(color_range):
    """The decoder's colour on every Y value and a grid of chroma pairs,
    planes of odd size: exact, the reference's f32 operations in order."""
    rng = np.random.default_rng(2)
    y = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None], (256, 33)).copy()
    cb = rng.integers(0, 256, (256, 33), dtype=np.uint8)
    cr = rng.integers(0, 256, (256, 33), dtype=np.uint8)
    cb[:, 0], cr[:, 0] = np.arange(256), 255 - np.arange(256)
    assert _same(color.ycbcr_to_rgb_f32(y, cb, cr, color_range=color_range),
                 ref_color.ycbcr_to_rgb_f32(y, cb, cr, np, color_range=color_range))


def test_ycbcr_to_rgb_f32_rejects_a_range():
    z = np.zeros((2, 2), np.uint8)
    with pytest.raises(ValueError) as want:
        ref_color.ycbcr_to_rgb_f32(z, z, z, np, color_range="pc")
    with pytest.raises(ValueError) as got:
        color.ycbcr_to_rgb_f32(z, z, z, color_range="pc")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("quality", QUALITIES)
def test_quality_to_quant(quality):
    got_w, got_s = mpeg1.quality_to_quant(quality)
    want_w, want_s = ref_mpeg1.quality_to_quant(quality)
    assert _same(got_w, want_w) and got_s == want_s
    assert _same(tables.scale_quantization_matrix(quality),
                 ref_tables.scale_quantization_matrix(quality))


@pytest.mark.parametrize("width", WIDTHS)
def test_slice_sizing(width):
    mbw = -(-width // 16)
    assert mpeg1.worst_case_slice_bytes(mbw) == ref_mpeg1.worst_case_slice_bytes(mbw)
    for q in QUALITIES:
        assert mpeg1.initial_slice_bytes(q, mbw) == ref_mpeg1.initial_slice_bytes(q, mbw)
    for nbytes in (1, 2560, 2561, 23_000 * mbw // 120, 342_528):
        assert mpeg1.slice_bytes_bucket(nbytes) == ref_mpeg1.slice_bytes_bucket(nbytes)


@pytest.mark.parametrize("height,width", [(16, 16), (75, 101), (144, 96), (1080, 1920)])
def test_padding(height, width):
    rng = np.random.default_rng(height + width)
    frames = rng.integers(0, 256, (2, height, width, 3), dtype=np.uint8)
    assert _same(mpeg1.pad_to_macroblocks(frames), ref_mpeg1.pad_to_macroblocks(frames))
    planes = (frames[..., 0], frames[:, ::2, ::2, 1], frames[:, ::2, ::2, 2])
    for got, want in zip(mpeg1.pad_planes_to_macroblocks(*planes),
                         ref_mpeg1.pad_planes_to_macroblocks(*planes)):
        assert _same(got, want)


@pytest.mark.parametrize("quality", QUALITIES)
def test_sequence_header(quality):
    intra_q, _ = mpeg1.quality_to_quant(quality)
    for width, height in ((16, 16), (101, 75), (1920, 1080), (4095, 2800)):
        for code in (1, 3, 8):
            assert (mpeg1.sequence_header_es(width, height, code, intra_matrix=intra_q)
                    == ref_mpeg1.sequence_header_es(width, height, code, intra_matrix=intra_q))
    assert mpeg1.sequence_header_es(32, 32) == ref_mpeg1.sequence_header_es(32, 32)


def test_gop_picture_and_system_headers():
    for index in (0, 1, 24, 25, 1499, 90_000, 400_000):
        for fps in (23.976, 25.0, 29.97, 60.0):
            assert mpeg1.gop_header_es(index, fps) == ref_mpeg1.gop_header_es(index, fps)
    for t in (0, 1, 14, 1023):
        assert headers.picture_header(t) == ref_headers.picture_header(t)
    for i in range(0, 40, 3):
        assert headers.pes_packet_header(1 + 3600 * i) == ref_headers.pes_packet_header(1 + 3600 * i)
        assert headers.gop_header(hour=i, minute=0, second=0) == ref_headers.gop_header(
            hour=i, minute=0, second=0)
    assert headers.pes_packet_header(0) == ref_headers.pes_packet_header(0)
    assert headers.pack_header(2202035) == ref_headers.pack_header(2202035)
    assert headers.system_header(2202035, 0xE6) == ref_headers.system_header(2202035, 0xE6)
    for w, h in ((96, 144), (101, 150), (600, 400)):
        assert headers.sequence_header(w & 0xFF, h & 0xFF) == ref_headers.sequence_header(
            w & 0xFF, h & 0xFF)
    for name in ("SEQUENCE_START", "SEQUENCE_END", "GOP_START", "PICTURE_START",
                 "COMPAT_SEQUENCE_END_GARBAGE"):
        assert getattr(headers, name) == getattr(ref_headers, name), name
    assert headers.sequence_end() == ref_headers.sequence_end()
    frame = bytearray(ref_headers.pes_packet_header(3601) + bytes(range(200)))
    mine = bytearray(frame)
    headers.patch_pes_length(mine)
    ref_headers.patch_pes_length(frame)
    assert mine == frame
    y = np.arange(96 * 144, dtype=np.uint8)
    assert (headers.raw_plane_dump(96, 144, y, y, y)
            == ref_headers.raw_plane_dump(96, 144, y, y, y))


def test_bitwriter():
    rng = np.random.default_rng(9)
    ours, ref = bitwriter.BitWriter(), ref_bitwriter.BitWriter()
    for _ in range(300):
        n = int(rng.integers(0, 33))
        code = int(rng.integers(0, 1 << 32))
        ours.put(code, n)
        ref.put(code, n)
    ours.put_bytes(b"\x00\x01\xb3")
    ref.put_bytes(b"\x00\x01\xb3")
    ours.align(1)
    ref.align(1)
    assert ours.nbits == ref.nbits and ours.tobytes() == ref.tobytes()


def test_compat_constants_and_validation():
    for name in ("CROP_W", "CROP_H", "N_SLICES", "N_MBS", "QUANT_SCALE", "MAX_SLICE_BYTES_COMPAT"):
        assert getattr(encoder, name) == getattr(ref_encoder, name), name
    bad = [np.zeros((2, 143, 96, 3), np.uint8), np.zeros((2, 144, 95, 3), np.uint8),
           np.zeros((2, 144, 96), np.uint8), np.zeros((2, 144, 96, 3), np.int16)]
    for frames in bad:
        with pytest.raises(ValueError) as got:
            encoder._validate_frames(frames)
        with pytest.raises(ValueError) as want:
            ref_encoder._validate_frames(frames)
        assert str(got.value) == str(want.value)
    encoder._validate_frames(np.zeros((1, 144, 96, 3), np.uint8))


def test_frame_rate_and_size_limits():
    assert mpeg1.FRAME_RATE_CODES == ref_mpeg1.FRAME_RATE_CODES
    assert mpeg1.FRAME_RATE_VALUES == ref_mpeg1.FRAME_RATE_VALUES
    assert (mpeg1.MAX_WIDTH, mpeg1.MAX_HEIGHT) == (ref_mpeg1.MAX_WIDTH, ref_mpeg1.MAX_HEIGHT)
