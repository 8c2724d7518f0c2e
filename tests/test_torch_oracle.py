"""The port's scalar oracles against the reference's, on the host.

`ops/rle_vlc.py` (run-length pairs, the compat and correct block codes,
the AC, DC and motion-vector codes) on random zigzag blocks with escapes,
long runs and the (run 16, |level| 2) pair of hazard C-r5: the compat
codes follow the reference C encoder's table (its 15-bit typo), the
correct codes ISO table B.5c/d (16 bits).  `models/oracle.py`: the scalar
compat encoder byte-equal to the reference's oracle on small frames and
to the C encoder's golden stream and .bit dumps.  Tolerance: exact (0).
"""

import hashlib
import json

import numpy as np
import pytest

from ec504_imageencoder_tpu.models import oracle as ref_oracle
from ec504_imageencoder_tpu.ops import rle_vlc as ref_rle
from ec504_imageencoder_tpu_torch.models import oracle
from ec504_imageencoder_tpu_torch.ops import rle_vlc


@pytest.fixture
def rng():
    return np.random.default_rng(20261018)


def _blocks(rng, n):
    """n zigzag blocks: sparse levels up to |255| (escapes of 20 and 28
    bits), zero and negative DCs, long runs, adjacent nonzero ACs (the
    compat truncation) and the C-r5 pair."""
    zz = rng.integers(-255, 256, (n, 64)).astype(np.int32)
    zz[rng.random(zz.shape) < 0.75] = 0
    small = rng.random(zz.shape) < 0.6
    zz[small] = np.sign(zz[small]) * rng.integers(1, 42, int(small.sum()))
    zz[0] = 0                                   # all zero
    zz[1, 1:] = 0
    zz[1, 63] = -200                            # a run of 62, a long escape
    zz[2, :20] = 0
    zz[2, 0], zz[2, 17], zz[2, 18] = -77, 2, 5  # run 16, |level| 2 (C-r5), then adjacent
    zz[3, :20] = 0
    zz[3, 0], zz[3, 18] = 300, -2               # compat: 17 zeros before (run index 16)
    return zz


def test_rle_pairs(rng):
    for zz in _blocks(rng, 40):
        assert rle_vlc.rle_pairs(zz) == ref_rle.rle_pairs(zz)


@pytest.mark.parametrize("is_luma", [True, False])
def test_compat_block_codes(rng, is_luma):
    for zz in _blocks(rng, 200):
        assert rle_vlc.compat_block_codes(zz, is_luma) == ref_rle.compat_block_codes(zz, is_luma)


@pytest.mark.parametrize("is_luma", [True, False])
def test_correct_block_codes(rng, is_luma):
    pred = 128
    for zz in _blocks(rng, 200):
        zz[0] = abs(int(zz[0])) % 256
        got = rle_vlc.correct_block_codes(zz, is_luma, pred)
        assert got == ref_rle.correct_block_codes(zz, is_luma, pred)
        pred = got[1]


def test_the_c_r5_pair_follows_each_modes_table():
    """(run 16, |level| 2): compat codes the C encoder's 15-bit typo (17
    zeros before: run index 16), correct mode the ISO 16-bit code plus its
    sign bit."""
    assert rle_vlc.compat_ac_code(17, 2) == ref_rle.compat_ac_code(17, 2) == [(0b10101, 15)]
    assert rle_vlc.correct_ac_code(16, -2, first=False) == \
        ref_rle.correct_ac_code(16, -2, first=False) == [(0b101011, 17)]


def test_ac_and_dc_codes_over_their_domains():
    for zeros_before in range(1, 65):
        for level in (*range(-255, 0), *range(1, 256)):
            assert rle_vlc.compat_ac_code(zeros_before, level) == \
                ref_rle.compat_ac_code(zeros_before, level)
            assert rle_vlc.correct_ac_code(zeros_before - 1, level, first=zeros_before == 1) == \
                ref_rle.correct_ac_code(zeros_before - 1, level, first=zeros_before == 1)
    for diff in range(-255, 256):
        for is_luma in (True, False):
            assert rle_vlc.correct_dc_codes(diff, is_luma) == ref_rle.correct_dc_codes(diff, is_luma)
        assert rle_vlc.dc_size(diff) == ref_rle.dc_size(diff)
    for bad in ((1, 256), (1, -300)):
        with pytest.raises(ValueError):
            rle_vlc.compat_ac_code(*bad)
    with pytest.raises(ValueError):
        rle_vlc.correct_dc_codes(300, True)


def test_mv_code():
    for v in range(-16, 17):
        assert rle_vlc.mv_code(v) == ref_rle.mv_code(v)
    for v in (-17, 17):
        with pytest.raises(ValueError):
            rle_vlc.mv_code(v)


@pytest.mark.parametrize("quality,width", [(12, 96), (50, 101), (100, 144)])
def test_oracle_encode_compat_equals_reference(rng, quality, width):
    frames = [rng.integers(0, 256, (144, width, 3), dtype=np.uint8) for _ in range(2)]
    frames[1][:, :, :] = frames[1][:1, :1, :]  # a flat frame: every AC level 0
    assert oracle.encode_compat(frames, quality) == ref_oracle.encode_compat(frames, quality)


def test_oracle_encode_compat_equals_the_golden_stream(fixture_frames, frame_order, golden_mpeg,
                                                       golden_dir):
    """The C encoder's 30 frames at quality 12: the stream and every .bit
    dump."""
    frames = [fixture_frames[k] for k in frame_order]
    mpeg, dumps = oracle.encode_compat(frames, 12)
    assert mpeg == golden_mpeg
    md5s = json.loads((golden_dir / "bit_dump_md5.json").read_text())
    assert [hashlib.md5(d).hexdigest() for d in dumps] == [
        md5s[f"image_{i + 1}.bit"] for i in range(len(frames))]
