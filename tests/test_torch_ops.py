"""The port's plain ops against the reference's, with xp=numpy and xp=jnp.

Inputs are made with numpy from a seed and fed to both sides.  Tolerance:
exact (0) — every op here is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models import mpeg1 as ref_mpeg1
from ec504_imageencoder_tpu.ops import bitpack as ref_bitpack
from ec504_imageencoder_tpu.ops import color as ref_color
from ec504_imageencoder_tpu.ops import dct as ref_dct
from ec504_imageencoder_tpu.ops import quant as ref_quant
from ec504_imageencoder_tpu.ops import vlc_device as ref_vlc
from ec504_imageencoder_tpu.ops import zigzag as ref_zigzag
from ec504_imageencoder_tpu_torch.ops import bitpack, color, dct, quant, vlc_device, zigzag
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts

XPS = pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jnp"])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(got.numpy(), want)


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


@XPS
@pytest.mark.parametrize("color_range", ["studio", "full"])
def test_color(rng, xp, color_range):
    rgb = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    fn = ref_color.rgb_to_ycbcr_studio if color_range == "studio" else ref_color.rgb_to_ycbcr
    want = fn(xp.asarray(rgb), xp)
    got = color.rgb_to_ycbcr(_t(rgb), color_range)
    for g, w in zip(got, want):
        assert _eq(g, w)


@XPS
@pytest.mark.parametrize("shape", [(2, 6, 8), (1, 7, 9)])
def test_subsample_420(rng, xp, shape):
    plane = rng.integers(0, 256, shape, dtype=np.uint8)
    assert _eq(color.subsample_420(_t(plane)), ref_color.subsample_420(xp.asarray(plane), xp))


@XPS
def test_aan_dct(rng, xp):
    blocks = rng.integers(0, 256, (3, 4, 8, 8), dtype=np.uint8)
    blocks[0, 0] = 255
    blocks[0, 1] = (np.indices((8, 8)).sum(0) % 2) * 255  # checkerboard
    assert _eq(dct.aan_dct(_t(blocks)), ref_dct.aan_dct(xp.asarray(blocks), xp))


@XPS
@pytest.mark.parametrize("quality", [5, 50, 69, 95])
def test_quantize_intra(rng, xp, quality):
    f = rng.integers(-2100, 2100, (6, 8, 8)).astype(np.int32)
    intra_q, qscale = ref_mpeg1.quality_to_quant(quality)
    qw = (intra_q * qscale).astype(np.int32)
    # the reference's quantizer, mpeg1._generic_pipeline_from_planes
    fx, qwx = xp.asarray(f), xp.asarray(qw)
    dc = xp.clip((fx[..., 0, 0] + 4) >> 3, 0, 255)
    num = 16 * xp.abs(fx) + qwx
    mag = num // (2 * qwx) if xp is np else ref_quant.exact_div_floor(num, 2 * qwx, xp)
    lvl = xp.sign(fx) * xp.clip(mag, 0, 255)
    got_dc, got_lvl = quant.quantize_intra(_t(f), _t(qw))
    assert _eq(got_dc, dc) and _eq(got_lvl, lvl)


@XPS
def test_zigzag_scan(rng, xp):
    blocks = rng.integers(-300, 300, (2, 3, 8, 8)).astype(np.int32)
    assert _eq(zigzag.zigzag_scan(_t(blocks)), ref_zigzag.zigzag_scan(xp.asarray(blocks), xp))


def _levels(rng, shape):
    """Zigzag blocks heavy in escapes: long runs, |level| up to 255."""
    zz = rng.integers(-255, 256, shape + (64,)).astype(np.int32)
    zz[rng.random(zz.shape) < 0.6] = 0
    zz[..., 1:40][rng.random(shape + (39,)) < 0.3] = 0
    zz[..., 0] = rng.integers(0, 256, shape)
    zz[0, 0, 1:63] = 0                  # run of 62 before slot 63
    zz[0, 0, 63] = -200
    zz[0, 1, 1:] = 0                    # empty block: EOB only
    zz[0, 2, 1] = 1                     # the '11s' special case
    zz[0, 2, 2] = -1
    return zz


@XPS
def test_block_streams_correct64(rng, xp):
    shape = (3, 6)
    zz = _levels(rng, shape)
    pred = rng.integers(0, 256, shape).astype(np.int32)
    is_luma = np.broadcast_to(np.array([1, 1, 1, 1, 0, 0], np.int32), shape)
    mb_first = np.broadcast_to(np.array([1, 0, 0, 0, 0, 0], np.int32), shape)
    want_c, want_l = ref_vlc.block_streams_correct64(
        xp.asarray(zz), xp.asarray(pred), xp.asarray(is_luma), xp, mb_first=xp.asarray(mb_first)
    )
    luts = Luts.default("cpu")
    got_c, got_l = vlc_device.block_streams_correct64(
        _t(zz), _t(pred), _t(is_luma), _t(mb_first),
        luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len,
    )
    assert _eq(got_c, np.asarray(want_c).astype(np.int64))
    assert _eq(got_l, np.asarray(want_l).astype(np.int64))
    assert int(got_l.max()) == 30  # a 28-bit escape with the EOB folded in


@XPS
def test_dc_predictors(rng, xp):
    dc = rng.integers(0, 256, (2, 3, 4, 6)).astype(np.int32)
    want = ref_mpeg1._dc_predictors(xp.asarray(dc), 2, 3, 4, xp)
    assert _eq(vlc_device.dc_predictors(_t(dc)), want)


def test_fuse4(rng):
    from ec504_imageencoder_tpu.ops.pallas_vlc import fuse_slots_streamwise

    r, nb = 3, 10
    lens = rng.integers(0, 31, (r, 64, nb)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.4] = 0
    codes = (rng.integers(0, 1 << 31, lens.shape) & ((1 << lens) - 1)).astype(np.uint32)
    want = fuse_slots_streamwise(jnp.asarray(codes), jnp.asarray(lens))
    # the port takes slots in stream order: (R, NB, 64) -> (R, NB * 64)
    stream = lambda a: _t(a.transpose(0, 2, 1).reshape(r, nb * 64))
    got = bitpack.fuse4(stream(codes.astype(np.int64)), stream(lens))
    for g, w in zip(got, want):
        assert _eq(g, np.asarray(w).astype(np.int64))


@XPS
@pytest.mark.parametrize("max_words", [64, 5])
def test_pack_words(rng, xp, max_words):
    """The prefix-sum pack with the slice-header offset; 5 words overflows."""
    lens = rng.integers(0, 33, (3, 100)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.3] = 0
    codes = (rng.integers(0, 1 << 32, lens.shape, dtype=np.uint64)
             & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    want_w, want_n = ref_bitpack.pack_words(xp.asarray(codes), xp.asarray(lens), max_words,
                                            xp=xp, bit_offset=38)
    got_w, got_n = bitpack.pack_words(_t(codes.astype(np.int64)), _t(lens), max_words, 38)
    assert _eq(got_w, np.asarray(want_w).astype(np.int64))
    assert _eq(got_n, np.asarray(want_n).astype(np.int64))
    assert _eq(bitpack.words_to_bytes(got_w), ref_bitpack.words_to_bytes(want_w, xp=xp))


@XPS
def test_or_slice_headers(rng, xp):
    seg = rng.integers(0, 256, (2, 4, 16), dtype=np.uint8)
    seg[..., :4] = 0
    seg[..., 4] &= 0x03  # the pack leaves the 38 header bits zero
    want, _ = ref_mpeg1._or_slice_headers(
        seg.copy() if xp is np else xp.asarray(seg), None, 2, 4, 12, xp
    )
    assert _eq(bitpack.or_slice_headers(_t(seg.copy()), 12), want)
