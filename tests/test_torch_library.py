"""The port's library helpers against the reference's, on the CPU.

The colour default (C-p5), the slice compaction and its host inverse, the
compacted form of `assemble`, `pack_bytes`, the inverse AAN DCT and the f64
DCT oracles, dequantization and the exact floor division, the inverse
zigzag and the coefficient hook, the 65-slot correct-mode emission and the
bit writer's probes.  Inputs are made with numpy from a seed and fed to
both sides (the reference with xp=numpy, and its jnp compaction on the
CPU).  Tolerance: exact (0) everywhere: every function here is integer or
f64 arithmetic in the reference's order.
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
from ec504_imageencoder_tpu.syntax import bitwriter as ref_bitwriter
from ec504_imageencoder_tpu.utils.tables import INTRA_Q_MATRIX, scale_quantization_matrix
from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.ops import bitpack, color, dct, quant, vlc_device, zigzag
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
from ec504_imageencoder_tpu_torch.syntax import bitwriter


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(got.numpy(), want)


@pytest.fixture
def rng():
    return np.random.default_rng(20261017)


# ---- C-p5: rgb_to_ycbcr's default range ----------------------------------


def test_rgb_to_ycbcr_defaults_to_full_range_c_p5(rng):
    """A call written against the reference (one argument) gets the
    reference's full-range planes (hazard C-p5: the port's default was
    studio range)."""
    rgb = rng.integers(0, 256, (2, 9, 11, 3), dtype=np.uint8)
    rgb[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    got = color.rgb_to_ycbcr(_t(rgb))
    for g, w in zip(got, ref_color.rgb_to_ycbcr(rgb, xp=np)):
        assert _eq(g, w)
    assert int(got[0][0, 0, 0]) == 0 and int(got[0][0, 0, 1]) == 255  # full range


def test_rgb_to_ycbcr_studio_equals_reference(rng):
    rgb = rng.integers(0, 256, (2, 9, 11, 3), dtype=np.uint8)
    rgb[0, 0, :2] = [[0, 0, 0], [255, 255, 255]]
    got = color.rgb_to_ycbcr_studio(_t(rgb))
    for g, w, e in zip(got, ref_color.rgb_to_ycbcr_studio(rgb, xp=np),
                       color.rgb_to_ycbcr(_t(rgb), "studio")):
        assert _eq(g, w) and torch.equal(g, e)
    assert (int(got[0][0, 0, 0]), int(got[0][0, 0, 1])) == (16, 235)


def test_rgb_to_ycbcr_rejects_other_ranges():
    with pytest.raises(ValueError, match="color_range"):
        color.rgb_to_ycbcr(torch.zeros((1, 2, 2, 3), dtype=torch.uint8), "limited")


# ---- compact_slices and split_compact_slices ------------------------------


def _compact_case(rng, case):
    """(seg (B, S, msb) u8, bits (B, S) int32, cap_words) for a named case."""
    b, s, msb = 3, 5, 32
    mw = msb // 4
    seg = rng.integers(0, 256, (b, s, msb), dtype=np.uint8)
    bits = rng.integers(1, 8 * msb, (b, s)).astype(np.int32)
    if case == "zero-bit rows":
        bits[:, ::2] = 0
        bits[-1, -1] = 0
    elif case == "full rows":
        bits[:] = 8 * msb
    elif case == "overflowed rows":
        bits[0, 1] = 8 * msb + 100   # more words than the row holds: a zero gap
        bits[2, 0] = 20 * msb
    need = int(((bits.astype(np.int64) + 31) // 32).sum())
    cap = {"undersized cap (C-r4)": need // 2, "one row's words": mw,
           "bench.py's power-of-two cap": 1 << (b * s * mw + mw - 1).bit_length(),
           }.get(case, need + mw)  # the documented minimum
    return seg, bits, cap


COMPACT_CASES = ["random", "zero-bit rows", "full rows", "overflowed rows",
                 "undersized cap (C-r4)", "one row's words", "bench.py's power-of-two cap"]


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_slices_equals_reference(rng, case):
    """The whole dense buffer, tails, gaps and zeros included, and the
    offsets, word for word."""
    seg, bits, cap = _compact_case(rng, case)
    want_dense, want_offs = ref_bitpack.compact_slices(jnp.asarray(seg), jnp.asarray(bits), cap)
    dense, offs = bitpack.compact_slices(_t(seg), _t(bits), cap)
    assert dense.dtype == torch.int32 and offs.dtype == torch.int32
    assert _eq(dense, np.asarray(want_dense).view(np.int32))
    assert _eq(offs, np.asarray(want_offs))


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_split_compact_slices_equals_reference(rng, case):
    """The host inverse on the port's int32 words gives the reference's
    rows; with a cap of at least the documented minimum they are every
    slice's used bytes, and under it earlier slices are overwritten by the
    clamped later ones (hazard C-r4, reproduced, not repaired)."""
    seg, bits, cap = _compact_case(rng, case)
    dense, _ = bitpack.compact_slices(_t(seg), _t(bits), cap)
    want_dense, _ = ref_bitpack.compact_slices(jnp.asarray(seg), jnp.asarray(bits), cap)
    rows = bitpack.split_compact_slices(dense.numpy(), bits)
    want = ref_bitpack.split_compact_slices(np.asarray(want_dense), bits)
    assert [[bytes(r) for r in row] for row in rows] == [[bytes(r) for r in row] for row in want]
    used = [[bytes(seg[i, j, :(int(bits[i, j]) + 7) // 8]) for j in range(seg.shape[1])]
            for i in range(seg.shape[0])]
    intact = [[bytes(r) for r in row] for row in rows] == used
    minimum = int(((bits.astype(np.int64) + 31) // 32).sum()) + seg.shape[2] // 4
    if case == "overflowed rows":
        assert not intact  # a row past its buffer reads the next row's words and zeros
    else:
        assert intact == (cap >= minimum), case


def test_compact_slices_raises_below_one_row(rng):
    """cap_words < msb / 4: the reference's dynamic_update_slice raises
    TypeError, the port ValueError."""
    seg, bits, _ = _compact_case(rng, "random")
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        ref_bitpack.compact_slices(jnp.asarray(seg), jnp.asarray(bits), 7)
    with pytest.raises(ValueError, match="cap_words"):
        bitpack.compact_slices(_t(seg), _t(bits), 7)


def test_compact_slices_takes_sliced_and_unaligned_buffers(rng):
    """The encoder's fetch slices (seg[:, :, :n], not contiguous) and a
    buffer starting one byte into its storage give the same words as the
    contiguous copy."""
    seg, bits, cap = _compact_case(rng, "random")
    wide = np.zeros(seg.shape[:2] + (48,), np.uint8)
    wide[..., :32] = seg
    shifted = torch.cat([torch.zeros(1, dtype=torch.uint8), _t(seg).reshape(-1)])[1:]
    want = bitpack.compact_slices(_t(seg), _t(bits), cap)
    for s in (_t(wide)[:, :, :32], shifted.view(seg.shape)):
        got = bitpack.compact_slices(s, _t(bits), cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("quality", [50, 85])
def test_assemble_takes_compacted_rows(rng, quality):
    """assemble(rows) of the compacted slices equals assemble of the slice
    array, the encoder's own bytes and the reference's assemble(rows)."""
    y = rng.integers(0, 256, (3, 40, 72), dtype=np.uint8)
    cb = rng.integers(0, 256, (3, 20, 36), dtype=np.uint8)
    cr = rng.integers(0, 256, (3, 20, 36), dtype=np.uint8)
    enc = mpeg1.TorchMPEG1IntraEncoder(quality=quality, gop_size=2, device="cpu")
    want = enc.encode_from_planes(y, cb, cr)
    planes = [_t(p) for p in mpeg1.pad_planes_to_macroblocks(y, cb, cr)]
    seg, bits = mpeg1.correct_pipeline_planes(enc.core, *planes, enc.max_slice_bytes)
    b, s, msb = seg.shape
    cap = 1 << (b * s * msb // 4 + msb // 4 - 1).bit_length()
    dense, _ = bitpack.compact_slices(seg, bits, cap)
    rows = bitpack.split_compact_slices(dense.numpy(), bits.numpy())
    got = enc.assemble(rows, bits.numpy(), 72, 40)
    assert got == want == enc.assemble(seg.numpy(), bits.numpy(), 72, 40)
    ref = ref_mpeg1.MPEG1IntraEncoder(quality=quality, gop_size=2, backend="numpy")
    assert ref.assemble(rows, bits.numpy(), 72, 40) == got


# ---- pack_bytes -------------------------------------------------------------


@pytest.mark.parametrize("bit_offset", [0, 38])
def test_pack_bytes_equals_reference(rng, bit_offset):
    lens = rng.integers(0, 33, (2, 3, 40)).astype(np.int32)
    lens[0, 0, :5] = 0
    codes = rng.integers(0, 2**32, lens.shape, dtype=np.uint64).astype(np.uint32)
    codes = np.where(lens > 0, codes & ((1 << lens.astype(np.uint64)) - 1).astype(np.uint32), 0)
    for max_bytes in (64, 256):
        want_b, want_n = ref_bitpack.pack_bytes(codes, lens, max_bytes, np, bit_offset)
        got_b, got_n = bitpack.pack_bytes(_t(codes.astype(np.int64)), _t(lens), max_bytes,
                                          bit_offset)
        assert _eq(got_b, want_b) and _eq(got_n, np.asarray(want_n).astype(np.int64))
    with pytest.raises(ValueError):
        bitpack.pack_bytes(_t(codes.astype(np.int64)), _t(lens), 30)


# ---- the DCT helpers -------------------------------------------------------


def test_aan_idct_equals_reference(rng):
    """On the forward DCT's own output and on random coefficients
    (overflowing the u8 truncation and the clamps)."""
    px = rng.integers(0, 256, (4, 3, 8, 8), dtype=np.uint8)
    coeffs = ref_dct.aan_dct(px, np)
    wild = rng.integers(-2048, 2048, (5, 8, 8)).astype(np.int32)
    for c in (coeffs, wild):
        got = dct.aan_idct(_t(c))
        assert got.dtype == torch.uint8 and _eq(got, ref_dct.aan_idct(c, np))


def test_naive_dct_f64_equals_reference(rng):
    for _ in range(4):
        block = rng.integers(0, 256, (8, 8), dtype=np.uint8)
        f = dct.naive_dct_f64(block)
        assert np.array_equal(f, ref_dct.naive_dct_f64(block))
        assert np.array_equal(dct.naive_idct_f64(f), ref_dct.naive_idct_f64(f))
        assert np.array_equal(dct.naive_idct_f64(f), block)  # f64 round trip
        noisy = f + rng.normal(0, 40, f.shape)
        assert np.array_equal(dct.naive_idct_f64(noisy), ref_dct.naive_idct_f64(noisy))


# ---- quantization helpers ---------------------------------------------------


@pytest.mark.parametrize("quality", [1, 12, 50, 100])
def test_dequantize_equals_reference(rng, quality):
    levels = rng.integers(-255, 256, (3, 8, 8)).astype(np.int32)
    for m in (INTRA_Q_MATRIX, scale_quantization_matrix(quality)):
        assert _eq(quant.dequantize(_t(levels), _t(m)), ref_quant.dequantize(levels, m, np))


def test_exact_div_floor_equals_reference(rng):
    """On the reference's domain: 0 <= a < 2**23, q > 0."""
    a = np.concatenate([rng.integers(0, 2**23, 4000), [0, 1, 2**23 - 1]]).astype(np.int32)
    q = np.concatenate([rng.integers(1, 5000, 4000), [1, 7, 2**23 - 1]]).astype(np.int32)
    q[:100] = a[:100] // 3 + 1  # quotients near small integers
    want = ref_quant.exact_div_floor(a, q, np)
    assert _eq(quant.exact_div_floor(_t(a), _t(q)), want)
    assert np.array_equal(want, a // q)


# ---- zigzag helpers ---------------------------------------------------------


def test_zigzag_descan_equals_reference(rng):
    scanned = rng.integers(-300, 300, (2, 3, 64)).astype(np.int32)
    got = zigzag.zigzag_descan(_t(scanned))
    assert _eq(got, ref_zigzag.zigzag_descan(scanned, np))
    assert torch.equal(zigzag.zigzag_scan(got), _t(scanned))


def test_equalize_coefficients_is_the_identity(rng):
    zz = _t(rng.integers(-300, 300, (2, 64)).astype(np.int32))
    assert zigzag.equalize_coefficients(zz) is zz
    assert ref_zigzag.equalize_coefficients(zz.numpy(), np) is not None


# ---- the 65-slot correct-mode emission --------------------------------------


def test_block_streams_correct_equals_reference(rng):
    """65 slots: differential DC, the AC with true runs and sign bits (escapes
    of 20 and 28 bits), EOB."""
    shape = (3, 6)
    zz = rng.integers(-255, 256, shape + (64,)).astype(np.int32)
    zz[rng.random(zz.shape) < 0.6] = 0
    zz[..., 0] = rng.integers(0, 256, shape)
    zz[0, 0, 1:63] = 0          # a run of 62 before slot 63
    zz[0, 0, 63] = -200
    zz[0, 1, 1:] = 0            # EOB only
    zz[0, 2, 1:3] = [1, -1]     # the '11s' special case
    pred = rng.integers(0, 256, shape).astype(np.int32)
    is_luma = np.broadcast_to(np.array([1, 1, 1, 1, 0, 0], np.int32), shape)
    want_c, want_l = ref_vlc.block_streams_correct(zz, pred, is_luma, np)
    luts = Luts.default("cpu")
    got_c, got_l = vlc_device.block_streams_correct(
        _t(zz), _t(pred), _t(is_luma), luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len)
    assert _eq(got_c, want_c.astype(np.int64)) and _eq(got_l, want_l.astype(np.int64))
    assert got_l.shape[-1] == 65 and int(got_l.max()) == 28


# ---- BitWriter's probes and the scalar packer -------------------------------


def test_bitwriter_probes_equal_reference(rng):
    lens = rng.integers(0, 33, 50).astype(np.int32)
    codes = rng.integers(0, 2**32, 50, dtype=np.uint64)
    got, want = bitwriter.BitWriter(), ref_bitwriter.BitWriter()
    for w in (got, want):
        w.put_bits("0010")
        w.put_bits("")
        for c, n in zip(codes.tolist(), lens.tolist()):
            w.put(c, n)
        w.put_bits("1")
        w.align(1)
    assert got.tobytes() == want.tobytes() and got.nbits == want.nbits
    for g, w in zip(got.code_arrays(), want.code_arrays()):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert bitwriter.pack_codes(codes, lens) == ref_bitwriter.pack_codes(codes, lens)
