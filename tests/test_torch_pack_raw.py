"""The raw-code pack kernels' plain twins (K1-K4) against the Pallas
kernels they replace, on the CPU.

Five Pallas kernels of `ec504_imageencoder_tpu/ops/pallas_pack.py`
compute `bitpack.pack_words` of raw codes of <= 32 bits; the port runs
them behind `TorchMPEG1IntraEncoder(pack=...)`:

| TPU kernel (launcher) | port wrapper (kernel) |
|---|---|
| B6d `_pack_kernel` (`pack_words_pallas`) | `cuda_pack.pack_raw` (K1) |
| B6e `_pack2_kernel` (`pack_words_pallas2`) | `cuda_pack.pack_raw` (K1) |
| B6f `_pack3_kernel` (`pack_words_pallas3`) | `cuda_pack_split.pack_windows` (K3) |
| B6g `_fused_kernel` (`pack_words_fused`) | `cuda_pack_split.pack_split` (K4) |
| B6h `_fused2w_kernel` (`pack_words_fused2w`) | `cuda_pack.pack_pairs` (K2) |

On CPU tensors each wrapper runs its twin.  The launchers run here in
Pallas's TPU interpret mode (`pltpu.force_tpu_interpret_mode()`), at one
shared shape so each compiles once, with small `group` values where the
defaults would pad far past it.  B6e's launcher does not run on the CPU
(its bf16 x bf16 -> f32 product is unimplemented there), so it, like every
twin, is also held against the reference's numpy `bitpack.pack_words`, at
buffers the TPU kernels refuse (not a multiple of 128, below their
windows) and one that overflows with the true bit count kept.
Tolerance: exact (0).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ec504_imageencoder_tpu.ops.bitpack import pack_words as ref_pack_words
from ec504_imageencoder_tpu.ops.pallas_pack import (
    _fuse2_32,
    pack_words_fused,
    pack_words_fused2w,
    pack_words_pallas,
    pack_words_pallas3,
)
from ec504_imageencoder_tpu_torch.ops import bitpack, cuda_pack, cuda_pack_split
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import to_i32_bits

MAX_WORDS = 1280
BIT_OFFSET = 38

# kernel -> (port wrapper, the launcher it replaces or None)
KERNELS = {
    "B6d": (cuda_pack.pack_raw,
            lambda c, l: pack_words_pallas(c, l, MAX_WORDS, bit_offset=BIT_OFFSET)),
    "B6e": (cuda_pack.pack_raw, None),
    "B6f": (cuda_pack_split.pack_windows,
            lambda c, l: pack_words_pallas3(c, l, MAX_WORDS, bit_offset=BIT_OFFSET)),
    "B6g": (cuda_pack_split.pack_split,
            lambda c, l: pack_words_fused(c, l, MAX_WORDS, group=2, bit_offset=BIT_OFFSET)),
    "B6h": (cuda_pack.pack_pairs,
            lambda c, l: pack_words_fused2w(c, l, MAX_WORDS, group=1, bit_offset=BIT_OFFSET)),
}


def _raw(rng, shape, lo: int = 0, zeros: float = 0.0):
    """Random raw codes of lo..32 bits (u32, masked to their lengths; a
    share `zeros` of empty slots) and int32 lengths."""
    lens = rng.integers(lo, 33, shape).astype(np.int32)
    lens[rng.random(shape) < zeros] = 0
    mask = (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    codes = (rng.integers(0, 1 << 32, shape, dtype=np.uint64) & mask).astype(np.uint32)
    return codes, lens


def _port(fn, codes, lens, max_words):
    seg, nbits = fn(torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lens),
                    max_words, bit_offset=BIT_OFFSET)
    assert seg.dtype == torch.uint8 and nbits.dtype == torch.int32
    assert seg.shape == (lens.shape[0], 4 * max_words)
    return seg.numpy(), nbits.numpy()


def _stream_bytes(words):
    """Big-endian u32 words -> their bytes in stream order."""
    return np.asarray(words).astype(">u4").view(np.uint8).reshape(len(words), -1)


@pytest.mark.parametrize("fill", ["fits", "overflows"])
@pytest.mark.parametrize("kernel", ["B6d", "B6f", "B6g", "B6h"])
def test_twin_matches_interpret_launcher(kernel, fill):
    """(2, 2048) codes, 1280 words, bit offset 38; "overflows" needs about
    53,000 bits per slice for the buffer's 40,960."""
    rng = np.random.default_rng(50 + (fill == "overflows"))
    codes, lens = _raw(rng, (2, 2048), lo=20 if fill == "overflows" else 0)
    port, launcher = KERNELS[kernel]
    with pltpu.force_tpu_interpret_mode():
        words, nbits = launcher(codes, lens)
    seg, got_bits = _port(port, codes, lens, MAX_WORDS)
    assert np.array_equal(got_bits, np.asarray(nbits))
    assert np.array_equal(seg, _stream_bytes(words))
    assert (got_bits > 32 * MAX_WORDS).all() == (fill == "overflows")


@pytest.mark.parametrize("max_words", [1000, 600, 100],
                         ids=["odd-size", "below-windows", "overflows"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_twin_matches_numpy_pack(kernel, max_words):
    """Buffers the TPU kernels refuse (not a multiple of 128; below the
    640- and 1152-word windows of B6g and B6h); 100 words overflows every
    slice and keeps its first words and the true bit count."""
    rng = np.random.default_rng(max_words)
    codes, lens = _raw(rng, (3, 2048), zeros=0.6)
    words, nbits = ref_pack_words(codes, lens, max_words, xp=np, bit_offset=BIT_OFFSET)
    seg, got_bits = _port(KERNELS[kernel][0], codes, lens, max_words)
    assert np.array_equal(got_bits, nbits)
    assert np.array_equal(seg, _stream_bytes(words))
    assert (nbits > 32 * max_words).all() == (max_words == 100)


@pytest.mark.parametrize("k", [2047, 1, 0])
def test_pairs_twin_odd_and_empty_rows(k):
    """K2 pairs code 2i with 2i+1; an odd row's last code gets an empty
    partner, and an empty row packs to zeros and the bit offset."""
    codes, lens = _raw(np.random.default_rng(k), (2, k), lo=1)
    if k:
        words, nbits = ref_pack_words(codes, lens, 700, xp=np, bit_offset=BIT_OFFSET)
    else:  # the reference's pack_words needs a code
        words, nbits = np.zeros((2, 700), np.uint32), np.full(2, BIT_OFFSET)
    seg, got_bits = _port(cuda_pack.pack_pairs, codes, lens, 700)
    assert np.array_equal(got_bits, nbits) and np.array_equal(seg, _stream_bytes(words))


def test_fuse2_matches_reference():
    """`bitpack.fuse2` equals the reference's `_fuse2_32` (lengths 0..32,
    the l2 = 32 and l2 = 0 edges included)."""
    codes, lens = _raw(np.random.default_rng(3), (4, 4096))
    lens[:, 1:8:2] = 32
    lens[:, 9:16:2] = 0
    codes = np.where(lens > 0, codes, np.uint32(0xFFFFFFFF))  # empty slots' codes are ignored
    want = _fuse2_32(np.where(lens > 0, codes, np.uint32(0)), lens, np)
    got = bitpack.fuse2(torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lens))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_raw_packs_equal_the_fused4_pack_of_the_same_slots():
    """The raw slots fused 4:1 and packed by B2's twin give the same bytes
    and bit counts as every raw-code pack (the encoder's two routes)."""
    codes, lens = _raw(np.random.default_rng(9), (2, 4096), zeros=0.5)
    lens = np.minimum(lens, 30)  # fuse4 takes slots of <= 30 bits
    codes = (codes & ((np.uint32(1) << lens.astype(np.uint32)) - np.uint32(1))).astype(np.uint32)
    tc, tl = torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lens)
    fused = tuple(to_i32_bits(t) for t in bitpack.fuse4(tc, tl))
    want = cuda_pack.pack_fused4(*fused, 900, bit_offset=BIT_OFFSET)
    for kernel, (port, _) in KERNELS.items():
        got = port(tc, tl, 900, bit_offset=BIT_OFFSET)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kernel


@pytest.mark.parametrize("port", [cuda_pack.pack_raw, cuda_pack.pack_pairs,
                                  cuda_pack_split.pack_windows, cuda_pack_split.pack_split],
                         ids=["K1", "K2", "K3", "K4"])
def test_raw_wrappers_check_inputs(port):
    v = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        port(v.long(), v, 16)
    with pytest.raises(ValueError):
        port(v, v[:, :4], 16)
    with pytest.raises(ValueError):
        port(v, v, 0)
    with pytest.raises(ValueError):
        port(v[0], v[0], 16)
