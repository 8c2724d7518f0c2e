"""Kernels B2's and B6c's plain twins against the Pallas kernels they replace.

`pack_fused4` and `pack_fused8` on CPU tensors run their twins; the
references are `pack_words_fused4_core(..., bit_offset=38, emit_be=True,
interpret=True)` and `pack_words_fused8_core(..., bit_offset=38,
interpret=True)` (whose byte-swapped words are the stream bytes when
viewed as u8), as in tests/test_pack_interpret.py, and for B6c where the
Pallas kernel refuses the buffer size, the reference's numpy
`bitpack.pack_words` of the raw codes, byte-swapped.  The cases of each
kernel share one shape so the Pallas interpreter compiles once.
Tolerance: exact (0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.ops.bitpack import pack_words as ref_pack_words
from ec504_imageencoder_tpu.ops.pallas_pack import (
    _fuse2_32,
    _fuse2_64,
    _fuse2_128,
    pack_words_fused4_core,
    pack_words_fused8_core,
)
from ec504_imageencoder_tpu_torch.ops import bitpack, cuda_pack

MAX_WORDS = 640


def _raw_slots(rng, sparse: bool):
    """(2, 2048) raw codes of <= 28 bits, masked to their lengths."""
    lens = rng.integers(0, 29, (2, 2048)).astype(np.int32)
    if sparse:
        lens[rng.random(lens.shape) < 0.5] = 0
    codes = (rng.integers(0, 1 << 31, lens.shape) & ((1 << np.maximum(lens, 1)) - 1)).astype(np.uint32)
    return codes, lens


def _fused_slots(rng, sparse: bool):
    """(2, 512) fused slots made from 2048 raw codes per slice by the
    reference's own 4:1 fusion."""
    codes, lens = _raw_slots(rng, sparse)
    cm = jnp.where(jnp.asarray(lens) > 0, jnp.asarray(codes), jnp.uint32(0))
    h1, l1, len1 = _fuse2_32(cm, jnp.asarray(lens), jnp)
    return _fuse2_64(h1, l1, len1, jnp)


def _fused8_slots(rng, sparse: bool):
    """(raw codes, raw lens, 8 word planes (2, 256), lens (2, 256)): the
    reference's three fusion levels over 2048 raw codes per slice."""
    codes, lens = _raw_slots(rng, sparse)
    cm = jnp.where(jnp.asarray(lens) > 0, jnp.asarray(codes), jnp.uint32(0))
    h1, l1, len1 = _fuse2_32(cm, jnp.asarray(lens), jnp)
    *v4, fl4 = _fuse2_64(h1, l1, len1, jnp)
    w8, fl8 = _fuse2_128(list(v4), fl4, jnp)
    return codes, lens, w8, fl8


def _torch_i32(a):
    return torch.from_numpy(np.array(a).view(np.int32))


@pytest.mark.parametrize("sparse", [True, False], ids=["fits", "overflows"])
def test_twin_matches_pallas_kernel(sparse):
    rng = np.random.default_rng(7 + sparse)
    v0, v1, v2, v3, fl = _fused_slots(rng, sparse)
    words, nbits = pack_words_fused4_core(
        v0, v1, v2, v3, fl, MAX_WORDS, bit_offset=38, emit_be=True, interpret=True
    )
    want_seg = np.asarray(words).view(np.uint8).reshape(2, 4 * MAX_WORDS)
    want_bits = np.asarray(nbits)

    ins = [_torch_i32(a) for a in (v0, v1, v2, v3, fl)]
    seg, got_bits = cuda_pack.pack_fused4(*ins, MAX_WORDS, bit_offset=38)
    assert seg.dtype == torch.uint8 and got_bits.dtype == torch.int32
    assert np.array_equal(got_bits.numpy(), want_bits)
    assert np.array_equal(seg.numpy(), want_seg)
    # nbits stays the true count when the slice overflows its buffer
    assert (want_bits > 32 * MAX_WORDS).any() == (not sparse)
    assert not seg[:, :4].any() and not (seg[:, 4] & 0xFC).any()  # 38 header bits left zero


def test_wrapper_checks_inputs():
    v = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_pack.pack_fused4(v, v, v, v.long(), v, 16)
    with pytest.raises(ValueError):
        cuda_pack.pack_fused4(v, v, v, v[:, :4], v, 16)
    with pytest.raises(ValueError):
        cuda_pack.pack_fused4(v, v, v, v, v, 0)


def test_fuse8_twin_matches_reference_fusion():
    """`bitpack.fuse8` of `fuse4` equals the reference's `_fuse2_128`."""
    codes, lens, want_w, want_l = _fused8_slots(np.random.default_rng(3), False)
    words, flens = bitpack.fuse8(*bitpack.fuse4(torch.from_numpy(codes.astype(np.int64)),
                                                torch.from_numpy(lens)))
    assert np.array_equal(flens.numpy(), np.asarray(want_l))
    for g, w in zip(words, want_w):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_pack8_twin_matches_pallas_kernel(sparse):
    """B6c's twin against `pack_words_fused8_core(interpret=True)` at a
    buffer the Pallas kernel takes (1024 words) and that holds every slice."""
    max_words = 1024
    _, _, w8, fl8 = _fused8_slots(np.random.default_rng(17 + sparse), sparse)
    words, nbits = pack_words_fused8_core(tuple(w8), fl8, max_words, bit_offset=38, interpret=True)
    want_seg = np.asarray(words).view(np.uint8).reshape(2, 4 * max_words)
    assert (np.asarray(nbits) <= 32 * max_words).all()

    seg, got_bits = cuda_pack.pack_fused8([_torch_i32(w) for w in w8], _torch_i32(fl8), max_words,
                                          bit_offset=38)
    assert seg.dtype == torch.uint8 and got_bits.dtype == torch.int32
    assert np.array_equal(got_bits.numpy(), np.asarray(nbits))
    assert np.array_equal(seg.numpy(), want_seg)


@pytest.mark.parametrize("max_words", [100, 1000, 2050], ids=["overflows", "odd-size", "large"])
def test_pack8_twin_matches_numpy_pack(max_words):
    """Buffers the Pallas kernel refuses (not a multiple of 128, or below
    its 384-word window): B6c's twin against the reference's numpy
    `pack_words` of the raw codes, byte-swapped; an overflowing buffer
    keeps its first words and the true bit count."""
    codes, lens, w8, fl8 = _fused8_slots(np.random.default_rng(max_words), False)
    words, nbits = ref_pack_words(codes, lens, max_words, xp=np, bit_offset=38)
    seg, got_bits = cuda_pack.pack_fused8([_torch_i32(w) for w in w8], _torch_i32(fl8), max_words,
                                          bit_offset=38)
    assert np.array_equal(got_bits.numpy(), nbits)
    assert np.array_equal(seg.numpy(), words.byteswap().view(np.uint8))
    assert (nbits > 32 * max_words).any() == (max_words == 100)


def test_pack8_wrapper_checks_inputs():
    v = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_pack.pack_fused8([v] * 4, v, 16)                   # 4 word planes
    with pytest.raises(ValueError):
        cuda_pack.pack_fused8([v] * 7 + [v.long()], v, 16)
    with pytest.raises(ValueError):
        cuda_pack.pack_fused8([v] * 8, v[:, :4], 16)
    with pytest.raises(ValueError):
        cuda_pack.pack_fused8([v] * 8, v, 0)
