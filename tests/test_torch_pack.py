"""Kernel B2's plain twin against the Pallas kernel it replaces.

`pack_fused4` on CPU tensors runs its twin; the reference is
`pack_words_fused4_core(..., bit_offset=38, emit_be=True, interpret=True)`
(whose byte-swapped words are the stream bytes when viewed as u8), as in
tests/test_pack_interpret.py.  Both cases share one shape so the Pallas
interpreter compiles once.  Tolerance: exact (0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.ops.pallas_pack import _fuse2_32, _fuse2_64, pack_words_fused4_core
from ec504_imageencoder_tpu_torch.ops import cuda_pack

MAX_WORDS = 640


def _fused_slots(rng, sparse: bool):
    """(2, 512) fused slots made from 2048 raw codes per slice by the
    reference's own 4:1 fusion."""
    lens = rng.integers(0, 29, (2, 2048)).astype(np.int32)
    if sparse:
        lens[rng.random(lens.shape) < 0.5] = 0
    codes = (rng.integers(0, 1 << 31, lens.shape) & ((1 << np.maximum(lens, 1)) - 1)).astype(np.uint32)
    cm = jnp.where(jnp.asarray(lens) > 0, jnp.asarray(codes), jnp.uint32(0))
    h1, l1, len1 = _fuse2_32(cm, jnp.asarray(lens), jnp)
    return _fuse2_64(h1, l1, len1, jnp)


@pytest.mark.parametrize("sparse", [True, False], ids=["fits", "overflows"])
def test_twin_matches_pallas_kernel(sparse):
    rng = np.random.default_rng(7 + sparse)
    v0, v1, v2, v3, fl = _fused_slots(rng, sparse)
    words, nbits = pack_words_fused4_core(
        v0, v1, v2, v3, fl, MAX_WORDS, bit_offset=38, emit_be=True, interpret=True
    )
    want_seg = np.asarray(words).view(np.uint8).reshape(2, 4 * MAX_WORDS)
    want_bits = np.asarray(nbits)

    ins = [torch.from_numpy(np.array(a).view(np.int32)) for a in (v0, v1, v2, v3, fl)]
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
