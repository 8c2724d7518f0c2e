"""Kernel B1's plain twin against the Pallas kernel it replaces.

`vlc_fused4` on CPU tensors runs its twin; the reference is
`vlc_fused_slots_from_blocks_tpu(..., interpret=True)` followed by
`fused_stack_to_stream`, fed the same planes in the reference's blockized
layout.  All cases share one kernel shape (6 slice rows of 18 blocks), so
the Pallas interpreter compiles once.  Tolerance: exact (0).
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models.mpeg1 import pad_planes_to_macroblocks, quality_to_quant
from ec504_imageencoder_tpu.ops.pallas_vlc import (
    fused_stack_to_stream,
    vlc_fused_slots_from_blocks_tpu,
)
from ec504_imageencoder_tpu_torch.ops import cuda_vlc
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize_intra


def _px64_blocks(y, cb, cr):
    """Padded planes -> the Pallas kernel's (R, 64, NB) u8 px-major rows
    (the reference's own blockize, models/mpeg1.py)."""
    bsz, h, w = y.shape
    mbh, mbw = h // 16, w // 16
    lg = y.reshape(bsz, mbh, 2, 8, mbw, 2, 8)
    luma = lg.transpose(0, 1, 6, 3, 4, 2, 5).reshape(bsz, mbh, 64, mbw, 4)

    def chroma(p):
        return p.reshape(bsz, mbh, 8, mbw, 8).transpose(0, 1, 4, 2, 3).reshape(bsz, mbh, 64, mbw, 1)

    return np.concatenate([luma, chroma(cb), chroma(cr)], axis=-1).reshape(bsz * mbh, 64, mbw * 6)


def _planes(rng, b, h, w, noise: bool):
    ch, cw = -(-h // 2), -(-w // 2)
    if noise:
        return (rng.integers(0, 256, (b, h, w), dtype=np.uint8),
                rng.integers(0, 256, (b, ch, cw), dtype=np.uint8),
                rng.integers(0, 256, (b, ch, cw), dtype=np.uint8))
    yy, xx = np.mgrid[:h, :w]
    base = ((yy * 3 + xx * 5) % 256).astype(np.uint8)
    y = np.stack([np.roll(base, 7 * i, axis=1) for i in range(b)])
    c = np.stack([np.full((ch, cw), 90 + 40 * i, np.uint8) for i in range(b)])
    return y, c, 255 - c


CASES = [
    # (frames, height, width, noise): 32x48 is macroblock-aligned, 40x44
    # pads to 48x48; both make 6 slice rows of 18 blocks
    pytest.param(3, 32, 48, True, id="3x32x48-noise"),
    pytest.param(2, 40, 44, True, id="2x40x44-noise"),
    pytest.param(3, 32, 48, False, id="3x32x48-smooth"),
]


@pytest.mark.parametrize("quality", [5, 50, 69, 95])
@pytest.mark.parametrize("frames,height,width,noise", CASES)
def test_twin_matches_pallas_kernel(quality, frames, height, width, noise):
    rng = np.random.default_rng(quality * 1000 + height * 10 + width + noise)
    y, cb, cr = pad_planes_to_macroblocks(*_planes(rng, frames, height, width, noise))
    intra_q, qscale = quality_to_quant(quality)
    qw = (intra_q * qscale).astype(np.int32)

    vstack, flens = vlc_fused_slots_from_blocks_tpu(_px64_blocks(y, cb, cr), qw, interpret=True)
    want = [np.asarray(a).view(np.int32) for a in fused_stack_to_stream(vstack, flens)]

    planes = [torch.from_numpy(p) for p in (y, cb, cr)]
    got = cuda_vlc.vlc_fused4(*planes, torch.from_numpy(qw), Luts.default("cpu"))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)

    if noise and quality == 95:
        # the case covers 28-bit escapes: some |level| >= 128
        _, lvl = quantize_intra(aan_dct(cuda_vlc.blockize(*planes)), torch.from_numpy(qw))
        assert int(lvl.abs().max()) >= 128


def test_wrapper_checks_inputs():
    y = torch.zeros((1, 32, 32), dtype=torch.uint8)
    c = torch.zeros((1, 16, 16), dtype=torch.uint8)
    qw = torch.ones((8, 8), dtype=torch.int32)
    luts = Luts.default("cpu")
    with pytest.raises(ValueError):
        cuda_vlc.vlc_fused4(y[:, :30], c, c, qw, luts)          # not padded
    with pytest.raises(ValueError):
        cuda_vlc.vlc_fused4(y, c[:, :8], c, qw, luts)            # chroma shape
    with pytest.raises(TypeError):
        cuda_vlc.vlc_fused4(y.int(), c, c, qw, luts)             # dtype
    with pytest.raises(TypeError):
        cuda_vlc.vlc_fused4(y, c, c, qw.long(), luts)
