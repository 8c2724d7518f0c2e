"""The rate control of correct mode (`TorchMPEG1IntraEncoder(bit_rate=)`),
written anew: every picture coded at its own quantizer_scale and padded to
one fixed size.

Semantics:

- The budget B is bit_rate / picture_rate bits rounded down to whole
  bytes (picture rates 24000/1001, 30000/1001 and 60000/1001 for codes 1,
  4 and 7).
- A coded picture is its picture header (8 bytes) and every slice, each
  slice rounded up to whole bytes.  A slice at scale q: 38 header bits;
  per macroblock 2 bits ('1' address increment, '1' intra); per block the
  dct_dc_size code and the differential's bits (the DC step is 8 at every
  scale), one run/level code per nonzero AC level (its table code and a
  sign bit, '11s' for run 0 |level| 1, else a 20-bit escape below |level|
  128 and a 28-bit one from it) and the 2-bit EOB.  AC levels: min(255,
  floor((16 |F| + q W) / (2 q W))) of the AAN coefficients F.
- q* is the smallest scale in 1..31 whose coded picture fits in B, over
  all 31 (bits are not monotone in the scale); 31 where none fits.
- A picture that fits is followed by zero bytes up to exactly B.
- The sequence header carries bit_rate / 400 and vbv_buffer_size =
  ceil(8 B / 16384).

The bit counts are plain torch integer ops on the CPU, one scale at a
time over the nonzero levels; the coded bytes at q* are
`reference/mpeg1.py`'s plain numpy coder, which the benchmark's other
cells already trust.  It imports nothing of either package.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from portbench.reference import headers, mpeg1
from portbench.reference.tables import (
    AC_LEN_CORRECT,
    DC_SIZE_CHROMA_LEN,
    DC_SIZE_LUMA_LEN,
    ZIGZAG_GATHER,
)

SCALES = range(1, 32)
PICTURE_HEADER_BYTES = 8


def budget_bytes(bit_rate: int, frame_rate_code: int) -> int:
    """Each picture's budget: bit_rate / picture_rate bits, whole bytes."""
    fps = headers.FRAME_RATE_VALUES[frame_rate_code]
    rate = {23.976: Fraction(24000, 1001), 29.97: Fraction(30000, 1001),
            59.94: Fraction(60000, 1001)}.get(fps, Fraction(int(fps)))
    return int(Fraction(bit_rate) / rate / 8)


def vbv_buffer_size(budget: int) -> int:
    return -(-budget * 8 // 16384)


def _aan(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int32 pixels -> the C project's fixed-point AAN DCT
    (`mpeg1.aan_dct`'s steps, rows then columns) in torch int32."""
    e0, e4, e2, e6, o1, o5, o7, o3 = mpeg1._butterfly([blocks[..., :, k] for k in range(8)])
    r = torch.stack([e0, (o1 + o5) >> 10, e2 >> 10, (o7 * mpeg1._R2) >> 17, e4,
                     (o3 * mpeg1._R2) >> 17, e6 >> 10, (o1 - o5) >> 10], dim=-1)
    e0, e4, e2, e6, o1, o5, o7, o3 = mpeg1._butterfly([r[..., k, :] for k in range(8)])
    return torch.stack([(e0 + 16) >> 3, (o1 + o5 + 16384) >> 13, (e2 + 16384) >> 13,
                        ((o7 >> 8) * mpeg1._R2 + 8192) >> 12, (e4 + 16) >> 3,
                        ((o3 >> 8) * mpeg1._R2 + 8192) >> 12, (e6 + 16384) >> 13,
                        (o1 - o5 + 16384) >> 13], dim=-2)


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    return sum((v >= (1 << k)).to(torch.int64) for k in range(8))


def slice_bits(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, quality: int) -> np.ndarray:
    """Padded planes (B, H, W), (B, H/2, W/2) -> (B, H/16, 31) int64: each
    slice's exact bits at quantizer_scale 1..31 (not rounded to bytes).
    At each scale only the nonzero AC levels are visited, as
    `mpeg1._slices` visits them."""
    blocks = torch.from_numpy(mpeg1.macroblock_blocks(y, cb, cr).astype(np.int32))
    bsz, mbh, mbw = blocks.shape[:3]
    nb = mbw * 6
    f = _aan(blocks).reshape(bsz * mbh * nb, 64)[:, torch.from_numpy(ZIGZAG_GATHER)]
    comp = torch.arange(nb) % 6
    # the DC: step 8, against the previous block of its component in the slice
    dc = ((f[:, 0] + 4) >> 3).clamp(0, 255).to(torch.int64).reshape(-1, nb)
    back = torch.where(comp == 0, 3, torch.where(comp >= 4, 6, 1))
    idx = torch.arange(nb) - back
    pred = torch.where(idx >= 0, dc[:, idx.clamp(min=0)], 128)
    size = _bit_length((dc - pred).abs())
    size_len = torch.where(comp < 4, torch.from_numpy(DC_SIZE_LUMA_LEN)[size],
                           torch.from_numpy(DC_SIZE_CHROMA_LEN)[size])
    fixed = (size_len + size).sum(dim=1) + 2 * mbw + 2 * nb + 38  # + MB headers, EOBs

    intra_q, _ = mpeg1.quality_to_quant(quality)
    w = torch.from_numpy(intra_q.reshape(64)[ZIGZAG_GATHER].astype(np.int64))[1:]
    a16 = 16 * f[:, 1:].abs().to(torch.int64)  # (blocks, 63), scan positions 1..63
    ac_len = torch.from_numpy(AC_LEN_CORRECT.astype(np.int64))
    out = []
    for q in SCALES:
        blk, k = torch.nonzero(a16 >= q * w, as_tuple=True)  # level >= 1: 16|F| >= qW
        qw = q * w[k]
        level = torch.minimum((a16[blk, k] + qw) // (2 * qw), torch.tensor(255))
        pos = k + 1
        prev = torch.zeros_like(pos)  # the previous nonzero position in the block, 0: the DC
        same = blk[1:] == blk[:-1]
        prev[1:] = torch.where(same, pos[:-1], 0)
        run = pos - prev - 1
        table = torch.where((run <= 31) & (level <= 40),
                            ac_len[run.clamp(max=31), level.clamp(max=40)], 0)
        length = torch.where(table > 0, table + 1, torch.where(level >= 128, 28, 20))
        length = torch.where((run == 0) & (level == 1), 3, length)
        out.append(torch.zeros(bsz * mbh, dtype=torch.int64).index_add_(0, blk // nb, length)
                   + fixed)
    return torch.stack(out, dim=1).reshape(bsz, mbh, 31).numpy()


def choose(bits: np.ndarray, budget: int) -> int:
    """One picture's (S, 31) slice bits -> q*."""
    fits = np.flatnonzero(((bits + 7) // 8).sum(axis=0) + PICTURE_HEADER_BYTES <= budget)
    return int(fits[0]) + 1 if fits.size else 31


def code_slices(y, cb, cr, quality: int, qscale: int, rows=None) -> list[list[bytes]]:
    """Padded planes -> each frame's slices' bytes at `qscale`, with the
    quality's matrix (`rows`: as `mpeg1.frame_slices`)."""
    intra_q, _ = mpeg1.quality_to_quant(quality)
    data, bits = mpeg1._slices(y, cb, cr, intra_q, qscale, "int32", rows)
    ends = np.cumsum((bits + 7) // 8)
    each = [data[a:b].tobytes() for a, b in zip(np.concatenate([[0], ends[:-1]]), ends)]
    mbh = 1 if rows is not None else y.shape[1] // 16
    return [each[i:i + mbh] for i in range(0, len(each), mbh)]


def sequence_header(width: int, height: int, frame_rate_code: int, intra_matrix,
                    bit_rate: int, budget: int) -> bytes:
    fields = [(width, 12), (height, 12), (1, 4), (frame_rate_code, 4), (bit_rate // 400, 18),
              (1, 1), (vbv_buffer_size(budget), 10), (0, 1), (1, 1)]
    fields += [(int(v), 8) for v in np.asarray(intra_matrix).reshape(64)[ZIGZAG_GATHER]]
    fields += [(0, 1)]
    return headers.SEQUENCE_START + headers._bits_to_bytes(fields)


def assemble(payloads: list[bytes], width: int, height: int, quality: int,
             frame_rate_code: int, gop_size: int, first_frame_index: int, bit_rate: int) -> bytes:
    """`mpeg1.assemble` with the rate's sequence header, each picture
    padded with zero bytes to the budget where it fits."""
    intra_q, _ = mpeg1.quality_to_quant(quality)
    budget = budget_bytes(bit_rate, frame_rate_code)
    fps = headers.FRAME_RATE_VALUES[frame_rate_code]
    parts = []
    for i, payload in enumerate(payloads):
        gi = first_frame_index + i
        if gi % gop_size == 0:
            parts.append(sequence_header(width, height, frame_rate_code, intra_q, bit_rate,
                                         budget))
            parts.append(headers.gop_header_es(gi, fps))
        picture = headers.picture_header(gi % gop_size) + payload
        parts.append(picture + bytes(max(0, budget - len(picture))))
    return b"".join(parts)


def encode_planes(y, cb, cr, quality: int, frame_rate_code: int, gop_size: int,
                  bit_rate: int, first_frame_index: int = 0, size=None) -> bytes:
    """Unpadded 4:2:0 planes -> the stream `encode_from_planes` writes with
    `bit_rate`, a picture at a time.  size: the (width, height) the
    sequence header states, where the planes are padded already (those of
    `color.planes_420`)."""
    width, height = size or y.shape[:0:-1]
    y, cb, cr = mpeg1.pad_planes(y, cb, cr)
    budget = budget_bytes(bit_rate, frame_rate_code)
    payloads = []
    for i in range(len(y)):
        p = (y[i:i + 1], cb[i:i + 1], cr[i:i + 1])
        q = choose(slice_bits(*p, quality)[0], budget)
        payloads.append(b"".join(code_slices(*p, quality, q)[0]))
    return assemble(payloads, width, height, quality, frame_rate_code, gop_size,
                    first_frame_index, bit_rate)
