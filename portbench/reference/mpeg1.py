"""Correct-mode (ISO 11172-2) MPEG-1 intra encoding in plain numpy.

The semantics of the JAX package's host path (`MPEG1IntraEncoder(backend=
"numpy")`: `_generic_pipeline_from_planes`, `block_streams_correct64`,
`assemble`), written anew for speed: the VLC emission visits only the
nonzero coefficients, and the bits are packed by `bits.pack_slices`.

Per macroblock-padded 4:2:0 frame: blocks in macroblock order (four luma
blocks TL, TR, BL, BR, then Cb, Cr), the DCT (the integer AAN DCT of the C
project, or the orthonormal f32 DCT at high quality), ISO intra
quantization (DC step 8; AC level round-half-up of 8F / (qscale W), at most
255), zigzag, DC differences against the previous block of the component
(128 at each slice start), dct_dc_size + bits, run/level VLC with a sign
bit or the 20/28-bit escape, end of block '10', a 2-bit macroblock header
'11' (address increment 1, intra) and one slice per macroblock row with a
38-bit slice header.

`precision` names the arithmetic of the DCT: "int32" (AAN) and "f32"
(matrix DCT) as the configuration states, or one step below for the
benchmark's control: "int16" (AAN in wrapping int16) and "bf16" (every
product and sum of the matrix DCT rounded to bfloat16).
"""

from __future__ import annotations

import numpy as np

from portbench.reference import headers
from portbench.reference.bits import pack_slices
from portbench.reference.tables import (
    AC_CODE_CORRECT,
    AC_LEN_CORRECT,
    DC_SIZE_CHROMA_CODE,
    DC_SIZE_CHROMA_LEN,
    DC_SIZE_LUMA_CODE,
    DC_SIZE_LUMA_LEN,
    ZIGZAG_GATHER,
    scale_quantization_matrix,
)

FRAMES_PER_CHUNK = 2  # frames coded at once: bounds the temporaries

# fixed-point AAN constants of the C project (image_processing.c:40-46)
_C1, _S1, _C3, _S3, _R2C6, _R2S6, _R2 = 1004, 200, 851, 569, 554, 1337, 181


def quality_to_quant(quality: int) -> tuple[np.ndarray, int]:
    """Quality 1..100 -> (intra matrix int32, quantizer_scale): the JPEG
    scaled matrix, with quantizer_scale taking the factor above 255."""
    m = scale_quantization_matrix(quality).astype(np.int64)
    s = max(1, int(np.ceil(m.max() / 255.0)))
    qscale = int(np.clip(8 * s, 1, 31))
    w = np.clip(np.round(8.0 * m / qscale), 1, 255).astype(np.int32)
    return w, qscale


def _butterfly(a):
    a0, a1, a2, a3, a4, a5, a6, a7 = a
    s8, d0 = a7 + a0, a0 - a7
    s7, d1 = a1 + a6, a1 - a6
    s6, d2 = a2 + a5, a2 - a5
    s5, d3 = a3 + a4, a3 - a4
    e_x4, e_x8, e_x5, e_x7 = s8 + s5, s8 - s5, s7 + s6, s7 - s6
    t6 = _C1 * (d1 + d2)
    o_x2 = (-_S1 - _C1) * d2 + t6
    o_x1 = (_S1 - _C1) * d1 + t6
    t6b = _C3 * (d0 + d3)
    o_x3 = (-_S3 - _C3) * d3 + t6b
    o_x0 = (_S3 - _C3) * d0 + t6b
    t5 = _R2C6 * (e_x7 + e_x8)
    return (e_x4 + e_x5, e_x4 - e_x5, (_R2S6 - _R2C6) * e_x8 + t5, (-_R2S6 - _R2C6) * e_x7 + t5,
            o_x3 + o_x1, o_x0 + o_x2, o_x3 - o_x1, o_x0 - o_x2)


def aan_dct(blocks: np.ndarray, dtype=np.int32) -> np.ndarray:
    """(..., 8, 8) pixels -> (..., 8v, 8u) the C project's fixed-point AAN
    DCT (rows, then columns), in `dtype` arithmetic."""
    x = blocks.astype(dtype)
    e0, e4, e2, e6, o1, o5, o7, o3 = _butterfly([x[..., :, k] for k in range(8)])
    rows = [e0, (o1 + o5) >> 10, e2 >> 10, (o7 * _R2) >> 17, e4, (o3 * _R2) >> 17,
            e6 >> 10, (o1 - o5) >> 10]
    r = np.stack(rows, axis=-1)
    e0, e4, e2, e6, o1, o5, o7, o3 = _butterfly([r[..., k, :] for k in range(8)])
    out = [(e0 + 16) >> 3, (o1 + o5 + 16384) >> 13, (e2 + 16384) >> 13,
           ((o7 >> 8) * _R2 + 8192) >> 12, (e4 + 16) >> 3, ((o3 >> 8) * _R2 + 8192) >> 12,
           (e6 + 16384) >> 13, (o1 - o5 + 16384) >> 13]
    return np.stack(out, axis=-2).astype(np.int32)


def dct_matrix_f32() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix D in f32: F = D X D^T."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    d *= np.where(k[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return d.astype(np.float32)


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bfloat16 (ties to even), held in f32."""
    u = a.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def matmul_dct(blocks: np.ndarray, precision: str = "f32") -> np.ndarray:
    """(..., 8, 8) pixels -> (..., 8v, 8u) int32: D X D^T in f32 as
    numpy's einsum sums it (over y, then x, each product
    (d[v, y] x[y, x]) d[u, x] rounded), then rounded half away from zero.
    "bf16": the same sums with every operand, product and partial sum
    rounded to bfloat16."""
    d = dct_matrix_f32()
    x = blocks.astype(np.float32)
    if precision == "f32":
        f = np.einsum("vy,...yx,ux->...vu", d, x, d)
    else:
        d, x = _bf16(d), _bf16(x)
        f = np.zeros(x.shape, np.float32)
        for y in range(8):
            p = _bf16(d[:, y, None] * x[..., y:y + 1, :])
            for k in range(8):
                f = _bf16(f + _bf16(p[..., :, k:k + 1] * d[:, k]))
    return np.where(f >= 0, np.floor(f + 0.5), np.ceil(f - 0.5)).astype(np.int32)


def macroblock_blocks(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Padded planes (B, H, W), (B, H/2, W/2) -> (B, H/16, W/16, 6, 8, 8)."""
    bsz, h, w = y.shape
    mbh, mbw = h // 16, w // 16
    luma = y.reshape(bsz, mbh, 2, 8, mbw, 2, 8).transpose(0, 1, 4, 2, 5, 3, 6)
    luma = luma.reshape(bsz, mbh, mbw, 4, 8, 8)
    chroma = [p.reshape(bsz, mbh, 8, mbw, 8).transpose(0, 1, 3, 2, 4)[:, :, :, None]
              for p in (cb, cr)]
    return np.concatenate([luma, *chroma], axis=3)


def _bitlength(v: np.ndarray) -> np.ndarray:
    """bit_length of 0 <= v <= 255."""
    return sum((v >= (1 << k)).astype(np.int64) for k in range(8))


def _escape(run, a, neg):
    """The 20-bit (|level| < 128) or 28-bit escape: '000001', 6-bit run,
    then the level in 8 bits, or 0x00/0x80 and 8 bits."""
    lo = np.where(neg, (256 - a) & 0xFF, a & 0xFF).astype(np.uint64)
    base = (np.uint64(1 << 6) | run.astype(np.uint64))
    long_ = a >= 128
    code = np.where(long_, (base << np.uint64(16)) | (neg.astype(np.uint64) << np.uint64(15)) | lo,
                    (base << np.uint64(8)) | lo)
    return code, np.where(long_, 28, 20)


def _ac_tokens(run, level):
    """ISO run/level VLC of nonzero AC levels -> (codes, lens)."""
    a = np.abs(level).astype(np.int64)
    neg = level < 0
    s = neg.astype(np.uint64)
    in_range = (run <= 31) & (a <= 40)
    rc, ac = np.minimum(run, 31), np.minimum(a, 40)
    tlen = np.where(in_range, AC_LEN_CORRECT[rc, ac], 0)
    tcode = AC_CODE_CORRECT[rc, ac].astype(np.uint64)
    ecode, elen = _escape(run, a, neg)
    special = (run == 0) & (a == 1)
    code = np.where(special, np.uint64(0b110) | s,
                    np.where(tlen > 0, (tcode << np.uint64(1)) | s, ecode))
    length = np.where(special, 3, np.where(tlen > 0, tlen + 1, elen))
    return code, length


def dct_precision(quality: int) -> str:
    """The DCT the configuration states for a quality: the integer AAN DCT
    below 70, the f32 matrix DCT at 70 and above (dct_impl="auto")."""
    return "f32" if quality >= 70 else "int32"


def _slices(y, cb, cr, intra_q, qscale, precision, rows=None):
    """Padded planes -> (bytes of every slice back to back, bits per slice
    (B * mbh,)), slices in stream order.  `rows`: the macroblock row of
    each slice where the planes are single rows cut from frames (their
    slice_vertical_position), else the row within each frame."""
    blocks = macroblock_blocks(y, cb, cr)
    bsz, mbh, mbw = blocks.shape[:3]
    if precision in ("f32", "bf16"):
        f = matmul_dct(blocks, precision)
    else:
        f = aan_dct(blocks, np.int16 if precision == "int16" else np.int32)
    n = bsz * mbh * mbw * 6
    f = f.reshape(n, 64)
    dc = np.clip((f[:, 0] + 4) >> 3, 0, 255).astype(np.int64)
    qw = (np.asarray(intra_q, np.int32) * qscale).reshape(64)
    mag = np.minimum((16 * np.abs(f) + qw) // (2 * qw), 255)
    lvl = np.where(f < 0, -mag, mag)[:, ZIGZAG_GATHER]

    # DC predictors: the previous block of the same component in the
    # slice, 128 at its start
    dcs = dc.reshape(bsz * mbh, mbw, 6)
    luma = dcs[:, :, :4].reshape(-1, mbw * 4)
    pred = np.empty_like(dcs)
    pred[:, :, :4] = np.concatenate([np.full((len(luma), 1), 128), luma[:, :-1]], 1).reshape(-1, mbw, 4)
    for c in (4, 5):
        pred[:, :, c] = np.concatenate([np.full((len(luma), 1), 128), dcs[:, :-1, c]], 1)
    diff = dc - pred.reshape(n)
    size = _bitlength(np.abs(diff))
    comp = np.arange(n) % 6
    is_luma = comp < 4
    sz_code = np.where(is_luma, DC_SIZE_LUMA_CODE[size], DC_SIZE_CHROMA_CODE[size]).astype(np.uint64)
    sz_len = np.where(is_luma, DC_SIZE_LUMA_LEN[size], DC_SIZE_CHROMA_LEN[size])
    bits = np.where(diff >= 0, diff, diff + (1 << size) - 1) & ((1 << size) - 1)
    mb_first = comp == 0
    dc_code = (sz_code << size.astype(np.uint64)) | bits.astype(np.uint64)
    dc_code |= mb_first.astype(np.uint64) * (np.uint64(0b11) << (sz_len + size).astype(np.uint64))
    dc_len = sz_len + size + 2 * mb_first

    blk, k = np.nonzero(lvl[:, 1:])
    pos = k + 1
    prev = np.zeros_like(pos)
    same = np.zeros(len(pos), bool)
    same[1:] = blk[1:] == blk[:-1]
    prev[1:] = np.where(same[1:], pos[:-1], 0)
    ac_code, ac_len = _ac_tokens(pos - prev - 1, lvl[blk, pos])

    # token slots: per block [slice header x2 (first block of a slice)],
    # DC, its AC levels, end of block
    n_ac = np.bincount(blk, minlength=n)
    slice_first = np.arange(n) % (mbw * 6) == 0
    count = 2 + n_ac + 2 * slice_first
    start = np.cumsum(count) - count
    t = int(count.sum())
    codes = np.zeros(t, np.uint64)
    lens = np.zeros(t, np.int64)
    hs = start[slice_first]
    vpos = ((np.arange(bsz * mbh) % mbh if rows is None else np.asarray(rows)) + 1).astype(np.uint64)
    codes[hs], lens[hs] = np.uint64(0x100) | vpos, 32
    codes[hs + 1], lens[hs + 1] = np.uint64((qscale & 0x1F) << 1), 6
    dpos = start + 2 * slice_first
    codes[dpos], lens[dpos] = dc_code, dc_len
    ac_first = np.cumsum(n_ac) - n_ac
    apos = dpos[blk] + 1 + np.arange(len(blk)) - ac_first[blk]
    codes[apos], lens[apos] = ac_code, ac_len
    epos = dpos + 1 + n_ac
    codes[epos], lens[epos] = 0b10, 2
    slice_of = np.repeat(np.arange(n) // (mbw * 6), count)
    return pack_slices(codes, lens, slice_of, bsz * mbh)


def pad_planes(y, cb, cr):
    """Edge-replicate 4:2:0 planes to whole macroblocks (chroma to half)."""
    ph, pw = -y.shape[1] % 16, -y.shape[2] % 16
    y = np.pad(y, ((0, 0), (0, ph), (0, pw)), mode="edge")
    c = ((0, 0), (0, y.shape[1] // 2 - cb.shape[1]), (0, y.shape[2] // 2 - cb.shape[2]))
    return y, np.pad(cb, c, mode="edge"), np.pad(cr, c, mode="edge")


def frame_slices(y, cb, cr, quality: int, precision: str, rows=None) -> list[list[bytes]]:
    """Padded planes -> each frame's slices, each slice's bytes: what of
    the frame's picture follows its picture header.  With `rows`, the
    planes are single macroblock rows and `rows` their positions."""
    intra_q, qscale = quality_to_quant(quality)
    mbh = y.shape[1] // 16
    out = []
    for lo in range(0, y.shape[0], FRAMES_PER_CHUNK):
        sl = slice(lo, lo + FRAMES_PER_CHUNK)
        data, slice_bits = _slices(y[sl], cb[sl], cr[sl], intra_q, qscale, precision,
                                   None if rows is None else rows[sl])
        ends = np.cumsum((slice_bits + 7) // 8)
        starts = np.concatenate([[0], ends[:-1]])
        each = [data[a:b].tobytes() for a, b in zip(starts, ends)]
        out += [each[i:i + mbh] for i in range(0, len(each), mbh)]
    return out


def picture_payloads(y, cb, cr, quality: int, precision: str) -> list[bytes]:
    """Padded planes -> each frame's slices, back to back."""
    return [b"".join(f) for f in frame_slices(y, cb, cr, quality, precision)]


def restamp(frames: list[list[bytes]], rows, new: list[list[bytes]]) -> list[bytes]:
    """Each frame's payload, slice rows[i] of frame i replaced by new[i]
    (frames past the end of `rows` as they are)."""
    out = [b"".join(f) for f in frames]
    for i, (r, (s,)) in enumerate(zip(rows, new)):
        out[i] = b"".join(frames[i][:r]) + s + b"".join(frames[i][r + 1:])
    return out


def assemble(payloads: list[bytes], width: int, height: int, quality: int,
             frame_rate_code: int, gop_size: int, first_frame_index: int) -> bytes:
    """The video elementary stream of consecutive frames from
    `first_frame_index` on: a sequence header (with the intra matrix) and
    a closed GOP header every `gop_size` frames, a picture header per
    frame (temporal reference = index within the GOP), then its slices."""
    intra_q, _ = quality_to_quant(quality)
    fps = headers.FRAME_RATE_VALUES[frame_rate_code]
    parts = []
    for i, payload in enumerate(payloads):
        gi = first_frame_index + i
        if gi % gop_size == 0:
            parts.append(headers.sequence_header_es(width, height, frame_rate_code, intra_q))
            parts.append(headers.gop_header_es(gi, fps))
        parts.append(headers.picture_header(gi % gop_size))
        parts.append(payload)
    return b"".join(parts)

