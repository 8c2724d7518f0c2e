"""Compat mode in plain numpy: the C course project's
`mpeg_encode_procedure`, bug for bug.

The semantics of the JAX package's `models/encoder.py::encode_compat`
(`backend="numpy"`), written anew: C-double BT.601 colour truncated to u8
on the full frame (also written out as the `.bit` dumps), a 96 x 144 crop
coded as 6 column bands ("slices") of 9 macroblocks, chroma read from the
full-resolution planes at half the row stride, the AAN DCT, truncating
quantization by the quality-scaled matrix, zigzag, the C project's VLC
(absolute DC with a size code, AC runs less one, no sign bits, its run-0
table off by one, and every AC level dropped from the first one that
follows a nonzero without a zero between), a 38-bit slice header, and the
system stream with a pack header, one PES packet per frame and four stale
bytes for the sequence end.

`precision` names the colour arithmetic: "f64" as the configuration
states, or "f32" for the benchmark's control.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import headers
from portbench.reference.bits import pack_slices
from portbench.reference.mpeg1 import _bitlength, _escape, aan_dct
from portbench.reference.tables import (
    AC_CODE_COMPAT,
    AC_LEN_COMPAT,
    DC_SIZE_CHROMA_CODE,
    DC_SIZE_CHROMA_LEN,
    DC_SIZE_LUMA_CODE,
    DC_SIZE_LUMA_LEN,
    ZIGZAG_GATHER,
    scale_quantization_matrix,
)

CROP_W, CROP_H = 96, 144
N_SLICES, N_MBS = CROP_W // 16, CROP_H // 16
MUX_RATE = 2202035


def rgb_to_ycbcr(rgb: np.ndarray, precision: str = "f64"):
    """(..., 3) u8 -> Y, Cb, Cr u8 planes: BT.601 full range, truncated."""
    ft = np.float64 if precision == "f64" else np.float32
    r, g, b = (rgb[..., c].astype(ft) for c in range(3))
    k = lambda v: ft(v)  # noqa: E731
    y = k(0.299) * r + k(0.587) * g + k(0.114) * b
    cb = k(128) - k(0.168736) * r - k(0.331264) * g + k(0.5) * b
    cr = k(128) + k(0.5) * r - k(0.418688) * g - k(0.081312) * b
    return tuple(p.astype(np.uint8) for p in (y, cb, cr))


def _crop_blocks(y, cb, cr):
    """Planes (B, H, W) -> (B, 6 slices, 9 MBs, 6, 8, 8) in stream order."""
    bsz, h, w = y.shape
    lg = y[:, :CROP_H, :CROP_W].reshape(bsz, N_MBS, 2, 8, N_SLICES, 2, 8)
    luma = lg.transpose(0, 4, 1, 2, 5, 3, 6).reshape(bsz, N_SLICES, N_MBS, 4, 8, 8)

    def chroma(p):
        half = w // 2
        v = p.reshape(bsz, h * w)[:, :8 * N_MBS * half].reshape(bsz, 8 * N_MBS, half)
        g = v[:, :, :8 * N_SLICES].reshape(bsz, N_MBS, 8, N_SLICES, 8)
        return g.transpose(0, 3, 1, 2, 4)[:, :, :, None]

    return np.concatenate([luma, chroma(cb), chroma(cr)], axis=3)


def _slices(y, cb, cr, quality):
    bsz = y.shape[0]
    f = aan_dct(_crop_blocks(y, cb, cr)).reshape(-1, 64)
    n = len(f)
    q = scale_quantization_matrix(quality).reshape(64)
    zz = (np.sign(f) * (np.abs(f) // q))[:, ZIGZAG_GATHER].astype(np.int64)

    is_luma = np.arange(n) % 6 < 4
    dc = zz[:, 0]
    adc = np.abs(dc)
    size = np.maximum(_bitlength(adc & 0xFF), 1)
    coe = np.where(dc < 0, adc ^ (1 << (size - 1)), adc) & ((1 << size) - 1)
    size = np.where(dc != 0, size, 0)
    sz_code = np.where(is_luma, DC_SIZE_LUMA_CODE[size], DC_SIZE_CHROMA_CODE[size]).astype(np.uint64)
    sz_len = np.where(is_luma, DC_SIZE_LUMA_LEN[size], DC_SIZE_CHROMA_LEN[size])
    dc_code = np.where(dc != 0, (sz_code << size.astype(np.uint64)) | coe.astype(np.uint64), sz_code)
    dc_len = sz_len + size

    # AC levels after the DC, each with the zeros before it (the DC counts
    # as a nonzero only when it is one); from the first that has none, the
    # block's levels are dropped
    blk, pos = np.nonzero(zz)
    same = np.zeros(len(pos), bool)
    same[1:] = blk[1:] == blk[:-1]
    prev = np.where(same, np.concatenate([[0], pos[:-1]]), -1)
    zb = pos - prev - 1
    ac = pos > 0
    bad = ac & (zb == 0)
    first_bad = np.full(n, 64)
    np.minimum.at(first_bad, blk[bad], pos[bad])
    keep = ac & (pos < first_bad[blk])
    blk, pos, zb = blk[keep], pos[keep], zb[keep]
    lvl = zz[blk, pos]
    a = np.abs(lvl)
    run = np.maximum(zb - 1, 0)
    special = (run == 0) & (a == 1)
    in_range = (run <= 31) & (a <= 40)
    rc, acl = np.minimum(run, 31), np.minimum(a, 40)
    tlen = np.where(in_range, AC_LEN_COMPAT[rc, acl], 0)
    ecode, elen = _escape(run, a, lvl < 0)
    ac_code = np.where(special, np.uint64(0b11),
                       np.where(tlen > 0, AC_CODE_COMPAT[rc, acl].astype(np.uint64), ecode))
    ac_len = np.where(special, 2, np.where(tlen > 0, tlen, elen))

    # token slots per block: [slice header x2 (first block of a slice),
    # MB header '11' (first block of a MB)], DC, AC levels, end of block
    n_ac = np.bincount(blk, minlength=n)
    mb_first = np.arange(n) % 6 == 0
    slice_first = np.arange(n) % (N_MBS * 6) == 0
    count = 2 + n_ac + mb_first + 2 * slice_first
    start = np.cumsum(count) - count
    codes = np.zeros(int(count.sum()), np.uint64)
    lens = np.zeros(len(codes), np.int64)
    hs = start[slice_first]
    vpos = (np.arange(bsz * N_SLICES) % N_SLICES + 1).astype(np.uint64)
    codes[hs], lens[hs] = np.uint64(0x100) | vpos, 32
    codes[hs + 1], lens[hs + 1] = 1 << 1, 6  # quantizer_scale 1, no extra slice info
    ms = start[mb_first] + 2 * slice_first[mb_first]
    codes[ms], lens[ms] = 0b11, 2
    dpos = start + 2 * slice_first + mb_first
    codes[dpos], lens[dpos] = dc_code, dc_len
    ac_first = np.cumsum(n_ac) - n_ac
    apos = dpos[blk] + 1 + np.arange(len(blk)) - ac_first[blk]
    codes[apos], lens[apos] = ac_code, ac_len
    epos = dpos + 1 + n_ac
    codes[epos], lens[epos] = 0b10, 2
    slice_of = np.repeat(np.arange(n) // (N_MBS * 6), count)
    return pack_slices(codes, lens, slice_of, bsz * N_SLICES)


def encode_compat(frames: np.ndarray, quality: int, precision: str = "f64"):
    """(B, H, W, 3) u8 frames -> (the system stream, the `.bit` dumps)."""
    bsz, h, w = frames.shape[:3]
    y, cb, cr = rgb_to_ycbcr(frames, precision)
    data, slice_bits = _slices(y, cb, cr, quality)
    ends = np.cumsum((slice_bits + 7) // 8)
    out = [headers.pack_header(MUX_RATE), headers.system_header(MUX_RATE, 0xE6)]
    dumps = []
    for i in range(bsz):
        a = int(ends[i * N_SLICES - 1]) if i else 0
        frame = bytearray(headers.pes_packet_header(1 + 3600 * i))
        frame += headers.compat_sequence_header(w & 0xFF, h & 0xFF)
        frame += headers.gop_header(hour=i, minute=0, second=0)
        frame += headers.picture_header(0)
        frame += data[a:int(ends[(i + 1) * N_SLICES - 1])].tobytes()
        headers.patch_pes_length(frame)
        out.append(bytes(frame) + headers.COMPAT_SEQUENCE_END_GARBAGE)
        dumps.append(headers.raw_plane_dump(w, h, y[i].reshape(-1), cb[i].reshape(-1),
                                            cr[i].reshape(-1)))
    return b"".join(out), dumps
