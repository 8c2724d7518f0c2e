"""Slot fusion and bit packing in plain PyTorch (int64 words).

* `fuse2`: exact 2:1 slot fusion, the reference's
  `ops/pallas_pack._fuse2_32`: two consecutive (code, len) slots of <= 32
  bits become one right-aligned value of <= 64 bits, words (hi, lo).
* `fuse4`: exact 4:1 slot fusion, the arithmetic of the reference's
  `ops/pallas_vlc.fuse_slots_streamwise`: four consecutive (code, len)
  slots of <= 30 bits become one right-aligned value of <= 128 bits,
  held as four 32-bit words v0..v3 (most significant first); its first
  level is `fuse2`.
* `fuse8`: the third fusion level, the arithmetic of the reference's
  `ops/pallas_pack._fuse2_128`: pairs of `fuse4` values (slots 2k, 2k+1)
  become one value of <= 256 bits, eight words w0..w7.
* `pack_words4`: the prefix-sum pack of `fuse4` values.  Each value
  lands at bit offset cumsum(lens) + bit_offset, MSB first, and spans at
  most 5 consecutive 32-bit words.  Words past `max_words` are dropped,
  but `nbits` is the true total, so the caller can regrow exactly.
  Contributions are bit-disjoint, so `index_add_` equals an OR.  With
  `checks` it also counts what the checked pack kernel counts: fused
  lengths outside [0, 128], and words whose contributions overlap
  (disjoint bits add without carries, so an overlap shows as a popcount
  of the sum below the sum of the popcounts).
* `pack_words8`: the same for `fuse8` values, at most 9 words each.
* `pack_words`: the same for plain <= 32-bit codes (the reference's
  `ops/bitpack.pack_words`), each spanning at most 2 words; `pack_words2`
  the same after `fuse2`, at most 3 words per fused pair.
* `pack_bytes`: `pack_words` straight to big-endian bytes.
* `words_to_bytes`, `or_slice_headers`: big-endian serialisation and
  the 38-bit slice header (`models/mpeg1._or_slice_headers`).
* `compact_slices`, `split_compact_slices`: the device-side compaction
  of the packed slice buffers into one dense word buffer (so that the
  device-to-host copy carries about the stream's bytes, not the padded
  buffers), and its host inverse.

Every 32-bit quantity is carried in int64 (int32 for the compacted
words): torch on the CPU cannot shift or compare uint32.
"""

from __future__ import annotations

import numpy as np
import torch

_I64 = torch.int64
_M32 = 0xFFFFFFFF


def _shl(x, k):
    return torch.bitwise_left_shift(x, k)


def _shr(x, k):
    return torch.bitwise_right_shift(x, k)


def fuse2(codes: torch.Tensor, lens: torch.Tensor):
    """(..., K) slot codes (u32 bits in any integer dtype) and lens <= 32
    in stream order, K % 2 == 0 -> (hi, lo, len2), each (..., K // 2)
    int64: slots 2i and 2i+1 fused to c1 * 2^l2 | c2.

    Zero-length slots contribute nothing whatever their code."""
    codes = torch.where(lens > 0, codes.to(_I64) & _M32, 0)
    lens = lens.to(_I64)
    c = codes.reshape(*codes.shape[:-1], -1, 2)
    ln = lens.reshape(*lens.shape[:-1], -1, 2)
    c1, c2, l1, l2 = c[..., 0], c[..., 1], ln[..., 0], ln[..., 1]
    r = l2 & 31
    rc = (32 - r) & 31
    hi = torch.where(l2 > 0, _shr(c1, rc), 0)  # l2 == 32: rc == 0, hi = c1
    lo = (torch.where(l2 < 32, _shl(c1, r) & _M32, 0)) | c2
    return hi, lo, l1 + l2


def fuse4(codes: torch.Tensor, lens: torch.Tensor):
    """(..., K) slot codes/lens in stream order, K % 4 == 0 ->
    (v0, v1, v2, v3, flens), each (..., K // 4) int64.

    Zero-length slots contribute nothing whatever their code."""
    # level 1: pairs of <= 30-bit slots -> (hi, lo) 32-bit words
    hi, lo, len2 = fuse2(codes, lens)
    # level 2: pairs of pairs -> four words
    hi = hi.reshape(*hi.shape[:-1], -1, 2)
    lo = lo.reshape(*lo.shape[:-1], -1, 2)
    len2 = len2.reshape(*len2.shape[:-1], -1, 2)
    a_hi, b_hi, a_lo, b_lo = hi[..., 0], hi[..., 1], lo[..., 0], lo[..., 1]
    l1b, l2b = len2[..., 0], len2[..., 1]
    q = l2b >> 5
    r = l2b & 31
    rc = (32 - r) & 31
    g1 = torch.where(r > 0, _shr(a_hi, rc), 0)
    g2 = (_shl(a_hi, r) & _M32) | torch.where(r > 0, _shr(a_lo, rc), 0)
    g3 = _shl(a_lo, r) & _M32
    z = torch.zeros_like(g1)
    v0 = torch.where(q == 2, g2, torch.where(q == 1, g1, z))
    v1 = torch.where(q == 2, g3, torch.where(q == 1, g2, g1))
    v2 = torch.where(q == 2, z, torch.where(q == 1, g3, g2)) | b_hi
    v3 = torch.where(q >= 1, z, g3) | b_lo
    return v0, v1, v2, v3, l1b + l2b


def fuse8(v0, v1, v2, v3, flens):
    """`fuse4` outputs (..., K) in stream order, K % 2 == 0 ->
    (words (w0, ..., w7), flens), each (..., K // 2) int64: the values of
    slots 2k and 2k+1 concatenated, w0 the most significant word."""
    def pairs(x):
        x = x.to(_I64).reshape(*x.shape[:-1], -1, 2)
        return x[..., 0], x[..., 1]

    a, b = zip(*(pairs(v) for v in (v0, v1, v2, v3)))
    la, lb = pairs(flens)
    # the 128-bit value a shifted up by lb = 32 q + r bits over 8 words
    q = lb >> 5
    r = lb & 31
    rc = (32 - r) & 31
    u = [torch.zeros_like(a[0]), *a, torch.zeros_like(a[0])]
    f = [(_shl(u[i], r) & _M32) | torch.where(r > 0, _shr(u[i + 1], rc), 0) for i in range(5)]
    w = []
    for j in range(8):
        acc = torch.zeros_like(f[0])
        for qq in range(5):
            if 0 <= j + qq - 3 <= 4:
                acc = torch.where(q == qq, f[j + qq - 3], acc)
        w.append(acc | b[j - 4] if j >= 4 else acc)
    return tuple(w), la + lb


def _popcount(x):
    """Set bits of each non-negative int64."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x + (x >> 32)) & 0x7F


def _pack_values(vs, flens, max_words: int, bit_offset: int, checks: bool):
    """The pack of values of up to 32 * len(vs) bits (len(vs) words each,
    most significant first): each spans at most len(vs) + 1 words."""
    nw = len(vs)
    n, kf = flens.shape
    dev = flens.device
    lens = flens.to(_I64)
    ends = torch.cumsum(lens, dim=-1) + bit_offset
    off = ends - lens
    nbits = ends[:, -1] if kf else torch.full((n,), bit_offset, dtype=_I64, device=dev)
    word = off >> 5
    s = off & 31
    # place the value at the top of a 32 (nw + 1)-bit window: shift left by
    # 32 (nw + 1) - s - len = 32 q + r over the words [0, v0, ..., v_{nw-1}]
    sig = 32 * (nw + 1) - s - lens
    q = sig >> 5
    r = sig & 31
    rc = 32 - r  # 32 when r == 0: an int64 shift by 32 of a u32 gives 0
    u = [torch.zeros_like(lens)] + [torch.where(lens > 0, v.to(_I64) & _M32, 0) for v in vs]
    f = [
        (_shl(u[i], r) & _M32) | (_shr(u[i + 1], rc) if i < nw else 0)
        for i in range(nw + 1)
    ]
    out = torch.zeros(n * max_words, dtype=_I64, device=dev)
    ones = torch.zeros_like(out) if checks else None
    rows = torch.arange(n, device=dev, dtype=_I64)[:, None] * max_words
    for j in range(nw + 1):
        wj = torch.zeros_like(lens)
        for qq in range(nw + 1 - j):
            wj = torch.where(q == qq, f[j + qq], wj)
        idx = word + j
        keep = (idx >= 0) & (idx < max_words)
        at = torch.where(keep, rows + idx, 0).reshape(-1)
        wj = torch.where(keep, wj, 0).reshape(-1)
        out.index_add_(0, at, wj)
        if checks:
            ones.index_add_(0, at, _popcount(wj))
    if not checks:
        return out.reshape(n, max_words), nbits
    bad_len = ((lens < 0) | (lens > 32 * nw)).sum(dim=-1)
    overlap = (_popcount(out) != ones).reshape(n, max_words).sum(dim=-1)
    return out.reshape(n, max_words), nbits, bad_len + overlap


def pack_words4(v0, v1, v2, v3, flens, max_words: int, bit_offset: int = 0,
                checks: bool = False):
    """(n, KF) <= 128-bit values (four 32-bit words each, any integer
    dtype holding the same bits) + (n, KF) lengths ->
    (words (n, max_words) int64, nbits (n,) int64), and with `checks`
    viol (n,) int64: lengths outside [0, 128] plus overlapping words.

    A value whose length does not fit its 160-bit window, or a word below
    the buffer (after a negative length), is not placed."""
    return _pack_values((v0, v1, v2, v3), flens, max_words, bit_offset, checks)


def pack_words8(words, flens, max_words: int, bit_offset: int = 0):
    """8 (n, KF) words of <= 256-bit values (most significant first) +
    (n, KF) lengths -> (words (n, max_words) int64, nbits (n,) int64),
    as `pack_words4`."""
    return _pack_values(tuple(words), flens, max_words, bit_offset, False)


def pack_words(codes, lens, max_words: int, bit_offset: int = 0):
    """(n, K) <= 32-bit codes (u32 bits in any integer dtype) + (n, K)
    lengths -> (words (n, max_words) int64, nbits (n,) int64), as
    `pack_words4`."""
    return _pack_values((codes,), lens, max_words, bit_offset, False)


def pack_words2(codes, lens, max_words: int, bit_offset: int = 0):
    """`pack_words` through `fuse2`: the same words and bit counts, with
    slots 2i and 2i+1 placed as one value of <= 64 bits (an odd K gets an
    empty partner)."""
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
        lens = torch.nn.functional.pad(lens, (0, 1))
    hi, lo, len2 = fuse2(codes, lens)
    return _pack_values((hi, lo), len2, max_words, bit_offset, False)


def pack_bytes(codes, lens, max_bytes: int, bit_offset: int = 0):
    """(..., K) <= 32-bit codes + (..., K) lengths -> (bytes (...,
    max_bytes) u8, nbits (...,) int64): `pack_words` of the rows, then
    `words_to_bytes`.  max_bytes % 4 == 0."""
    if max_bytes % 4:
        raise ValueError(f"max_bytes must be a multiple of 4, got {max_bytes}")
    k = codes.shape[-1]
    words, nbits = pack_words(codes.reshape(-1, k), lens.reshape(-1, k), max_bytes // 4,
                              bit_offset)
    batch = codes.shape[:-1]
    return words_to_bytes(words).reshape(*batch, max_bytes), nbits.reshape(batch)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., W) 32-bit words (int64) -> (..., 4W) u8, big-endian."""
    w = words.to(_I64)
    b = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(*words.shape[:-1], words.shape[-1] * 4)


def or_slice_headers(seg: torch.Tensor, qscale: int, first_row: int = 0) -> torch.Tensor:
    """OR the 38-bit slice header into bytes 0..4 of every (B, mbh, msb)
    slice segment, in place: 00 00 01 vpos [qscale<<3].  The pack leaves
    those bits zero (bit_offset=38).  The segments are MB rows first_row ..
    first_row + mbh - 1 of their picture (a row shard's offset), so vpos
    runs from first_row + 1."""
    mbh = seg.shape[1]
    hdr = torch.zeros((mbh, 5), dtype=torch.uint8, device=seg.device)
    hdr[:, 2] = 1
    hdr[:, 3] = torch.arange(first_row + 1, first_row + mbh + 1, dtype=torch.uint8,
                             device=seg.device)
    hdr[:, 4] = (qscale & 0x1F) << 3
    seg[..., :5] |= hdr
    return seg


def compact_slices(seg: torch.Tensor, bits: torch.Tensor, cap_words: int):
    """Gather every slice's used word prefix into one dense buffer, on
    seg's device: the reference's `ops/bitpack.py::compact_slices`, its
    whole buffer word for word.

    seg: (B, S, msb) u8 slice buffers, msb % 4 == 0; bits: (B, S) bit
    counts >= 0.  Returns (dense (cap_words,) int32, offs (B*S,) int32):
    slice i's used words ceil(bits_i / 32) start at word offs_i (their
    exclusive sum), and dense is a bitcast of the byte stream (each word
    holds 4 bytes in stream order, little-endian).

    As in the reference, every row writes all msb / 4 of its words, in
    row order, at start_i = min(offs_i, cap_words - msb / 4) (the clamp
    of `dynamic_update_slice`), and what no row writes stays 0.  So a
    row's unused tail lands where the next row starts, and is overwritten
    by it; with cap_words >= sum(used words) + msb / 4 every used prefix
    survives.  A smaller cap_words clamps the last rows' starts back over
    earlier rows, which the reference does too (hazard C-r4).
    cap_words < msb / 4 raises ValueError, where the reference raises
    TypeError.

    No write loop: the starts never decrease, so word p comes from the
    last row j with start_j <= p, as row_j[p - start_j] when that is
    inside the row, else 0."""
    b, s, msb = seg.shape
    if msb % 4:
        raise ValueError(f"slice buffers of {msb} B are not whole words")
    mw = msb // 4
    if cap_words < mw:
        raise ValueError(f"cap_words={cap_words} is below one slice buffer ({mw} words)")
    rows = seg.reshape(b * s, msb)
    if not rows.is_contiguous() or rows.storage_offset() % 4:
        rows = rows.clone(memory_format=torch.contiguous_format)
    words = rows.view(torch.int32).reshape(-1)
    used_w = torch.div(bits.reshape(-1).to(torch.int64) + 31, 32, rounding_mode="floor")
    ends = torch.cumsum(used_w, dim=0)
    offs = (ends - used_w).to(torch.int32)
    start = (ends - used_w).clamp(0, cap_words - mw).contiguous()
    p = torch.arange(cap_words, dtype=torch.int64, device=seg.device)
    j = torch.searchsorted(start, p, right=True) - 1
    jc = j.clamp(min=0)
    k = p - start[jc]
    hit = (j >= 0) & (k < mw)
    dense = torch.where(hit, words[jc * mw + k.clamp(0, mw - 1)], 0)
    return dense, offs


def split_compact_slices(dense_words: np.ndarray, bits: np.ndarray):
    """Host inverse of `compact_slices` (numpy, int32 or uint32 words):
    the (B, S) nested list of each slice's ceil(bits / 8) bytes, as views
    of dense_words."""
    byts = dense_words.view(np.uint8)
    used_w = (bits.reshape(-1).astype(np.int64) + 31) // 32
    offs = np.concatenate([[0], np.cumsum(used_w)[:-1]])
    nby = (bits.reshape(-1) + 7) // 8
    out = []
    for i in range(bits.size):
        start = int(offs[i]) * 4
        out.append(byts[start:start + int(nby[i])])
    b, s = bits.shape
    return [out[r * s:(r + 1) * s] for r in range(b)]
