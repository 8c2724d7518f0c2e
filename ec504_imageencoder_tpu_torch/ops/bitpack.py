"""Slot fusion and bit packing in plain PyTorch (int64 words).

* `fuse4`: exact 4:1 slot fusion, the arithmetic of the reference's
  `ops/pallas_vlc.fuse_slots_streamwise`: four consecutive (code, len)
  slots of <= 30 bits become one right-aligned value of <= 128 bits,
  held as four 32-bit words v0..v3 (most significant first).
* `pack_words4`: the prefix-sum pack of such values.  Each value lands
  at bit offset cumsum(lens) + bit_offset, MSB first, and spans at most
  5 consecutive 32-bit words.  Words past `max_words` are dropped, but
  `nbits` is the true total, so the caller can regrow exactly.
  Contributions are bit-disjoint, so `index_add_` equals an OR.
* `pack_words`: the same for plain <= 32-bit codes (the reference's
  `ops/bitpack.pack_words`).
* `words_to_bytes`, `or_slice_headers`: big-endian serialisation and
  the 38-bit slice header (`models/mpeg1._or_slice_headers`).

Every 32-bit quantity is carried in int64: torch on the CPU cannot shift
or compare uint32.
"""

from __future__ import annotations

import torch

_I64 = torch.int64
_M32 = 0xFFFFFFFF


def _shl(x, k):
    return torch.bitwise_left_shift(x, k)


def _shr(x, k):
    return torch.bitwise_right_shift(x, k)


def fuse4(codes: torch.Tensor, lens: torch.Tensor):
    """(..., K) slot codes/lens in stream order, K % 4 == 0 ->
    (v0, v1, v2, v3, flens), each (..., K // 4) int64.

    Zero-length slots contribute nothing whatever their code."""
    codes = torch.where(lens > 0, codes.to(_I64), 0)
    lens = lens.to(_I64)
    c = codes.reshape(*codes.shape[:-1], -1, 2)
    ln = lens.reshape(*lens.shape[:-1], -1, 2)
    c1, c2, l1, l2 = c[..., 0], c[..., 1], ln[..., 0], ln[..., 1]
    # level 1: pairs of <= 30-bit slots -> (hi, lo) 32-bit words
    r = l2 & 31
    rc = (32 - r) & 31
    hi = torch.where(l2 > 0, _shr(c1, rc), 0)
    lo = (torch.where(l2 < 32, _shl(c1, r) & _M32, 0)) | c2
    len2 = l1 + l2
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


def pack_words4(v0, v1, v2, v3, flens, max_words: int, bit_offset: int = 0):
    """(n, KF) <= 128-bit values (four 32-bit words each, any integer
    dtype holding the same bits) + (n, KF) lengths ->
    (words (n, max_words) int64, nbits (n,) int64)."""
    n, kf = flens.shape
    dev = flens.device
    lens = flens.to(_I64)
    ends = torch.cumsum(lens, dim=-1) + bit_offset
    off = ends - lens
    nbits = ends[:, -1] if kf else torch.full((n,), bit_offset, dtype=_I64, device=dev)
    word = off >> 5
    s = off & 31
    # place the value at the top of a 160-bit window: shift left by
    # 160 - s - len = 32 q + r over the words [0, v0, v1, v2, v3]
    sig = 160 - s - lens
    q = sig >> 5
    r = sig & 31
    rc = 32 - r  # 32 when r == 0: an int64 shift by 32 of a u32 gives 0
    u = [torch.zeros_like(lens)] + [
        torch.where(lens > 0, v.to(_I64) & _M32, 0) for v in (v0, v1, v2, v3)
    ]
    f = [
        (_shl(u[i], r) & _M32) | (_shr(u[i + 1], rc) if i < 4 else 0)
        for i in range(5)
    ]
    out = torch.zeros(n * max_words, dtype=_I64, device=dev)
    rows = torch.arange(n, device=dev, dtype=_I64)[:, None] * max_words
    for j in range(5):
        wj = torch.zeros_like(lens)
        for qq in range(5 - j):
            wj = torch.where(q == qq, f[j + qq], wj)
        idx = word + j
        keep = idx < max_words
        out.index_add_(
            0,
            torch.where(keep, rows + idx, 0).reshape(-1),
            torch.where(keep, wj, 0).reshape(-1),
        )
    return out.reshape(n, max_words), nbits


def pack_words(codes, lens, max_words: int, bit_offset: int = 0):
    """(n, K) <= 32-bit codes -> (words (n, max_words) int64, nbits (n,))."""
    z = torch.zeros_like(lens, dtype=_I64)
    return pack_words4(z, z, z, codes, lens, max_words, bit_offset)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., W) 32-bit words (int64) -> (..., 4W) u8, big-endian."""
    w = words.to(_I64)
    b = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(*words.shape[:-1], words.shape[-1] * 4)


def or_slice_headers(seg: torch.Tensor, qscale: int) -> torch.Tensor:
    """OR the 38-bit slice header into bytes 0..4 of every (B, mbh, msb)
    slice segment, in place: 00 00 01 vpos [qscale<<3].  The pack leaves
    those bits zero (bit_offset=38)."""
    mbh = seg.shape[1]
    hdr = torch.zeros((mbh, 5), dtype=torch.uint8, device=seg.device)
    hdr[:, 2] = 1
    hdr[:, 3] = torch.arange(1, mbh + 1, dtype=torch.uint8, device=seg.device)
    hdr[:, 4] = (qscale & 0x1F) << 3
    seg[..., :5] |= hdr
    return seg
