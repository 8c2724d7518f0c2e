"""Vectorised MSB-first bit packing of the plain reference.

Tokens are (code, length) pairs in stream order, each tagged with the
slice it belongs to.  Each slice starts on a byte boundary and ends padded
with zero bits, as MPEG-1 slices do before the next start code.  The codes
of one stream never share a bit, so each byte is the sum of the pieces that
the tokens put into it; `np.bincount` adds the pieces.
"""

from __future__ import annotations

import numpy as np


def pack_slices(codes: np.ndarray, lens: np.ndarray, slice_of: np.ndarray,
                n_slices: int) -> tuple[np.ndarray, np.ndarray]:
    """codes (T,) unsigned < 2**32, lens (T,) 0..32, slice_of (T,)
    non-decreasing slice indices -> (bytes of every slice back to back
    (u8), bit count of each slice (n_slices,) int64)."""
    lens = lens.astype(np.int64)
    slice_bits = np.bincount(slice_of, weights=lens, minlength=n_slices).astype(np.int64)
    slice_bytes = (slice_bits + 7) // 8
    byte_start = np.cumsum(slice_bytes) - slice_bytes
    bit_start = np.cumsum(slice_bits) - slice_bits
    pos = np.cumsum(lens) - lens                      # global, unpadded
    pos += 8 * byte_start[slice_of] - bit_start[slice_of]
    first = pos >> 3
    # the code inside a 40-bit window that starts at its first byte
    window = codes.astype(np.uint64) << (40 - (pos & 7) - lens).astype(np.uint64)
    total = int(slice_bytes.sum())
    out = np.zeros(total + 5, np.float64)
    for j in range(5):
        piece = ((window >> np.uint64(32 - 8 * j)) & np.uint64(0xFF)).astype(np.float64)
        out += np.bincount(first + j, weights=piece, minlength=total + 5)
    return out[:total].astype(np.uint8), slice_bits
