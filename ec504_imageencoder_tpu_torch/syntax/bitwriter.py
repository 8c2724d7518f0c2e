"""Host-side MSB-first bit writer: the header-side streams and the scalar
oracles.

The port's copy of the reference's `syntax/bitwriter.py` (pure Python):
the encoder appends (code, nbits) pairs and `tobytes` packs them;
`pack_codes` is the scalar packer that the pack kernels are held to.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Append-only MSB-first bit buffer."""

    __slots__ = ("_codes", "_lens", "_nbits")

    def __init__(self) -> None:
        self._codes: list[int] = []
        self._lens: list[int] = []
        self._nbits = 0

    @property
    def nbits(self) -> int:
        return self._nbits

    def put(self, code: int, nbits: int) -> None:
        """Append the low `nbits` bits of `code`, MSB first."""
        if nbits <= 0:
            return
        self._codes.append(int(code) & ((1 << nbits) - 1))
        self._lens.append(int(nbits))
        self._nbits += int(nbits)

    def put_bits(self, bits: str) -> None:
        """Append a literal bit-string like '0010'."""
        if bits:
            self.put(int(bits, 2), len(bits))

    def put_bytes(self, data: bytes) -> None:
        for b in data:
            self.put(b, 8)

    def align(self, bit: int = 0) -> None:
        """Pad with `bit` to the next byte boundary."""
        pad = -self._nbits % 8
        if pad:
            self.put(-1 if bit else 0, pad)

    def tobytes(self) -> bytes:
        """Serialize; a trailing partial byte is zero-padded low bits."""
        out = np.zeros((self._nbits + 7) // 8, dtype=np.uint8)
        pos = 0
        for code, n in zip(self._codes, self._lens):
            for k in range(n - 1, -1, -1):
                if (code >> k) & 1:
                    out[pos >> 3] |= 128 >> (pos & 7)
                pos += 1
        return out.tobytes()

    def code_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The (code u64, nbits i32) pairs appended so far."""
        return (
            np.asarray(self._codes, dtype=np.uint64),
            np.asarray(self._lens, dtype=np.int32),
        )


def pack_codes(codes: np.ndarray, lens: np.ndarray) -> bytes:
    """Scalar packer: (code, len) arrays -> MSB-first bytes."""
    w = BitWriter()
    for c, n in zip(codes.tolist(), lens.tolist()):
        w.put(int(c), int(n))
    return w.tobytes()
