"""ISO/IEC 11172-2 intra-coding tables of the plain reference, as dense
numpy look-up tables: the default intra quantizer matrix, the zigzag scan,
dct_dc_size (B.5a/b) and the AC run/level VLC (B.5c/d) in both the ISO
mapping and the C course project's run-0 off-by-one (compat mode).

A frozen copy of the JAX package's `utils/tables.py`, so that later changes
to either package do not move the benchmark's yardstick.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Default MPEG-1 intra quantizer matrix (ISO 11172-2 §2.4.3.2;
# reference image_processing.c:17-26).
INTRA_Q_MATRIX = np.array(
    [
        [8, 16, 19, 22, 26, 27, 29, 34],
        [16, 16, 22, 24, 27, 29, 34, 37],
        [19, 22, 26, 27, 29, 34, 34, 38],
        [22, 22, 26, 27, 29, 34, 37, 40],
        [22, 26, 27, 29, 32, 35, 40, 48],
        [26, 27, 29, 32, 35, 40, 48, 58],
        [26, 27, 29, 34, 38, 46, 56, 69],
        [27, 29, 35, 38, 46, 56, 69, 83],
    ],
    dtype=np.int32,
)

# Zigzag: ZIGZAG_INDEX[r, c] = position of coefficient (r, c) in the scan
# (reference image_processing.c:28-37).  ZIGZAG_GATHER[k] = flat (r*8+c)
# index of the k-th scanned coefficient, i.e. the inverse permutation, which
# is what a vectorized gather wants.
ZIGZAG_INDEX = np.array(
    [
        [0, 1, 5, 6, 14, 15, 27, 28],
        [2, 4, 7, 13, 16, 26, 29, 42],
        [3, 8, 12, 17, 25, 30, 41, 43],
        [9, 11, 18, 24, 31, 40, 44, 53],
        [10, 19, 23, 32, 39, 45, 52, 54],
        [20, 22, 33, 38, 46, 51, 55, 60],
        [21, 34, 37, 47, 50, 56, 59, 61],
        [35, 36, 48, 49, 57, 58, 62, 63],
    ],
    dtype=np.int32,
)

ZIGZAG_GATHER = np.empty(64, dtype=np.int32)
ZIGZAG_GATHER[ZIGZAG_INDEX.reshape(-1)] = np.arange(64, dtype=np.int32)


def _codes(entries):
    """Build (code, len) arrays from a list of bit-strings ('' -> invalid)."""
    n = len(entries)
    code = np.zeros(n, dtype=np.uint32)
    length = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(entries):
        if s:
            code[i] = int(s, 2)
            length[i] = len(s)
    return code, length


# --------------------------------------------------------------------------
# dct_dc_size VLCs, Tables B.5a (luma) and B.5b (chroma), sizes 0..8.
# Reference vlc.c:121-144.
_DC_SIZE_LUMA_BITS = [
    "100", "00", "01", "101", "110", "1110", "11110", "111110", "1111110",
]
_DC_SIZE_CHROMA_BITS = [
    "00", "01", "10", "110", "1110", "11110", "111110", "1111110", "11111110",
]
DC_SIZE_LUMA_CODE, DC_SIZE_LUMA_LEN = _codes(_DC_SIZE_LUMA_BITS)
DC_SIZE_CHROMA_CODE, DC_SIZE_CHROMA_LEN = _codes(_DC_SIZE_CHROMA_BITS)

# --------------------------------------------------------------------------
# AC coefficient run/level VLC, Tables B.5c/B.5d.  (run, |level|) -> bits,
# sign bit appended by the encoder (correct mode) or omitted (compat mode,
# reference vlc.c:344 has it commented out).  Reference vlc.c:176-288.
#
# Layout: dict run -> list of bit-strings for |level| = first_level..N.
# For run 0 the first row is |level|=2 ((0,1) has the dedicated codes
# "1"/"11"); for every other run rows start at |level|=1.
_AC_BITS = {
    0: [  # |level| = 2..40
        "0100", "00101", "0000110", "00100110", "00100001", "0000001010",
        "000000011101", "000000011000", "000000010011", "000000010000",
        "0000000011010", "0000000011001", "0000000011000", "0000000010111",
        "00000000011111", "00000000011110", "00000000011101", "00000000011100",
        "00000000011011", "00000000011010", "00000000011001", "00000000011000",
        "00000000010111", "00000000010110", "00000000010101", "00000000010100",
        "00000000010011", "00000000010010", "00000000010001", "00000000010000",
        "000000000011000", "000000000010111", "000000000010110",
        "000000000010101", "000000000010100", "000000000010011",
        "000000000010010", "000000000010001", "000000000010000",
    ],
    1: [  # |level| = 1..18
        "011", "000110", "00100101", "0000001100", "000000011011",
        "0000000010110", "0000000010101", "000000000011111",
        "000000000011110", "000000000011101", "000000000011100",
        "000000000011011", "000000000011010", "000000000011001",
        "0000000000010011", "0000000000010010", "0000000000010001",
        "0000000000010000",
    ],
    2: ["0101", "0000100", "0000001011", "000000010100", "0000000010100"],
    3: ["00111", "00100100", "000000011100", "0000000010011"],
    4: ["00110", "0000001111", "000000010010"],
    5: ["000111", "0000001001", "0000000010010"],
    6: ["000101", "000000011110", "0000000000010100"],
    7: ["000100", "000000010101"],
    8: ["0000111", "000000010001"],
    9: ["0000101", "0000000010001"],
    10: ["00100111", "0000000010000"],
    11: ["00100011", "0000000000011010"],
    12: ["00100010", "0000000000011001"],
    13: ["00100000", "0000000000011000"],
    14: ["0000001110", "0000000000010111"],
    15: ["0000001101", "0000000000010110"],
    16: ["0000001000", "0000000000010101"],
    17: ["000000011111"],
    18: ["000000011010"],
    19: ["000000011001"],
    20: ["000000010111"],
    21: ["000000010110"],
    22: ["0000000011111"],
    23: ["0000000011110"],
    24: ["0000000011101"],
    25: ["0000000011100"],
    26: ["0000000011011"],
    27: ["0000000000011111"],
    28: ["0000000000011110"],
    29: ["0000000000011101"],
    30: ["0000000000011100"],
    31: ["0000000000011011"],
}

# The reference transcribed (16,2) with a missing zero — 15 bits,
# "000000000010101", which DUPLICATES the (0,35) code and makes its
# streams ambiguous (vlc.c:271; ISO B.5d has 16 bits).  The compat table
# must reproduce the typo bit-for-bit; the correct table uses the ISO
# code (the ambiguity was caught by the spec decoder at high quality).
_AC_REF_ERRATA = {(16, 2): "000000000010101"}

# Special codes (reference vlc.c:290-297).
AC_FIRST_1 = ("1", 1)        # (0, +-1) as the first coefficient of a block
AC_NOTFIRST_1 = ("11", 2)    # (0, +-1) elsewhere
AC_EOB = ("10", 2)           # end_of_block
AC_ESCAPE = ("000001", 6)

MAX_RUN = 31          # largest run with a VLC row
MAX_AC_LEVEL = 40     # largest |level| with any VLC row (run 0)


def _build_ac_lut(compat: bool) -> tuple[np.ndarray, np.ndarray]:
    """Dense (run 0..31, |level| 0..40) -> (code, len); len 0 = escape needed.

    compat=True reproduces the reference's run-0 off-by-one: |level| L
    (2 <= L <= 40) maps to the row the reference picks via
    ``table[lookup[0] + (L-1)]`` which is the level-(L+1) bitstring, and
    |level|==40 escapes one row early.  The (0,1)/"11" special entry is
    handled by the encoder, not this table.
    """
    code = np.zeros((MAX_RUN + 1, MAX_AC_LEVEL + 1), dtype=np.uint32)
    length = np.zeros((MAX_RUN + 1, MAX_AC_LEVEL + 1), dtype=np.int32)
    for run, rows in _AC_BITS.items():
        first_level = 2 if run == 0 else 1
        for k, bits in enumerate(rows):
            level = first_level + k
            if compat:
                bits = _AC_REF_ERRATA.get((run, level), bits)
            if compat and run == 0:
                # reference: lvl_idx = |level|-1 bounds-checked against 39
                # rows then used as a direct row offset -> |level| L lands on
                # row L-1 which holds the level-(L+1) code; L=1 is the
                # special-cased "11"; row for level 40 is unreachable.
                ref_level = level - 1
                if ref_level < 2:
                    continue
                code[run, ref_level] = int(bits, 2)
                length[run, ref_level] = len(bits)
            else:
                code[run, level] = int(bits, 2)
                length[run, level] = len(bits)
    return code, length


AC_CODE_COMPAT, AC_LEN_COMPAT = _build_ac_lut(compat=True)
AC_CODE_CORRECT, AC_LEN_CORRECT = _build_ac_lut(compat=False)


def scale_quantization_matrix(quality_factor: int) -> np.ndarray:
    """JPEG-style quality scaling of the intra matrix.

    Matches reference image_processing.c:314-343 bit-for-bit: qf clamped to
    [1,100]; scaling_factor is a C float (f32) of 5000/qf below 50 else
    200-2*qf; each entry is Q*scaling computed as an f32 product (int*float
    in C), promoted to double, divided by 100.0, C round() (half away from
    zero), truncated to int, clamped to >= 1.
    """
    qf = min(100, max(1, int(quality_factor)))
    if qf < 50:
        scaling = np.float32(np.float64(5000.0) / qf)
    else:
        scaling = np.float32(200.0 - 2 * qf)
    prod = (INTRA_Q_MATRIX.astype(np.float32) * scaling).astype(np.float64)
    rounded = np.floor(prod / 100.0 + 0.5)  # C round() for positive values
    return np.maximum(rounded.astype(np.int32), 1)
