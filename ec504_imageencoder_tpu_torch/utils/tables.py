"""Constant tables for MPEG-1 intra coding: numpy first, then torch.

The port's own copy of the reference's `utils/tables.py` (the ISO tables,
the decoder's macroblock address VLC, the motion vector VLC, and the
compat AC table with the
reference's run-0 off-by-one and its (16, 2) typo) and of the packed
tables of `ops/mxu_lut.py`
(`ac_packed_table`, `_dc_packed`), under the reference's names.
tests/test_torch_host.py holds every one equal to the reference's.

Sources (behavioral parity): the reference C encoder's
image_processing.c:17-37 (intra matrix, zigzag) and vlc.c:121-297 (the
dct_dc_size and AC run/level VLCs of ISO/IEC 11172-2 Tables B.5a-d).

The torch section builds int32 CPU tensors from them; callers move them
to their device (EncodeCore registers them as buffers).
"""

from __future__ import annotations

import numpy as np
import torch

# ---- numpy: the reference's tables ----------------------------------------

# Default MPEG-1 intra quantizer matrix (ISO 11172-2 §2.4.3.2).
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

# ZIGZAG_INDEX[r, c] = scan position of coefficient (r, c); ZIGZAG_GATHER[k]
# = flat (r*8 + c) index of the k-th scanned coefficient (its inverse).
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
    """(code, len) arrays from a list of bit-strings ('' -> len 0)."""
    n = len(entries)
    code = np.zeros(n, dtype=np.uint32)
    length = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(entries):
        if s:
            code[i] = int(s, 2)
            length[i] = len(s)
    return code, length


# Motion vector VLC, Table B.4 magnitudes 0..16 (sign bit appended for
# nonzero values).  Unused by the I-frame path.
_MV_BITS = [
    "1", "010", "0010", "00010", "0000110", "00001010", "00001000",
    "00000110", "0000010110", "0000010100", "0000010010", "00000100010",
    "00000100000", "00000011110", "00000011100", "00000011010", "00000011000",
]
MV_CODE, MV_LEN = _codes(_MV_BITS)

# dct_dc_size VLCs, Tables B.5a (luma) and B.5b (chroma), sizes 0..8.
_DC_SIZE_LUMA_BITS = [
    "100", "00", "01", "101", "110", "1110", "11110", "111110", "1111110",
]
_DC_SIZE_CHROMA_BITS = [
    "00", "01", "10", "110", "1110", "11110", "111110", "1111110", "11111110",
]
DC_SIZE_LUMA_CODE, DC_SIZE_LUMA_LEN = _codes(_DC_SIZE_LUMA_BITS)
DC_SIZE_CHROMA_CODE, DC_SIZE_CHROMA_LEN = _codes(_DC_SIZE_CHROMA_BITS)

# Macroblock address increment VLC, ISO 11172-2 Table B.1 (values 1..33),
# plus stuffing (34) and escape (35), for the decoder.  Reference vlc.c:33-70.
_MB_ADDRESS_BITS = [
    "",  # 0: invalid
    "1", "011", "010", "0011", "0010", "00011", "00010",
    "0000111", "0000110", "00001011", "00001010", "00001001", "00001000",
    "00000111", "00000110", "0000010111", "0000010110", "0000010101",
    "0000010100", "0000010011", "0000010010", "00000100011", "00000100010",
    "00000100001", "00000100000", "00000011111", "00000011110", "00000011101",
    "00000011100", "00000011011", "00000011010", "00000011001", "00000011000",
    "00000001111",  # 34: macroblock_stuffing
    "00000001000",  # 35: macroblock_escape
]
MB_ADDRESS_CODE, MB_ADDRESS_LEN = _codes(_MB_ADDRESS_BITS)
MB_STUFFING = 34
MB_ESCAPE = 35

# AC run/level VLC, Tables B.5c/d, without the sign bit: run -> bit-strings
# for |level| = first_level.. (run 0 starts at 2: (0, 1) has the dedicated
# codes "1" / "11"; every other run starts at 1).
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

# The reference C encoder's (16, 2) has a missing zero: 15 bits that
# duplicate the (0, 35) code (vlc.c:271).  Compat mode reproduces it; the
# ISO table keeps the 16-bit code.
_AC_REF_ERRATA = {(16, 2): "000000000010101"}

MAX_RUN = 31          # largest run with a VLC row
MAX_AC_LEVEL = 40     # largest |level| with any VLC row (run 0)


def _build_ac_lut(compat: bool) -> tuple[np.ndarray, np.ndarray]:
    """Dense (run 0..31, |level| 0..40) -> (code, len); len 0 = escape.

    compat=True reproduces the reference C encoder's run-0 off-by-one:
    |level| L (2 <= L <= 40) holds the level-(L+1) code and |level| 40
    has no row; the (0, 1) code is the encoder's, not the table's."""
    code = np.zeros((MAX_RUN + 1, MAX_AC_LEVEL + 1), dtype=np.uint32)
    length = np.zeros((MAX_RUN + 1, MAX_AC_LEVEL + 1), dtype=np.int32)
    for run, rows in _AC_BITS.items():
        first_level = 2 if run == 0 else 1
        for k, bits in enumerate(rows):
            level = first_level + k
            if compat:
                bits = _AC_REF_ERRATA.get((run, level), bits)
            if compat and run == 0:
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
    """JPEG-style quality scaling of the intra matrix, as the reference C
    encoder computes it (image_processing.c:314-343): qf clamped to
    [1, 100]; an f32 scaling factor (5000/qf below 50, else 200 - 2 qf);
    each entry an f32 product promoted to double, / 100.0, C round(),
    truncated, clamped to >= 1."""
    qf = min(100, max(1, int(quality_factor)))
    if qf < 50:
        scaling = np.float32(np.float64(5000.0) / qf)
    else:
        scaling = np.float32(200.0 - 2 * qf)
    prod = (INTRA_Q_MATRIX.astype(np.float32) * scaling).astype(np.float64)
    rounded = np.floor(prod / 100.0 + 0.5)  # C round() for positive values
    return np.maximum(rounded.astype(np.int32), 1)


def _build_rank_tables():
    """The ISO AC table rank-compressed: rank -> (code, len), runs in
    order, |levels| in order within a run (111 rows)."""
    rank_code = np.zeros(128, np.uint32)
    rank_len = np.zeros(128, np.int32)
    r = 0
    for run in range(32):
        for level in range(2 if run == 0 else 1, MAX_AC_LEVEL + 1):
            if AC_LEN_CORRECT[run, level]:
                rank_code[r] = AC_CODE_CORRECT[run, level]
                rank_len[r] = AC_LEN_CORRECT[run, level]
                r += 1
    return rank_code, rank_len


AC_RANK_CODE, AC_RANK_LEN = _build_rank_tables()


def ac_packed_table() -> np.ndarray:
    """(112,) u32 `code | len << 16`, the rank-compressed AC table (111
    rows and one pad)."""
    return (AC_RANK_CODE | (AC_RANK_LEN.astype(np.uint32) << 16))[:112]


def _dc_packed() -> np.ndarray:
    """(32,) u32 `code | len << 8` of the dct_dc_size VLCs at index
    is_luma * 16 + size."""
    code = np.zeros(32, np.uint32)
    length = np.zeros(32, np.uint32)
    code[0:9] = DC_SIZE_CHROMA_CODE
    length[0:9] = DC_SIZE_CHROMA_LEN
    code[16:25] = DC_SIZE_LUMA_CODE
    length[16:25] = DC_SIZE_LUMA_LEN
    return code | (length << 8)


# ---- torch: int32 tensors for the device pipeline -------------------------


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


ZIGZAG_GATHER_T = _t(ZIGZAG_GATHER)
ZIGZAG_INDEX_T = _t(ZIGZAG_INDEX.reshape(-1))
# [run 0..31, |level| 0..40] -> code (<= 16 bits, no sign) and len (0: escape)
AC_CODE_T = _t(AC_CODE_CORRECT)
AC_LEN_T = _t(AC_LEN_CORRECT)
AC_CODE_COMPAT_T = _t(AC_CODE_COMPAT)
AC_LEN_COMPAT_T = _t(AC_LEN_COMPAT)
# dct_dc_size VLCs stacked as [is_luma, size 0..8] (row 0 chroma, row 1 luma)
DC_CODE_T = _t(np.stack([DC_SIZE_CHROMA_CODE, DC_SIZE_LUMA_CODE]))
DC_LEN_T = _t(np.stack([DC_SIZE_CHROMA_LEN, DC_SIZE_LUMA_LEN]))
# the packed tables of the lookup kernel B5 (rank = the row of (run,
# |level|), see ops/cuda_lut.py::rank_base)
AC_PACKED = _t(ac_packed_table())
DC_PACKED = _t(_dc_packed())
