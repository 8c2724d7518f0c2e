"""Run-length + VLC coding of quantized zigzag blocks: the scalar oracle.

The port's copy of the reference's `ops/rle_vlc.py`: per-block Python on
the host (`compat_block_codes`, `correct_block_codes`) that pins the exact
emission semantics, used by tests and the host oracle encoder
(`models/oracle.py`).  The vectorised emission (`ops/vlc_device.py` and
the VLC kernels) is held to it.

Which AC table each mode follows (hazard C-r5): compat mode follows the
reference C encoder's table (`tables.AC_CODE_COMPAT`: its run-0
off-by-one, and (run 16, |level| 2) with vlc.c:271's 15-bit typo), as the
`.bit`-exact golden stream does; correct mode follows ISO 11172-2 table
B.5c/d (`tables.AC_CODE_CORRECT`, the 16-bit (16, 2) code).

Compat semantics reproduce the reference bug surface (SURVEY.md §2.9):
  - runs are the zeros-before count and get decremented before lookup
    (vlc.c:326 "Run 1 actually means 0"), so stored run = zeros_before-1;
  - emission stops at the first pair whose zeros-before count is 0
    (image_processing.c:421-423, Q5) — adjacent nonzero coefficients
    truncate the block;
  - no AC sign bits on table codes (vlc.c:344 commented out, Q4);
  - run-0 levels index one row high in table B.5c (vlc.c:329-338);
  - DC is absolute, MSB-flipped when negative, not differential (Q6;
    mpeg1_blk.c:73-95).
"""

from __future__ import annotations

import numpy as np

from ec504_imageencoder_tpu_torch.utils.tables import (
    AC_CODE_COMPAT,
    AC_CODE_CORRECT,
    AC_LEN_COMPAT,
    AC_LEN_CORRECT,
    DC_SIZE_CHROMA_CODE,
    DC_SIZE_CHROMA_LEN,
    DC_SIZE_LUMA_CODE,
    DC_SIZE_LUMA_LEN,
    MAX_RUN,
    MV_CODE,
    MV_LEN,
)

Code = tuple[int, int]  # (value, nbits)

AC_EOB_CODE: Code = (0b10, 2)
AC_ESCAPE_CODE: Code = (0b000001, 6)


def rle_pairs(zigzag: np.ndarray) -> list[tuple[int, int]]:
    """(level, zeros_before) pairs over all 64 positions, in scan order.

    Matches reference run_length_encode (image_processing.c:703-751): every
    nonzero coefficient (including position 0, the DC) yields a pair.
    """
    pairs = []
    count = 0
    for v in zigzag.reshape(64).tolist():
        if v != 0:
            pairs.append((int(v), count))
            count = 0
        else:
            count += 1
    return pairs


def _dc_size_code(size: int, is_luma: bool) -> Code:
    if is_luma:
        return int(DC_SIZE_LUMA_CODE[size]), int(DC_SIZE_LUMA_LEN[size])
    return int(DC_SIZE_CHROMA_CODE[size]), int(DC_SIZE_CHROMA_LEN[size])


def compat_ac_code(zeros_before: int, level: int) -> list[Code]:
    """Emission for one AC pair, reference encode_blk_coeff (vlc.c:315-385).

    `zeros_before` must be >= 1 (the caller stops at 0 per Q5).
    """
    sign = level < 0
    al = -level if sign else level
    ri = zeros_before - 1
    if ri == 0 and al == 1:
        return [(0b11, 2)]  # `first` is always 0 in the reference (vlc.c:411-416)
    if ri <= MAX_RUN and al <= 40 and AC_LEN_COMPAT[ri, al] > 0:
        return [(int(AC_CODE_COMPAT[ri, al]), int(AC_LEN_COMPAT[ri, al]))]
    # escape coding (vlc.c:347-376): 6-bit escape + 6-bit run + level byte(s)
    if al >= 256 or ri >= 64:
        raise ValueError(f"unencodable AC pair run={ri} |level|={al}")
    out = [AC_ESCAPE_CODE, (ri & 0x3F, 6)]
    if al < 128:
        out.append(((256 - al) & 0xFF if sign else al, 8))
    else:
        out.append((0x80 if sign else 0x00, 8))
        out.append(((256 - al) & 0xFF if sign else al & 0xFF, 8))
    return out


def compat_block_codes(zigzag: np.ndarray, is_luma: bool) -> list[Code]:
    """Full compat emission for one block: DC + truncated AC run + EOB.

    Mirrors encode_block_header_i (mpeg1_blk.c:67-113) + VLC_encode
    (image_processing.c:400-433) + encode_block_end (mpeg1_blk.c:115-117).
    """
    pairs = rle_pairs(zigzag)
    codes: list[Code] = []
    dc = int(zigzag.reshape(64)[0])
    if dc != 0:
        # pairs[0] is (dc, 0); probed-size absolute DC coding (mpeg1_blk.c:73-95)
        coe = -dc if dc < 0 else dc
        low = coe & 0xFF
        sz = low.bit_length() if low else 1
        codes.append(_dc_size_code(sz, is_luma))
        if dc < 0:
            coe ^= 1 << (sz - 1)
        codes.append((coe & ((1 << sz) - 1), sz))
        ac = pairs[1:]
    else:
        codes.append(_dc_size_code(0, is_luma))
        ac = pairs
    for level, zeros_before in ac:
        if zeros_before == 0:
            break  # Q5: VLC_encode treats run 0 as terminator
        codes.extend(compat_ac_code(zeros_before, level))
    codes.append(AC_EOB_CODE)
    return codes


# --------------------------------------------------------------------------
# Correct-mode emission: ISO 11172-2 compliant intra block coding.

def dc_size(value: int) -> int:
    """dct_dc_size of a differential DC value (bit length of |value|)."""
    return abs(value).bit_length()


def correct_dc_codes(diff: int, is_luma: bool) -> list[Code]:
    """Differential DC per ISO 11172-2 §2.4.3.7: size VLC + offset bits.

    Negative differentials are coded as diff + (2^size - 1).
    """
    sz = dc_size(diff)
    if sz > 8:
        raise ValueError(f"DC differential out of range: {diff}")
    codes = [_dc_size_code(sz, is_luma)]
    if sz:
        v = diff if diff >= 0 else diff + (1 << sz) - 1
        codes.append((v & ((1 << sz) - 1), sz))
    return codes


def correct_ac_code(run: int, level: int, first: bool) -> list[Code]:
    """ISO AC pair coding with sign bit; `run` is the true zero-run (>= 0)."""
    sign = 1 if level < 0 else 0
    al = -level if sign else level
    if al == 0:
        raise ValueError("zero level")
    if run == 0 and al == 1:
        # table B.5c first entry: '1s' when first, '11s' otherwise
        return [(0b10 | sign, 2)] if first else [(0b110 | sign, 3)]
    if run <= MAX_RUN and al <= 40 and AC_LEN_CORRECT[run, al]:
        code = (int(AC_CODE_CORRECT[run, al]) << 1) | sign
        return [(code, int(AC_LEN_CORRECT[run, al]) + 1)]
    if al >= 256 or run >= 64:
        raise ValueError(f"unencodable AC pair run={run} |level|={al}")
    out = [AC_ESCAPE_CODE, (run & 0x3F, 6)]
    if al < 128:
        out.append(((256 - al) & 0xFF if sign else al, 8))
    else:
        out.append((0x80 if sign else 0x00, 8))
        out.append(((256 - al) & 0xFF if sign else al & 0xFF, 8))
    return out


def correct_block_codes(zigzag: np.ndarray, is_luma: bool, dc_pred: int) -> tuple[list[Code], int]:
    """ISO-compliant intra block: differential DC + signed AC + EOB.

    Returns (codes, new_dc_pred).
    """
    zz = zigzag.reshape(64)
    dc = int(zz[0])
    codes = correct_dc_codes(dc - dc_pred, is_luma)
    run = 0
    first = True
    for v in zz[1:].tolist():
        if v == 0:
            run += 1
        else:
            codes.extend(correct_ac_code(run, int(v), first=False))
            # note: in intra blocks the DC is always coded, so AC codes are
            # never "first"; the '1s' short form applies only to non-intra
            # blocks (ISO 11172-2 table B.5c note 2).
            run = 0
            first = False
    codes.append(AC_EOB_CODE)
    return codes, dc


def mv_code(value: int) -> Code:
    """Motion vector VLC, table B.4 (reference vlc.c:108-118).

    Unused by the I-frame path (as in the reference) but part of the API
    surface.  The reference emits the magnitude code and then overwrites
    its final bit with 1 for negative values (bitvector_pos(-1) +
    put_bit(1)), which matches B.4's sign convention.
    """
    if not -16 <= value <= 16:
        raise ValueError(f"motion code out of range: {value}")
    mag = -value if value < 0 else value
    code, length = int(MV_CODE[mag]), int(MV_LEN[mag])
    if value < 0:
        code |= 1  # set the final bit
    return code, length
