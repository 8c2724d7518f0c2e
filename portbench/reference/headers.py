"""Byte-aligned MPEG-1 headers of the plain reference.

A frozen copy of the header builders of the JAX package
(`syntax/headers.py`, and the correct-mode sequence and GOP headers of
`models/mpeg1.py`), with a bit writer of its own.  Compat mode repeats the
C course project's quirks: pre-truncated dimensions, the PES timestamps'
`* 1.2`, and four stale bytes where the sequence end code belongs.
"""

from __future__ import annotations

import struct

import numpy as np

from portbench.reference.tables import ZIGZAG_GATHER

PACK_START = b"\x00\x00\x01\xba"
SYSTEM_START = b"\x00\x00\x01\xbb"
VIDEO_PES_START = b"\x00\x00\x01\xe0"
SEQUENCE_START = b"\x00\x00\x01\xb3"
GOP_START = b"\x00\x00\x01\xb8"
PICTURE_START = b"\x00\x00\x01\x00"
COMPAT_SEQUENCE_END_GARBAGE = b"\xff\x00\x00\x00"

FRAME_RATE_VALUES = {1: 23.976, 2: 24.0, 3: 25.0, 4: 29.97, 5: 30.0, 6: 50.0, 7: 59.94, 8: 60.0}


def _bits_to_bytes(fields) -> bytes:
    """[(value, nbits), ...] MSB first, zero-padded to a whole byte."""
    acc, n = 0, 0
    for value, nbits in fields:
        acc = (acc << nbits) | (int(value) & ((1 << nbits) - 1))
        n += nbits
    pad = -n % 8
    return (acc << pad).to_bytes((n + pad) // 8, "big")


def _mux_rate_bytes(rate: int) -> bytes:
    v = ((rate & 0x3FFFFF) | 0x400000) << 1 | 1
    return bytes([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])


def pack_header(rate: int) -> bytes:
    return PACK_START + bytes([0x21, 0x00, 0x01, 0x00, 0x01]) + _mux_rate_bytes(rate)


def system_header(rate: int, packet_num: int) -> bytes:
    return (SYSTEM_START + bytes([0x00, 0x09]) + _mux_rate_bytes(rate)
            + bytes([0x00, 0x21, 0xFF, 0xE0, 0xE0, packet_num & 0xFF]))


def _timestamp(marker: int, d: int) -> bytes:
    return bytes([marker | ((d & 0xE0000000) >> 28), (d & 0x1FE00000) >> 21,
                  0x01 | ((d & 0x001FC000) >> 13), (d & 0x00003FC0) >> 6,
                  0x01 | ((d & 0x0000003F) << 1) & 0xFF])


def pes_packet_header(dts_seconds: int) -> bytes:
    """The C project's video PES header: PTS = DTS + 0xBEEF of `s * 1.2`
    truncated, the length left 0 for `patch_pes_length`."""
    d = int(float(dts_seconds & 0xFFFFFFFF) * 1.2) & 0xFFFFFFFF
    body = _timestamp(0x31, (d + 0xBEEF) & 0xFFFFFFFF) + _timestamp(0x11, d)
    return VIDEO_PES_START + b"\x00\x00" + body


def patch_pes_length(frame: bytearray) -> None:
    fwd = len(frame) - 8
    frame[4], frame[5] = (fwd >> 8) & 0xFF, fwd & 0xFF


def compat_sequence_header(width: int, height: int) -> bytes:
    """The C project's 12-byte sequence header: frame rate code 4, VBV 3."""
    return SEQUENCE_START + bytes([
        (width & 0xFF0) >> 4, ((width & 0xF) << 4) | ((height & 0xF00) >> 8), height & 0xFF,
        (1 << 4) | 4, 0xFF, 0xFF, 0xE0, 3 << 3])


def gop_header(hour: int, minute: int, second: int, num_pic: int = 0, closed: int = 1) -> bytes:
    return GOP_START + bytes([
        ((hour & 0x1F) << 2) | ((minute & 0x30) >> 4),
        ((minute & 0xF) << 4) | 0x8 | ((second & 0x38) >> 3),
        ((second & 0x7) << 5) | ((num_pic & 0xFC) >> 1),
        ((num_pic & 1) << 7) | ((closed & 1) << 6)])


def picture_header(temporal_ref: int) -> bytes:
    """An I picture, vbv_delay 0xFFFF."""
    return PICTURE_START + _bits_to_bytes([(temporal_ref, 10), (1, 3), (0xFFFF, 16)])


def raw_plane_dump(width: int, height: int, y, cb, cr) -> bytes:
    """A `.bit` dump: int32 width and height, then the full Y, Cb, Cr planes."""
    return struct.pack("<ii", width, height) + bytes(y) + bytes(cb) + bytes(cr)


def sequence_header_es(width: int, height: int, frame_rate_code: int,
                       intra_matrix: np.ndarray) -> bytes:
    """ISO 11172-2 §2.4.2.3 sequence header with the intra quantizer matrix
    in zigzag order, variable bit rate, VBV 20."""
    fields = [(width, 12), (height, 12), (1, 4), (frame_rate_code, 4), (0x3FFFF, 18),
              (1, 1), (20, 10), (0, 1), (1, 1)]
    fields += [(int(v), 8) for v in np.asarray(intra_matrix).reshape(64)[ZIGZAG_GATHER]]
    fields += [(0, 1)]
    return SEQUENCE_START + _bits_to_bytes(fields)


def gop_header_es(frame_index: int, fps: float) -> bytes:
    """Closed GOP header with the SMPTE timecode of `frame_index`."""
    fps_i = max(1, int(round(fps)))
    total_s, pic = divmod(frame_index, fps_i)
    total_m, sec = divmod(total_s, 60)
    hour, minute = divmod(total_m, 60)
    return gop_header(hour, minute, sec, pic)
