"""MPEG-1 system and video-sequence header builders (byte-aligned layers).

The port's copy of the reference's `syntax/headers.py` (pure Python;
tests/test_torch_host.py holds it byte-equal to the reference's).  Each
function returns `bytes`, byte-exact against the reference C encoder's
emitters (mpeg1_enc.c:7-137).  The C encoder's quirks that compat mode
reproduces are explicit arguments, so correct mode uses the same
builders with sane values.
"""

from __future__ import annotations

import struct

PACK_START = b"\x00\x00\x01\xba"
SYSTEM_START = b"\x00\x00\x01\xbb"
VIDEO_PES_START = b"\x00\x00\x01\xe0"
SEQUENCE_START = b"\x00\x00\x01\xb3"
SEQUENCE_END = b"\x00\x00\x01\xb7"
GOP_START = b"\x00\x00\x01\xb8"
PICTURE_START = b"\x00\x00\x01\x00"
SLICE_START_BASE = 0x00000101  # slice 1; vertical position adds to low byte


def _mux_rate_bytes(multiplex_rate: int) -> bytes:
    """22-bit mux rate framed as marker|rate|marker (reference mpeg1_enc.c:14-20)."""
    v = ((multiplex_rate & 0x3FFFFF) | 0x400000) << 1 | 1
    return bytes([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])


def pack_header(multiplex_rate: int) -> bytes:
    """ISO 11172-1 pack header, 12 bytes (reference mpeg1_enc.c:7-21).

    SCR fields are left as the reference's fixed placeholder pattern.
    """
    return PACK_START + bytes([0x21, 0x00, 0x01, 0x00, 0x01]) + _mux_rate_bytes(multiplex_rate)


def system_header(multiplex_rate: int, packet_num: int) -> bytes:
    """ISO 11172-1 system header, 15 bytes (reference mpeg1_enc.c:24-44)."""
    return (
        SYSTEM_START
        + bytes([0x00, 0x09])
        + _mux_rate_bytes(multiplex_rate)
        + bytes([0x00, 0x21, 0xFF, 0xE0, 0xE0, packet_num & 0xFF])
    )


def pes_packet_header(dts_seconds: int) -> bytes:
    """Video PES packet header with PTS+DTS, 16 bytes.

    Reproduces reference mpeg1_enc.c:47-77 exactly, including its quirks:
    the "90 kHz" conversion is actually *1.2 with double->uint32 truncation,
    the DTS field carries the value + 0xbeef, and the 16-bit packet length
    starts as zero to be backpatched once the payload size is known
    (reference encoder.h:448-454 / patch_pes_length below).
    """
    if dts_seconds:
        d = int(float(dts_seconds & 0xFFFFFFFF) * 1.2) & 0xFFFFFFFF
        d = (d + 0xBEEF) & 0xFFFFFFFF
        body = bytes(
            [
                0x31 | ((d & 0xE0000000) >> 28),
                (d & 0x1FE00000) >> 21,
                0x01 | ((d & 0x001FC000) >> 13),
                (d & 0x00003FC0) >> 6,
                0x01 | ((d & 0x0000003F) << 1) & 0xFF,
            ]
        )
        d = (d - 0xBEEF) & 0xFFFFFFFF
        body += bytes(
            [
                0x11 | ((d & 0xE0000000) >> 28),
                (d & 0x1FE00000) >> 21,
                0x01 | ((d & 0x001FC000) >> 13),
                (d & 0x00003FC0) >> 6,
                0x01 | ((d & 0x0000003F) << 1) & 0xFF,
            ]
        )
    else:
        body = bytes([0x3F])
    return VIDEO_PES_START + b"\x00\x00" + body


def patch_pes_length(frame_bytes: bytearray, extra_after: int = 0) -> None:
    """Backpatch the PES packet length in-place over an assembled frame.

    The reference computes `ftell(end_of_slice_data) - (pes_start+4) - 4`
    (encoder.h:448-453).  `frame_bytes` must start at the PES start code and
    end where the reference's ftell stood (i.e. BEFORE the trailing
    sequence-end bytes); pass what follows via `extra_after` if the buffer
    already includes it.
    """
    fwd = len(frame_bytes) - extra_after - 4 - 4
    frame_bytes[4] = (fwd >> 8) & 0xFF
    frame_bytes[5] = fwd & 0xFF


def sequence_header(
    width: int,
    height: int,
    aspect_ratio: int = 1,
    frame_rate_code: int = 4,
    yby_size: int = 3,
) -> bytes:
    """Video sequence header, 12 bytes (reference mpeg1_enc.c:81-94).

    `width`/`height` are emitted as 12-bit fields; compat mode passes them
    pre-truncated to uint8 (SURVEY.md Q1).  Bitrate is the reference's
    fixed 0x3FFFF "variable" pattern; VBV size = yby_size.
    """
    return SEQUENCE_START + bytes(
        [
            (width & 0xFF0) >> 4,
            ((width & 0xF) << 4) | ((height & 0xF00) >> 8),
            height & 0x0FF,
            ((aspect_ratio & 0xF) << 4) | (frame_rate_code & 0xF),
            0xFF,
            0xFF,
            0xE0,
            (yby_size & 0x1F) << 3,
        ]
    )


def gop_header(
    hour: int,
    minute: int,
    second: int,
    num_pic: int = 0,
    drop_frame: int = 0,
    closed: int = 1,
    broken: int = 0,
) -> bytes:
    """GOP header, 8 bytes (reference mpeg1_enc.c:103-113)."""
    return GOP_START + bytes(
        [
            ((drop_frame & 1) << 7) | ((hour & 0x1F) << 2) | ((minute & 0x30) >> 4),
            ((minute & 0xF) << 4) | 0x8 | ((second & 0x38) >> 3),
            ((second & 0x7) << 5) | ((num_pic & 0xFC) >> 1),
            ((num_pic & 1) << 7) | ((closed & 1) << 6) | ((broken & 1) << 5),
        ]
    )


PICTURE_TYPE_I = 1
PICTURE_TYPE_P = 2
PICTURE_TYPE_B = 3


def picture_header(
    temporal_ref: int,
    picture_type: int = PICTURE_TYPE_I,
    vbv_delay: int = 0xFFFF,
) -> bytes:
    """Picture header for I frames, 8 bytes (reference mpeg1_enc.c:120-129).

    P/B extra fields are not emitted — this framework encodes I frames only,
    like the reference (README.md:132-137).
    """
    if picture_type != PICTURE_TYPE_I:
        raise ValueError("only I-frames are supported")
    return PICTURE_START + bytes(
        [
            (temporal_ref & 0x3FC) >> 2,
            ((temporal_ref & 0x3) << 6)
            | ((picture_type & 0x7) << 3)
            | ((vbv_delay & 0xE000) >> 13),
            (vbv_delay & 0x1FE0) >> 5,
            (vbv_delay & 0x1F) << 3,
        ]
    )


def sequence_end() -> bytes:
    """Proper sequence_end_code (reference mpeg1_enc.c:96-98, never called)."""
    return SEQUENCE_END


# The reference writes 4 *uninitialized* stack bytes where the sequence end
# code belongs (encoder.h:456-458, SURVEY.md Q8).  With the reference binary
# built by the survey's toolchain the garbage is stable:
COMPAT_SEQUENCE_END_GARBAGE = b"\xff\x00\x00\x00"


def raw_plane_dump(width: int, height: int, y, cb, cr) -> bytes:
    """Per-image .bit payload: int32 w, int32 h, full-res Y|Cb|Cr planes
    (reference image_processing.c:753-787)."""
    return struct.pack("<ii", width, height) + bytes(y) + bytes(cb) + bytes(cr)
