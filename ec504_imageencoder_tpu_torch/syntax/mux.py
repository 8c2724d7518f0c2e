"""MPEG-1 system-layer (ISO 11172-1) muxing for correct-mode streams (the
port's copy of the JAX package's `syntax/mux.py`, on the port's own
`syntax/headers.py`; held equal by tests/test_torch_entry.py).

The reference wraps its video in a pack header + system header + one PES
packet per picture with quirky fields (reference mpeg1_enc.c:7-77,
encoder.h:196-213); compat mode reproduces that byte-for-byte in
models/encoder.py.  This module is the *correct* counterpart: a minimal
but standards-shaped program stream — pack + system header up front,
then the video ES split into PES packets on picture boundaries with real
90 kHz PTS — so correct-mode output can also be delivered in the
reference's container format.
"""

from __future__ import annotations

from ec504_imageencoder_tpu_torch.syntax import headers

MAX_PES_PAYLOAD = 0xFFF0
ISO11172_END = b"\x00\x00\x01\xb9"  # program end code (ISO 11172-1 §2.4.3.2)


def _pts_bytes(pts90: int, first: bool) -> bytes:
    """PES PTS field: '0010' marker layout per ISO 11172-1 §2.4.3.6."""
    v = pts90 & ((1 << 33) - 1)
    return bytes(
        [
            0x21 | (((v >> 30) & 0x7) << 1),
            (v >> 22) & 0xFF,
            0x01 | (((v >> 15) & 0x7F) << 1),
            (v >> 7) & 0xFF,
            0x01 | ((v & 0x7F) << 1),
        ]
    )


def pes_packet(payload: bytes, pts90: int | None) -> bytes:
    """One video PES packet (stream 0xE0), MPEG-1 style header."""
    header = _pts_bytes(pts90, True) if pts90 is not None else b"\x0f"
    length = len(header) + len(payload)
    if length > 0xFFFF:
        raise ValueError("PES payload too large")
    return (
        headers.VIDEO_PES_START
        + bytes([(length >> 8) & 0xFF, length & 0xFF])
        + header
        + payload
    )


def mux_program_stream(
    picture_payloads: list[bytes], fps: float, mux_rate: int = 2_202_035
) -> bytes:
    """Wrap per-picture ES chunks into a program stream.

    `picture_payloads[i]` must contain everything belonging to picture i
    (any preceding sequence/GOP headers included); the final sequence_end
    is appended to the last packet.
    """
    out = bytearray()
    out += headers.pack_header(mux_rate)
    out += headers.system_header(mux_rate, 0xE6)
    for i, payload in enumerate(picture_payloads):
        if i == len(picture_payloads) - 1:
            payload = payload + headers.sequence_end()
        pts = int(round(i * 90000 / fps))
        for start in range(0, len(payload), MAX_PES_PAYLOAD):
            chunk = payload[start : start + MAX_PES_PAYLOAD]
            out += pes_packet(chunk, pts if start == 0 else None)
    out += ISO11172_END
    return bytes(out)


def split_es_pictures(es: bytes) -> list[bytes]:
    """Split an ES into per-picture chunks (picture start 00 00 01 00),
    attaching preceding sequence/GOP headers to the following picture."""
    import re

    starts = [m.start() for m in re.finditer(b"\x00\x00\x01\x00", es)]
    if not starts:
        return [es]
    # pull back each start to include contiguous preceding seq/gop headers
    bounds = []
    prev_end = 0
    for s in starts:
        b = s
        for code in (b"\x00\x00\x01\xb8", b"\x00\x00\x01\xb3"):
            idx = es.rfind(code, prev_end, b)
            if idx != -1 and (b - idx) < 512:
                b = idx
        bounds.append(max(b, prev_end))
        prev_end = s + 4
    bounds.append(len(es))
    return [es[bounds[i] : bounds[i + 1]] for i in range(len(starts))]


def demux_program_stream(ps: bytes) -> bytes:
    """Extract the video ES from a program stream (verification path)."""
    out = bytearray()
    i = 0
    n = len(ps)
    while i + 4 <= n:
        if ps[i : i + 3] != b"\x00\x00\x01":
            i += 1
            continue
        code = ps[i + 3]
        if code == 0xBA:
            i += 12
        elif code == 0xBB:
            ln = (ps[i + 4] << 8) | ps[i + 5]
            i += 6 + ln
        elif code == 0xE0:
            ln = (ps[i + 4] << 8) | ps[i + 5]
            j = i + 6
            end = j + ln
            # skip stuffing then PTS/DTS flags (MPEG-1 PES)
            while j < end and ps[j] == 0xFF:
                j += 1
            if j < end and (ps[j] >> 6) == 0b01:  # STD buffer fields
                j += 2
            if j < end:
                flag = ps[j] >> 4
                if flag == 0x2:
                    j += 5
                elif flag == 0x3:
                    j += 10
                else:
                    j += 1
            out += ps[j:end]
            i = end
        elif code == 0xB9:  # program end
            break
        else:
            i += 1
    return bytes(out)
