"""Host-side scalar oracle encoder (compat mode).

The port's copy of the reference's `models/oracle.py`: the executable
specification of the compat-mode bitstream, a direct, slow, readable
encoder whose output is byte-exact against the reference C encoder
(`tests/golden/awesome_video.mpeg`).  It runs on the host, a block at a
time: the port's own `aan_dct`, `quantize`, `zigzag_scan` and
`equalize_coefficients` on CPU tensors, then `ops/rle_vlc.py`'s
`compat_block_codes` and a `BitWriter`.  The device path
(`models/encoder.py`) is held to it.

Frame structure per the C encoder's encoder.h:196-486; its quirks: the
hard 96x144 crop, full-resolution chroma read with half the stride,
sequence dimensions truncated to 8 bits, a GOP per frame with
hour = frame index, the PES length backpatch, and 4 garbage bytes in
place of a sequence end code.
"""

from __future__ import annotations

import numpy as np
import torch

from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr_exact
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize
from ec504_imageencoder_tpu_torch.ops.rle_vlc import compat_block_codes
from ec504_imageencoder_tpu_torch.ops.zigzag import equalize_coefficients, zigzag_scan
from ec504_imageencoder_tpu_torch.syntax import headers
from ec504_imageencoder_tpu_torch.syntax.bitwriter import BitWriter
from ec504_imageencoder_tpu_torch.utils.tables import scale_quantization_matrix

# the C encoder's crop: slice loop encoder.h:238 (columns), MB loop :248 (rows)
CROP_W = 96
CROP_H = 144
MUX_RATE = 2202035      # encoder.h:86
SYS_PACKET_NUM = 0xE6   # encoder.h:88
QUANT_SCALE = 1         # encoder.h:51


def compat_frame_slice_bytes(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray, quality: int, width: int
) -> bytes:
    """All slices of one frame (each byte-aligned), in the C encoder's
    block order.  y, cb, cr: (H, W) u8 full-resolution planes."""
    scaled_q = torch.from_numpy(scale_quantization_matrix(quality))
    w = BitWriter()
    cb_flat = cb.reshape(-1)
    cr_flat = cr.reshape(-1)
    half_stride = width // 2

    def emit(block: np.ndarray, is_luma: bool) -> None:
        levels = quantize(aan_dct(torch.from_numpy(np.ascontiguousarray(block))), scaled_q)
        zz = equalize_coefficients(zigzag_scan(levels)).numpy()
        for code, nbits in compat_block_codes(zz, is_luma):
            w.put(code, nbits)

    for vpos, x in enumerate(range(0, CROP_W, 16)):
        # slice header (mpeg1_blk.c:12-18)
        w.put(0x000001, 24)
        w.put(vpos + 1, 8)
        w.put(QUANT_SCALE & 0x1F, 5)
        w.put(0, 1)
        for yy in range(0, CROP_H, 16):
            # MB header: address increment always 1 + intra type (encoder.h:257)
            w.put(0b11, 2)
            for b in range(4):
                xs = x + (b % 2) * 8
                ys = yy + (b // 2) * 8
                emit(y[ys : ys + 8, xs : xs + 8], is_luma=True)
            # chroma read from the FULL-RES planes with half-width stride (Q3)
            rows = (yy // 2 + np.arange(8))[:, None] * half_stride
            cols = x // 2 + np.arange(8)[None, :]
            idx = (rows + cols).reshape(8, 8)
            emit(cb_flat[idx], is_luma=False)
            emit(cr_flat[idx], is_luma=False)
        w.align(0)  # encoder.h:442-443
    return w.tobytes()


def encode_compat(
    frames_rgb: list[np.ndarray], quality: int = 12
) -> tuple[bytes, list[bytes]]:
    """Encode RGB frames ((H, W, 3) u8 each) into the compat .mpeg stream.

    Returns (mpeg_bytes, per-frame .bit raw-plane dumps)."""
    out = bytearray()
    out += headers.pack_header(MUX_RATE)
    out += headers.system_header(MUX_RATE, SYS_PACKET_NUM)
    bit_dumps: list[bytes] = []
    for i, rgb in enumerate(frames_rgb):
        h, wdt = rgb.shape[0], rgb.shape[1]
        y, cb, cr = rgb_to_ycbcr_exact(rgb)
        slice_bytes = compat_frame_slice_bytes(y, cb, cr, quality, wdt)
        frame = bytearray()
        # timecode quirk: minute%60==0 at minute=0 bumps the hour every
        # frame and zeroes sec/min (encoder.h:475-484) -> hour == frame idx
        frame += headers.pes_packet_header(1 + 3600 * i)
        frame += headers.sequence_header(wdt & 0xFF, h & 0xFF)  # Q1 truncation
        frame += headers.gop_header(hour=i, minute=0, second=0)
        frame += headers.picture_header(temporal_ref=0)
        frame += slice_bytes
        headers.patch_pes_length(frame)
        frame += headers.COMPAT_SEQUENCE_END_GARBAGE
        out += frame
        bit_dumps.append(headers.raw_plane_dump(wdt, h, y.reshape(-1), cb.reshape(-1), cr.reshape(-1)))
    return bytes(out), bit_dumps
