"""Compat-mode encoder on PyTorch: the reference C encoder's bitstream, bug
for bug.

The port of the reference's `models/encoder.py::encode_compat` (the C
project's `mpeg_encode_procedure` minus file I/O), with its own copies of
the reference's crop and slice constants and `_validate_frames`: the RGB
frames to the device, the compat colour there (`compat_color`: the
reference's host f64 `rgb_to_ycbcr_exact`, operation for operation), kernel
B4b (crop blockize, AAN DCT, truncating quantization, zigzag, compat
emission, 4:1 fusion), kernel B2 (38 bits in, 12,288 B per slice: the
worst-case compat slice is 12,026 B, so a slice never overflows), the
slice headers (vpos 1..6, qscale 1), then the reference's two-step fetch,
the planes fetched for the `.bit` dumps, and system-stream assembly.  On
the CPU the kernels' plain twins run instead.

While a profiler records, a call runs as a sequence of spans on the
calling thread (`utils.profiling.stage_scope`): `encode.h2d` (the RGB
frames copied), `encode.color` (the colour launched), `encode.tables` (the
core's tables built and copied), `encode.enqueue`, `encode.fetch_bits`,
`encode.fetch_prefix` (as in `models/mpeg1.py`), `encode.fetch_planes`
(the planes copied back for the dumps) and `encode.assemble` (the system
stream and the `.bit` dumps).
"""

from __future__ import annotations

import numpy as np
import torch

from ec504_imageencoder_tpu_torch.device import resolve_device
from ec504_imageencoder_tpu_torch.models.mpeg1 import (
    SLICE_HEADER_BITS,
    LutCore,
    fetch_bits,
    fetch_prefix,
    pack_checked,
)
from ec504_imageencoder_tpu_torch.ops.bitpack import or_slice_headers
from ec504_imageencoder_tpu_torch.ops.cuda_pack import pack_fused4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_compat import (  # noqa: F401 (re-exported)
    CROP_H,
    CROP_W,
    N_MBS,
    N_SLICES,
    compat_color,
    vlc_compat_fused4,
    vlc_compat_slots,
)
from ec504_imageencoder_tpu_torch.syntax import headers
from ec504_imageencoder_tpu_torch.utils.profiling import stage_scope
from ec504_imageencoder_tpu_torch.utils.tables import scale_quantization_matrix

QUANT_SCALE = 1

# the worst-case compat slice, 38 header bits + 9 MBs * (2 + 6 blocks * (15
# DC + 63 * 28 AC + 2 EOB)) bits = 12,026 B, rounded up to a multiple of
# 512: a compat slice never overflows
MAX_SLICE_BYTES_COMPAT = 12288


def _validate_frames(frames: np.ndarray) -> None:
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) uint8 RGB frames, got {frames.shape}")
    if frames.shape[1] < CROP_H or frames.shape[2] < CROP_W:
        raise ValueError(
            f"compat mode encodes a {CROP_W}x{CROP_H} region; frames of "
            f"{frames.shape[2]}x{frames.shape[1]} are too small"
        )
    if frames.dtype != np.uint8:
        raise ValueError(f"expected uint8 frames, got {frames.dtype}")


class CompatCore(LutCore):
    """The scaled JPEG matrix and the compat VLC tables as buffers; forward
    runs the device pipeline from full-resolution planes to slice
    segments."""

    def __init__(self, quality: int):
        super().__init__(Luts.compat("cpu"))
        sq = scale_quantization_matrix(quality).astype(np.int32)
        self.register_buffer("scaled_q", torch.from_numpy(sq))

    def forward(self, y, cb, cr, debug_checks: bool = False):
        """y, cb, cr (B, H, W) u8 full-resolution planes ->
        (seg (B, 6, MAX_SLICE_BYTES_COMPAT) u8, nbits (B, 6) int32).

        debug_checks: the raw slots of B4a go through the slot invariant
        checks, are fused in PyTorch and packed by B2's checked form, as
        the reference's EC504_DEBUG_CHECKS=1 runs its raw-slot compat
        kernel and its guarded pack; a slice with violations (slot, fused
        length or overlap) reports their count negated in nbits."""
        bsz = y.shape[0]
        mw = MAX_SLICE_BYTES_COMPAT // 4
        if debug_checks:
            codes, lens = vlc_compat_slots(y, cb, cr, self.scaled_q, self.luts())
            seg, nbits = pack_checked(codes.transpose(1, 2), lens.transpose(1, 2), mw)
        else:
            slots = vlc_compat_fused4(y, cb, cr, self.scaled_q, self.luts())
            seg, nbits = pack_fused4(*slots, mw, bit_offset=SLICE_HEADER_BITS)
        seg = or_slice_headers(seg.view(bsz, N_SLICES, MAX_SLICE_BYTES_COMPAT), QUANT_SCALE)
        return seg, nbits.view(bsz, N_SLICES)


def encode_compat(frames_rgb, quality: int = 12, *, device="cuda",
                  debug_checks: bool = False,
                  batch_size: int | None = None) -> tuple[bytes, list[bytes]]:
    """Compat-mode encode on `device` (the CUDA kernels on "cuda", the
    default, their twins on "cpu"): (B, H, W, 3) u8 RGB frames, H >= 144
    and W >= 96 -> (mpeg bytes, per-frame .bit dumps), byte-exact against
    the reference C encoder.  debug_checks: see CompatCore.forward; a
    violation raises RuntimeError.  batch_size is accepted and ignored,
    as the reference's is: the frames go to the device in one batch."""
    frames = np.ascontiguousarray(frames_rgb)
    _validate_frames(frames)
    bsz, h, w = frames.shape[:3]
    dev = resolve_device(device)

    with stage_scope("encode.h2d"):
        rgb = torch.from_numpy(frames).to(dev)
    with stage_scope("encode.color"):
        planes = compat_color(rgb)  # the reference's C-double colour, on the device
    with stage_scope("encode.tables"):
        core = CompatCore(quality).to(dev)
    with stage_scope("encode.enqueue"):
        seg_dev, bits_dev = core(*planes, debug_checks=debug_checks)
    # two-step fetch: the bit counts first, then only the used byte prefix
    seg_bits = fetch_bits(bits_dev, "VLC slot invariant violations in {slices} compat "
                                    "slice(s) ({hits} in all)")
    seg_bytes = fetch_prefix(seg_dev, int(seg_bits.max(initial=0)), MAX_SLICE_BYTES_COMPAT)
    with stage_scope("encode.fetch_planes"):
        y, cb, cr = planes.cpu().numpy()  # the .bit dumps hold every pixel

    # the system stream of the reference (models/encoder.py::encode_compat)
    with stage_scope("encode.assemble"):
        out = bytearray()
        out += headers.pack_header(2202035)
        out += headers.system_header(2202035, 0xE6)
        dumps = []
        for i in range(bsz):
            frame = bytearray()
            frame += headers.pes_packet_header(1 + 3600 * i)
            frame += headers.sequence_header(w & 0xFF, h & 0xFF)
            frame += headers.gop_header(hour=i, minute=0, second=0)
            frame += headers.picture_header(temporal_ref=0)
            for s in range(N_SLICES):
                nb = (int(seg_bits[i, s]) + 7) // 8
                frame += bytes(seg_bytes[i, s, :nb])
            headers.patch_pes_length(frame)
            frame += headers.COMPAT_SEQUENCE_END_GARBAGE
            out += frame
            dumps.append(headers.raw_plane_dump(w, h, y[i].reshape(-1), cb[i].reshape(-1),
                                                cr[i].reshape(-1)))
        return bytes(out), dumps
