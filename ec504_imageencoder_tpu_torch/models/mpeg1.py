"""Correct-mode (ISO 11172-2) MPEG-1 intra encoder on PyTorch.

The device part of `ec504_imageencoder_tpu.models.mpeg1` on torch tensors:
colour conversion and 4:2:0 subsampling, then kernel B1 (DCT, quantize,
zigzag, DC prediction, VLC emission, 4:1 fusion), kernel B2 (bit
placement into big-endian slice buffers, 38 bits in) and the OR of the
slice headers.  On the CPU the kernels' plain twins run instead.

The host part (slice sizing, regrow, header builders, `assemble`) is the
reference's own `MPEG1IntraEncoder`, which `TorchMPEG1IntraEncoder`
subclasses.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ec504_imageencoder_tpu_torch.device import resolve_device
from ec504_imageencoder_tpu_torch.ops.bitpack import or_slice_headers
from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420
from ec504_imageencoder_tpu_torch.ops.cuda_pack import pack_fused4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts, vlc_fused4
from ec504_imageencoder_tpu_torch.shared import MPEG1IntraEncoder, slice_bytes_bucket

SLICE_HEADER_BITS = 38  # slice start code (32) + quantizer_scale (5) + extra_bit (1)


class EncodeCore(nn.Module):
    """Quantizer state and VLC tables as buffers; forward runs the device
    pipeline from padded 4:2:0 planes to slice segments."""

    def __init__(self, intra_q: np.ndarray, qscale: int):
        super().__init__()
        self.qscale = int(qscale)
        iq = torch.as_tensor(np.asarray(intra_q), dtype=torch.int32)
        self.register_buffer("intra_q", iq)
        self.register_buffer("qw", iq * self.qscale)
        for name, t in Luts.default("cpu")._asdict().items():
            self.register_buffer(name, t)

    def luts(self) -> Luts:
        return Luts(self.zigzag, self.ac_code, self.ac_len, self.dc_code, self.dc_len)

    def forward(self, y, cb, cr, max_slice_bytes: int):
        """y (B, H, W) u8, cb/cr (B, H/2, W/2) u8, H and W multiples of 16
        -> (seg (B, H/16, max_slice_bytes) u8, nbits (B, H/16) int32).

        nbits is each slice's true bit count, also when it exceeds
        8 * max_slice_bytes (the segment then holds its first bytes)."""
        if max_slice_bytes % 4:
            raise ValueError(f"max_slice_bytes must be a multiple of 4, got {max_slice_bytes}")
        bsz, h, _ = y.shape
        mbh = h // 16
        v0, v1, v2, v3, flens = vlc_fused4(y, cb, cr, self.qw, self.luts())
        seg, nbits = pack_fused4(
            v0, v1, v2, v3, flens, max_slice_bytes // 4, bit_offset=SLICE_HEADER_BITS
        )
        seg = or_slice_headers(seg.view(bsz, mbh, max_slice_bytes), self.qscale)
        return seg, nbits.view(bsz, mbh)


def correct_pipeline_planes(core: EncodeCore, y, cb, cr, max_slice_bytes: int):
    """Padded 4:2:0 planes -> (seg, nbits); see EncodeCore.forward."""
    return core(y, cb, cr, max_slice_bytes)


def correct_pipeline(core: EncodeCore, rgb, max_slice_bytes: int,
                     color_range: str = "studio"):
    """(B, H, W, 3) u8 RGB, H and W multiples of 16 -> (seg, nbits)."""
    y, cb, cr = rgb_to_ycbcr(rgb, color_range)
    return core(y, subsample_420(cb), subsample_420(cr), max_slice_bytes)


class TorchMPEG1IntraEncoder(MPEG1IntraEncoder):
    """`MPEG1IntraEncoder` whose device pipeline runs on torch tensors on
    `device`: the CUDA kernels on a GPU, their plain twins on the CPU.

    encode(), encode_from_planes() and encode_to_file() are the reference's
    own; the byte stream equals the reference's for the same settings.
    Only the integer AAN DCT is ported: dct_impl "f32" (what "auto" picks
    at quality >= 70) raises NotImplementedError."""

    def __init__(self, quality: int = 50, frame_rate_code: int = 3,
                 gop_size: int = 15, max_slice_bytes: int | None = None,
                 dct_impl: str = "auto", color_range: str = "studio",
                 grow_slices: bool = True, *, device):
        super().__init__(
            quality=quality, frame_rate_code=frame_rate_code, gop_size=gop_size,
            max_slice_bytes=max_slice_bytes, backend="torch", dct_impl=dct_impl,
            color_range=color_range, grow_slices=grow_slices,
        )
        if self.dct_impl == "f32":
            raise NotImplementedError(
                "the f32 matmul DCT (dct_impl='f32', chosen by 'auto' at "
                "quality >= 70) is not ported yet (ROADMAP A5); pass "
                "dct_impl='aan'"
            )
        if self.dct_impl != "aan":
            raise ValueError(f"dct_impl must be 'auto', 'aan' or 'f32', got {dct_impl!r}")
        self.device = resolve_device(device)
        self._set_quant(self.intra_q, self.qscale)

    def _set_quant(self, intra_q: np.ndarray, qscale: int) -> None:
        self.intra_q = np.array(intra_q, dtype=np.int32)
        self.qscale = int(qscale)
        self.core = EncodeCore(self.intra_q, self.qscale).to(self.device)

    @classmethod
    def from_reference(cls, enc: MPEG1IntraEncoder, device) -> "TorchMPEG1IntraEncoder":
        """A port encoder that computes what `enc` computes: its quality,
        quantizer, DCT, colour range, GOP, frame rate and slice sizing."""
        port = cls(
            quality=enc.quality, frame_rate_code=enc.frame_rate_code,
            gop_size=enc.gop_size, max_slice_bytes=enc.max_slice_bytes,
            dct_impl=enc.dct_impl, color_range=enc.color_range,
            grow_slices=enc.grow_slices, device=device,
        )
        port._set_quant(enc.intra_q, enc.qscale)
        return port

    def _pipeline_once(self, padded: np.ndarray, msb: int):
        rgb = torch.from_numpy(padded).to(self.device)
        return correct_pipeline(self.core, rgb, msb, self.color_range)

    def _planes_once(self, planes, msb: int):
        y, cb, cr = (torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                     for p in planes)
        return correct_pipeline_planes(self.core, y, cb, cr, msb)

    def _run_with_regrow(self, run_once, mbw: int):
        """The reference's regrow loop on torch outputs: fetch the bit
        counts, regrow once if a slice overflowed (nbits is exact, so one
        regrow lands), then fetch only the used byte prefix."""
        msb = self.resolve_slice_bytes(mbw)
        for _attempt in range(3):
            seg_dev, bits_dev = run_once(msb)
            bits = bits_dev.cpu().numpy()
            need_bits = int(bits.max(initial=0))
            if need_bits <= 8 * msb:
                break
            if not self.grow_slices:
                raise OverflowError(
                    f"slice needs {-(-need_bits // 8)} bytes > "
                    f"max_slice_bytes={msb} and grow_slices=False"
                )
            msb = slice_bytes_bucket(-(-need_bits // 8))
            self.max_slice_bytes = msb
        else:
            raise OverflowError(f"slice-buffer regrow did not converge at {msb} bytes")
        used = -(-need_bits // 8)
        bucket = min(max(256, 1 << max(used - 1, 1).bit_length()), msb)
        return seg_dev[:, :, :bucket].cpu().numpy(), bits

    def encode_from_coeffs(self, yc, cbc, crc, height: int, width: int,
                           first_frame_index: int = 0) -> bytes:
        raise NotImplementedError(
            "the JPEG coefficients intake is not ported yet (ROADMAP A6); "
            "use encode_from_planes"
        )
