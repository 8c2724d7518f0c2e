"""Correct-mode (ISO 11172-2) MPEG-1 intra encoder on PyTorch.

The device part of `ec504_imageencoder_tpu.models.mpeg1` on torch tensors:
colour conversion and 4:2:0 subsampling, then the slots, then kernel B2
(bit placement into big-endian slice buffers, 38 bits in) and the OR of
the slice headers.  The slots come from one of the two DCTs of the
reference (`dct_impl`):

* "aan", the integer AAN DCT: kernel B1 (DCT, quantize, zigzag, DC
  prediction, VLC emission, 4:1 fusion) reads the planes;
* "f32", the f32 matrix DCT of the high-quality path: blockize,
  `matmul_dct`, quantize, zigzag and DC prediction in PyTorch
  (`f32_levels`, the reference's `_generic_pipeline_from_planes`), then
  kernel B3 (VLC emission, 4:1 fusion).

With `debug_checks` (the port's counterpart of the reference's
EC504_DEBUG_CHECKS=1) raw (code, len) slots take the place of B1 and B3:
kernel B6a for "aan", or the plain emission with its table lookups
through kernel B5 for "f32"; the slot invariants are checked, the slots
fused in PyTorch (`bitpack.fuse4`) and packed by B2's checked form, and a
slice with violations reports their count negated in its bit count.

On the CPU the kernels' plain twins run instead.

The host part (slice sizing, regrow, header builders, `assemble`) is the
reference's own `MPEG1IntraEncoder`, which `TorchMPEG1IntraEncoder`
subclasses.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ec504_imageencoder_tpu_torch.device import resolve_device
from ec504_imageencoder_tpu_torch.ops.bitpack import fuse4, or_slice_headers
from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420
from ec504_imageencoder_tpu_torch.ops.cuda_lut import block_streams_lut
from ec504_imageencoder_tpu_torch.ops.cuda_pack import pack_fused4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts, blockize, to_i32_bits, vlc_fused4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_levels import vlc_levels4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_raw import vlc_raw
from ec504_imageencoder_tpu_torch.ops.dct import matmul_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize_intra
from ec504_imageencoder_tpu_torch.ops.vlc_device import dc_predictors, slot_violations
from ec504_imageencoder_tpu_torch.ops.zigzag import zigzag_scan
from ec504_imageencoder_tpu_torch.shared import MPEG1IntraEncoder, slice_bytes_bucket

SLICE_HEADER_BITS = 38  # slice start code (32) + quantizer_scale (5) + extra_bit (1)
DCT_IMPLS = ("aan", "f32")


def f32_levels(y, cb, cr, qw, zigzag):
    """The f32-DCT half of the reference's `_generic_pipeline_from_planes`:
    padded planes -> (levels (B * mbh, mbw * 6, 64) int32, zigzag order,
    slot 0 the absolute quantized DC; preds (B * mbh, mbw * 6) int32 DC
    predictors), the input of kernel B3."""
    blocks = blockize(y, cb, cr)                       # (B, mbh, mbw, 6, 8, 8)
    bsz, mbh, mbw = blocks.shape[:3]
    dc, lvl = quantize_intra(matmul_dct(blocks), qw)
    zz = zigzag_scan(lvl, zigzag)
    lane = torch.arange(64, device=y.device)
    zz = torch.where(lane == 0, dc[..., None], zz)
    r = bsz * mbh
    return zz.reshape(r, mbw * 6, 64), dc_predictors(dc).reshape(r, mbw * 6)


class EncodeCore(nn.Module):
    """Quantizer state and VLC tables as buffers; forward runs the device
    pipeline from padded 4:2:0 planes to slice segments with the DCT
    `dct_impl` ("aan" or "f32")."""

    def __init__(self, intra_q: np.ndarray, qscale: int, dct_impl: str):
        super().__init__()
        if dct_impl not in DCT_IMPLS:
            raise ValueError(f"dct_impl must be 'aan' or 'f32', got {dct_impl!r}")
        self.dct_impl = dct_impl
        self.qscale = int(qscale)
        iq = torch.as_tensor(np.asarray(intra_q), dtype=torch.int32)
        self.register_buffer("intra_q", iq)
        self.register_buffer("qw", iq * self.qscale)
        for name, t in Luts.default("cpu")._asdict().items():
            self.register_buffer(name, t)

    def luts(self) -> Luts:
        return Luts(self.zigzag, self.ac_code, self.ac_len, self.dc_code, self.dc_len)

    def forward(self, y, cb, cr, max_slice_bytes: int, debug_checks: bool = False):
        """y (B, H, W) u8, cb/cr (B, H/2, W/2) u8, H and W multiples of 16
        -> (seg (B, H/16, max_slice_bytes) u8, nbits (B, H/16) int32).

        nbits is each slice's true bit count, also when it exceeds
        8 * max_slice_bytes (the segment then holds its first bytes).
        debug_checks: the raw-slot routes with the invariant checks (see
        the module docstring); a slice with violations reports their count
        negated in nbits."""
        if max_slice_bytes % 4:
            raise ValueError(f"max_slice_bytes must be a multiple of 4, got {max_slice_bytes}")
        bsz, h, _ = y.shape
        mbh = h // 16
        mw = max_slice_bytes // 4
        if debug_checks:
            slots, viol = self._checked_slots(y, cb, cr)
            seg, nbits, pviol = pack_fused4(*slots, mw, bit_offset=SLICE_HEADER_BITS, checks=True)
            viol = viol + pviol
            nbits = torch.where(viol > 0, -viol, nbits)
        else:
            if self.dct_impl == "aan":
                slots = vlc_fused4(y, cb, cr, self.qw, self.luts())
            else:
                levels, preds = f32_levels(y, cb, cr, self.qw, self.zigzag)
                slots = vlc_levels4(levels, preds, self.luts())
            seg, nbits = pack_fused4(*slots, mw, bit_offset=SLICE_HEADER_BITS)
        seg = or_slice_headers(seg.view(bsz, mbh, max_slice_bytes), self.qscale)
        return seg, nbits.view(bsz, mbh)

    def _checked_slots(self, y, cb, cr):
        """The raw-slot routes: -> (fused slots (v0, v1, v2, v3, flens),
        (R,) int32 violations: slot invariants, and for "aan" the DCT
        guard).  The raw slots are fused in stream order, the counterpart
        of the reference's `fuse_slots_streamwise`."""
        if self.dct_impl == "aan":
            codes, lens, viol = vlc_raw(y, cb, cr, self.qw, self.luts())  # (R, 64, NB)
            viol = viol + slot_violations(codes, lens)
            codes, lens = codes.transpose(1, 2), lens.transpose(1, 2)
        else:
            levels, preds = f32_levels(y, cb, cr, self.qw, self.zigzag)  # (R, NB, 64)
            comp = torch.arange(levels.shape[1], device=y.device) % 6
            codes, lens = block_streams_lut(levels, preds, comp < 4, comp == 0)
            viol = slot_violations(codes, lens)
        r = codes.shape[0]
        fused = fuse4(codes.reshape(r, -1), lens.reshape(r, -1))
        return tuple(to_i32_bits(t) for t in fused), viol


def correct_pipeline_planes(core: EncodeCore, y, cb, cr, max_slice_bytes: int,
                            debug_checks: bool = False):
    """Padded 4:2:0 planes -> (seg, nbits); see EncodeCore.forward."""
    return core(y, cb, cr, max_slice_bytes, debug_checks)


def correct_pipeline(core: EncodeCore, rgb, max_slice_bytes: int,
                     color_range: str = "studio", debug_checks: bool = False):
    """(B, H, W, 3) u8 RGB, H and W multiples of 16 -> (seg, nbits)."""
    y, cb, cr = rgb_to_ycbcr(rgb, color_range)
    return core(y, subsample_420(cb), subsample_420(cr), max_slice_bytes, debug_checks)


class TorchMPEG1IntraEncoder(MPEG1IntraEncoder):
    """`MPEG1IntraEncoder` whose device pipeline runs on torch tensors on
    `device`: the CUDA kernels on a GPU, their plain twins on the CPU.

    encode(), encode_from_planes() and encode_to_file() are the reference's
    own.  dct_impl is the reference's: "auto" picks "f32" at quality >= 70
    and "aan" below.  With "aan" the byte stream equals the reference's for
    the same settings.  With "f32" it equals the reference's numpy backend
    (the port repeats its f32 operations) on every device and batch split;
    the reference's XLA backend may break an f32 tie the other way, and
    decodes to the same PSNR within 0.05 dB.

    debug_checks=True is the sanitizer (the reference's
    EC504_DEBUG_CHECKS=1): the device pipeline runs its raw-slot routes
    with the invariant checks (see the module docstring), the bytes stay
    the same, and a violation raises RuntimeError."""

    def __init__(self, quality: int = 50, frame_rate_code: int = 3,
                 gop_size: int = 15, max_slice_bytes: int | None = None,
                 dct_impl: str = "auto", color_range: str = "studio",
                 grow_slices: bool = True, debug_checks: bool = False, *, device):
        super().__init__(
            quality=quality, frame_rate_code=frame_rate_code, gop_size=gop_size,
            max_slice_bytes=max_slice_bytes, backend="torch", dct_impl=dct_impl,
            color_range=color_range, grow_slices=grow_slices,
        )
        if self.dct_impl not in DCT_IMPLS:
            raise ValueError(f"dct_impl must be 'auto', 'aan' or 'f32', got {dct_impl!r}")
        self.debug_checks = bool(debug_checks)
        self.device = resolve_device(device)
        self._set_quant(self.intra_q, self.qscale)

    def _set_quant(self, intra_q: np.ndarray, qscale: int) -> None:
        self.intra_q = np.array(intra_q, dtype=np.int32)
        self.qscale = int(qscale)
        self.core = EncodeCore(self.intra_q, self.qscale, self.dct_impl).to(self.device)

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
        return correct_pipeline(self.core, rgb, msb, self.color_range, self.debug_checks)

    def _planes_once(self, planes, msb: int):
        y, cb, cr = (torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                     for p in planes)
        return correct_pipeline_planes(self.core, y, cb, cr, msb, self.debug_checks)

    def _run_with_regrow(self, run_once, mbw: int):
        """The reference's regrow loop on torch outputs: fetch the bit
        counts, raise on a negated one (the violations that debug_checks
        found), regrow once if a slice overflowed (nbits is exact, so one
        regrow lands), then fetch only the used byte prefix."""
        msb = self.resolve_slice_bytes(mbw)
        for _attempt in range(3):
            seg_dev, bits_dev = run_once(msb)
            bits = bits_dev.cpu().numpy()
            if int(bits.min(initial=0)) < 0:
                viol = -bits[bits < 0]
                raise RuntimeError(
                    f"invariant violations in {viol.size} slice(s) "
                    f"({int(viol.sum())} total hits): VLC slot length/masking, "
                    "DCT magnitude or pack length/overlap invariant broken; see "
                    "ops.vlc_device.slot_violations and ops.cuda_pack"
                )
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
