"""Correct-mode (ISO 11172-2) MPEG-1 intra encoder on PyTorch.

The port of the reference's `models/mpeg1.py`.  The device part runs on
torch tensors: colour conversion and 4:2:0 subsampling, then the slots,
then the pack (bit placement into big-endian slice buffers, 38 bits in)
and the OR of the slice headers.  The slots come from one of the two DCTs
of the reference (`dct_impl`):

* "aan", the integer AAN DCT: kernel B1 (DCT, quantize, zigzag, DC
  prediction, VLC emission, 4:1 fusion) reads the planes, kernel B2
  packs; with `fuse=8` (the reference's EC504_FUSE=8) kernel B6b fuses
  8:1 instead and kernel B6c packs its 256-bit slots;
* "f32", the f32 matrix DCT of the high-quality path: the f32 levels
  kernel (blockize, `matmul_dct` in numpy's operation order, quantize,
  zigzag and DC prediction in one launch: `plane_levels`, the reference's
  `_generic_pipeline_from_planes`), then kernel B3 (VLC emission, 4:1
  fusion) and B2.

With a `pack` other than "fused4" (the reference's EC504_VLC=xla with
EC504_PACK) the reference's generic emission runs instead, with either
DCT: `plane_levels`, then 64 raw (code, len) slots per block through the
table lookups of kernel B5 (`raw_slots`), then the chosen raw-code pack
kernel at bit offset 38: K1 for "pallas1", K3 for "pallas3", K4 for
"fused", K2 for "fused2w".

With `debug_checks` (the port's counterpart of the reference's
EC504_DEBUG_CHECKS=1) raw (code, len) slots take the place of B1, B6b and
B3: kernel B6a for "aan", or `raw_slots` for "f32"; the slot invariants
are checked, the slots fused in PyTorch (`bitpack.fuse4`) and packed by
B2's checked form, and a slice with violations reports their count
negated in its bit count.  On the generic route (a `pack` value) the slot
invariants of the raw slots are checked after the pack, as the
reference's generic route does.

The coefficients intake (`encode_from_coeffs`) runs the JPEG decode's back
half on the device first (`ops/jpeg_device.py`, plain torch: the islow
IDCT, then the macroblock edge padding) and feeds the planes to the same
routes.  The JPEG intake (`encode_from_jpegs`, a widening beyond the JAX
package) takes the JPEG files or bytes themselves: the host's native
decoder (`io/jpeg.py::decode_batch`) decodes them to what the intake rule
(`io/jpeg.py::intake_kind`) picks, then `encode_from_planes`,
`encode_from_coeffs` or `encode` codes that.

On the CPU the kernels' plain twins run instead.

The host part is the port's own copy of the reference's: quality to
quantizer, slice-buffer sizing, macroblock padding, the header builders,
the regrow loop and `assemble`.

While a profiler records, each call of the encoder runs as a sequence of
spans on the calling thread (`utils.profiling.stage_scope`), one per stage:
`encode.jpeg_decode` (`encode_from_jpegs`' host decode of the JPEGs),
`encode.pad` (validation; the sharded encoder's host padding and slabs),
`encode.h2d` (the caller's unpadded arrays copied to the device),
`encode.edge_pad` (the planes or RGB frames edge-padded to whole
macroblocks on the device), `encode.intake` (the coefficients intake's
IDCT and device padding), `encode.enqueue` (the device pipeline's
launches; inside it `encode.rgb420` around the RGB route's colour
conversion and 4:2:0 subsampling, and `encode.levels` around
`plane_levels`), `encode.fetch_bits` (the bit counts, where the host
waits for the device), `encode.fetch_prefix`
(the used byte prefix), `encode.assemble` (`assemble`) and `encode.release`
(the fetched prefix's host buffer given back).  A re-run after an overflow
adds one `encode.enqueue` and one `encode.fetch_bits`.  The module
counter `rgb420_passes` counts the RGB route's colour-and-subsampling
passes since the last reset, on any device: one a call, and one more for
each re-run.  The `Counter` `prefix_fetches` counts the prefix fetches by
their host buffer: "pinned" (page-locked memory from PyTorch's caching
host allocator, reused from call to call: slice buffers on a CUDA device)
or "pageable" (`.cpu()`: CPU tensors and the sharded encoder's results).
The `Counter` `pad_sites` counts the calls whose frames or planes needed
macroblock padding by where it was done: "device" (`edge_pad`, after the
copy: every single-device entry) or "host" (`np.pad`, before it: the
sharded encoder, which cuts the padded rows into slabs on the host).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
from torch import nn

from ec504_imageencoder_tpu_torch.device import resolve_device
from ec504_imageencoder_tpu_torch.io import jpeg as jpeg_io
from ec504_imageencoder_tpu_torch.ops import jpeg_device
from ec504_imageencoder_tpu_torch.ops.bitpack import or_slice_headers
from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420
from ec504_imageencoder_tpu_torch.ops.cuda_lut import block_streams_lut
from ec504_imageencoder_tpu_torch.ops.cuda_pack import (
    pack_fused4,
    pack_fused8,
    pack_pairs,
    pack_raw,
)
from ec504_imageencoder_tpu_torch.ops.cuda_pack_split import pack_split, pack_windows
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import (
    Luts,
    fuse4_i32,
    levels_plain,
    vlc_fused4,
    vlc_fused8,
)
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_levels import f32_levels, vlc_levels4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_raw import vlc_raw
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.vlc_device import slot_violations
from ec504_imageencoder_tpu_torch.syntax import headers
from ec504_imageencoder_tpu_torch.syntax.bitwriter import BitWriter
from ec504_imageencoder_tpu_torch.utils.profiling import stage_scope
from ec504_imageencoder_tpu_torch.utils.tables import ZIGZAG_GATHER, scale_quantization_matrix

SLICE_HEADER_BITS = 38  # slice start code (32) + quantizer_scale (5) + extra_bit (1)
DCT_IMPLS = ("aan", "f32")
FUSES = (4, 8)
# the reference's EC504_PACK values: "fused4", its production pack, and the
# raw-code pack kernels of its generic route
RAW_PACKS = {"pallas1": pack_raw, "pallas3": pack_windows, "fused": pack_split,
             "fused2w": pack_pairs}
PACKS = ("fused4", *RAW_PACKS)

# ---- host half: the reference's own rules ---------------------------------

FRAME_RATE_CODES = {
    23.976: 1, 24.0: 2, 25.0: 3, 29.97: 4, 30.0: 5, 50.0: 6, 59.94: 7, 60.0: 8,
}
FRAME_RATE_VALUES = {v: k for k, v in FRAME_RATE_CODES.items()}

# 12-bit sequence-header fields bound the width at 4095; the slice start
# codes 0x01..0xAF bound the height at 175 macroblock rows.
MAX_WIDTH = 4095
MAX_HEIGHT = 175 * 16  # 2800

# colour-and-subsampling passes of `correct_pipeline` since the last reset
rgb420_passes = 0
# `fetch_prefix` calls by host buffer, "pinned" or "pageable", since the last clear()
prefix_fetches: Counter[str] = Counter()
# calls whose inputs were padded to whole macroblocks, by "device" or "host", since the last clear()
pad_sites: Counter[str] = Counter()


def quality_to_quant(quality: int) -> tuple[np.ndarray, int]:
    """JPEG-style quality 1..100 -> (intra matrix int32, quant_scale): the
    JPEG scaled matrix becomes the intra matrix with quant_scale absorbing
    the factor above the 8-bit entry range (both capped by the format, so
    quality <= 4 saturates at steps of ~988)."""
    m = scale_quantization_matrix(quality).astype(np.int64)
    s = max(1, int(np.ceil(m.max() / 255.0)))
    qscale = int(np.clip(8 * s, 1, 31))
    w = np.clip(np.round(8.0 * m / qscale), 1, 255).astype(np.int32)
    return w, qscale


def slice_bytes_bucket(nbytes: int) -> int:
    """A slice-buffer size rounded up to a multiple of 512, at least 2560."""
    return max(2560, -(-nbytes // 512) * 512)


def worst_case_slice_bytes(mbw: int) -> int:
    """Upper bound on one slice's bytes: per block a DC size code and bits
    (<= 16), 63 AC escapes of 28 bits and a 2-bit EOB; per MB a 2-bit
    header; per slice 38 header bits."""
    per_block = 8 + 8 + 63 * 28 + 2
    bits = 38 + mbw * (2 + 6 * per_block)
    return slice_bytes_bucket(-(-bits // 8))


def initial_slice_bytes(quality: int, mbw: int) -> int:
    """Default slice-buffer size for (quality, frame width): sized from
    content with headroom, not the worst case; a slice that overflows
    regrows the buffer once, exactly."""
    if quality <= 60:
        per_block = 256
    elif quality <= 85:
        per_block = 384
    else:
        per_block = 512
    bits = 38 + mbw * 6 * per_block
    return min(slice_bytes_bucket(-(-bits // 8)), worst_case_slice_bytes(mbw))


def pad_to_macroblocks(frames: np.ndarray) -> np.ndarray:
    """Edge-replicate (B, H, W, 3) frames to multiples of 16."""
    h, w = frames.shape[1:3]
    ph, pw = -h % 16, -w % 16
    if ph or pw:
        frames = np.pad(frames, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    return frames


def pad_planes_to_macroblocks(y, cb, cr):
    """Edge-replicate 4:2:0 planes so Y is a multiple of 16 (chroma 8)."""
    h, w = y.shape[1:3]
    ph, pw = -h % 16, -w % 16
    if ph or pw:
        y = np.pad(y, ((0, 0), (0, ph), (0, pw)), mode="edge")
    th, tw = y.shape[1] // 2, y.shape[2] // 2
    ch, cw = cb.shape[1:3]
    if (ch, cw) != (th, tw):
        pad = ((0, 0), (0, th - ch), (0, tw - cw))
        cb = np.pad(cb, pad, mode="edge")
        cr = np.pad(cr, pad, mode="edge")
    return y, cb, cr


def sequence_header_es(width: int, height: int, frame_rate_code: int = 3,
                       aspect_code: int = 1, vbv_size: int = 20,
                       intra_matrix: np.ndarray | None = None) -> bytes:
    """ISO 11172-2 §2.4.2.3 sequence header, with an optional intra
    quantizer matrix (sent in zigzag order)."""
    w = BitWriter()
    w.put_bytes(headers.SEQUENCE_START)
    w.put(width, 12)
    w.put(height, 12)
    w.put(aspect_code, 4)
    w.put(frame_rate_code, 4)
    w.put(0x3FFFF, 18)  # variable bitrate
    w.put(1, 1)         # marker
    w.put(vbv_size, 10)
    w.put(0, 1)         # constrained_parameters_flag
    if intra_matrix is not None:
        w.put(1, 1)     # load_intra_quantizer_matrix
        for v in intra_matrix.reshape(64)[ZIGZAG_GATHER].tolist():
            w.put(int(v), 8)
    else:
        w.put(0, 1)
    w.put(0, 1)         # load_non_intra_quantizer_matrix
    w.align(0)
    return w.tobytes()


def gop_header_es(frame_index: int, fps: float, closed: bool = True) -> bytes:
    """GOP header with an SMPTE-style timecode for the frame index."""
    fps_i = max(1, int(round(fps)))
    total_s, pic = divmod(frame_index, fps_i)
    total_m, sec = divmod(total_s, 60)
    hour, minute = divmod(total_m, 60)
    return headers.gop_header(
        hour=hour, minute=minute, second=sec, num_pic=pic,
        drop_frame=0, closed=1 if closed else 0, broken=0,
    )


# ---- device half ----------------------------------------------------------


def plane_levels(y, cb, cr, qw, zigzag, dct_impl: str = "f32"):
    """The DCT half of the reference's `_generic_pipeline_from_planes`, with
    the DCT `dct_impl` ("f32": `matmul_dct`, "aan": `aan_dct`): padded
    planes -> (levels (B * mbh, mbw * 6, 64) int32, zigzag order, slot 0
    the absolute quantized DC; preds (B * mbh, mbw * 6) int32 DC
    predictors), the input of kernel B3 and of `raw_slots`.  With "f32"
    on CUDA tensors the f32 levels kernel (`cuda_vlc_levels.f32_levels`)
    computes them in one launch; on CPU tensors, and with "aan", the plain
    PyTorch ops (`cuda_vlc.levels_plain`).  Traced as the span
    `encode.levels`."""
    with stage_scope("encode.levels"):
        if dct_impl == "aan":
            return levels_plain(y, cb, cr, qw, zigzag, aan_dct)
        return f32_levels(y, cb, cr, qw, zigzag)


def _check_pack(pack) -> None:
    if pack not in PACKS:
        raise ValueError(f"pack must be one of {', '.join(map(repr, PACKS))}, got {pack!r}")


def negate_violations(nbits, viol):
    """nbits with each slice's violation count negated where it has any:
    how the sanitizer reports a slice to the host."""
    return torch.where(viol > 0, -viol, nbits)


def pack_checked(codes, lens, max_words: int, viol=None):
    """The sanitizer's pack: raw (codes, lens) (R, ...) in stream order
    (u32 codes) and an optional (R,) count of violations found before ->
    (seg (R, 4 * max_words) u8, nbits (R,) int32).  The slot invariants are
    checked (`slot_violations`), the slots fused 4:1 in PyTorch (the
    counterpart of the reference's `fuse_slots_streamwise`) and packed by
    B2's checked form at bit offset 38; a slice's violations (earlier,
    slot, fused length and overlap) are negated in nbits."""
    found = slot_violations(codes, lens)
    if viol is not None:
        found = viol + found
    seg, nbits, pviol = pack_fused4(*fuse4_i32(codes, lens), max_words,
                                    bit_offset=SLICE_HEADER_BITS, checks=True)
    return seg, negate_violations(nbits, found + pviol)


class LutCore(nn.Module):
    """A module whose VLC tables are buffers named after the `Luts` fields;
    `luts()` reads them back on the module's device."""

    def __init__(self, luts: Luts):
        super().__init__()
        for name, t in luts._asdict().items():
            self.register_buffer(name, t)

    def luts(self) -> Luts:
        return Luts(*(getattr(self, name) for name in Luts._fields))


class EncodeCore(LutCore):
    """Quantizer state and VLC tables as buffers; forward runs the device
    pipeline from padded 4:2:0 planes to slice segments with the DCT
    `dct_impl` ("aan" or "f32"), on the AAN production route `fuse` (4: B1
    and B2; 8: B6b and B6c), and with a `pack` other than "fused4" the
    generic route with that raw-code pack kernel (see the module
    docstring)."""

    def __init__(self, intra_q: np.ndarray, qscale: int, dct_impl: str, fuse: int = 4,
                 pack: str = "fused4"):
        super().__init__(Luts.default("cpu"))
        if dct_impl not in DCT_IMPLS:
            raise ValueError(f"dct_impl must be 'aan' or 'f32', got {dct_impl!r}")
        if fuse not in FUSES:
            raise ValueError(f"fuse must be 4 or 8, got {fuse!r}")
        _check_pack(pack)
        self.dct_impl = dct_impl
        self.fuse = fuse
        self.pack = pack
        self.qscale = int(qscale)
        iq = torch.as_tensor(np.asarray(intra_q), dtype=torch.int32)
        self.register_buffer("intra_q", iq)
        self.register_buffer("qw", iq * self.qscale)

    def forward(self, y, cb, cr, max_slice_bytes: int, debug_checks: bool = False,
                first_row: int = 0):
        """y (B, H, W) u8, cb/cr (B, H/2, W/2) u8, H and W multiples of 16
        -> (seg (B, H/16, max_slice_bytes) u8, nbits (B, H/16) int32).
        first_row: the picture's MB row of the planes' first (a row
        shard's offset); it numbers the slice headers.

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
        if self.pack in RAW_PACKS:
            codes, lens = self.raw_slots(y, cb, cr)
            seg, nbits = RAW_PACKS[self.pack](codes, lens, mw, bit_offset=SLICE_HEADER_BITS)
            if debug_checks:
                nbits = negate_violations(nbits, slot_violations(codes, lens))
        elif debug_checks and self.dct_impl == "aan":
            codes, lens, viol = vlc_raw(y, cb, cr, self.qw, self.luts())  # (R, 64, NB)
            seg, nbits = pack_checked(codes.transpose(1, 2), lens.transpose(1, 2), mw, viol)
        elif debug_checks:
            seg, nbits = pack_checked(*self.raw_slots(y, cb, cr), mw)
        elif self.dct_impl == "aan" and self.fuse == 8:
            words, flens = vlc_fused8(y, cb, cr, self.qw, self.luts())
            seg, nbits = pack_fused8(words, flens, mw, bit_offset=SLICE_HEADER_BITS)
        else:
            if self.dct_impl == "aan":
                slots = vlc_fused4(y, cb, cr, self.qw, self.luts())
            else:
                levels, preds = plane_levels(y, cb, cr, self.qw, self.zigzag)
                slots = vlc_levels4(levels, preds, self.luts())
            seg, nbits = pack_fused4(*slots, mw, bit_offset=SLICE_HEADER_BITS)
        seg = or_slice_headers(seg.view(bsz, mbh, max_slice_bytes), self.qscale, first_row)
        return seg, nbits.view(bsz, mbh)

    def raw_slots(self, y, cb, cr):
        """The reference's generic emission (`_emit_and_pack_generic`):
        `plane_levels` with this core's DCT, then 64 slots per block, MB
        header and EOB folded in, through kernel B5's lookups -> (codes,
        lens) int32 (R, NB * 64) in stream order."""
        levels, preds = plane_levels(y, cb, cr, self.qw, self.zigzag, self.dct_impl)
        comp = torch.arange(levels.shape[1], device=y.device) % 6
        codes, lens = block_streams_lut(levels, preds, comp < 4, comp == 0)
        r = codes.shape[0]
        return codes.reshape(r, -1).to(torch.int32), lens.reshape(r, -1).to(torch.int32)


def correct_pipeline_planes(core: EncodeCore, y, cb, cr, max_slice_bytes: int,
                            debug_checks: bool = False, first_row: int = 0):
    """Padded 4:2:0 planes -> (seg, nbits); see EncodeCore.forward."""
    return core(y, cb, cr, max_slice_bytes, debug_checks, first_row)


def edge_pad(x: torch.Tensor, h: int, w: int, dims: tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """x with the adjacent axes `dims` (h0, w0) grown to (h, w), h >= h0
    and w >= w0: the last row and column repeated, as `np.pad(mode="edge")`,
    on the tensor's device (any dtype).  x is copied once into a new tensor
    and only the margins are filled (from x's last row, then from the new
    tensor's last column: the corner too); where neither axis grows, x
    itself is returned."""
    d0, d1 = (d % x.ndim for d in dims)
    h0, w0 = x.shape[d0], x.shape[d1]
    if (h0, w0) == (h, w):
        return x
    shape = list(x.shape)
    shape[d0], shape[d1] = h, w
    out = x.new_empty(shape)
    out.narrow(d0, 0, h0).narrow(d1, 0, w0).copy_(x)
    rows = out.narrow(d0, h0, h - h0).narrow(d1, 0, w0)
    rows.copy_(x.narrow(d0, h0 - 1, 1).expand(rows.shape))
    cols = out.narrow(d1, w0, w - w0)
    cols.copy_(out.narrow(d1, w0 - 1, 1).expand(cols.shape))
    return out


def edge_pad_planes(y, cb, cr):
    """4:2:0 planes (..., H, W) and (..., ceil(H/2), ceil(W/2)) edge-padded
    on their device by the rule of `pad_planes_to_macroblocks`: Y to
    multiples of 16, chroma to half of that."""
    h, w = y.shape[-2:]
    th, tw = h + -h % 16, w + -w % 16
    return edge_pad(y, th, tw), edge_pad(cb, th // 2, tw // 2), edge_pad(cr, th // 2, tw // 2)


def edge_pad_frames(rgb):
    """(B, H, W, 3) frames edge-padded on their device to multiples of 16,
    as `pad_to_macroblocks` pads them on the host."""
    h, w = rgb.shape[1:3]
    return edge_pad(rgb, h + -h % 16, w + -w % 16, dims=(1, 2))


def coeffs_to_planes(yc, cbc, crc, height: int, width: int):
    """The front of the reference's `_jitted_coeffs_pipeline`: (B, blocks,
    64) int32 dequantized JPEG coefficients -> the islow IDCT's 4:2:0
    planes, cropped to height x width, then edge-padded on their device
    (`edge_pad_planes`)."""
    return edge_pad_planes(*jpeg_device.decode_planes_from_coeffs(yc, cbc, crc, height, width))


def correct_pipeline(core: EncodeCore, rgb, max_slice_bytes: int,
                     color_range: str = "studio", debug_checks: bool = False,
                     first_row: int = 0):
    """(B, H, W, 3) u8 RGB, H and W multiples of 16 -> (seg, nbits): the
    colour conversion and 4:2:0 subsampling, run as the span
    `encode.rgb420` and counted in `rgb420_passes`, then
    `correct_pipeline_planes`."""
    global rgb420_passes
    with stage_scope("encode.rgb420"):
        y, cb, cr = rgb_to_ycbcr(rgb, color_range)
        cb, cr = subsample_420(cb), subsample_420(cr)
    rgb420_passes += 1
    return correct_pipeline_planes(core, y, cb, cr, max_slice_bytes, debug_checks, first_row)


# the raise of `_run_with_regrow` on a negated bit count (see `fetch_bits`)
VIOLATIONS = ("invariant violations in {slices} slice(s) ({hits} total hits): VLC slot "
              "length/masking, DCT magnitude or pack length/overlap invariant broken; see "
              "ops.vlc_device.slot_violations and ops.cuda_pack")


def fetch_bits(bits_dev, message: str) -> np.ndarray:
    """The `encode.fetch_bits` stage of an encode call: the slices' bit
    counts to the host, where it waits for the device.  A negated count
    (the violations that debug_checks found) raises RuntimeError with
    `message`, formatted with `slices` (how many) and `hits` (their
    violations in all)."""
    with stage_scope("encode.fetch_bits"):
        bits = bits_dev.cpu().numpy()
    if int(bits.min(initial=0)) < 0:
        viol = -bits[bits < 0]
        raise RuntimeError(message.format(slices=viol.size, hits=int(viol.sum())))
    return bits


def prefix_bytes(used: int, cap: int) -> int:
    """How many bytes of each slice to fetch when the longest uses `used`:
    the power of two at or above it, at least 256, at most `cap` (a few
    sizes a run, so the host's buffers are reused)."""
    return min(max(256, 1 << (used - 1).bit_length()), cap)


def fetch_prefix(seg_dev, need_bits: int, cap: int) -> np.ndarray:
    """The `encode.fetch_prefix` stage: the (B, S, cap) slice buffers'
    first `prefix_bytes` bytes, enough for `need_bits`, to the host.

    From a CUDA tensor the bytes go into page-locked memory from PyTorch's
    caching host allocator, one copy on the current stream and a wait for
    it: no page faults while CUDA stages the copy, and no unmapping
    when the caller drops the array, whose block then serves the next
    fetch of the same bucket.  Every fetch overwrites its block whole.
    Other slice buffers (CPU tensors, the sharded encoder's `ShardedTensor`)
    come back through `.cpu()`.  Counted in `prefix_fetches`."""
    with stage_scope("encode.fetch_prefix"):
        prefix = seg_dev[:, :, :prefix_bytes(-(-need_bits // 8), cap)]
        if isinstance(prefix, torch.Tensor) and prefix.is_cuda:
            prefix_fetches["pinned"] += 1
            host = torch.empty(prefix.shape, dtype=prefix.dtype, pin_memory=True)
            host.copy_(prefix, non_blocking=True)
            torch.cuda.current_stream(prefix.device).synchronize()
            return host.numpy()
        prefix_fetches["pageable"] += 1
        return prefix.cpu().numpy()


def encode_decoded(enc, kind: str, arrays: tuple, geom: dict,
                   first_frame_index: int = 0) -> bytes:
    """A batch that `io/jpeg.py::decode_batch` decoded to `kind`, coded by
    the entry of `enc` (a `TorchMPEG1IntraEncoder` or the sharded encoder)
    that takes it: "planes" `encode_from_planes`, "coeffs"
    `encode_from_coeffs` (geom gives the frame size), "rgb" `encode`."""
    if kind == "planes":
        return enc.encode_from_planes(*arrays, first_frame_index=first_frame_index)
    if kind == "coeffs":
        return enc.encode_from_coeffs(*arrays, geom["height"], geom["width"],
                                      first_frame_index=first_frame_index)
    return enc.encode(*arrays, first_frame_index=first_frame_index)


class TorchMPEG1IntraEncoder:
    """ISO-compliant all-I-frame MPEG-1 video encoder whose device pipeline
    runs on torch tensors on `device`: the CUDA kernels on a GPU (the
    default, "cuda", which raises RuntimeError where CUDA is absent), their
    plain twins on the CPU (device="cpu").  The public API, keywords and
    errors are the reference `MPEG1IntraEncoder`'s, with `device` in place
    of `backend`.  Everything after max_slice_bytes is keyword-only: the
    reference's fifth positional argument is `backend`, which the port does
    not take, so a positional call meant for the reference raises
    TypeError.

    dct_impl is the reference's: "auto" picks "f32" at quality >= 70 and
    "aan" below.  With "aan" the byte stream equals the reference's for
    the same settings.  With "f32" it equals the reference's numpy backend
    (the port repeats its f32 operations) on every device and batch split;
    the reference's XLA backend may break an f32 tie the other way, and
    decodes to the same PSNR within 0.05 dB.

    fuse (4 or 8) is the reference's EC504_FUSE, under its rule: 8 runs
    the 8:1-fusion kernels (B6b, then B6c) on the AAN production route
    only.  Under debug_checks=True the sanitizer's routes run unchanged,
    and with dct_impl="f32" or a pack other than "fused4" it has no effect
    (the reference reads EC504_FUSE only on its AAN kernel route).  The
    bytes are the same either way.

    pack is the reference's EC504_PACK with EC504_VLC=xla: "fused4" (the
    default) keeps the routes above; "pallas1", "pallas3", "fused" and
    "fused2w" run the generic route (see the module docstring) with its
    raw-code pack kernel K1, K3, K4 or K2, for either DCT.  The bytes are
    the same for every value.

    debug_checks=True is the sanitizer (the reference's
    EC504_DEBUG_CHECKS=1): the device pipeline runs its raw-slot routes
    with the invariant checks (see the module docstring), the bytes stay
    the same, and a violation raises RuntimeError."""

    def __init__(self, quality: int = 50, frame_rate_code: int = 3,
                 gop_size: int = 15, max_slice_bytes: int | None = None, *,
                 dct_impl: str = "auto", color_range: str = "studio",
                 grow_slices: bool = True, debug_checks: bool = False,
                 fuse: int = 4, pack: str = "fused4", device="cuda"):
        if color_range not in ("studio", "full"):
            raise ValueError(f"color_range must be 'studio' or 'full', got {color_range!r}")
        if dct_impl == "auto":
            dct_impl = "f32" if quality >= 70 else "aan"
        if dct_impl not in DCT_IMPLS:
            raise ValueError(f"dct_impl must be 'auto', 'aan' or 'f32', got {dct_impl!r}")
        if fuse not in FUSES:
            raise ValueError(f"fuse must be 4 or 8, got {fuse!r}")
        _check_pack(pack)
        self.quality = quality
        self.dct_impl = dct_impl
        self.color_range = color_range
        self.frame_rate_code = frame_rate_code
        self.fps = FRAME_RATE_VALUES[frame_rate_code]
        self.gop_size = gop_size
        # None: sized from (quality, frame width) at the first encode.  An
        # explicit size is a starting size: an overflowing slice regrows it
        # and re-encodes, unless grow_slices=False (OverflowError).
        self.max_slice_bytes = max_slice_bytes
        self.grow_slices = grow_slices
        self.debug_checks = bool(debug_checks)
        self.fuse = fuse
        self.pack = pack
        self.metrics = None  # optional sink with a histogram(name, values) method
        self.device = resolve_device(device)
        self._set_quant(*quality_to_quant(quality))

    def _set_quant(self, intra_q: np.ndarray, qscale: int) -> None:
        self.intra_q = np.array(intra_q, dtype=np.int32)
        self.qscale = int(qscale)
        self.core = EncodeCore(self.intra_q, self.qscale, self.dct_impl, self.fuse,
                               self.pack).to(self.device)

    @classmethod
    def from_reference(cls, enc, device="cuda", **kw) -> "TorchMPEG1IntraEncoder":
        """A port encoder that computes what the reference encoder `enc`
        computes: its quality, quantizer, DCT, colour range, GOP, frame
        rate and slice sizing, read from its attributes.  kw: the port's
        own keywords (debug_checks, fuse, pack)."""
        port = cls(
            quality=enc.quality, frame_rate_code=enc.frame_rate_code,
            gop_size=enc.gop_size, max_slice_bytes=enc.max_slice_bytes,
            dct_impl=enc.dct_impl, color_range=enc.color_range,
            grow_slices=enc.grow_slices, device=device, **kw,
        )
        port._set_quant(enc.intra_q, enc.qscale)
        return port

    def resolve_slice_bytes(self, mbw: int) -> int:
        """Current slice-buffer size, auto-sized on first use."""
        if self.max_slice_bytes is None:
            self.max_slice_bytes = initial_slice_bytes(self.quality, mbw)
        return self.max_slice_bytes

    def _to_device(self, arrays, kind: str):
        """The caller's unpadded host arrays, `kind` "rgb" ((B, H, W, 3)
        frames) or "planes" (Y, Cb, Cr) -> the device inputs of
        `_enqueue_rgb` and `_enqueue_planes`: each array copied to the
        device as it is (`encode.h2d`), then edge-padded there to whole
        macroblocks (`encode.edge_pad`: `edge_pad_frames` or
        `edge_pad_planes`; counted in `pad_sites["device"]` where it pads),
        once a call: a regrow re-runs on the same padded tensors."""
        with stage_scope("encode.h2d"):
            inputs = tuple(torch.from_numpy(a).to(self.device) for a in arrays)
        with stage_scope("encode.edge_pad"):
            padded = (edge_pad_frames(*inputs),) if kind == "rgb" else edge_pad_planes(*inputs)
        if padded[0] is not inputs[0]:
            pad_sites["device"] += 1
        return padded

    def _enqueue_rgb(self, inputs, msb: int):
        (rgb,) = inputs
        with stage_scope("encode.enqueue"):
            return correct_pipeline(self.core, rgb, msb, self.color_range, self.debug_checks)

    def _enqueue_planes(self, inputs, msb: int):
        with stage_scope("encode.enqueue"):
            return correct_pipeline_planes(self.core, *inputs, msb, self.debug_checks)

    def _run_with_regrow(self, run_once, mbw: int):
        """Run (`run_once` enqueues the device pipeline), fetch the bit
        counts, raise on a negated one (the violations that debug_checks
        found), regrow once if a slice overflowed (nbits is exact, so one
        regrow lands), then fetch only the used byte prefix, bucketed."""
        msb = self.resolve_slice_bytes(mbw)
        for _attempt in range(3):
            seg_dev, bits_dev = run_once(msb)
            bits = fetch_bits(bits_dev, VIOLATIONS)
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
        return fetch_prefix(seg_dev, need_bits, msb), bits

    def _run_and_assemble(self, run_once, mbw: int, disp_w: int, disp_h: int,
                          first_frame_index: int) -> bytes:
        """`_run_with_regrow`, then `assemble` of what it fetched.  The
        fetched prefix's host buffer is given back in a span of its own:
        a pageable one is unmapped, which takes milliseconds at tens of MB;
        a pinned one returns to the caching host allocator."""
        seg, bits = self._run_with_regrow(run_once, mbw)
        self._record(bits, mbw)
        with stage_scope("encode.assemble"):
            stream = self.assemble(seg, bits, disp_w, disp_h, first_frame_index)
        with stage_scope("encode.release"):
            del seg
        return stream

    def _record(self, bits, mbw: int) -> None:
        if self.metrics is not None:
            self.metrics.histogram("slice_bits", bits)
            # a slice is one MB row, so bits/MB is the row total split evenly
            self.metrics.histogram("bits_per_macroblock", bits / mbw)

    def encode(self, frames_rgb: np.ndarray, first_frame_index: int = 0) -> bytes:
        """Encode (B, H, W, 3) uint8 frames into an MPEG-1 video ES.

        The frames are copied to the device unpadded and edge-padded to
        whole macroblocks there, before the colour conversion (see
        `_to_device`); the host only validates them.  first_frame_index
        keeps GOP boundaries and timecodes consistent across chunked
        encodes; callers append `headers.sequence_end()`."""
        with stage_scope("encode.pad"):
            frames = np.ascontiguousarray(frames_rgb)
            if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
                raise ValueError(f"expected (B,H,W,3) uint8, got {frames.shape} {frames.dtype}")
            disp_h, disp_w = frames.shape[1:3]
            if disp_w > MAX_WIDTH or disp_h > MAX_HEIGHT:
                raise ValueError(
                    f"frame {disp_w}x{disp_h} exceeds MPEG-1 limits "
                    f"({MAX_WIDTH}x{MAX_HEIGHT}: 12-bit sequence-header "
                    "dimensions, slice start codes 0x01..0xAF)"
                )
        inputs = self._to_device((frames,), "rgb")
        return self._run_and_assemble(lambda msb: self._enqueue_rgb(inputs, msb),
                                      -(-disp_w // 16), disp_w, disp_h, first_frame_index)

    def assemble(self, seg, bits, disp_w: int, disp_h: int,
                 first_frame_index: int = 0) -> bytes:
        """Sequence, GOP and picture headers plus the used byte prefix of
        every slice of the fetched (seg (B, S, msb) u8, bits (B, S)).

        seg may instead be the nested row list of
        `ops.bitpack.split_compact_slices` (each slice already trimmed to
        its bytes), as the reference's `assemble` takes it."""
        compacted = isinstance(seg, list)
        out = bytearray()
        for i in range(len(seg) if compacted else seg.shape[0]):
            gi = first_frame_index + i
            if gi % self.gop_size == 0:
                out += sequence_header_es(disp_w, disp_h, self.frame_rate_code,
                                          intra_matrix=self.intra_q)
                out += gop_header_es(gi, self.fps)
            out += headers.picture_header(temporal_ref=gi % self.gop_size)
            if compacted:
                for row in seg[i]:
                    out += bytes(row)
            else:
                for s in range(seg.shape[1]):
                    nb = (int(bits[i, s]) + 7) // 8
                    out += bytes(seg[i, s, :nb])
        return bytes(out)

    def encode_from_planes(self, y, cb, cr, first_frame_index: int = 0) -> bytes:
        """Encode 4:2:0 YCbCr planes directly: y (B, H, W) u8, cb/cr
        (B, ceil(H/2), ceil(W/2)) u8 -> MPEG-1 video ES bytes.  The planes
        are copied to the device as they are (contiguous arrays are not
        copied on the host) and edge-padded to whole macroblocks there
        (see `_to_device`)."""
        with stage_scope("encode.pad"):
            y = np.ascontiguousarray(y)
            cb = np.ascontiguousarray(cb)
            cr = np.ascontiguousarray(cr)
            if y.ndim != 3 or y.dtype != np.uint8:
                raise ValueError(f"expected (B,H,W) uint8 Y, got {y.shape} {y.dtype}")
            disp_h, disp_w = y.shape[1:3]
            exp = (y.shape[0], -(-disp_h // 2), -(-disp_w // 2))
            if cb.shape != exp or cr.shape != exp:
                raise ValueError(f"chroma planes must be {exp}, got {cb.shape}/{cr.shape}")
            if cb.dtype != np.uint8 or cr.dtype != np.uint8:
                raise ValueError(f"expected uint8 chroma planes, got {cb.dtype}/{cr.dtype}")
            if disp_w > MAX_WIDTH or disp_h > MAX_HEIGHT:
                raise ValueError(
                    f"frame {disp_w}x{disp_h} exceeds MPEG-1 limits ({MAX_WIDTH}x{MAX_HEIGHT})"
                )
        inputs = self._to_device((y, cb, cr), "planes")
        return self._run_and_assemble(lambda msb: self._enqueue_planes(inputs, msb),
                                      -(-disp_w // 16), disp_w, disp_h, first_frame_index)

    def encode_from_jpegs(self, jpegs, first_frame_index: int = 0,
                          intake: str = "auto") -> bytes:
        """Encode a batch of JPEGs, files (paths) or in memory (bytes-like
        buffers), into an MPEG-1 video ES.  The first is probed; `intake`
        ("auto", "ycbcr", "coeffs" or "rgb") picks what the batch is
        decoded to by the rule of `api.encode_jpeg_folder` and the CLI's
        `--stream` (`io/jpeg.py::intake_kind`: the 4:2:0 planes of
        3-component 2x2-subsampled JPEGs under "auto"); the host's native
        decoder decodes every frame on its threads, in the span
        `encode.jpeg_decode` (a frame of another geometry, or one that
        fails, raises ValueError naming it); then this returns what
        `encode_from_planes`, `encode_from_coeffs` or `encode` returns for
        the decoded batch.  A widening beyond the JAX package, which takes
        decoded frames only."""
        if not len(jpegs):
            raise ValueError("encode_from_jpegs needs at least one JPEG")
        geom = jpeg_io.probe_jpeg(jpegs[0])
        if geom is None:
            raise ValueError(f"decode failure: {jpeg_io.source_name(jpegs, 0)}")
        kind = jpeg_io.intake_kind(geom, intake)
        with stage_scope("encode.jpeg_decode"):
            arrays = jpeg_io.decode_batch(jpegs, geom, kind)
        return encode_decoded(self, kind, arrays, geom, first_frame_index)

    def encode_to_file(self, frames_rgb: np.ndarray, path: str) -> int:
        data = self.encode(frames_rgb) + headers.sequence_end()
        with open(path, "wb") as f:
            f.write(data)
        return len(data)

    def _coeffs_to_device(self, a) -> torch.Tensor:
        """Coefficients (numpy or torch) copied to the device as they are,
        2 B a sample for the int16 of `io/jpeg.decode_coeffs_batch`, then
        widened to int32 there."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device).to(torch.int32)

    def encode_from_coeffs(self, yc, cbc, crc, height: int, width: int,
                           first_frame_index: int = 0) -> bytes:
        """Encode straight from dequantized JPEG coefficient blocks (the
        reference's `io/jpeg.decode_coeffs_batch`: (B, blocks, 64) per
        component, int16): the host has done the entropy decode only; the
        islow IDCT (`ops/jpeg_device.py`, exact against stb_image), the
        macroblock padding and the whole encode run on the device.  Like the
        reference's planes intakes it stores the JPEG's full-range YCbCr as
        it is (the rgb intake stores studio range)."""
        with stage_scope("encode.pad"):
            ch, cw = -(-height // 2), -(-width // 2)
            exp_y = (-(-height // 8) * -(-width // 8), 64)
            exp_c = (-(-ch // 8) * -(-cw // 8), 64)
            for name, arr, exp in (("Y", yc, exp_y), ("Cb", cbc, exp_c), ("Cr", crc, exp_c)):
                if arr.ndim != 3 or tuple(arr.shape[1:]) != exp:
                    raise ValueError(
                        f"{name} coefficients must be (B, {exp[0]}, 64) for "
                        f"{width}x{height} 4:2:0, got {tuple(arr.shape)}"
                    )
            if width > MAX_WIDTH or height > MAX_HEIGHT:
                raise ValueError(
                    f"frame {width}x{height} exceeds MPEG-1 limits ({MAX_WIDTH}x{MAX_HEIGHT})"
                )
        with stage_scope("encode.h2d"):
            coeffs = [self._coeffs_to_device(a) for a in (yc, cbc, crc)]
        with stage_scope("encode.intake"):
            y, cb, cr = coeffs_to_planes(*coeffs, height, width)
        if -height % 16 or -width % 16:
            pad_sites["device"] += 1
        del coeffs  # the int32 coefficients are not held through the encode
        return self._run_and_assemble(
            lambda msb: self._enqueue_planes((y, cb, cr), msb),
            y.shape[2] // 16, width, height, first_frame_index)
