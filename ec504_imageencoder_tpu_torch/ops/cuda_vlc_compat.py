"""Kernels B4a/B4b: compat-mode planes -> VLC slots, bug for bug; and the
compat colour that makes those planes.

One CUDA source (`csrc/vlc_compat.cu`) with three entry points.  Two
replace the Pallas kernels of `ec504_imageencoder_tpu/ops/pallas_vlc.py`:

* `vlc_compat_slots` (B4a) replaces `_vlc_compat_kernel`
  (`vlc_compat_slots_from_blocks_tpu`): raw (code, len) slots;
* `vlc_compat_fused4` (B4b) replaces `_vlc_compat_fused_kernel`
  (`vlc_compat_fused_slots_from_blocks_tpu`) and the
  `fused_stack_to_stream` behind it: B1's fused format, ready for B2.

Both read the full-resolution planes directly with the compat geometry
(the reference's `models/encoder.py::compat_blockize_px64`).  Their
plain PyTorch twins are composed from `compat_blockize`, `aan_dct`, the
compat `quantize`, `zigzag_scan` and `block_streams_compat` (then `fuse4`
for B4b).  One difference from the Pallas kernels is deliberate: their
one-hot lookup reads the ISO AC table, so at (run 16, |level| 2) they
emit 16 bits where the reference C encoder (and the reference's numpy
path, and the golden stream) emits its 15-bit typo; the port follows the
reference C encoder.

The third, `compat_color`, replaces no Pallas kernel: the reference's
compat colour is host numpy f64 (`ops/color.py::rgb_to_ycbcr_exact`).
The kernel and its plain twin repeat that arithmetic operation for
operation, so the planes are the same bytes.

Each wrapper runs the twin for CPU tensors and the kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import fuse4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts, check_matrix, to_i32_bits
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize
from ec504_imageencoder_tpu_torch.ops.vlc_device import block_streams_compat
from ec504_imageencoder_tpu_torch.ops.zigzag import zigzag_scan

# kernel launches since the last reset, per entry point (launches for CPU
# tensors excluded)
launches_slots = 0
launches_fused4 = 0
launches_color = 0

# the compat geometry (the reference's models/encoder.py, which the port's
# models/encoder.py re-exports): the C encoder encodes a 96-column x
# 144-row crop as 6 column-band slices of 9 macroblocks
CROP_W = 96
CROP_H = 144
N_SLICES = CROP_W // 16
N_MBS = CROP_H // 16
NB = N_MBS * 6  # 8x8 blocks per slice row

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]
_ARGTYPES = {
    "vlc_compat_slots_launch": [*_COMMON, _P, _P, _I, _P],
    "vlc_compat_fused4_launch": [*_COMMON, _P, _P, _P, _P, _P, _I, _P],
    "compat_color_launch": [_P, ctypes.c_longlong, _P, _I, _P],
}


def load_kernel():
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("vlc_compat", _ARGTYPES)


def compat_blockize(y, cb, cr) -> torch.Tensor:
    """Full-resolution (B, H, W) planes -> (B, 6 bands, 9 MBs, 6, 8, 8)
    blocks of the 96 x 144 crop.  Luma b = y2 * 2 + x2; chroma reads the
    full-resolution plane through a half-width pointer view (quirk Q3),
    exact at odd widths too."""
    bsz, h, w = y.shape
    luma = y[:, :CROP_H, :CROP_W].reshape(bsz, N_MBS, 2, 8, N_SLICES, 2, 8)
    luma = luma.permute(0, 4, 1, 2, 5, 3, 6).reshape(bsz, N_SLICES, N_MBS, 4, 8, 8)

    def chroma(p):
        half = w // 2
        v = p.reshape(bsz, h * w)[:, : 8 * N_MBS * half].reshape(bsz, 8 * N_MBS, half)
        g = v[:, :, : 8 * N_SLICES].reshape(bsz, N_MBS, 8, N_SLICES, 8)
        return g.permute(0, 3, 1, 2, 4)[:, :, :, None]

    return torch.cat([luma, chroma(cb), chroma(cr)], dim=3)


def compat_levels(y, cb, cr, scaled_q, luts: Luts) -> torch.Tensor:
    """The twins' DCT side: (B, 6 bands, 9 MBs, 6, 64) quantized zigzag
    levels (slot 0 the absolute DC)."""
    return zigzag_scan(quantize(aan_dct(compat_blockize(y, cb, cr)), scaled_q), luts.zigzag)


def stream_slots(zz, luts: Luts):
    """The twins' emission: (B, 6, 9, 6, 64) levels -> int64 (codes, lens)
    of shape (B * 6, 54, 64), the MB header and EOB folded in as the
    kernels do."""
    comp = torch.arange(6, device=zz.device)
    codes, lens = block_streams_compat(
        zz, (comp < 4).expand(zz.shape[:-1]),
        luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len,
    )
    codes, lens = codes[..., :64].clone(), lens[..., :64].clone()
    codes[..., 63] = (codes[..., 63] << 2) | 0b10  # EOB '10' into slot 63
    lens[..., 63] += 2
    first = comp == 0                               # MB header '11' into the DC
    hdr = torch.bitwise_left_shift(torch.full_like(lens[..., 0], 0b11), lens[..., 0])
    codes[..., 0] = torch.where(first, hdr | codes[..., 0], codes[..., 0])
    lens[..., 0] += 2 * first
    r = zz.shape[0] * N_SLICES
    return codes.reshape(r, NB, 64), lens.reshape(r, NB, 64)


def vlc_compat_slots_plain(y, cb, cr, scaled_q, luts: Luts):
    """Plain twin of B4a: same arguments, same outputs."""
    codes, lens = stream_slots(compat_levels(y, cb, cr, scaled_q, luts), luts)
    return (to_i32_bits(codes.transpose(1, 2)).contiguous(),
            lens.transpose(1, 2).to(torch.int32).contiguous())


def vlc_compat_fused4_plain(y, cb, cr, scaled_q, luts: Luts):
    """Plain twin of B4b: same arguments, same outputs."""
    codes, lens = stream_slots(compat_levels(y, cb, cr, scaled_q, luts), luts)
    r = codes.shape[0]
    return tuple(to_i32_bits(t) for t in fuse4(codes.reshape(r, -1), lens.reshape(r, -1)))


def _check(y, cb, cr, scaled_q, luts: Luts) -> None:
    if y.dim() != 3:
        raise ValueError(f"y must be (B, H, W), got {tuple(y.shape)}")
    _, h, w = y.shape
    if h < CROP_H or w < CROP_W:
        raise ValueError(f"compat frames must be at least {CROP_W}x{CROP_H}, got {w}x{h}")
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
        if t.shape != y.shape or t.device != y.device:
            raise ValueError(f"{name} must be {tuple(y.shape)} on {y.device}")
    check_matrix("scaled_q", scaled_q, y.device)
    luts.check(y.device)


def _launch(entry: str, y, cb, cr, scaled_q, luts: Luts, outs) -> None:
    tensors = (y, cb, cr, scaled_q, *luts)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{entry} needs contiguous tensors")
    lib = load_kernel()
    bsz, h, w = y.shape
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in (y, cb, cr)), bsz, h, w,
        *(t.data_ptr() for t in (scaled_q, *luts)),
        *(t.data_ptr() for t in outs),
        y.device.index, torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, "vlc_compat", err)


def vlc_compat_slots(y, cb, cr, scaled_q, luts: Luts):
    """B4a.  y, cb, cr: full-resolution (B, H, W) u8 planes, H >= 144,
    W >= 96; scaled_q: (8, 8) int32 scaled JPEG matrix; luts:
    `Luts.compat` -> (codes, lens), each (B * 6, 64, 54) int32: per slice
    row (frame-major, 6 column bands), slot k of block n at [row, k, n];
    codes hold no bits above their length."""
    global launches_slots
    _check(y, cb, cr, scaled_q, luts)
    if y.device.type == "cpu":
        return vlc_compat_slots_plain(y, cb, cr, scaled_q, luts)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    out = torch.empty((2, y.shape[0] * N_SLICES, 64, NB), dtype=torch.int32, device=y.device)
    _launch("vlc_compat_slots_launch", y, cb, cr, scaled_q, luts, out.unbind(0))
    launches_slots += 1
    return tuple(out.unbind(0))


def vlc_compat_fused4(y, cb, cr, scaled_q, luts: Luts):
    """B4b.  Same inputs as `vlc_compat_slots` -> (v0, v1, v2, v3, flens),
    each (B * 6, 54 * 16) int32: per slice row, the fused slots of its
    blocks in stream order (the format of B1)."""
    global launches_fused4
    _check(y, cb, cr, scaled_q, luts)
    if y.device.type == "cpu":
        return vlc_compat_fused4_plain(y, cb, cr, scaled_q, luts)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    out = torch.empty((5, y.shape[0] * N_SLICES, NB * 16), dtype=torch.int32, device=y.device)
    _launch("vlc_compat_fused4_launch", y, cb, cr, scaled_q, luts, out.unbind(0))
    launches_fused4 += 1
    return tuple(out.unbind(0))


def compat_color_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain twin of the compat colour: `rgb_to_ycbcr_exact`'s f64
    operations in numpy's order, each its own rounded torch op."""
    r, g, b = rgb.to(torch.float64).unbind(-1)
    y = (0.299 * r + 0.587 * g) + 0.114 * b
    cb = ((128.0 - 0.168736 * r) - 0.331264 * g) + 0.5 * b
    cr = ((128.0 + 0.5 * r) - 0.418688 * g) - 0.081312 * b
    return torch.stack([y, cb, cr]).to(torch.uint8)


def compat_color(rgb: torch.Tensor) -> torch.Tensor:
    """The compat colour.  rgb: (B, H, W, 3) u8 frames, contiguous ->
    (3, B, H, W) u8, one buffer that unpacks into the Y, Cb and Cr plane
    views, byte-equal to `rgb_to_ycbcr_exact`'s planes."""
    global launches_color
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) frames, got {tuple(rgb.shape)}")
    if rgb.dtype != torch.uint8:
        raise TypeError(f"frames must be uint8, got {rgb.dtype}")
    if rgb.device.type == "cpu":
        return compat_color_plain(rgb)
    if rgb.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb.device}")
    if not rgb.is_contiguous():
        raise ValueError("compat_color_launch needs contiguous frames")
    out = torch.empty((3, *rgb.shape[:3]), dtype=torch.uint8, device=rgb.device)
    lib = load_kernel()
    err = lib.compat_color_launch(rgb.data_ptr(), out[0].numel(), out.data_ptr(),
                                  rgb.device.index,
                                  torch.cuda.current_stream(rgb.device).cuda_stream)
    _build.check(lib, "vlc_compat", err)
    launches_color += 1
    return out
