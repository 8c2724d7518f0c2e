"""The rate control's bit count: 4:2:0 planes -> each slice's exact coded
bits at every quantizer_scale 1..31, and each picture's scale from them.

No kernel of the JAX package does this (it codes every picture at one
scale).  The CUDA kernel (`csrc/bit_count.cu`, `bit_count_launch`) reads
the planes once and writes the (pictures, slices, 31) table;
`bit_count_plain` is its plain PyTorch twin, B1's twin pipeline
(`cuda_vlc.levels_plain`, `level_slots`) run at each scale with the code
lengths summed.  `bit_count` runs the twin for CPU tensors and the kernel
for CUDA tensors; there is no other route.

`choose_qscales` turns the table into each picture's quantizer_scale q*:
the smallest scale whose coded picture (the picture header and every slice,
each rounded up to whole bytes, as the stream holds them) fits the budget,
or 31 where none fits.  It is plain torch on the table's device, so the
scales stay there for B1 and the slice headers.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import (
    Luts,
    check_matrix,
    check_plane_shapes,
    level_slots,
    levels_plain,
)
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct

SCALES = 31  # quantizer_scale 1..31
SLICE_HEADER_BITS = 38
PICTURE_HEADER_BYTES = 8  # start code, temporal_reference, picture_coding_type, vbv_delay

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {"bit_count_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P]}


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    return _build.load("bit_count", _ARGTYPES)


def bit_count_plain(y, cb, cr, intra_q, luts: Luts) -> torch.Tensor:
    """Plain twin of the kernel: same arguments, same output."""
    bsz, h, _ = y.shape
    out = []
    for q in range(1, SCALES + 1):
        _, lens = level_slots(*levels_plain(y, cb, cr, intra_q * q, luts.zigzag, aan_dct), luts)
        out.append(lens.sum(dim=(1, 2)) + SLICE_HEADER_BITS)
    return torch.stack(out, dim=1).to(torch.int32).reshape(bsz, h // 16, SCALES)


def bit_count(y, cb, cr, intra_q, luts: Luts) -> torch.Tensor:
    """Planes y (B, H, W) u8, cb/cr (B, H/2, W/2) u8 (H, W multiples of 16),
    intra_q (8, 8) int32 the intra matrix (entries 1..255) ->
    (B, H/16, 31) int32: entry [b, s, q - 1] the exact bits of slice s of
    picture b coded at quantizer_scale q, its 38 header bits included (the
    nbits that B1 and B2 give at that scale)."""
    check_plane_shapes(y, cb, cr)
    check_matrix("intra_q", intra_q, y.device)
    luts.check(y.device)
    if y.device.type == "cpu":
        return bit_count_plain(y, cb, cr, intra_q, luts)
    bsz, h, w = y.shape
    out = torch.empty((bsz, h // 16, SCALES), dtype=torch.int32, device=y.device)
    _build.launch(load_kernel, "bit_count", y.device, y, cb, cr, bsz, h, w, intra_q,
                  luts.ac_len, luts.dc_len, out)
    return out


def choose_qscales(table: torch.Tensor, budget_bytes: int) -> torch.Tensor:
    """(B, S, 31) slice bits (`bit_count`) and a picture budget in bytes ->
    (B,) int32 q*: the smallest quantizer_scale whose coded picture fits,
    31 where none does.  Every scale is tried (bits are not monotone in the
    scale: merged zero runs can turn into escapes)."""
    picture = torch.div(table + 7, 8, rounding_mode="floor").sum(dim=1) + PICTURE_HEADER_BYTES
    fits = picture <= budget_bytes
    first = fits.to(torch.int32).argmax(dim=1)  # the first scale that fits
    return torch.where(fits.any(dim=1), first + 1, SCALES).to(torch.int32)
