"""Kernel B1: 4:2:0 planes -> 4:1-fused VLC slots in stream order.

The CUDA kernel (`csrc/vlc_fused4.cu`) replaces the Pallas kernel
`ec504_imageencoder_tpu/ops/pallas_vlc.py::_vlc_blocks_fused_kernel`
together with the blockize in front of it and `fused_stack_to_stream`
behind it.  `vlc_fused4_plain` is its plain PyTorch twin, composed from
the port's colour-free ops: blockize, AAN DCT, quantization, zigzag, DC
prediction, 64-slot emission and 4:1 fusion.

`vlc_fused4` runs the twin for CPU tensors and the kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import fuse4
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize_intra
from ec504_imageencoder_tpu_torch.ops.vlc_device import (
    block_streams_correct64,
    dc_predictors,
)
from ec504_imageencoder_tpu_torch.ops.zigzag import zigzag_scan
from ec504_imageencoder_tpu_torch.utils import tables

# kernel launches since the last reset (launches for CPU tensors excluded)
launches = 0

MAX_WIDTH = 4096  # the kernel keeps one slice's DC values in shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "vlc_fused4_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _I, _P],
}


class Luts(NamedTuple):
    """The VLC tables B1 reads, as int32 tensors on one device."""
    zigzag: torch.Tensor    # (64,)   scan position -> natural index
    ac_code: torch.Tensor   # (32, 41) run, |level| -> code (no sign bit)
    ac_len: torch.Tensor    # (32, 41) -> length, 0 = escape
    dc_code: torch.Tensor   # (2, 9)  [is_luma, size] -> dct_dc_size code
    dc_len: torch.Tensor    # (2, 9)

    @classmethod
    def default(cls, device) -> "Luts":
        return cls(*(t.to(device) for t in (
            tables.ZIGZAG_GATHER, tables.AC_CODE, tables.AC_LEN,
            tables.DC_CODE, tables.DC_LEN,
        )))


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    return _build.load("vlc_fused4", _ARGTYPES)


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 holding the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def blockize(y, cb, cr) -> torch.Tensor:
    """(B, H, W) / (B, H/2, W/2) planes -> (B, mbh, mbw, 6, 8, 8) blocks;
    luma order in a macroblock is TL, TR, BL, BR, then Cb, Cr."""
    bsz, h, w = y.shape
    mbh, mbw = h // 16, w // 16
    luma = y.reshape(bsz, mbh, 2, 8, mbw, 2, 8).permute(0, 1, 4, 2, 5, 3, 6)
    luma = luma.reshape(bsz, mbh, mbw, 4, 8, 8)

    def chroma(p):
        return p.reshape(bsz, mbh, 8, mbw, 8).permute(0, 1, 3, 2, 4)[:, :, :, None]

    return torch.cat([luma, chroma(cb), chroma(cr)], dim=3)


def vlc_fused4_plain(y, cb, cr, qw, luts: Luts):
    """Plain twin of the kernel: same arguments, same outputs."""
    blocks = blockize(y, cb, cr)
    bsz, mbh, mbw = blocks.shape[:3]
    dc, lvl = quantize_intra(aan_dct(blocks), qw)
    zz = zigzag_scan(lvl, luts.zigzag)
    lane = torch.arange(64, device=y.device)
    zz = torch.where(lane == 0, dc[..., None], zz)
    comp = torch.arange(6, device=y.device)
    codes, lens = block_streams_correct64(
        zz, dc_predictors(dc), (comp < 4).expand(dc.shape), (comp == 0).expand(dc.shape),
        luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len,
    )
    r = bsz * mbh
    fused = fuse4(codes.reshape(r, -1), lens.reshape(r, -1))
    return tuple(_to_i32_bits(t) for t in fused)


def _check(y, cb, cr, qw, luts: Luts) -> None:
    if y.dim() != 3:
        raise ValueError(f"y must be (B, H, W), got {tuple(y.shape)}")
    bsz, h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError(f"planes must be padded to macroblocks, got {h}x{w}")
    if w > MAX_WIDTH:
        raise ValueError(f"width {w} exceeds {MAX_WIDTH}")
    for name, t in (("cb", cb), ("cr", cr)):
        if tuple(t.shape) != (bsz, h // 2, w // 2):
            raise ValueError(f"{name} must be {(bsz, h // 2, w // 2)}, got {tuple(t.shape)}")
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
    want = {"qw": (8, 8), "zigzag": (64,), "ac_code": (32, 41), "ac_len": (32, 41),
            "dc_code": (2, 9), "dc_len": (2, 9)}
    for name, t in (("qw", qw), *zip(Luts._fields, luts)):
        if t.dtype != torch.int32 or tuple(t.shape) != want[name]:
            raise TypeError(f"{name} must be int32 {want[name]}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("cb", cb), ("cr", cr), ("qw", qw), *zip(Luts._fields, luts)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")


def vlc_fused4(y, cb, cr, qw, luts: Luts):
    """Planes y (B, H, W) u8, cb/cr (B, H/2, W/2) u8 (H, W multiples of 16),
    qw (8, 8) int32 = qscale * intra matrix ->
    (v0, v1, v2, v3, flens), each (B * H/16, 6 * W/16 * 16) int32: per
    slice, the fused slots of its blocks in stream order; v0..v3 hold the
    u32 words (most significant first) of values of flens <= 128 bits."""
    global launches
    _check(y, cb, cr, qw, luts)
    if y.device.type == "cpu":
        return vlc_fused4_plain(y, cb, cr, qw, luts)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    tensors = (y, cb, cr, qw, *luts)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("vlc_fused4 needs contiguous tensors")
    lib = load_kernel()
    bsz, h, w = y.shape
    out = torch.empty((5, bsz * (h // 16), (w // 16) * 6 * 16), dtype=torch.int32,
                      device=y.device)
    err = lib.vlc_fused4_launch(
        *(t.data_ptr() for t in (y, cb, cr)), bsz, h, w,
        *(t.data_ptr() for t in (qw, *luts)),
        *(out[i].data_ptr() for i in range(5)),
        y.device.index, torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, "vlc_fused4", err)
    launches += 1
    return tuple(out.unbind(0))
