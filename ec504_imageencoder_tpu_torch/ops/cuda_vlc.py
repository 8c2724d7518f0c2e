"""Kernels B1 and B6b: 4:2:0 planes -> 4:1- or 8:1-fused VLC slots in
stream order.

One CUDA kernel template (`csrc/vlc_fused4.cu`, which also holds B6a's
raw slots, `cuda_vlc_raw`) replaces the Pallas kernels
`ec504_imageencoder_tpu/ops/pallas_vlc.py::_vlc_blocks_fused_kernel`
(B1, `vlc_fused4`) and `_vlc_blocks_fused8_kernel` (B6b, `vlc_fused8`,
the reference's EC504_FUSE=8 route), each with the blockize in front of
it and `fused_stack_to_stream` / `fused8_stack_to_stream` behind it.
`vlc_fused4_plain` is B1's plain PyTorch twin, composed from the port's
colour-free ops: blockize, AAN DCT, quantization, zigzag, DC prediction,
64-slot emission and 4:1 fusion; `vlc_fused8_plain` adds the third fusion
level `bitpack.fuse8`.

`vlc_fused4` and `vlc_fused8` run the twin for CPU tensors and the kernel
for CUDA tensors; there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import fuse4, fuse8
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize_intra
from ec504_imageencoder_tpu_torch.ops.vlc_device import (
    block_streams_correct64,
    dc_predictors,
)
from ec504_imageencoder_tpu_torch.ops.zigzag import zigzag_scan
from ec504_imageencoder_tpu_torch.utils import tables

# kernel launches since the last reset (launches for CPU tensors excluded):
# B1 (vlc_fused4) and B6b (vlc_fused8)
launches = 0
launches8 = 0

MAX_WIDTH = 4096  # the kernel keeps one slice's DC values in shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int
_LAUNCH = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P]
_ARGTYPES = {"vlc_fused4_launch": _LAUNCH, "vlc_fused8_launch": _LAUNCH,
             "vlc_raw_launch": [*_LAUNCH[:13], _P, _I, _P]}


class Luts(NamedTuple):
    """The VLC tables B1 reads, as int32 tensors on one device."""
    zigzag: torch.Tensor    # (64,)   scan position -> natural index
    ac_code: torch.Tensor   # (32, 41) run, |level| -> code (no sign bit)
    ac_len: torch.Tensor    # (32, 41) -> length, 0 = escape
    dc_code: torch.Tensor   # (2, 9)  [is_luma, size] -> dct_dc_size code
    dc_len: torch.Tensor    # (2, 9)

    @classmethod
    def default(cls, device) -> "Luts":
        """The ISO tables of correct mode (B1, B3)."""
        return cls(*(t.to(device) for t in (
            tables.ZIGZAG_GATHER_T, tables.AC_CODE_T, tables.AC_LEN_T,
            tables.DC_CODE_T, tables.DC_LEN_T,
        )))

    @classmethod
    def compat(cls, device) -> "Luts":
        """The same with the compat AC table (B4)."""
        return cls(*(t.to(device) for t in (
            tables.ZIGZAG_GATHER_T, tables.AC_CODE_COMPAT_T, tables.AC_LEN_COMPAT_T,
            tables.DC_CODE_T, tables.DC_LEN_T,
        )))

    def check(self, device) -> None:
        """Raise unless every table is int32 of its shape on `device`."""
        want = {"zigzag": (64,), "ac_code": (32, 41), "ac_len": (32, 41),
                "dc_code": (2, 9), "dc_len": (2, 9)}
        for name, t in zip(self._fields, self):
            if t.dtype != torch.int32 or tuple(t.shape) != want[name]:
                raise TypeError(f"{name} must be int32 {want[name]}, got {t.dtype} {tuple(t.shape)}")
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, the input on {device}")


def load_kernel():
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("vlc_fused4", _ARGTYPES)


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
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


def block_slots(y, cb, cr, qw, luts: Luts):
    """The plain integer-DCT pipeline of B1 and B6a: padded planes ->
    (codes, lens) int64 (R, NB, 64) per slice row in stream order, MB
    header and EOB folded in, and the AAN coefficients (B, mbh, mbw, 6,
    8, 8) int32."""
    blocks = blockize(y, cb, cr)
    bsz, mbh, mbw = blocks.shape[:3]
    f = aan_dct(blocks)
    dc, lvl = quantize_intra(f, qw)
    zz = zigzag_scan(lvl, luts.zigzag)
    lane = torch.arange(64, device=y.device)
    zz = torch.where(lane == 0, dc[..., None], zz)
    comp = torch.arange(6, device=y.device)
    codes, lens = block_streams_correct64(
        zz, dc_predictors(dc), (comp < 4).expand(dc.shape), (comp == 0).expand(dc.shape),
        luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len,
    )
    r = bsz * mbh
    return codes.reshape(r, -1, 64), lens.reshape(r, -1, 64), f


def vlc_fused4_plain(y, cb, cr, qw, luts: Luts):
    """Plain twin of the kernel: same arguments, same outputs."""
    codes, lens, _ = block_slots(y, cb, cr, qw, luts)
    r = codes.shape[0]
    fused = fuse4(codes.reshape(r, -1), lens.reshape(r, -1))
    return tuple(to_i32_bits(t) for t in fused)


def vlc_fused8_plain(y, cb, cr, qw, luts: Luts):
    """Plain twin of B6b: same arguments, same outputs."""
    codes, lens, _ = block_slots(y, cb, cr, qw, luts)
    r = codes.shape[0]
    words, flens = fuse8(*fuse4(codes.reshape(r, -1), lens.reshape(r, -1)))
    return tuple(to_i32_bits(w) for w in words), flens.to(torch.int32)


def check_planes(y, cb, cr, qw, luts: Luts) -> None:
    """Raise unless the arguments are what B1, B6a and B6b take."""
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
    check_matrix("qw", qw, y.device)
    luts.check(y.device)
    for name, t in (("cb", cb), ("cr", cr)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")


def check_matrix(name: str, m: torch.Tensor, device) -> None:
    """Raise unless `m` is an (8, 8) int32 matrix on `device`."""
    if m.dtype != torch.int32 or tuple(m.shape) != (8, 8):
        raise TypeError(f"{name} must be int32 (8, 8), got {m.dtype} {tuple(m.shape)}")
    if m.device != device:
        raise ValueError(f"{name} is on {m.device}, the input on {device}")


def _launch(fuse: int, y, cb, cr, qw, luts: Luts) -> torch.Tensor:
    """Launch the kernel at fusion level `fuse` on CUDA tensors ->
    (fuse + 1, R, NB * 64 / fuse) int32: the word planes, then the
    lengths."""
    name = f"vlc_fused{fuse}"
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if not all(t.is_contiguous() for t in (y, cb, cr, qw, *luts)):
        raise ValueError(f"{name} needs contiguous tensors")
    lib = load_kernel()
    bsz, h, w = y.shape
    out = torch.empty((fuse + 1, bsz * (h // 16), (w // 16) * 6 * (64 // fuse)),
                      dtype=torch.int32, device=y.device)
    err = getattr(lib, f"{name}_launch")(
        *(t.data_ptr() for t in (y, cb, cr)), bsz, h, w,
        *(t.data_ptr() for t in (qw, *luts)), out.data_ptr(),
        y.device.index, torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, "vlc_fused4", err)
    return out


def vlc_fused4(y, cb, cr, qw, luts: Luts):
    """Planes y (B, H, W) u8, cb/cr (B, H/2, W/2) u8 (H, W multiples of 16),
    qw (8, 8) int32 = qscale * intra matrix ->
    (v0, v1, v2, v3, flens), each (B * H/16, 6 * W/16 * 16) int32: per
    slice, the fused slots of its blocks in stream order; v0..v3 hold the
    u32 words (most significant first) of values of flens <= 128 bits."""
    global launches
    check_planes(y, cb, cr, qw, luts)
    if y.device.type == "cpu":
        return vlc_fused4_plain(y, cb, cr, qw, luts)
    out = _launch(4, y, cb, cr, qw, luts)
    launches += 1
    return tuple(out.unbind(0))


def vlc_fused8(y, cb, cr, qw, luts: Luts):
    """The same planes and qw as `vlc_fused4` ->
    (words (w0, ..., w7), flens), each (B * H/16, 6 * W/16 * 8) int32: per
    slice, the 8:1-fused slots of its blocks in stream order; w0..w7 hold
    the u32 words (most significant first) of values of flens <= 256
    bits."""
    global launches8
    check_planes(y, cb, cr, qw, luts)
    if y.device.type == "cpu":
        return vlc_fused8_plain(y, cb, cr, qw, luts)
    planes = _launch(8, y, cb, cr, qw, luts).unbind(0)
    launches8 += 1
    return planes[:8], planes[8]
