"""Kernel B3 (zigzag levels + DC predictors -> 4:1-fused VLC slots) and the
f32 levels kernel in front of it: the high-quality path (f32 DCT, quality
>= 70) after the planes.

One CUDA source (`csrc/vlc_levels4.cu`) with two entry points:

* `vlc_levels4` (B3) replaces the Pallas kernel
  `ec504_imageencoder_tpu/ops/pallas_vlc.py::_vlc_kernel` (launched by
  `vlc_slots_tpu`) together with `fuse_slots_streamwise` behind it: it
  writes B1's output format, ready for the pack kernel B2.
  `vlc_levels4_plain` is its plain PyTorch twin (`block_streams_correct64`
  and `fuse4`).
* `f32_levels` replaces no Pallas kernel: the reference computes the
  levels with an XLA einsum and elementwise ops.  It reads the padded
  planes and writes what `models/mpeg1.py::plane_levels` returns for
  `dct_impl="f32"`: blockize, the f32 `matmul_dct` in numpy's einsum
  order (every product and sum rounded on its own, no FMA), quantize,
  zigzag and DC prediction, in one launch.  `f32_levels_plain` is its
  plain PyTorch twin, those ops themselves (`levels_plain` with
  `matmul_dct`).

Each wrapper runs the twin for CPU tensors and the kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import fuse4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import (
    MAX_WIDTH,
    Luts,
    blockize,
    check_matrix,
    check_plane_shapes,
    to_i32_bits,
)
from ec504_imageencoder_tpu_torch.ops.dct import matmul_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize_intra
from ec504_imageencoder_tpu_torch.ops.vlc_device import block_streams_correct64, dc_predictors
from ec504_imageencoder_tpu_torch.ops.zigzag import zigzag_scan

# kernel launches since the last reset, per entry point (launches for CPU
# tensors excluded): B3 (vlc_levels4) and the f32 levels (f32_levels)
launches = 0
launches_levels = 0

MAX_NB = MAX_WIDTH // 16 * 6

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "vlc_levels4_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "f32_levels_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
}


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    return _build.load("vlc_levels4", _ARGTYPES)


def vlc_levels4_plain(levels, preds, luts: Luts):
    """Plain twin of the kernel: same arguments, same outputs."""
    r, nb, _ = levels.shape
    comp = torch.arange(nb, device=levels.device).expand(r, nb) % 6
    codes, lens = block_streams_correct64(
        levels, preds, comp < 4, comp == 0,
        luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len,
    )
    fused = fuse4(codes.reshape(r, -1), lens.reshape(r, -1))
    return tuple(to_i32_bits(t) for t in fused)


def _check(levels, preds, luts: Luts) -> None:
    if levels.dim() != 3 or levels.shape[2] != 64:
        raise ValueError(f"levels must be (R, NB, 64), got {tuple(levels.shape)}")
    r, nb, _ = levels.shape
    if nb % 6 or nb > MAX_NB:
        raise ValueError(f"NB must be 6 blocks per macroblock, at most {MAX_NB}; got {nb}")
    if tuple(preds.shape) != (r, nb):
        raise ValueError(f"preds must be {(r, nb)}, got {tuple(preds.shape)}")
    for name, t in (("levels", levels), ("preds", preds)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if preds.device != levels.device:
        raise ValueError(f"preds is on {preds.device}, levels on {levels.device}")
    luts.check(levels.device)


def vlc_levels4(levels, preds, luts: Luts):
    """levels (R, NB, 64) int32 zigzag levels per block in stream order,
    slot 0 the absolute quantized DC, NB = 6 blocks per macroblock;
    preds (R, NB) int32 DC predictors ->
    (v0, v1, v2, v3, flens), each (R, NB * 16) int32: per slice row, the
    fused slots of its blocks in stream order (the format of B1)."""
    global launches
    _check(levels, preds, luts)
    if levels.device.type == "cpu":
        return vlc_levels4_plain(levels, preds, luts)
    if levels.device.type != "cuda":
        raise ValueError(f"unsupported device {levels.device}")
    tensors = (levels, preds, *luts)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("vlc_levels4 needs contiguous tensors")
    if levels.data_ptr() % 16:
        raise ValueError("vlc_levels4 reads levels as 16-byte vectors: misaligned tensor")
    lib = load_kernel()
    r, nb, _ = levels.shape
    out = torch.empty((5, r, nb * 16), dtype=torch.int32, device=levels.device)
    err = lib.vlc_levels4_launch(
        levels.data_ptr(), preds.data_ptr(), r, nb,
        *(t.data_ptr() for t in luts[1:]),
        *(out[i].data_ptr() for i in range(5)),
        levels.device.index, torch.cuda.current_stream(levels.device).cuda_stream,
    )
    _build.check(lib, "vlc_levels4", err)
    launches += 1
    return tuple(out.unbind(0))


def levels_plain(y, cb, cr, qw, zigzag, dct):
    """Padded planes -> (levels (B * mbh, mbw * 6, 64) int32, zigzag order,
    slot 0 the absolute quantized DC; preds (B * mbh, mbw * 6) int32 DC
    predictors) in plain PyTorch, with the DCT `dct` (`matmul_dct` or
    `aan_dct`): the reference's `_generic_pipeline_from_planes` up to the
    emission."""
    blocks = blockize(y, cb, cr)                       # (B, mbh, mbw, 6, 8, 8)
    bsz, mbh, mbw = blocks.shape[:3]
    dc, lvl = quantize_intra(dct(blocks), qw)
    zz = zigzag_scan(lvl, zigzag)
    lane = torch.arange(64, device=y.device)
    zz = torch.where(lane == 0, dc[..., None], zz)
    r = bsz * mbh
    return zz.reshape(r, mbw * 6, 64), dc_predictors(dc).reshape(r, mbw * 6)


def f32_levels_plain(y, cb, cr, qw, zigzag):
    """Plain twin of the f32 levels kernel: same arguments, same outputs."""
    return levels_plain(y, cb, cr, qw, zigzag, matmul_dct)


def _check_planes(y, cb, cr, qw, zigzag) -> None:
    check_plane_shapes(y, cb, cr)
    check_matrix("qw", qw, y.device)
    if zigzag.dtype != torch.int32 or tuple(zigzag.shape) != (64,):
        raise TypeError(f"zigzag must be int32 (64,), got {zigzag.dtype} {tuple(zigzag.shape)}")
    if zigzag.device != y.device:
        raise ValueError(f"zigzag is on {zigzag.device}, the input on {y.device}")


def f32_levels(y, cb, cr, qw, zigzag):
    """Planes y (B, H, W) u8, cb/cr (B, H/2, W/2) u8 (H, W multiples of 16),
    qw (8, 8) int32 = qscale * intra matrix (entries >= 1), zigzag (64,)
    int32 scan position -> natural index ->
    (levels (B * H/16, W/16 * 6, 64) int32, zigzag order, slot 0 the
    absolute quantized DC; preds (B * H/16, W/16 * 6) int32 DC
    predictors): `plane_levels` with the f32 DCT, the input of B3."""
    global launches_levels
    _check_planes(y, cb, cr, qw, zigzag)
    if y.device.type == "cpu":
        return f32_levels_plain(y, cb, cr, qw, zigzag)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if not all(t.is_contiguous() for t in (y, cb, cr, qw, zigzag)):
        raise ValueError("f32_levels needs contiguous tensors")
    if any(t.data_ptr() % 8 for t in (y, cb, cr)):
        raise ValueError("f32_levels reads pixel rows as 8-byte words: misaligned plane")
    lib = load_kernel()
    bsz, h, w = y.shape
    r, nb = bsz * (h // 16), (w // 16) * 6
    levels = torch.empty((r, nb, 64), dtype=torch.int32, device=y.device)
    preds = torch.empty((r, nb), dtype=torch.int32, device=y.device)
    err = lib.f32_levels_launch(
        *(t.data_ptr() for t in (y, cb, cr)), bsz, h, w, qw.data_ptr(), zigzag.data_ptr(),
        levels.data_ptr(), preds.data_ptr(),
        y.device.index, torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, "vlc_levels4", err)
    launches_levels += 1
    return levels, preds
