"""Kernel B3 (zigzag levels + DC predictors -> 4:1-fused VLC slots) and the
f32 levels kernel in front of it: the high-quality path (f32 DCT, quality
>= 70) after the planes.

One CUDA source (`csrc/vlc_levels4.cu`) with two entry points:

* `vlc_levels4` (B3) replaces the Pallas kernel
  `ec504_imageencoder_tpu/ops/pallas_vlc.py::_vlc_kernel` (launched by
  `vlc_slots_tpu`) together with `fuse_slots_streamwise` behind it: it
  writes B1's output format, ready for the pack kernel B2.
  `vlc_levels4_plain` is its plain PyTorch twin (`cuda_vlc.level_slots`
  and `fuse4_i32`).
* `f32_levels` replaces no Pallas kernel: the reference computes the
  levels with an XLA einsum and elementwise ops.  It reads the padded
  planes and writes what `models/mpeg1.py::plane_levels` returns for
  `dct_impl="f32"`: blockize, the f32 `matmul_dct` in numpy's einsum
  order (every product and sum rounded on its own, no FMA), quantize,
  zigzag and DC prediction, in one launch.  `f32_levels_plain` is its
  plain PyTorch twin, those ops themselves (`cuda_vlc.levels_plain` with
  `matmul_dct`).

Each wrapper runs the twin for CPU tensors and the kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import (
    MAX_WIDTH,
    Luts,
    check_matrix,
    check_plane_shapes,
    fuse4_i32,
    level_slots,
    levels_plain,
)
from ec504_imageencoder_tpu_torch.ops.dct import matmul_dct

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
    return fuse4_i32(*level_slots(levels, preds, luts))


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
    _check(levels, preds, luts)
    if levels.device.type == "cpu":
        return vlc_levels4_plain(levels, preds, luts)
    if levels.data_ptr() % 16:
        raise ValueError("vlc_levels4 reads levels as 16-byte vectors: misaligned tensor")
    r, nb, _ = levels.shape
    out = torch.empty((5, r, nb * 16), dtype=torch.int32, device=levels.device)
    _build.launch(load_kernel, "vlc_levels4", levels.device, levels, preds, r, nb,
                  *luts[1:], *out.unbind(0))
    return tuple(out.unbind(0))


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
    _check_planes(y, cb, cr, qw, zigzag)
    if y.device.type == "cpu":
        return f32_levels_plain(y, cb, cr, qw, zigzag)
    if any(t.data_ptr() % 8 for t in (y, cb, cr)):
        raise ValueError("f32_levels reads pixel rows as 8-byte words: misaligned plane")
    bsz, h, w = y.shape
    r, nb = bsz * (h // 16), (w // 16) * 6
    levels = torch.empty((r, nb, 64), dtype=torch.int32, device=y.device)
    preds = torch.empty((r, nb), dtype=torch.int32, device=y.device)
    _build.launch(load_kernel, "f32_levels", y.device, y, cb, cr, bsz, h, w, qw, zigzag,
                  levels, preds)
    return levels, preds
