"""Kernel B3: zigzag levels + DC predictors -> 4:1-fused VLC slots.

The emission of the high-quality path (f32 DCT, quality >= 70), whose
DCT, quantization, zigzag and DC prediction run as PyTorch ops in front
of it.  The CUDA kernel (`csrc/vlc_levels4.cu`) replaces the Pallas kernel
`ec504_imageencoder_tpu/ops/pallas_vlc.py::_vlc_kernel` (launched by
`vlc_slots_tpu`) together with `fuse_slots_streamwise` behind it: it
writes B1's output format, ready for the pack kernel B2.
`vlc_levels4_plain` is its plain PyTorch twin (`block_streams_correct64`
and `fuse4`).

`vlc_levels4` runs the twin for CPU tensors and the kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import fuse4
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import MAX_WIDTH, Luts, to_i32_bits
from ec504_imageencoder_tpu_torch.ops.vlc_device import block_streams_correct64

# kernel launches since the last reset (launches for CPU tensors excluded)
launches = 0

MAX_NB = MAX_WIDTH // 16 * 6

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "vlc_levels4_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
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
