"""Kernels K3 and K4: raw VLC codes -> big-endian slice bytes + bit counts,
one slice spread over many CUDA blocks.

One CUDA source (`csrc/pack_split.cu`) replaces two Pallas kernels of
`ec504_imageencoder_tpu/ops/pallas_pack.py` that compute
`bitpack.pack_words` of raw codes of <= 32 bits, with the bitcast to
bytes behind them:

* `pack_windows` (K3) replaces `_pack3_kernel` and its level-2 placement
  (`pack_words_pallas3`, the reference's EC504_PACK=pallas3, B6f): each
  chunk of codes packs into a private window, and each output tile
  gathers the windows that cover it;
* `pack_split` (K4) replaces `_fused_kernel` (`pack_words_fused`,
  EC504_PACK=fused, B6g): blocks of codes OR their words straight into
  the zeroed output row.

Both take the bit offsets from an int32 `torch.cumsum` of the lengths,
the counterpart of the reference's XLA cumsum outside its kernels; the
bit counts are its last column.  Any max_words works (the TPU kernels'
multiple-of-128 and window limits were their tiling).  Their twin is
`cuda_pack.pack_raw_plain`.  Each wrapper runs the twin for CPU tensors
and its kernel for CUDA tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.cuda_pack import check_slots, pack_raw_plain

# kernel launches since the last reset: K3, K4 (launches for CPU tensors
# excluded)
launches_windows = 0
launches_split = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    "pack_windows_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    "pack_split_launch": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    "pack_windows_scratch": [_IP, _IP],
}


def load_kernel():
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("pack_split", _ARGTYPES)


def _scratch_geometry() -> tuple[int, int]:
    """(K3's codes per chunk, words per window), as the library was built."""
    chunk, window = ctypes.c_int(), ctypes.c_int()
    load_kernel().pack_windows_scratch(ctypes.byref(chunk), ctypes.byref(window))
    return chunk.value, window.value


def _ends(lens, bit_offset: int):
    """(n, K) int32 lengths -> (ends (n, K) int32: the inclusive prefix sum
    plus bit_offset, nbits (n,) int32)."""
    ends = torch.cumsum(lens, dim=1, dtype=torch.int32) + bit_offset
    if lens.shape[1]:
        return ends, ends[:, -1].contiguous()
    return ends, torch.full((lens.shape[0],), bit_offset, dtype=torch.int32, device=lens.device)


def pack_windows(codes, lens, max_words: int, bit_offset: int = 38):
    """K3.  (n, K) int32 raw codes (u32 bits of <= 32-bit values) and
    lengths -> (seg (n, 4 * max_words) u8, nbits (n,) int32), as
    `cuda_pack.pack_raw`."""
    global launches_windows
    check_slots((codes, lens), max_words, bit_offset, "pack_windows")
    if lens.device.type == "cpu":
        return pack_raw_plain(codes, lens, max_words, bit_offset)
    lib = load_kernel()
    chunk, window = _scratch_geometry()
    n, k = lens.shape
    dev = lens.device
    ends, nbits = _ends(lens, bit_offset)
    nch = -(-k // chunk)
    windows = torch.empty((n, nch, window), dtype=torch.int32, device=dev)
    tiles = torch.empty((n, nch), dtype=torch.int32, device=dev)
    seg = torch.empty((n, 4 * max_words), dtype=torch.uint8, device=dev)
    err = lib.pack_windows_launch(
        codes.data_ptr(), lens.data_ptr(), ends.data_ptr(), n, k, max_words,
        windows.data_ptr(), tiles.data_ptr(), seg.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "pack_split", err)
    launches_windows += 1
    return seg, nbits


def pack_split(codes, lens, max_words: int, bit_offset: int = 38):
    """K4: `pack_windows`'s function, many blocks per slice placing with
    global atomics."""
    global launches_split
    check_slots((codes, lens), max_words, bit_offset, "pack_split")
    if lens.device.type == "cpu":
        return pack_raw_plain(codes, lens, max_words, bit_offset)
    lib = load_kernel()
    n, k = lens.shape
    dev = lens.device
    ends, nbits = _ends(lens, bit_offset)
    seg = torch.empty((n, 4 * max_words), dtype=torch.uint8, device=dev)
    err = lib.pack_split_launch(
        codes.data_ptr(), lens.data_ptr(), ends.data_ptr(), n, k, max_words,
        seg.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "pack_split", err)
    launches_split += 1
    return seg, nbits
