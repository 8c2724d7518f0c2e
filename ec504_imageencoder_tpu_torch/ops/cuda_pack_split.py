"""Kernels K3 and K4: raw VLC codes -> big-endian slice bytes + bit counts,
one slice spread over many CUDA blocks.

One CUDA source (`csrc/pack_split.cu`) replaces two Pallas kernels of
`ec504_imageencoder_tpu/ops/pallas_pack.py` that compute
`bitpack.pack_words` of raw codes of <= 32 bits, with the bitcast to
bytes behind them.  Both take the bit offsets' prefix sum inside the
kernels and write the bit counts themselves; nothing runs in front:

* `pack_split` (K4) replaces `_fused_kernel` (`pack_words_fused`, the
  reference's EC504_PACK=fused, B6g): one pass, one block per tile of
  4096 codes of a row, a decoupled look-back over per-tile status words
  for each tile's first bit; a tile stores the words only it touches and
  ORs its two edge words into the row, which its launcher zeroes;
* `pack_windows` (K3) replaces `_pack3_kernel` and its level-2 placement
  (`pack_words_pallas3`, EC504_PACK=pallas3, B6f): two levels and no
  global atomics.  Level 1 sums each chunk's lengths; level 2 places a
  chunk in shared memory and stores each word it owns (those whose last
  bit it holds) once, the leading bits read back from the codes before.

What bounds both on the H100 is bytes: 8 B read per code, the buffer
written once (K4 zeroes it first; K3 reads the lengths twice).  Any
max_words works (the TPU kernels' multiple-of-128 and window limits were
their tiling).  Their twin is `cuda_pack.pack_raw_plain`.  Each wrapper
runs the twin for CPU tensors and its kernel for CUDA tensors; there is
no other route.
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
_LLP = ctypes.POINTER(ctypes.c_longlong)
_LAUNCH = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]
_ARGTYPES = {
    "pack_windows_launch": _LAUNCH,
    "pack_split_launch": _LAUNCH,
    "pack_split_scratch": [_I, _I, _LLP, _LLP],
}


def load_kernel():
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("pack_split", _ARGTYPES)


def _launch(entry: str, codes, lens, max_words: int, bit_offset: int):
    """Run K3 ("pack_windows") or K4 ("pack_split") on CUDA tensors with
    the scratch it needs: K3's chunk totals, K4's status words."""
    lib = load_kernel()
    n, k = lens.shape
    dev = lens.device
    windows_bytes, split_bytes = ctypes.c_longlong(), ctypes.c_longlong()
    _build.check(lib, "pack_split", lib.pack_split_scratch(
        n, k, ctypes.byref(windows_bytes), ctypes.byref(split_bytes)))
    nbytes = (windows_bytes if entry == "pack_windows" else split_bytes).value
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    seg = torch.empty((n, 4 * max_words), dtype=torch.uint8, device=dev)
    nbits = torch.empty((n,), dtype=torch.int32, device=dev)
    err = getattr(lib, f"{entry}_launch")(
        codes.data_ptr(), lens.data_ptr(), n, k, max_words, bit_offset,
        scratch.data_ptr(), seg.data_ptr(), nbits.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "pack_split", err)
    return seg, nbits


def pack_windows(codes, lens, max_words: int, bit_offset: int = 38):
    """K3.  (n, K) int32 raw codes (u32 bits of <= 32-bit values) and
    lengths -> (seg (n, 4 * max_words) u8, nbits (n,) int32), as
    `cuda_pack.pack_raw`."""
    global launches_windows
    check_slots((codes, lens), max_words, bit_offset, "pack_windows")
    if lens.device.type == "cpu":
        return pack_raw_plain(codes, lens, max_words, bit_offset)
    out = _launch("pack_windows", codes, lens, max_words, bit_offset)
    launches_windows += 1
    return out


def pack_split(codes, lens, max_words: int, bit_offset: int = 38):
    """K4: `pack_windows`'s function in one pass, many blocks per slice
    chained by a decoupled look-back."""
    global launches_split
    check_slots((codes, lens), max_words, bit_offset, "pack_split")
    if lens.device.type == "cpu":
        return pack_raw_plain(codes, lens, max_words, bit_offset)
    out = _launch("pack_split", codes, lens, max_words, bit_offset)
    launches_split += 1
    return out
