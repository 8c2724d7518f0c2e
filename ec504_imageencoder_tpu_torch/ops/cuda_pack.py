"""Kernel B2: 4:1-fused VLC slots -> big-endian slice bytes + bit counts.

The CUDA kernel (`csrc/pack_fused4.cu`) replaces the Pallas kernel
`ec504_imageencoder_tpu/ops/pallas_pack.py::_fused4_kernel` as launched by
`pack_words_fused4_core(..., emit_be=True)`, plus the bitcast to bytes.
`pack_fused4_plain` is its plain PyTorch twin (`bitpack.pack_words4`,
the same <= 5-word split, `index_add_`ed into int64 words).

`pack_fused4` runs the twin for CPU tensors and the kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import pack_words4, words_to_bytes

# kernel launches since the last reset (launches for CPU tensors excluded)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "pack_fused4_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
}


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    return _build.load("pack_fused4", _ARGTYPES)


def pack_fused4_plain(v0, v1, v2, v3, flens, max_words: int, bit_offset: int = 38):
    """Plain twin of the kernel: same arguments, same outputs."""
    words, nbits = pack_words4(v0, v1, v2, v3, flens, max_words, bit_offset)
    return words_to_bytes(words), nbits.to(torch.int32)


def pack_fused4(v0, v1, v2, v3, flens, max_words: int, bit_offset: int = 38):
    """(n, KF) int32 fused slots (v0..v3: u32 words of values of flens
    <= 128 bits, most significant first) -> (seg (n, 4 * max_words) u8,
    nbits (n,) int32).

    seg holds the slice bit streams MSB first from bit `bit_offset` on,
    zero elsewhere; words past max_words are dropped, and nbits is the
    true bit count including bit_offset, even when it exceeds the buffer."""
    global launches
    vs = (v0, v1, v2, v3, flens)
    if flens.dim() != 2:
        raise ValueError(f"flens must be (n, KF), got {tuple(flens.shape)}")
    for t in vs:
        if t.dtype != torch.int32 or t.shape != flens.shape or t.device != flens.device:
            raise ValueError("v0..v3 and flens must be int32 (n, KF) on one device")
    if max_words <= 0 or bit_offset < 0:
        raise ValueError(f"bad max_words={max_words} / bit_offset={bit_offset}")
    if flens.device.type == "cpu":
        return pack_fused4_plain(*vs, max_words, bit_offset)
    if flens.device.type != "cuda":
        raise ValueError(f"unsupported device {flens.device}")
    if not all(t.is_contiguous() for t in vs):
        raise ValueError("pack_fused4 needs contiguous tensors")
    lib = load_kernel()
    n, kf = flens.shape
    seg = torch.empty((n, 4 * max_words), dtype=torch.uint8, device=flens.device)
    nbits = torch.empty((n,), dtype=torch.int32, device=flens.device)
    err = lib.pack_fused4_launch(
        *(t.data_ptr() for t in vs), n, kf, max_words, bit_offset,
        seg.data_ptr(), nbits.data_ptr(),
        flens.device.index, torch.cuda.current_stream(flens.device).cuda_stream,
    )
    _build.check(lib, "pack_fused4", err)
    launches += 1
    return seg, nbits
