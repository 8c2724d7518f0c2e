"""Kernel B2: 4:1-fused VLC slots -> big-endian slice bytes + bit counts.

The CUDA kernel (`csrc/pack_fused4.cu`) replaces the Pallas kernel
`ec504_imageencoder_tpu/ops/pallas_pack.py::_fused4_kernel` as launched by
`pack_words_fused4_core(..., emit_be=True)`, plus the bitcast to bytes.
`pack_fused4_plain` is its plain PyTorch twin (`bitpack.pack_words4`,
the same <= 5-word split, `index_add_`ed into int64 words).

`checks=True` runs the checked form, which replaces the debug outputs of
`_fused4_kernel` (`pack_words_fused4_core(..., debug=True)`) and also
returns per-slice violation counts: fused lengths outside [0, 128] and
overlapping bits.  The length term is exact; the overlap term is exact
only as zero / nonzero (the kernel counts the placements that found bits
already set, which depends on the order of its atomics; the twin counts
the words whose contributions overlap).

`pack_fused4` runs the twin for CPU tensors and the kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import pack_words4, words_to_bytes

# kernel launches since the last reset, unchecked and checked (launches
# for CPU tensors excluded)
launches = 0
launches_checked = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "pack_fused4_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
}


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    return _build.load("pack_fused4", _ARGTYPES)


def pack_fused4_plain(v0, v1, v2, v3, flens, max_words: int, bit_offset: int = 38,
                      checks: bool = False):
    """Plain twin of the kernel: same arguments, same outputs (with
    overlapping bits its words hold sums where the kernel's hold ORs)."""
    out = pack_words4(v0, v1, v2, v3, flens, max_words, bit_offset, checks=checks)
    head = (words_to_bytes(out[0]), out[1].to(torch.int32))
    return head + (out[2].to(torch.int32),) if checks else head


def pack_fused4(v0, v1, v2, v3, flens, max_words: int, bit_offset: int = 38,
                checks: bool = False):
    """(n, KF) int32 fused slots (v0..v3: u32 words of values of flens
    <= 128 bits, most significant first) -> (seg (n, 4 * max_words) u8,
    nbits (n,) int32), and with `checks` viol (n,) int32 (0 on healthy
    slots; see the module docstring).

    seg holds the slice bit streams MSB first from bit `bit_offset` on,
    zero elsewhere; words past max_words are dropped, and nbits is the
    true bit count including bit_offset, even when it exceeds the buffer."""
    global launches, launches_checked
    vs = (v0, v1, v2, v3, flens)
    if flens.dim() != 2:
        raise ValueError(f"flens must be (n, KF), got {tuple(flens.shape)}")
    for t in vs:
        if t.dtype != torch.int32 or t.shape != flens.shape or t.device != flens.device:
            raise ValueError("v0..v3 and flens must be int32 (n, KF) on one device")
    if max_words <= 0 or bit_offset < 0:
        raise ValueError(f"bad max_words={max_words} / bit_offset={bit_offset}")
    if flens.device.type == "cpu":
        return pack_fused4_plain(*vs, max_words, bit_offset, checks)
    if flens.device.type != "cuda":
        raise ValueError(f"unsupported device {flens.device}")
    if not all(t.is_contiguous() for t in vs):
        raise ValueError("pack_fused4 needs contiguous tensors")
    lib = load_kernel()
    n, kf = flens.shape
    seg = torch.empty((n, 4 * max_words), dtype=torch.uint8, device=flens.device)
    nbits = torch.empty((n,), dtype=torch.int32, device=flens.device)
    viol = torch.empty((n,), dtype=torch.int32, device=flens.device) if checks else None
    err = lib.pack_fused4_launch(
        *(t.data_ptr() for t in vs), n, kf, max_words, bit_offset,
        seg.data_ptr(), nbits.data_ptr(), None if viol is None else viol.data_ptr(),
        flens.device.index, torch.cuda.current_stream(flens.device).cuda_stream,
    )
    _build.check(lib, "pack_fused4", err)
    if checks:
        launches_checked += 1
        return seg, nbits, viol
    launches += 1
    return seg, nbits
