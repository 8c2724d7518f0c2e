"""Kernels B2, B6c, K1 and K2: VLC slots -> big-endian slice bytes + bit counts.

One CUDA source (`csrc/pack_fused4.cu`, a kernel templated on the slots
it reads) replaces five Pallas kernels of
`ec504_imageencoder_tpu/ops/pallas_pack.py`, each with the bitcast to
bytes behind it:

* `pack_fused4` (B2) replaces `_fused4_kernel` as launched by
  `pack_words_fused4_core(..., emit_be=True)`: 4:1-fused slots of <= 128
  bits.  `pack_fused4_plain` is its plain PyTorch twin
  (`bitpack.pack_words4`, the same <= 5-word split, `index_add_`ed into
  int64 words).
* `pack_fused8` (B6c) replaces `_fused8_kernel` (`pack_words_fused8_core`,
  the reference's EC504_FUSE=8 route): 8:1-fused slots of <= 256 bits,
  each spanning <= 9 words.  Any max_words works (the TPU kernel's
  multiple-of-128 limit was its tiling).  Twin: `pack_fused8_plain`
  (`bitpack.pack_words8`).
* `pack_raw` (K1) packs raw codes of <= 32 bits (`bitpack.pack_words`)
  and replaces both `_pack_kernel` (`pack_words_pallas`, the reference's
  EC504_PACK=pallas1, B6d) and `_pack2_kernel` (`pack_words_pallas2`,
  B6e, which nothing calls): the two differ only in how they lay the
  same placement on the TPU's matrix unit.  Twin: `pack_raw_plain`.
* `pack_pairs` (K2) packs the same codes fused 2:1 as it loads them,
  replacing `_fused2w_kernel` and the `_fuse2_32` before it
  (`pack_words_fused2w`, EC504_PACK=fused2w, B6h).  Twin:
  `pack_pairs_plain` (`bitpack.fuse2`, then `pack_words2`).

`checks=True` runs the checked form, which replaces the debug outputs of
`_fused4_kernel` (`pack_words_fused4_core(..., debug=True)`) and also
returns per-slice violation counts: fused lengths outside [0, 128] and
overlapping bits.  The length term is exact; the overlap term is exact
only as zero / nonzero (the kernel counts the placements that found bits
already set, which depends on the order of its atomics; the twin counts
the words whose contributions overlap).

Each wrapper runs its twin for CPU tensors and its kernel for CUDA
tensors; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.bitpack import (
    pack_words,
    pack_words2,
    pack_words4,
    pack_words8,
    words_to_bytes,
)

# kernel launches since the last reset: B2 unchecked and checked, B6c, K1,
# K2 (launches for CPU tensors excluded)
launches = 0
launches_checked = 0
launches8 = 0
launches_raw = 0
launches_pairs = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "pack_fused4_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "pack_fused8_launch": [*[_P] * 9, _I, _I, _I, _I, _P, _P, _I, _P],
    "pack_raw_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "pack_pairs_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "pack_fused4_tile": [],
}


def load_kernel():
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("pack_fused4", _ARGTYPES)


def fused4_tile() -> int:
    """B2's slots per tile (threads per block x slots per thread), as the
    built kernel has it: where the tile edges that its tests cover lie."""
    return load_kernel().pack_fused4_tile()


def pack_fused4_plain(v0, v1, v2, v3, flens, max_words: int, bit_offset: int = 38,
                      checks: bool = False):
    """Plain twin of the kernel: same arguments, same outputs (with
    overlapping bits its words hold sums where the kernel's hold ORs)."""
    out = pack_words4(v0, v1, v2, v3, flens, max_words, bit_offset, checks=checks)
    head = (words_to_bytes(out[0]), out[1].to(torch.int32))
    return head + (out[2].to(torch.int32),) if checks else head


def check_slots(vs, max_words: int, bit_offset: int, name: str) -> None:
    """Raise unless vs (word planes, then the lengths) are int32 (n, KF)
    tensors on one device, contiguous on a CUDA device."""
    flens = vs[-1]
    if flens.dim() != 2:
        raise ValueError(f"flens must be (n, KF), got {tuple(flens.shape)}")
    for t in vs:
        if t.dtype != torch.int32 or t.shape != flens.shape or t.device != flens.device:
            raise ValueError("the word planes and flens must be int32 (n, KF) on one device")
    if max_words <= 0 or bit_offset < 0:
        raise ValueError(f"bad max_words={max_words} / bit_offset={bit_offset}")
    if flens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flens.device}")
    if flens.device.type == "cuda" and not all(t.is_contiguous() for t in vs):
        raise ValueError(f"{name} needs contiguous tensors")


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
    check_slots(vs, max_words, bit_offset, "pack_fused4")
    if flens.device.type == "cpu":
        return pack_fused4_plain(*vs, max_words, bit_offset, checks)
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


def pack_fused8_plain(words, flens, max_words: int, bit_offset: int = 38):
    """Plain twin of B6c: same arguments, same outputs."""
    out, nbits = pack_words8(words, flens, max_words, bit_offset)
    return words_to_bytes(out), nbits.to(torch.int32)


def pack_fused8(words, flens, max_words: int, bit_offset: int = 38):
    """B6c.  words: 8 (n, KF) int32 word planes (u32 words of values of
    flens <= 256 bits, most significant first); flens (n, KF) int32 ->
    (seg (n, 4 * max_words) u8, nbits (n,) int32), as `pack_fused4`."""
    global launches8
    vs = (*words, flens)
    if len(vs) != 9:
        raise ValueError(f"pack_fused8 takes 8 word planes, got {len(vs) - 1}")
    check_slots(vs, max_words, bit_offset, "pack_fused8")
    if flens.device.type == "cpu":
        return pack_fused8_plain(words, flens, max_words, bit_offset)
    lib = load_kernel()
    n, kf = flens.shape
    seg = torch.empty((n, 4 * max_words), dtype=torch.uint8, device=flens.device)
    nbits = torch.empty((n,), dtype=torch.int32, device=flens.device)
    err = lib.pack_fused8_launch(
        *(t.data_ptr() for t in vs), n, kf, max_words, bit_offset,
        seg.data_ptr(), nbits.data_ptr(),
        flens.device.index, torch.cuda.current_stream(flens.device).cuda_stream,
    )
    _build.check(lib, "pack_fused4", err)
    launches8 += 1
    return seg, nbits


def pack_raw_plain(codes, lens, max_words: int, bit_offset: int = 38):
    """Plain twin of K1 (and of K3 and K4): same arguments, same outputs."""
    out, nbits = pack_words(codes, lens, max_words, bit_offset)
    return words_to_bytes(out), nbits.to(torch.int32)


def pack_pairs_plain(codes, lens, max_words: int, bit_offset: int = 38):
    """Plain twin of K2: same arguments, same outputs."""
    out, nbits = pack_words2(codes, lens, max_words, bit_offset)
    return words_to_bytes(out), nbits.to(torch.int32)


def _raw_launch(entry: str, codes, lens, max_words: int, bit_offset: int):
    lib = load_kernel()
    n, k = lens.shape
    seg = torch.empty((n, 4 * max_words), dtype=torch.uint8, device=lens.device)
    nbits = torch.empty((n,), dtype=torch.int32, device=lens.device)
    err = getattr(lib, f"{entry}_launch")(
        codes.data_ptr(), lens.data_ptr(), n, k, max_words, bit_offset,
        seg.data_ptr(), nbits.data_ptr(),
        lens.device.index, torch.cuda.current_stream(lens.device).cuda_stream,
    )
    _build.check(lib, "pack_fused4", err)
    return seg, nbits


def pack_raw(codes, lens, max_words: int, bit_offset: int = 38):
    """K1.  (n, K) int32 raw codes (u32 bits of <= 32-bit values) and
    lengths -> (seg (n, 4 * max_words) u8, nbits (n,) int32), as
    `pack_fused4`."""
    global launches_raw
    check_slots((codes, lens), max_words, bit_offset, "pack_raw")
    if lens.device.type == "cpu":
        return pack_raw_plain(codes, lens, max_words, bit_offset)
    out = _raw_launch("pack_raw", codes, lens, max_words, bit_offset)
    launches_raw += 1
    return out


def pack_pairs(codes, lens, max_words: int, bit_offset: int = 38):
    """K2: `pack_raw`'s function, the codes fused 2:1 as they are loaded."""
    global launches_pairs
    check_slots((codes, lens), max_words, bit_offset, "pack_pairs")
    if lens.device.type == "cpu":
        return pack_pairs_plain(codes, lens, max_words, bit_offset)
    out = _raw_launch("pack_pairs", codes, lens, max_words, bit_offset)
    launches_pairs += 1
    return out
