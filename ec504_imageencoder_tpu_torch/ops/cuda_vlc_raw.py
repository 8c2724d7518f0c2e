"""Kernel B6a: 4:2:0 planes -> raw VLC slots and the DCT-magnitude guard.

The raw-slot route of the sanitizer (`debug_checks`) for the integer AAN
DCT.  The CUDA kernel (B1's template in `csrc/vlc_fused4.cu`, loaded by
`cuda_vlc.load_kernel`) replaces the Pallas kernel
`ec504_imageencoder_tpu/ops/pallas_vlc.py::_vlc_blocks_kernel` (launched
by `vlc_from_blocks_tpu`) together with the blockize in front of it, and
carries the DCT-magnitude guard of the reference's `_vlc_blocks_core`
debug form.  `vlc_raw_plain` is its plain PyTorch twin, B1's twin without
the fusion (`cuda_vlc.block_slots`).

`vlc_raw` runs the twin for CPU tensors and the kernel for CUDA tensors;
there is no other route.
"""

from __future__ import annotations

import torch

from ec504_imageencoder_tpu_torch.ops import _build, cuda_vlc
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts, block_slots, check_planes, to_i32_bits

# kernel launches since the last reset (launches for CPU tensors excluded)
launches = 0

FMAX = 1 << 19  # the guard: the reference's quantizer is exact below this |F|


def vlc_raw_plain(y, cb, cr, qw, luts: Luts):
    """Plain twin of the kernel: same arguments, same outputs."""
    codes, lens, f = block_slots(y, cb, cr, qw, luts)
    r = codes.shape[0]
    big = (f.abs().amax(dim=(-2, -1)) >= FMAX).reshape(r, -1).sum(dim=1)
    return (to_i32_bits(codes.transpose(1, 2)).contiguous(),
            lens.transpose(1, 2).to(torch.int32).contiguous(),
            big.to(torch.int32))


def vlc_raw(y, cb, cr, qw, luts: Luts):
    """Planes y (B, H, W) u8, cb/cr (B, H/2, W/2) u8 (H, W multiples of 16),
    qw (8, 8) int32 = qscale * intra matrix ->
    (codes, lens, dct_viol): codes and lens (B * H/16, 64, 6 * W/16) int32,
    slot k of block n of a slice row at [row, k, n] (codes hold u32 bits,
    none above their length on healthy input), and dct_viol (B * H/16,)
    int32, the blocks of each row whose largest |AAN coefficient| reaches
    2^19 (0 for any u8 input)."""
    global launches
    check_planes(y, cb, cr, qw, luts)
    if y.device.type == "cpu":
        return vlc_raw_plain(y, cb, cr, qw, luts)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    tensors = (y, cb, cr, qw, *luts)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("vlc_raw needs contiguous tensors")
    lib = cuda_vlc.load_kernel()
    bsz, h, w = y.shape
    r, nb = bsz * (h // 16), (w // 16) * 6
    out = torch.empty((2, r, 64, nb), dtype=torch.int32, device=y.device)
    dct_viol = torch.zeros((r,), dtype=torch.int32, device=y.device)  # the kernel adds to it
    err = lib.vlc_raw_launch(
        *(t.data_ptr() for t in (y, cb, cr)), bsz, h, w,
        *(t.data_ptr() for t in (qw, *luts)), out.data_ptr(), dct_viol.data_ptr(),
        y.device.index, torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, "vlc_fused4", err)
    launches += 1
    return out[0], out[1], dct_viol
