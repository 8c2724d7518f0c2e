"""ISO 11172-2 intra quantization, as in `models/mpeg1.py` of the reference.

DC: step 8, rounded, clipped to [0, 255].  AC: level = sign(F) *
min(255, floor((16|F| + qW) / (2 qW))) with qW = qscale * W.  Exact
integer floor division (the reference's f32-divide-and-fixup exists only
because integer division is slow on a TPU).
"""

from __future__ import annotations

import torch


def quantize_intra(f: torch.Tensor, qw: torch.Tensor):
    """(..., 8, 8) int32 coefficients, (8, 8) int32 qscale*W ->
    (dc (...,) int32, levels (..., 8, 8) int32)."""
    dc = ((f[..., 0, 0] + 4) >> 3).clamp(0, 255)
    num = 16 * f.abs() + qw
    mag = torch.div(num, 2 * qw, rounding_mode="floor")
    return dc, torch.sign(f) * mag.clamp(0, 255)
