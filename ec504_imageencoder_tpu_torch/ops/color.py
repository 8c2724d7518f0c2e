"""BT.601 colour conversion and 4:2:0 subsampling in int32.

Bit-identical to `ec504_imageencoder_tpu.ops.color` (`_ycbcr_studio_i32`,
`_ycbcr_full_i32`, `subsample_420`): 16-bit fixed point with a 1<<15
rounding bias and arithmetic right shifts, clipped to u8.
"""

from __future__ import annotations

import torch

_HALF = 1 << 15


def _u8(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(0, 255).to(torch.uint8)


def _ycbcr_full_i32(r, g, b):
    y = (19595 * r + 38470 * g + 7471 * b + _HALF) >> 16
    cb = ((-11059 * r - 21709 * g + 32768 * b + _HALF) >> 16) + 128
    cr = ((32768 * r - 27439 * g - 5329 * b + _HALF) >> 16) + 128
    return _u8(y), _u8(cb), _u8(cr)


def _ycbcr_studio_i32(r, g, b):
    # 65536 * 219/255 * (0.299, 0.587, 0.114) and 224/255 * Cb/Cr rows
    y = ((16830 * r + 33039 * g + 6417 * b + _HALF) >> 16) + 16
    cb = ((-9715 * r - 19070 * g + 28784 * b + _HALF) >> 16) + 128
    cr = ((28784 * r - 24103 * g - 4681 * b + _HALF) >> 16) + 128
    return _u8(y), _u8(cb), _u8(cr)


def rgb_to_ycbcr(rgb: torch.Tensor, color_range: str = "studio"):
    """(..., H, W, 3) u8 -> three (..., H, W) u8 planes."""
    if color_range not in ("studio", "full"):
        raise ValueError(
            f"color_range must be 'studio' or 'full', got {color_range!r}"
        )
    i = rgb.to(torch.int32)
    fn = _ycbcr_studio_i32 if color_range == "studio" else _ycbcr_full_i32
    return fn(i[..., 0], i[..., 1], i[..., 2])


def subsample_420(plane: torch.Tensor) -> torch.Tensor:
    """2x2 box average, truncating: (..., H, W) u8 -> (..., H//2, W//2) u8."""
    h, w = plane.shape[-2], plane.shape[-1]
    p = plane[..., : h - h % 2, : w - w % 2].to(torch.int32)
    s = p[..., 0::2, 0::2] + p[..., 0::2, 1::2] + p[..., 1::2, 0::2] + p[..., 1::2, 1::2]
    return (s >> 2).to(torch.uint8)
