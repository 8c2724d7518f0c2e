"""BT.601 colour conversion and 4:2:0 subsampling.

* `rgb_to_ycbcr`, `subsample_420`: torch int32, bit-identical to the
  reference's `ops/color.py` (`_ycbcr_studio_i32`, `_ycbcr_full_i32`,
  `subsample_420`): 16-bit fixed point with a 1<<15 rounding bias and
  arithmetic right shifts, clipped to u8;
* `rgb_to_ycbcr_exact`: compat mode's host colour in numpy f64, the
  reference C encoder's double arithmetic with its (unsigned char)
  truncation (image_processing.c:68-110), which the `.bit` dumps hold;
* `upsample_420`, `ycbcr_to_rgb_f32`: the decoder's host half in numpy,
  the reference's `xp=np` forms with its f32 operations in its order.
"""

from __future__ import annotations

import numpy as np
import torch

_HALF = 1 << 15


def rgb_to_ycbcr_exact(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(..., H, W, 3) uint8 -> three (..., H, W) uint8 planes, C-double-exact."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = (0.299 * r + 0.587 * g + 0.114 * b).astype(np.uint8)
    cb = (128 - 0.168736 * r - 0.331264 * g + 0.5 * b).astype(np.uint8)
    cr = (128 + 0.5 * r - 0.418688 * g - 0.081312 * b).astype(np.uint8)
    return y, cb, cr


def upsample_420(plane: np.ndarray) -> np.ndarray:
    """Nearest-neighbour 2x replication (image_processing.c:607-638)."""
    return np.repeat(np.repeat(plane, 2, axis=-2), 2, axis=-1)


def ycbcr_to_rgb_f32(y, cb, cr, color_range: str = "full") -> np.ndarray:
    """BT.601 inverse for the verification decoder, in numpy f32
    (image_processing.c:678-686 constants; implemented correctly — the
    reference's own function reads Y/Cb/Cr all from the same buffer by
    mistake and is never called).

    color_range="studio" inverts rgb_to_ycbcr's studio range (16-235/16-240)."""
    if color_range not in ("studio", "full"):
        raise ValueError(
            f"color_range must be 'studio' or 'full', got {color_range!r}"
        )
    yf = y.astype(np.float32)
    cbf = cb.astype(np.float32) - 128.0
    crf = cr.astype(np.float32) - 128.0
    if color_range == "studio":
        yf = (yf - 16.0) * (255.0 / 219.0)
        cbf = cbf * (255.0 / 224.0)
        crf = crf * (255.0 / 224.0)
    r = yf + 1.402 * crf
    g = yf - 0.344136 * cbf - 0.714136 * crf
    b = yf + 1.772 * cbf
    return np.stack([np.clip(v, 0.0, 255.0).astype(np.uint8) for v in (r, g, b)], axis=-1)


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
