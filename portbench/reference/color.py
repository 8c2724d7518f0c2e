"""Studio-range BT.601 colour and 4:2:0 subsampling of RGB frames, in
plain torch int32 on the CPU.

The semantics of the JAX package's `ops/color.py::rgb_to_ycbcr_studio`
and `subsample_420` and of the encoder's `pad_to_macroblocks`, written
anew: the frames edge-padded to whole macroblocks first; each of Y, Cb
and Cr a weighted sum of R, G and B in fixed point with a rounding bias of
half its unit, an arithmetic right shift and its offset (16 for Y, 128
for Cb and Cr), clipped to u8; chroma the truncating mean of each 2 x 2.

`precision` names the fixed point: "fixed16" as the configuration states
(16 fractional bits, bias 1 << 15), or one step below for the benchmark's
control, "fixed8" (each coefficient rounded to 8 fractional bits, bias
1 << 7: the textbook 66, 129, 25 luma row).
"""

from __future__ import annotations

import numpy as np
import torch

# rows Y, Cb, Cr in 16 fractional bits: 65536 x 219/255 x (0.299, 0.587,
# 0.114) and the 224/255-scaled chroma rows
COEFFS16 = ((16830, 33039, 6417), (-9715, -19070, 28784), (28784, -24103, -4681))
OFFSETS = (16, 128, 128)


def coefficients(precision: str) -> tuple[tuple[tuple[int, ...], ...], int]:
    """-> (the three rows of coefficients, their fractional bits)."""
    if precision == "fixed16":
        return COEFFS16, 16
    if precision == "fixed8":
        return tuple(tuple(round(c / 256) for c in row) for row in COEFFS16), 8
    raise ValueError(f"unknown colour precision {precision!r}")


def pad_to_macroblocks(rgb: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) -> height and width edge-padded to multiples of 16."""
    h, w = rgb.shape[1:3]
    return np.pad(rgb, ((0, 0), (0, -h % 16), (0, -w % 16), (0, 0)), mode="edge")


def studio_ycbcr(rgb: torch.Tensor, precision: str = "fixed16"):
    """(..., H, W, 3) u8 -> Y, Cb, Cr (..., H, W) u8.  Each sum is built in
    place on contiguous int32 planes (a third of the time of one expression
    on strided views, on a CPU core)."""
    rows, bits = coefficients(precision)
    r, g, b = (c.to(torch.int32) for c in rgb.movedim(-1, 0).contiguous())
    out = []
    for (kr, kg, kb), off in zip(rows, OFFSETS):
        acc = r * kr
        acc.add_(g, alpha=kg).add_(b, alpha=kb).add_(1 << (bits - 1)).bitwise_right_shift_(bits)
        out.append(acc.add_(off).clamp_(0, 255).to(torch.uint8))
    return tuple(out)


def subsample(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) u8 -> (..., H // 2, W // 2) u8: the truncating mean of
    each 2 x 2 (an odd last row or column dropped)."""
    h, w = plane.shape[-2:]
    p = plane[..., :h - h % 2, :w - w % 2].to(torch.int32)
    return ((p[..., 0::2, 0::2] + p[..., 0::2, 1::2] + p[..., 1::2, 0::2] + p[..., 1::2, 1::2])
            >> 2).to(torch.uint8)


def planes_420(rgb: np.ndarray, precision: str = "fixed16"):
    """(B, H, W, 3) u8 RGB -> the macroblock-padded 4:2:0 planes Y (B, H', W'),
    Cb, Cr (B, H'/2, W'/2) u8, as numpy arrays."""
    y, cb, cr = studio_ycbcr(torch.from_numpy(pad_to_macroblocks(rgb)), precision)
    return y.numpy(), subsample(cb).numpy(), subsample(cr).numpy()
