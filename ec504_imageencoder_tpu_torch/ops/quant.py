"""The two quantizers of the reference, in exact integer division (the
reference's f32-divide-and-fixup exists only because integer division is
slow on a TPU).

* `quantize_intra`: ISO 11172-2 intra quantization, as in
  `models/mpeg1.py` of the reference.  DC: step 8, rounded, clipped to
  [0, 255].  AC: level = sign(F) * min(255, floor((16|F| + qW) / (2 qW)))
  with qW = qscale * W.
* `quantize`: compat mode, the reference's `ops/quant.py::quantize`.
* `exact_div_floor`: floor(a / q), which the reference computes by an f32
  divide and an integer fix-up; here the integer division itself, equal
  on the reference's domain (0 <= a < 2**23, q > 0).
* `dequantize`: the reconstruction multiply (image_processing.c:438-446).
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


def quantize(f: torch.Tensor, scaled_q: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int32 coefficients / (8, 8) int32 scaled JPEG matrix ->
    int32 levels, truncated toward zero and not clamped (C's `/` on the
    reference's integral doubles)."""
    return torch.div(f, scaled_q, rounding_mode="trunc")


def exact_div_floor(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """floor(a / q) for non-negative int32 a and positive int32 q."""
    return torch.div(a.to(torch.int32), q.to(torch.int32), rounding_mode="floor")


def dequantize(quantized: torch.Tensor, q_matrix: torch.Tensor) -> torch.Tensor:
    """levels * matrix in int32 (the reference C encoder multiplies by the
    unscaled base matrix; a correct decoder passes the scaled one)."""
    return quantized.to(torch.int32) * q_matrix.to(torch.int32)
