"""The DCTs of the reference's `ops/dct.py`.

* `aan_dct`: the exact int32 AAN transform, bit-identical to the
  reference's.  Same constants, same arithmetic right shifts (torch `>>`
  on int32 is arithmetic, as in numpy, XLA and nvcc) and same rounding
  biases as `ec504_imageencoder_tpu.ops.dct.aan_dct` and the in-kernel
  `_aan_f_rows_a` of `ops/pallas_vlc.py`.  int32 products wrap exactly as
  they do there.
* `aan_idct`: the reference C encoder's latent inverse (the forward
  butterfly, columns then rows, with its clamps and u8 truncations), in
  torch int32 likewise.
* `matmul_dct`: the f32 orthonormal DCT of the high-quality path
  (quality >= 70), on the basis `dct_matrix_f32`.
* `naive_dct_f64`, `naive_idct_f64`: the textbook f64 DCT of one block
  (image_processing.c:157-183, 452-480), a host numpy oracle for tests.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 1004   # cos(pi/16)  << 10
_S1 = 200    # sin(pi/16)  << 10
_C3 = 851    # cos(3pi/16) << 10
_S3 = 569    # sin(3pi/16) << 10
_R2C6 = 554  # sqrt2*cos(6pi/16) << 10
_R2S6 = 1337 # sqrt2*sin(6pi/16) << 10
_R2 = 181    # sqrt2 << 7


def _aan_butterfly(a):
    """Stages 1-3 of the 8-point AAN transform on a list of 8 int32 tensors.

    Returns the pre-descale nodes (e0, e4, e2, e6, o1, o5, o7, o3)."""
    a0, a1, a2, a3, a4, a5, a6, a7 = a
    s8, d0 = a7 + a0, a0 - a7
    s7, d1 = a1 + a6, a1 - a6
    s6, d2 = a2 + a5, a2 - a5
    s5, d3 = a3 + a4, a3 - a4
    e_x4, e_x8 = s8 + s5, s8 - s5
    e_x5, e_x7 = s7 + s6, s7 - s6
    t6 = _C1 * (d1 + d2)
    o_x2 = (-_S1 - _C1) * d2 + t6
    o_x1 = (_S1 - _C1) * d1 + t6
    t6b = _C3 * (d0 + d3)
    o_x3 = (-_S3 - _C3) * d3 + t6b
    o_x0 = (_S3 - _C3) * d0 + t6b
    e0 = e_x4 + e_x5
    e4 = e_x4 - e_x5
    t5 = _R2C6 * (e_x7 + e_x8)
    e6 = (-_R2S6 - _R2C6) * e_x7 + t5
    e2 = (_R2S6 - _R2C6) * e_x8 + t5
    return e0, e4, e2, e6, o_x3 + o_x1, o_x0 + o_x2, o_x3 - o_x1, o_x0 - o_x2


def _first_pass(a):
    """The butterfly of 8 int32 tensors and its first-pass descale, outputs
    0..7 in order."""
    e0, e4, e2, e6, o1, o5, o7, o3 = _aan_butterfly(a)
    return [e0, (o1 + o5) >> 10, e2 >> 10, (o7 * _R2) >> 17,
            e4, (o3 * _R2) >> 17, e6 >> 10, (o1 - o5) >> 10]


def aan_dct(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) pixel blocks -> (..., 8v, 8u) int32 coefficients (x8)."""
    x = blocks.to(torch.int32)
    # row pass
    r = torch.stack(_first_pass([x[..., :, k] for k in range(8)]), dim=-1)
    # column pass
    e0, e4, e2, e6, o1, o5, o7, o3 = _aan_butterfly([r[..., k, :] for k in range(8)])
    out = [
        (e0 + 16) >> 3,
        (o1 + o5 + 16384) >> 13,
        (e2 + 16384) >> 13,
        ((o7 >> 8) * _R2 + 8192) >> 12,
        (e4 + 16) >> 3,
        ((o3 >> 8) * _R2 + 8192) >> 12,
        (e6 + 16384) >> 13,
        (o1 - o5 + 16384) >> 13,
    ]
    return torch.stack(out, dim=-2)


def aan_idct(dct_blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) coefficients -> (..., 8, 8) u8: the reference C
    encoder's AAN "inverse" (image_processing.c:492-603), which reuses the
    forward butterfly (columns, then rows without the descale), clamps
    outputs 0 and 4 to [0, 255] and truncates the others to their low
    byte.  Kept for parity; it is not a mathematically correct IDCT."""
    x = dct_blocks.to(torch.int32)
    # column pass
    c = torch.stack(_first_pass([x[..., k, :] for k in range(8)]), dim=-2)
    # row pass
    e0, e4, e2, e6, o1, o5, o7, o3 = _aan_butterfly([c[..., :, k] for k in range(8)])
    out = [
        e0.clamp(0, 255),
        ((o1 + o5) >> 10) & 0xFF,
        (e2 >> 10) & 0xFF,
        ((o7 * _R2) >> 17) & 0xFF,
        e4.clamp(0, 255),
        ((o3 * _R2) >> 17) & 0xFF,
        (e6 >> 10) & 0xFF,
        ((o1 - o5) >> 10) & 0xFF,
    ]
    return torch.stack(out, dim=-1).to(torch.uint8)


def _naive_basis():
    n = 8
    y = np.arange(n)
    basis = np.cos((2 * y[:, None] + 1) * np.arange(n)[None, :] * np.pi / (2 * n))
    cu = np.where(np.arange(n) == 0, np.sqrt(1 / n), np.sqrt(2 / n))
    return basis, cu[:, None] * cu[None, :]


def naive_dct_f64(block: np.ndarray) -> np.ndarray:
    """One 8x8 block -> its orthonormal f64 DCT-II, dct[v, u] (vertical,
    horizontal frequency), unscaled (no x8)."""
    basis, cc = _naive_basis()
    return cc * (basis.T @ block.reshape(8, 8).astype(np.float64) @ basis)


def naive_idct_f64(dct_block: np.ndarray) -> np.ndarray:
    """Inverse of `naive_dct_f64`, rounded (half to even, as np.round) and
    clamped to u8 (the reference's round and clamp)."""
    basis, cc = _naive_basis()
    pix = basis @ (cc * dct_block.reshape(8, 8).astype(np.float64)) @ basis.T
    return np.clip(np.round(pix), 0, 255).astype(np.uint8)


def dct_matrix_f32() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D (f32): coeffs = D @ block @ D.T
    (the reference's `ops/dct.py::dct_matrix_f32`, the same f32 numbers)."""
    n = 8
    k = np.arange(n)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / (2 * n))
    d *= np.where(k[:, None] == 0, np.sqrt(1 / n), np.sqrt(2 / n))
    return d.astype(np.float32)


_D = torch.from_numpy(dct_matrix_f32())


def matmul_dct(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) pixel blocks -> (..., 8v, 8u) int32: the orthonormal f32
    DCT D @ X @ D.T of the reference's `ops/dct.py::matmul_dct`, rounded
    half away from zero (not half to even, as `torch.round` would).

    The arithmetic is the reference's host einsum (numpy's
    "vy,...yx,ux->...vu") operation for operation: each coefficient sums
    (d[v, y] * x[y, x]) * d[u, x] over y, then x, in f32, every product
    and every sum rounded on its own.  Each step is a separate elementwise
    op: no GEMM, no fused multiply-add and no reduction kernel whose order
    could depend on the shape.  So the bits are numpy's, on the CPU and on
    a GPU alike, for every batch split, and no TF32 or
    float32-matmul-precision setting can change them.  (The integer DCT
    coefficients often sit exactly on a .5 tie, which each f32
    formulation breaks its own way; matching one reference's breaks keeps
    the port's bytes equal to it.)"""
    d = _D.to(blocks.device)
    x = blocks.to(torch.float32)
    f = None
    for y in range(8):
        p = d[:, y, None] * x[..., y:y + 1, :]   # p[..., v, x] = d[v, y] * x[..., y, x]
        for k in range(8):
            t = p[..., :, k:k + 1] * d[:, k]     # t[..., v, u] = p[..., v, k] * d[u, k]
            f = t if f is None else f.add_(t)
    return torch.where(f >= 0, torch.floor(f + 0.5), torch.ceil(f - 0.5)).to(torch.int32)
