"""The back half of the JPEG decode, on torch tensors of any device.

The port of the reference's `ec504_imageencoder_tpu/ops/jpeg_tpu.py`: the
functions keep its names and compute the same integers, so the coefficients
intake (`TorchMPEG1IntraEncoder.encode_from_coeffs`) decodes exactly as the
reference's native decoder (stb_image) does once the host has entropy
decoded the JPEG:

* `islow_idct`: the libjpeg "islow" integer IDCT at stb's fixed-point
  scales (column pass +512 >> 10, row pass +65536 + (128 << 17) >> 17);
* `upsample2x_triangular`: JFIF-centred triangular 2x chroma upsampling
  with the truncating >> 4 descale;
* `ycbcr_to_rgb_fixed`: 20-bit fixed-point YCbCr -> RGB, with the green
  term's `& 0xffff0000` truncation.

Everything is int32: products wrap as int32 products do in numpy, and `>>`
of a negative int32 is arithmetic in torch as in numpy, which the descales
rely on.  (torch cannot shift uint32 on the CPU, so nothing here is
unsigned.)  In the reference this is plain XLA, not a Pallas kernel; here
it is plain torch, on the card when the tensors are there.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def _f2f(x: float) -> int:
    return int(x * 4096 + 0.5)


def _idct_1d(s):
    """One 8-point islow pass.  s: sequence of 8 int32 tensors (same
    shape); returns (x0..x3, t0..t3) per jidctint's even/odd split."""
    s0, s1, s2, s3, s4, s5, s6, s7 = s
    p1 = (s2 + s6) * _f2f(0.5411961)
    u2 = p1 + s6 * _f2f(-1.847759065)
    u3 = p1 + s2 * _f2f(0.765366865)
    ev0 = (s0 + s4) * 4096
    ev1 = (s0 - s4) * 4096
    x0 = ev0 + u3
    x3 = ev0 - u3
    x1 = ev1 + u2
    x2 = ev1 - u2
    a0, a1, a2, a3 = s7, s5, s3, s1
    q3 = a0 + a2
    q4 = a1 + a3
    q1 = a0 + a3
    q2 = a1 + a2
    q5 = (q3 + q4) * _f2f(1.175875602)
    t0 = a0 * _f2f(0.298631336)
    t1 = a1 * _f2f(2.053119869)
    t2 = a2 * _f2f(3.072711026)
    t3 = a3 * _f2f(1.501321110)
    q1 = q5 + q1 * _f2f(-0.899976223)
    q2 = q5 + q2 * _f2f(-2.562915447)
    q3 = q3 * _f2f(-1.961570560)
    q4 = q4 * _f2f(-0.390180644)
    t3 = t3 + q1 + q4
    t2 = t2 + q2 + q3
    t1 = t1 + q2 + q4
    t0 = t0 + q1 + q3
    return x0, x1, x2, x3, t0, t1, t2, t3


def islow_idct(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 64) int dequantized natural-order coefficients -> (..., 8, 8)
    uint8 pixels, bit-exact against the native idct_block."""
    d = blocks.to(I32).reshape(blocks.shape[:-1] + (8, 8))
    # column pass: 1-D over rows, per column
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d([d[..., r, :] for r in range(8)])
    x0, x1, x2, x3 = x0 + 512, x1 + 512, x2 + 512, x3 + 512
    v = [(x0 + t3) >> 10, (x1 + t2) >> 10, (x2 + t1) >> 10, (x3 + t0) >> 10,
         (x3 - t0) >> 10, (x2 - t1) >> 10, (x1 - t2) >> 10, (x0 - t3) >> 10]
    # row pass: 1-D over columns, per row (v[k]: row k across columns)
    rows = torch.stack(v, dim=-2)
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d([rows[..., :, c] for c in range(8)])
    bias = 65536 + (128 << 17)
    x0, x1, x2, x3 = x0 + bias, x1 + bias, x2 + bias, x3 + bias
    o = [(x0 + t3) >> 17, (x1 + t2) >> 17, (x2 + t1) >> 17, (x3 + t0) >> 17,
         (x3 - t0) >> 17, (x2 - t1) >> 17, (x1 - t2) >> 17, (x0 - t3) >> 17]
    return torch.stack(o, dim=-1).clamp(0, 255).to(torch.uint8)  # (..., 8 rows, 8 cols)


def idct_plane(coeff_blocks: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(..., bh*bw, 64) coefficients -> (..., bh*8, bw*8) uint8 plane."""
    lead = coeff_blocks.shape[:-2]
    g = islow_idct(coeff_blocks).reshape(lead + (bh, bw, 8, 8))
    n = len(lead)
    return g.permute(*range(n), n, n + 2, n + 1, n + 3).reshape(lead + (bh * 8, bw * 8))


def _tri_axis_pairs(x: torch.Tensor, axis: int) -> torch.Tensor:
    """3*near + far along `axis`, interleaved 2x (JFIF-centred, edges
    clamped): out[2i] pairs (i, i-1), out[2i+1] pairs (i, i+1)."""
    axis %= x.dim()
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    st = torch.stack([3 * x + prev, 3 * x + nxt], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return st.reshape(shape)


def upsample2x_triangular(c: torch.Tensor) -> torch.Tensor:
    """(..., h, w) u8 chroma -> (..., 2h, 2w) u8, stb hv2 semantics."""
    t = _tri_axis_pairs(c.to(I32), -2)  # vertical, 2h x w
    o = _tri_axis_pairs(t, -1)          # horizontal
    return ((o + 8) >> 4).to(torch.uint8)


def ycbcr_to_rgb_fixed(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Full-resolution u8 planes -> (..., 3) u8 RGB, stb 20-bit fixed point."""

    def fx(v: float) -> int:
        return _f2f(v) << 8

    yf = (y.to(I32) << 20) + (1 << 19)
    cbi = cb.to(I32) - 128
    cri = cr.to(I32) - 128
    r = yf + cri * fx(1.40200)
    # the green cb term is truncated to its top 16 bits before the sum
    # (int & 0xffff0000; -65536 is the same mask in two's complement)
    gcb = (cbi * -fx(0.34414)) & -65536
    g = yf + cri * -fx(0.71414) + gcb
    b = yf + cbi * fx(1.77200)
    rgb = torch.stack([r >> 20, g >> 20, b >> 20], dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


def decode_rgb_from_planes(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """4:2:0 YCbCr planes (Y (..., h, w), chroma (..., ceil(h/2),
    ceil(w/2))) -> (..., h, w, 3) u8 RGB, pixel-identical to the native
    FULL decode (and therefore to stb_image)."""
    h, w = y.shape[-2], y.shape[-1]
    cbu = upsample2x_triangular(cb)[..., :h, :w]
    cru = upsample2x_triangular(cr)[..., :h, :w]
    return ycbcr_to_rgb_fixed(y, cbu, cru)


def decode_planes_from_coeffs(yc: torch.Tensor, cbc: torch.Tensor, crc: torch.Tensor,
                              h: int, w: int):
    """Dequantized coefficient blocks -> cropped YCbCr 4:2:0 planes.

    yc: (..., ceil(h/8)*ceil(w/8), 64); cbc/crc likewise for the chroma
    dims (ceil(h/2), ceil(w/2)).  Returns (y, cb, cr) u8 planes."""
    ch, cw = -(-h // 2), -(-w // 2)
    ybh, ybw = -(-h // 8), -(-w // 8)
    cbh, cbw = -(-ch // 8), -(-cw // 8)
    y = idct_plane(yc, ybh, ybw)[..., :h, :w]
    cb = idct_plane(cbc, cbh, cbw)[..., :ch, :cw]
    cr = idct_plane(crc, cbh, cbw)[..., :ch, :cw]
    return y, cb, cr


def decode_rgb_from_coeffs(yc: torch.Tensor, cbc: torch.Tensor, crc: torch.Tensor,
                           h: int, w: int) -> torch.Tensor:
    """The whole back half: coefficients -> RGB."""
    return decode_rgb_from_planes(*decode_planes_from_coeffs(yc, cbc, crc, h, w))
