"""The back half of a JPEG decode in plain numpy: dequantized coefficients
to cropped 4:2:0 planes by the libjpeg "islow" integer IDCT at stb_image's
fixed-point scales (column pass +512 >> 10, row pass +65536 + (128 << 17)
>> 17), clamped to u8.

A frozen copy of the JAX package's `ops/jpeg_tpu.py` (`xp=np`) arithmetic.
`dtype` is the arithmetic: int32 as the configuration states, or int16
for the benchmark's control.
"""

from __future__ import annotations

import numpy as np


def _f2f(x: float) -> int:
    return int(x * 4096 + 0.5)


def _idct_1d(s):
    s0, s1, s2, s3, s4, s5, s6, s7 = s
    p1 = (s2 + s6) * _f2f(0.5411961)
    u2 = p1 + s6 * _f2f(-1.847759065)
    u3 = p1 + s2 * _f2f(0.765366865)
    ev0, ev1 = (s0 + s4) * 4096, (s0 - s4) * 4096
    x0, x3, x1, x2 = ev0 + u3, ev0 - u3, ev1 + u2, ev1 - u2
    a0, a1, a2, a3 = s7, s5, s3, s1
    q3, q4, q1, q2 = a0 + a2, a1 + a3, a0 + a3, a1 + a2
    q5 = (q3 + q4) * _f2f(1.175875602)
    t0, t1 = a0 * _f2f(0.298631336), a1 * _f2f(2.053119869)
    t2, t3 = a2 * _f2f(3.072711026), a3 * _f2f(1.501321110)
    q1 = q5 + q1 * _f2f(-0.899976223)
    q2 = q5 + q2 * _f2f(-2.562915447)
    q3 = q3 * _f2f(-1.961570560)
    q4 = q4 * _f2f(-0.390180644)
    return x0, x1, x2, x3, t0 + q1 + q3, t1 + q2 + q4, t2 + q2 + q3, t3 + q1 + q4


def islow_idct(blocks: np.ndarray, dtype=np.int32) -> np.ndarray:
    """(..., 64) natural-order coefficients -> (..., 8, 8) u8 pixels."""
    d = blocks.astype(dtype).reshape(blocks.shape[:-1] + (8, 8))
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d([d[..., r, :] for r in range(8)])
    x0, x1, x2, x3 = x0 + 512, x1 + 512, x2 + 512, x3 + 512
    rows = np.stack([(x0 + t3) >> 10, (x1 + t2) >> 10, (x2 + t1) >> 10, (x3 + t0) >> 10,
                     (x3 - t0) >> 10, (x2 - t1) >> 10, (x1 - t2) >> 10, (x0 - t3) >> 10], axis=-2)
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d([rows[..., :, c] for c in range(8)])
    bias = np.array(65536 + (128 << 17)).astype(dtype)  # wraps in int16
    x0, x1, x2, x3 = x0 + bias, x1 + bias, x2 + bias, x3 + bias
    out = np.stack([(x0 + t3) >> 17, (x1 + t2) >> 17, (x2 + t1) >> 17, (x3 + t0) >> 17,
                    (x3 - t0) >> 17, (x2 - t1) >> 17, (x1 - t2) >> 17, (x0 - t3) >> 17], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _plane(coeffs, bh: int, bw: int, dtype):
    lead = coeffs.shape[:-2]
    px = islow_idct(coeffs, dtype).reshape(lead + (bh, bw, 8, 8))
    return px.swapaxes(-3, -2).reshape(lead + (bh * 8, bw * 8))


def planes_from_coeffs(yc, cbc, crc, height: int, width: int, dtype=np.int32):
    """(B, blocks, 64) coefficients per component -> Y (B, height, width)
    and Cb, Cr (B, ceil(height/2), ceil(width/2)) u8 planes."""
    ch, cw = -(-height // 2), -(-width // 2)
    y = _plane(yc, -(-height // 8), -(-width // 8), dtype)[..., :height, :width]
    cb = _plane(cbc, -(-ch // 8), -(-cw // 8), dtype)[..., :ch, :cw]
    cr = _plane(crc, -(-ch // 8), -(-cw // 8), dtype)[..., :ch, :cw]
    return y, cb, cr
