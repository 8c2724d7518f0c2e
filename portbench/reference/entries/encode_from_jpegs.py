"""The reference of `encode_from_jpegs` on the `jpeg_restart` files: the
coefficients the generator coded, through stb_image's integer IDCT
(`stbi__idct_block`: `reference/jpeg.py`'s islow arithmetic at stb's
fixed-point scales) to the 4:2:0 planes, then as `encode_from_planes`.
It does not decode the files' bytes: `tests/test_torch_jpeg_bytes.py`
holds the port's decoder to the generator's coefficients.  A stamped call
codes anew the three macroblock rows whose segments its stamp moved, from
the coefficient rows that moved there (each block's IDCT stands alone).

The control decodes with libjpeg's jidctint (`islow`: 13-bit constants,
two extra bits between the passes, rounding descales) in place of stb's
IDCT: the same algorithm at other scales, which moves some pixels by one.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import jpeg, mpeg1
from portbench.reference.entries import encode_from_planes
from portbench.traffic.jpeg_coeffs import block_rows
from portbench.traffic.jpeg_restart import cycles

CONST_BITS, PASS1_BITS = 13, 2


def nominal(mix: dict) -> dict:
    return {"dct": mpeg1.dct_precision(mix["quality"]), "idct": "stb"}


def _fix(x: float) -> int:
    return int(x * (1 << CONST_BITS) + 0.5)


def _jidctint_1d(s):
    """One pass of libjpeg's jidctint.c on eight coefficient vectors ->
    (tmp10, tmp11, tmp12, tmp13, tmp0..tmp3), outputs k and 7 - k being
    even[k] +- odd[3 - k]."""
    z1 = (s[2] + s[6]) * _fix(0.541196100)
    tmp2 = z1 + s[6] * -_fix(1.847759065)
    tmp3 = z1 + s[2] * _fix(0.765366865)
    tmp0, tmp1 = (s[0] + s[4]) << CONST_BITS, (s[0] - s[4]) << CONST_BITS
    even = (tmp0 + tmp3, tmp1 + tmp2, tmp1 - tmp2, tmp0 - tmp3)
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _fix(1.175875602)
    t0, t1 = t0 * _fix(0.298631336), t1 * _fix(2.053119869)
    t2, t3 = t2 * _fix(3.072711026), t3 * _fix(1.501321110)
    z1, z2 = z1 * -_fix(0.899976223), z2 * -_fix(2.562915447)
    z3, z4 = z3 * -_fix(1.961570560) + z5, z4 * -_fix(0.390180644) + z5
    odd = (t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4)
    return even, odd


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def jidctint(blocks: np.ndarray) -> np.ndarray:
    """(..., 64) dequantized natural-order coefficients -> (..., 8, 8) u8
    pixels by libjpeg's jidctint.c (the range limit as a clamp)."""
    d = blocks.astype(np.int64).reshape(blocks.shape[:-1] + (8, 8))
    even, odd = _jidctint_1d([d[..., r, :] for r in range(8)])
    n = CONST_BITS - PASS1_BITS
    cols = [_descale(even[k] + odd[3 - k], n) for k in range(4)]
    cols += [_descale(even[3 - k] - odd[k], n) for k in range(4)]
    ws = np.stack(cols, axis=-2)
    even, odd = _jidctint_1d([ws[..., :, c] for c in range(8)])
    n = CONST_BITS + PASS1_BITS + 3
    out = [_descale(even[k] + odd[3 - k], n) for k in range(4)]
    out += [_descale(even[3 - k] - odd[k], n) for k in range(4)]
    return np.clip(np.stack(out, axis=-1) + 128, 0, 255).astype(np.uint8)


def _planes(yc, cbc, crc, height: int, width: int, idct: str):
    if idct == "stb":
        return jpeg.planes_from_coeffs(yc, cbc, crc, height, width)
    ch, cw = -(-height // 2), -(-width // 2)
    out = []
    for c, (h, w) in zip((yc, cbc, crc), ((height, width), (ch, cw), (ch, cw))):
        bh, bw = -(-h // 8), -(-w // 8)
        px = jidctint(c).reshape(c.shape[:-2] + (bh, bw, 8, 8)).swapaxes(-3, -2)
        out.append(px.reshape(c.shape[:-2] + (bh * 8, bw * 8))[..., :h, :w])
    return out


def _slices(yc, cbc, crc, height, width, quality, precision, rows=None):
    planes = _planes(yc, cbc, crc, height, width, precision["idct"])
    return mpeg1.frame_slices(*mpeg1.pad_planes(*planes), quality, precision["dct"], rows)


def prepare(batch: dict, config: dict, mix: dict, precision: dict, pool) -> list[list[bytes]]:
    n, step = len(batch["yc"]), mpeg1.FRAMES_PER_CHUNK
    jobs = [pool.submit(_slices, batch["yc"][i:i + step], batch["cbc"][i:i + step],
                        batch["crc"][i:i + step], config["height"], config["width"],
                        mix["quality"], precision)
            for i in range(0, n, step)]
    return [f for j in jobs for f in j.result()]


def submit(pool, batch: dict, config: dict, mix: dict, precision: dict, stamp: dict):
    """The three moved rows of every frame as frames one macroblock row
    high: at a, b, c the coefficient rows of c, a, b."""
    parts, rows = [], []
    for f, (a, b, c) in enumerate(cycles(config, stamp)):
        parts += [block_rows(batch, config["width"], f, r) for r in (c, a, b)]
        rows += [a, b, c]
    yc, cbc, crc = (np.stack([p[k].reshape(-1, 64) for p in parts]) for k in range(3))
    return pool.submit(_slices, yc, cbc, crc, 16, config["width"], mix["quality"], precision,
                       np.array(rows))


def expected(state: list[list[bytes]], config: dict, mix: dict, first_frame_index: int,
             stamp: dict, part: list[list[bytes]]) -> bytes:
    payloads = []
    for f, (a, b, c) in enumerate(cycles(config, stamp)):
        frame = list(state[f])
        for j, r in enumerate((a, b, c)):
            (frame[r],) = part[3 * f + j]
        payloads.append(b"".join(frame))
    return mpeg1.assemble(payloads, config["width"], config["height"], mix["quality"],
                          config["frame_rate_code"], config["gop_size"], first_frame_index)
