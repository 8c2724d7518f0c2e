"""What a JPEG decoder's entropy stage hands over: the dequantized int16
coefficients ((B, blocks, 64) per component, natural order, raster block
order) of the `fixture_tiles` planes, as a JPEG encoder at quality 75
makes them: the orthonormal 8 x 8 DCT of each block less 128, quantized by
the Annex K tables scaled to quality 75, dequantized.  A quarter of the
first frame's luma blocks, drawn from the seed, hold int16 extremes
(-32768, -32767, 0, 32767), so the IDCT's clamps are driven every call.

Copied from `chip_smoke.py::_jpeg_coeffs`, with the frame size a parameter.
"""

from __future__ import annotations

import numpy as np
from scipy.fft import dctn

from portbench.traffic import fixture_tiles, roll_in_place, stamp_rows

# JPEG Annex K tables K.1 (luminance) and K.2 (chrominance)
JPEG_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
             14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
             18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
             49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
JPEG_CHROMA = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
               24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32


def coefficients(planes, height: int, width: int, rng: np.random.Generator):
    ch, cw = -(-height // 2), -(-width // 2)
    out = []
    for plane, (ph, pw), table in zip(planes, ((height, width), (ch, cw), (ch, cw)),
                                      (JPEG_LUMA, JPEG_CHROMA, JPEG_CHROMA)):
        bh, bw = -(-ph // 8), -(-pw // 8)
        p = np.pad(plane, ((0, 0), (0, bh * 8 - ph), (0, bw * 8 - pw)), mode="edge")
        blocks = (p.astype(np.float64) - 128).reshape(-1, bh, 8, bw, 8).transpose(0, 1, 3, 2, 4)
        q = np.clip((np.array(table) * 50 + 50) // 100, 1, 255).reshape(8, 8)
        f = np.round(dctn(blocks, axes=(-2, -1), norm="ortho") / q) * q
        out.append(f.reshape(len(p), bh * bw, 64).astype(np.int16))
    y = out[0]
    pick = rng.random(y.shape[1]) < 0.25
    y[0, pick] = np.array([-32768, -32767, 0, 32767], np.int16)[
        rng.integers(0, 4, (int(pick.sum()), 64))]
    return out


def make(config: dict, mix: dict, rng: np.random.Generator) -> dict:
    """One batch of the call's frames as JPEG coefficients."""
    planes = fixture_tiles.make(config, mix, rng)
    yc, cbc, crc = coefficients((planes["y"], planes["cb"], planes["cr"]),
                                config["height"], config["width"], rng)
    return {"yc": yc, "cbc": cbc, "crc": crc}


def block_rows(batch: dict, width: int, f: int, r: int):
    """Views of macroblock row r of frame f: its two luma block rows
    (2, blocks across, 64) and one block row of each chroma component."""
    bw, cbw = -(-width // 8), -(-(-(-width // 2)) // 8)
    y = batch["yc"][f, 2 * r * bw:(2 * r + 2) * bw].reshape(2, bw, 64)
    return y, batch["cbc"][f, r * cbw:(r + 1) * cbw], batch["crc"][f, r * cbw:(r + 1) * cbw]


def stamp(config: dict, key: np.ndarray, k: int) -> dict:
    """Per frame a whole macroblock row, rolled by 1..width / 16 - 1
    macroblocks (two luma blocks, one chroma block each)."""
    return stamp_rows(key, k, config["height"] // 16, config["width"] // 16 - 1)


def apply(batch: dict, config: dict, stamp: dict):
    parts = []
    for f, (r, s) in enumerate(zip(stamp["rows"], stamp["shifts"])):
        y, cb, cr = block_rows(batch, config["width"], f, r)
        parts += [(y, 2 * s, 1), (cb, s, 0), (cr, s, 0)]
    return roll_in_place(parts)
