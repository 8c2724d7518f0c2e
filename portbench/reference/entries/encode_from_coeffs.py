"""The reference of `encode_from_coeffs`: the islow IDCT to 4:2:0 planes,
then as `encode_from_planes`; a stamped macroblock row is decoded from its
own block rows (each block's IDCT stands alone)."""

from __future__ import annotations

import numpy as np

from portbench.reference import jpeg, mpeg1
from portbench.reference.entries import encode_from_planes
from portbench.traffic.jpeg_coeffs import block_rows


def nominal(mix: dict) -> dict:
    return {"dct": mpeg1.dct_precision(mix["quality"]), "idct": "int32"}


def _slices(yc, cbc, crc, height, width, quality, precision, rows=None):
    idct = np.int16 if precision["idct"] == "int16" else np.int32
    planes = jpeg.planes_from_coeffs(yc, cbc, crc, height, width, idct)
    return mpeg1.frame_slices(*mpeg1.pad_planes(*planes), quality, precision["dct"], rows)


def prepare(batch: dict, config: dict, mix: dict, precision: dict, pool) -> list[list[bytes]]:
    n, step = len(batch["yc"]), mpeg1.FRAMES_PER_CHUNK
    jobs = [pool.submit(_slices, batch["yc"][i:i + step], batch["cbc"][i:i + step],
                        batch["crc"][i:i + step], config["height"], config["width"],
                        mix["quality"], precision)
            for i in range(0, n, step)]
    return [f for j in jobs for f in j.result()]


def submit(pool, batch: dict, config: dict, mix: dict, precision: dict, stamp: dict):
    """The stamped rows as frames one macroblock row high."""
    parts = [block_rows(batch, config["width"], f, r) for f, r in enumerate(stamp["rows"])]
    yc, cbc, crc = (np.stack([p[c].reshape(-1, 64) for p in parts]) for c in range(3))
    return pool.submit(_slices, yc, cbc, crc, 16, config["width"], mix["quality"], precision,
                       np.array(stamp["rows"]))


expected = encode_from_planes.expected
