"""The reference of `encode` on RGB frames: the frames' macroblock-padded
studio-range 4:2:0 planes (`reference/color.py`), then as
`encode_from_planes`.  A stamped macroblock row is coded anew from its
frame's 16 stamped RGB rows: neither the colour nor the 2 x 2 mean reaches
across a macroblock row.

The colour is plain PyTorch, written anew.  The one departure from a
plain-PyTorch reference is the chain after the planes (AAN DCT, VLC,
slices, `assemble`): `reference/mpeg1.py`'s plain numpy, which the
benchmark's other cells already trust.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import color, mpeg1
from portbench.reference.entries import encode_from_planes


def nominal(mix: dict) -> dict:
    return {"dct": mpeg1.dct_precision(mix["quality"]), "colour": "fixed16"}


def _slices(rgb, quality, precision, rows=None):
    y, cb, cr = color.planes_420(rgb, precision["colour"])
    return mpeg1.frame_slices(y, cb, cr, quality, precision["dct"], rows)


def prepare(batch: dict, config: dict, mix: dict, precision: dict, pool) -> list[list[bytes]]:
    """Each frame's slices: the work that does not depend on the call."""
    step = mpeg1.FRAMES_PER_CHUNK
    jobs = [pool.submit(_slices, batch["rgb"][i:i + step], mix["quality"], precision)
            for i in range(0, len(batch["rgb"]), step)]
    return [f for j in jobs for f in j.result()]


def submit(pool, batch: dict, config: dict, mix: dict, precision: dict, stamp: dict):
    """The stamped rows as frames one macroblock row high."""
    rows = np.array(stamp["rows"])
    rgb = np.stack([batch["rgb"][f, 16 * r:16 * r + 16] for f, r in enumerate(rows)])
    return pool.submit(_slices, rgb, mix["quality"], precision, rows)


expected = encode_from_planes.expected
