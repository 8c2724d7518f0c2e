"""The reference of `encode` with `bit_rate` on RGB frames
(`reference/rate.py`): each frame's macroblock-padded studio-range 4:2:0
planes (`reference/color.py`), every slice's bits at the 31 scales, the
frame's q*, its slices at q*, the stream with every picture padded to the
budget.

Per pool batch, once: each frame's planes, its (slices, 31) bit table, its
q* and its slices at q*.  Per kept call: the stamped macroblock row of
each frame recounted at the 31 scales from its 16 stamped RGB rows
(neither the colour nor the 2 x 2 mean reaches across a macroblock row),
q* picked from the table with that row replaced, the row coded at q*, and
the frame's other slices taken from the cache, coded anew (and cached)
only where this q* is one the frame has not met.

`precision["rate"]`: "search" as the configuration states, or for the
benchmark's control "fixed8", every picture at quality 50's own scale (8),
padded where it fits.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import color, rate

FIXED8 = 8


def nominal(mix: dict) -> dict:
    return {"dct": "int32", "colour": "fixed16", "rate": "search"}


def _frame(rgb, quality, precision, budget):
    """One frame -> (padded planes, bit table or None, q*, slices at q*)."""
    planes = color.planes_420(rgb[None], precision["colour"])
    if precision["rate"] == "search":
        bits = rate.slice_bits(*planes, quality)[0]
        q = rate.choose(bits, budget)
    else:
        bits, q = None, FIXED8
    return planes, bits, q, rate.code_slices(*planes, quality, q)[0]


def prepare(batch: dict, config: dict, mix: dict, precision: dict, pool) -> dict:
    budget = rate.budget_bytes(config["bit_rate"], config["frame_rate_code"])
    jobs = [pool.submit(_frame, rgb, mix["quality"], precision, budget) for rgb in batch["rgb"]]
    frames = [j.result() for j in jobs]
    return {"planes": [f[0] for f in frames], "bits": [f[1] for f in frames],
            "slices": [{f[2]: f[3]} for f in frames], "budget": budget}


def _rows(rgb_rows, quality, precision):
    """Frames one macroblock row high -> (their planes, their bits at the
    31 scales or None)."""
    planes = color.planes_420(rgb_rows, precision["colour"])
    bits = rate.slice_bits(*planes, quality)[:, 0] if precision["rate"] == "search" else None
    return planes, bits


def submit(pool, batch: dict, config: dict, mix: dict, precision: dict, stamp: dict):
    """The stamped rows as frames one macroblock row high."""
    rgb = np.stack([batch["rgb"][f, 16 * r:16 * r + 16] for f, r in enumerate(stamp["rows"])])
    return pool.submit(_rows, rgb, mix["quality"], precision)


def expected(state: dict, config: dict, mix: dict, first_frame_index: int, stamp: dict,
             part) -> bytes:
    (y, cb, cr), row_bits = part
    payloads = []
    for f, r in enumerate(stamp["rows"]):
        if row_bits is None:
            q = FIXED8
        else:
            bits = state["bits"][f].copy()
            bits[r] = row_bits[f]
            q = rate.choose(bits, state["budget"])
        cached = state["slices"][f]
        if q not in cached:
            cached[q] = rate.code_slices(*(p for p in state["planes"][f]), mix["quality"], q)[0]
        (row,), = rate.code_slices(y[f:f + 1], cb[f:f + 1], cr[f:f + 1], mix["quality"], q,
                                   np.array([r]))
        payloads.append(b"".join(cached[q][:r]) + row + b"".join(cached[q][r + 1:]))
    return rate.assemble(payloads, config["width"], config["height"], mix["quality"],
                         config["frame_rate_code"], config["gop_size"], first_frame_index,
                         config["bit_rate"])
