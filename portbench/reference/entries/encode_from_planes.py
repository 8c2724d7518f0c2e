"""The reference of `encode_from_planes`: pad and code each frame's slices
once per pool batch; per call, code anew the macroblock row of each frame
that the call's stamp changed, then assemble the stream."""

from __future__ import annotations

import numpy as np

from portbench.reference import mpeg1


def nominal(mix: dict) -> dict:
    return {"dct": mpeg1.dct_precision(mix["quality"])}


def _slices(y, cb, cr, quality, dct, rows=None):
    return mpeg1.frame_slices(*mpeg1.pad_planes(y, cb, cr), quality, dct, rows)


def prepare(batch: dict, config: dict, mix: dict, precision: dict, pool) -> list[list[bytes]]:
    """Each frame's slices: the work that does not depend on the call."""
    chunks = [slice(i, i + mpeg1.FRAMES_PER_CHUNK)
              for i in range(0, len(batch["y"]), mpeg1.FRAMES_PER_CHUNK)]
    jobs = [pool.submit(_slices, batch["y"][s], batch["cb"][s], batch["cr"][s],
                        mix["quality"], precision["dct"]) for s in chunks]
    return [f for j in jobs for f in j.result()]


def submit(pool, batch: dict, config: dict, mix: dict, precision: dict, stamp: dict):
    rows = np.array(stamp["rows"])
    f = np.arange(len(rows))
    y = np.stack([batch["y"][i, 16 * r:16 * r + 16] for i, r in zip(f, rows)])
    cb, cr = (np.stack([batch[c][i, 8 * r:8 * r + 8] for i, r in zip(f, rows)])
              for c in ("cb", "cr"))
    return pool.submit(_slices, y, cb, cr, mix["quality"], precision["dct"], rows)


def expected(state: list[list[bytes]], config: dict, mix: dict, first_frame_index: int,
             stamp: dict, part: list[list[bytes]]) -> bytes:
    return mpeg1.assemble(mpeg1.restamp(state, stamp["rows"], part), config["width"],
                          config["height"], mix["quality"], config["frame_rate_code"],
                          config["gop_size"], first_frame_index)
