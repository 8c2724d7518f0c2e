"""RGB frames of natural content at any size: `fixture_tiles.rgb_frames`
(the repository's three fixture images tiled to the frame and shifted by
the seed), handed over as the (B, H, W, 3) u8 frames that `encode` takes.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import fixture_tiles, roll_in_place, stamp_rows


def make(config: dict, mix: dict, rng: np.random.Generator) -> dict:
    """One batch of the call's frames as RGB."""
    return {"rgb": fixture_tiles.rgb_frames(rng, config["frames_per_call"], config["height"],
                                            config["width"])}


def stamp(config: dict, key: np.ndarray, k: int) -> dict:
    """Per frame a whole macroblock row (16 RGB rows) and an even shift in
    2..width - 2, so that the row's 2 x 2 chroma groups stay whole."""
    st = stamp_rows(key, k, config["height"] // 16, config["width"] // 2 - 1)
    st["shifts"] = [2 * s for s in st["shifts"]]
    return st


def apply(batch: dict, config: dict, stamp: dict):
    return roll_in_place([(batch["rgb"][f, 16 * r:16 * r + 16], s, 1)
                          for f, (r, s) in enumerate(zip(stamp["rows"], stamp["shifts"]))])
