"""The C project's own input: its 30 frames of 400 x 600 (the fixture
images in `data/frame_order.json`'s order, as stb_image decoded the
project's JPEGs), each rolled cyclically by a seeded offset, so that the
96 x 144 region that compat mode codes sees other content per seed.
"""

from __future__ import annotations

import json

import numpy as np

from portbench.traffic import roll_in_place, stamp_rows
from portbench.traffic.fixture_tiles import DATA


def make(config: dict, mix: dict, rng: np.random.Generator) -> dict:
    order = json.loads((DATA / "frame_order.json").read_text())["unique_ids"]
    with np.load(DATA / "fixture_rgb.npz") as z:
        imgs = {k: z[k] for k in set(order)}
    n, h, w = config["frames_per_call"], config["height"], config["width"]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        im = imgs[order[i % len(order)]]
        dy, dx = (int(v) for v in rng.integers(0, im.shape[:2]))
        rolled = np.roll(im, (dy, dx), axis=(0, 1))
        out[i] = np.tile(rolled, (-(-h // im.shape[0]), -(-w // im.shape[1]), 1))[:h, :w]
    return {"rgb": out}


def stamp(config: dict, key: np.ndarray, k: int) -> dict:
    """Per frame a 16-pixel band of rows and a shift along it in
    1..width - 1."""
    return stamp_rows(key, k, config["height"] // 16, config["width"] - 1)


def apply(batch: dict, config: dict, stamp: dict):
    return roll_in_place([(batch["rgb"][f, 16 * r:16 * r + 16], s, 1)
                          for f, (r, s) in enumerate(zip(stamp["rows"], stamp["shifts"]))])
