"""4:2:0 planes of white noise, the encoder's worst case: `bench.py`'s
multiply-xorshift hash of an iota, offset by a number drawn from the seed,
written straight into Y, Cb and Cr (u8).  Nearly every coefficient is
nonzero, so every slice is as long as q=50 makes it.  The stamps and their
undo are `fixture_tiles`' (a macroblock row of each frame rolled by an
even luma shift).
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import fixture_tiles


def hash_u8(start: int, n: int) -> np.ndarray:
    """The low byte of bench.py's hash of the u32 iota start, start + 1, ...
    (n values, wrapping at 2**32)."""
    x = (np.arange(n, dtype=np.uint64) + np.uint64(start)).astype(np.uint32)
    x *= np.uint32(2654435761)
    x ^= x >> np.uint32(15)
    x *= np.uint32(2246822519)
    x ^= x >> np.uint32(13)
    return (x & np.uint32(0xFF)).astype(np.uint8)


def make(config: dict, mix: dict, rng: np.random.Generator) -> dict:
    """One batch of the call's frames as 4:2:0 planes of noise."""
    n, h, w = config["frames_per_call"], config["height"], config["width"]
    ch, cw = -(-h // 2), -(-w // 2)
    x = hash_u8(int(rng.integers(0, 2**32)), n * (h * w + 2 * ch * cw))
    y, cb = n * h * w, n * ch * cw
    return {"y": x[:y].reshape(n, h, w), "cb": x[y:y + cb].reshape(n, ch, cw),
            "cr": x[y + cb:].reshape(n, ch, cw)}


stamp = fixture_tiles.stamp
apply = fixture_tiles.apply
