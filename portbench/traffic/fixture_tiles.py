"""Frames of natural content at any size: the repository's three fixture
images (`data/fixture_rgb.npz`, 600 x 400) tiled to the frame and shifted
by the seed, frame i from image i mod 3; as the 4:2:0 planes that a JPEG
decoder hands over (JFIF full-range BT.601 in 16-bit fixed point, chroma
the rounded mean of each 2 x 2).

The tiling is `chip_smoke.py::_frames`' (copied, with the frame size a
parameter).  Every seed tiles whole images over the frame, so every seed
codes about as many bits: the seed moves the content, not the work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.traffic import roll_in_place, stamp_rows

DATA = Path(__file__).resolve().parent.parent / "data"


def fixture_images() -> list[np.ndarray]:
    with np.load(DATA / "fixture_rgb.npz") as z:
        return [z[k] for k in sorted(z.files)]


def rgb_frames(rng: np.random.Generator, n: int, height: int, width: int) -> np.ndarray:
    """n (height, width, 3) u8 frames: image i % 3 tiled, shifted by a
    seeded offset inside one image."""
    imgs = fixture_images()
    out = np.empty((n, height, width, 3), np.uint8)
    for i in range(n):
        im = imgs[i % len(imgs)]
        reps = (-(-height // im.shape[0]) + 1, -(-width // im.shape[1]) + 1, 1)
        dy, dx = (int(v) for v in rng.integers(0, im.shape[:2]))
        out[i] = np.tile(im, reps)[dy:dy + height, dx:dx + width]
    return out


def planes_420(rgb: np.ndarray):
    """(B, H, W, 3) u8 -> Y (B, H, W), Cb, Cr (B, ceil(H/2), ceil(W/2)) u8."""
    h, w = rgb.shape[1:3]
    x = np.pad(rgb, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)), mode="edge").astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = ((-11059 * r - 21709 * g + 32768 * b + half) >> 16) + 128
    cr = ((32768 * r - 27439 * g - 5329 * b + half) >> 16) + 128

    def sub(c):
        c = np.clip(c, 0, 255)
        return ((c[:, 0::2, 0::2] + c[:, 1::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 1::2] + 2)
                >> 2).astype(np.uint8)

    return np.clip(y[:, :h, :w], 0, 255).astype(np.uint8), sub(cb), sub(cr)


def make(config: dict, mix: dict, rng: np.random.Generator) -> dict:
    """One batch of the call's frames as 4:2:0 planes."""
    rgb = rgb_frames(rng, config["frames_per_call"], config["height"], config["width"])
    y, cb, cr = planes_420(rgb)
    return {"y": y, "cb": cb, "cr": cr}


def stamp(config: dict, key: np.ndarray, k: int) -> dict:
    """Per frame a whole macroblock row and an even luma shift in
    2..width - 2 (the chroma rows shift by half)."""
    st = stamp_rows(key, k, config["height"] // 16, config["width"] // 2 - 1)
    st["shifts"] = [2 * s for s in st["shifts"]]
    return st


def apply(batch: dict, config: dict, stamp: dict):
    parts = []
    for f, (r, s) in enumerate(zip(stamp["rows"], stamp["shifts"])):
        parts.append((batch["y"][f, 16 * r:16 * r + 16], s, -1))
        parts += [(batch[c][f, 8 * r:8 * r + 8], s // 2, -1) for c in ("cb", "cr")]
    return roll_in_place(parts)
