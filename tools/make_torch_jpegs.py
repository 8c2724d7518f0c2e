#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's entry-point checks.

From the three stb-decoded fixture frames (`tests/golden/fixture_rgb.npz`,
600 rows x 400 columns):

- `frame_<k>.jpg`: each frame as it is, 4:2:0, quality 90;
- `hd_<k>.jpg`, k = 0, 1: a 1920 x 1080 tiling of the three frames side
  by side, shifted by a seeded offset, 4:2:0, quality 75.

All baseline with optimized Huffman tables (1.2 MB or less in all).

`chip_smoke.py` and the card tests build their folders from copies of
these, so they need no PIL.  This script needs it:

    python3 tools/make_torch_jpegs.py [--out tests/data/torch_jpegs]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HD_H, HD_W = 1080, 1920
SEED = 20261017
N_HD = 2


def hd_tiling(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    reps = (-(-HD_H // img.shape[0]) + 1, -(-HD_W // img.shape[1]) + 1, 1)
    dy, dx = (int(v) for v in rng.integers(0, img.shape[:2]))
    return np.tile(img, reps)[dy:dy + HD_H, dx:dx + HD_W]


def main(argv=None) -> int:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" / "torch_jpegs"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    with np.load(ROOT / "tests" / "golden" / "fixture_rgb.npz") as z:
        frames = [z[k] for k in sorted(z.files)]
    for k, img in enumerate(frames):
        Image.fromarray(img).save(out / f"frame_{k}.jpg", quality=90, subsampling=2,
                                  optimize=True)
    mosaic = np.concatenate(frames, axis=1)
    for k in range(N_HD):
        Image.fromarray(hd_tiling(mosaic, rng)).save(out / f"hd_{k}.jpg", quality=75,
                                                     subsampling=2, optimize=True)
    paths = sorted(out.glob("*.jpg"))
    print(f"wrote {len(paths)} JPEGs to {out}: {sum(p.stat().st_size for p in paths)} B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
