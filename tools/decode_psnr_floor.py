#!/usr/bin/env python3
"""Derive, on the CPU, the decoded-PSNR floors that `chip_smoke.py` phase
24 holds the card's streams to.

The card's streams are byte-equal to the port's CPU path, so their
decodes are the CPU path's decodes: this script encodes the same frames
with `device="cpu"`, decodes them with the port's decoder (studio range,
as the rgb intake stores them) and prints each stream's mean and least
per-frame PSNR against the source RGB frames, in dB, unrounded:

- the 16 x 1080p frames of phases 2-8 (`chip_smoke._frames`, seed
  `chip_smoke.SEED`) at q=50 and q=85, encoded a frame at a time with its
  frame index (the same bytes as the whole batch: phase 8 holds the q=85
  split, and the AAN route is exact per block), so no full-size batch is
  ever held;
- the CLI's `--container ps` stream of 4 copies of
  `tests/data/torch_jpegs/hd_0.jpg` (rgb intake, q=50), against the
  folder's frames decoded by the port's `io/jpeg.load_folder`.

    python3 tools/decode_psnr_floor.py      # about 2 minutes on one core
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ec504_imageencoder_tpu_torch.io.jpeg import load_folder  # noqa: E402
from ec504_imageencoder_tpu_torch.models.decoder import decode_stream, psnr  # noqa: E402
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder  # noqa: E402
from ec504_imageencoder_tpu_torch.syntax import headers  # noqa: E402


def _report(label, src, dec):
    vals = [psnr(s, d) for s, d in zip(src, dec)]
    print(f"{label}: {len(dec)} frames, mean PSNR {float(np.mean(vals))!r} dB, "
          f"least {float(min(vals))!r} dB")


def main() -> int:
    rng = np.random.default_rng(chip_smoke.SEED)
    frames = chip_smoke._frames(np, rng, chip_smoke.BATCH)
    for q in (chip_smoke.QUALITY, chip_smoke.HQ_QUALITY):
        enc = TorchMPEG1IntraEncoder(quality=q, device="cpu")
        es = b"".join(enc.encode(frames[i:i + 1], first_frame_index=i)
                      for i in range(len(frames))) + headers.sequence_end()
        _report(f"{chip_smoke.BATCH}x1080p rgb q={q}", frames, decode_stream(es))
    with tempfile.TemporaryDirectory() as tmp:
        folder = chip_smoke._jpeg_folder(Path(tmp) / "hd4", ["hd_0.jpg"], 4)
        hd, _ = load_folder(str(folder), require_exact=False)
    es = TorchMPEG1IntraEncoder(quality=chip_smoke.QUALITY, device="cpu").encode(hd)
    _report("4 x hd_0.jpg rgb q=50", hd, decode_stream(es + headers.sequence_end()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
