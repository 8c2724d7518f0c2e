"""Checkpointed / resumable encoding: per-GOP segments + manifest.

The reference appends to one file frame-by-frame, so a crash leaves a
truncated stream and a restart redoes everything (SURVEY.md §5).  Here a
long encode is a series of independent GOP segments — each an .m1vseg
file plus a manifest entry with byte size and a checksum — so:

  * a crashed or preempted job resumes at the first missing GOP,
  * failed shards of a distributed run are simply re-dispatched
    (frames are independent; nothing downstream is contaminated),
  * the final stream is a pure concatenation ("GOP stitching") of
    segments + one sequence_end_code.

The manifest is JSON, rewritten atomically after every completed segment.

The port's copy of the JAX package's `runtime/checkpoint.py` (held equal
to it by tests/test_torch_entry.py); it drives a `TorchMPEG1IntraEncoder`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np

from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.syntax import headers
from ec504_imageencoder_tpu_torch.utils.metrics import EncodeMetrics


@dataclasses.dataclass
class SegmentRecord:
    index: int           # GOP index
    first_frame: int
    n_frames: int
    path: str
    nbytes: int
    md5: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class CheckpointedEncode:
    """Resumable GOP-granular encode session."""

    def __init__(self, workdir: str, encoder: TorchMPEG1IntraEncoder, total_frames: int):
        self.workdir = workdir
        self.encoder = encoder
        self.total_frames = total_frames
        self.gop = encoder.gop_size
        os.makedirs(workdir, exist_ok=True)
        self.manifest_path = os.path.join(workdir, "manifest.json")
        self.segments: dict[int, SegmentRecord] = {}
        self._load_manifest()

    # -- manifest ---------------------------------------------------------
    def _load_manifest(self) -> None:
        if not os.path.exists(self.manifest_path):
            return
        data = json.loads(open(self.manifest_path).read())
        if data.get("total_frames") != self.total_frames or data.get("gop") != self.gop:
            raise ValueError(
                "manifest belongs to a different job "
                f"(frames {data.get('total_frames')} gop {data.get('gop')})"
            )
        for rec in data["segments"]:
            sr = SegmentRecord(**rec)
            # only trust segments whose bytes are intact
            if os.path.exists(sr.path) and os.path.getsize(sr.path) == sr.nbytes:
                if hashlib.md5(open(sr.path, "rb").read()).hexdigest() == sr.md5:
                    self.segments[sr.index] = sr

    def _save_manifest(self) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "total_frames": self.total_frames,
                    "gop": self.gop,
                    "updated": time.time(),
                    "segments": [s.to_json() for s in sorted(self.segments.values(), key=lambda r: r.index)],
                },
                f,
                indent=1,
            )
        os.replace(tmp, self.manifest_path)

    # -- work layout ------------------------------------------------------
    def n_gops(self) -> int:
        return (self.total_frames + self.gop - 1) // self.gop

    def pending_gops(self) -> list[int]:
        return [g for g in range(self.n_gops()) if g not in self.segments]

    def gop_frame_range(self, g: int) -> tuple[int, int]:
        start = g * self.gop
        return start, min(start + self.gop, self.total_frames)

    # -- encoding ---------------------------------------------------------
    def encode_gop(self, g: int, frames: np.ndarray) -> SegmentRecord:
        """Encode frames for GOP g (caller supplies exactly that range)."""
        start, end = self.gop_frame_range(g)
        if frames.shape[0] != end - start:
            raise ValueError(f"GOP {g} needs {end - start} frames, got {frames.shape[0]}")
        data = self.encoder.encode(frames, first_frame_index=start)
        path = os.path.join(self.workdir, f"seg_{g:06d}.m1vseg")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        rec = SegmentRecord(
            index=g, first_frame=start, n_frames=end - start, path=path,
            nbytes=len(data), md5=hashlib.md5(data).hexdigest(),
        )
        self.segments[g] = rec
        self._save_manifest()
        return rec

    def stitch(self, out_path: str) -> int:
        """Concatenate all segments + sequence_end into the final stream."""
        missing = self.pending_gops()
        if missing:
            raise RuntimeError(f"cannot stitch: GOPs missing {missing[:8]}...")
        total = 0
        with open(out_path, "wb") as out:
            for g in range(self.n_gops()):
                rec = self.segments[g]
                with open(rec.path, "rb") as f:
                    total += out.write(f.read())
            total += out.write(headers.sequence_end())
        return total


def encode_resumable(
    frame_source,
    total_frames: int,
    workdir: str,
    out_path: str,
    encoder: TorchMPEG1IntraEncoder | None = None,
    metrics: EncodeMetrics | None = None,
    max_retries: int = 2,
) -> int:
    """Drive a checkpointed encode to completion.

    `frame_source(start, end)` returns frames [start, end) as (N,H,W,3) u8 —
    the streaming replacement for the reference's load-everything-at-once
    intake (encoder.h:126-171).  Failed GOPs are retried (fault
    re-dispatch); completed GOPs are never re-encoded across restarts.
    encoder=None encodes with `TorchMPEG1IntraEncoder()`, on "cuda".
    """
    enc = encoder or TorchMPEG1IntraEncoder()
    sess = CheckpointedEncode(workdir, enc, total_frames)
    m = metrics or EncodeMetrics()
    m.set("frames", total_frames)
    for g in sess.pending_gops():
        start, end = sess.gop_frame_range(g)
        attempt = 0
        while True:
            try:
                t0 = time.perf_counter()
                sess.encode_gop(g, frame_source(start, end))
                m.add("encode_s", time.perf_counter() - t0)
                break
            except OverflowError:
                raise  # configuration problem, not transient
            except Exception:
                attempt += 1
                if attempt > max_retries:
                    raise
    n = sess.stitch(out_path)
    m.set("stream_bytes", n)
    return n
