"""Bounded-memory streaming intake (the port's copy of the JAX package's
`io/stream.py`, held equal to it by tests/test_torch_io.py).

The reference decodes the whole folder into RAM before encoding a single
frame (encoder.h:126-171); SURVEY.md §5 prescribes the opposite for the
production path: "stream input frames in bounded batches instead of
load-all".  FolderFrameSource scans once, then decodes [start, end)
windows on demand with the threaded native decoder, so peak memory is
one batch (plus one prefetched batch), not the whole shoot.

It is both a random-access frame source — `src(s, e)` — plugging
directly into runtime.checkpoint.encode_resumable / parallel.distributed
(their GOP loops pull exactly the ranges they own), and a sequential
iterator — `src.batches(n)` — with one-batch lookahead decode running in
a worker thread while the device encodes the current batch (the native
decoder releases the GIL, so the overlap is real).  While a profiler
records, the caller's wait for each decoded batch runs in the span
`encode.jpeg_decode` (the span of the decode in `encode_from_jpegs`): the
part of the decode that the previous batch's encode did not hide.

Failure semantics differ deliberately from load-all: an undecodable file
raises instead of being skipped (reference encoder.h:163-167 skips).
Skipping would renumber every later frame, which silently corrupts GOP
ownership in checkpointed/multi-host runs; fail-fast + resume is the
production behavior.  Dimension mismatches raise in both modes.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np

from ec504_imageencoder_tpu_torch.io import jpeg as jpeg_io
from ec504_imageencoder_tpu_torch.utils.profiling import stage_scope


class FolderFrameSource:
    """Random-access, bounded-memory JPEG frame source.

    src(start, end) -> (end-start, H, W, 3) uint8, decoded on demand.
    """

    def __init__(self, folder: str, require_exact: bool = False,
                 n_threads: int = 0):
        self.folder = folder
        self.require_exact = require_exact
        self.n_threads = n_threads
        self.paths = jpeg_io.scan_folder(folder)
        if not self.paths:
            raise ValueError(f"no decodable images found in {folder}")
        try:
            probe = jpeg_io.decode_jpeg(self.paths[0], require_exact)
        except RuntimeError:
            raise  # compat-exactness requirement, not a decode failure
        except Exception as e:
            # normalize decoder-specific errors (PIL etc.) to the
            # streaming intake's fail-fast ValueError contract
            raise ValueError(
                f"decode failure: {self.paths[0]} ({e})"
            ) from e
        self.height, self.width = probe.shape[:2]
        self._probe = probe

    def __len__(self) -> int:
        return len(self.paths)

    def _decode_range(self, start: int, end: int) -> np.ndarray:
        paths = self.paths[start:end]
        geom = {"width": self.width, "height": self.height}
        (out,), st = jpeg_io.decode_with_status(paths, geom, "rgb", self.n_threads)
        bad = np.nonzero(st != 0)[0]
        if bad.size:
            i = int(bad[0])
            kind = "dimension mismatch" if st[i] == 2 else "decode failure"
            raise ValueError(f"{kind}: {paths[i]} (streaming intake is fail-fast)")
        return out

    def __call__(self, start: int, end: int) -> np.ndarray:
        start = max(0, start)
        end = min(len(self.paths), end)
        if start == 0 and end >= 1 and self._probe is not None:
            # reuse the constructor's probe decode for frame 0
            rest = self._decode_range(1, end)
            first = self._probe[None, ..., :3]
            self._probe = None
            return np.concatenate([first, rest]) if len(rest) else first.copy()
        return self._decode_range(start, end)

    def _lookahead(self, fetch, batch_size: int):
        n = len(self.paths)
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(fetch, 0, min(batch_size, n))
            for start in range(0, n, batch_size):
                with stage_scope("encode.jpeg_decode"):
                    cur = nxt.result()
                e2 = min(start + 2 * batch_size, n)
                if start + batch_size < n:
                    nxt = pool.submit(fetch, start + batch_size, e2)
                yield start, cur

    def batches(self, batch_size: int):
        """Yield (start_index, frames) with one-batch lookahead decode."""
        yield from self._lookahead(self, batch_size)

    # -- YCbCr 4:2:0 plane intake (the JPEG fast path) --------------------
    @property
    def geometry(self) -> dict | None:
        """Probed JPEG geometry of frame 0, or None where the native
        decoder cannot parse its header."""
        if not hasattr(self, "_geom"):
            self._geom = jpeg_io.probe_jpeg(self.paths[0])
        return self._geom

    def supports_planes(self) -> bool:
        """True when frames can stream as 4:2:0 YCbCr planes: 3-component
        2x2-subsampled JPEGs through the native staged decoder (other
        layouts fall back to the RGB intake)."""
        g = self.geometry
        return (jpeg_io.intake_kind(g) == "planes"
                and (g["width"], g["height"]) == (self.width, self.height))

    def planes(self, start: int, end: int):
        """Decode [start, end) to (Y, Cb, Cr) u8 plane batches — half the
        bytes of RGB, no host resample/color (io/jpeg.decode_planes_batch),
        ready for TorchMPEG1IntraEncoder.encode_from_planes."""
        return jpeg_io.decode_planes_batch(
            self.paths[start:end], self.geometry, self.n_threads
        )

    def plane_batches(self, batch_size: int):
        """Yield (start_index, (y, cb, cr)) with lookahead decode."""
        yield from self._lookahead(self.planes, batch_size)

    def coeffs(self, start: int, end: int):
        """Decode [start, end) to dequantized int16 coefficient blocks
        (host does entropy decode ONLY; ~1.5x faster than planes on the
        host, 2x the bytes) for
        TorchMPEG1IntraEncoder.encode_from_coeffs."""
        return jpeg_io.decode_coeffs_batch(
            self.paths[start:end], self.geometry, self.n_threads
        )

    def coeff_batches(self, batch_size: int):
        """Yield (start_index, (yc, cbc, crc)) with lookahead decode."""
        yield from self._lookahead(self.coeffs, batch_size)
