"""Structured metrics for encode runs (the port's copy of the JAX
package's `utils/metrics.py`, held equal to it by tests/test_torch_entry.py).

The reference's only observability is printf logging in hot loops
(SURVEY.md §5); here metrics are first-class: named counters, stage
timers, histograms, and derived rates with JSON and human reports, used
by the CLI (--metrics) and the benchmark harness.  Frames/s is the
north-star number, so derived rates are computed on demand:

  frames + encode_s          -> encode_fps
  encode_fps + n_devices     -> encode_fps_per_chip
  stream_bytes + frames      -> bytes_per_frame
  encode_fps + baseline_fps  -> speedup_vs_baseline
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np


class EncodeMetrics:
    def __init__(self) -> None:
        self._v: dict[str, object] = {}

    def set(self, key: str, value) -> None:
        self._v[key] = value

    def add(self, key: str, value: float) -> None:
        self._v[key] = self._v.get(key, 0.0) + value

    def get(self, key: str, default=None):
        return self._v.get(key, default)

    @contextlib.contextmanager
    def timer(self, key: str):
        """Accumulating stage timer: `with metrics.timer("dct_s"): ...`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(key, time.perf_counter() - t0)

    def histogram(self, key: str, values, n_bins: int = 12) -> None:
        """Record a compact histogram (counts + edges + summary stats).

        Used for the bits-per-macroblock / bits-per-slice distributions
        that show where the bit budget goes across a frame.
        """
        a = np.asarray(values, dtype=np.float64).reshape(-1)
        if a.size == 0:
            return
        counts, edges = np.histogram(a, bins=n_bins)
        self._v[key] = {
            "count": int(a.size),
            "min": float(a.min()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "max": float(a.max()),
            "mean": float(a.mean()),
            "bin_edges": [round(float(e), 2) for e in edges],
            "bin_counts": [int(c) for c in counts],
        }

    def derived(self) -> dict:
        d = dict(self._v)
        frames = d.get("frames")
        if frames:
            if d.get("encode_s"):
                d["encode_fps"] = frames / d["encode_s"]
                if d.get("n_devices"):
                    d["encode_fps_per_chip"] = d["encode_fps"] / d["n_devices"]
                if d.get("baseline_fps"):
                    d["speedup_vs_baseline"] = d["encode_fps"] / d["baseline_fps"]
            if d.get("stream_bytes"):
                d["bytes_per_frame"] = d["stream_bytes"] / frames
        return d

    def merge(self, other: "EncodeMetrics") -> None:
        """Fold another process's counters in (multi-host aggregation):
        numbers add, everything else takes the other's value."""
        for k, v in other._v.items():
            if isinstance(v, (int, float)) and isinstance(self._v.get(k), (int, float)):
                self._v[k] = self._v[k] + v
            else:
                self._v[k] = v

    def report(self) -> str:
        return json.dumps(self.derived(), indent=1, default=str)
