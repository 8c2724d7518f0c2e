"""Reading a `torch.profiler` Chrome trace of the measured window.

The window is the span from the start of the first `CALL_SPAN` (the
benchmark's own span around each call of the entry point) to the end of
the last.  Device work is every kernel, copy and set on the card.  The
port's own kernels are launched through ctypes inside spans named after
their C entry points (`*_launch`); the profiler is known to lose some of
their device records, so `port_kernels` counts the launches it saw and
scales the recorded time to them.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

CALL_SPAN = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_SUFFIX = "_launch"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one Chrome trace (times in microseconds)."""

    def __init__(self, doc: dict):
        events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
        calls = sorted((e for e in events if e.get("name") == CALL_SPAN
                        and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
        self.calls = len(calls)
        if calls:
            self.t0 = calls[0]["ts"]
            self.t1 = max(e["ts"] + e["dur"] for e in calls)
            self.thread = (calls[0].get("pid"), calls[0].get("tid"))
        else:
            self.t0 = self.t1 = 0.0
            self.thread = None
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        self.runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f))

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list[list[float]]:
        """The device's busy intervals inside the window, merged."""
        return _union((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                      for e in self.device)

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernels(self):
        return [e for e in self.device if e.get("cat") == "kernel"]

    def copies_us(self, direction: str) -> float:
        """Summed time of the window's copies whose name holds `direction`
        ("HtoD", "DtoH")."""
        return sum(e["dur"] for e in self.device
                   if e.get("cat") == "gpu_memcpy" and direction in e["name"])

    def port_kernels(self) -> dict:
        """The kernels launched inside a `*_launch` span, by the span's name:
        launches (spans in the window), recorded (spans with a device record)
        and us (their recorded device time)."""
        spans = defaultdict(list)
        for e in self.host:
            if e["name"].endswith(LAUNCH_SUFFIX) and self.t0 <= e["ts"] <= self.t1:
                spans[(e.get("pid"), e.get("tid"))].append(e)
        ordered = {k: sorted(v, key=lambda e: e["ts"]) for k, v in spans.items()}
        starts = {k: [e["ts"] for e in v] for k, v in ordered.items()}
        by_corr = {e.get("args", {}).get("correlation"): e for e in self.kernels()}
        out = defaultdict(lambda: {"launches": 0, "recorded": 0, "us": 0.0})
        seen = defaultdict(set)
        for v in ordered.values():
            for e in v:
                out[e["name"]]["launches"] += 1
        for r in self.runtime:
            k = by_corr.get(r.get("args", {}).get("correlation"))
            key = (r.get("pid"), r.get("tid"))
            if k is None or key not in starts:
                continue
            i = bisect.bisect_right(starts[key], r["ts"]) - 1
            if i < 0:
                continue
            span = ordered[key][i]
            if r["ts"] > span["ts"] + span["dur"]:
                continue
            out[span["name"]]["us"] += k["dur"]
            seen[span["name"]].add(id(span))
        for name, s in seen.items():
            out[name]["recorded"] = len(s)
        return dict(out)

    def kernel_us(self) -> tuple[float, float, dict]:
        """(the window's kernel time with the port's lost records scaled
        in, the time as recorded, the port's launch accounting); the first
        is None where a launch span name has no record at all."""
        recorded = sum(e["dur"] for e in self.kernels())
        port = self.port_kernels()
        scaled = recorded
        for acc in port.values():
            if acc["launches"] and not acc["recorded"]:
                return None, recorded, port
            if acc["recorded"]:
                scaled += acc["us"] * (acc["launches"] / acc["recorded"] - 1)
        return scaled, recorded, port

    def top_device_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for e in self.device:
            tot[e["name"][:120]] += e["dur"]
        return [[k, v / 1e6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host_span(self, n: int = 10) -> list:
        """The window's idle device time, summed by the innermost host span
        open on the calling thread at the middle of each gap."""
        busy = self.busy()
        gaps, t = [], self.t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            gaps.append((t, self.t1))
        spans = sorted((e for e in self.host if (e.get("pid"), e.get("tid")) == self.thread),
                       key=lambda e: (e["ts"], -e["dur"]))
        tot = defaultdict(float)
        stack, i = [], 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while i < len(spans) and spans[i]["ts"] <= mid:
                stack.append(spans[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
                stack.pop()
            inner = next((s for s in reversed(stack) if s["ts"] + s["dur"] >= mid), None)
            tot[inner["name"][:120] if inner else "(no host span)"] += b - a
        return [[k, v / 1e6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
