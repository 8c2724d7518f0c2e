"""Reading the program's own spans (`encode.*`, `utils.profiling.stage_scope`
in the port) out of a `tracefile.Trace`.

Only spans on the calling thread (`trace.thread`, the thread of the
benchmark's call span) whose start lies in the window count.  Both
functions return None where the trace holds no such span, so a reader
built on them finds nothing to read in a program that lacks the span.
`per_call_ms` turns a sum into the per-call milliseconds the readers
report.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.tracefile import _union


def _spans(trace, name: str) -> list[dict]:
    return [e for e in trace.host
            if e["name"] == name and e.get("cat") == "user_annotation"
            and (e.get("pid"), e.get("tid")) == trace.thread
            and trace.t0 <= e["ts"] <= trace.t1]


def span_us(trace, name: str) -> float | None:
    """The summed duration (us) of the spans named `name`."""
    spans = _spans(trace, name)
    return sum(e["dur"] for e in spans) if spans else None


def span_device_us(trace, name: str) -> float | None:
    """The summed duration (us) of the device records (kernels, copies,
    sets) whose runtime launch event, matched by its `correlation`, starts
    inside a span named `name` on the calling thread."""
    spans = _spans(trace, name)
    if not spans:
        return None
    merged = _union((e["ts"], e["ts"] + e["dur"]) for e in spans)
    starts = [a for a, _ in merged]
    device = defaultdict(float)
    for e in trace.device:
        device[e.get("args", {}).get("correlation")] += e["dur"]
    us = 0.0
    for r in trace.runtime:
        corr = r.get("args", {}).get("correlation")
        if corr is None or corr not in device or (r.get("pid"), r.get("tid")) != trace.thread:
            continue
        i = bisect.bisect_right(starts, r["ts"]) - 1
        if i >= 0 and r["ts"] <= merged[i][1]:
            us += device[corr]
    return us


def per_call_ms(trace, us: float | None) -> float | None:
    """us summed over the traced calls -> ms per call; None where there is
    nothing to read."""
    if not trace.calls or us is None:
        return None
    return us / 1e3 / trace.calls
