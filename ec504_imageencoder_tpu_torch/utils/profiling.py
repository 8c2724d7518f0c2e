"""Tracing and profiling helpers on `torch.profiler`.

The port's counterpart of the JAX package's `utils/profiling.py`
(`jax.profiler`): `device_trace` records the host's operations and, where
a CUDA card is present, the card's kernels and copies, and writes them as
a Chrome trace (open in Perfetto or chrome://tracing); `stage_scope`
names a span in it, on the profiler's clock.  Every CUDA kernel launch of
the port runs inside a `stage_scope` named after its C entry point
(`ops/_build.load`), and every encode call runs as a sequence of
`encode.*` spans, one per stage (`models/mpeg1.py`, `models/encoder.py`).  The
JAX package's `WallTimer` has no copy here: the spans time the stages.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the block and write it to
    `logdir/trace_<pid>.pt.trace.json`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.pt.trace.json"))


def stage_scope(name: str):
    """Named span for a pipeline stage while a profiler records; outside
    one, a `nullcontext`, and nothing else is built."""
    return record_function(name) if _profiler_enabled() else contextlib.nullcontext()
