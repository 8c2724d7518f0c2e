"""Shared pieces of the benchmark's CPU tests."""

from __future__ import annotations

import io
import json
from pathlib import Path

PB = Path(__file__).resolve().parent.parent
ROOT = PB.parent
GOLDEN = ROOT / "tests" / "golden"


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells() -> list[str]:
    return [w["name"] for w in bench()["workloads"]]


def rehearse(workload: str, seed: int = 2**31 + 11, seconds: float = 0.5, **kw):
    """One CPU rehearsal of a cell -> (exit code, result, standard error)."""
    from portbench import harness

    err = io.StringIO()
    code, result = harness.run(workload, seed, seconds, False, rehearse=True, log=err, **kw)
    return code, result, err.getvalue()
