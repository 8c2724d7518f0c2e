"""Per-layer metric readers, one module per metric of `BENCHMARK.json`'s
`per_layer`, found by the metric's name.  Each defines
`read(trace: tracefile.Trace, ctx: dict) -> float | None`, and returns
None where the trace holds nothing to read; the harness then leaves the
metric out.  ctx: `calls` (calls traced), `least_s` (the least device
time of their work, `work/`)."""
