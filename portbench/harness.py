"""One run of one cell of the port's benchmark.

A cell is an entry of `BENCHMARK.json`'s `workloads`: a configuration
(`configs/<config>.json`) under a traffic mix (`mixes/<traffic>.json`).
The mix names the entry point (`entries/<entry>.py`), its reference
(`reference/entries/<entry>.py`), the least device time of its work
(`work/<entry>.py`) and the generator of its inputs
(`traffic/<generator>.py`); each per-layer metric is read by
`layer_metrics/<metric>.py`.  All are found by name, so a new cell, mix,
configuration or metric is a new file and a new entry.

A run: set-up (the inputs of `POOL_BATCHES` batches made from the seed,
the entry built, `WARM_CALLS` calls, which build the kernels and settle
the slice buffers), then a closed loop of one caller for `seconds`: each
call waits for its bytes before the next is sent, with
`first_frame_index` running on, the batches in turn.  Before each call
the generator stamps the batch in place (a seeded change to every frame,
undone after the call), so that no two calls send the same input.  Then
the check: the digest of each call kept against the reference's bytes,
computed from the same stamped inputs once the window has closed.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import os
import platform
import signal
import subprocess
import sys
import time
import traceback
from concurrent.futures import Future, ProcessPoolExecutor
from multiprocessing import active_children, get_context, resource_tracker
from pathlib import Path

THREADS = 1  # torch's and the BLAS libraries' host threads in the measuring process
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = str(THREADS)  # before numpy and torch start their pools

import numpy as np  # noqa: E402

from portbench.tracefile import CALL_SPAN, Trace  # noqa: E402

PB = Path(__file__).resolve().parent
ROOT = PB.parent
OUT = PB / "_out"
FORBIDDEN = ("jax", "jaxlib", "flax", "ec504_imageencoder_tpu")
REHEARSE_SECONDS = 2.0
POOL_BATCHES = 2  # distinct batches made from the seed, sent in turn
WARM_CALLS = 4  # set-up's calls: each batch of the pool twice
TRACE_SECONDS = 4.0  # the traced window's cap: a trace of plain-torch stages grows ~20 MB/s


class Inline:
    """An executor that runs each job at once in this process."""

    def submit(self, fn, *args):
        fut = Future()
        fut.set_result(fn(*args))
        return fut

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def load_cell(name: str) -> dict:
    """The cell `name` with its configuration, mix and metrics."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((PB / "mixes" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": config, "mix": mix,
            "end_to_end": mine(spec["end_to_end"]), "per_layer": mine(spec["per_layer"])}


def stamp_keys(seed: int, batches: int, frames: int) -> list[np.ndarray]:
    """Each pool batch's stamp key: two seeded numbers per frame."""
    return [np.random.default_rng([seed, 2, i]).integers(0, 2**62, (frames, 2))
            for i in range(batches)]


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def _executor(workers: int):
    return (ProcessPoolExecutor(max_workers=workers, mp_context=get_context("spawn"))
            if workers else Inline())


def _child_pids() -> list[int]:
    """The processes whose parent is this one, read from /proc."""
    me, pids = os.getpid(), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue  # ended while it was read
        if int(fields[1]) == me:
            pids.append(int(stat.parent.name))
    return pids


def stop_children(log=sys.stderr) -> None:
    """Stop every process this run started and wait for each to end: the
    reference pool's workers, the resource tracker that multiprocessing
    starts beside a spawned pool and otherwise leaves running until this
    process has gone, and any other child, which is named on `log`."""
    gc.collect()  # the pools' locks unregister while the tracker still runs
    for p in active_children():
        p.join()
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        os.close(tracker._fd)  # the tracker ends at the end of its pipe
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None
    for pid in _child_pids():
        print(f"stopping child process {pid}", file=log)
        try:
            os.kill(pid, signal.SIGTERM)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass


def precision_of(ref, mix: dict, control: bool) -> dict:
    """The arithmetic the reference computes in: the configuration's
    (`ref.nominal`), or one step below it for the control."""
    return {**ref.nominal(mix), **(mix["control"] if control else {})}


def control_entry(config: dict, mix: dict, pool: list, workers: int, now: list):
    """The benchmark's control in the entry's place: the reference in the
    precision below the configuration's (`mix["control"]`), each pool
    batch coded once, each call's stamped part coded anew (`now` holds the
    call's pool index and stamp)."""
    ref = importlib.import_module(f"portbench.reference.entries.{mix['entry']}")
    precision = precision_of(ref, mix, True)
    with _executor(workers) as ex:
        states = [ref.prepare(b, config, mix, precision, ex) for b in pool]

    def call(batch: dict, first_frame_index: int):
        i, stamp = now
        part = ref.submit(Inline(), batch, config, mix, precision, stamp).result()
        return ref.expected(states[i], config, mix, first_frame_index, stamp, part)

    return call


def digest(out) -> str:
    """sha256 of a call's output: its bytes, or each of its parts in turn."""
    h = hashlib.sha256()
    for part in (out if isinstance(out, tuple) else (out,)):
        for b in (part if isinstance(part, list) else [part]):
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
    return h.hexdigest()


def _stream_bytes(out) -> int:
    return len(out[0] if isinstance(out, tuple) else out)


def _read_trace(tr: Trace, spec: dict, config: dict, sizes: list, log):
    """-> (the cell's per-layer metrics, {busy_s, window_s} or None, the
    breakdown) of a traced window, and the profiler's launch accounting on
    `log`."""
    mix = spec["mix"]
    work = importlib.import_module(f"portbench.work.{mix['entry']}")
    least_s, bound_by = work.least(config, mix, len(sizes), sum(sizes))
    ctx = {"calls": tr.calls, "least_s": least_s}
    metrics = {}
    for m in spec["per_layer"]:
        v = importlib.import_module(f"portbench.layer_metrics.{m['name']}").read(tr, ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    scaled, recorded, port = tr.kernel_us()
    print(f"trace: {tr.calls} calls, {len(tr.device)} device records in "
          f"{tr.window_us / 1e6} s; least device time {least_s} s ({bound_by})", file=log)
    print("trace: the port's kernels recorded against their *_launch spans: " + (", ".join(
        f"{k} {v['recorded']} of {v['launches']}" for k, v in sorted(port.items())) or "none"),
        file=log)
    if scaled is not None and tr.window_us:
        print(f"trace: kernel time {recorded / 1e3} ms recorded, {scaled / 1e3} ms with the "
              f"lost launches scaled in; device_idle_pct may read up to "
              f"{100 * (scaled - recorded) / tr.window_us} points high", file=log)
    if not tr.device:
        return metrics, None, None
    busy = {"busy_s": tr.busy_us() / 1e6, "window_s": tr.window_us / 1e6}
    return metrics, busy, {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_by_host_span()}


def _check(spec: dict, config: dict, pool: list, gen, kept: list, workers: int):
    """-> (calls whose digest differs from the reference's bytes, the
    first such call described or None).  Each kept call's stamp is put on
    its batch again while the reference copies out what it needs."""
    mix, fpc = spec["mix"], config["frames_per_call"]
    ref = importlib.import_module(f"portbench.reference.entries.{mix['entry']}")
    precision = precision_of(ref, mix, False)
    wrong, first_bad = 0, None
    ahead = max(2 * workers, 1)
    with _executor(workers) as ex:
        states = [ref.prepare(batch, config, mix, precision, ex) for batch in pool]
        for lo in range(0, len(kept), ahead):
            jobs = []
            for k, i, stamp, got in kept[lo:lo + ahead]:
                undo = gen.apply(pool[i], config, stamp)
                try:
                    jobs.append(ref.submit(ex, pool[i], config, mix, precision, stamp))
                finally:
                    undo()
            for (k, i, stamp, got), job in zip(kept[lo:lo + ahead], jobs):
                want = ref.expected(states[i], config, mix, k * fpc, stamp, job.result())
                if digest(want) != got:
                    wrong += 1
                    if first_bad is None:
                        first_bad = (f"call {k}: digest {got[:16]} against the reference's "
                                     f"{digest(want)[:16]} ({_stream_bytes(want)} stream bytes)")
    return wrong, first_bad


def run(workload: str, seed: int, seconds: float, trace: bool, rehearse: bool = False,
        control: bool = False, t0: float | None = None, entry_wrapper=None,
        log=sys.stderr) -> tuple[int, dict | None]:
    """Run one cell; -> (exit code, the result object or None)."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_cell(workload)
    cell, config, mix = spec["cell"], dict(spec["config"]), spec["mix"]
    import torch

    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    if rehearse:
        config.update(config.get("rehearse", {}))
        device = "cpu"
        seconds = min(seconds, REHEARSE_SECONDS)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{workload}: needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"device_count() is {torch.cuda.device_count()}", file=log)
            return 2, None
        device = "cuda"

    torch.set_num_threads(THREADS)
    rng = np.random.default_rng(seed)
    gen = importlib.import_module(f"portbench.traffic.{mix['generator']}")
    pool = [gen.make(config, mix, rng) for _ in range(POOL_BATCHES)]
    keys = stamp_keys(seed, len(pool), config["frames_per_call"])
    workers = 0 if rehearse else min(8, os.cpu_count() or 1)  # the reference's processes
    now = [0, None]  # the pool index and stamp of the call under way
    if control:
        call = control_entry(config, mix, pool, workers, now)
    else:
        call = importlib.import_module(f"portbench.entries.{mix['entry']}").make(
            config, mix, device)
    if entry_wrapper is not None:
        call = entry_wrapper(call, config)
    frames_per_call, n_pool = config["frames_per_call"], len(pool)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def stamped(n: int):
        """-> (the stamp, the function that undoes it) of call n's batch."""
        i = n % n_pool
        now[:] = [i, gen.stamp(config, keys[i], n // n_pool)]
        return now[1], gen.apply(pool[i], config, now[1])

    for n in range(WARM_CALLS):
        _, undo = stamped(n)
        try:
            call(pool[n % n_pool], n * frames_per_call)
        finally:
            undo()
    n = WARM_CALLS
    sync()
    builds = {}
    if not rehearse:
        from ec504_imageencoder_tpu_torch.ops import _build
        builds = {k: v[0] for k, v in _build.build_info.items()}
    setup_s = time.perf_counter() - t0

    # each call is kept for the check with the mix's `checked_share` of
    # probability, drawn from the seed (and the window's last call): its
    # pool index, stamp and output digest, so that what the window holds
    # does not grow with the calls
    checker = np.random.default_rng([seed, 1])
    share = mix["checked_share"]
    durations, sizes, kept, failures = [], [], [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        stamp, undo = stamped(n)
        a = time.perf_counter()
        try:
            if trace:
                with record_function(CALL_SPAN):
                    out = call(pool[n % n_pool], n * frames_per_call)
            else:
                out = call(pool[n % n_pool], n * frames_per_call)
        except Exception:  # a failed call is counted, and the window goes on
            failures.append(traceback.format_exc())
            out = None
        b = time.perf_counter()
        undo()
        durations.append(b - a)
        if out is not None:
            sizes.append(_stream_bytes(out))
            if checker.random() < share or b >= deadline:
                kept.append((n, n % n_pool, stamp, digest(out)))
        del out
        n += 1
        if b >= deadline:
            break
    window_s = b - w0
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    del call
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    metrics, device_info, breakdown = {}, {}, None
    if device == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": cell["chips"], "memory_peak_bytes": int(peak)}
    else:
        device_info = {"platform": "cpu", "kind": platform.processor() or platform.machine(),
                       "count": 1, "memory_peak_bytes": None}
    e2e = {
        "frames_per_s": (len(sizes) * frames_per_call / window_s, "frames/s"),
        "call_ms_p95": (float(np.percentile(np.array(durations) * 1e3, 95)), "ms"),
        "setup_s": (setup_s, "s"),
    }
    if trace:
        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / f"{workload}.trace.json"
        prof.export_chrome_trace(str(path))
        metrics, busy, breakdown = _read_trace(Trace.load(path), spec, config, sizes, log)
        if device == "cuda" and busy is not None:
            device_info.update(busy)
        else:
            breakdown = None
    else:
        for m in spec["end_to_end"]:
            value, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": unit}
    if rehearse:  # a CPU run writes nothing under a device metric's name
        rehearsal = {k: v["value"] for k, v in metrics.items()}
        metrics = {}

    wrong, first_bad = _check(spec, config, pool, gen, kept, workers)
    checks = {"calls_wrong": {"value": wrong, "limit": 0},
              "calls_failed": {"value": len(failures), "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": len(durations), "failed": len(failures),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if rehearse:
        result["cpu_rehearsal"] = rehearsal
    result["card"] = "cpu" if rehearse else _card_line()
    if builds:
        result["cold_build_s"] = builds
    result["calls_checked"] = len(kept)
    result["checks"] = checks

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{workload}.calls.json").write_text(json.dumps(
        {"seed": seed, "call_s": durations, "setup_s": setup_s, "window_s": window_s}))
    if failures:
        print(f"{len(failures)} call(s) raised; the first:\n{failures[0]}", file=log)
    if first_bad:
        print(f"first wrong call: {first_bad}", file=log)
    # last, once everything the run imports is loaded: JAX or the JAX package
    # in this process means no result
    found = forbidden_modules()
    if found:
        print(f"{workload}: JAX or the JAX package is loaded: {', '.join(found)}", file=log)
        return 3, None
    print(f"{len(kept)} of {len(sizes)} calls checked against the reference", file=log)
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=log)
    return 0, result
