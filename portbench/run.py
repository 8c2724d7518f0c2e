#!/usr/bin/env python3
"""The port's benchmark: run one cell of BENCHMARK.json and print its result.

    python3 portbench/run.py --workload hd1080.q85.planes --seed 7 --seconds 20 --trace 0

from the root of a checkout on a machine with a CUDA card.  The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number with its limit; they are also the last
lines of standard error.  Without a card the run fails; `--rehearse` runs
the cell for 2 s on the CPU at the reduced size of its configuration's
`rehearse` key instead, and prints its numbers under `cpu_rehearsal`.
`--control` puts the benchmark's control (the reference in the precision
below the configuration's) in the entry point's place: its `correct` must
come out false.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    # every build and kernel cache of the run inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    try:
        code, result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                   rehearse=args.rehearse, control=args.control, t0=T0)
    finally:
        harness.stop_children()
    sys.stderr.flush()
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
