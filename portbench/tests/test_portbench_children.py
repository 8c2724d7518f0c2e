"""A run leaves no process behind: the reference's spawned pool and the
resource tracker that multiprocessing starts beside it are stopped and
waited for before the run's process ends."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests.helpers import ROOT

SCRIPT = """
import json, math
from portbench import harness

with harness._executor(2) as ex:
    assert [ex.submit(math.sqrt, 4.0).result() for _ in range(4)] == [2.0] * 4
before = harness._child_pids()
harness.stop_children()
from multiprocessing import resource_tracker
print(json.dumps({"before": before, "after": harness._child_pids(),
                  "tracker": resource_tracker._resource_tracker._pid}))
"""


def test_stop_children_leaves_no_process():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["before"], "the spawned pool left no tracker to stop: the test tests nothing"
    assert got["after"] == [] and got["tracker"] is None


def test_stop_children_waits_for_any_other_child():
    script = ("import subprocess, sys\nfrom portbench import harness\n"
              "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
              "harness.stop_children()\n"
              "print(harness._child_pids(), p.pid)\n")
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=60, check=True)
    assert done.stdout.startswith("[] ") and "stopping child process" in done.stderr
