"""BENCHMARK.json meets the benchmark's contract, and every cell resolves,
by name, to the files that run it."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench.tests.helpers import PB, ROOT, bench, cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    spec = bench()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)


def test_names_units_and_lengths():
    spec = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in spec[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in spec["configs"]] + [w["why"] for w in spec["workloads"]]
                 + [c["source"] for c in spec["configs"]] + [m["layer"] for m in spec["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    spec = bench()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert set(e2e) == {"frames_per_s", "call_ms_p95", "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_the_contract_asks():
    spec = bench()
    for w in spec["workloads"]:
        mine = lambda ms: [m["name"] for m in ms if w["name"] in m.get("workloads", [w["name"]])]  # noqa: E731
        e2e, layer = mine(spec["end_to_end"]), mine(spec["per_layer"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        assert w["chips"] == 1


@pytest.mark.parametrize("workload", cells())
def test_cell_resolves_to_files(workload):
    from portbench.harness import load_cell

    spec = load_cell(workload)
    config, mix = spec["config"], spec["mix"]
    for key in ("width", "height", "frames_per_call", "reduced", "assumed", "rehearse"):
        assert key in config
    for module in (f"portbench.entries.{mix['entry']}",
                   f"portbench.reference.entries.{mix['entry']}",
                   f"portbench.work.{mix['entry']}",
                   f"portbench.traffic.{mix['generator']}"):
        importlib.import_module(module)
    for m in spec["per_layer"]:
        assert callable(importlib.import_module(f"portbench.layer_metrics.{m['name']}").read)
    assert 0 < mix["checked_share"] <= 1
    nominal = importlib.import_module(f"portbench.reference.entries.{mix['entry']}").nominal(mix)
    assert mix["control"] and all(nominal[k] != v for k, v in mix["control"].items())


def test_config_files_are_under_paths_and_distinct():
    spec = bench()
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    for c in spec["configs"]:
        assert c["file"].startswith("portbench/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


def test_size_limit():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert (PB / "run.py").is_file()
