"""One short run of each cell on the card (skips without CUDA): the run
ends with code 0, is correct, and reports its cell's end-to-end metrics
and a device named by torch.  Run on the card with
`python -m pytest -q -p no:cacheprovider portbench/tests/test_portbench_card.py`."""

from __future__ import annotations

import io

import pytest

from portbench.tests.helpers import cells


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", cells())
def test_short_run_on_the_card(workload, card):
    from portbench import harness

    err = io.StringIO()
    code, result = harness.run(workload, 2**31 + 3, 1.0, False, log=err)
    assert code == 0 and result["correct"], err.getvalue()
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    assert "frames_per_s" in result["metrics"] and "setup_s" in result["metrics"]


def test_no_card_no_result(monkeypatch):
    """Without a card a run fails and prints no result; it does not fall
    back to the CPU."""
    import torch

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    code, result = harness.run(cells()[0], 1, 0.1, False, log=err)
    assert code != 0 and result is None and "CUDA" in err.getvalue()
