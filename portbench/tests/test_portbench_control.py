"""The control (the reference in the precision below the configuration's,
put in the entry point's place) comes out not correct in every cell, at
the rehearsal's size; the program itself comes out correct there."""

from __future__ import annotations

import pytest

from portbench.tests.helpers import cells, rehearse


@pytest.mark.parametrize("workload", cells())
def test_program_is_correct(workload):
    code, result, err = rehearse(workload)
    assert code == 0 and result["correct"], err
    assert result["checks"]["calls_wrong"]["value"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct(workload):
    code, result, err = rehearse(workload, control=True)
    assert code == 0 and not result["correct"], err
    assert result["checks"]["calls_wrong"]["value"] == result["calls_checked"] >= 1
