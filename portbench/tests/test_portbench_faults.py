"""A whole run with the timed path broken underneath comes out not
correct: a call that hands back the previous call's output (its state
unchanged), one that hands back what it returned for the same batch
object before (a result kept across repeated inputs), a call that codes
only half its batch, a slice whose bits are altered where the device
produces them, and a call that raises (its answer never comes).  (The
cells run on one chip: no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest

from portbench.harness import WARM_CALLS
from portbench.tests.helpers import cells, rehearse


def _stale(call, config):
    last = []

    def stale(batch, ffi):
        out = last[0] if last else call(batch, ffi)
        last[:] = [out]
        return out

    return stale


def _memo(call, config):
    """Keeps each output by the identity of the batch's arrays."""
    seen = {}

    def memo(batch, ffi):
        key = tuple(id(v) for v in batch.values())
        if key not in seen:
            seen[key] = call(batch, ffi)
        return seen[key]

    return memo


def _half(call, config):
    def half(batch, ffi):
        return call({k: v[:max(1, len(v) // 2)] for k, v in batch.items()}, ffi)

    return half


def _flip_slice_bit(seg):
    seg = seg.clone()
    seg[0, 0, 6] ^= 1
    return seg


def _raises(call, config):
    """Every call after set-up's warm calls raises."""
    count = [0]

    def raises(batch, ffi):
        count[0] += 1
        if count[0] > WARM_CALLS:
            raise RuntimeError("the device went away")
        return call(batch, ffi)

    return raises


@pytest.fixture
def altered(monkeypatch):
    """The device's slice buffers with one bit flipped past the slice header."""
    from ec504_imageencoder_tpu_torch.models import encoder, mpeg1

    core = mpeg1.correct_pipeline_planes
    monkeypatch.setattr(mpeg1, "correct_pipeline_planes",
                        lambda *a, **k: (lambda s, b: (_flip_slice_bit(s), b))(*core(*a, **k)))
    fwd = encoder.CompatCore.forward
    monkeypatch.setattr(encoder.CompatCore, "forward",
                        lambda self, *a, **k: (lambda s, b: (_flip_slice_bit(s), b))(
                            *fwd(self, *a, **k)))


@pytest.mark.parametrize("fault", [_stale, _memo, _half])
@pytest.mark.parametrize("workload", cells())
def test_broken_call_is_caught(workload, fault):
    code, result, err = rehearse(workload, entry_wrapper=fault)
    assert code == 0 and not result["correct"], err
    assert result["checks"]["calls_wrong"]["value"] >= 1


@pytest.mark.parametrize("workload", cells())
def test_altered_slice_is_caught(workload, altered):
    code, result, err = rehearse(workload)
    assert code == 0 and not result["correct"], err
    assert result["checks"]["calls_wrong"]["value"] == result["calls_checked"] >= 1


@pytest.mark.parametrize("workload", cells())
def test_failed_call_is_caught(workload):
    code, result, err = rehearse(workload, entry_wrapper=_raises)
    assert code == 0 and not result["correct"], err
    assert result["failed"] == result["checks"]["calls_failed"]["value"] == result["attempted"]
