"""The traffic generators repeat for a seed and differ across seeds, and
their stamps make every call's input one that no earlier call sent."""

from __future__ import annotations

import hashlib
import importlib

import numpy as np
import pytest

from portbench.harness import POOL_BATCHES, load_cell, stamp_keys
from portbench.tests.helpers import cells


def _gen(workload):
    spec = load_cell(workload)
    config = {**spec["config"], **spec["config"]["rehearse"]}
    return importlib.import_module(f"portbench.traffic.{spec['mix']['generator']}"), config, spec


def _batch(workload, seed):
    gen, config, spec = _gen(workload)
    rng = np.random.default_rng(seed)
    return [gen.make(config, spec["mix"], rng) for _ in range(2)], config


def _hash(batch):
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(batch[k].tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload", cells())
def test_same_seed_same_inputs(workload):
    a, _ = _batch(workload, 2**31 + 5)
    b, _ = _batch(workload, 2**31 + 5)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert all(np.array_equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("workload", cells())
def test_other_seed_other_inputs(workload):
    a, config = _batch(workload, 2**31 + 5)
    b, _ = _batch(workload, 2**32 + 77)
    assert any(not np.array_equal(a[0][k], b[0][k]) for k in a[0])
    assert any(not np.array_equal(a[0][k], a[1][k]) for k in a[0])  # the pool's batches differ
    for k in a[0]:
        assert a[0][k].shape == b[0][k].shape and a[0][k].dtype == b[0][k].dtype
        assert len(a[0][k]) == config["frames_per_call"]


@pytest.mark.parametrize("workload", cells())
def test_stamps_repeat_for_a_seed_and_undo_exactly(workload):
    gen, config, _ = _gen(workload)
    (batch, _), _ = _batch(workload, 2**31 + 9)
    before = _hash(batch)
    key = stamp_keys(2**31 + 9, 1, config["frames_per_call"])[0]
    s1, s2 = gen.stamp(config, key, 7), gen.stamp(config, key, 7)
    assert s1 == s2 and len(s1["rows"]) == config["frames_per_call"]
    assert s1 != gen.stamp(config, key, 8)
    undo = gen.apply(batch, config, s1)
    stamped = _hash(batch)
    undo()
    assert stamped != before and _hash(batch) == before


def _pairs(gen, config, key, calls):
    """-> the (row, shift) of each frame in each of `calls` stamps."""
    out = []
    for k in range(calls):
        st = gen.stamp(config, key, k)
        out.append(list(zip(st["rows"], st["shifts"])))
    return out


@pytest.mark.parametrize("workload", cells())
def test_no_call_repeats_an_input(workload):
    """Over as many calls as a frame has stamps, every call's input and
    every frame that a call sends are new: a result kept from an earlier
    input never fits."""
    gen, config, spec = _gen(workload)
    rng = np.random.default_rng(2**31 + 13)
    pool = [gen.make(config, spec["mix"], rng) for _ in range(POOL_BATCHES)]
    keys = stamp_keys(2**31 + 13, len(pool), config["frames_per_call"])
    per_frame = len({p[0] for p in _pairs(gen, config, keys[0], 10**4)})
    n = min(300, per_frame * len(pool))
    calls, frames = set(), set()
    for k in range(n):
        i = k % len(pool)
        undo = gen.apply(pool[i], config, gen.stamp(config, keys[i], k // len(pool)))
        calls.add(_hash(pool[i]))
        for f in range(config["frames_per_call"]):
            frames.add(_hash({key: v[f] for key, v in pool[i].items()}))
        undo()
    assert n >= 50 and len(calls) == n and len(frames) == n * config["frames_per_call"]


@pytest.mark.parametrize("workload", cells())
def test_full_size_stamps_do_not_repeat_in_a_window(workload):
    """At the configuration's own size no frame's (row, shift) comes twice
    in 4,000 calls of a batch, more than a window sends."""
    gen, _, _ = _gen(workload)
    config = load_cell(workload)["config"]
    pairs = _pairs(gen, config, stamp_keys(2**31 + 17, 1, 3)[0], 4000)
    for f in range(3):
        assert len({p[f] for p in pairs}) == 4000
