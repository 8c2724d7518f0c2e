"""The reference of `encode_compat`: each call is a whole procedure on
the call's stamped frames (the `.bit` dumps hold every pixel of them), so
nothing is prepared per pool batch."""

from __future__ import annotations

from portbench.reference import compat


def nominal(mix: dict) -> dict:
    return {"colour": "f64"}


def prepare(batch: dict, config: dict, mix: dict, precision: dict, pool) -> None:
    return None


def submit(pool, batch: dict, config: dict, mix: dict, precision: dict, stamp: dict):
    return pool.submit(compat.encode_compat, batch["rgb"].copy(), mix["quality"],
                       precision["colour"])


def expected(state, config: dict, mix: dict, first_frame_index: int, stamp: dict, part):
    return part
