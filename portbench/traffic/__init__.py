"""Traffic generators, one module per generator that a mix names.

Each defines `make(config, mix, rng) -> dict of numpy arrays` (one batch
of a call, as users hand it over), `stamp(config, key, k) -> dict`
(the k-th change made to a batch, from the batch's seeded `key`: `rows`, one
macroblock row of each frame, and `shifts`, how far that row is rolled)
and `apply(batch, config, stamp) -> undo`, which makes the change in place
and returns the function that takes it back.  The harness stamps the
batch before every call and undoes it after, so that no two calls send
the same input and no frame is sent twice (until every row and shift of a
frame has been used: 64,253 calls a batch at 1080p planes, 7,973 for
coefficients, 14,763 for compat's frames).
"""

from __future__ import annotations

import math

import numpy as np


def stamp_rows(key: np.ndarray, k: int, mb_rows: int, n_shifts: int) -> dict:
    """The k-th stamp of a batch: per frame (a row (a, b) of `key`) a
    macroblock row in 0..mb_rows - 1 and a shift in 1..n_shifts, the pair
    (a k + b) mod (mb_rows n_shifts) with a prime to the modulus, so that
    no pair comes twice in a frame before all have come."""
    n = mb_rows * max(n_shifts, 1)
    rows, shifts = [], []
    for a, b in key.tolist():
        a = a % n or 1
        while math.gcd(a, n) != 1:
            a += 1
        r, s = divmod((a * k + b) % n, max(n_shifts, 1))
        rows.append(r)
        shifts.append(s + 1)
    return {"rows": rows, "shifts": shifts}


def roll_in_place(parts) -> callable:
    """parts: (view, shift, axis) -> each view rolled in place; -> undo."""
    saved = []
    for view, shift, axis in parts:
        orig = view.copy()
        view[...] = np.roll(orig, shift, axis=axis)
        saved.append((view, orig))

    def undo():
        for view, orig in saved:
            view[...] = orig

    return undo
