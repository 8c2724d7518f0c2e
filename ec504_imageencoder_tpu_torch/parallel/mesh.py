"""Device mesh for the encoder, and the split and gather of its shards.

Parallel axes of this workload (SURVEY.md §2.1):
  * `data`  — frames; every I-frame is independent (the DP analogue).
  * `rows`  — macroblock rows within a frame; each row is one slice, and
    slices are byte-aligned independent bitstream islands, so row sharding
    needs no cross-device communication until the final segment gather
    (the SP analogue).

The port's counterpart of the JAX package's `parallel/mesh.py`.  A
`DeviceMesh` is a plain `(n_data, n_rows)` grid of `torch.device` with the
`.shape` dict of `jax.sharding.Mesh`.  There is no GSPMD to place the
work, so the `NamedSharding` helpers of the reference (`frame_sharding`,
`segment_sharding`, `bits_sharding`, `replicated`) have no counterpart of
their own name; in their place:

* `split_batch` and `shard_host` cut a host batch into the per-device
  slabs that `frame_sharding` described (frames over `data`, image rows
  over `rows`), each contiguous for its host-to-device copy;
* `ShardedTensor` holds the per-device outputs that `segment_sharding` and
  `bits_sharding` described, and gathers them on the host on `.cpu()`;
* what `replicated` placed on every device (the quantizer) goes there
  with the one `EncodeCore` per device of `ShardedTorchMPEG1Encoder`.
"""

from __future__ import annotations

import numpy as np
import torch

from ec504_imageencoder_tpu_torch.device import resolve_device

DATA_AXIS = "data"
ROWS_AXIS = "rows"


class DeviceMesh:
    """An (n_data, n_rows) grid of torch devices: `devices[i][j]` encodes
    the i-th share of the frames, j-th band of macroblock rows.  A device
    may appear more than once; its shards then run one after another."""

    def __init__(self, devices):
        self.devices = tuple(tuple(row) for row in devices)
        self.shape = {DATA_AXIS: len(self.devices),
                      ROWS_AXIS: len(self.devices[0]) if self.devices else 0}

    def distinct_devices(self) -> list[torch.device]:
        """Every device of the grid once, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_mesh(n_data: int | None = None, n_rows: int = 1, devices=None) -> DeviceMesh:
    """Build a (data, rows) mesh.  Defaults to all devices on `data`.

    devices=None takes every visible CUDA device, once each, and raises
    RuntimeError where CUDA is absent (no CPU fallback).  An explicit list
    may hold "cpu" and may name a device more than once: a mesh of CPU
    entries for tests, or several shards on one card."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_rows
    if n_data * n_rows > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_rows} needs {n_data * n_rows} devices, "
            f"have {len(devices)}"
        )
    grid = devices[: n_data * n_rows]
    return DeviceMesh([grid[i * n_rows:(i + 1) * n_rows] for i in range(n_data)])


def split_batch(batch: int, n_data: int) -> list[tuple[int, int]]:
    """[start, end) frames of each data shard, split as `torch.tensor_split`
    splits: the first batch % n_data shards take one frame more; a shard
    past the batch is empty.  No frame is padded in."""
    per, extra = divmod(batch, n_data)
    bounds, start = [], 0
    for i in range(n_data):
        end = start + per + (i < extra)
        bounds.append((start, end))
        start = end
    return bounds


def shard_host(arrays, mesh: DeviceMesh, mb_rows: int):
    """Host arrays (B, H_k, ...) that cover the same mb_rows macroblock rows
    (H_k = mb_rows * 16 for luma or RGB, * 8 for chroma) -> a grid [i][j] of
    (device, first MB row, [contiguous slab of each array]): frames over
    `data`, whole MB rows over `rows`.  Shards with no frame are left out,
    so a row of the grid may be missing."""
    n_data, n_rows = mesh.shape[DATA_AXIS], mesh.shape[ROWS_AXIS]
    band = mb_rows // n_rows
    grid = []
    for i, (b0, b1) in enumerate(split_batch(arrays[0].shape[0], n_data)):
        if b0 == b1:
            continue
        row = []
        for j in range(n_rows):
            slabs = []
            for a in arrays:
                unit = a.shape[1] // mb_rows  # 16 or 8 image rows a MB row
                slabs.append(np.ascontiguousarray(
                    a[b0:b1, j * band * unit:(j + 1) * band * unit]))
            row.append((mesh.devices[i][j], j * band, slabs))
        grid.append(row)
    return grid


class ShardedTensor:
    """A (B, mbh, ...) result held as a grid of per-shard tensors, each on
    its own device (row i: a share of the frames; column j: a band of MB
    rows).  Indexing applies to every shard alike and must keep the first
    two axes whole (`seg[:, :, :n]`); `.cpu()` copies each shard to the
    host and joins them, rows then frames."""

    def __init__(self, grid):
        self.grid = [list(row) for row in grid]

    def __getitem__(self, index) -> "ShardedTensor":
        return ShardedTensor([[t[index] for t in row] for row in self.grid])

    def cpu(self) -> torch.Tensor:
        return torch.cat([torch.cat([t.cpu() for t in row], dim=1) for row in self.grid], dim=0)
