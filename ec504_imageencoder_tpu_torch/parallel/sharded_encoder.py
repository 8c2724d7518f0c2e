"""Sharded encode: the correct-mode pipeline run over a (data, rows) mesh.

Frames shard over the `data` axis, image rows (=> macroblock rows =>
slices) over the `rows` axis.  No collectives: slices are independent
bitstream islands, so each shard runs the whole device pipeline (the same
kernels as one device: B1 and B2, or B6b and B6c, or B3 and B2, and the
sanitizer's routes under debug_checks) on its own slab, and the host
gathers the segments when it reads them.

The port's counterpart of the JAX package's `parallel/sharded_encoder.py`,
where GSPMD partitions one jitted program.  Here the split is explicit:

* one `EncodeCore` per distinct device of the mesh, built with the
  quantizer (a device appearing several times runs its shards one after
  another on its current stream);
* the frames or planes are edge-padded to whole macroblocks on the host
  (`np.pad`, counted in `mpeg1.pad_sites["host"]`) and the shards' slabs
  made contiguous there (a second span `encode.pad`): the slabs are cut
  by macroblock rows before any copy, so the padded rows must exist on
  the host (one device pads on the device, after the copy); then each
  shard's slab is copied to its device (`encode.h2d`) and launched there
  at once (`encode.enqueue`), its slice headers numbered from its first
  MB row, so a card runs its shard while the host copies the next; the
  host fetches nothing before every shard is launched, and a regrow
  re-runs on the same copies;
* the batch splits unevenly over `data` (`mesh.split_batch`, as
  `torch.tensor_split`): the reference pads the batch with copies of its
  last frame because GSPMD needs an even split; the bytes are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.mpeg1 import (
    EncodeCore,
    TorchMPEG1IntraEncoder,
    correct_pipeline,
    correct_pipeline_planes,
    pad_planes_to_macroblocks,
    pad_to_macroblocks,
)
from ec504_imageencoder_tpu_torch.parallel import mesh as mesh_lib
from ec504_imageencoder_tpu_torch.utils.profiling import stage_scope


class ShardedTorchMPEG1Encoder(TorchMPEG1IntraEncoder):
    """TorchMPEG1IntraEncoder whose device pipeline runs across a mesh.

    Same host-side API, keywords (debug_checks, fuse, pack, dct_impl reach
    every shard; bit_rate raises NotImplementedError) and identical bytes out; the batch axis shards over
    `data` and image rows over `rows`.  mesh=None takes `make_mesh()`:
    every visible CUDA device on `data`.  `device` defaults to the mesh's
    first device and only places the base encoder's own core."""

    def __init__(self, *args, mesh=None, **kwargs):
        if kwargs.get("bit_rate") is not None:
            raise NotImplementedError(
                "the rate control (bit_rate) is single-device: each picture's scale comes "
                "from all of its slices, which a rows mesh splits; use TorchMPEG1IntraEncoder"
            )
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        kwargs.setdefault("device", self.mesh.devices[0][0])
        super().__init__(*args, **kwargs)

    def _set_quant(self, intra_q: np.ndarray, qscale: int) -> None:
        super()._set_quant(intra_q, qscale)
        self.cores = {self.device: self.core}
        for dev in self.mesh.distinct_devices():
            if dev not in self.cores:
                self.cores[dev] = EncodeCore(self.intra_q, self.qscale, self.dct_impl,
                                             self.fuse, self.pack).to(dev)

    def _check_divisible(self, mbh: int) -> tuple[int, int]:
        n_data = self.mesh.shape[mesh_lib.DATA_AXIS]
        n_rows = self.mesh.shape[mesh_lib.ROWS_AXIS]
        if mbh % n_rows:
            raise ValueError(
                f"padded frame has {mbh} MB rows, not divisible by the "
                f"rows mesh axis ({n_rows}); pick n_rows dividing {mbh}"
            )
        return n_data, n_rows

    def _to_device(self, arrays, kind: str):
        """The caller's host arrays (`kind` as the base class takes them)
        edge-padded to whole macroblocks on the host, then cut into shards:
        a grid [i][j] of [device, first MB row, slabs], as
        `mesh_lib.shard_host` lays it out.  The slabs are host arrays until
        `_run_shards` first launches their shard."""
        mbh = -(-arrays[0].shape[1] // 16)
        self._check_divisible(mbh)
        with stage_scope("encode.pad"):
            padded = ((pad_to_macroblocks(*arrays),) if kind == "rgb"
                      else pad_planes_to_macroblocks(*arrays))
            if padded[0] is not arrays[0]:
                mpeg1.pad_sites["host"] += 1
            return [[list(shard) for shard in row]
                    for row in mesh_lib.shard_host(padded, self.mesh, mbh)]

    def _run_shards(self, shards, run):
        """Launch `run(core, first_row, *device slabs)` on every shard of the
        grid, each copied to its device just before its first launch and
        kept there for a regrow, then wrap the outputs for the host
        gather."""
        segs, bits = [], []
        for row in shards:
            segs.append([])
            bits.append([])
            for shard in row:
                dev, first_row, slabs = shard
                if isinstance(slabs[0], np.ndarray):
                    with stage_scope("encode.h2d"):
                        slabs = shard[2] = [torch.from_numpy(s).to(dev) for s in slabs]
                with stage_scope("encode.enqueue"):
                    seg, nb = run(self.cores[dev], first_row, *slabs)
                segs[-1].append(seg)
                bits[-1].append(nb)
        return mesh_lib.ShardedTensor(segs), mesh_lib.ShardedTensor(bits)

    def _enqueue_rgb(self, shards, msb: int):
        return self._run_shards(shards, lambda core, first_row, rgb: correct_pipeline(
            core, rgb, msb, self.color_range, self.debug_checks, first_row))

    def _enqueue_planes(self, shards, msb: int):
        return self._run_shards(shards, lambda core, first_row, y, cb, cr:
                                correct_pipeline_planes(core, y, cb, cr, msb,
                                                        self.debug_checks, first_row))

    def encode_from_coeffs(self, *args, **kwargs):
        raise NotImplementedError(
            "the coefficients intake is single-device (the in-jit IDCT "
            "is not sharded yet); decode to planes and use "
            "encode_from_planes, which shards"
        )
