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
* each shard's slab is made contiguous on the host, copied to its device
  and encoded there, its slice headers numbered from its first MB row;
  every shard is launched before the host fetches anything;
* the batch splits unevenly over `data` (`mesh.split_batch`, as
  `torch.tensor_split`): the reference pads the batch with copies of its
  last frame because GSPMD needs an even split; the bytes are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ec504_imageencoder_tpu_torch.models.mpeg1 import (
    EncodeCore,
    TorchMPEG1IntraEncoder,
    correct_pipeline,
    correct_pipeline_planes,
)
from ec504_imageencoder_tpu_torch.parallel import mesh as mesh_lib


class ShardedTorchMPEG1Encoder(TorchMPEG1IntraEncoder):
    """TorchMPEG1IntraEncoder whose device pipeline runs across a mesh.

    Same host-side API, keywords (debug_checks, fuse, pack, dct_impl reach
    every shard) and identical bytes out; the batch axis shards over
    `data` and image rows over `rows`.  mesh=None takes `make_mesh()`:
    every visible CUDA device on `data`.  `device` defaults to the mesh's
    first device and only places the base encoder's own core."""

    def __init__(self, *args, mesh=None, **kwargs):
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

    def _run_shards(self, arrays, run):
        """Launch `run(core, first_row, *device slabs)` on every shard of the
        host arrays, then wrap the outputs for the host gather."""
        mbh = arrays[0].shape[1] // 16
        self._check_divisible(mbh)
        segs, bits = [], []
        for row in mesh_lib.shard_host(arrays, self.mesh, mbh):
            segs.append([])
            bits.append([])
            for dev, first_row, slabs in row:
                seg, nb = run(self.cores[dev], first_row,
                              *(torch.from_numpy(s).to(dev) for s in slabs))
                segs[-1].append(seg)
                bits[-1].append(nb)
        return mesh_lib.ShardedTensor(segs), mesh_lib.ShardedTensor(bits)

    def _pipeline_once(self, padded: np.ndarray, msb: int):
        return self._run_shards((padded,), lambda core, first_row, rgb: correct_pipeline(
            core, rgb, msb, self.color_range, self.debug_checks, first_row))

    def _planes_once(self, planes, msb: int):
        return self._run_shards(tuple(planes), lambda core, first_row, y, cb, cr:
                                correct_pipeline_planes(core, y, cb, cr, msb,
                                                        self.debug_checks, first_row))

    def encode_from_coeffs(self, *args, **kwargs):
        raise NotImplementedError(
            "the coefficients intake is single-device (the in-jit IDCT "
            "is not sharded yet); decode to planes and use "
            "encode_from_planes, which shards"
        )
