"""The reference's MPEG-1 tables as torch tensors.

Built from the shared numpy tables (`ec504_imageencoder_tpu_torch.shared`;
no second copy of the ISO numbers).  All are int32 on the CPU; callers
move them to their device (EncodeCore registers them as buffers).
"""

from __future__ import annotations

import numpy as np
import torch

from ec504_imageencoder_tpu_torch.shared import ac_packed_table, dc_packed_table
from ec504_imageencoder_tpu_torch.shared import tables as ref

# ZIGZAG_GATHER[k] = flat (v*8 + u) index of the k-th scanned coefficient
ZIGZAG_GATHER = torch.from_numpy(ref.ZIGZAG_GATHER.astype(np.int32))

# dense ISO AC run/level LUT, indexed [run 0..31, |level| 0..40]; len 0
# means no table row (escape).  Codes are at most 16 bits, without sign.
AC_MAX_RUN = ref.MAX_RUN
AC_MAX_LEVEL = ref.MAX_AC_LEVEL
AC_CODE = torch.from_numpy(ref.AC_CODE_CORRECT.astype(np.int32))
AC_LEN = torch.from_numpy(ref.AC_LEN_CORRECT.astype(np.int32))
# the same for compat mode: the reference's run-0 off-by-one (|level| L of
# run 0 holds the level-(L+1) code, L = 40 has no row) and its (16, 2) typo
AC_CODE_COMPAT = torch.from_numpy(ref.AC_CODE_COMPAT.astype(np.int32))
AC_LEN_COMPAT = torch.from_numpy(ref.AC_LEN_COMPAT.astype(np.int32))

# dct_dc_size VLCs stacked as [is_luma, size 0..8] (row 0 chroma, row 1 luma)
DC_CODE = torch.from_numpy(
    np.stack([ref.DC_SIZE_CHROMA_CODE, ref.DC_SIZE_LUMA_CODE]).astype(np.int32)
)
DC_LEN = torch.from_numpy(
    np.stack([ref.DC_SIZE_CHROMA_LEN, ref.DC_SIZE_LUMA_LEN]).astype(np.int32)
)

# the packed tables of the lookup kernel B5 (the reference's ops/mxu_lut.py):
# the ISO AC table rank-compressed to 112 entries `code | len << 16` (rank =
# the row of (run, |level|), see ops/cuda_lut.py::rank_base), and the
# dct_dc_size table, 32 entries `code | len << 8` at is_luma * 16 + size
AC_PACKED = torch.from_numpy(ac_packed_table().astype(np.int32))
DC_PACKED = torch.from_numpy(dc_packed_table().astype(np.int32))
