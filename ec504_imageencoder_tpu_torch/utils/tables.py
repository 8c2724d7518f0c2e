"""The reference's MPEG-1 tables as torch tensors.

Built from the shared numpy tables (`ec504_imageencoder_tpu_torch.shared`;
no second copy of the ISO numbers).  All are int32 on the CPU; callers
move them to their device (EncodeCore registers them as buffers).
"""

from __future__ import annotations

import numpy as np
import torch

from ec504_imageencoder_tpu_torch.shared import tables as ref

# ZIGZAG_GATHER[k] = flat (v*8 + u) index of the k-th scanned coefficient
ZIGZAG_GATHER = torch.from_numpy(ref.ZIGZAG_GATHER.astype(np.int32))

# dense ISO AC run/level LUT, indexed [run 0..31, |level| 0..40]; len 0
# means no table row (escape).  Codes are at most 16 bits, without sign.
AC_MAX_RUN = ref.MAX_RUN
AC_MAX_LEVEL = ref.MAX_AC_LEVEL
AC_CODE = torch.from_numpy(ref.AC_CODE_CORRECT.astype(np.int32))
AC_LEN = torch.from_numpy(ref.AC_LEN_CORRECT.astype(np.int32))

# dct_dc_size VLCs stacked as [is_luma, size 0..8] (row 0 chroma, row 1 luma)
DC_CODE = torch.from_numpy(
    np.stack([ref.DC_SIZE_CHROMA_CODE, ref.DC_SIZE_LUMA_CODE]).astype(np.int32)
)
DC_LEN = torch.from_numpy(
    np.stack([ref.DC_SIZE_CHROMA_LEN, ref.DC_SIZE_LUMA_LEN]).astype(np.int32)
)
