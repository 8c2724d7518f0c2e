"""The reference package's host code that the port shares by import.

None of these modules imports JAX (tests/test_torch_isolation.py checks it
with `import jax` made to fail), so sharing them keeps one copy of the
ISO tables, the header builders, the stream assembly and the spec decoder:

* `tables`: quantizer matrix, zigzag order, dct_dc_size and AC run/level
  VLCs (ISO and compat) as numpy arrays;
* `ac_packed_table`, `dc_packed_table` (`ops/mxu_lut.py`, whose JAX
  imports sit inside its functions): the packed tables of the reference's
  lookup kernel, the rank-compressed AC table (112 entries,
  `code | len << 16`) and the dct_dc_size table (32 entries, index
  is_luma * 16 + size, `code | len << 8`);
* `dct_matrix_f32`: the orthonormal f32 DCT basis of the f32 DCT;
* `MPEG1IntraEncoder`: slice sizing, regrow, headers and `assemble`; its
  `backend="numpy"` path is the host reference the port is checked
  against on the card;
* `slice_bytes_bucket`: slice-buffer size rounding;
* `headers`: start codes, `sequence_end` and the compat system-stream
  builders (pack, system and PES headers, `raw_plane_dump`);
* `decode_es`, `decode_es_fast`, `psnr`: the independent spec decoder;
* compat mode (`models/encoder.py`, whose JAX imports sit inside its
  functions): the crop geometry and slice-buffer constants,
  `_validate_frames`, the host f64 colour `rgb_to_ycbcr_exact` and
  `scale_quantization_matrix`; `encode_compat_reference` is its
  `encode_compat`, whose `backend="numpy"` path is the host reference.

The port never calls the reference's JAX or Pallas functions.
"""

from ec504_imageencoder_tpu.models.decoder import decode_es, decode_es_fast, psnr
from ec504_imageencoder_tpu.models.encoder import (
    CROP_H,
    CROP_W,
    MAX_SLICE_BYTES_COMPAT,
    N_MBS,
    N_SLICES,
    QUANT_SCALE,
    _validate_frames,
)
from ec504_imageencoder_tpu.models.encoder import encode_compat as encode_compat_reference
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder, slice_bytes_bucket
from ec504_imageencoder_tpu.ops.color import rgb_to_ycbcr_exact
from ec504_imageencoder_tpu.ops.dct import dct_matrix_f32
from ec504_imageencoder_tpu.ops.mxu_lut import _dc_packed as dc_packed_table
from ec504_imageencoder_tpu.ops.mxu_lut import ac_packed_table
from ec504_imageencoder_tpu.syntax import headers
from ec504_imageencoder_tpu.utils import tables
from ec504_imageencoder_tpu.utils.tables import scale_quantization_matrix

__all__ = [
    "CROP_H", "CROP_W", "MAX_SLICE_BYTES_COMPAT", "MPEG1IntraEncoder", "N_MBS",
    "N_SLICES", "QUANT_SCALE", "_validate_frames", "ac_packed_table", "dc_packed_table",
    "dct_matrix_f32", "decode_es", "decode_es_fast", "encode_compat_reference", "headers",
    "psnr", "rgb_to_ycbcr_exact", "scale_quantization_matrix", "slice_bytes_bucket", "tables",
]
