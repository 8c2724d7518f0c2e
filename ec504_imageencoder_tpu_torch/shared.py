"""The reference package's host code that the port shares by import.

None of these modules imports JAX (tests/test_torch_isolation.py checks it
with `import jax` made to fail), so sharing them keeps one copy of the
ISO tables, the header builders, the stream assembly and the spec decoder:

* `tables`: quantizer matrix, zigzag order, dct_dc_size and AC run/level
  VLCs as numpy arrays;
* `MPEG1IntraEncoder`: slice sizing, regrow, headers and `assemble`; its
  `backend="numpy"` path is the host reference the port is checked
  against on the card;
* `slice_bytes_bucket`: slice-buffer size rounding;
* `headers`: start codes and `sequence_end`;
* `decode_es`, `decode_es_fast`, `psnr`: the independent spec decoder.

The port never calls the reference's JAX or Pallas functions.
"""

from ec504_imageencoder_tpu.models.decoder import decode_es, decode_es_fast, psnr
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder, slice_bytes_bucket
from ec504_imageencoder_tpu.syntax import headers
from ec504_imageencoder_tpu.utils import tables

__all__ = [
    "MPEG1IntraEncoder", "decode_es", "decode_es_fast", "headers", "psnr",
    "slice_bytes_bucket", "tables",
]
