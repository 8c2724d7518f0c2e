"""Kernel B5: small-table lookup, and the VLC table lookups built on it.

The CUDA kernel (`csrc/lut_lookup.cu`) replaces the Pallas kernel of
`ec504_imageencoder_tpu/ops/mxu_lut.py::_onehot_lookup_packed_mxu` (the
inner `kernel` of `tpu_lookup`): `table[idx]` for a table of at most 128
entries, 0 for an index outside it.  `lut_lookup_plain` is its plain
PyTorch twin (tensor indexing).  `lut_lookup` runs the twin for CPU
tensors and the kernel for CUDA tensors; there is no other route.

Above it, the host side of `mxu_lut.py` in torch:

* `rank_base`, `rank_count`: the closed forms of the rank-compressed AC
  table's layout (the first rank and the number of rows of each run);
* `ac_rank(ri, al)`: the row of (run, |level|) in the packed AC table;
* `ac_table_lookup(ri, al)`: (code, len) of table B.5c/d without the
  sign bit, len 0 where it has no row;
* `dc_size_lookup(is_luma, size)`: the dct_dc_size VLC;
* `block_streams_lut`: `vlc_device.block_streams_correct64` with its
  lookups through these, the device form of the reference's XLA VLC path
  (`models/mpeg1._emit_and_pack_generic`), which the sanitizer runs after
  the f32 DCT.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ec504_imageencoder_tpu_torch.ops import _build
from ec504_imageencoder_tpu_torch.ops.vlc_device import emit_correct64
from ec504_imageencoder_tpu_torch.utils.tables import AC_PACKED, DC_PACKED

# kernel launches since the last reset (launches for CPU tensors excluded)
launches = 0

MAX_TABLE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {"lut_lookup_launch": [_P, ctypes.c_longlong, _P, _I, _P, _I, _P]}


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    return _build.load("lut_lookup", _ARGTYPES)


def lut_lookup_plain(idx, table):
    """Plain twin of the kernel: same arguments, same outputs."""
    m = table.shape[0]
    hit = (idx >= 0) & (idx < m)
    return torch.where(hit, table[idx.clamp(0, m - 1).long()], 0).to(torch.int32)


def lut_lookup(idx, table):
    """idx: int32 tensor of any shape; table: (m,) int32, 0 < m <= 128, on the
    same device -> int32 tensor of idx's shape: table[idx] where
    0 <= idx < m, else 0."""
    global launches
    if idx.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError(f"idx and table must be int32, got {idx.dtype} and {table.dtype}")
    if table.dim() != 1 or not 0 < table.shape[0] <= MAX_TABLE:
        raise ValueError(f"table must be (m,) with 0 < m <= {MAX_TABLE}, got {tuple(table.shape)}")
    if table.device != idx.device:
        raise ValueError(f"table is on {table.device}, idx on {idx.device}")
    if idx.device.type == "cpu":
        return lut_lookup_plain(idx, table)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("lut_lookup needs contiguous tensors")
    lib = load_kernel()
    out = torch.empty_like(idx)
    err = lib.lut_lookup_launch(
        idx.data_ptr(), idx.numel(), table.data_ptr(), table.shape[0], out.data_ptr(),
        idx.device.index, torch.cuda.current_stream(idx.device).cuda_stream,
    )
    _build.check(lib, "lut_lookup", err)
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    return AC_PACKED.to(device), DC_PACKED.to(device)


def rank_base(ri):
    """The first rank of run ri (0..31) in the packed AC table."""
    b = torch.where(ri <= 16, 2 * ri + 61, ri + 78)  # runs 7..16 / 17..31
    for v, val in ((6, 72), (5, 69), (4, 66), (3, 62), (2, 57), (1, 39), (0, 0)):
        b = torch.where(ri == v, val, b)
    return b


def rank_count(ri):
    """The number of |level| rows of run ri (0..31) in table B.5c/d."""
    c = torch.where(ri <= 16, 2, 1)
    for v, val in ((6, 3), (5, 3), (4, 3), (3, 4), (2, 5), (1, 18), (0, 39)):
        c = torch.where(ri == v, val, c)
    return c


def ac_rank(ri, al):
    """Run ri >= 0 and |level| al -> (int32 index into the packed AC table,
    bool: the table has the row; run 0 starts at |level| 2, '11s' being
    coded apart)."""
    ri = ri.to(torch.int64)
    ric = ri.clamp(0, 31)
    k = al.to(torch.int64) - torch.where(ri == 0, 2, 1)
    valid = (ri <= 31) & (k >= 0) & (k < rank_count(ric))
    rank = (rank_base(ric) + k).clamp(0, AC_PACKED.shape[0] - 1)
    return rank.to(torch.int32), valid


def ac_table_lookup(ri, al):
    """Integer tensors of one shape, run ri >= 0 and |level| al ->
    int64 (code, len) of table B.5c/d without the sign bit; (0, 0) where
    the table has no row."""
    ac, _ = _tables(ri.device)
    rank, valid = ac_rank(ri, al)
    vals = lut_lookup(rank, ac).to(torch.int64)
    return torch.where(valid, vals & 0xFFFF, 0), torch.where(valid, vals >> 16, 0)


def dc_size_lookup(is_luma, size):
    """is_luma (0/1) and dct_dc_size 0..8, integer tensors of one shape ->
    int64 (code, len) of its VLC."""
    _, dc = _tables(size.device)
    vals = lut_lookup((is_luma.to(torch.int32) * 16 + size).to(torch.int32), dc)
    vals = vals.to(torch.int64)
    return vals & 0xFF, vals >> 8


def block_streams_lut(zz, dc_pred, is_luma, mb_first):
    """`vlc_device.block_streams_correct64` (same arguments less the
    tables, same int64 (codes, lens) (..., 64)) with its AC and DC
    lookups through kernel B5."""
    return emit_correct64(zz, dc_pred, is_luma, mb_first, dc_size_lookup, ac_table_lookup)
