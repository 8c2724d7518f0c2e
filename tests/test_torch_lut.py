"""Kernel B5 (`lut_lookup`) and the VLC table lookups built on it, against
the reference's `ops/mxu_lut.py`.

On CPU tensors `lut_lookup` runs its twin (tensor indexing).  The
reference for the kernel is `_onehot_lookup_packed_mxu`, which on the CPU
runs the Pallas kernel's own XLA formulation (the one-hot byte-plane
matmul); `ac_table_lookup` and `dc_size_lookup` are held against the
reference's with jnp and with numpy over every input pair.  Tolerance:
exact (0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.ops import mxu_lut
from ec504_imageencoder_tpu.ops import vlc_device as ref_vlc
from ec504_imageencoder_tpu_torch.ops import cuda_lut
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
from ec504_imageencoder_tpu_torch.ops.vlc_device import block_streams_correct64


@pytest.mark.parametrize("table", ["ac", "dc"])
def test_twin_matches_onehot_kernel(table):
    """Indices over the table, around it and far outside (both signs):
    outside [0, len(table)) the TPU's one-hot rows match nothing, 0."""
    values, bits = ((mxu_lut.ac_packed_table(), 21) if table == "ac"
                    else (mxu_lut._dc_packed(), 12))
    rng = np.random.default_rng(len(values))
    idx = np.concatenate([np.arange(-20, 150), rng.integers(-5000, 5000, 3000),
                          [np.iinfo(np.int32).min, np.iinfo(np.int32).max]]).astype(np.int32)
    want = np.asarray(mxu_lut._onehot_lookup_packed_mxu(jnp.asarray(idx), values, bits, 4096, 4, 6))
    tab = cuda_lut.AC_PACKED if table == "ac" else cuda_lut.DC_PACKED
    assert np.array_equal(tab.numpy().view(np.uint32), values)
    got = cuda_lut.lut_lookup(torch.from_numpy(idx), tab)
    assert got.dtype == torch.int32 and got.shape == idx.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)
    inside = (idx >= 0) & (idx < len(values))
    assert not got.numpy()[~inside].any() and got.numpy()[inside].any()


def test_rank_closed_forms():
    ri = torch.arange(32)
    assert np.array_equal(cuda_lut.rank_base(ri).numpy(), mxu_lut.AC_RANK_BASE)
    assert np.array_equal(cuda_lut.rank_count(ri).numpy(), mxu_lut.AC_RANK_COUNT)


@pytest.mark.parametrize("xp", [jnp, np], ids=["jnp", "np"])
def test_ac_table_lookup_every_pair(xp):
    ri, al = np.meshgrid(np.arange(34), np.arange(260), indexing="ij")
    ri, al = ri.astype(np.int32), al.astype(np.int32)
    want_c, want_l = mxu_lut.ac_table_lookup(xp.asarray(ri), xp.asarray(al), xp)
    got_c, got_l = cuda_lut.ac_table_lookup(torch.from_numpy(ri), torch.from_numpy(al))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c).astype(np.int64))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l).astype(np.int64))
    # the 111 rows of table B.5c/d but (run 0, |level| 1), which is coded apart
    assert int(got_l.max()) == 16 and int((got_l > 0).sum()) == 110


@pytest.mark.parametrize("xp", [jnp, np], ids=["jnp", "np"])
def test_dc_size_lookup_every_pair(xp):
    luma, size = np.meshgrid(np.arange(2), np.arange(9), indexing="ij")
    luma, size = luma.astype(np.int32), size.astype(np.int32)
    want_c, want_l = mxu_lut.dc_size_lookup(xp.asarray(luma), xp.asarray(size), xp)
    got_c, got_l = cuda_lut.dc_size_lookup(torch.from_numpy(luma), torch.from_numpy(size))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c).astype(np.int64))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l).astype(np.int64))


def _levels(rng, shape):
    """Zigzag blocks heavy in escapes and long runs, |level| up to 255."""
    zz = rng.integers(-255, 256, shape + (64,)).astype(np.int32)
    zz[rng.random(zz.shape) < 0.6] = 0
    zz[..., 1:40][rng.random(shape + (39,)) < 0.3] = 0
    small = rng.random(zz.shape) < 0.5
    zz[small] = np.sign(zz[small]) * rng.integers(1, 41, int(small.sum()))  # table rows
    zz[..., 0] = rng.integers(0, 256, shape)
    zz[0, 0, 1:63] = 0                  # run of 62 before slot 63
    zz[0, 0, 63] = -200
    zz[0, 1, 1:] = 0                    # empty block: EOB only
    return zz


@pytest.mark.parametrize("xp", [jnp, np], ids=["jnp", "np"])
def test_block_streams_lut_matches_reference(xp):
    """The device form of the emission (B5 lookups) equals the reference's
    block_streams_correct64 (jnp: through mxu_lut; np: dense tables) and
    the port's dense-table form."""
    rng = np.random.default_rng(5)
    shape = (4, 12)
    zz = _levels(rng, shape)
    pred = rng.integers(0, 256, shape).astype(np.int32)
    comp = np.arange(shape[1]) % 6
    is_luma = np.broadcast_to(comp < 4, shape).astype(np.int32)
    mb_first = np.broadcast_to(comp == 0, shape).astype(np.int32)
    want_c, want_l = ref_vlc.block_streams_correct64(
        xp.asarray(zz), xp.asarray(pred), xp.asarray(is_luma), xp, mb_first=xp.asarray(mb_first))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (zz, pred, is_luma, mb_first)]
    got_c, got_l = cuda_lut.block_streams_lut(*args)
    assert np.array_equal(got_c.numpy(), np.asarray(want_c).astype(np.int64))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l).astype(np.int64))
    luts = Luts.default("cpu")
    dense = block_streams_correct64(*args, luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len)
    assert torch.equal(dense[0], got_c) and torch.equal(dense[1], got_l)


def test_wrapper_checks_inputs():
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_lut.lut_lookup(idx.long(), cuda_lut.AC_PACKED)
    with pytest.raises(ValueError):
        cuda_lut.lut_lookup(idx, torch.zeros(129, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_lut.lut_lookup(idx, torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_lut.lut_lookup(idx, cuda_lut.AC_PACKED.reshape(2, 56))
