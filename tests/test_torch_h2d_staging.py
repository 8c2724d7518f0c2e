"""The host-to-device copy of the encoder's inputs (`models/mpeg1.py::to_device`)
and its counter `h2d_copies`.

To a CUDA device an array goes through page-locked staging memory that
`staging_threads` fill in `STAGING_CHUNK`s, each chunk sent on by an
asynchronous copy ("staged"); to any other device it is `torch.from_numpy`
and `.to` as before ("direct").  On the CPU: the values, dtype and shape,
the memory shared with the caller's array as before, non-contiguous input,
and one count per array of every single-device entry.  On the card: the
bytes at the chunk edges and for the entries' shapes and dtypes, the
caller's array written again at once after the return, the pinned blocks
reused from call to call, and more callers than cores copying at once.  The card tests skip without a CUDA card
(decided in a fixture); this file imports nothing of the JAX package, so
on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_h2d_staging.py

Tolerance: exact (0).
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.mpeg1 import (
    STAGING_CHUNK,
    TorchMPEG1IntraEncoder,
    to_device,
)

SHAPES = [((2, 3, 4), np.uint8), ((3, 40, 56, 3), np.uint8), ((2, 5, 64), np.int16),
          ((0, 16, 16), np.uint8)]


@pytest.fixture
def copies():
    """`h2d_copies`, cleared for the test."""
    mpeg1.h2d_copies.clear()
    yield mpeg1.h2d_copies
    mpeg1.h2d_copies.clear()


def _array(shape, dtype, seed=0):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(info.min, info.max, shape, dtype=dtype,
                                                endpoint=True)


# ---- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_cpu_copy_is_direct_and_shares_memory(copies, shape, dtype):
    a = _array(shape, dtype)
    t = to_device(a, "cpu")
    assert t.shape == a.shape and t.dtype == torch.from_numpy(a).dtype
    assert np.array_equal(t.numpy(), a)
    if a.size:
        assert t.data_ptr() == a.ctypes.data  # no copy, as `.to("cpu")` made none
    assert copies == {"direct": 1}


def test_cpu_copy_of_a_strided_view(copies):
    a = _array((4, 40, 56, 3), np.uint8)[::2, :, ::3]
    t = to_device(a, torch.device("cpu"))
    assert t.is_contiguous() and np.array_equal(t.numpy(), a)
    assert copies == {"direct": 1}


@pytest.mark.parametrize("entry,arrays", [("encode", 1), ("encode_from_planes", 3)])
def test_cpu_entries_count_one_copy_an_array(copies, entry, arrays):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    if entry == "encode":
        enc.encode(rgb)
    else:
        enc.encode_from_planes(rgb[..., 0], rgb[:, ::2, ::2, 1], rgb[:, ::2, ::2, 2])
    assert copies == {"direct": arrays}


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_h2d_staging.py`")
    return torch.device("cuda", 0)


EDGES = [1, STAGING_CHUNK - 1, STAGING_CHUNK, STAGING_CHUNK + 1, 3 * STAGING_CHUNK + 5]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbytes", EDGES)
def test_card_copy_at_the_chunk_edges(cuda, copies, nbytes):
    a = _array((nbytes,), np.uint8, seed=nbytes)
    t = to_device(a, cuda)
    assert t.device == cuda and np.array_equal(t.cpu().numpy(), a)
    assert copies == {"staged": 1}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", SHAPES + [((16, 1080, 1920, 3), np.uint8),
                                                  ((16, 8160, 64), np.int16)])
def test_card_copy_equals_to(cuda, copies, shape, dtype):
    a = _array(shape, dtype, seed=7)
    t = to_device(a, cuda)
    want = torch.from_numpy(a).to(cuda)
    assert t.dtype == want.dtype and t.shape == want.shape and torch.equal(t, want)
    assert copies == {"staged": 1}


@pytest.mark.requires_cuda
def test_card_caller_may_write_its_array_at_once(cuda, copies):
    a = _array((16, 1080, 1920, 3), np.uint8, seed=11)
    keep = a.copy()
    t = to_device(a, cuda)
    a[:] = 0  # before the card has taken the staged chunks
    torch.cuda.synchronize()
    assert np.array_equal(t.cpu().numpy(), keep)


def _host_allocs() -> int:
    return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0))


@pytest.mark.requires_cuda
def test_card_twenty_copies_reuse_their_pinned_block(cuda, copies):
    arrays = [_array((16, 360, 640, 3), np.uint8, seed=s) for s in range(2)]
    for a in arrays:
        to_device(a, cuda)
    torch.cuda.synchronize()
    before = _host_allocs()
    for n in range(20):
        t = to_device(arrays[n % 2], cuda)
        assert np.array_equal(t.cpu().numpy(), arrays[n % 2])
    assert _host_allocs() == before
    assert copies == {"staged": 22}


@pytest.mark.requires_cuda
def test_card_copies_from_many_threads_at_once(cuda, copies):
    """More callers than staging threads, each copying its own arrays at once:
    every copy holds its own array's bytes."""
    callers = 2 * (os.cpu_count() or 1) + 1
    arrays = [_array((3 * STAGING_CHUNK + 17,), np.uint8, seed=100 + k) for k in range(callers)]
    wrong, done = [], []

    def copy_many(k):
        for _ in range(5):
            t = to_device(arrays[k], cuda)
            if not np.array_equal(t.cpu().numpy(), arrays[k]):
                wrong.append(k)
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=copy_many, args=(k,)) for k in range(callers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(done) == list(range(callers)) and wrong == []
    assert copies == {"staged": 5 * callers}
