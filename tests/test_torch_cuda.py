"""CUDA kernels of the port against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and nvcc; without them each one skips
(the decision is made in a fixture, never at import).  On the GPU machine,
where JAX is absent, run without the repository's conftest (it imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact (0) everywhere; the whole path is integer arithmetic.
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.ops import cuda_pack, cuda_vlc
from ec504_imageencoder_tpu_torch.shared import MPEG1IntraEncoder

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_cuda.py`")
    return torch.device("cuda", 0)


def _planes(rng, b, h, w, dev):
    shapes = ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2))
    return tuple(torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
                 for s in shapes)


@pytest.mark.parametrize("quality", [5, 50, 69, 95])
@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 48, 4096), (3, 16, 16)])
def test_vlc_kernel_matches_twin(cuda, quality, shape):
    rng = np.random.default_rng(quality * 7 + shape[2])
    core = TorchMPEG1IntraEncoder(quality=quality, dct_impl="aan", device=cuda).core
    planes = _planes(rng, *shape, cuda)
    got = cuda_vlc.vlc_fused4(*planes, core.qw, core.luts())
    want = cuda_vlc.vlc_fused4_plain(*planes, core.qw, core.luts())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("max_words", [640, 7, 342528 // 4])
def test_pack_kernel_matches_twin(cuda, max_words):
    """Random values of up to 128 bits; 7 words overflows every slice,
    342528 B exceeds shared memory and takes the global-memory path."""
    rng = np.random.default_rng(max_words)
    n, kf = 5, 3000
    flens = rng.integers(0, 129, (n, kf))
    flens[rng.random((n, kf)) < 0.3] = 0
    words = rng.integers(0, 1 << 32, (4, n, kf), dtype=np.uint64)
    # mask each value to its length (v0 is the most significant word)
    for i in range(4):
        keep = np.clip(flens - 32 * (3 - i), 0, 32).astype(np.uint64)
        words[i] &= (np.uint64(1) << keep) - np.uint64(1)
    vs = [torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(cuda) for w in words]
    fl = torch.from_numpy(flens.astype(np.int32)).to(cuda)
    seg, nbits = cuda_pack.pack_fused4(*vs, fl, max_words, bit_offset=38)
    seg_t, nbits_t = cuda_pack.pack_fused4_plain(*vs, fl, max_words, bit_offset=38)
    assert torch.equal(nbits, nbits_t)
    assert torch.equal(seg, seg_t)


def test_launch_counts_and_encoder_bytes(cuda):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    cuda_vlc.launches = cuda_pack.launches = 0
    got = TorchMPEG1IntraEncoder(quality=50, max_slice_bytes=2560, device=cuda).encode(frames)
    assert cuda_vlc.launches > 0 and cuda_pack.launches > 0
    want = MPEG1IntraEncoder(quality=50, max_slice_bytes=2560, backend="numpy").encode(frames)
    assert got == want


def test_kernel_wrappers_reject_bad_input(cuda):
    core = TorchMPEG1IntraEncoder(quality=50, device=cuda).core
    y, cb, cr = _planes(np.random.default_rng(0), 1, 32, 32, cuda)
    with pytest.raises(ValueError):
        cuda_vlc.vlc_fused4(y.transpose(1, 2), cb, cr, core.qw, core.luts())
    with pytest.raises(ValueError):
        cuda_vlc.vlc_fused4(y, cb.cpu(), cr, core.qw, core.luts())
    v = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_pack.pack_fused4(v, v, v, v, v.t(), 16)
