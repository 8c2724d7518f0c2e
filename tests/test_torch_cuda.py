"""CUDA kernels of the port against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and nvcc; without them each one skips
(the decision is made in a fixture, never at import).  On the GPU machine,
where JAX is absent, run without the repository's conftest (it imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The encoders on the card are held against the JAX package's numpy
reference (`backend="numpy"`, host code that imports no JAX) and against
the same encoders on the CPU (the twins); the CLI and the C ABI shim on
the card against the same entry points on the CPU; the sharded encoder on
meshes of cuda:0 (and, with two cards, over both) against the CPU.

Tolerance: exact (0) everywhere: the kernels are integer arithmetic, and
the f32 DCT in front of B3 is separate IEEE f32 multiplies and adds in the
reference's numpy order, the same bits on the card as on the host.
"""

import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models.encoder import encode_compat as encode_compat_reference
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu_torch import cli, mpeg_encode_procedure
from ec504_imageencoder_tpu_torch.io import _native
from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.encoder import encode_compat
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder, plane_levels
from ec504_imageencoder_tpu_torch.ops import (
    bitpack,
    cuda_lut,
    cuda_pack,
    cuda_pack_split,
    cuda_vlc,
    cuda_vlc_compat,
    cuda_vlc_levels,
    cuda_vlc_raw,
)
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
from ec504_imageencoder_tpu_torch.ops.dct import matmul_dct
from ec504_imageencoder_tpu_torch.parallel.mesh import make_mesh
from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import ShardedTorchMPEG1Encoder
from ec504_imageencoder_tpu_torch.utils.tables import scale_quantization_matrix


def _cpu_encode(frames, **kw):
    """The same encoder on the CPU (the kernels' twins)."""
    return TorchMPEG1IntraEncoder(device="cpu", **kw).encode(frames)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_cuda.py`")
    return torch.device("cuda", 0)


def _planes(rng, b, h, w, dev, content="noise"):
    """Random 4:2:0 planes: "noise"; "flat" (one value per frame and plane:
    every AC level 0, only the DC and the EOB); "checker" (a checkerboard of
    random contrast: the last zigzag level is nonzero, at q=100 an
    escape); "last" (a checkerboard of contrast 100..110: at q=5 the last
    zigzag level is the only nonzero AC level, a run of 62, an escape)."""
    shapes = ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2))
    out = []
    for s in shapes:
        if content == "noise":
            p = rng.integers(0, 256, s, dtype=np.uint8)
        elif content == "flat":
            p = np.broadcast_to(rng.integers(0, 256, (b, 1, 1)), s)
        else:
            yy, xx = np.indices(s[1:])
            hi = 128 if content == "checker" else 111
            p = 128 + rng.integers(100, hi, (b, 1, 1)) * (((yy + xx) & 1) * 2 - 1)
        out.append(torch.from_numpy(np.ascontiguousarray(p, dtype=np.uint8)).to(dev))
    return tuple(out)


# B1, B6a, B6b and B3 emit a block with 16 lanes and a warp per two blocks,
# B1, B6a and B6b in groups of 128 blocks: 1920 (720 blocks a row) and 1408
# (528) leave a half-warp in the last group, 16 and 48 a short one, 4096
# runs 12 groups.
EMIT_SHAPES = [(2, 32, 48), (1, 48, 4096), (3, 16, 16), (1, 16, 1920), (2, 16, 1408)]


@pytest.mark.parametrize("content", ["noise", "flat", "checker"])
@pytest.mark.parametrize("quality", [5, 50, 69, 95])
@pytest.mark.parametrize("shape", EMIT_SHAPES)
def test_vlc_kernel_matches_twin(cuda, quality, shape, content):
    rng = np.random.default_rng(quality * 7 + shape[2])
    core = TorchMPEG1IntraEncoder(quality=quality, dct_impl="aan", device=cuda).core
    planes = _planes(rng, *shape, cuda, content)
    got = cuda_vlc.vlc_fused4(*planes, core.qw, core.luts())
    want = cuda_vlc.vlc_fused4_plain(*planes, core.qw, core.luts())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _fused_slots(rng, n, kf, dev):
    """(n, kf) random fused slots of up to 128 bits, each value masked to
    its length (v0 is the most significant word): [v0, v1, v2, v3, flens]."""
    flens = rng.integers(0, 129, (n, kf))
    flens[rng.random((n, kf)) < 0.3] = 0
    words = rng.integers(0, 1 << 32, (4, n, kf), dtype=np.uint64)
    for i in range(4):
        keep = np.clip(flens - 32 * (3 - i), 0, 32).astype(np.uint64)
        words[i] &= (np.uint64(1) << keep) - np.uint64(1)
    vs = [torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev) for w in words]
    return [*vs, torch.from_numpy(flens.astype(np.int32)).to(dev)]


# B2's slots per row: 3000; one tile -1, +0, +1 (+1 is odd, not a multiple
# of the slots per thread: the scalar loads); a 1080p row's 11,520
KF_CASES = [3000, "tile-1", "tile", "tile+1", 11520]


def _kf(case) -> int:
    if isinstance(case, int):
        return case
    tile = cuda_pack.fused4_tile()
    return tile + {"tile-1": -1, "tile": 0, "tile+1": 1}[case]


def _offset(slots, unaligned: bool):
    """The planes, each as a view one element into a larger tensor when
    `unaligned` (no vector loads)."""
    if not unaligned:
        return slots
    return [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape) for t in slots]


def _pack_inputs(rng, n, kf, dev, unaligned: bool):
    """_fused_slots, off alignment when `unaligned`."""
    return _offset(_fused_slots(rng, n, kf, dev), unaligned)


@pytest.mark.parametrize("unaligned", [False, True], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("kf", KF_CASES, ids=str)
@pytest.mark.parametrize("max_words", [640, 7, 342528 // 4])
def test_pack_kernel_matches_twin(cuda, max_words, kf, unaligned):
    """Random values of up to 128 bits; 7 words overflows every slice,
    342528 B exceeds shared memory and takes the global-memory path; rows
    at B2's tile edges, of a 1080p row's length, and planes whose bases
    are not aligned for vector loads."""
    slots = _pack_inputs(np.random.default_rng(max_words), 5, _kf(kf), cuda, unaligned)
    seg, nbits = cuda_pack.pack_fused4(*slots, max_words, bit_offset=38)
    seg_t, nbits_t = cuda_pack.pack_fused4_plain(*slots, max_words, bit_offset=38)
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
    assert got == _cpu_encode(frames, quality=50, max_slice_bytes=2560)


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


@pytest.mark.parametrize("content", ["noise", "flat", "checker", "last-only"])
@pytest.mark.parametrize("quality", [70, 85, 100])
@pytest.mark.parametrize("shape", EMIT_SHAPES)
def test_levels_kernel_matches_twin(cuda, quality, shape, content):
    """"last-only": the noise's levels with every AC level but the last
    cleared, so its run is 62 (an escape), of random size and sign."""
    rng = np.random.default_rng(quality * 7 + shape[2])
    core = TorchMPEG1IntraEncoder(quality=quality, device=cuda).core
    planes = _planes(rng, *shape, cuda, "noise" if content == "last-only" else content)
    levels, preds = plane_levels(*planes, core.qw, core.zigzag)
    if content == "last-only":
        levels[..., 1:63] = 0
        last = rng.integers(1, 256, levels.shape[:2]) * rng.choice([-1, 1], levels.shape[:2])
        levels[..., 63] = torch.from_numpy(last.astype(np.int32)).to(cuda)
    got = cuda_vlc_levels.vlc_levels4(levels, preds, core.luts())
    want = cuda_vlc_levels.vlc_levels4_plain(levels, preds, core.luts())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_f32_dct_same_bits_on_card_and_host(cuda):
    blocks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (999, 8, 8), dtype=np.uint8))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(matmul_dct(blocks.to(cuda)).cpu(), matmul_dct(blocks))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# B4a and B4b take flat groups of 128 blocks, 324 a frame: 1 frame leaves a
# last group of 68, 2 of 8, 30 of 120, 480 none; 401, 101 and 601 are odd
# widths; at 602 and 610 (W % 8 != 0) the kernels read bytes, at 96 and
# 600 4-byte words (chroma's half-width rows at 300 only 4-byte aligned)
COMPAT_SHAPES = [(2, 150, 401), (1, 144, 96), (30, 150, 101), (480, 144, 96), (1, 144, 600),
                 (2, 150, 601), (2, 150, 602), (1, 151, 610)]


@pytest.mark.parametrize("content", ["noise", "flat", "checker"])
@pytest.mark.parametrize("quality", [1, 12, 50, 100])
@pytest.mark.parametrize("shape", COMPAT_SHAPES)
def test_compat_kernels_match_twins(cuda, quality, shape, content):
    """B4a and B4b against their twins on noise (at q=1 nearly every slot
    is nonzero, so the Q5 drop at slot 1 is common; q=100 escapes), flat
    frames (the DC alone, 0 for dark frames) and checkerboards (the last
    zigzag level nonzero)."""
    rng = np.random.default_rng(quality + shape[0] + shape[2])
    frames = shape[0]
    if content == "noise":
        arrays = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    elif content == "flat":
        arrays = [np.broadcast_to(rng.integers(0, 256, (frames, 1, 1)), shape) for _ in range(3)]
    else:
        yy, xx = np.indices(shape[1:])
        arrays = [128 + rng.integers(100, 128, (frames, 1, 1)) * (((yy + xx) & 1) * 2 - 1)
                  for _ in range(3)]
    planes = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(cuda)
                   for a in arrays)
    q = torch.from_numpy(scale_quantization_matrix(quality).astype(np.int32)).to(cuda)
    luts = Luts.compat(cuda)
    for kernel, twin in ((cuda_vlc_compat.vlc_compat_slots, cuda_vlc_compat.vlc_compat_slots_plain),
                         (cuda_vlc_compat.vlc_compat_fused4, cuda_vlc_compat.vlc_compat_fused4_plain)):
        got, want = kernel(*planes, q, luts), twin(*planes, q, luts)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_compat_kernels_repeat_and_run_on_a_side_stream(cuda):
    """B4a and B4b twice back to back, once on a side stream and once on
    planes one byte off their alignment (the byte loads at W % 8 == 0) give
    the twins' outputs."""
    rng = np.random.default_rng(91)
    planes = tuple(torch.from_numpy(rng.integers(0, 256, (3, 144, 96), dtype=np.uint8)).to(cuda)
                   for _ in range(3))
    shifted = tuple(torch.cat([p.new_zeros(1), p.reshape(-1)])[1:].view(p.shape) for p in planes)
    q = torch.from_numpy(scale_quantization_matrix(50).astype(np.int32)).to(cuda)
    luts = Luts.compat(cuda)
    side = torch.cuda.Stream(cuda)
    for fn, twin in ((cuda_vlc_compat.vlc_compat_slots, cuda_vlc_compat.vlc_compat_slots_plain),
                     (cuda_vlc_compat.vlc_compat_fused4, cuda_vlc_compat.vlc_compat_fused4_plain)):
        first, second = fn(*planes, q, luts), fn(*planes, q, luts)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            third = fn(*planes, q, luts)
        torch.cuda.current_stream(cuda).wait_stream(side)
        fourth = fn(*shifted, q, luts)
        torch.cuda.synchronize(cuda)
        want = twin(*planes, q, luts)
        for got in (first, second, third, fourth):
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w)


def test_high_quality_and_compat_encoders(cuda, tmp_path):
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    cuda_vlc.launches = cuda_vlc_levels.launches = cuda_pack.launches = 0
    got = TorchMPEG1IntraEncoder(quality=85, device=cuda).encode(frames)
    assert cuda_vlc_levels.launches > 0 and cuda_pack.launches > 0 and cuda_vlc.launches == 0
    assert got == MPEG1IntraEncoder(quality=85, backend="numpy").encode(frames)
    assert got == _cpu_encode(frames, quality=85)

    frames = rng.integers(0, 256, (3, 150, 101, 3), dtype=np.uint8)
    cuda_vlc_compat.launches_fused4 = cuda_vlc_compat.launches_slots = 0
    cuda_vlc_compat.launches_color = 0
    want = encode_compat_reference(frames, 12, backend="numpy")
    assert encode_compat(frames, 12, device="cpu") == want
    assert encode_compat(frames, 12, device=cuda) == want
    assert encode_compat(frames, 12, device=cuda, debug_checks=True) == want
    assert cuda_vlc_compat.launches_fused4 == cuda_vlc_compat.launches_slots == 1
    assert cuda_vlc_compat.launches_color == 2


def test_new_wrappers_reject_bad_input(cuda):
    lv = torch.zeros((2, 12, 64), dtype=torch.int32, device=cuda)
    pr = torch.zeros((2, 12), dtype=torch.int32, device=cuda)
    luts = Luts.default(cuda)
    with pytest.raises(ValueError):
        cuda_vlc_levels.vlc_levels4(lv[:, :10], pr[:, :10], luts)   # not whole MBs
    with pytest.raises(ValueError):
        cuda_vlc_levels.vlc_levels4(lv, pr.cpu(), luts)
    shifted = torch.zeros(2 * 12 * 64 + 1, dtype=torch.int32, device=cuda)[1:].view(2, 12, 64)
    with pytest.raises(ValueError):
        cuda_vlc_levels.vlc_levels4(shifted, pr, luts)              # not 16-byte aligned
    y = torch.zeros((1, 144, 96), dtype=torch.uint8, device=cuda)
    q = torch.ones((8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_vlc_compat.vlc_compat_fused4(y, y.cpu(), y, q, Luts.compat(cuda))
    y_t = torch.zeros((1, 96, 144), dtype=torch.uint8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        cuda_vlc_compat.vlc_compat_slots(y_t, y, y, q, Luts.compat(cuda))


# ---- the sanitizer's kernels: B6a, B5 and B2's checked form ---------------

@pytest.mark.parametrize("content", ["noise", "flat", "checker", "last"])
@pytest.mark.parametrize("quality", [5, 50, 95, 100])
@pytest.mark.parametrize("shape", EMIT_SHAPES)
def test_raw_kernel_matches_twin(cuda, quality, shape, content):
    """B6a: at q=100 noise gives 28-bit escapes, at q=5 "last" runs of 62."""
    rng = np.random.default_rng(quality * 11 + shape[2])
    core = TorchMPEG1IntraEncoder(quality=quality, dct_impl="aan", device=cuda).core
    planes = _planes(rng, *shape, cuda, content)
    got = cuda_vlc_raw.vlc_raw(*planes, core.qw, core.luts())
    want = cuda_vlc_raw.vlc_raw_plain(*planes, core.qw, core.luts())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[2].any()


@pytest.mark.parametrize("n", [1, 1000, 3 * 2**20 + 7])
def test_lut_kernel_matches_twin(cuda, n):
    """Indices in and around both packed tables, out-of-range ones too."""
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(rng.integers(-40, 160, n).astype(np.int32)).to(cuda)
    for table in (cuda_lut.AC_PACKED, cuda_lut.DC_PACKED):
        t = table.to(cuda)
        assert torch.equal(cuda_lut.lut_lookup(idx, t), cuda_lut.lut_lookup_plain(idx, t))


@pytest.mark.parametrize("unaligned", [False, True], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("kf", KF_CASES, ids=str)
@pytest.mark.parametrize("max_words", [640, 7, 342528 // 4])
def test_checked_pack_kernel_matches_twin(cuda, max_words, kf, unaligned):
    """Healthy slots: the unchecked kernel's bytes and no violation.  Fused
    lengths of 200 and 129 at the first slot of a row's last tile and the
    last slot of its first tile: the same counts as the twin.  Overlapping
    bits: a count above 0 (its multiplicity depends on the order of the
    atomics).  The rows and planes of test_pack_kernel_matches_twin."""
    kf = _kf(kf)
    slots = _pack_inputs(np.random.default_rng(max_words), 5, kf, cuda, unaligned)
    seg, nbits, viol = cuda_pack.pack_fused4(*slots, max_words, bit_offset=38, checks=True)
    seg_u, nbits_u = cuda_pack.pack_fused4(*slots, max_words, bit_offset=38)
    assert torch.equal(seg, seg_u) and torch.equal(nbits, nbits_u)
    assert not viol.any()

    tile = cuda_pack.fused4_tile()
    bad = [t.clone() for t in slots]
    bad[4][1, (kf - 1) // tile * tile] = 200
    bad[4][3, min(tile, kf) - 1] = 129
    bad = _offset(bad, unaligned)
    got = cuda_pack.pack_fused4(*bad, max_words, bit_offset=38, checks=True)
    want = cuda_pack.pack_fused4_plain(*bad, max_words, bit_offset=38, checks=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].tolist() == [0, 1, 0, 1, 0]

    over = [t.clone() for t in slots]
    for t in over[:3]:
        t[2, :20] = 0
    over[3][2, :20] = -1  # 16 one bits above each 16-bit length
    over[4][2, :20] = 16
    over = _offset(over, unaligned)
    got = cuda_pack.pack_fused4(*over, max_words, bit_offset=38, checks=True)
    want = cuda_pack.pack_fused4_plain(*over, max_words, bit_offset=38, checks=True)
    assert torch.equal(got[1], want[1])
    assert ((got[2] > 0) == (want[2] > 0)).all() and got[2].tolist()[2] > 0


def test_debug_checks_encoder(cuda, monkeypatch):
    """debug_checks on the card: the bytes of the numpy reference, through
    B6a (q=50) or B5 (q=85) and the checked B2, never B1 or B3; an injected
    slot violation raises."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    for quality, kernel in ((50, cuda_vlc_raw), (85, cuda_lut)):
        cuda_vlc.launches = cuda_vlc_levels.launches = cuda_vlc_raw.launches = 0
        cuda_lut.launches = cuda_pack.launches = cuda_pack.launches_checked = 0
        enc = TorchMPEG1IntraEncoder(quality=quality, debug_checks=True, device=cuda)
        got = enc.encode(frames)
        assert got == MPEG1IntraEncoder(quality=quality, backend="numpy").encode(frames)
        assert got == _cpu_encode(frames, quality=quality)
        assert kernel.launches > 0 and cuda_pack.launches_checked > 0
        assert cuda_vlc.launches == cuda_vlc_levels.launches == cuda_pack.launches == 0

    def corrupt(*args):
        codes, lens, viol = cuda_vlc_raw.vlc_raw(*args)
        lens[0, 5, 0] = 31
        return codes, lens, viol

    monkeypatch.setattr(mpeg1, "vlc_raw", corrupt)
    with pytest.raises(RuntimeError, match="invariant violations"):
        TorchMPEG1IntraEncoder(quality=50, debug_checks=True, device=cuda).encode(frames)


# ---- the 8:1-fusion path: B6b and B6c -------------------------------------

@pytest.mark.parametrize("content", ["noise", "flat", "checker", "last"])
@pytest.mark.parametrize("quality", [5, 50, 95, 100])
@pytest.mark.parametrize("shape", EMIT_SHAPES)
def test_fused8_kernel_matches_twin(cuda, quality, shape, content):
    rng = np.random.default_rng(quality * 13 + shape[2])
    core = TorchMPEG1IntraEncoder(quality=quality, dct_impl="aan", device=cuda).core
    planes = _planes(rng, *shape, cuda, content)
    words, flens = cuda_vlc.vlc_fused8(*planes, core.qw, core.luts())
    want_w, want_l = cuda_vlc.vlc_fused8_plain(*planes, core.qw, core.luts())
    assert torch.equal(flens, want_l)
    for g, w in zip(words, want_w):
        assert torch.equal(g, w)


def _flat(out):
    """B6b's (words, flens) or B6a's (codes, lens, guard) as one list."""
    return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]


def test_vlc_kernels_repeat_and_run_on_a_side_stream(cuda):
    """B6a and B6b twice back to back and once on a side stream give the
    twins' outputs (B6a adds its guard counts to a buffer its wrapper
    zeroes at each call)."""
    planes = _planes(np.random.default_rng(78), 3, 64, 1408, cuda)
    core = TorchMPEG1IntraEncoder(quality=50, dct_impl="aan", device=cuda).core
    args = (*planes, core.qw, core.luts())
    side = torch.cuda.Stream(cuda)
    for fn, twin in ((cuda_vlc_raw.vlc_raw, cuda_vlc_raw.vlc_raw_plain),
                     (cuda_vlc.vlc_fused8, cuda_vlc.vlc_fused8_plain)):
        first, second = fn(*args), fn(*args)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            third = fn(*args)
        torch.cuda.current_stream(cuda).wait_stream(side)
        torch.cuda.synchronize(cuda)
        want = _flat(twin(*args))
        for got in (first, second, third):
            for g, w in zip(_flat(got), want, strict=True):
                assert torch.equal(g, w)


def _fused8_slots(rng, n, kf, dev):
    """(n, kf) random 8-word slots of up to 256 bits, each value masked to
    its length (w0 the most significant word): ([w0, ..., w7], flens)."""
    flens = rng.integers(0, 257, (n, kf))
    flens[rng.random((n, kf)) < 0.3] = 0
    words = rng.integers(0, 1 << 32, (8, n, kf), dtype=np.uint64)
    for i in range(8):
        keep = np.clip(flens - 32 * (7 - i), 0, 32).astype(np.uint64)
        words[i] &= (np.uint64(1) << keep) - np.uint64(1)
    ws = [torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev) for w in words]
    return ws, torch.from_numpy(flens.astype(np.int32)).to(dev)


@pytest.mark.parametrize("max_words", [1000, 7, 342528 // 4])
def test_pack8_kernel_matches_twin(cuda, max_words):
    """Random values of up to 256 bits; 7 words overflows every slice,
    342528 B exceeds shared memory and takes the global-memory path."""
    words, flens = _fused8_slots(np.random.default_rng(max_words), 5, 1500, cuda)
    seg, nbits = cuda_pack.pack_fused8(words, flens, max_words, bit_offset=38)
    seg_t, nbits_t = cuda_pack.pack_fused8_plain(words, flens, max_words, bit_offset=38)
    assert torch.equal(nbits, nbits_t)
    assert torch.equal(seg, seg_t)


def test_fuse8_encoder(cuda):
    """fuse=8 on the card: the numpy reference's bytes (and the CPU
    encoder's), through B6b and B6c, never B1 or the unchecked B2; a
    forced regrow lands."""
    frames = np.random.default_rng(8).integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    cuda_vlc.launches = cuda_pack.launches = cuda_vlc.launches8 = cuda_pack.launches8 = 0
    enc = TorchMPEG1IntraEncoder(quality=50, fuse=8, max_slice_bytes=2560, device=cuda)
    got = enc.encode(frames)
    want = MPEG1IntraEncoder(quality=50, max_slice_bytes=2560, backend="numpy").encode(frames)
    assert got == want
    assert got == _cpu_encode(frames, quality=50, max_slice_bytes=2560)
    assert cuda_vlc.launches8 > 0 and cuda_pack.launches8 > 0
    assert cuda_vlc.launches == cuda_pack.launches == 0


# ---- pack=: the raw-code pack kernels K1-K4 --------------------------------

RAW_KERNELS = {"pallas1": (cuda_pack, "pack_raw", "launches_raw"),
               "pallas3": (cuda_pack_split, "pack_windows", "launches_windows"),
               "fused": (cuda_pack_split, "pack_split", "launches_split"),
               "fused2w": (cuda_pack, "pack_pairs", "launches_pairs")}


def _raw_slots(rng, n, k, dev, content="random"):
    """(n, k) raw codes masked to their lengths, and their int32 lengths:
    "random" up to 30 bits (so that fuse4 takes them too), 40% empty;
    "zeros", "ones" and "all32" every length 0, 1 or 32; "zero-runs"
    1..30 bits with runs of 3,000-9,000 empty codes, across K3's chunks
    (2,048 codes) and K4's tiles (4,096)."""
    if content == "random":
        lens = rng.integers(0, 31, (n, k))
        lens[rng.random((n, k)) < 0.4] = 0
    elif content == "zero-runs":
        lens = rng.integers(1, 31, (n, k))
        for r in range(n):
            for s in rng.integers(0, k, 2):
                lens[r, s:s + rng.integers(3000, 9000)] = 0
    else:
        lens = np.full((n, k), {"zeros": 0, "ones": 1, "all32": 32}[content])
    codes = rng.integers(0, 1 << 32, (n, k)) & ((1 << lens) - 1)
    return tuple(torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)
                 for a in (codes, lens))


def _raw_kernels_equal_twin(codes, lens, max_words, b2=False):
    """K1-K4 byte-equal to the twin, bit counts included; with b2 also B2
    on the 4:1 fusion of the same slots."""
    want = cuda_pack.pack_raw_plain(codes, lens, max_words, bit_offset=38)
    if b2:
        fused = tuple(cuda_vlc.to_i32_bits(t) for t in bitpack.fuse4(codes, lens))
        via_b2 = cuda_pack.pack_fused4(*fused, max_words, bit_offset=38)
        assert torch.equal(via_b2[0], want[0]) and torch.equal(via_b2[1], want[1])
    for pack, (mod, fn, _) in RAW_KERNELS.items():
        seg, nbits = getattr(mod, fn)(codes, lens, max_words, bit_offset=38)
        assert torch.equal(nbits, want[1]), pack
        assert torch.equal(seg, want[0]), pack
    return want


@pytest.mark.parametrize("content", ["random", "zeros", "ones", "all32", "zero-runs"])
@pytest.mark.parametrize("k", [46080, 4095, 1, 100, 4096, 4097, 511, 512, 513])
@pytest.mark.parametrize("max_words", [5888, 7, 1000, "used", 342528 // 4])
def test_raw_pack_kernels_match_twins(cuda, max_words, k, content):
    """K1-K4 against their twins (and, for "random" at K % 4 == 0, B2 on
    the 4:1 fusion of the same slots): a 1080p row's 46,080 slots, an odd
    count, a row shorter than one tile, exactly one K4 tile and one code
    past it, and one code short of K1's tile (512), one tile and one code
    past it; 7 words overflows every slice, 1000 is no multiple of 128 and
    ends inside a tile, "used" is exactly the longest row's words, 342528 B
    exceeds shared memory (K1, K2 place in global memory)."""
    rng = np.random.default_rng(k + (max_words if isinstance(max_words, int) else 3))
    codes, lens = _raw_slots(rng, 5, k, cuda, content)
    if max_words == "used":
        max_words = max(-(-(38 + int(lens.sum(dim=1).max())) // 32), 1)
    want = _raw_kernels_equal_twin(codes, lens, max_words, b2=content == "random" and k % 4 == 0)
    pairs = cuda_pack.pack_pairs_plain(codes, lens, max_words, bit_offset=38)
    assert torch.equal(pairs[0], want[0]) and torch.equal(pairs[1], want[1])


@pytest.mark.parametrize("shape", [(1088, 4608), (3, 0), (0, 4096)],
                         ids=["many-tiles", "k0", "n0"])
def test_raw_pack_kernels_edge_shapes(cuda, shape):
    """1,088 rows of 4,608 codes (many K3 chunks and K4 tiles in flight),
    empty rows (zeros and the bit offset) and no rows."""
    codes, lens = _raw_slots(np.random.default_rng(shape[1]), *shape, cuda)
    mw = 342528 // 4 if shape[1] == 0 else 2945
    want = _raw_kernels_equal_twin(codes, lens, mw)
    if shape == (3, 0):
        assert (want[1] == 38).all() and not want[0].any()


def test_split_packs_repeat_and_run_on_a_side_stream(cuda):
    """K3 and K4 twice back to back and once on a side stream give the
    same bytes: their scratch (chunk totals, status words and the tile
    counter) is set anew by every launch."""
    codes, lens = _raw_slots(np.random.default_rng(77), 64, 46080, cuda)
    side = torch.cuda.Stream(cuda)
    for fn in (cuda_pack_split.pack_windows, cuda_pack_split.pack_split):
        first = fn(codes, lens, 5888, bit_offset=38)
        second = fn(codes, lens, 5888, bit_offset=38)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            third = fn(codes, lens, 5888, bit_offset=38)
        torch.cuda.current_stream(cuda).wait_stream(side)
        torch.cuda.synchronize(cuda)
        want = cuda_pack.pack_raw_plain(codes, lens, 5888, bit_offset=38)
        for got in (first, second, third):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("pack", list(RAW_KERNELS))
def test_pack_route_encoder(cuda, pack):
    """pack= on the card: the numpy reference's bytes (and the CPU
    encoder's) at q=50 (AAN) and q=85 (f32), with a forced regrow, through
    B5 and the chosen kernel, never B1, B2, B3 or B6a."""
    mod, _, counter = RAW_KERNELS[pack]
    frames = np.random.default_rng(9).integers(0, 256, (2, 40, 520, 3), dtype=np.uint8)
    for quality in (50, 85):
        setattr(mod, counter, 0)
        cuda_lut.launches = cuda_vlc.launches = cuda_vlc_levels.launches = 0
        cuda_pack.launches = cuda_vlc_raw.launches = 0
        enc = TorchMPEG1IntraEncoder(quality=quality, max_slice_bytes=2560, pack=pack,
                                     device=cuda)
        got = enc.encode(frames)
        want = MPEG1IntraEncoder(quality=quality, max_slice_bytes=2560, backend="numpy")
        assert got == want.encode(frames)
        assert got == _cpu_encode(frames, quality=quality, max_slice_bytes=2560)
        assert enc.max_slice_bytes > 2560
        assert getattr(mod, counter) > 0 and cuda_lut.launches > 0
        assert cuda_vlc.launches == cuda_vlc_levels.launches == 0
        assert cuda_pack.launches == cuda_vlc_raw.launches == 0


# ---- every launcher leaves the caller's current device --------------------

def _launch_each_kernel(dev):
    """kernel -> a call of its wrapper that launches it once on dev, at a
    small size (B6d and B6e are one kernel, K1 `pack_raw`)."""
    rng = np.random.default_rng(12)
    core = TorchMPEG1IntraEncoder(quality=50, device=dev).core
    hq = TorchMPEG1IntraEncoder(quality=85, device=dev).core
    planes = _planes(rng, 1, 16, 48, dev)
    slots = cuda_vlc.vlc_fused4(*planes, core.qw, core.luts())
    words8, flens8 = cuda_vlc.vlc_fused8(*planes, core.qw, core.luts())
    levels, preds = plane_levels(*planes, hq.qw, hq.zigzag)
    compat = tuple(torch.from_numpy(rng.integers(0, 256, (1, 144, 96), dtype=np.uint8)).to(dev)
                   for _ in range(3))
    q = torch.from_numpy(scale_quantization_matrix(12).astype(np.int32)).to(dev)
    codes, lens = _raw_slots(rng, 2, 1000, dev)
    idx = torch.arange(-5, 200, dtype=torch.int32, device=dev)
    return {
        "vlc_fused4": lambda: cuda_vlc.vlc_fused4(*planes, core.qw, core.luts()),
        "vlc_fused8": lambda: cuda_vlc.vlc_fused8(*planes, core.qw, core.luts()),
        "vlc_raw": lambda: cuda_vlc_raw.vlc_raw(*planes, core.qw, core.luts()),
        "vlc_levels4": lambda: cuda_vlc_levels.vlc_levels4(levels, preds, hq.luts()),
        "vlc_compat_slots": lambda: cuda_vlc_compat.vlc_compat_slots(*compat, q, Luts.compat(dev)),
        "vlc_compat_fused4": lambda: cuda_vlc_compat.vlc_compat_fused4(*compat, q, Luts.compat(dev)),
        "lut_lookup": lambda: cuda_lut.lut_lookup(idx, cuda_lut.AC_PACKED.to(dev)),
        "pack_fused4": lambda: cuda_pack.pack_fused4(*slots, 640),
        "pack_fused4_checked": lambda: cuda_pack.pack_fused4(*slots, 640, checks=True),
        "pack_fused8": lambda: cuda_pack.pack_fused8(words8, flens8, 640),
        **{fn: (lambda mod=mod, fn=fn: getattr(mod, fn)(codes, lens, 640))
           for mod, fn, _ in RAW_KERNELS.values()},
    }


KERNELS = ("vlc_fused4", "vlc_fused8", "vlc_raw", "vlc_levels4", "vlc_compat_slots",
           "vlc_compat_fused4", "lut_lookup", "pack_fused4", "pack_fused4_checked", "pack_fused8",
           "pack_raw", "pack_windows", "pack_split", "pack_pairs")


@pytest.mark.parametrize("kernel", KERNELS)
def test_launch_leaves_the_current_device(cuda, kernel):
    """Each launcher sets the tensors' device for its launch and restores
    the caller's: torch.cuda.current_device() is the same after a launch
    as before it.  With several cards, each is launched on while another
    is current; with one, that case cannot be shown."""
    n = torch.cuda.device_count()
    for index in range(n):
        dev = torch.device("cuda", index)
        launches = _launch_each_kernel(dev)
        torch.cuda.synchronize(dev)
        current = (index + 1) % n
        with torch.cuda.device(current):
            launches[kernel]()
            assert torch.cuda.current_device() == current
        torch.cuda.synchronize(dev)


# ---- the coefficients intake (A6) -----------------------------------------

def _coeff_blocks(rng, b, h, w):
    """Dequantized-looking int16 coefficient blocks of b frames of h x w."""
    ch, cw = -(-h // 2), -(-w // 2)
    out = []
    for n in (-(-h // 8) * -(-w // 8), -(-ch // 8) * -(-cw // 8), -(-ch // 8) * -(-cw // 8)):
        c = rng.integers(-64, 65, (b, n, 64)) * (rng.random((b, n, 64)) < 0.3)
        c[..., 0] = rng.integers(-1024, 1024, (b, n))
        out.append(c.astype(np.int16))
    return out


@pytest.mark.parametrize("quality", [50, 85])
@pytest.mark.parametrize("h, w", [(16, 16), (37, 70), (299, 401), (1080, 1920)])
def test_encode_from_coeffs_card_equals_cpu(cuda, h, w, quality):
    """The IDCT and the padding on the card, then the kernels: the CPU
    path's bytes, and the reference's numpy intake's."""
    coeffs = _coeff_blocks(np.random.default_rng(h + w + quality), 2, h, w)
    cuda_vlc.launches = cuda_vlc_levels.launches = cuda_pack.launches = 0
    got = TorchMPEG1IntraEncoder(quality=quality, device=cuda).encode_from_coeffs(*coeffs, h, w)
    assert cuda_pack.launches > 0
    assert (cuda_vlc.launches if quality < 70 else cuda_vlc_levels.launches) > 0
    assert got == TorchMPEG1IntraEncoder(quality=quality, device="cpu").encode_from_coeffs(
        *coeffs, h, w)
    assert got == MPEG1IntraEncoder(quality=quality, backend="numpy").encode_from_coeffs(
        *coeffs, h, w)


@pytest.mark.parametrize("shape, h, w", [((2, 5, 7), 16, 16), ((1, 150, 201), 150, 208),
                                         ((3, 1, 1), 8, 8), ((2, 1080, 1920), 1088, 1920)])
def test_edge_pad_on_card(cuda, shape, h, w):
    x = np.random.default_rng(h + w).integers(0, 256, shape, dtype=np.uint8)
    want = np.pad(x, ((0, 0), (0, h - shape[1]), (0, w - shape[2])), mode="edge")
    got = mpeg1.edge_pad(torch.from_numpy(x).to(cuda), h, w)
    assert got.is_cuda and np.array_equal(got.cpu().numpy(), want)


# ---- the entry points on the card: the CLI and the C ABI shim ---------------

JPEGS = Path(__file__).resolve().parent / "data" / "torch_jpegs"


def _jpeg_folder(folder: Path, n: int) -> Path:
    """n copies of the committed 400 x 600 fixture JPEGs, in turn."""
    folder.mkdir()
    for i in range(n):
        shutil.copy(JPEGS / f"frame_{i % 3}.jpg", folder / f"img_{i:02d}.jpg")
    return folder


def _outputs(d: Path):
    bits = d / "bits"
    return (d / "out.mpeg").read_bytes(), (
        {p.name: p.read_bytes() for p in sorted(bits.iterdir())} if bits.exists() else {})


@pytest.mark.parametrize("flags", [
    [], ["--stream", "--intake", "ycbcr"], ["--stream", "--intake", "coeffs", "--batch", "2"],
    ["--stream", "--intake", "rgb"], ["-q", "85", "--stream"], ["--fuse", "8"],
    ["--pack", "fused"], ["--debug-checks", "-q", "85"], ["--container", "ps", "--gop", "2"],
    ["--bitstream-dir", "{bits}"], ["--mode", "compat", "--bitstream-dir", "{bits}"],
    ["--mode", "compat", "--debug-checks"]], ids=lambda f: " ".join(f) or "default")
def test_cli_on_card_equals_cpu(cuda, tmp_path, flags, capsys):
    """The CLI on its default device (the card) and with --device cpu."""
    folder = _jpeg_folder(tmp_path / "imgs", 5)
    outs = []
    for extra in ([], ["--device", "cpu"]):
        d = tmp_path / ("cpu" if extra else "card")
        d.mkdir()
        argv = [str(folder), "-o", str(d / "out.mpeg"),
                *(f.format(bits=d / "bits") for f in flags), *extra]
        assert cli.main(argv) == 0
        outs.append(_outputs(d))
    assert outs[0] == outs[1]


def test_capi_shim_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """The C ABI shim (a child process running the CLI on the card) and
    mpeg_encode_procedure on the card: the CPU's stream and dumps."""
    folder = _jpeg_folder(tmp_path / "imgs", 6)
    shim = _native.load("encoder_compat").mpeg_encode_procedure
    shim.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    shim.restype = ctypes.c_int
    monkeypatch.setenv("EC504_PYTHON", sys.executable)
    monkeypatch.setenv("PYTHONPATH", str(Path(__file__).resolve().parent.parent))
    outs = []
    for name, run in (
        ("shim", lambda d: shim(str(folder).encode(), str(d / "bits").encode(),
                                str(d / "out.mpeg").encode(), 12)),
        ("card", lambda d: mpeg_encode_procedure(str(folder), str(d / "bits"),
                                                 str(d / "out.mpeg"), 12)),
        ("cpu", lambda d: mpeg_encode_procedure(str(folder), str(d / "bits"),
                                                str(d / "out.mpeg"), 12, device="cpu")),
    ):
        d = tmp_path / name
        d.mkdir()
        assert run(d) == 0
        outs.append(_outputs(d))
    assert outs[0] == outs[1] == outs[2] and len(outs[0][1]) == 6


# ---- the sharded encoder (A10) --------------------------------------------

@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the multi-card mesh and hazard C-h5 across "
                    "cards cannot be shown on one")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


# route -> (encoder keywords, the emission kernel's module and counter)
SHARDED_ROUTES = {
    "q=50": (dict(quality=50), cuda_vlc, "launches"),
    "q=50 fuse=8": (dict(quality=50, fuse=8), cuda_vlc, "launches8"),
    "q=85": (dict(quality=85), cuda_vlc_levels, "launches"),
    "q=50 debug_checks": (dict(quality=50, debug_checks=True), cuda_vlc_raw, "launches"),
}


@pytest.mark.parametrize("route", list(SHARDED_ROUTES))
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2)])
def test_sharded_on_card_equals_cpu(cuda, shape, route):
    """Shards on cuda:0, each its own launch: the CPU path's bytes from RGB
    and planes, one emission launch per shard per batch."""
    kw, mod, counter = SHARDED_ROUTES[route]
    rng = np.random.default_rng(sum(shape) + kw["quality"])
    frames = rng.integers(0, 256, (3, 128, 176, 3), dtype=np.uint8)
    planes = (frames[..., 0], frames[:, ::2, ::2, 1], frames[:, ::2, ::2, 2])
    enc = ShardedTorchMPEG1Encoder(mesh=make_mesh(*shape, [cuda] * (shape[0] * shape[1])), **kw)
    setattr(mod, counter, 0)
    got = enc.encode(frames)
    assert getattr(mod, counter) == shape[0] * shape[1]
    assert got == _cpu_encode(frames, **kw)
    assert enc.encode_from_planes(*planes) == TorchMPEG1IntraEncoder(
        device="cpu", **kw).encode_from_planes(*planes)


def test_sharded_two_cards_equals_cpu(two_cards):
    """A (2, 1) mesh over two cards: each card encodes its frames with its
    own core; the bytes are the CPU path's and the caller's device stays."""
    frames = np.random.default_rng(3).integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    enc = ShardedTorchMPEG1Encoder(quality=50, mesh=make_mesh(2, 1, two_cards))
    assert sorted(str(d) for d in enc.cores) == ["cuda:0", "cuda:1"]
    with torch.cuda.device(1):
        assert enc.encode(frames) == _cpu_encode(frames, quality=50)
        assert torch.cuda.current_device() == 1


def test_launch_leaves_the_current_device_on_two_cards(two_cards):
    """Hazard C-h5 across cards: each kernel launched on one card while
    the other is current leaves the current device as it was."""
    for dev, current in zip(two_cards, (1, 0)):
        launches = _launch_each_kernel(dev)
        torch.cuda.synchronize(dev)
        for kernel in KERNELS:
            with torch.cuda.device(current):
                launches[kernel]()
                assert torch.cuda.current_device() == current, kernel
        torch.cuda.synchronize(dev)
