"""The prefix fetch (`models/mpeg1.py::fetch_prefix`) and its counter
`prefix_fetches`.

From slice buffers on a CUDA device the bucketed prefix goes into
page-locked memory from PyTorch's caching host allocator, reused from call
to call ("pinned"); CPU tensors and the sharded encoder's `ShardedTensor`
keep `.cpu()` ("pageable").  On the CPU: the bucket at its edges for three
capacities, the same bytes as `.cpu()` (a view of the CPU buffer, as
before), the sharded gather, and every encoder entry's bytes before and
after a counter reset.  On the card: the array is pinned and holds
`.cpu()`'s bytes (q=85, q=50, compat); twenty calls on alternating stamped
batches each equal a fresh encoder's stream, leave the previous fetch's
bytes alone and allocate no pinned block after the first fetches of each
bucket; a regrow stays byte-equal.  The card tests skip without a CUDA
card (decided in a fixture); this file imports nothing of the JAX package,
so on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prefix_fetch.py

Tolerance: exact (0).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.models import encoder, mpeg1
from ec504_imageencoder_tpu_torch.models.encoder import (
    MAX_SLICE_BYTES_COMPAT,
    CompatCore,
    encode_compat,
)
from ec504_imageencoder_tpu_torch.models.mpeg1 import (
    TorchMPEG1IntraEncoder,
    fetch_prefix,
    prefix_bytes,
)
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_compat import compat_color
from ec504_imageencoder_tpu_torch.parallel.mesh import ShardedTensor, make_mesh
from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import ShardedTorchMPEG1Encoder

H, W = 40, 56  # two macroblock rows and columns of padding
CAPS = (256, 300, 2560)


def _need_bits(cap):
    return (0, 1, 8 * 255, 8 * 256, 8 * 257, 8 * cap - 1, 8 * cap, 8 * cap + 1)


def _old_fetch(seg, need_bits, cap):
    """The fetch as it was written before the pinned path."""
    used = -(-need_bits // 8)
    return seg[:, :, :min(max(256, 1 << (used - 1).bit_length()), cap)].cpu().numpy()


def _seg(cap, b=2, s=3, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (b, s, cap),
                                                                 dtype=np.uint8))


@pytest.fixture
def fetches():
    """`prefix_fetches`, cleared for the test."""
    mpeg1.prefix_fetches.clear()
    yield mpeg1.prefix_fetches
    mpeg1.prefix_fetches.clear()


# ---- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("which", range(8))
def test_cpu_fetch_keeps_the_old_prefix(fetches, cap, which):
    need = _need_bits(cap)[which]
    seg = _seg(cap, seed=cap + which)
    got = fetch_prefix(seg, need, cap)
    want = _old_fetch(seg, need, cap)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[2] == prefix_bytes(-(-need // 8), cap)
    np.testing.assert_array_equal(got, want)
    assert np.shares_memory(got, seg.numpy())  # `.cpu()` of a CPU tensor: a view, as before
    assert fetches == Counter(pageable=1)


def test_sharded_prefix_keeps_the_gathered_bytes(fetches):
    cap, need = 2560, 8 * 700
    grid = [[_seg(cap, b=2, s=s, seed=10 * i + s) for s in (3, 2)] for i in range(2)]
    got = fetch_prefix(ShardedTensor(grid), need, cap)
    whole = torch.cat([torch.cat(row, dim=1) for row in grid], dim=0)
    np.testing.assert_array_equal(got, _old_fetch(whole, need, cap))
    assert got.shape == (4, 5, 1024)
    assert fetches == Counter(pageable=1)


def _planes(seed=3, b=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, H, W), dtype=np.uint8),
            *(rng.integers(0, 256, (b, H // 2, W // 2), dtype=np.uint8) for _ in range(2)))


def _rgb(seed=4, b=2, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _coeffs(seed=5, b=2):
    """Dequantized int16 coefficient blocks of an H x W 4:2:0 picture."""
    rng = np.random.default_rng(seed)
    ny = -(-H // 8) * -(-W // 8)
    nc = -(-H // 16) * -(-W // 16)
    out = []
    for n in (ny, nc, nc):
        c = np.zeros((b, n, 64), np.int16)
        c[..., 0] = rng.integers(-1000, 1000, (b, n))
        c[..., 1:6] = rng.integers(-60, 60, (b, n, 5))
        out.append(c)
    return out


def _cpu_call(entry, max_slice_bytes=None):
    if entry == "compat":
        frames = _rgb(b=2, h=150, w=101)
        return lambda: encode_compat(frames, 12, device="cpu")
    if entry == "sharded":
        enc = ShardedTorchMPEG1Encoder(quality=80, mesh=make_mesh(2, 1, ["cpu"] * 2),
                                       device="cpu", max_slice_bytes=max_slice_bytes)
        return lambda: enc.encode_from_planes(*_planes(b=3))
    enc = TorchMPEG1IntraEncoder(quality=85 if entry == "planes" else 50, device="cpu",
                                 max_slice_bytes=max_slice_bytes)
    return {"planes": lambda: enc.encode_from_planes(*_planes()),
            "rgb": lambda: enc.encode(_rgb()),
            "coeffs": lambda: enc.encode_from_coeffs(*_coeffs(), H, W)}[entry]


# compat's slice buffer is fixed: it never regrows
@pytest.mark.parametrize("entry,max_slice_bytes", [
    *((e, m) for e in ("planes", "rgb", "coeffs", "sharded") for m in (None, 8)),
    ("compat", None),
])
def test_cpu_entries_fetch_pageable_and_keep_their_bytes(fetches, entry, max_slice_bytes):
    """One pageable fetch a call (a regrow re-runs, it does not fetch
    twice); the bytes are the same after the counter is reset."""
    call = _cpu_call(entry, max_slice_bytes)
    first = call()
    assert fetches == Counter(pageable=1)
    fetches.clear()
    assert call() == first
    assert call() == first
    assert fetches == Counter(pageable=2)


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_prefix_fetch.py`")
    return torch.device("cuda", 0)


CB, CH, CW = 4, 144, 1920  # the card's batches: 9 slices of 120 macroblocks a frame


def _smooth_planes(seed, b=CB, h=CH, w=CW):
    """Gradients with noise of a few levels: slices of a few hundred bytes
    to a few kB, so the buckets lie below the slice buffer."""
    rng = np.random.default_rng(seed)

    def plane(hh, ww):
        yy, xx = np.mgrid[:hh, :ww]
        base = (yy * 3 + xx // 2 + rng.integers(0, 256)) % 200 + 28
        return (base[None] + rng.integers(-6, 7, (b, hh, ww))).clip(0, 255).astype(np.uint8)

    return plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)


def _card_slices(kind, dev):
    """(slice buffers on the card, the bit counts, the capacity) of one
    call's device pipeline: q=85 and q=50 planes or compat."""
    if kind == "compat":
        rgb = torch.from_numpy(_rgb(seed=7, b=CB, h=CH, w=96 * 3)).to(dev)
        seg, bits = CompatCore(12).to(dev)(*compat_color(rgb))
        return seg, bits.cpu().numpy(), MAX_SLICE_BYTES_COMPAT
    enc = TorchMPEG1IntraEncoder(quality=85 if kind == "q85" else 50, device=dev)
    padded = mpeg1.pad_planes_to_macroblocks(*_smooth_planes(11))
    msb = mpeg1.worst_case_slice_bytes(padded[0].shape[2] // 16)
    seg, bits = mpeg1.correct_pipeline_planes(
        enc.core, *(torch.from_numpy(p).to(dev) for p in padded), msb)
    return seg, bits.cpu().numpy(), msb


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["q85", "q50", "compat"])
def test_card_fetch_is_pinned_and_equals_cpu_copy(cuda, fetches, kind):
    seg, bits, cap = _card_slices(kind, cuda)
    need = int(bits.max())
    assert 0 < need <= 8 * cap
    got = fetch_prefix(seg, need, cap)
    n = prefix_bytes(-(-need // 8), cap)
    assert torch.from_numpy(got).is_pinned()
    assert got.shape == (*seg.shape[:2], n) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, seg[:, :, :n].cpu().numpy())
    assert fetches == Counter(pinned=1)


def _stamp(arrays, k):
    """Call k's input: one macroblock row of every frame rolled by k + 1
    along its width (16 rows of luma and RGB, 8 of chroma; coefficient
    blocks of one row of 8 x 8 blocks rolled within the block)."""
    out = []
    for i, a in enumerate(arrays):
        a = a.copy()
        if a.dtype == np.int16:  # (B, blocks, 64)
            a[:, :8] = np.roll(a[:, :8], k + 1, axis=2)
        else:  # luma or RGB first, then chroma
            unit = 8 if i else 16
            r = k % (a.shape[1] // unit)
            band = a[:, r * unit:(r + 1) * unit]
            a[:, r * unit:(r + 1) * unit] = np.roll(band, 2 * (k + 1), axis=2)
        out.append(a)
    return out


def _card_entry(entry, dev):
    """(two base batches, a call on an encoder kept across calls, a call on
    a fresh encoder) for one entry point on the card."""
    if entry == "compat":
        bases = [[_rgb(seed=s, b=CB, h=150, w=101)] for s in (1, 2)]
        call = lambda x: encode_compat(x[0], 12, device=dev)  # noqa: E731
        return bases, call, call
    if entry == "coeffs":
        rng = np.random.default_rng(5)
        blocks = (CH // 8) * (CW // 8), (CH // 16) * (CW // 16)
        bases = []
        for _ in range(2):
            comps = []
            for n in (blocks[0], blocks[1], blocks[1]):
                c = np.zeros((CB, n, 64), np.int16)
                c[..., 0] = rng.integers(-1000, 1000, (CB, n))
                c[..., 1:6] = rng.integers(-60, 60, (CB, n, 5))
                comps.append(c)
            bases.append(comps)
        kept = TorchMPEG1IntraEncoder(quality=50, device=dev)
        return (bases, lambda x: kept.encode_from_coeffs(*x, CH, CW),
                lambda x: TorchMPEG1IntraEncoder(quality=50, device=dev).encode_from_coeffs(
                    *x, CH, CW))
    if entry == "rgb":
        bases = [[_rgb(seed=s, b=CB, h=CH, w=CW)] for s in (1, 2)]
        kept = TorchMPEG1IntraEncoder(quality=50, device=dev)
        return (bases, lambda x: kept.encode(x[0]),
                lambda x: TorchMPEG1IntraEncoder(quality=50, device=dev).encode(x[0]))
    bases = [list(_smooth_planes(s)) for s in (1, 2)]
    kept = TorchMPEG1IntraEncoder(quality=85, device=dev)
    return (bases, lambda x: kept.encode_from_planes(*x),
            lambda x: TorchMPEG1IntraEncoder(quality=85, device=dev).encode_from_planes(*x))


def _host_allocs() -> int:
    return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("entry", ["planes", "rgb", "coeffs", "compat"])
def test_card_twenty_calls_reuse_pinned_blocks(cuda, fetches, monkeypatch, entry):
    """Twenty calls on alternating stamped batches: each stream equals a
    fresh encoder's on the same batch; the array of a fetch keeps its
    bytes while the next one is written; a pinned block is allocated
    only by the first two fetches of a bucket (the spy holds one array
    while the next is fetched), never after."""
    seen, held, fresh_allocs = Counter(), [], []

    def spy(seg_dev, need_bits, cap):
        before = _host_allocs()
        got = fetch_prefix(seg_dev, need_bits, cap)
        seen[got.shape] += 1
        if _host_allocs() > before:
            fresh_allocs.append((got.shape, seen[got.shape]))
        if held:
            prev, copy = held.pop()
            np.testing.assert_array_equal(prev, copy)  # not overwritten by this fetch
            del prev
        held.append((got, got.copy()))
        return got

    monkeypatch.setattr(mpeg1, "fetch_prefix", spy)
    monkeypatch.setattr(encoder, "fetch_prefix", spy)
    bases, call, fresh = _card_entry(entry, cuda)
    calls = 20
    for k in range(calls):
        batch = _stamp(bases[k % 2], k)
        got = call(batch)
        assert got == fresh(batch), f"call {k}"
    assert fetches == Counter(pinned=2 * calls)
    assert sum(seen.values()) == 2 * calls
    late = [(shape, nth) for shape, nth in fresh_allocs if nth > 2]
    assert not late, f"pinned blocks allocated after a bucket's first fetches: {late}"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("entry", ["planes", "rgb", "coeffs"])
def test_card_regrow_stays_byte_equal(cuda, fetches, entry):
    """From an 8-byte slice buffer the first call regrows and re-runs; its
    one pinned fetch gives the CPU's bytes, and so does the next call."""
    enc = TorchMPEG1IntraEncoder(quality=50, max_slice_bytes=8, device=cuda)
    call = {"planes": lambda e: e.encode_from_planes(*_planes()),
            "rgb": lambda e: e.encode(_rgb()),
            "coeffs": lambda e: e.encode_from_coeffs(*_coeffs(), H, W)}[entry]
    want = call(TorchMPEG1IntraEncoder(quality=50, device="cpu"))
    fetches.clear()
    assert call(enc) == want
    assert enc.max_slice_bytes > 8
    assert call(enc) == want
    assert fetches == Counter(pinned=2)
