"""The VLC kernels' plain twins against the Pallas kernels they replace.

Each wrapper on CPU tensors runs its twin; the reference is the Pallas
kernel in interpret mode, fed the same input in its own layout:

* B1 `vlc_fused4`: `vlc_fused_slots_from_blocks_tpu` + `fused_stack_to_stream`;
* B6b `vlc_fused8`: `vlc_fused8_slots_from_blocks_tpu` + `fused8_stack_to_stream`;
* B3 `vlc_levels4`: `vlc_slots_tpu` + `fuse_slots_streamwise`;
* B4a `vlc_compat_slots`: `vlc_compat_slots_from_blocks_tpu`;
* B4b `vlc_compat_fused4`: `vlc_compat_fused_slots_from_blocks_tpu` +
  `fused_stack_to_stream`;
* B6a `vlc_raw`: `vlc_from_blocks_tpu`, slot for slot, and the
  reference's numpy emission `block_streams_correct64(xp=np)`.

The cases of each kernel share one shape (6 slice rows of 18 blocks; 12
compat rows of 54), so the Pallas interpreter compiles once per kernel.
Tolerance: exact (0).
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models.encoder import compat_blockize_px64
from ec504_imageencoder_tpu.models.mpeg1 import pad_planes_to_macroblocks, quality_to_quant
from ec504_imageencoder_tpu.ops.dct import aan_dct_nb, dct_matrix_f32
from ec504_imageencoder_tpu.models.mpeg1 import _dc_predictors as ref_dc_predictors
from ec504_imageencoder_tpu.ops.dct import aan_dct as ref_aan_dct
from ec504_imageencoder_tpu.ops.pallas_vlc import (
    fuse_slots_streamwise,
    fused8_stack_to_stream,
    fused_stack_to_stream,
    vlc_compat_fused_slots_from_blocks_tpu,
    vlc_compat_slots_from_blocks_tpu,
    vlc_from_blocks_tpu,
    vlc_fused8_slots_from_blocks_tpu,
    vlc_fused_slots_from_blocks_tpu,
    vlc_slots_tpu,
)
from ec504_imageencoder_tpu.ops.quant import quantize as ref_quantize
from ec504_imageencoder_tpu.ops.vlc_device import block_streams_compat as ref_block_streams_compat
from ec504_imageencoder_tpu.ops.vlc_device import block_streams_correct64 as ref_block_streams_correct64
from ec504_imageencoder_tpu.ops.zigzag import zigzag_scan as ref_zigzag_scan
from ec504_imageencoder_tpu.utils.tables import ZIGZAG_GATHER, scale_quantization_matrix
from ec504_imageencoder_tpu_torch.models.mpeg1 import plane_levels
from ec504_imageencoder_tpu_torch.ops import cuda_vlc, cuda_vlc_compat, cuda_vlc_levels, cuda_vlc_raw
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize, quantize_intra
from ec504_imageencoder_tpu_torch.ops.zigzag import zigzag_scan


def _px64_blocks(y, cb, cr):
    """Padded planes -> the Pallas kernel's (R, 64, NB) u8 px-major rows
    (the reference's own blockize, models/mpeg1.py)."""
    bsz, h, w = y.shape
    mbh, mbw = h // 16, w // 16
    lg = y.reshape(bsz, mbh, 2, 8, mbw, 2, 8)
    luma = lg.transpose(0, 1, 6, 3, 4, 2, 5).reshape(bsz, mbh, 64, mbw, 4)

    def chroma(p):
        return p.reshape(bsz, mbh, 8, mbw, 8).transpose(0, 1, 4, 2, 3).reshape(bsz, mbh, 64, mbw, 1)

    return np.concatenate([luma, chroma(cb), chroma(cr)], axis=-1).reshape(bsz * mbh, 64, mbw * 6)


def _planes(rng, b, h, w, noise: bool):
    ch, cw = -(-h // 2), -(-w // 2)
    if noise:
        return (rng.integers(0, 256, (b, h, w), dtype=np.uint8),
                rng.integers(0, 256, (b, ch, cw), dtype=np.uint8),
                rng.integers(0, 256, (b, ch, cw), dtype=np.uint8))
    yy, xx = np.mgrid[:h, :w]
    base = ((yy * 3 + xx * 5) % 256).astype(np.uint8)
    y = np.stack([np.roll(base, 7 * i, axis=1) for i in range(b)])
    c = np.stack([np.full((ch, cw), 90 + 40 * i, np.uint8) for i in range(b)])
    return y, c, 255 - c


CASES = [
    # (frames, height, width, noise): 32x48 is macroblock-aligned, 40x44
    # pads to 48x48; both make 6 slice rows of 18 blocks
    pytest.param(3, 32, 48, True, id="3x32x48-noise"),
    pytest.param(2, 40, 44, True, id="2x40x44-noise"),
    pytest.param(3, 32, 48, False, id="3x32x48-smooth"),
]


@pytest.mark.parametrize("quality", [5, 50, 69, 95])
@pytest.mark.parametrize("frames,height,width,noise", CASES)
def test_twin_matches_pallas_kernel(quality, frames, height, width, noise):
    rng = np.random.default_rng(quality * 1000 + height * 10 + width + noise)
    y, cb, cr = pad_planes_to_macroblocks(*_planes(rng, frames, height, width, noise))
    intra_q, qscale = quality_to_quant(quality)
    qw = (intra_q * qscale).astype(np.int32)

    vstack, flens = vlc_fused_slots_from_blocks_tpu(_px64_blocks(y, cb, cr), qw, interpret=True)
    want = [np.asarray(a).view(np.int32) for a in fused_stack_to_stream(vstack, flens)]

    planes = [torch.from_numpy(p) for p in (y, cb, cr)]
    got = cuda_vlc.vlc_fused4(*planes, torch.from_numpy(qw), Luts.default("cpu"))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)

    if noise and quality == 95:
        # the case covers 28-bit escapes: some |level| >= 128
        _, lvl = quantize_intra(aan_dct(cuda_vlc.blockize(*planes)), torch.from_numpy(qw))
        assert int(lvl.abs().max()) >= 128


@pytest.mark.parametrize("quality", [5, 50, 69, 95])
@pytest.mark.parametrize("frames,height,width,noise", CASES)
def test_fused8_twin_matches_pallas_kernel(quality, frames, height, width, noise):
    """B6b's twin (B1's twin, then `fuse8`) against
    `vlc_fused8_slots_from_blocks_tpu(interpret=True)` + `fused8_stack_to_stream`:
    8 word planes and the lengths (<= 256), slot for slot."""
    rng = np.random.default_rng(quality * 1000 + height * 10 + width + noise)
    y, cb, cr = pad_planes_to_macroblocks(*_planes(rng, frames, height, width, noise))
    intra_q, qscale = quality_to_quant(quality)
    qw = (intra_q * qscale).astype(np.int32)

    vstack, flens = vlc_fused8_slots_from_blocks_tpu(_px64_blocks(y, cb, cr), qw, interpret=True)
    want_w, want_l = fused8_stack_to_stream(vstack, flens)
    planes = [torch.from_numpy(p) for p in (y, cb, cr)]
    words, got_l = cuda_vlc.vlc_fused8(*planes, torch.from_numpy(qw), Luts.default("cpu"))
    assert len(words) == 8 and got_l.dtype == torch.int32
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    for g, w in zip(words, want_w):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w).view(np.int32))
    if noise and quality == 95:
        assert int(got_l.max()) > 128  # values that span more than four words


def test_wrapper_checks_inputs():
    y = torch.zeros((1, 32, 32), dtype=torch.uint8)
    c = torch.zeros((1, 16, 16), dtype=torch.uint8)
    qw = torch.ones((8, 8), dtype=torch.int32)
    luts = Luts.default("cpu")
    with pytest.raises(ValueError):
        cuda_vlc.vlc_fused4(y[:, :30], c, c, qw, luts)          # not padded
    with pytest.raises(ValueError):
        cuda_vlc.vlc_fused4(y, c[:, :8], c, qw, luts)            # chroma shape
    with pytest.raises(TypeError):
        cuda_vlc.vlc_fused4(y.int(), c, c, qw, luts)             # dtype
    with pytest.raises(TypeError):
        cuda_vlc.vlc_fused4(y, c, c, qw.long(), luts)
    with pytest.raises(ValueError):
        cuda_vlc.vlc_fused8(y[:, :30], c, c, qw, luts)          # not padded
    with pytest.raises(TypeError):
        cuda_vlc.vlc_fused8(y, c, c.int(), qw, luts)


# ---- B6a: planes -> raw slots (the sanitizer's integer-DCT route) --------

def _reference_raw_slots(y, cb, cr, qw):
    """The reference's numpy chain (models/mpeg1._generic_pipeline_from_planes
    up to the emission) in the kernel's layout: (codes, lens) (R, 64, NB)."""
    px = _px64_blocks(y, cb, cr)                             # (R, 64, NB), row = px*8 + py
    r, _, nb = px.shape
    blocks = px.reshape(r, 8, 8, nb).transpose(0, 3, 2, 1).astype(np.int32)  # (R, NB, py, px)
    f = ref_aan_dct(blocks, np)
    dc = np.clip((f[..., 0, 0] + 4) >> 3, 0, 255)
    num = 16 * np.abs(f) + qw
    lvl = np.sign(f) * np.clip(num // (2 * qw), 0, 255)
    zz = ref_zigzag_scan(lvl, np)
    zz[..., 0] = dc
    bsz, mbh = y.shape[0], y.shape[1] // 16
    pred = ref_dc_predictors(dc.reshape(bsz, mbh, nb // 6, 6), bsz, mbh, nb // 6, np).reshape(r, nb)
    comp = np.arange(nb) % 6
    codes, lens = ref_block_streams_correct64(
        zz, pred, np.broadcast_to(comp < 4, (r, nb)), np, mb_first=np.broadcast_to(comp == 0, (r, nb)))
    return codes.transpose(0, 2, 1), lens.transpose(0, 2, 1)


@pytest.mark.parametrize("quality", [5, 50, 95])
@pytest.mark.parametrize("frames,height,width,noise", CASES)
def test_raw_twin_matches_pallas_kernel(quality, frames, height, width, noise):
    """B6a's twin against `vlc_from_blocks_tpu(interpret=True)` and the
    reference's numpy emission, slot for slot; the DCT guard stays 0."""
    rng = np.random.default_rng(quality * 100 + height + width + noise)
    y, cb, cr = pad_planes_to_macroblocks(*_planes(rng, frames, height, width, noise))
    intra_q, qscale = quality_to_quant(quality)
    qw = (intra_q * qscale).astype(np.int32)

    codes, lens = vlc_from_blocks_tpu(_px64_blocks(y, cb, cr), qw, interpret=True)
    got_c, got_l, guard = cuda_vlc_raw.vlc_raw(
        *(torch.from_numpy(p) for p in (y, cb, cr)), torch.from_numpy(qw), Luts.default("cpu"))
    assert got_c.dtype == got_l.dtype == guard.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), np.asarray(codes).view(np.int32))
    assert np.array_equal(got_l.numpy(), np.asarray(lens))
    want_c, want_l = _reference_raw_slots(y, cb, cr, qw)
    assert np.array_equal(got_c.numpy().view(np.uint32), want_c)
    assert np.array_equal(got_l.numpy(), want_l)
    assert guard.tolist() == [0] * got_c.shape[0]
    if noise and quality == 5:
        assert (got_l[:, 1:] == 20).any()  # 20-bit escapes


def test_raw_twin_dct_guard(monkeypatch):
    """The guard counts, per slice row, the blocks whose largest |F|
    reaches 2^19 (u8 pixels never do: the coefficients are scaled here)."""
    y = torch.zeros((1, 32, 32), dtype=torch.uint8)
    y[0, :8, :8] = 255  # one luma block of row 0: F00 = 2042, 2042 * 512 >= 2^19
    c = torch.zeros((1, 16, 16), dtype=torch.uint8)
    real = cuda_vlc.aan_dct
    monkeypatch.setattr(cuda_vlc, "aan_dct", lambda b: real(b) * 512)
    _, _, guard = cuda_vlc_raw.vlc_raw(y, c, c, torch.ones((8, 8), dtype=torch.int32) * 16,
                                       Luts.default("cpu"))
    assert guard.tolist() == [1, 0]


def test_raw_wrapper_checks_inputs():
    y = torch.zeros((1, 32, 32), dtype=torch.uint8)
    c = torch.zeros((1, 16, 16), dtype=torch.uint8)
    qw = torch.ones((8, 8), dtype=torch.int32)
    luts = Luts.default("cpu")
    with pytest.raises(ValueError):
        cuda_vlc_raw.vlc_raw(y[:, :30], c, c, qw, luts)           # not padded
    with pytest.raises(TypeError):
        cuda_vlc_raw.vlc_raw(y, c, c.int(), qw, luts)
    with pytest.raises(TypeError):
        cuda_vlc_raw.vlc_raw(y, c, c, qw, Luts(*(t.long() for t in luts)))


# ---- B3: levels -> fused slots (the high-quality path's emission) --------

@pytest.mark.parametrize("quality", [70, 85, 100])
@pytest.mark.parametrize("noise", [True, False], ids=["noise", "smooth"])
def test_levels_twin_matches_pallas_kernel(quality, noise):
    """`vlc_levels4` on CPU tensors against `vlc_slots_tpu(interpret=True)`
    + `fuse_slots_streamwise`, both fed one levels tensor computed once
    (the port's f32 DCT path).  6 slice rows of 18 blocks."""
    rng = np.random.default_rng(quality * 10 + noise)
    y, cb, cr = (torch.from_numpy(p) for p in _planes(rng, 3, 32, 48, noise))
    intra_q, qscale = quality_to_quant(quality)
    qw = torch.from_numpy((intra_q * qscale).astype(np.int32))
    luts = Luts.default("cpu")
    levels, preds = plane_levels(y, cb, cr, qw, luts.zigzag)
    if noise and quality == 100:
        assert int(levels[..., 1:].abs().max()) >= 128  # 28-bit escapes

    codes, lens = vlc_slots_tpu(levels.numpy().transpose(0, 2, 1), preds.numpy(), interpret=True)
    want = [np.asarray(a).view(np.int32) for a in fuse_slots_streamwise(codes, lens)]
    got = cuda_vlc_levels.vlc_levels4(levels, preds, luts)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)


def test_levels_wrapper_checks_inputs():
    lv = torch.zeros((2, 12, 64), dtype=torch.int32)
    pr = torch.zeros((2, 12), dtype=torch.int32)
    luts = Luts.default("cpu")
    with pytest.raises(ValueError):
        cuda_vlc_levels.vlc_levels4(lv[:, :10], pr[:, :10], luts)   # not whole MBs
    with pytest.raises(ValueError):
        cuda_vlc_levels.vlc_levels4(lv, pr[:, :6], luts)            # preds shape
    with pytest.raises(TypeError):
        cuda_vlc_levels.vlc_levels4(lv.long(), pr, luts)
    with pytest.raises(TypeError):
        cuda_vlc_levels.vlc_levels4(lv, pr, Luts(*(t.long() for t in luts)))


# ---- B4a/B4b: compat frames -> slots -------------------------------------

def _compat_planes(rng, h, w):
    """Two frames of full-resolution planes: noise, and smooth ramps whose
    first luma block is `_ESCAPE_BLOCK`."""
    noise = [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3)]
    yy, xx = np.mgrid[:h, :w]
    smooth = [((yy * (2 * k + 3) + (xx // 8) * 11 * k) % 256).astype(np.uint8)
              for k in (1, 2, 3)]
    smooth[0][:8, :8] = _ESCAPE_BLOCK
    return tuple(np.stack([a, b]) for a, b in zip(noise, smooth))


# its AAN levels at q=100 (steps of 1) start 239, 0, -144: the compat
# emission keeps slot 2 (a zero before it) as a 28-bit escape
_ESCAPE_BLOCK = np.array([
    [3, 1, 0, 1, 2, 2, 3, 1], [11, 10, 7, 9, 10, 11, 10, 9],
    [18, 18, 15, 18, 19, 18, 19, 16], [27, 25, 23, 25, 26, 27, 27, 25],
    [34, 34, 31, 33, 34, 35, 35, 33], [42, 42, 40, 41, 43, 42, 43, 41],
    [51, 50, 47, 49, 51, 50, 50, 49], [58, 58, 55, 58, 59, 58, 58, 56],
], np.uint8)


def _emits_typo_pair(y, cb, cr, scaled_q) -> bool:
    """Whether a block emits (run 16, |level| 2), where the reference's
    Pallas kernels read the ISO row and the C encoder its 15-bit typo."""
    blocks = cuda_vlc_compat.compat_blockize(*(torch.from_numpy(p) for p in (y, cb, cr)))
    zz = zigzag_scan(quantize(aan_dct(blocks), torch.from_numpy(scaled_q))).numpy()
    for blk in zz.reshape(-1, 64):
        nz = np.flatnonzero(blk[1:]) + 1
        prev = np.concatenate([[0 if blk[0] else -1], nz[:-1]])
        zb = nz - prev - 1
        stop = np.flatnonzero(zb == 0)
        keep = slice(None, stop[0] if stop.size else None)
        if ((zb[keep] == 17) & (np.abs(blk[nz][keep]) == 2)).any():
            return True
    return False


COMPAT_CASES = [
    pytest.param(150, 101, 12, id="150x101-q12"),
    pytest.param(150, 101, 1, id="150x101-q1"),
    pytest.param(150, 101, 50, id="150x101-q50"),
    pytest.param(150, 101, 100, id="150x101-q100"),
]


@pytest.mark.parametrize("height,width,quality", COMPAT_CASES)
def test_compat_twins_match_pallas_kernels(height, width, quality):
    """B4a's twin against `vlc_compat_slots_from_blocks_tpu(interpret=True)`
    (lengths exact, codes exact below their length) and B4b's against
    `vlc_compat_fused_slots_from_blocks_tpu` + `fused_stack_to_stream`
    (exact), both fed the reference's compat blockize of the same planes.
    The inputs avoid (run 16, |level| 2), where the Pallas kernels leave
    the reference (see test_compat_typo_pair_follows_the_reference)."""
    rng = np.random.default_rng(quality + width)
    y, cb, cr = _compat_planes(rng, height, width)
    scaled_q = scale_quantization_matrix(quality).astype(np.int32)
    assert not _emits_typo_pair(y, cb, cr, scaled_q)
    blocks = compat_blockize_px64(y, cb, cr, np)
    planes = [torch.from_numpy(p) for p in (y, cb, cr)]
    luts = Luts.compat("cpu")

    codes, lens = vlc_compat_slots_from_blocks_tpu(blocks, scaled_q, interpret=True)
    got_c, got_l = cuda_vlc_compat.vlc_compat_slots(*planes, torch.from_numpy(scaled_q), luts)
    want_l = np.asarray(lens)
    assert np.array_equal(got_l.numpy(), want_l)
    mask = ((1 << np.clip(want_l, 0, 31).astype(np.uint64)) - 1).astype(np.uint32)
    assert np.array_equal(got_c.numpy().view(np.uint32), np.asarray(codes) & mask)

    vstack, flens = vlc_compat_fused_slots_from_blocks_tpu(blocks, scaled_q, interpret=True)
    want = [np.asarray(a).view(np.int32) for a in fused_stack_to_stream(vstack, flens)]
    got = cuda_vlc_compat.vlc_compat_fused4(*planes, torch.from_numpy(scaled_q), luts)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
    if quality == 100:
        assert int(got_l[:, 1:].max()) == 28  # a 28-bit escape (unclamped levels)


def _reference_compat_slots(y, cb, cr, scaled_q):
    """The reference's numpy compat chain (golden-exact), folded to the
    kernels' 64 slots: (codes, lens) of shape (B * 6, 64, 54)."""
    px = compat_blockize_px64(y, cb, cr, np)
    r, _, nb = px.shape
    f = aan_dct_nb(px.reshape(r, 8, 8, nb).transpose(0, 2, 1, 3), np)
    lvl = ref_quantize(f.transpose(0, 3, 1, 2), scaled_q, np)
    zz = ref_zigzag_scan(lvl, np)                                # (R, NB, 64)
    comp = np.arange(nb) % 6
    c, ln = ref_block_streams_compat(zz, np.broadcast_to(comp < 4, (r, nb)), np)
    c, ln = c[..., :64].astype(np.uint32), ln[..., :64].copy()
    c[..., 63] = (c[..., 63] << 2) | 2
    ln[..., 63] += 2
    first = comp == 0
    c[:, first, 0] |= np.uint32(3) << ln[:, first, 0].astype(np.uint32)
    ln[:, first, 0] += 2
    return c.transpose(0, 2, 1), ln.transpose(0, 2, 1)


def test_compat_typo_pair_follows_the_reference():
    """At (run 16, |level| 2) the reference C encoder writes a 15-bit typo
    of the 16-bit ISO code; the reference's numpy compat path (which the
    golden stream locks) does too, and so does the port.  The Pallas
    kernels read the ISO row there and write 16 bits.  The first luma
    block is built from an inverse DCT to hold a DC, 17 zeros and a level
    of 2 at q=12 (steps of 67 and more drown the rounding noise)."""
    quality = 12
    scaled_q = scale_quantization_matrix(quality).astype(np.int32)
    k = 18
    v, u = divmod(int(ZIGZAG_GATHER[k]), 8)
    coef = np.zeros((8, 8))
    coef[v, u] = 2.5 * scaled_q[v, u]
    d = dct_matrix_f32().astype(np.float64)
    blk = np.clip(np.rint(128 + d.T @ coef @ d), 0, 255).astype(np.uint8)
    y = np.full((2, 150, 101), 128, np.uint8)  # the shape of COMPAT_CASES
    y[0, :8, :8] = blk
    cb = np.full_like(y, 128)
    cr = np.full_like(y, 128)
    assert _emits_typo_pair(y, cb, cr, scaled_q)

    want_c, want_l = _reference_compat_slots(y, cb, cr, scaled_q)
    planes = [torch.from_numpy(p) for p in (y, cb, cr)]
    got_c, got_l = cuda_vlc_compat.vlc_compat_slots(
        *planes, torch.from_numpy(scaled_q), Luts.compat("cpu"))
    assert np.array_equal(got_l.numpy(), want_l)
    assert np.array_equal(got_c.numpy().view(np.uint32), want_c)
    assert got_l[0, k, 0] == 15
    _, lens = vlc_compat_slots_from_blocks_tpu(
        compat_blockize_px64(y, cb, cr, np), scaled_q, interpret=True)
    diff = got_l.numpy() != np.asarray(lens)
    assert diff.sum() == 1 and np.asarray(lens)[0, k, 0] == 16


def test_compat_wrappers_check_inputs():
    y = torch.zeros((1, 144, 96), dtype=torch.uint8)
    q = torch.ones((8, 8), dtype=torch.int32)
    luts = Luts.compat("cpu")
    with pytest.raises(ValueError):
        cuda_vlc_compat.vlc_compat_fused4(y[:, :140], y[:, :140], y[:, :140], q, luts)
    with pytest.raises(ValueError):
        cuda_vlc_compat.vlc_compat_slots(y, y[:, :, :95], y, q, luts)
    with pytest.raises(TypeError):
        cuda_vlc_compat.vlc_compat_fused4(y.int(), y, y, q, luts)
    with pytest.raises(TypeError):
        cuda_vlc_compat.vlc_compat_slots(y, y, y, q.long(), luts)
