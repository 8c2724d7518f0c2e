"""The f32 levels kernel (`ops/cuda_vlc_levels.py::f32_levels`, the entry
point `f32_levels_launch` in `csrc/vlc_levels4.cu`) against its plain twin
(`f32_levels_plain`: blockize, `matmul_dct`, `quantize_intra`,
`zigzag_scan`, `dc_predictors`), and the twin against numpy's einsum chain,
the reference's host `matmul_dct` ("vy,...yx,ux->...vu" in f32).

On the CPU: the kernel's basis literals are `dct_matrix_f32()`; the twin
equals the numpy chain on fixture, noise and tie-hunting blocks at every
quality from 70 to 100; a model of the kernel's schedule (its groups of
macroblocks, the accumulation order of one thread's coefficient row, the
multiply-high division, the zigzag gather and the predecessors recomputed
for a group's first macroblock) equals the twin; `plane_levels` on CPU
tensors launches nothing; the wrapper rejects bad arguments.  On the card:
the kernel equals the twin and the numpy chain, predictors included, the
whole q=85 encode gives the CPU's bytes, each f32 call launches the kernel
once, and its machine code holds no FFMA.  The card tests skip without a
CUDA card (decided in a fixture); this file imports nothing of the JAX
package, so on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_f32_levels.py

Tolerance: exact (0).  The f32 DCT's coefficients often sit on an exact
.5, so a sum in another order, an FMA or TF32 rounds some to the other
integer; the tie-hunting set makes sure such blocks are tested.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder, plane_levels
from ec504_imageencoder_tpu_torch.ops import _build, cuda_vlc_levels
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import MAX_WIDTH
from ec504_imageencoder_tpu_torch.ops.cuda_vlc_levels import f32_levels, f32_levels_plain
from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420
from ec504_imageencoder_tpu_torch.ops.dct import dct_matrix_f32
from ec504_imageencoder_tpu_torch.utils.tables import ZIGZAG_GATHER

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "ec504_imageencoder_tpu_torch" / "csrc" / "vlc_levels4.cu"
GOLDEN = ROOT / "tests" / "golden"
D = dct_matrix_f32()
F32 = np.float32


def _qw(quality: int) -> np.ndarray:
    intra_q, qscale = mpeg1.quality_to_quant(quality)
    return (intra_q * qscale).astype(np.int32)


def _args(planes, quality, dev="cpu"):
    """Torch arguments of `f32_levels` on `dev`."""
    return (*(torch.from_numpy(np.ascontiguousarray(p)).to(dev) for p in planes),
            torch.from_numpy(_qw(quality)).to(dev), torch.from_numpy(ZIGZAG_GATHER).to(dev))


# ---- the numpy chain (the reference's host arithmetic) -----------------------

def _blocks(y, cb, cr) -> np.ndarray:
    """Planes -> (B, mbh, mbw, 6, 8, 8) u8: luma TL, TR, BL, BR, Cb, Cr."""
    b, h, w = y.shape
    mbh, mbw = h // 16, w // 16
    luma = y.reshape(b, mbh, 2, 8, mbw, 2, 8).transpose(0, 1, 4, 2, 5, 3, 6)
    luma = luma.reshape(b, mbh, mbw, 4, 8, 8)
    chroma = [p.reshape(b, mbh, 8, mbw, 8).transpose(0, 1, 3, 2, 4)[:, :, :, None]
              for p in (cb, cr)]
    return np.concatenate([luma, *chroma], axis=3)


def _einsum_f(blocks) -> np.ndarray:
    """The reference's f32 DCT before rounding: numpy's einsum."""
    return np.einsum("vy,...yx,ux->...vu", D, blocks.astype(F32), D)


def _round(f) -> np.ndarray:
    return np.where(f >= 0, np.floor(f + F32(0.5)), np.ceil(f - F32(0.5))).astype(np.int32)


def _quantize(coef, qw):
    """`quantize_intra` in numpy: (dc, levels in natural order)."""
    dc = np.clip((coef[..., 0, 0] + 4) >> 3, 0, 255)
    mag = np.clip((16 * np.abs(coef) + qw) // (2 * qw), 0, 255)
    return dc, np.sign(coef) * mag


def _numpy_levels(y, cb, cr, qw):
    """The whole stage in numpy: (levels (R, NB, 64), preds (R, NB))."""
    blocks = _blocks(y, cb, cr)
    b, mbh, mbw = blocks.shape[:3]
    dc, lvl = _quantize(_round(_einsum_f(blocks)), qw)
    zz = lvl.reshape(*lvl.shape[:-2], 64)[..., ZIGZAG_GATHER]
    zz[..., 0] = dc
    pred = np.full_like(dc, 128)
    luma = dc[..., :4].reshape(b, mbh, mbw * 4)
    pred[..., :4] = np.concatenate(
        [np.full((b, mbh, 1), 128), luma[..., :-1]], axis=-1).reshape(b, mbh, mbw, 4)
    pred[:, :, 1:, 4:] = dc[:, :, :-1, 4:]
    r = b * mbh
    return zz.reshape(r, mbw * 6, 64).astype(np.int32), pred.reshape(r, mbw * 6).astype(np.int32)


def _equal(got, want) -> None:
    for name, g, w in zip(("levels", "preds"), got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}"
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{name}: {len(bad)} values differ, first at {bad[:4].tolist()}"


# ---- inputs -----------------------------------------------------------------

def _fixture_planes(b, h, w, shift=0):
    """The golden fixture's frames (600 x 400 RGB), tiled to h x w, rolled by
    `shift` columns per frame, as 4:2:0 planes (studio range)."""
    with np.load(GOLDEN / "fixture_rgb.npz") as z:
        frames = [z[k] for k in sorted(z.files)]
    rgb = np.stack([np.roll(np.tile(frames[i % len(frames)], (-(-h // 600), -(-w // 400), 1)),
                            shift * (i + 1), axis=1)[:h, :w] for i in range(b)])
    y, cb, cr = rgb_to_ycbcr(torch.from_numpy(rgb), "studio")
    return y.numpy(), subsample_420(cb).numpy(), subsample_420(cr).numpy()


def _noise_planes(rng, b, h, w):
    return tuple(rng.integers(0, 256, s, dtype=np.uint8)
                 for s in ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2)))


def _tie_blocks() -> np.ndarray:
    """(N, 8, 8) u8: every single-pixel impulse of every value (64 x 256),
    the 256 constant blocks, and two-level steps (a vertical and a
    horizontal edge at every position, low/high pairs of a coarse grid)."""
    imp = np.zeros((64, 256, 64), np.uint8)
    imp[np.arange(64), :, np.arange(64)] = np.arange(256, dtype=np.uint8)
    const = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None], (256, 64))
    lo, hi = np.meshgrid(np.arange(0, 256, 17), np.arange(0, 256, 17), indexing="ij")
    steps = []
    for edge in range(1, 8):
        for axis in (0, 1):
            mask = (np.indices((8, 8))[axis] >= edge).reshape(64)
            steps.append(np.where(mask, hi.reshape(-1, 1), lo.reshape(-1, 1)))
    return np.concatenate([imp.reshape(-1, 64), const,
                           np.concatenate(steps).astype(np.uint8)]).reshape(-1, 8, 8)


def _blocks_as_planes(blocks):
    """(N, 8, 8) blocks -> planes whose blocks in stream order are these,
    N padded with zero blocks to whole macroblocks; one row of macroblocks
    a frame, 8 macroblocks a row."""
    mbw = 8
    n = -(-len(blocks) // (6 * mbw)) * 6 * mbw
    blk = np.zeros((n, 8, 8), np.uint8)
    blk[:len(blocks)] = blocks
    blk = blk.reshape(-1, mbw, 6, 8, 8)
    b = len(blk)
    y = blk[:, :, :4].reshape(b, mbw, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5).reshape(b, 16, 16 * mbw)
    cb = blk[:, :, 4].transpose(0, 2, 1, 3).reshape(b, 8, 8 * mbw)
    cr = blk[:, :, 5].transpose(0, 2, 1, 3).reshape(b, 8, 8 * mbw)
    return np.ascontiguousarray(y), np.ascontiguousarray(cb), np.ascontiguousarray(cr)


# ---- a model of the kernel's schedule ------------------------------------------

def _kernel_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def _chain(x: np.ndarray, rows=range(8), cols=range(8)) -> np.ndarray:
    """The kernel's DCT of (N, 8, 8) f32 blocks, one accumulator a
    coefficient: acc[v][u] over y (outer), k (inner) of
    (d[v][y] * x[y][k]) * d[u][k], from its first product, every step
    rounded to f32 -> (N, len(rows), len(cols)) f32."""
    acc = {}
    for yy in range(8):
        for v in rows:
            p = [D[v, yy] * x[:, yy, k] for k in range(8)]
            for u in cols:
                for k in range(8):
                    t = p[k] * D[u, k]
                    acc[v, u] = t if (yy, k) == (0, 0) else acc[v, u] + t
    return np.stack([np.stack([acc[v, u] for u in cols], -1) for v in rows], -2)


def _model_levels(y, cb, cr, qw):
    """The kernel's schedule in numpy: stream block g read at the kernel's
    addresses (`block_row`), groups of kLevelsMbs macroblocks, the DCT by
    `_chain`, the division by ceil(2^32 / 2qW) and a multiply-high, the
    zigzag as a gather with lane 0 the DC, and each predictor from the
    group's DCs or, for the group's first macroblock, from the three
    predecessors' DCs recomputed from their pixels."""
    b, h, w = y.shape
    mbw = w // 16
    n = b * (h // 16) * mbw * 6
    g = np.arange(n)
    mb, c = g // 6, g % 6
    row, mx = mb // mbw, mb % mbw
    r = np.arange(8)[:, None]
    cols = np.arange(8)[None, :]
    px = np.empty((n, 8, 8), np.uint8)
    luma = c < 4
    yrow = row[:, None, None] * 16 + (c[:, None, None] >> 1) * 8 + r
    ycol = mx[:, None, None] * 16 + (c[:, None, None] & 1) * 8 + cols
    px[luma] = y.reshape(-1, w)[yrow[luma], ycol[luma]]
    for comp, plane in ((4, cb), (5, cr)):
        sel = c == comp
        px[sel] = plane.reshape(-1, w // 2)[row[sel, None, None] * 8 + r, mx[sel, None, None] * 8 + cols]
    x = px.astype(F32)
    coef = _round(_chain(x))
    d2 = 2 * qw.reshape(64).astype(np.int64)
    m = 0xFFFFFFFF // d2 + 1  # ceil(2^32 / d2), as the kernel builds it
    num = 16 * np.abs(coef.reshape(n, 64)).astype(np.int64) + qw.reshape(64)
    mag = np.minimum((num * m) >> 32, 255)
    lvl = np.sign(coef.reshape(n, 64)) * mag
    dc = np.clip((coef[:, 0, 0] + 4) >> 3, 0, 255)
    levels = lvl[:, ZIGZAG_GATHER]
    levels[:, 0] = dc
    group = 6 * _kernel_const("kLevelsMbs")
    preds = np.empty(n, np.int64)
    for g0 in range(0, n, group):
        carry = (g0 // 6) % mbw != 0
        extra = np.zeros(3, np.int64)
        if carry:  # the previous macroblock's BR, Cb and Cr, from their pixels
            f00 = _chain(x[g0 - 3:g0], rows=[0], cols=[0])[:, 0, 0]
            extra = np.clip((_round(f00) + 4) >> 3, 0, 255)
        for t in range(min(group, n - g0)):
            ct = t % 6
            if 1 <= ct <= 3:
                preds[g0 + t] = dc[g0 + t - 1]
            elif mx[g0 + t] == 0:
                preds[g0 + t] = 128
            elif ct == 0:
                preds[g0 + t] = dc[g0 + t - 3] if t >= 3 else extra[0]
            else:
                preds[g0 + t] = dc[g0 + t - 6] if t >= 6 else extra[ct - 3]
    rr = b * (h // 16)
    return levels.reshape(rr, -1, 64).astype(np.int32), preds.reshape(rr, -1).astype(np.int32)


# ---- CPU ------------------------------------------------------------------------

def test_kernel_basis_is_dct_matrix_f32():
    body = re.search(r"__constant__ float kDct\[64\] = \{(.*?)\};", SOURCE.read_text(), re.S)
    lits = re.findall(r"-?0x[0-9a-f.]+p-?\d+f", body.group(1))
    got = np.array([float.fromhex(s[:-1]) for s in lits], np.float64)
    assert got.shape == (64,)
    assert np.array_equal(got.astype(F32).astype(np.float64), got)  # each exactly an f32
    assert np.array_equal(got.astype(F32).reshape(8, 8), D)


def test_tie_set_holds_exact_halves():
    """The tie-hunting blocks put coefficients on exact .5 before rounding
    (where half-away and half-even differ), in several positions."""
    f = _einsum_f(_tie_blocks())
    ties = np.abs(f - np.trunc(f)) == 0.5
    assert ties.sum() >= 100
    assert len({(v, u) for _, v, u in np.argwhere(ties)}) >= 4
    assert (_round(f[ties]) != np.round(f[ties])).any()


@pytest.mark.parametrize("quality", range(70, 101))
def test_twin_equals_numpy_chain_at_every_quality(quality):
    planes = _fixture_planes(2, 32, 48, shift=quality)
    _equal(f32_levels_plain(*_args(planes, quality)), _numpy_levels(*planes, _qw(quality)))


@pytest.mark.parametrize("quality", [70, 85, 100])
def test_twin_equals_numpy_chain_on_the_tie_set(quality):
    planes = _blocks_as_planes(_tie_blocks())
    _equal(f32_levels_plain(*_args(planes, quality)), _numpy_levels(*planes, _qw(quality)))


def test_kernel_order_equals_numpy_einsum():
    """`_chain`, the kernel's accumulation order, gives numpy's einsum bits
    on the tie set and on noise."""
    x = np.concatenate([_tie_blocks(),
                        np.random.default_rng(1).integers(0, 256, (2000, 8, 8), dtype=np.uint8)])
    x = x.astype(F32)
    got, want = _chain(x), _einsum_f(x)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# (frames, height, width): one macroblock row of 1, 3, 7, 8, 9 and 17
# macroblocks (a group of 8 straddles rows, or starts mid-row), tall frames
MODEL_SHAPES = [(1, 16, 16), (3, 16, 48), (2, 32, 112), (1, 16, 128), (2, 48, 144),
                (1, 32, 272)]


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("content", ["noise", "fixture"])
def test_kernel_schedule_model_equals_twin(shape, content):
    quality = 70 + sum(shape) % 31
    planes = (_noise_planes(np.random.default_rng(sum(shape)), *shape) if content == "noise"
              else _fixture_planes(*shape, shift=7))
    got = _model_levels(*planes, _qw(quality))
    _equal(f32_levels_plain(*_args(planes, quality)), got)


def test_multiply_high_division_is_exact():
    """floor(num / d) = (num * ceil(2^32 / d)) >> 32 for every divisor
    d = 2 qW <= kMaxMulDiv and every numerator 16 |F| + qW, |F| <= 2040."""
    d_max = _kernel_const("kMaxMulDiv")
    for d in (*range(2, 4097, 2), *range(d_max - 2001, d_max + 1, 2)):
        num = np.arange(d // 2, 16 * 2040 + d // 2 + 1, dtype=np.int64)
        m = 0xFFFFFFFF // d + 1  # the kernel's ceil(2^32 / d)
        assert m == -(-(1 << 32) // d)
        assert np.array_equal((num * m) >> 32, num // d), d


def test_plane_levels_on_cpu_runs_the_twin(monkeypatch):
    planes = _noise_planes(np.random.default_rng(5), 2, 32, 48)
    args = _args(planes, 85)
    before = cuda_vlc_levels.launches_levels

    def no_kernel():
        raise AssertionError("the CPU route loaded the kernel")

    monkeypatch.setattr(cuda_vlc_levels, "load_kernel", no_kernel)
    _equal(plane_levels(*args), _numpy_levels(*planes, _qw(85)))
    _equal(plane_levels(*args, dct_impl="f32"), _numpy_levels(*planes, _qw(85)))
    assert cuda_vlc_levels.launches_levels == before


def _bad_args(case):
    y, cb, cr, qw, zz = _args(_noise_planes(np.random.default_rng(0), 2, 32, 48), 85)
    return {
        "y-2d": (y[0], cb, cr, qw, zz),
        "height-not-16": (y[:, :24], cb[:, :12], cr[:, :12], qw, zz),
        "width-not-16": (y[..., :40], cb[..., :20], cr[..., :20], qw, zz),
        "cb-shape": (y, cb[:, :8], cr, qw, zz),
        "cr-batch": (y, cb, cr[:1], qw, zz),
        "y-int16": (y.short(), cb, cr, qw, zz),
        "cr-float": (y, cb, cr.float(), qw, zz),
        "qw-int64": (y, cb, cr, qw.long(), zz),
        "qw-shape": (y, cb, cr, qw.reshape(64), zz),
        "zigzag-int64": (y, cb, cr, qw, zz.long()),
        "zigzag-shape": (y, cb, cr, qw, zz[:63]),
    }[case]


BAD = {"y-2d": ValueError, "height-not-16": ValueError, "width-not-16": ValueError,
       "cb-shape": ValueError, "cr-batch": ValueError, "y-int16": TypeError,
       "cr-float": TypeError, "qw-int64": TypeError, "qw-shape": TypeError,
       "zigzag-int64": TypeError, "zigzag-shape": TypeError}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_bad_arguments(case, monkeypatch):
    """Each is refused by the checks, before the kernel's library is
    loaded (which is the first thing a launch does)."""
    def no_kernel():
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(cuda_vlc_levels, "load_kernel", no_kernel)
    with pytest.raises(BAD[case]):
        f32_levels(*_bad_args(case))


def test_wrapper_rejects_an_unknown_device():
    args = _args(_noise_planes(np.random.default_rng(0), 1, 16, 16), 85, "meta")
    with pytest.raises(ValueError):
        f32_levels(*args)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_f32_levels.py`")
    return torch.device("cuda", 0)


def _kernel_vs_twin(planes, quality, dev, numpy_too=False):
    args = _args(planes, quality, dev)
    before = cuda_vlc_levels.launches_levels
    got = f32_levels(*args)
    torch.cuda.synchronize()
    assert cuda_vlc_levels.launches_levels == before + 1
    want = f32_levels_plain(*args)  # the plain ops on the card: numpy's bits
    _equal(got, tuple(t.cpu().numpy() for t in want))
    if numpy_too:
        _equal(got, _numpy_levels(*planes, _qw(quality)))
    return got


# (frames, height, width): B = 1, 3 and 16, from one macroblock to MAX_WIDTH
CARD_SHAPES = [(1, 16, 16), (3, 16, 16), (16, 16, 16), (3, 32, 48), (2, 16, 1408),
               (1, 48, MAX_WIDTH), (16, 64, 208), (3, 1088, 1920)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("content", ["noise", "fixture"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_equals_twin(cuda, shape, content):
    planes = (_noise_planes(np.random.default_rng(sum(shape)), *shape) if content == "noise"
              else _fixture_planes(*shape, shift=3))
    _kernel_vs_twin(planes, 85, cuda, numpy_too=shape[0] * shape[1] * shape[2] <= 1 << 20)


@pytest.mark.requires_cuda
def test_kernel_equals_twin_at_16x1080p(cuda):
    _kernel_vs_twin(_fixture_planes(16, 1088, 1920, shift=11), 85, cuda)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("quality", range(70, 101))
def test_kernel_at_every_quality(cuda, quality):
    _kernel_vs_twin(_fixture_planes(2, 64, 96, shift=quality), quality, cuda, numpy_too=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("quality", [70, 85, 100])
def test_kernel_on_the_tie_set(cuda, quality):
    _kernel_vs_twin(_blocks_as_planes(_tie_blocks()), quality, cuda, numpy_too=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(3, 32, 48), (2, 48, 144), (1, 32, 272), (2, 32, 1920)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_predictors(cuda, shape):
    """128 at every slice row's start for Y, Cb and Cr; elsewhere the
    previous luma block's DC, and the previous macroblock's Cb (Cr) DC
    across the interleave, also where a CUDA block's group of macroblocks
    starts mid-row."""
    planes = _noise_planes(np.random.default_rng(sum(shape) + 1), *shape)
    levels, preds = (t.cpu().numpy() for t in _kernel_vs_twin(planes, 90, cuda))
    dc = levels[..., 0].reshape(preds.shape[0], -1, 6)
    p = preds.reshape(dc.shape)
    assert (p[:, 0, [0, 4, 5]] == 128).all()
    assert np.array_equal(p[:, :, 1:4], dc[:, :, 0:3])
    assert np.array_equal(p[:, 1:, 0], dc[:, :-1, 3])
    assert np.array_equal(p[:, 1:, 4:], dc[:, :-1, 4:])


@pytest.mark.requires_cuda
def test_kernel_runs_on_the_current_stream(cuda):
    planes = _noise_planes(np.random.default_rng(9), 2, 32, 48)
    args = _args(planes, 85, cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = tuple(t.cpu() for t in f32_levels(*args))
    _equal(got, _numpy_levels(*planes, _qw(85)))


@pytest.mark.requires_cuda
def test_kernel_rejects_strided_and_misaligned_planes(cuda):
    y, cb, cr, qw, zz = _args(_noise_planes(np.random.default_rng(2), 2, 32, 64), 85, cuda)
    with pytest.raises(ValueError):
        f32_levels(y[:, :, ::2], cb[:, :, ::2], cr[:, :, ::2], qw, zz)
    flat = torch.zeros(y.numel() + 4, dtype=torch.uint8, device=cuda)
    shifted = flat[4:].view(y.shape)
    with pytest.raises(ValueError):
        f32_levels(shifted, cb, cr, qw, zz)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("frames,height,width", [(2, 1080, 1920), (3, 72, 136)],
                         ids=["1080p", "rehearse-136x72"])
def test_encode_from_planes_q85_on_the_card_equals_the_cpu(cuda, frames, height, width):
    planes = _fixture_planes(frames, height, width, shift=5)
    want = TorchMPEG1IntraEncoder(quality=85, device="cpu").encode_from_planes(*planes)
    enc = TorchMPEG1IntraEncoder(quality=85, device=cuda)
    before = cuda_vlc_levels.launches_levels
    assert enc.encode_from_planes(*planes) == want
    assert cuda_vlc_levels.launches_levels == before + 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("quality,dct_impl,launches", [(85, "auto", 1), (50, "f32", 1),
                                                       (50, "auto", 0), (85, "aan", 0)])
def test_launches_once_a_call_on_the_f32_route(cuda, quality, dct_impl, launches):
    planes = _noise_planes(np.random.default_rng(4), 2, 32, 48)
    enc = TorchMPEG1IntraEncoder(quality=quality, dct_impl=dct_impl, device=cuda)
    want = TorchMPEG1IntraEncoder(quality=quality, dct_impl=dct_impl,
                                  device="cpu").encode_from_planes(*planes)
    before = cuda_vlc_levels.launches_levels
    for i in range(2):
        assert enc.encode_from_planes(*planes) == want
        assert cuda_vlc_levels.launches_levels == before + launches * (i + 1)


def _sass_functions(lib: Path) -> dict:
    """Function name -> its SASS, from `cuobjdump -sass`."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        cuobjdump = Path(shutil.which("cuobjdump") or cuobjdump)
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", out)
    return dict(zip(parts[1::2], parts[2::2]))


@pytest.mark.requires_cuda
def test_kernel_machine_code_holds_no_ffma(cuda):
    """nvcc contracts a * b + c into FFMA unless told not to; the kernel's
    __fmul_rn / __fadd_rn must leave none, and its multiplies and adds must
    be there."""
    cuda_vlc_levels.load_kernel()
    funcs = _sass_functions(_build._library("vlc_levels4"))
    sass = [s for name, s in funcs.items() if "f32_levels_kernel" in name]
    assert len(sass) == 1, sorted(funcs)
    ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass[0], re.M)
    assert "FFMA" not in ops
    assert ops.count("FMUL") >= 8 * 8 * 9 and ops.count("FADD") >= 8 * 63
