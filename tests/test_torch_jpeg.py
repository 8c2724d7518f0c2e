"""The port's JPEG back half (`ops/jpeg_device.py`) and its coefficients
intake (`TorchMPEG1IntraEncoder.encode_from_coeffs`) against the JAX
package, on the CPU.

* Each function of `jpeg_device` against its namesake in the reference's
  `ops/jpeg_tpu.py` with `xp=np`, on seeded int16 coefficient blocks, the
  int16 extremes included (there the int32 products wrap, as in numpy),
  and on seeded u8 planes.
* `decode_planes_from_coeffs` against the native stb planes
  (`io/jpeg.decode_planes_batch`) of synthesized 4:2:0 JPEGs, odd sizes and
  progressive ones included, as `tests/test_jpeg_tpu.py` builds them; these
  cases skip where the native decoder does not load.
* `encode_from_coeffs` against `MPEG1IntraEncoder(backend="numpy")
  .encode_from_coeffs` and the port's own `encode_from_planes` on the
  decoded planes, on every route the port has (fuse=8, pack="fused",
  debug_checks); its shape checks against the reference's; `edge_pad`
  against `np.pad(mode="edge")`.
* C-r1 (ROADMAP), reproduced as the reference has it: the coefficients
  intake stores the JPEG's full-range YCbCr.

Tolerance: exact (0) everywhere: integer arithmetic, equal bytes.
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.io import jpeg as jio
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu.ops import jpeg_tpu as jt
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder, edge_pad
from ec504_imageencoder_tpu_torch.ops import jpeg_device as jd

I16 = np.iinfo(np.int16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.from_numpy(want).dtype
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def _blocks(kind: str, n: int, seed: int) -> np.ndarray:
    """(n, 64) int16 coefficient blocks: "typical" (dequantized JPEG range,
    mostly small ACs), "full" (uniform over int16), "extremes" (every entry
    -32768, -32767, 0 or 32767: the int32 products wrap), "dc-only"."""
    rng = np.random.default_rng(seed)
    if kind == "typical":
        b = rng.integers(-64, 65, (n, 64)) * (rng.random((n, 64)) < 0.3)
        b[:, 0] = rng.integers(-1024, 1024, n)
        return b.astype(np.int16)
    if kind == "full":
        return rng.integers(I16.min, I16.max + 1, (n, 64), dtype=np.int16)
    if kind == "extremes":
        vals = np.array([I16.min, -I16.max, 0, I16.max], np.int16)
        b = vals[rng.integers(0, 4, (n, 64))]
        b[: min(n, 3)] = np.array([I16.max, -I16.max, I16.min], np.int16)[: min(n, 3), None]
        return b
    b = np.zeros((n, 64), np.int16)
    b[:, 0] = rng.integers(I16.min, I16.max + 1, n)
    return b


BLOCK_KINDS = ("typical", "full", "extremes", "dc-only")


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_islow_idct_matches_reference(kind):
    b = _blocks(kind, 4096, len(kind))
    _equal(jd.islow_idct(_t(b)), jt.islow_idct(b, np))
    if kind == "extremes":
        # the row pass's products leave int32 here, so both wrap alike: its
        # inputs, the column pass's outputs computed in int64, times the
        # largest multiplier (3.072711026 in 12-bit fixed point)
        d = torch.from_numpy(b.astype(np.int64)).reshape(-1, 8, 8)
        x0, x1, x2, x3, t0, t1, t2, t3 = jd._idct_1d([d[:, r, :] for r in range(8)])
        col = torch.stack([(x0 + 512 + t3) >> 10, (x3 + 512 - t0) >> 10])
        assert int(col.abs().max()) * jd._f2f(3.072711026) > 2**31


@pytest.mark.parametrize("kind", BLOCK_KINDS)
@pytest.mark.parametrize("bh, bw", [(1, 1), (3, 5), (38, 51)])
def test_idct_plane_matches_reference(kind, bh, bw):
    b = _blocks(kind, 2 * bh * bw, bh * 100 + bw).reshape(2, bh * bw, 64)
    _equal(jd.idct_plane(_t(b), bh, bw), jt.idct_plane(b, bh, bw, np))


@pytest.mark.parametrize("axis", [-2, -1, 1, 2])
@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 7, 3), (3, 150, 201)])
def test_tri_axis_pairs_matches_reference(axis, shape):
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.int32)
    _equal(jd._tri_axis_pairs(_t(x), axis), jt._tri_axis_pairs(x, axis, np))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 7, 3), (3, 150, 201), (1, 540, 960)])
def test_upsample2x_triangular_matches_reference(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    c = rng.integers(0, 256, shape, dtype=np.uint8)
    c[..., 0, 0] = 255  # the descale's top end
    _equal(jd.upsample2x_triangular(_t(c)), jt.upsample2x_triangular(c, np))


def test_ycbcr_to_rgb_fixed_matches_reference():
    """Every (y, cb, cr) on a grid of 0..255 with the ends, and random
    planes: the green term's mask and the clamps."""
    v = np.unique(np.r_[np.arange(0, 256, 5), 0, 1, 127, 128, 129, 254, 255]).astype(np.uint8)
    y, cb, cr = (a.reshape(1, -1) for a in np.meshgrid(v, v, v, indexing="ij"))
    _equal(jd.ycbcr_to_rgb_fixed(*map(_t, (y, cb, cr))), jt.ycbcr_to_rgb_fixed(y, cb, cr, np))
    rng = np.random.default_rng(7)
    p = [rng.integers(0, 256, (2, 61, 47), dtype=np.uint8) for _ in range(3)]
    _equal(jd.ycbcr_to_rgb_fixed(*map(_t, p)), jt.ycbcr_to_rgb_fixed(*p, np))


# (h, w): even, odd in either dimension, a chroma plane one block wide, 1080p
SIZES = [(16, 16), (17, 33), (299, 401), (9, 8), (1080, 1920)]


def _coeffs(h, w, b, seed):
    ch, cw = -(-h // 2), -(-w // 2)
    n_y = -(-h // 8) * -(-w // 8)
    n_c = -(-ch // 8) * -(-cw // 8)
    return tuple(_blocks("typical", b * n, seed + i).reshape(b, n, 64)
                 for i, n in enumerate((n_y, n_c, n_c)))


@pytest.mark.parametrize("h, w", SIZES)
def test_decode_from_coeffs_matches_reference(h, w):
    yc, cbc, crc = _coeffs(h, w, 1 if h > 500 else 2, h + w)
    want = jt.decode_planes_from_coeffs(yc, cbc, crc, h, w, np)
    got = jd.decode_planes_from_coeffs(*map(_t, (yc, cbc, crc)), h, w)
    for g, wt in zip(got, want, strict=True):
        _equal(g, wt)
    _equal(jd.decode_rgb_from_planes(*got), jt.decode_rgb_from_planes(*want, np))
    _equal(jd.decode_rgb_from_coeffs(*map(_t, (yc, cbc, crc)), h, w),
           jt.decode_rgb_from_coeffs(yc, cbc, crc, h, w, np))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("shape, h, w", [((2, 5, 7), 16, 16), ((1, 8, 8), 8, 16),
                                         ((1, 150, 201), 150, 208), ((3, 1, 1), 8, 8),
                                         ((1, 299, 401), 304, 416)])
def test_edge_pad_matches_numpy(shape, h, w, dtype):
    x = np.random.default_rng(h * w).integers(0, 256, shape).astype(dtype)
    want = np.pad(x, ((0, 0), (0, h - shape[1]), (0, w - shape[2])), mode="edge")
    _equal(edge_pad(_t(x), h, w), want)


# ---- synthesized JPEGs through the native decoder -------------------------

native = pytest.mark.skipif(
    not (jio.have_native_decoder() and hasattr(jio._load_native(), "stbj_probe_file")),
    reason="native staged JPEG decoder unavailable",
)
# (w, h, quality, progressive), as tests/test_jpeg_tpu.py makes them
JPEG_CASES = [(64, 48, 90, False), (33, 17, 75, False), (401, 299, 85, False),
              (128, 96, 95, True), (257, 129, 60, True), (16, 16, 50, False)]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Per case: (geometry, stb planes (y, cb, cr), int16 coefficients)."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(20261017)
    out = []
    for i, (w, h, q, prog) in enumerate(JPEG_CASES):
        base = (np.sin(np.arange(h)[:, None] / 7) * 50 + 128)[:, :, None]
        img = np.clip(base + rng.integers(-40, 40, (h, w, 3)), 0, 255)
        p = str(tmp / f"f{i}.jpg")
        Image.fromarray(img.astype(np.uint8)).save(p, quality=q, progressive=prog, subsampling=2)
        g = jio.probe_jpeg(p)
        out.append((g, jio.decode_planes_batch([p], g), jio.decode_coeffs_batch([p], g)))
    return out


@native
@pytest.mark.parametrize("case", range(len(JPEG_CASES)))
def test_planes_equal_the_native_decoder(jpegs, case):
    g, planes, coeffs = jpegs[case]
    assert all(c.dtype == np.int16 for c in coeffs)
    got = jd.decode_planes_from_coeffs(*map(_t, coeffs), g["height"], g["width"])
    for gp, wp in zip(got, planes, strict=True):
        _equal(gp, wp)


@native
@pytest.mark.parametrize("quality", [45, 85])
@pytest.mark.parametrize("case", [2, 5], ids=["401x299", "16x16"])
def test_encode_from_coeffs_matches_reference(jpegs, case, quality):
    """Byte-equal to the reference's numpy coefficients intake and to the
    port's planes intake on the native decoder's planes; numpy int16 and
    torch int16 inputs alike."""
    g, planes, coeffs = jpegs[case]
    h, w = g["height"], g["width"]
    want = MPEG1IntraEncoder(quality=quality, backend="numpy").encode_from_coeffs(*coeffs, h, w)
    enc = TorchMPEG1IntraEncoder(quality=quality, device="cpu")
    assert enc.encode_from_coeffs(*coeffs, h, w) == want
    assert enc.encode_from_coeffs(*map(_t, coeffs), h, w) == want
    assert TorchMPEG1IntraEncoder(quality=quality, device="cpu").encode_from_planes(*planes) == want


@native
@pytest.mark.parametrize("route", [{"fuse": 8}, {"pack": "fused"}, {"debug_checks": True},
                                   {"max_slice_bytes": 2560}],
                         ids=["fuse8", "pack-fused", "debug-checks", "regrow"])
@pytest.mark.parametrize("quality", [45, 85])
def test_encode_from_coeffs_on_every_route(jpegs, route, quality):
    g, planes, coeffs = jpegs[2]  # 401 x 299
    want = MPEG1IntraEncoder(quality=quality, backend="numpy").encode_from_coeffs(
        *coeffs, g["height"], g["width"])
    got = TorchMPEG1IntraEncoder(quality=quality, device="cpu", **route).encode_from_coeffs(
        *coeffs, g["height"], g["width"], first_frame_index=0)
    assert got == want


def test_encode_from_coeffs_of_random_blocks_matches_reference():
    """Without the native decoder too: random dequantized blocks, two
    frames at an odd size and a later first_frame_index."""
    h, w = 37, 70
    coeffs = _coeffs(h, w, 2, 5)
    for q in (12, 85):
        want = MPEG1IntraEncoder(quality=q, backend="numpy").encode_from_coeffs(
            *coeffs, h, w, first_frame_index=14)
        got = TorchMPEG1IntraEncoder(quality=q, device="cpu").encode_from_coeffs(
            *coeffs, h, w, first_frame_index=14)
        assert got == want


@pytest.mark.parametrize("bad", ["Y", "Cb", "Cr", "ndim"])
def test_coefficient_shape_errors_match_reference(bad):
    h, w = 17, 33
    coeffs = list(_coeffs(h, w, 1, 3))
    if bad == "ndim":
        coeffs[0] = coeffs[0][0]
    else:
        i = ("Y", "Cb", "Cr").index(bad)
        coeffs[i] = coeffs[i][:, 1:]
    errors = []
    for enc in (MPEG1IntraEncoder(quality=50, backend="numpy"),
                TorchMPEG1IntraEncoder(quality=50, device="cpu")):
        with pytest.raises(ValueError) as e:
            enc.encode_from_coeffs(*coeffs, h, w)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_coefficients_beyond_mpeg1_limits_raise():
    h, w = 16, 4096  # wider than the 12-bit sequence header
    coeffs = _coeffs(h, w, 1, 9)
    with pytest.raises(ValueError, match="exceeds MPEG-1 limits"):
        TorchMPEG1IntraEncoder(quality=50, device="cpu").encode_from_coeffs(*coeffs, h, w)


def test_coeffs_intake_stores_full_range_c_r1():
    """C-r1, reproduced, not fixed: the coefficients intake encodes the
    JPEG's full-range YCbCr planes as they are, so it equals the planes
    intake on them and differs from the rgb intake of the same pixels,
    which converts to studio range."""
    h, w = 32, 48
    coeffs = _coeffs(h, w, 1, 11)
    planes = jt.decode_planes_from_coeffs(*coeffs, h, w, np)
    rgb = jt.decode_rgb_from_planes(*planes, np)
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    got = enc.encode_from_coeffs(*coeffs, h, w)
    assert got == TorchMPEG1IntraEncoder(quality=50, device="cpu").encode_from_planes(*planes)
    assert got != TorchMPEG1IntraEncoder(quality=50, device="cpu").encode(rgb)
    assert got == MPEG1IntraEncoder(quality=50, backend="numpy").encode_from_coeffs(*coeffs, h, w)
