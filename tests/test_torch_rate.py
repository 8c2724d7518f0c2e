"""The rate control (`TorchMPEG1IntraEncoder(bit_rate=)`): each picture
coded at its own quantizer_scale q*, the smallest of 1..31 whose coded
picture fits the budget, and padded to exactly the budget.

On the CPU, at small sizes with budgets that bind there: the port's CPU
path (the count kernel's twin `ops/cuda_rate.py::bit_count_plain`, B1's
twin at per-picture scales) against the plain reference
`portbench/reference/rate.py` byte for byte, on seeded noise and fixture
tiles, through `encode` and `encode_from_planes`; the twin's table against
fixed-scale encodes; q* on a picture whose bits are not monotone in the
scale; every fitting picture exactly the budget; the overshoot path; a
batch at several scales; the sequence header's fields; the decoder reading
the stream back at each picture's scale; the other routes and entry
points; the regrow; the errors.  On the card (they skip without one): the
count kernel and B1, B6b and B6a at per-picture scales against their
twins, at 16 x 1080p among others, and whole encodes against the CPU.
This file imports nothing of the JAX package, so on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rate.py

Tolerance: exact (0).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.decoder import decode_es
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder, quality_to_quant
from ec504_imageencoder_tpu_torch.ops import _build, cuda_rate, cuda_vlc, cuda_vlc_raw
from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
from ec504_imageencoder_tpu_torch.syntax import headers
from ec504_imageencoder_tpu_torch.utils.tables import ZIGZAG_GATHER
from portbench.reference import color, rate
from portbench.traffic import fixture_tiles

CSRC = Path(mpeg1.__file__).resolve().parent.parent / "csrc"


def _noise_planes(seed, n, h, w):
    rng = np.random.default_rng(seed)
    ch, cw = -(-h // 2), -(-w // 2)
    return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            rng.integers(0, 256, (n, ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (n, ch, cw), dtype=np.uint8))


def _fixture_rgb(seed, n, h, w):
    return fixture_tiles.rgb_frames(np.random.default_rng(seed), n, h, w)


def _pictures(es: bytes):
    """The stream's pictures: each from its picture start code up to the
    next sequence, GOP, picture or sequence-end start code."""
    starts = [m.start() for m in re.finditer(b"\x00\x00\x01\x00", es)]
    out = []
    for a in starts:
        ends = [es.find(code, a + 4) for code in (b"\x00\x00\x01\x00", b"\x00\x00\x01\xb3",
                                                  b"\x00\x00\x01\xb8", b"\x00\x00\x01\xb7")]
        ends = [e for e in ends if e >= 0]
        out.append(es[a:min(ends) if ends else len(es)])
    return out


def _slice_scales(picture: bytes):
    """The quantizer_scale of each slice of a picture."""
    return [picture[m.start() + 4] >> 3
            for m in re.finditer(b"\x00\x00\x01[\x01-\xaf]", picture)]


def _encoder(bit_rate, **kw):
    return TorchMPEG1IntraEncoder(quality=kw.pop("quality", 50), bit_rate=bit_rate,
                                  device=kw.pop("device", "cpu"), **kw)


@pytest.fixture(autouse=True)
def _reset_counters():
    mpeg1.rate_qscales.clear()
    mpeg1.rate_overshoots = mpeg1.rate_pad_bytes = 0


# ---- the count and its twin -------------------------------------------------

def test_the_kernels_zigzag_is_the_iso_table():
    src = (CSRC / "bit_count.cu").read_text()
    body = re.search(r"constexpr int t\[64\] = \{([^}]*)\}", src).group(1)
    assert [int(v) for v in body.replace("\n", " ").split(",")] == ZIGZAG_GATHER.tolist()


@pytest.mark.parametrize("content", ["noise", "fixture"])
def test_twin_table_is_the_nbits_of_fixed_scale_encodes(content):
    """bit_count_plain's [b, s, q - 1] is slice s's nbits when the whole
    batch is coded at scale q (B1's twin and B2's twin)."""
    if content == "noise":
        y, cb, cr = (torch.from_numpy(a) for a in _noise_planes(1, 2, 32, 48))
    else:
        y, cb, cr = rgb_to_ycbcr(torch.from_numpy(_fixture_rgb(1, 2, 32, 48)), "studio")
        cb, cr = subsample_420(cb), subsample_420(cr)
    intra_q, _ = quality_to_quant(50)
    table = cuda_rate.bit_count(y, cb, cr, torch.as_tensor(intra_q), Luts.default("cpu"))
    assert table.shape == (2, 2, 31) and table.dtype == torch.int32
    for q in range(1, 32):
        _, nbits = mpeg1.EncodeCore(intra_q, q, "aan")(y, cb, cr, 8192)
        assert torch.equal(nbits, table[:, :, q - 1]), q


def test_twin_table_equals_the_references():
    y, cb, cr = (np.ascontiguousarray(a) for a in _noise_planes(2, 2, 32, 64))
    intra_q, _ = quality_to_quant(50)
    got = cuda_rate.bit_count(*(torch.from_numpy(a) for a in (y, cb, cr)),
                              torch.as_tensor(intra_q), Luts.default("cpu"))
    np.testing.assert_array_equal(got.numpy(), rate.slice_bits(y, cb, cr, 50))


# ---- the port's CPU path against the reference -------------------------------

# (content, frames, height, width, bit_rate): budgets of 2,200 and 500 bytes
# bind at scales 9-10 (noise) and 3-14 (fixture tiles) at 25 frames/s
CASES = [("noise", 3, 40, 56, 440_000), ("fixture", 3, 48, 80, 100_000),
         ("noise", 2, 33, 50, 400_000), ("fixture", 4, 72, 136, 400 * 700)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[2]}x{c[3]}")
def test_planes_equal_the_reference_byte_for_byte(case):
    content, n, h, w, bit_rate = case
    if content == "noise":
        y, cb, cr = _noise_planes(3, n, h, w)
    else:
        y, cb, cr = fixture_tiles.planes_420(_fixture_rgb(3, n, h, w))
    got = _encoder(bit_rate).encode_from_planes(y, cb, cr, first_frame_index=14)
    assert got == rate.encode_planes(y, cb, cr, 50, 3, 15, bit_rate, 14)
    assert len(set(mpeg1.rate_qscales)) >= 1 and mpeg1.rate_overshoots == 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[2]}x{c[3]}")
def test_rgb_equals_the_reference_byte_for_byte(case):
    content, n, h, w, bit_rate = case
    rgb = (np.random.default_rng(4).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
           if content == "noise" else _fixture_rgb(4, n, h, w))
    got = _encoder(bit_rate).encode(rgb, first_frame_index=29)
    assert got == rate.encode_planes(*color.planes_420(rgb), 50, 3, 15, bit_rate, 29, (w, h))


# ---- q*, the padding, the header ----------------------------------------------

def _non_monotone_picture():
    """One 16 x 16 picture, built from its DCT: in block 0 level 1 at scan
    position 8 and level 3 at 9 (quality 50's matrix) at scale 3.  At
    scale 4 the first quantizes to 0 and the second's run grows from 0 to
    8: the code of (run 8, level 3) is longer than both codes it replaces.
    Cb at 121 sets the DC bits so that the bytes step up too: 19, 20, 19
    bytes at scales 3, 4, 5."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    d *= np.where(k[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    f = np.zeros(64)
    f[ZIGZAG_GATHER[8]], f[ZIGZAG_GATHER[9]] = 4.47, 27.84
    y = np.full((1, 16, 16), 128, np.uint8)
    y[0, :8, :8] = np.clip(np.round(d.T @ f.reshape(8, 8) @ d + 128), 0, 255)
    return y, np.full((1, 8, 8), 121, np.uint8), np.full((1, 8, 8), 128, np.uint8)


def test_q_star_is_the_smallest_scale_that_fits_though_bits_are_not_monotone():
    y, cb, cr = _non_monotone_picture()
    intra_q, _ = quality_to_quant(50)
    table = cuda_rate.bit_count(*(torch.from_numpy(a) for a in (y, cb, cr)),
                                torch.as_tensor(intra_q), Luts.default("cpu"))
    sizes = ((table + 7) // 8).sum(dim=1)[0] + cuda_rate.PICTURE_HEADER_BYTES
    assert table[0, 0, 3] > table[0, 0, 2] and sizes[2:5].tolist() == [19, 20, 19]
    assert (sizes[:2] > 19).all()
    # 7,600 bit/s at 50 frames/s: 19 bytes; scale 4 does not fit, 5 does, 3 is the least
    enc = _encoder(7600, frame_rate_code=6)
    assert enc.budget_bytes == 19
    assert cuda_rate.choose_qscales(table, 19).tolist() == [3]
    es = enc.encode_from_planes(y, cb, cr)
    assert [len(p) for p in _pictures(es)] == [19] and mpeg1.rate_qscales == {3: 1}
    assert _slice_scales(_pictures(es)[0]) == [3]
    assert es == rate.encode_planes(y, cb, cr, 50, 6, 15, 7600)


def test_choose_qscales_tries_every_scale():
    table = torch.full((3, 2, 31), 8 * 100, dtype=torch.int32)  # 208 bytes a picture
    table[0, :, 4:] = 8 * 40   # fits from scale 5
    table[1, :, 2] = 8 * 40    # fits at 3 only
    assert cuda_rate.choose_qscales(table, 100).tolist() == [5, 3, 31]
    assert cuda_rate.choose_qscales(table, 208).tolist() == [1, 1, 1]


def test_every_picture_that_fits_is_exactly_the_budget_and_counted():
    y, cb, cr = fixture_tiles.planes_420(_fixture_rgb(5, 3, 48, 80))
    enc = _encoder(100_000)
    es = enc.encode_from_planes(y, cb, cr)
    pictures = _pictures(es)
    assert enc.budget_bytes == 500 and [len(p) for p in pictures] == [500] * 3
    # one batch at several scales, each picture's slices at its own
    scales = [_slice_scales(p) for p in pictures]
    assert all(len(set(s)) == 1 for s in scales) and len({s[0] for s in scales}) >= 2
    assert sorted(mpeg1.rate_qscales.elements()) == sorted(s[0] for s in scales)
    unpadded = [len(p.rstrip(b"\x00")) for p in pictures]  # slices end in a nonzero byte here
    assert mpeg1.rate_pad_bytes == sum(500 - u for u in unpadded) > 0
    assert mpeg1.rate_overshoots == 0


def test_overshoot_gives_31_over_budget_and_counts_it():
    y, cb, cr = _noise_planes(6, 2, 32, 32)
    es = _encoder(4000).encode_from_planes(y, cb, cr)  # 20 bytes a picture
    pictures = _pictures(es)
    assert all(len(p) > 20 for p in pictures) and mpeg1.rate_qscales == {31: 2}
    assert mpeg1.rate_overshoots == 2 and mpeg1.rate_pad_bytes == 0
    assert [_slice_scales(p) for p in pictures] == [[31, 31]] * 2


@pytest.mark.parametrize("bit_rate,code,budget,vbv", [
    (50_000_000, 3, 250_000, 123), (400, 3, 2, 1), (400 * 0x3FFFE, 1, 546_675, 267),
    (20_000_000, 4, 83_416, 41), (6_000_000, 8, 12_500, 7)])
def test_sequence_header_fields(bit_rate, code, budget, vbv):
    enc = _encoder(bit_rate, frame_rate_code=code)
    assert (enc.budget_bytes, enc.vbv_size) == (budget, vbv)
    hdr = mpeg1.sequence_header_es(16, 16, code, vbv_size=enc.vbv_size,
                                   intra_matrix=enc.intra_q, bit_rate_units=bit_rate // 400)
    bits = int.from_bytes(hdr[4:12], "big")
    assert (bits >> 14) & 0x3FFFF == bit_rate // 400  # after 12 + 12 + 4 + 4 bits
    assert (bits >> 13) & 1 == 1 and (bits >> 3) & 0x3FF == vbv
    es = enc.encode_from_planes(*_noise_planes(7, 1, 16, 16))
    assert es.startswith(hdr)


def test_the_default_header_is_unchanged():
    """Without bit_rate: variable rate (0x3FFFF) and vbv_buffer_size 20."""
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    bits = int.from_bytes(enc.encode_from_planes(*_noise_planes(8, 1, 16, 16))[4:12], "big")
    assert (bits >> 14) & 0x3FFFF == 0x3FFFF and (bits >> 3) & 0x3FF == 20
    assert not mpeg1.rate_qscales


def test_the_decoder_reads_each_picture_at_its_scale():
    """The stream decodes (zero stuffing before each start code) to what
    each picture decodes to when coded alone at its q* without a rate."""
    rgb = _fixture_rgb(9, 3, 48, 80)
    es = _encoder(100_000).encode(rgb)
    frames = decode_es(es + headers.sequence_end())
    scales = [_slice_scales(p)[0] for p in _pictures(es)]
    assert len(frames) == 3 and len(set(scales)) >= 2
    for i, q in enumerate(scales):
        fixed = TorchMPEG1IntraEncoder(quality=50, device="cpu")
        fixed._set_quant(fixed.intra_q, q)
        (want,) = decode_es(fixed.encode(rgb[i:i + 1]) + headers.sequence_end())
        np.testing.assert_array_equal(frames[i], want)


# ---- routes, entry points, regrow ----------------------------------------------

@pytest.mark.parametrize("kw", [{"fuse": 8}, {"debug_checks": True}, {"pack": "fused"},
                                {"pack": "pallas1"}], ids=str)
def test_every_aan_route_gives_the_same_bytes(kw):
    y, cb, cr = _noise_planes(10, 3, 40, 56)
    want = _encoder(440_000).encode_from_planes(y, cb, cr)
    assert _encoder(440_000, **kw).encode_from_planes(y, cb, cr) == want


def test_coefficients_and_jpegs_entry_points():
    """encode_from_coeffs codes the planes its IDCT gives, as
    encode_from_planes codes them; encode_from_jpegs as its intake's
    entry point."""
    from ec504_imageencoder_tpu_torch.io import jpeg as jpeg_io

    data = Path(__file__).resolve().parent / "data" / "torch_jpegs"
    jpegs = sorted(data.glob("*.jpg"))[:2]
    geom = jpeg_io.probe_jpeg(jpegs[0])
    enc = _encoder(400 * 2000)
    got = enc.encode_from_jpegs(jpegs, intake="coeffs")
    yc, cbc, crc = jpeg_io.decode_batch(jpegs, geom, "coeffs")
    assert got == enc.encode_from_coeffs(yc, cbc, crc, geom["height"], geom["width"])
    planes = mpeg1.coeffs_to_planes(*(torch.from_numpy(a).to(torch.int32) for a in (yc, cbc, crc)),
                                    geom["height"], geom["width"])
    h, w = geom["height"], geom["width"]
    y, cb, cr = (p.numpy() for p in planes)
    want = enc.encode_from_planes(y[:, :h, :w], cb[:, :-(-h // 2), :-(-w // 2)],
                                  cr[:, :-(-h // 2), :-(-w // 2)])
    assert got == want
    budget = enc.budget_bytes
    assert all(len(p) == budget for p in _pictures(got)) or mpeg1.rate_overshoots
    assert enc.encode_from_jpegs(jpegs, intake="ycbcr") == rate.encode_planes(
        *jpeg_io.decode_batch(jpegs, geom, "planes"), 50, 3, 15, 400 * 2000)


def test_the_regrow_follows_the_chosen_scales():
    """Slice buffers sized for quality 50 overflow at small scales: one
    regrow, the same bytes as a large buffer."""
    y, cb, cr = _noise_planes(11, 2, 16, 1920)
    small = _encoder(400 * 100_000, max_slice_bytes=2560)
    got = small.encode_from_planes(y, cb, cr)
    assert small.max_slice_bytes > 2560 and set(mpeg1.rate_qscales) == {1}
    assert got == _encoder(400 * 100_000, max_slice_bytes=1 << 16).encode_from_planes(y, cb, cr)
    with pytest.raises(OverflowError):
        _encoder(400 * 100_000, max_slice_bytes=2560, grow_slices=False).encode_from_planes(
            y, cb, cr)


# ---- errors -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"quality": 70}, {"quality": 85}, {"quality": 50, "dct_impl": "f32"},
    {"bit_rate": 1000}, {"bit_rate": 0}, {"bit_rate": 400 * 0x3FFFF}, {"bit_rate": -400},
    {"bit_rate": 400.5}], ids=str)
def test_value_errors(kw):
    args = {"quality": 50, "bit_rate": 50_000_000, **kw}
    with pytest.raises(ValueError):
        TorchMPEG1IntraEncoder(device="cpu", **args)


def test_the_sharded_encoder_raises():
    from ec504_imageencoder_tpu_torch.parallel.mesh import make_mesh
    from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import ShardedTorchMPEG1Encoder

    mesh = make_mesh(1, 1, devices=["cpu"])
    with pytest.raises(NotImplementedError):
        ShardedTorchMPEG1Encoder(quality=50, bit_rate=50_000_000, mesh=mesh)
    ShardedTorchMPEG1Encoder(quality=50, mesh=mesh)  # without bit_rate it builds


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_rate.py`")
    return torch.device("cuda", 0)


def _card_planes(kind, n, h, w):
    if kind == "fixture":
        y, cb, cr = rgb_to_ycbcr(torch.from_numpy(_fixture_rgb(12, n, h, w)), "studio")
        return y, subsample_420(cb), subsample_420(cr)
    if kind == "checker":  # every AC level large: 28-bit escapes
        y = torch.from_numpy(((np.indices((h, w)).sum(0) % 2) * 255).astype(np.uint8))
        c = torch.from_numpy(((np.indices((h // 2, w // 2)).sum(0) % 2) * 255).astype(np.uint8))
        return y.expand(n, h, w).contiguous(), c.expand(n, h // 2, w // 2).contiguous(), \
            (255 - c).expand(n, h // 2, w // 2).contiguous()
    return tuple(torch.from_numpy(a) for a in _noise_planes(13, n, h, w))


CARD_SHAPES = [("fixture", 16, 1088, 1920), ("noise", 2, 64, 4096), ("noise", 3, 32, 48),
               ("checker", 2, 32, 1920), ("fixture", 1, 16, 16)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_count_kernel_equals_twin(cuda, shape):
    """The kernel against its twin run on the card (plain integer torch ops,
    the CPU's results), and against the CPU's twin where it is small."""
    planes = [p.to(cuda) for p in _card_planes(*shape)]
    intra_q = torch.as_tensor(quality_to_quant(50)[0], device=cuda)
    luts = Luts.default(cuda)
    before = _build.launches["bit_count"]
    got = cuda_rate.bit_count(*planes, intra_q, luts)
    torch.cuda.synchronize()
    assert _build.launches["bit_count"] == before + 1
    assert torch.equal(got.cpu(), cuda_rate.bit_count_plain(*planes, intra_q, luts).cpu())
    if shape[1] * shape[2] * shape[3] <= 1 << 20:
        cpu = cuda_rate.bit_count(*(p.cpu() for p in planes), intra_q.cpu(), Luts.default("cpu"))
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel", ["vlc_fused4", "vlc_fused8", "vlc_raw"])
def test_slots_at_per_picture_scales_equal_twin(cuda, kernel):
    planes = [p.to(cuda) for p in _card_planes("fixture", 16, 1088, 1920)]
    intra_q = torch.as_tensor(quality_to_quant(50)[0], device=cuda)
    qscales = torch.tensor([1, 2, 3, 5, 7, 8, 9, 10, 12, 15, 18, 20, 24, 28, 30, 31],
                           dtype=torch.int32, device=cuda)
    fn, twin = {"vlc_fused4": (cuda_vlc.vlc_fused4, cuda_vlc.vlc_fused4_plain),
                "vlc_fused8": (cuda_vlc.vlc_fused8, cuda_vlc.vlc_fused8_plain),
                "vlc_raw": (cuda_vlc_raw.vlc_raw, cuda_vlc_raw.vlc_raw_plain)}[kernel]
    got = fn(*planes, intra_q, Luts.default(cuda), qscales)
    want = twin(*planes, intra_q, Luts.default(cuda), qscales)
    flat = (lambda t: [t] if isinstance(t, torch.Tensor) else [x for u in t for x in flat(u)])
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("entry", ["encode", "encode_from_planes"])
def test_card_encode_equals_cpu(cuda, entry):
    rgb = _fixture_rgb(14, 3, 1080, 1920)
    args = (rgb,) if entry == "encode" else fixture_tiles.planes_420(rgb)
    _build.launches.clear()
    got = getattr(_encoder(50_000_000, device="cuda"), entry)(*args)
    assert _build.launches["bit_count"] == 1 and _build.launches["vlc_fused4"] == 1
    card_scales = dict(mpeg1.rate_qscales)
    mpeg1.rate_qscales.clear()
    assert got == getattr(_encoder(50_000_000), entry)(*args)
    assert card_scales == dict(mpeg1.rate_qscales)
    assert [len(p) for p in _pictures(got)] == [250_000] * 3


# ---- the CLI and the API ------------------------------------------------------

def _jpeg_folder(tmp_path):
    import shutil

    folder = tmp_path / "frames"
    folder.mkdir()
    for i, f in enumerate(sorted((Path(__file__).resolve().parent / "data" / "torch_jpegs")
                                 .glob("frame_*.jpg"))):
        shutil.copy(f, folder / f"image{i}.jpg")
    return folder


def test_cli_bit_rate(tmp_path):
    """`--bit-rate` codes every picture to exactly the budget, as the
    encoder does on the folder's frames; compat, quality 70 and a mesh
    refuse it."""
    from ec504_imageencoder_tpu_torch import cli
    from ec504_imageencoder_tpu_torch.io.jpeg import load_folder

    folder, out = _jpeg_folder(tmp_path), tmp_path / "o.mpeg"
    assert cli.main([str(folder), "-o", str(out), "--device", "cpu", "--bit-rate", "4000000",
                     "--batch", "2"]) == 0
    frames, _ = load_folder(str(folder), require_exact=False)
    enc = _encoder(4_000_000)
    want = b"".join(enc.encode(frames[i:i + 2], first_frame_index=i)
                    for i in range(0, len(frames), 2)) + headers.sequence_end()
    data = out.read_bytes()
    assert data == want and [len(p) for p in _pictures(data)] == [20_000] * len(frames)
    for flags in (["--mode", "compat"], ["-q", "70"], ["--bit-rate", "1000"], ["--mesh", "1,1"]):
        argv = [str(folder), "-o", str(tmp_path / "x.mpeg"), "--device", "cpu", "--bit-rate",
                "400000", *flags]
        with pytest.raises(SystemExit, match="mpeg-encode-torch: "):
            cli.main(argv)
    assert not (tmp_path / "x.mpeg").exists()


def test_encode_video_bit_rate(tmp_path):
    from ec504_imageencoder_tpu_torch import encode_video

    rgb = _fixture_rgb(15, 3, 48, 80)
    n = encode_video(rgb, str(tmp_path / "v.mpeg"), 50, 25.0, 15, device="cpu", bit_rate=100_000)
    data = (tmp_path / "v.mpeg").read_bytes()
    assert n == len(data) and data == _encoder(100_000).encode(rgb) + headers.sequence_end()
    assert [len(p) for p in _pictures(data)] == [500] * 3
