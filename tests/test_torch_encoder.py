"""The port's encoder as a whole against the JAX encoder, on the CPU.

`TorchMPEG1IntraEncoder.from_reference(MPEG1IntraEncoder(backend="jax"),
"cpu")` runs the kernels' plain twins.  With the integer AAN DCT its byte
stream must equal the JAX encoder's for the same frames (exact).  With the
f32 DCT (what "auto" picks at quality >= 70) the reference promises equal
bytes only within one backend: across backends an f32 rounding tie may
fall the other way.  The port repeats the numpy backend's f32 operations,
so its bytes equal the numpy encoder's; against the JAX (XLA) encoder the
gate is decoded PSNR within 0.05 dB, and the port's own batch splits give
equal bytes.
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models.decoder import decode_es, decode_es_fast, psnr
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu.syntax import headers
from ec504_imageencoder_tpu_torch.device import resolve_device
from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder


def _pair(**kw):
    ref = MPEG1IntraEncoder(backend="jax", **kw)
    return ref, TorchMPEG1IntraEncoder.from_reference(MPEG1IntraEncoder(backend="jax", **kw), "cpu")


@pytest.fixture(scope="module")
def odd_frames(fixture_frames):
    """Two natural frames of an odd size (75 x 101: padded to 80 x 112)."""
    return np.stack([fixture_frames["0"][100:175, 50:151], fixture_frames["2"][:75, 200:301]])


def _planes(frames):
    """JPEG-style 4:2:0 planes of odd size: chroma is ceil(H/2) x ceil(W/2)."""
    return (np.ascontiguousarray(frames[..., 0]),
            np.ascontiguousarray(frames[:, ::2, ::2, 1]),
            np.ascontiguousarray(frames[:, ::2, ::2, 2]))


@pytest.mark.parametrize("quality", [5, 12, 50, 69])
def test_encode_matches_jax(odd_frames, quality):
    ref, port = _pair(quality=quality)
    assert port.encode(odd_frames) == ref.encode(odd_frames)


@pytest.mark.parametrize("quality", [5, 12, 50, 69])
def test_encode_from_planes_matches_jax(odd_frames, quality):
    ref, port = _pair(quality=quality)
    planes = _planes(odd_frames)
    assert port.encode_from_planes(*planes) == ref.encode_from_planes(*planes)


def test_first_frame_index_across_gop(odd_frames):
    ref, port = _pair(quality=50, gop_size=2)
    got = port.encode(odd_frames, first_frame_index=1)
    assert got == ref.encode(odd_frames, first_frame_index=1)
    # frames 1 and 2: frame 2 opens a GOP (one sequence + GOP header)
    assert got.count(headers.SEQUENCE_START) == 1 and got.count(headers.GOP_START) == 1


def test_forced_regrow_matches_jax():
    frames = np.random.default_rng(5).integers(0, 256, (1, 16, 512, 3), dtype=np.uint8)
    ref, port = _pair(quality=50, max_slice_bytes=2560)
    got = port.encode(frames)
    assert got == ref.encode(frames)
    assert port.max_slice_bytes > 2560 and port.max_slice_bytes == ref.max_slice_bytes


def test_grow_slices_false_raises():
    frames = np.random.default_rng(5).integers(0, 256, (1, 16, 512, 3), dtype=np.uint8)
    _, port = _pair(quality=50, max_slice_bytes=2560, grow_slices=False)
    with pytest.raises(OverflowError):
        port.encode(frames)


def test_output_decodes(odd_frames):
    _, port = _pair(quality=50)
    dec = decode_es(port.encode(odd_frames) + headers.sequence_end())
    assert len(dec) == len(odd_frames)
    for f, d in zip(odd_frames, dec):
        assert d.shape == f.shape
        assert psnr(f, d) > 30.0


def test_encode_to_file(tmp_path, odd_frames):
    _, port = _pair(quality=50)
    path = tmp_path / "out.mpeg"
    n = port.encode_to_file(odd_frames, str(path))
    data = path.read_bytes()
    assert n == len(data) and data == port.encode(odd_frames) + headers.sequence_end()


def test_from_reference_copies_state():
    ref = MPEG1IntraEncoder(quality=37, frame_rate_code=5, gop_size=4, max_slice_bytes=3072,
                            backend="numpy", color_range="full", grow_slices=False)
    port = TorchMPEG1IntraEncoder.from_reference(ref, "cpu")
    for name in ("quality", "qscale", "dct_impl", "color_range", "frame_rate_code",
                 "gop_size", "max_slice_bytes", "grow_slices"):
        assert getattr(port, name) == getattr(ref, name), name
    assert np.array_equal(port.intra_q, ref.intra_q)
    assert torch.equal(port.core.qw, torch.from_numpy(ref.intra_q * ref.qscale).int())


def test_unported_paths_raise():
    assert TorchMPEG1IntraEncoder(quality=80, device="cpu").dct_impl == "f32"  # auto
    with pytest.raises(ValueError, match="dct_impl"):
        TorchMPEG1IntraEncoder(quality=80, dct_impl="int", device="cpu")
    port = TorchMPEG1IntraEncoder(quality=80, dct_impl="aan", device="cpu")
    # the coefficients intake is ported (tests/test_torch_jpeg.py); what
    # it still refuses is coefficients of the wrong shape
    with pytest.raises(ValueError, match="coefficients must be"):
        port.encode_from_coeffs(np.zeros((1, 3, 64), np.int16), np.zeros((1, 1, 64), np.int16),
                                np.zeros((1, 1, 64), np.int16), 16, 16)


def test_cuda_device_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test checks its absence")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchMPEG1IntraEncoder(quality=50, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchMPEG1IntraEncoder(quality=50)  # the default device is the card


def _psnrs(es, frames):
    dec = decode_es_fast(es + headers.sequence_end())
    assert len(dec) == len(frames)
    return [psnr(f, d) for f, d in zip(frames, dec)]


def _f32_frames():
    """The reference's q=79 counterexample (numpy and XLA bytes differ on
    it, tests/test_sharding.py) beside the odd-size natural frames."""
    return np.random.default_rng(20261016 + 5).integers(0, 256, (1, 87, 44, 3), dtype=np.uint8)


@pytest.mark.parametrize("quality", [70, 79, 85, 100])
def test_f32_dct_psnr_matches_jax(odd_frames, quality):
    ref, port = _pair(quality=quality)
    assert port.dct_impl == ref.dct_impl == "f32"
    for frames in (odd_frames, _f32_frames()):
        got, want = _psnrs(port.encode(frames), frames), _psnrs(ref.encode(frames), frames)
        assert max(abs(g - w) for g, w in zip(got, want)) < 0.05, (got, want)


def test_f32_dct_counterexample_psnr():
    """The reference's own q=79 counterexample: numpy and XLA give other
    bytes and the same PSNR; the port lands within 0.05 dB of both."""
    frames = np.random.default_rng(20260821).integers(0, 256, (1, 87, 44, 3), dtype=np.uint8)
    port = TorchMPEG1IntraEncoder(quality=79, device="cpu")
    got = _psnrs(port.encode(frames), frames)[0]
    for backend in ("numpy", "jax"):
        want = _psnrs(MPEG1IntraEncoder(quality=79, backend=backend).encode(frames), frames)[0]
        assert abs(got - want) < 0.05, (backend, got, want)


def test_f32_dct_planes_psnr_matches_jax(odd_frames):
    ref, port = _pair(quality=85)
    planes = _planes(odd_frames)
    got = _psnrs(port.encode_from_planes(*planes), odd_frames)
    want = _psnrs(ref.encode_from_planes(*planes), odd_frames)
    assert max(abs(g - w) for g, w in zip(got, want)) < 0.05


def test_aan_at_high_quality_is_byte_exact(odd_frames):
    ref, port = _pair(quality=85, dct_impl="aan")
    assert port.encode(odd_frames) == ref.encode(odd_frames)
    planes = _planes(odd_frames)
    assert port.encode_from_planes(*planes) == ref.encode_from_planes(*planes)


def test_f32_dct_bytes_equal_across_batch_splits(odd_frames):
    """The same bytes for the batch at once and frame by frame (with
    first_frame_index), as the reference promises within one backend."""
    frames = np.concatenate([odd_frames, odd_frames[:, ::-1]])
    whole = TorchMPEG1IntraEncoder(quality=85, device="cpu").encode(frames)
    enc = TorchMPEG1IntraEncoder(quality=85, device="cpu")
    split = b"".join(enc.encode(frames[i:i + 1], first_frame_index=i) for i in range(len(frames)))
    assert whole == split


@pytest.mark.parametrize("quality", [70, 100])
def test_f32_dct_bytes_equal_numpy_reference(odd_frames, quality):
    """The port's f32 DCT repeats the reference's numpy einsum operation
    for operation, so its bytes equal the host numpy encoder's (the
    reference's own XLA backend may differ from both at f32 ties)."""
    for frames in (odd_frames, _f32_frames()):
        want = MPEG1IntraEncoder(quality=quality, backend="numpy").encode(frames)
        assert TorchMPEG1IntraEncoder(quality=quality, device="cpu").encode(frames) == want


@pytest.mark.parametrize("quality", [50, 85], ids=["q50-aan", "q85-f32"])
def test_debug_checks_bytes_equal(odd_frames, quality):
    """The sanitizer's raw-slot routes (B6a at q=50, the B5 lookups at
    q=85, then the checked pack) give the bytes of the production path and
    of the numpy reference, for both intakes."""
    planes = _planes(odd_frames)
    dbg = TorchMPEG1IntraEncoder(quality=quality, debug_checks=True, device="cpu")
    prod = TorchMPEG1IntraEncoder(quality=quality, device="cpu")
    ref = MPEG1IntraEncoder(quality=quality, backend="numpy")
    assert dbg.debug_checks and dbg.dct_impl == ("aan" if quality < 70 else "f32")
    want = ref.encode(odd_frames)
    assert dbg.encode(odd_frames) == prod.encode(odd_frames) == want
    want = ref.encode_from_planes(*planes)
    assert dbg.encode_from_planes(*planes) == prod.encode_from_planes(*planes) == want


# ---- fuse=8: the 8:1-fusion route (B6b, B6c) -------------------------------

@pytest.mark.parametrize("quality", [5, 50, 69])
def test_fuse8_matches_numpy(odd_frames, quality):
    """fuse=8 (the reference's EC504_FUSE=8 route) on the CPU: the numpy
    reference's bytes for both intakes, odd sizes included."""
    ref = MPEG1IntraEncoder(quality=quality, backend="numpy")
    port = TorchMPEG1IntraEncoder(quality=quality, fuse=8, device="cpu")
    assert port.fuse == 8 and port.core.fuse == 8 and port.dct_impl == "aan"
    assert port.encode(odd_frames) == ref.encode(odd_frames)
    planes = _planes(odd_frames)
    assert port.encode_from_planes(*planes) == ref.encode_from_planes(*planes)


def test_fuse8_forced_regrow_matches_numpy():
    frames = np.random.default_rng(5).integers(0, 256, (1, 16, 512, 3), dtype=np.uint8)
    ref = MPEG1IntraEncoder(quality=50, max_slice_bytes=2560, backend="numpy")
    port = TorchMPEG1IntraEncoder(quality=50, max_slice_bytes=2560, fuse=8, device="cpu")
    assert port.encode(frames) == ref.encode(frames)
    assert port.max_slice_bytes > 2560 and port.max_slice_bytes == ref.max_slice_bytes


@pytest.mark.parametrize("quality,fuse", [(50, 4), (50, 8), (85, 4)],
                         ids=["q50-fuse4", "q50-fuse8", "q85-f32"])
def test_full_width_1080p(quality, fuse):
    """One 1080 x 1920 frame (full-width slices of 720 blocks) on each
    route: the default AAN route (fuse 4), the 8:1-fusion route and the
    f32 DCT, whose bytes depend on numpy's order for breaking f32 ties."""
    rng = np.random.default_rng(1080)
    yy, xx = np.mgrid[:1080, :1920]
    frame = ((yy[..., None] * (1, 2, 3) + xx[..., None] * (3, 1, 2)) % 256).astype(np.uint8)
    frame[::7] = rng.integers(0, 256, frame[::7].shape, dtype=np.uint8)
    frames = frame[None]
    want = MPEG1IntraEncoder(quality=quality, backend="numpy").encode(frames)
    port = TorchMPEG1IntraEncoder(quality=quality, fuse=fuse, device="cpu")
    assert port.dct_impl == ("f32" if quality >= 70 else "aan")
    assert port.encode(frames) == want


@pytest.mark.parametrize("kw", [{"debug_checks": True}, {"dct_impl": "f32"}],
                         ids=["debug_checks", "f32"])
def test_fuse8_leaves_other_routes_alone(odd_frames, kw):
    """Under debug_checks the sanitizer's routes run, and the f32 DCT always
    fuses 4:1: fuse=8 gives fuse=4's bytes there."""
    want = TorchMPEG1IntraEncoder(quality=50, device="cpu", **kw).encode(odd_frames)
    assert TorchMPEG1IntraEncoder(quality=50, fuse=8, device="cpu", **kw).encode(odd_frames) == want


def test_fuse_must_be_4_or_8():
    for fuse in (3, 16, "8"):
        with pytest.raises(ValueError, match="fuse"):
            TorchMPEG1IntraEncoder(quality=50, fuse=fuse, device="cpu")
    port = TorchMPEG1IntraEncoder.from_reference(MPEG1IntraEncoder(backend="numpy"), "cpu", fuse=8)
    assert port.fuse == 8


# ---- pack=: the generic route with the raw-code pack kernels (K1-K4) -------

RAW_PACKS = ["pallas1", "pallas3", "fused", "fused2w"]


@pytest.mark.parametrize("quality", [12, 50, 85])
@pytest.mark.parametrize("pack", RAW_PACKS)
def test_pack_routes_match_numpy(odd_frames, pack, quality):
    """pack= (the reference's EC504_VLC=xla with EC504_PACK) on the CPU:
    levels with either DCT, raw slots through the B5 lookups, then the
    raw-code pack; the numpy reference's bytes for both intakes."""
    ref = MPEG1IntraEncoder(quality=quality, backend="numpy")
    port = TorchMPEG1IntraEncoder(quality=quality, pack=pack, device="cpu")
    assert port.pack == port.core.pack == pack
    assert port.encode(odd_frames) == ref.encode(odd_frames)
    planes = _planes(odd_frames)
    assert port.encode_from_planes(*planes) == ref.encode_from_planes(*planes)


@pytest.mark.parametrize("pack", RAW_PACKS)
def test_pack_routes_forced_regrow(pack):
    """An overflowing 2560 B slice keeps its true bit count through every
    raw-code pack, so one regrow lands; fuse=8 changes nothing here."""
    frames = np.random.default_rng(5).integers(0, 256, (1, 16, 512, 3), dtype=np.uint8)
    ref = MPEG1IntraEncoder(quality=50, max_slice_bytes=2560, backend="numpy")
    port = TorchMPEG1IntraEncoder(quality=50, max_slice_bytes=2560, pack=pack, fuse=8,
                                  device="cpu")
    assert port.encode(frames) == ref.encode(frames)
    assert port.max_slice_bytes > 2560 and port.max_slice_bytes == ref.max_slice_bytes


@pytest.mark.parametrize("pack", RAW_PACKS)
def test_pack_routes_debug_checks(odd_frames, pack, monkeypatch):
    """debug_checks on the generic route: the same bytes; a slot length of
    31 (over 30) raises RuntimeError, as the reference's generic guard
    negates the slice's bit count."""
    for quality in (50, 85):
        dbg = TorchMPEG1IntraEncoder(quality=quality, pack=pack, debug_checks=True, device="cpu")
        plain = TorchMPEG1IntraEncoder(quality=quality, device="cpu")
        assert dbg.encode(odd_frames) == plain.encode(odd_frames)

    real = mpeg1.block_streams_lut

    def corrupt(*args):
        codes, lens = real(*args)
        lens[0, 3, 5] = 31
        return codes, lens

    monkeypatch.setattr(mpeg1, "block_streams_lut", corrupt)
    with pytest.raises(RuntimeError, match="invariant violations"):
        TorchMPEG1IntraEncoder(quality=50, pack=pack, debug_checks=True,
                               device="cpu").encode(odd_frames)


def test_pack_must_be_known():
    """No "mxu" (XLA, not a Pallas kernel) and no "pallas2" (no route in
    the reference); from_reference passes pack on."""
    for pack in ("mxu", "pallas2", "FUSED", None):
        with pytest.raises(ValueError, match="pack"):
            TorchMPEG1IntraEncoder(quality=50, pack=pack, device="cpu")
    port = TorchMPEG1IntraEncoder.from_reference(MPEG1IntraEncoder(backend="numpy"), "cpu",
                                                 pack="pallas3")
    assert port.pack == "pallas3" and TorchMPEG1IntraEncoder(device="cpu").pack == "fused4"
