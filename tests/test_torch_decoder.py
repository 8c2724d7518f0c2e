"""The port's decoder (`models/decoder.py`) and `mpeg-decode-torch`
(`decode_cli.py`) against the JAX package's, on the CPU.

* `decode_es` (the scalar spec oracle), `decode_es_fast` and
  `decode_stream` (both containers, fast and scalar) decode the port's own
  streams — q=12, 45 and 85 (the f32 DCT), odd sizes, `fuse=8`, full
  range, an ES and a program stream — to the reference's pixels.
* Every malformed input of tests/test_decoder_errors.py and of
  test_decoder_fast.py::test_fast_error_surface, and the compat golden
  stream (not ISO-decodable: the C encoder's bugs), raise the same
  exception class name with the same message from both decoders, and
  it is a ValueError.
* `psnr` is the reference's; the decode CLI prints the same stdout and
  stderr, returns the same code and writes the same files, PIL present
  or not.

Tolerance: exact (0) everywhere: pixels, messages, bytes, floats.
"""

import contextlib
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from ec504_imageencoder_tpu import decode_cli as ref_cli
from ec504_imageencoder_tpu.models import decoder as ref
from ec504_imageencoder_tpu_torch import decode_cli
from ec504_imageencoder_tpu_torch.models import decoder
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.syntax import headers, mux

ROOT = Path(__file__).resolve().parent.parent


def _es(frames, **kw):
    return TorchMPEG1IntraEncoder(device="cpu", **kw).encode(frames) + headers.sequence_end()


def _ps(es):
    pics = mux.split_es_pictures(es[: -len(headers.sequence_end())])
    return mux.mux_program_stream(pics, fps=25.0)


@pytest.fixture(scope="module")
def streams(fixture_frames):
    """name -> (stream bytes, color range): the port's streams."""
    crop = np.stack([fixture_frames["0"], fixture_frames["2"]])[:, :64, :96]
    odd = np.stack([fixture_frames["1"][5:80, 3:104], fixture_frames["2"][:75, :101]])
    es45 = _es(crop, quality=45)
    return {
        "q12": (_es(crop, quality=12), "studio"),
        "q45": (es45, "studio"),
        "q85 f32": (_es(crop, quality=85), "studio"),
        "odd 75x101 q50": (_es(odd, quality=50), "studio"),
        "q50 fuse=8": (_es(crop, quality=50, fuse=8), "studio"),
        "q45 full range": (_es(crop, quality=45, color_range="full"), "full"),
        "q45 program stream": (_ps(es45), "studio"),
    }


def _same_frames(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        assert np.array_equal(g, w)


DECODERS = {
    "decode_es": lambda m, data, cr: m.decode_es(data, color_range=cr),
    "decode_es_fast": lambda m, data, cr: m.decode_es_fast(data, color_range=cr),
    "decode_stream": lambda m, data, cr: m.decode_stream(data, color_range=cr),
    "decode_stream scalar": lambda m, data, cr: m.decode_stream(data, color_range=cr, fast=False),
}
STREAMS = ["q12", "q45", "q85 f32", "odd 75x101 q50", "q50 fuse=8", "q45 full range",
           "q45 program stream"]


@pytest.mark.parametrize("fn", list(DECODERS))
@pytest.mark.parametrize("name", STREAMS)
def test_decoder_equals_reference(streams, name, fn):
    data, cr = streams[name]
    if "program" in name and not fn.startswith("decode_stream"):
        data = mux.demux_program_stream(data)
    _same_frames(DECODERS[fn](decoder, data, cr), DECODERS[fn](ref, data, cr))


def test_decoded_shapes_and_quality(streams, fixture_frames):
    """The decode of the q=45 stream has the source's frame count and
    shape and a PSNR well above noise."""
    dec = decoder.decode_stream(streams["q45"][0])
    src = np.stack([fixture_frames["0"], fixture_frames["2"]])[:, :64, :96]
    assert [d.shape for d in dec] == [(64, 96, 3)] * 2
    assert min(decoder.psnr(s, d) for s, d in zip(src, dec)) > 30


# ---- the error surface ------------------------------------------------------


@pytest.fixture(scope="module")
def small_es():
    """tests/test_decoder_errors.py's stream, made by the port."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (1, 64, 80, 3), dtype=np.uint8)
    return _es(frames, quality=40)


@pytest.fixture(scope="module")
def crop_es(fixture_frames):
    """test_decoder_fast.py::test_fast_error_surface's stream."""
    crop = np.stack([fixture_frames["0"]])[:, :96, :128]
    return _es(crop, quality=40)


def _xor_corrupt(es):
    rng = np.random.default_rng(3)
    data = bytearray(es)
    start = es.index(b"\x00\x00\x01\x01") + 5
    for i in range(start, min(start + 40, len(data))):
        data[i] ^= rng.integers(1, 256)
    return bytes(data)


def _ff_corrupt(es):
    bad = bytearray(es)
    bad[len(bad) // 2 : len(bad) // 2 + 16] = b"\xff" * 16
    return bytes(bad)


def _no_sequence(es):
    return es[es.index(b"\x00\x00\x01\x00"):]


def _no_picture(es):
    pic_at, sl_at = es.index(b"\x00\x00\x01\x00"), es.index(b"\x00\x00\x01\x01")
    return es[:pic_at] + es[sl_at:]


BAD_PICTURE_TYPE = (headers.SEQUENCE_START + b"\x19\x00\xb0\x13\xff\xff\xe0\x18"
                    b"\x00\x00\x00\x00\x00\x00\x01\x00" + b"\x00\x00\x40\x00")

# name -> (fixture, malformed stream from it, the class the reference's tests expect)
ERROR_CASES = {
    "truncated at 0.5": ("small_es", lambda es: es[: int(len(es) * 0.5)], "StreamError"),
    "truncated at 0.9": ("small_es", lambda es: es[: int(len(es) * 0.9)], "StreamError"),
    "hard truncation": ("small_es", lambda es: es[:6], "TruncatedStreamError"),
    "corrupt slice bytes": ("small_es", _xor_corrupt, None),
    "picture before sequence header": ("small_es", _no_sequence, "CorruptStreamError"),
    "slice before picture header": ("small_es", _no_picture, "CorruptStreamError"),
    "truncated mid-slice": ("crop_es", lambda es: es[: len(es) // 2], "StreamError"),
    "corrupt slice payload": ("crop_es", _ff_corrupt, "StreamError"),
    "bad picture type": ("crop_es", lambda es: BAD_PICTURE_TYPE, "CorruptStreamError"),
}


def _outcome(fn, data):
    """(exception class name, message) or the decoded frames."""
    try:
        return fn(data)
    except Exception as e:  # compared with the reference's, whatever it is
        assert isinstance(e, ValueError), f"{type(e).__name__}: {e}"
        return type(e).__name__, str(e), [k.__name__ for k in type(e).__mro__[:3]]


@pytest.mark.parametrize("fn", ["decode_es", "decode_es_fast"])
@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_surface_equals_reference(request, case, fn):
    fixture, make, expect = ERROR_CASES[case]
    data = make(request.getfixturevalue(fixture))
    got, want = _outcome(getattr(decoder, fn), data), _outcome(getattr(ref, fn), data)
    if isinstance(want, tuple):
        assert got == want
        assert expect is None or expect in want[2]
    else:
        _same_frames(got, want)


def test_compat_golden_stream_raises_as_reference(golden_mpeg):
    """The compat golden stream is the C encoder's, bugs included, and no
    ISO decoder reads it through: both decoders stop at the same bit."""
    for fast in (True, False):
        got = _outcome(lambda d: decoder.decode_stream(d, "full", fast), golden_mpeg)
        want = _outcome(lambda d: ref.decode_stream(d, "full", fast), golden_mpeg)
        assert got == want and got[0] == "CorruptStreamError"


def test_exception_classes():
    for name, base in (("StreamError", ValueError), ("TruncatedStreamError", "StreamError"),
                       ("CorruptStreamError", "StreamError")):
        cls = getattr(decoder, name)
        assert cls.__name__ == getattr(ref, name).__name__
        assert issubclass(cls, getattr(decoder, base) if isinstance(base, str) else base)
        assert cls.__module__ == "ec504_imageencoder_tpu_torch.models.decoder"


def test_sequence_info_and_readers_equal_reference(streams):
    data = streams["q45"][0]
    for mod in (decoder, ref):
        assert mod.SequenceInfo(16, 16, 1, 3).intra_matrix.shape == (8, 8)
    r, rr = decoder.BitReader(data), ref.BitReader(data)
    f, fr = decoder._FastReader(data), ref._FastReader(data)
    for n in (8, 8, 8, 8, 12, 12, 4, 4, 18, 1):
        v = r.read(n)
        assert v == rr.read(n) == f.read(n) == fr.read(n)
    for a, b in zip(decoder._build_fast_luts(), ref._build_fast_luts()):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("pair", ["equal", "noise", "one pixel"])
def test_psnr_equals_reference(pair):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (31, 47, 3), dtype=np.uint8)
    b = {"equal": a.copy(), "noise": rng.integers(0, 256, a.shape, dtype=np.uint8),
         "one pixel": a ^ np.pad(np.ones((1, 1, 1), np.uint8), ((3, 27), (5, 41), (0, 2)))}[pair]
    got, want = decoder.psnr(a, b), ref.psnr(a, b)
    assert type(got) is type(want) and (got == want or (np.isinf(got) and np.isinf(want)))


# ---- mpeg-decode-torch ----------------------------------------------------


@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory, fixture_frames):
    """Three 96 x 112 crops of the fixture frames as JPEGs (4:2:0, quality 90)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("jpegs")
    for k in range(3):
        crop = np.ascontiguousarray(fixture_frames[str(k)][k * 9:k * 9 + 96, k * 4:k * 4 + 112])
        Image.fromarray(crop).save(d / f"frame_{k}.jpg", quality=90, subsampling=2)
    return d


@pytest.fixture(scope="module")
def clip_path(jpeg_folder, tmp_path_factory):
    """The folder's frames encoded by the port at q=60, and its last frame
    dropped (a frame-count mismatch for --psnr-ref)."""
    from ec504_imageencoder_tpu_torch.io.jpeg import load_folder

    frames, _ = load_folder(str(jpeg_folder))
    d = tmp_path_factory.mktemp("clip")
    (d / "clip.mpeg").write_bytes(_es(frames, quality=60))
    (d / "short.mpeg").write_bytes(_es(frames[:2], quality=60))
    (d / "clip_ps.mpeg").write_bytes(_ps(_es(frames, quality=60)))
    (d / "empty.mpeg").write_bytes(b"\x00\x00\x01\xb7")
    return d


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())} if d.exists() else {}


CLI_CASES = {
    "summary": ("clip.mpeg", []),
    "ppm frames": ("clip.mpeg", ["-o", "{out}", "--format", "ppm"]),
    "png frames": ("clip.mpeg", ["-o", "{out}"]),
    "psnr": ("clip.mpeg", ["--psnr-ref", "{ref}"]),
    "psnr, frame count mismatch": ("short.mpeg", ["--psnr-ref", "{ref}"]),
    "program stream, ppm and psnr": ("clip_ps.mpeg", ["-o", "{out}", "--format", "ppm",
                                                     "--psnr-ref", "{ref}"]),
    "full range": ("clip.mpeg", ["--color-range", "full", "-o", "{out}", "--format", "ppm"]),
    "empty stream": ("empty.mpeg", []),
}


def _cli_outputs(main, case, clip_path, jpeg_folder, out_dir):
    stream, flags = CLI_CASES[case]
    argv = [str(clip_path / stream)] + [f.format(out=out_dir, ref=jpeg_folder) for f in flags]
    rc, out, err = _run(main, argv)
    return rc, out.replace(str(out_dir), "OUT"), err, _files(out_dir)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_decode_cli_equals_reference(case, clip_path, jpeg_folder, tmp_path):
    got = _cli_outputs(decode_cli.main, case, clip_path, jpeg_folder, tmp_path / "port")
    want = _cli_outputs(ref_cli.main, case, clip_path, jpeg_folder, tmp_path / "ref")
    assert got == want
    assert got[0] == (1 if case == "empty stream" else 0)


def test_decode_cli_without_pil_writes_ppm(clip_path, jpeg_folder, tmp_path, monkeypatch):
    """Where PIL is missing, both write PPM files and say so on stderr."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = _cli_outputs(decode_cli.main, "png frames", clip_path, jpeg_folder, tmp_path / "port")
    want = _cli_outputs(ref_cli.main, "png frames", clip_path, jpeg_folder, tmp_path / "ref")
    assert got[:2] == want[:2] and got[3] == want[3]
    assert got[2] == want[2].replace(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert sorted(got[3]) == [f"frame_{i:04d}.ppm" for i in range(3)]
    assert "PIL unavailable" in got[2]


def test_decode_cli_module_runs(clip_path, tmp_path):
    """`python -m ec504_imageencoder_tpu_torch.decode_cli` (the console
    script's entry) decodes and exits 0."""
    import subprocess

    proc = subprocess.run([sys.executable, "-m", "ec504_imageencoder_tpu_torch.decode_cli",
                           str(clip_path / "clip.mpeg")], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "decoded 3 frames, 112x96\n"
