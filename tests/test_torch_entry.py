"""The port's entry points against the JAX package's, on the CPU.

* `mpeg_encode_procedure(device="cpu")` against the reference's
  `backend="numpy"` on a folder of 400 x 600 JPEGs: the stream and every
  `.bit` dump; 1 on an empty or missing folder, with the same message.
* `encode_video` and `encode_jpeg_folder` against the reference's (the
  numpy backend chunk by chunk for every intake, and the reference's own
  `encode_jpeg_folder`, JAX on the CPU, for ycbcr); the port's ycbcr and
  coeffs intakes give the same bytes.  C-r1 and C-r2 (ROADMAP) are
  reproduced as the reference has them.
* The CLI, `main([..., "--device", "cpu"])`, against the JAX CLI with
  `--backend numpy` for every flag combination of the entry surface; its
  correct-mode output decodes with the JAX package's decoder.  The port's
  own flags (`--fuse 8`, `--pack`, `--debug-checks`) give the bytes of the
  reference's default route.
* `--workdir`: a run resumed after its manifest is cut back gives the same
  bytes, and the single-process cases of tests/test_runtime.py on the
  port's `runtime/checkpoint.py`.
* `syntax/mux.py` and `utils/metrics.py::EncodeMetrics` against the
  reference's; `utils/profiling.py`'s spans land in a trace; `--profile`
  writes a trace.
* Without `--device`, the CLI and the API run on "cuda": where CUDA is
  absent they exit non-zero or raise, and write nothing.

Tolerance: exact (equal bytes) everywhere.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu import api as ref_api
from ec504_imageencoder_tpu import cli as ref_cli
from ec504_imageencoder_tpu.io.stream import FolderFrameSource as RefSource
from ec504_imageencoder_tpu.models.decoder import decode_stream, psnr
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu.runtime import checkpoint as ref_checkpoint
from ec504_imageencoder_tpu.syntax import headers as ref_headers
from ec504_imageencoder_tpu.syntax import mux as ref_mux
from ec504_imageencoder_tpu.utils import metrics as ref_metrics
from ec504_imageencoder_tpu_torch import api, cli, encode_video, mpeg_encode_procedure
from ec504_imageencoder_tpu_torch.io import jpeg as port_jpeg
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.runtime import checkpoint
from ec504_imageencoder_tpu_torch.syntax import headers, mux
from ec504_imageencoder_tpu_torch.utils import metrics, profiling

ROOT = Path(__file__).resolve().parent.parent
JPEGS = ROOT / "tests" / "data" / "torch_jpegs"


def _save(path, arr, **kw):
    from PIL import Image

    Image.fromarray(arr).save(path, **kw)


@pytest.fixture(scope="module")
def compat_folder(tmp_path_factory):
    """Four 400 x 600 JPEGs (the committed fixtures, 4:2:0, quality 90)."""
    d = tmp_path_factory.mktemp("compat")
    for i, k in enumerate((0, 1, 2, 0)):
        shutil.copy(JPEGS / f"frame_{k}.jpg", d / f"img_{i}.jpg")
    return d


@pytest.fixture(scope="module")
def small_folder(tmp_path_factory, fixture_frames):
    """Five 96 x 112 crops of the fixture frames, 4:2:0, quality 90."""
    d = tmp_path_factory.mktemp("small")
    for i in range(5):
        crop = fixture_frames[str(i % 3)][i * 7:i * 7 + 96, i * 5:i * 5 + 112]
        _save(d / f"f{i}.jpg", np.ascontiguousarray(crop), quality=90, subsampling=2)
    return d


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())} if d.exists() else {}


# ---- api ------------------------------------------------------------------

def test_mpeg_encode_procedure_equals_reference(compat_folder, tmp_path):
    got = mpeg_encode_procedure(str(compat_folder), str(tmp_path / "pb"),
                                str(tmp_path / "p" / "out.mpeg"), 12, device="cpu")
    want = ref_api.mpeg_encode_procedure(str(compat_folder), str(tmp_path / "rb"),
                                         str(tmp_path / "r" / "out.mpeg"), 12, backend="numpy")
    assert got == want == 0
    assert (tmp_path / "p" / "out.mpeg").read_bytes() == (tmp_path / "r" / "out.mpeg").read_bytes()
    bits = _files(tmp_path / "pb")
    assert bits == _files(tmp_path / "rb") and len(bits) == 4


@pytest.mark.parametrize("case", ["empty", "missing"])
def test_mpeg_encode_procedure_returns_1_without_images(tmp_path, capsys, case):
    folder = tmp_path / "imgs"
    if case == "empty":
        folder.mkdir()
    outs = []
    for fn, kw in ((mpeg_encode_procedure, {"device": "cpu"}),
                   (ref_api.mpeg_encode_procedure, {"backend": "numpy"})):
        assert fn(str(folder), str(tmp_path / "b"), str(tmp_path / "o.mpeg"), **kw) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith("Error: ")
    assert not (tmp_path / "o.mpeg").exists() and not (tmp_path / "b").exists()


@pytest.mark.parametrize("fps", [25.0, 29.97, 50.0, 24.5])
def test_encode_video_equals_reference(fixture_frames, tmp_path, fps):
    """fps 24.5 has no frame-rate code: both map it to code 3 (C-r2)."""
    frames = np.stack([fixture_frames[k][:96, :112] for k in ("0", "1", "2")])
    got = encode_video(frames, str(tmp_path / "p.mpeg"), 45, fps, 2, device="cpu")
    want = ref_api.encode_video(frames, str(tmp_path / "r.mpeg"), 45, fps, 2, backend="numpy")
    data = (tmp_path / "p.mpeg").read_bytes()
    assert got == want == len(data) and data == (tmp_path / "r.mpeg").read_bytes()
    if fps == 24.5:
        assert data[7] & 0x0F == 3  # frame_rate_code of the sequence header


def _reference_folder_encode(folder, intake, batch_size=2, quality=50):
    """The reference's encode_jpeg_folder on its numpy backend, chunk by
    chunk (its own function runs the JAX backend)."""
    src = RefSource(str(folder))
    enc = MPEG1IntraEncoder(quality=quality, backend="numpy")
    if intake == "coeffs":
        g = src.geometry
        chunks = [enc.encode_from_coeffs(*c, g["height"], g["width"], first_frame_index=s)
                  for s, c in src.coeff_batches(batch_size)]
    elif intake in ("ycbcr", "auto"):
        chunks = [enc.encode_from_planes(*p, first_frame_index=s)
                  for s, p in src.plane_batches(batch_size)]
    else:
        chunks = [enc.encode(b, first_frame_index=s) for s, b in src.batches(batch_size)]
    return b"".join(chunks) + ref_headers.sequence_end()


@pytest.mark.parametrize("intake", ["rgb", "ycbcr", "coeffs", "auto"])
def test_encode_jpeg_folder_equals_reference(small_folder, tmp_path, intake):
    out = tmp_path / "sub" / "p.mpeg"
    n = api.encode_jpeg_folder(str(small_folder), str(out), batch_size=2, intake=intake,
                               device="cpu")
    data = out.read_bytes()
    assert n == len(data)
    assert data == _reference_folder_encode(small_folder, intake)


def test_encode_jpeg_folder_equals_the_jax_function(small_folder, tmp_path):
    """One batch: the JAX function compiles once per batch shape."""
    api.encode_jpeg_folder(str(small_folder), str(tmp_path / "p.mpeg"), batch_size=8,
                           intake="ycbcr", device="cpu")
    ref_api.encode_jpeg_folder(str(small_folder), str(tmp_path / "r.mpeg"), batch_size=8,
                               intake="ycbcr")
    assert (tmp_path / "p.mpeg").read_bytes() == (tmp_path / "r.mpeg").read_bytes()


def test_ycbcr_and_coeffs_intakes_give_equal_bytes(small_folder, tmp_path):
    outs = []
    for intake in ("ycbcr", "coeffs"):
        api.encode_jpeg_folder(str(small_folder), str(tmp_path / f"{intake}.mpeg"),
                               batch_size=3, intake=intake, device="cpu")
        outs.append((tmp_path / f"{intake}.mpeg").read_bytes())
    assert outs[0] == outs[1]


def test_auto_intake_stores_full_range_planes_c_r1(small_folder, tmp_path):
    """C-r1 as the reference has it: "auto" takes the JPEG's full-range
    planes, decoded as studio range by a standard player, while the rgb
    intake stores studio range."""
    outs = {}
    for intake in ("auto", "ycbcr", "rgb"):
        api.encode_jpeg_folder(str(small_folder), str(tmp_path / f"{intake}.mpeg"),
                               intake=intake, device="cpu")
        outs[intake] = (tmp_path / f"{intake}.mpeg").read_bytes()
    assert outs["auto"] == outs["ycbcr"] != outs["rgb"]
    frames, _ = port_jpeg.load_folder(str(small_folder))
    db = {k: np.mean([psnr(f, d) for f, d in zip(frames, decode_stream(v))])
          for k, v in outs.items()}
    assert db["rgb"] > db["auto"] + 3


def test_encode_jpeg_folder_rejects_what_the_reference_rejects(tmp_path):
    for i in range(2):
        _save(tmp_path / f"f{i}.jpg", np.full((48, 64, 3), 90 + i, np.uint8), quality=90,
              subsampling=0)
    for fn, kw in ((api.encode_jpeg_folder, {"device": "cpu"}), (ref_api.encode_jpeg_folder, {})):
        with pytest.raises(ValueError, match="unknown intake 'yuv'"):
            fn(str(tmp_path), str(tmp_path / "o.mpeg"), intake="yuv", **kw)
        with pytest.raises(ValueError, match="intake 'ycbcr' needs 3-component"):
            fn(str(tmp_path), str(tmp_path / "o.mpeg"), intake="ycbcr", **kw)


# ---- the CLI ----------------------------------------------------------------

# (folder, the port's flags, the reference's flags)
CLI_CASES = {
    "compat-bitstream-dir": ("compat", ["--mode", "compat", "--bitstream-dir", "{bits}"],
                             ["--mode", "compat", "--bitstream-dir", "{bits}"]),
    "compat-q50": ("compat", ["--mode", "compat", "-q", "50"], ["--mode", "compat", "-q", "50"]),
    "compat-debug-checks": ("compat", ["--mode", "compat", "--debug-checks"], ["--mode", "compat"]),
    "correct": ("small", [], []),
    "correct-batch-gop-rate": ("small", ["--batch", "2", "--gop", "2", "--frame-rate-code", "5"],
                               ["--batch", "2", "--gop", "2", "--frame-rate-code", "5"]),
    "stream": ("small", ["--stream", "--batch", "2"], ["--stream", "--batch", "2"]),
    "stream-rgb": ("small", ["--stream", "--intake", "rgb"], ["--stream", "--intake", "rgb"]),
    "stream-ycbcr": ("small", ["--stream", "--intake", "ycbcr", "--batch", "3"],
                     ["--stream", "--intake", "ycbcr", "--batch", "3"]),
    "stream-coeffs": ("small", ["--stream", "--intake", "coeffs", "--batch", "3"],
                      ["--stream", "--intake", "coeffs", "--batch", "3"]),
    "q85": ("small", ["-q", "85"], ["-q", "85"]),
    "q85-stream-ycbcr": ("small", ["-q", "85", "--stream", "--intake", "ycbcr"],
                         ["-q", "85", "--stream", "--intake", "ycbcr"]),
    "dct-f32-full-range": ("small", ["--dct", "f32", "--color-range", "full", "-q", "40"],
                           ["--dct", "f32", "--color-range", "full", "-q", "40"]),
    "container-ps": ("small", ["--container", "ps"], ["--container", "ps"]),
    "bitstream-dir": ("small", ["--bitstream-dir", "{bits}", "--batch", "2"],
                      ["--bitstream-dir", "{bits}", "--batch", "2"]),
    "stream-bitstream-dir": ("small", ["--stream", "--bitstream-dir", "{bits}"],
                             ["--stream", "--bitstream-dir", "{bits}"]),
    "fuse8": ("small", ["--fuse", "8"], []),
    "pack-fused": ("small", ["--pack", "fused"], []),
    "pack-fused2w-q85": ("small", ["--pack", "fused2w", "-q", "85"], ["-q", "85"]),
    "debug-checks": ("small", ["--debug-checks"], []),
    "debug-checks-q85-stream": ("small", ["--debug-checks", "-q", "85", "--stream"],
                                ["-q", "85", "--stream"]),
}


def _run_cli(main, folder, flags, out_dir, extra):
    out_dir.mkdir()
    bits = out_dir / "bits"
    argv = [str(folder), "-o", str(out_dir / "out.mpeg"),
            *(f.format(bits=bits) for f in flags), *extra]
    assert main(argv) == 0
    return (out_dir / "out.mpeg").read_bytes(), _files(bits)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_equals_reference_cli(case, compat_folder, small_folder, tmp_path, capsys):
    folder_kind, port_flags, ref_flags = CLI_CASES[case]
    folder = compat_folder if folder_kind == "compat" else small_folder
    got, got_bits = _run_cli(cli.main, folder, port_flags, tmp_path / "port", ["--device", "cpu"])
    want, want_bits = _run_cli(ref_cli.main, folder, ref_flags, tmp_path / "ref",
                               ["--backend", "numpy"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].split(":", 1)[1] == printed[-1].split(":", 1)[1]  # "wrote ..."
    assert got == want
    assert got_bits == want_bits
    if "{bits}" in port_flags:
        assert len(got_bits) == (4 if folder_kind == "compat" else 5)
    if folder_kind == "small":
        frames, _ = port_jpeg.load_folder(str(folder))
        color_range = "full" if "full" in port_flags else "studio"
        dec = decode_stream(got, color_range)
        assert len(dec) == len(frames) and dec[0].shape == frames[0].shape
        if "ycbcr" not in port_flags and "coeffs" not in port_flags and "--stream" not in port_flags:
            assert min(psnr(f, d) for f, d in zip(frames, dec)) > 28


def test_cli_rejects_as_reference(small_folder, tmp_path):
    for argv in (["--intake", "ycbcr"], ["--intake", "coeffs", "--stream", "--workdir", "w"],
                 ["--intake", "ycbcr", "--stream", "--bitstream-dir", "b"]):
        msgs = []
        for main, extra in ((cli.main, ["--device", "cpu"]), (ref_cli.main, ["--backend", "numpy"])):
            with pytest.raises(SystemExit) as e:
                main([str(small_folder), "-o", str(tmp_path / "o.mpeg"), *argv, *extra])
            msgs.append(str(e.value.code))
        assert msgs[0] == msgs[1] and "requires correct-mode --stream" in msgs[0]
    assert not (tmp_path / "o.mpeg").exists()


def test_cli_metrics_report(small_folder, tmp_path, capsys):
    reports = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (ref_cli.main, ["--backend", "numpy"])):
        main([str(small_folder), "-o", str(tmp_path / "o.mpeg"), "--metrics", "--stream",
              "--intake", "ycbcr", *extra])
        reports.append(json.loads(capsys.readouterr().err))
    got, want = reports
    assert set(got) == set(want)
    for key in ("frames", "resolution", "stream_bytes", "slice_bits", "bits_per_macroblock",
                "bytes_per_frame"):
        assert got[key] == want[key]
    assert got["decode_s"] > 0 and got["encode_s"] > 0 and "n_devices" not in got


def test_cli_profile_writes_a_trace(small_folder, tmp_path):
    assert cli.main([str(small_folder), "-o", str(tmp_path / "o.mpeg"), "--device", "cpu",
                     "--profile", str(tmp_path / "prof")]) == 0
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_never_falls_back(small_folder, compat_folder, tmp_path,
                                                     monkeypatch):
    _no_cuda(monkeypatch)
    out = tmp_path / "o.mpeg"
    with pytest.raises(SystemExit) as e:
        cli.main([str(small_folder), "-o", str(out)])
    assert e.value.code != 0 and "torch.cuda.is_available() is False" in str(e.value.code)
    with pytest.raises(RuntimeError, match="is_available"):
        mpeg_encode_procedure(str(compat_folder), str(tmp_path / "b"), str(out))
    with pytest.raises(RuntimeError, match="is_available"):
        api.encode_jpeg_folder(str(small_folder), str(out))
    with pytest.raises(RuntimeError, match="is_available"):
        encode_video(np.zeros((1, 16, 16, 3), np.uint8), str(out))
    with pytest.raises(RuntimeError, match="is_available"):
        checkpoint.encode_resumable(lambda s, e: None, 1, str(tmp_path / "wd"), str(out))
    assert not out.exists() and not (tmp_path / "b").exists()


def test_cli_module_exits_non_zero_without_cuda(small_folder, tmp_path):
    """`python -m ec504_imageencoder_tpu_torch.cli` with no card visible."""
    proc = subprocess.run(
        [sys.executable, "-m", "ec504_imageencoder_tpu_torch.cli", str(small_folder), "-o",
         str(tmp_path / "o.mpeg")], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "is_available() is False" in proc.stderr
    assert not (tmp_path / "o.mpeg").exists()


# ---- --workdir and runtime/checkpoint.py --------------------------------------

def test_cli_workdir_resumes_after_the_manifest_is_cut_back(small_folder, tmp_path):
    wd = tmp_path / "wd"
    argv = [str(small_folder), "--device", "cpu", "--gop", "2", "--workdir", str(wd)]
    assert cli.main([*argv, "-o", str(tmp_path / "a.mpeg")]) == 0
    first = (tmp_path / "a.mpeg").read_bytes()
    manifest = json.loads((wd / "manifest.json").read_text())
    assert [s["index"] for s in manifest["segments"]] == [0, 1, 2]
    seg0 = wd / "seg_000000.m1vseg"
    stamp = seg0.stat().st_mtime_ns
    manifest["segments"] = manifest["segments"][:1]  # GOPs 1 and 2 "lost"
    (wd / "manifest.json").write_text(json.dumps(manifest))
    time.sleep(0.01)
    assert cli.main([*argv, "-o", str(tmp_path / "b.mpeg")]) == 0
    assert (tmp_path / "b.mpeg").read_bytes() == first
    assert seg0.stat().st_mtime_ns == stamp  # GOP 0 was not re-encoded
    ref_cli.main([str(small_folder), "--backend", "numpy", "--gop", "2", "-o",
                  str(tmp_path / "r.mpeg")])
    assert first == (tmp_path / "r.mpeg").read_bytes()


@pytest.fixture(scope="module")
def frames(fixture_frames):
    base = np.stack([fixture_frames["0"], fixture_frames["1"], fixture_frames["2"]])
    return np.concatenate([base, base])[:, :96, :112]  # 6 frames, small


def _enc(gop):
    return TorchMPEG1IntraEncoder(quality=35, gop_size=gop, device="cpu")


def test_resumable_matches_single_shot_and_reference(frames, tmp_path):
    enc = _enc(2)
    n = checkpoint.encode_resumable(lambda s, e: frames[s:e], len(frames), str(tmp_path / "wd"),
                                    str(tmp_path / "out.mpeg"), encoder=enc)
    got = (tmp_path / "out.mpeg").read_bytes()
    assert n == len(got) and got == enc.encode(frames) + headers.sequence_end()
    ref_checkpoint.encode_resumable(
        lambda s, e: frames[s:e], len(frames), str(tmp_path / "rwd"), str(tmp_path / "r.mpeg"),
        encoder=MPEG1IntraEncoder(quality=35, gop_size=2, backend="numpy"))
    assert got == (tmp_path / "r.mpeg").read_bytes()
    assert len(decode_stream(got)) == len(frames)


def test_resume_skips_completed_gops(frames, tmp_path):
    enc = _enc(2)
    sess = checkpoint.CheckpointedEncode(str(tmp_path / "wd"), enc, len(frames))
    sess.encode_gop(0, frames[0:2])
    calls = []

    def source(start, end):
        calls.append((start, end))
        return frames[start:end]

    checkpoint.encode_resumable(source, len(frames), str(tmp_path / "wd"),
                                str(tmp_path / "out.mpeg"), encoder=enc)
    assert calls == [(2, 4), (4, 6)]


def test_corrupt_segment_is_reencoded(frames, tmp_path):
    enc = _enc(2)
    sess = checkpoint.CheckpointedEncode(str(tmp_path / "wd"), enc, len(frames))
    rec = sess.encode_gop(0, frames[0:2])
    with open(rec.path, "r+b") as f:
        f.write(b"\xde\xad")
    sess2 = checkpoint.CheckpointedEncode(str(tmp_path / "wd"), enc, len(frames))
    assert 0 in sess2.pending_gops()
    with pytest.raises(ValueError, match="different job"):
        checkpoint.CheckpointedEncode(str(tmp_path / "wd"), _enc(3), len(frames))


def test_transient_failure_redispatch(frames, tmp_path):
    enc = _enc(3)
    fail_once = {"left": 1}

    def flaky_source(start, end):
        if start == 3 and fail_once["left"]:
            fail_once["left"] -= 1
            raise IOError("simulated preemption")
        return frames[start:end]

    m = metrics.EncodeMetrics()
    checkpoint.encode_resumable(flaky_source, len(frames), str(tmp_path / "wd"),
                                str(tmp_path / "out.mpeg"), encoder=enc, metrics=m)
    assert (tmp_path / "out.mpeg").read_bytes() == enc.encode(frames) + headers.sequence_end()
    assert m.get("frames") == 6 and m.get("stream_bytes") > 0 and fail_once["left"] == 0


def test_segment_record_equals_reference():
    kw = dict(index=1, first_frame=2, n_frames=2, path="p", nbytes=10, md5="ab")
    assert checkpoint.SegmentRecord(**kw).to_json() == ref_checkpoint.SegmentRecord(**kw).to_json()


# ---- mux, metrics, profiling ------------------------------------------------

@pytest.fixture(scope="module")
def es(fixture_frames):
    frames = np.stack([fixture_frames["0"], fixture_frames["1"]])[:, :160, :240]
    return MPEG1IntraEncoder(quality=50, backend="numpy", gop_size=1).encode(frames) \
        + ref_headers.sequence_end()


@pytest.mark.parametrize("fps", [25.0, 29.97])
def test_mux_equals_reference(es, fps):
    body = es[:-4]
    pics = mux.split_es_pictures(body)
    assert pics == ref_mux.split_es_pictures(body) and len(pics) == 2
    ps = mux.mux_program_stream(pics, fps=fps)
    assert ps == ref_mux.mux_program_stream(pics, fps=fps)
    assert mux.demux_program_stream(ps) == ref_mux.demux_program_stream(ps) == es
    big = body * 20  # > 64 KB: several PES packets a picture
    assert mux.mux_program_stream([big], fps) == ref_mux.mux_program_stream([big], fps)
    for pts in (None, 0, 3600, (1 << 33) + 5):
        assert mux.pes_packet(b"xyz", pts) == ref_mux.pes_packet(b"xyz", pts)
    assert mux.split_es_pictures(b"no start code") == ref_mux.split_es_pictures(b"no start code")
    with pytest.raises(ValueError, match="too large"):
        mux.pes_packet(bytes(0x10000), None)


def test_encode_metrics_equal_reference():
    reports = []
    for mod in (metrics, ref_metrics):
        m, other = mod.EncodeMetrics(), mod.EncodeMetrics()
        m.set("frames", 40)
        m.add("encode_s", 0.5)
        m.add("encode_s", 1.5)
        m.set("n_devices", 2)
        m.set("baseline_fps", 4.0)
        m.set("stream_bytes", 4000)
        m.histogram("slice_bits", np.arange(100) ** 1.5)
        m.histogram("empty", [])
        with m.timer("decode_s"):
            pass
        m.set("decode_s", 0.25)
        other.set("frames", 2)
        other.set("resolution", "96x112")
        m.merge(other)
        reports.append((m.report(), m.get("missing", "d"), m.derived()))
    assert reports[0] == reports[1]
    assert reports[0][2]["encode_fps"] == 21.0 and reports[0][2]["encode_fps_per_chip"] == 10.5


def test_device_trace_and_stage_scope(tmp_path):
    with profiling.device_trace(str(tmp_path / "t")):
        with profiling.stage_scope("my_stage"):
            torch.ones(4) + 1
    (trace,) = (tmp_path / "t").glob("trace_*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "my_stage" in names
