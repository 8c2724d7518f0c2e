"""The port's JPEG intake (`io/jpeg.py`, `io/stream.py`, the g++-built
native decoder of `io/_native.py`) and its build directory (hazard C-h6)
against the JAX package, on the CPU.

* Every function of `io/jpeg.py` against its namesake in the JAX package
  on the same files: pixels, planes, int16 coefficients, probe dicts, kept
  paths, skip warnings and the `ValueError` messages of a corrupt file and
  of a dimension mismatch.  The JPEGs are made here with PIL (4:2:0, 4:4:4,
  grayscale, progressive; 48 x 64 to 96 x 112).
* The decoder the port loads is its own build, under `_build.build_dir()`.
* `FolderFrameSource`: every batch, window and error equal to the
  reference's.
* C-h6: with the package directory reported unwritable (the probe is
  patched: for root, permission bits stop nothing),
  the host libraries and the kernels' paths go to the user cache, and the
  decoder builds and loads from there; a failed g++ build raises.

Tolerance: exact everywhere (integer decode, equal arrays and messages).
"""

import ctypes
import warnings

import numpy as np
import pytest

from ec504_imageencoder_tpu.io import jpeg as ref_jpeg
from ec504_imageencoder_tpu.io.stream import FolderFrameSource as RefSource
from ec504_imageencoder_tpu_torch.io import _native
from ec504_imageencoder_tpu_torch.io import jpeg as port_jpeg
from ec504_imageencoder_tpu_torch.io.stream import FolderFrameSource
from ec504_imageencoder_tpu_torch.ops import _build

SIZES = [(48, 64), (64, 80), (96, 112), (50, 70)]


def _save(path, arr, **kw):
    from PIL import Image

    Image.fromarray(arr).save(path, **kw)


def _content(rng, h, w):
    """Smooth gradients plus noise: natural enough that every AC band is
    used, cheap to make."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 3 + xx) % 256, (xx * 5) % 256, (yy * 7 + 40) % 256], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> path of single JPEGs of each kind."""
    d = tmp_path_factory.mktemp("kinds")
    rng = np.random.default_rng(11)
    out = {}
    for i, (h, w) in enumerate(SIZES):
        out[f"420_{h}x{w}"] = d / f"a{i}_420.jpg"
        _save(out[f"420_{h}x{w}"], _content(rng, h, w), quality=85, subsampling=2)
    out["444"] = d / "b_444.jpg"
    _save(out["444"], _content(rng, 48, 64), quality=92, subsampling=0)
    out["gray"] = d / "c_gray.jpg"
    _save(out["gray"], _content(rng, 64, 80)[..., 0], quality=80)
    out["progressive"] = d / "d_prog.jpg"
    _save(out["progressive"], _content(rng, 96, 112), quality=88, subsampling=2,
          progressive=True)
    out["corrupt"] = d / "e_bad.jpg"
    out["corrupt"].write_bytes(b"\xff\xd8\xff garbage, not a JPEG")
    out["png"] = d / "f_png.jpg"  # a PNG under a JPEG name: native rejects, PIL reads
    _save(out["png"], _content(rng, 48, 64), format="PNG")
    return {k: str(v) for k, v in out.items()}


def _folder(tmp_path, n, h=48, w=64, seed=3, subsampling=2, quality=92):
    rng = np.random.default_rng(seed)
    for i in range(n):
        _save(tmp_path / f"f{i:02d}.jpg", _content(rng, h, w), quality=quality,
              subsampling=subsampling)
    return tmp_path


def _warned(fn, *args, **kw):
    """(result or exception, warning messages) of fn(*args, **kw)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            out = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 - the exception is the result
            out = e
    return out, [str(w.message) for w in rec]


def _same_outcome(got, want):
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_outcome(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def test_decoder_is_the_ports_build():
    lib = port_jpeg._load_native()
    path = lib._name
    assert path.startswith(str(_build.build_dir()))
    assert path == str(_native.library_path("stbjpeg"))
    assert "ec504_imageencoder_tpu/io/native" not in path
    assert port_jpeg.have_native_decoder() is True


@pytest.mark.parametrize("kind", ["420_48x64", "420_64x80", "420_96x112", "420_50x70",
                                  "444", "gray", "progressive", "corrupt", "png"])
def test_decode_and_probe_equal_reference(files, kind):
    path = files[kind]
    _same_outcome(port_jpeg.probe_jpeg(path), ref_jpeg.probe_jpeg(path))
    for exact in (False, True):
        got, got_w = _warned(port_jpeg.decode_jpeg, path, exact)
        want, want_w = _warned(ref_jpeg.decode_jpeg, path, exact)
        if kind == "corrupt" or (kind == "png" and exact):
            # the native decoder rejects it: PIL's error, or the
            # exactness requirement's RuntimeError in both
            assert type(got) is type(want) and isinstance(want, Exception)
        else:
            _same_outcome(got, want)
        assert got_w == want_w


def test_missing_pil_makes_a_rejected_file_a_decode_failure(files, tmp_path, monkeypatch):
    """Where PIL is not installed, a file the native decoder
    rejects is a decode failure: decode_jpeg raises ValueError and
    load_folder skips it with a warning."""
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ValueError, match="decode failure: .*f_png.jpg"):
        port_jpeg.decode_jpeg(files["png"])
    import shutil

    for i in range(2):
        shutil.copy(files["420_48x64"], tmp_path / f"ok{i}.jpg")
    shutil.copy(files["png"], tmp_path / "zz.jpg")
    (frames, kept), warned = _warned(port_jpeg.load_folder, str(tmp_path))
    assert len(frames) == len(kept) == 2 and not any(p.endswith("zz.jpg") for p in kept)
    assert any("zz.jpg" in w for w in warned)


def test_scan_folder_equals_reference(tmp_path):
    for name in ("a.jpg", "b.jpeg", "c.JPG", "d.jpg.bak", "e.png", "notes.txt", "xjpeg"):
        (tmp_path / name).write_bytes(b"")
    assert port_jpeg.scan_folder(str(tmp_path)) == ref_jpeg.scan_folder(str(tmp_path))
    assert sorted(p.rsplit("/", 1)[1] for p in port_jpeg.scan_folder(str(tmp_path))) == [
        "a.jpg", "b.jpeg", "d.jpg.bak"]


@pytest.mark.parametrize("case", ["clean", "corrupt", "corrupt-first", "mismatch", "empty",
                                  "all-corrupt", "single", "png", "444"])
def test_load_folder_equals_reference(tmp_path, case):
    if case == "444":
        _folder(tmp_path, 4, subsampling=0)
    elif case == "single":
        _folder(tmp_path, 1, h=96, w=112)
    elif case != "empty":
        _folder(tmp_path, 5)
    if case == "corrupt":
        (tmp_path / "f02.jpg").write_bytes(b"\xff\xd8garbage")
    elif case == "corrupt-first":
        (tmp_path / "a_first.jpg").write_bytes(b"\xff\xd8garbage")
    elif case == "mismatch":
        _save(tmp_path / "f03.jpg", _content(np.random.default_rng(0), 64, 64), quality=90)
    elif case == "all-corrupt":
        for p in tmp_path.glob("*.jpg"):
            p.write_bytes(b"\xff\xd8garbage")
    elif case == "png":
        _save(tmp_path / "f09.jpg", _content(np.random.default_rng(1), 48, 64), format="PNG")
    for exact in (False, True):
        got, got_w = _warned(port_jpeg.load_folder, str(tmp_path), exact)
        want, want_w = _warned(ref_jpeg.load_folder, str(tmp_path), exact)
        if case in ("corrupt-first", "all-corrupt") and not exact:
            # the sequential path: PIL's error text in the skip warnings
            assert len(got_w) == len(want_w)
            got_w = [w.split(": cannot identify")[0] for w in got_w]
            want_w = [w.split(": cannot identify")[0] for w in want_w]
        if isinstance(want, RuntimeError):
            assert isinstance(got, RuntimeError)  # require_exact: PIL not allowed
        else:
            _same_outcome(got, want)
        assert got_w == want_w


@pytest.mark.parametrize("kind", ["planes", "coeffs"])
@pytest.mark.parametrize("case", ["clean", "corrupt", "mismatch", "odd"])
def test_staged_batches_equal_reference(tmp_path, kind, case):
    h, w = (50, 70) if case == "odd" else (48, 64)
    _folder(tmp_path, 4, h=h, w=w)
    if case == "corrupt":
        (tmp_path / "f01.jpg").write_bytes(b"\xff\xd8garbage")
    elif case == "mismatch":
        _save(tmp_path / "f02.jpg", _content(np.random.default_rng(0), 64, 80), quality=90,
              subsampling=2)
    paths = sorted(ref_jpeg.scan_folder(str(tmp_path)))
    geom = ref_jpeg.probe_jpeg(paths[0])
    assert port_jpeg.probe_jpeg(paths[0]) == geom
    fn = {"planes": "decode_planes_batch", "coeffs": "decode_coeffs_batch"}[kind]
    got, _ = _warned(getattr(port_jpeg, fn), paths, geom, 2)
    want, _ = _warned(getattr(ref_jpeg, fn), paths, geom, 2)
    _same_outcome(got, want)
    if case == "clean":
        assert [a.dtype for a in got] == [np.uint8 if kind == "planes" else np.int16] * 3


def _collect(gen):
    return [(s, b) for s, b in gen]


@pytest.mark.parametrize("batch", [1, 3, 7, 16])
def test_folder_source_equals_reference(tmp_path, batch):
    _folder(tmp_path, 7)
    port, ref = FolderFrameSource(str(tmp_path)), RefSource(str(tmp_path))
    assert port.paths == ref.paths and len(port) == len(ref) == 7
    assert (port.height, port.width) == (ref.height, ref.width)
    assert port.geometry == ref.geometry and port.supports_planes() == ref.supports_planes()
    for method in ("batches", "plane_batches", "coeff_batches"):
        got = _collect(getattr(port, method)(batch))
        want = _collect(getattr(FolderFrameSource(str(tmp_path)), method)(batch))
        ref_want = _collect(getattr(RefSource(str(tmp_path)), method)(batch))
        assert [s for s, _ in got] == [s for s, _ in ref_want] == list(range(0, 7, batch))
        for (_, g), (_, w), (_, r) in zip(got, want, ref_want):
            _same_outcome(g, r)
            _same_outcome(w, r)
    for s, e in ((0, 7), (2, 5), (5, 99), (0, 1), (3, 3), (-2, 2)):
        _same_outcome(FolderFrameSource(str(tmp_path))(s, e), RefSource(str(tmp_path))(s, e))


def test_folder_source_444_has_no_planes(tmp_path):
    _folder(tmp_path, 3, subsampling=0)
    port, ref = FolderFrameSource(str(tmp_path)), RefSource(str(tmp_path))
    assert port.supports_planes() is ref.supports_planes() is False
    _same_outcome(port(0, 3), ref(0, 3))


@pytest.mark.parametrize("bad", ["middle", "first", "mismatch"])
def test_folder_source_fails_fast_as_reference(tmp_path, bad):
    """The fail-fast ValueError contract: a corrupt file anywhere (the
    constructor's probe included) or a size mismatch raises ValueError
    with the reference's message."""
    _folder(tmp_path, 5)
    if bad == "first":
        for p in tmp_path.glob("*.jpg"):
            p.write_bytes(b"\xff\xd8garbage")
        got = _warned(FolderFrameSource, str(tmp_path))[0]
        want = _warned(RefSource, str(tmp_path))[0]
        assert isinstance(got, ValueError) and isinstance(want, ValueError)
        assert str(got).split(" (")[0] == str(want).split(" (")[0]
        return
    got, want = FolderFrameSource(str(tmp_path)), RefSource(str(tmp_path))
    got.paths.sort()
    want.paths.sort()
    if bad == "middle":
        (tmp_path / "f02.jpg").write_bytes(b"\xff\xd8garbage")
    else:
        _save(tmp_path / "f03.jpg", _content(np.random.default_rng(0), 64, 80), quality=90,
              subsampling=2)
    for method in ("batches", "plane_batches", "coeff_batches"):
        errs = []
        for src in (got, want):
            with pytest.raises(ValueError) as e:
                _collect(getattr(src, method)(2))
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    for src in (got, want):
        with pytest.raises(ValueError, match="fail-fast|dimension mismatch"):
            src(0, len(src))


# ---- C-h6: the build directory --------------------------------------------

def test_build_dir_is_the_package_dir_by_default():
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build._library("vlc_fused4").parent == _build.BUILD_DIR
    assert _native.library_path("stbjpeg").parent == _build.BUILD_DIR


def test_writability_probe(tmp_path):
    assert _build._writable(tmp_path / "new" / "dir")
    (tmp_path / "afile").write_bytes(b"")
    assert not _build._writable(tmp_path / "afile" / "sub")


def test_unwritable_package_builds_into_the_user_cache(files, tmp_path, monkeypatch):
    cache = tmp_path / "xdg"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    monkeypatch.setattr(_build, "_writable", lambda path: False)
    want_dir = cache / "ec504_imageencoder_tpu_torch" / "build"
    assert _build.build_dir() == want_dir
    # the CUDA kernels are looked for (and would be built) there too
    assert _build._library("pack_fused4").parent == want_dir
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(port_jpeg, "_native", None)
    img = port_jpeg.decode_jpeg(files["420_96x112"])
    assert port_jpeg._load_native()._name == str(want_dir / _native.library_path(
        "stbjpeg").name)
    assert np.array_equal(img, ref_jpeg.decode_jpeg(files["420_96x112"]))
    _native.build(["encoder_compat", "encoder_jni"])
    for name in ("encoder_compat", "encoder_jni"):
        path = _native.library_path(name)
        assert path.parent == want_dir and path.exists()
        ctypes.CDLL(str(path))
    assert not list(want_dir.glob("*.tmp"))
    # without HOME's cache variable: ~/.cache
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir() == tmp_path / "home" / ".cache" / "ec504_imageencoder_tpu_torch" / "build"


def test_failed_host_build_raises(files, tmp_path, monkeypatch):
    """A g++ failure raises; the decoder never falls through to PIL."""
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "stb_compat_jpeg.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_native, "NATIVE", broken)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(port_jpeg, "_native", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on stbjpeg"):
        port_jpeg.decode_jpeg(files["420_48x64"])
    assert not list((tmp_path / "build").glob("*.so"))
