"""The port's C ABI shim (`io/native/encoder_capi.cpp`, libencoder_compat)
and its JNI binding (`encoder_jni.cpp`, libencoder_jni), built with g++ by
`io/_native.py`, on the CPU.

* The shim builds and loads, and returns 1 on null arguments.
* It runs `$EC504_PYTHON -m ec504_imageencoder_tpu_torch.cli <images> -o
  <video> --mode compat --bitstream-dir <bits> -q <quality>`, with no
  device (so on the card); a recording interpreter shows the command.
* The JNI export marshals its three strings through a spec-layout JNIEnv
  table and delegates to the shim, as tests/test_capi.py drives the
  reference's (`EC504_PYTHON=/bin/true`).
* Without CUDA the shim's encode fails (1) and writes nothing: it never
  falls back to the CPU.  Its card run is in tests/test_torch_cuda.py.
"""

import ctypes
import os
import shutil
import sys
from pathlib import Path

import pytest

from ec504_imageencoder_tpu_torch.io import _native
from ec504_imageencoder_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent


def _entry(lib):
    fn = lib.mpeg_encode_procedure
    fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def shim():
    return _entry(_native.load("encoder_compat"))


def test_capi_shim_builds_and_links(shim):
    path = _native.library_path("encoder_compat")
    assert path.exists() and path.parent == _build.build_dir()
    assert path.name.startswith("libencoder_compat_")
    for args in ((None, b"x", b"y", 12), (b"x", None, b"y", 12), (b"x", b"y", None, 12)):
        assert shim(*args) == 1


def test_capi_command_runs_the_ports_cli(shim, tmp_path, monkeypatch):
    record = tmp_path / "args.txt"
    python = tmp_path / "python"
    python.write_text(f"#!/bin/sh\nprintf '%s\\n' \"$@\" > {record}\n")
    python.chmod(0o755)
    monkeypatch.setenv("EC504_PYTHON", str(python))
    rc = shim(b"my images", str(tmp_path / "bits").encode(), b"it's.mpeg", 30)
    assert rc == 0
    assert record.read_text().splitlines() == [
        "-m", "ec504_imageencoder_tpu_torch.cli", "my images", "-o", "it's.mpeg",
        "--mode", "compat", "--bitstream-dir", str(tmp_path / "bits"), "-q", "30"]
    python.write_text("#!/bin/sh\nexit 3\n")
    assert shim(b"a", b"b", b"c", 12) == 1  # a failing command is an error return


def test_capi_shim_does_not_fall_back_to_the_cpu(shim, tmp_path, monkeypatch):
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for k in range(3):
        shutil.copy(ROOT / "tests" / "data" / "torch_jpegs" / f"frame_{k}.jpg", imgs)
    monkeypatch.setenv("EC504_PYTHON", sys.executable)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out.mpeg"
    assert shim(str(imgs).encode(), str(tmp_path / "bits").encode(), str(out).encode(), 12) == 1
    assert not out.exists() and not (tmp_path / "bits").exists()


def test_jni_binding_marshalls_strings(tmp_path, monkeypatch):
    lib = _native.load("encoder_jni")
    fn = lib.Java_com_example_Encoder_mpegEncodeProcedure

    GETCHARS = ctypes.CFUNCTYPE(ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p)
    RELCHARS = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p)
    strings = {}  # fake jstring handle -> bytes
    released = []

    def get_chars(env, jstr, is_copy):
        return strings[jstr]

    def rel_chars(env, jstr, chars):
        released.append(jstr)

    get_cb, rel_cb = GETCHARS(get_chars), RELCHARS(rel_chars)
    # JNI interface table: 4 reserved + functions from index 4;
    # GetStringUTFChars at 169, ReleaseStringUTFChars at 170.
    table = (ctypes.c_void_p * 171)()
    table[169] = ctypes.cast(get_cb, ctypes.c_void_p)
    table[170] = ctypes.cast(rel_cb, ctypes.c_void_p)
    env = ctypes.pointer(ctypes.cast(table, ctypes.c_void_p))

    imgs, bits, video = 101, 102, 103
    strings[imgs] = str(tmp_path / "imgs").encode()
    strings[bits] = str(tmp_path / "bits").encode()
    strings[video] = str(tmp_path / "out.mpeg").encode()
    monkeypatch.setenv("EC504_PYTHON", "/bin/true")
    fn.restype = ctypes.c_int
    rc = fn(env, None, ctypes.c_void_p(imgs), ctypes.c_void_p(bits), ctypes.c_void_p(video),
            ctypes.c_int(12))
    assert rc == 0
    assert sorted(released) == [imgs, bits, video]
    assert os.path.basename(lib._name).startswith("libencoder_jni_")
