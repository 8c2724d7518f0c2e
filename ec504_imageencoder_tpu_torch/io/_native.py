"""Build the host C++ libraries with g++ at first use.

- `stbjpeg`: the stb_image-compatible JPEG decoder
  (`native/stb_compat_jpeg.cpp`), which `io/jpeg.py` binds with ctypes;
- `encoder_compat`: the C ABI shim (`native/encoder_capi.cpp`), which
  exports the reference C project's `mpeg_encode_procedure` and runs this
  package's CLI;
- `encoder_jni`: its JNI binding (`native/encoder_jni.cpp` with the shim).

Each is built into `ops/_build.build_dir()` (beside the CUDA kernels) as
`lib<name>_<hash>.so`, the hash over its sources and the flags, by the
same temporary-name-then-`os.replace` step as the kernels.  A failed
build raises; nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
from pathlib import Path

from ec504_imageencoder_tpu_torch.ops import _build

NATIVE = Path(__file__).resolve().parent / "native"
GXX = "g++"
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")
SOURCES = {
    "stbjpeg": ("stb_compat_jpeg.cpp",),
    "encoder_compat": ("encoder_capi.cpp",),
    "encoder_jni": ("encoder_jni.cpp", "encoder_capi.cpp"),
}

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds from the start of its `build` call until its g++
# finished, compiler output); only for builds this process ran
build_info: dict[str, tuple[float, str]] = {}


def library_path(name: str) -> Path:
    """The library `name` would be loaded from (built or not)."""
    h = hashlib.sha256()
    for src in SOURCES[name]:
        h.update(src.encode() + b"\0" + (NATIVE / src).read_bytes())
    h.update(" ".join((GXX, *GXX_FLAGS)).encode())
    return _build.build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> None:
    """Compile every library of `names` that is missing, one g++ per
    library, all started together; raise if any fails."""
    _build.compile_all(
        [(n, library_path(n), [GXX, *GXX_FLAGS, *(str(NATIVE / s) for s in SOURCES[n])])
         for n in names],
        "g++", build_info)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library `name`, once a process."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
