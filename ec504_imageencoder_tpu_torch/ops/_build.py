"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled for Hopper
(`sm_90a`) into `build/lib<name>_<hash>.so` inside this package (listed
in `.gitignore`).  The hash covers the source and the flags, so an edited
source is rebuilt.  Nothing is built or loaded when this module is
imported: only `load()` runs nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds nvcc took, ptxas report); only for builds this process ran
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels "
            "are built from source at first use"
        )
    return found


def load(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; declare the C entry
    points in `argtypes` (each returns an int CUDA error code) and a
    `<name>_strerror(int) -> char*`."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        build_info[name] = (time.perf_counter() - t0, proc.stderr + proc.stdout)
    lib = ctypes.CDLL(str(so))
    for fn, types in argtypes.items():
        f = getattr(lib, fn)
        f.argtypes = types
        f.restype = ctypes.c_int
    strerror = getattr(lib, f"{name}_strerror")
    strerror.argtypes = [ctypes.c_int]
    strerror.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_strerror")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
