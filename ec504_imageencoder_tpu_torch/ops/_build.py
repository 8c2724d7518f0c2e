"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled for Hopper
(`sm_90a`) into `build/lib<name>_<hash>.so` inside this package (listed
in `.gitignore`).  The hash covers the source, every header under
`csrc/` (the kernels share device code through them) and the flags, so
an edited source or header is rebuilt.  Nothing is built or loaded when
this module is imported: only `load()` runs nvcc.
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
# name -> (seconds from the start of its `build` call until its nvcc
# finished, ptxas report); only for builds this process ran
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


def source_digest(src: Path, csrc: Path = CSRC) -> str:
    """Hex digest of `src`, of every header (`*.cuh`, `*.h`) in `csrc`
    and of the nvcc flags: the key of the built library."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted((*csrc.glob("*.cuh"), *csrc.glob("*.h"))):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}_{source_digest(src)[:16]}.so"


def build(names) -> None:
    """Compile every `csrc/<name>.cu` of `names` whose library is missing,
    one nvcc process per source, all started together; raise if any
    fails."""
    todo = [(n, _library(n)) for n in names]
    todo = [(n, so) for n, so in todo if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        build_info[name] = (time.perf_counter() - t0, err + out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; declare the C entry
    points in `argtypes` (each returns an int CUDA error code) and a
    `<name>_strerror(int) -> char*`."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_library(name)))
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
