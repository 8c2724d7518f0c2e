"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled for Hopper
(`sm_90a`) into `lib<name>_<hash>.so` in `build_dir()`: `build/` inside
this package (listed in `.gitignore`), or, where the package directory
is read-only (an installed copy), `$XDG_CACHE_HOME` (else `~/.cache`)
`/ec504_imageencoder_tpu_torch/build`.  The hash covers the source, every
header under `csrc/` (the kernels share device code through them) and the
flags, so an edited source or header is rebuilt.  Nothing is built or
loaded when this module is imported: only `load()` runs nvcc.  The host
libraries of `io/_native.py` (g++) share the directory and `compile_all`.

Every kernel call goes through `launch`: it rejects a device other than
CUDA, checks that the tensors are contiguous, passes their pointers with
the device and its current stream, raises on a CUDA error and counts the
call in `launches` under one of the names in `KERNELS` (calls on CPU
tensors run the plain twins, launch nothing and count nothing).  While a
profiler records, every `*_launch` entry point is called inside a span of
its own name (`utils.profiling.stage_scope`), so a trace names each kernel
launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled

from ec504_imageencoder_tpu_torch.utils.profiling import stage_scope

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"  # the default; see build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# what `launch` counts a call as: its wrapper's name, and B2's checked form
KERNELS = frozenset({
    "vlc_fused4", "vlc_fused8", "vlc_raw", "vlc_levels4", "f32_levels", "lut_lookup",
    "vlc_compat_slots", "vlc_compat_fused4", "compat_color", "pack_fused4",
    "pack_fused4_checked", "pack_fused8", "pack_raw", "pack_pairs", "pack_windows", "pack_split",
    "bit_count",
})
# kernel launches since the last `launches.clear()`, by name in KERNELS
launches: Counter[str] = Counter()
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


def _writable(path: Path) -> bool:
    """True when a file can be created in `path` (made if missing)."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=path):
            pass
    except OSError:
        return False
    return True


def build_dir() -> Path:
    """Where the libraries are built and found: `BUILD_DIR` while the
    package directory is writable, else the user cache directory."""
    if _writable(BUILD_DIR):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    out = Path(cache) / "ec504_imageencoder_tpu_torch" / "build"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return build_dir() / f"lib{name}_{source_digest(src)[:16]}.so"


def compile_all(jobs, tool: str, log: dict | None = None) -> None:
    """Run each job (name, library path, compiler argv without its output)
    whose library is missing, one process per job, all started together;
    each writes a temporary name that `os.replace` moves into place, so a
    concurrent loader sees the whole library or none.  Raise if any
    fails.  `log[name]` gets (seconds from the start until that job
    finished, its compiler output)."""
    procs = []
    t0 = time.perf_counter()
    for name, so, argv in jobs:
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [*argv, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{tool} failed on {name} (exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, so)
        if log is not None:
            log[name] = (time.perf_counter() - t0, err + out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names) -> None:
    """Compile every `csrc/<name>.cu` of `names` whose library is missing,
    one nvcc process per source, all started together; raise if any
    fails."""
    todo = [(n, _library(n)) for n in names]
    if all(so.exists() for _, so in todo):
        return
    nvcc = _nvcc()
    compile_all([(n, so, [nvcc, *NVCC_FLAGS, str(CSRC / f"{n}.cu")]) for n, so in todo],
                "nvcc", build_info)


def _scoped(fn, name: str):
    """fn inside a profiler span `name` while a profiler records; outside
    one, a bare call (a span costs ~12 us of host time a launch)."""
    def launch(*args):
        if not _profiler_enabled():
            return fn(*args)
        with stage_scope(name):
            return fn(*args)
    return launch


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
        if fn.endswith("_launch"):
            setattr(lib, fn, _scoped(f, fn))
    strerror = getattr(lib, f"{name}_strerror")
    strerror.argtypes = [ctypes.c_int]
    strerror.restype = ctypes.c_char_p
    lib.name = name  # what `launch` passes to `check`
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_strerror")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require_cuda(device: torch.device) -> None:
    """Raise unless `device` is a CUDA device: what the kernels run on."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")


def launch(load, entry: str, device: torch.device, *args, count_as: str | None = None) -> None:
    """Call the C entry point `<entry>_launch` of the library that `load()`
    returns (a module's `load_kernel`, called after the checks) on the CUDA
    `device`: ints and None in `args` as they are, every other argument a
    tensor passed as its data pointer, then the device's index and current
    stream.  Raise unless `device` is CUDA and every tensor contiguous;
    raise on a CUDA error; count the call in `launches[count_as]` (default
    `entry`, the wrapper's name)."""
    require_cuda(device)
    name = count_as or entry
    if name not in KERNELS:
        raise ValueError(f"{name!r} is not one of the counted kernels {sorted(KERNELS)}")
    ptrs = []
    for a in args:
        if a is not None and type(a) is not int:  # a tensor (`isinstance` costs ~0.2 us)
            if not a.is_contiguous():
                raise ValueError(f"{entry} needs contiguous tensors")
            a = a.data_ptr()
        ptrs.append(a)
    lib = load()
    err = getattr(lib, f"{entry}_launch")(
        *ptrs, device.index, torch.cuda.current_stream(device).cuda_stream)
    check(lib, lib.name, err)
    launches[name] += 1
