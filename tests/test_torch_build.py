"""The kernel build cache key and the kernel-call seam: no nvcc needed.

A built library is reused while its key holds, so the key must change
whenever anything that goes into the build changes: the `.cu` source and
every shared header under `csrc/` (an edited header must rebuild every
kernel that includes it).  Every kernel call goes through `_build.launch`,
which alone calls the C entry points and counts them in `_build.launches`;
calls on CPU tensors run the twins and count nothing.  Both fetches of an
encode call share one prefix bucket.
"""

import ast
import shutil
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.ops import _build


def test_digest_covers_the_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "vlc_fused4.cu"
    before = _build.source_digest(src, csrc)
    assert before == _build.source_digest(src, csrc)
    assert before == _build.source_digest(_build.CSRC / "vlc_fused4.cu")

    header = csrc / "vlc_emit.cuh"
    header.write_bytes(header.read_bytes() + b"// edited\n")
    after_header = _build.source_digest(src, csrc)
    assert after_header != before

    (csrc / "extra.h").write_text("#pragma once\n")
    assert _build.source_digest(src, csrc) != after_header

    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.source_digest(src, csrc) not in (before, after_header)


def test_every_kernel_source_is_keyed():
    """Each source's key differs from the others' (the source is in it)."""
    keys = {_build.source_digest(p) for p in _build.CSRC.glob("*.cu")}
    assert len(keys) == len(list(_build.CSRC.glob("*.cu"))) >= 4


def test_launch_spans_only_under_a_profiler():
    """`load` wraps every `*_launch` entry point: inside a profiler the
    call is a span of its name (what `--profile` traces show), outside one
    a bare call."""
    from torch.profiler import profile

    calls = []
    launch = _build._scoped(lambda *a: calls.append(a) or 0, "vlc_fused4_launch")
    assert launch(1, 2) == 0
    with profile() as prof:
        assert launch(3) == 0
    assert calls == [(1, 2), (3,)]
    assert [e.name for e in prof.events()].count("vlc_fused4_launch") == 1


# ---- the one kernel-call seam: `_build.launch` and `_build.launches` --------

OPS = Path(_build.__file__).resolve().parent


def _is_launch_call(node) -> bool:
    """A call of a `*_launch` attribute, or of `getattr(lib, "..._launch")`."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute) and node.func.attr.endswith("_launch"):
        return True
    if isinstance(node.func, ast.Call) and getattr(node.func.func, "id", None) == "getattr":
        return "_launch" in ast.unparse(node.func.args[1])
    return False


@pytest.mark.parametrize("path", sorted(p.name for p in OPS.glob("*.py")))
def test_only_the_seam_calls_entry_points_or_counts(path):
    """Outside `_build.py` no module of ops/ calls a C `*_launch` entry
    point, holds a module-level `launches*` name or has a `global`
    statement: every kernel call goes through `_build.launch`."""
    if path == "_build.py":
        return
    tree = ast.parse((OPS / path).read_text())
    calls = [ast.unparse(n) for n in ast.walk(tree) if _is_launch_call(n)]
    assert not calls, f"{path} calls entry points itself: {calls}"
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Global)], path
    names = [t.id for n in tree.body if isinstance(n, (ast.Assign, ast.AnnAssign))
             for t in (n.targets if isinstance(n, ast.Assign) else [n.target])
             if isinstance(t, ast.Name)]
    assert not [n for n in names if n.startswith("launches")], path


def test_the_counter_has_the_sixteen_kernels():
    assert len(_build.KERNELS) == 16
    assert "pack_fused4_checked" in _build.KERNELS and "compat_color" in _build.KERNELS
    assert isinstance(_build.launches, Counter)


def _cpu_calls():
    """kernel name in `_build.launches` -> a call of its wrapper on small
    CPU tensors (which runs the plain twin)."""
    from ec504_imageencoder_tpu_torch.ops import (
        cuda_lut,
        cuda_pack,
        cuda_pack_split,
        cuda_vlc,
        cuda_vlc_compat,
        cuda_vlc_levels,
        cuda_vlc_raw,
    )
    from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts

    rng = np.random.default_rng(0)
    planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
              for s in ((1, 16, 32), (1, 8, 16), (1, 8, 16))]
    compat = [torch.from_numpy(rng.integers(0, 256, (1, 144, 96), dtype=np.uint8))
              for _ in range(3)]
    qw = torch.full((8, 8), 16, dtype=torch.int32)
    luts, luts_c = Luts.default("cpu"), Luts.compat("cpu")
    levels, preds = cuda_vlc.levels_plain(*planes, qw, luts.zigzag, cuda_vlc.aan_dct)
    slots = cuda_vlc.vlc_fused4_plain(*planes, qw, luts)
    words8, flens8 = cuda_vlc.vlc_fused8_plain(*planes, qw, luts)
    lens = torch.from_numpy(rng.integers(0, 31, (2, 40), dtype=np.int32))
    codes = torch.from_numpy(rng.integers(0, 1 << 30, (2, 40), dtype=np.int32))
    codes = codes & ((1 << lens) - 1)
    idx = torch.arange(-3, 140, dtype=torch.int32)
    return {
        "vlc_fused4": lambda: cuda_vlc.vlc_fused4(*planes, qw, luts),
        "vlc_fused8": lambda: cuda_vlc.vlc_fused8(*planes, qw, luts),
        "vlc_raw": lambda: cuda_vlc_raw.vlc_raw(*planes, qw, luts),
        "vlc_levels4": lambda: cuda_vlc_levels.vlc_levels4(levels, preds, luts),
        "f32_levels": lambda: cuda_vlc_levels.f32_levels(*planes, qw, luts.zigzag),
        "lut_lookup": lambda: cuda_lut.lut_lookup(idx, cuda_lut.AC_PACKED),
        "vlc_compat_slots": lambda: cuda_vlc_compat.vlc_compat_slots(*compat, qw, luts_c),
        "vlc_compat_fused4": lambda: cuda_vlc_compat.vlc_compat_fused4(*compat, qw, luts_c),
        "compat_color": lambda: cuda_vlc_compat.compat_color(
            torch.from_numpy(rng.integers(0, 256, (1, 4, 6, 3), dtype=np.uint8))),
        "pack_fused4": lambda: cuda_pack.pack_fused4(*slots, 256),
        "pack_fused4_checked": lambda: cuda_pack.pack_fused4(*slots, 256, checks=True),
        "pack_fused8": lambda: cuda_pack.pack_fused8(words8, flens8, 256),
        "pack_raw": lambda: cuda_pack.pack_raw(codes, lens, 64),
        "pack_pairs": lambda: cuda_pack.pack_pairs(codes, lens, 64),
        "pack_windows": lambda: cuda_pack_split.pack_windows(codes, lens, 64),
        "pack_split": lambda: cuda_pack_split.pack_split(codes, lens, 64),
    }


@pytest.mark.parametrize("kernel", sorted(_build.KERNELS))
def test_twins_on_the_cpu_launch_and_count_nothing(kernel, monkeypatch):
    """Each wrapper on CPU tensors runs its plain twin: no library is
    loaded and `_build.launches` stays empty."""
    def no_library(*args):
        raise AssertionError("a CPU call loaded a kernel library")

    calls = _cpu_calls()
    assert sorted(calls) == sorted(_build.KERNELS)
    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(_build, "launches", Counter())
    calls[kernel]()
    assert not _build.launches


class _FakeLib:
    """Stands in for a loaded library: records the entry point's arguments."""

    name = "fake"

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def pack_raw_launch(self, *args):
        self.calls.append(args)
        return self.err

    def fake_strerror(self, err):
        return b"fake error"


def test_launch_passes_pointers_device_and_stream(monkeypatch):
    """`launch` hands tensors over as data pointers, ints and None as they
    are, then the device's index and its current stream; it counts the
    call under `count_as`, else the entry's name, and raises on an error
    code without counting."""
    class Stream:
        cuda_stream = 77

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    monkeypatch.setattr(_build, "launches", Counter())
    dev = torch.device("cuda", 3)
    t = torch.zeros(4, dtype=torch.int32)
    lib = _FakeLib()
    _build.launch(lambda: lib, "pack_raw", dev, t, 5, None)
    _build.launch(lambda: lib, "pack_raw", dev, t, count_as="pack_pairs")
    assert lib.calls == [(t.data_ptr(), 5, None, 3, 77), (t.data_ptr(), 3, 77)]
    assert _build.launches == Counter({"pack_raw": 1, "pack_pairs": 1})
    with pytest.raises(RuntimeError, match="fake: CUDA error 2 \\(fake error\\)"):
        _build.launch(lambda: _FakeLib(err=2), "pack_raw", dev, t)
    assert _build.launches == Counter({"pack_raw": 1, "pack_pairs": 1})


@pytest.mark.parametrize("case", ["cpu", "meta", "strided", "unknown-name"])
def test_launch_refuses_before_loading(case, monkeypatch):
    """The checks come before the library is loaded: a device other than
    CUDA, a tensor that is not contiguous, a name outside KERNELS."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "launches", Counter())
    t = torch.zeros((4, 4), dtype=torch.int32)
    dev, args, entry, match = {
        "cpu": (torch.device("cpu"), (t,), "pack_raw", "unsupported device cpu"),
        "meta": (torch.device("meta"), (t,), "pack_raw", "unsupported device meta"),
        "strided": (torch.device("cuda", 0), (t.T,), "pack_raw",
                    "pack_raw needs contiguous tensors"),
        "unknown-name": (torch.device("cuda", 0), (t,), "pack_other", "not one of"),
    }[case]
    with pytest.raises(ValueError, match=match):
        _build.launch(no_library, entry, dev, *args)
    assert not _build.launches


# ---- the encode-call protocol: the prefix fetch's bucket --------------------

def _old_correct_bucket(used, cap):
    return min(max(256, 1 << max(used - 1, 1).bit_length()), cap)


def _old_compat_bucket(used, cap):
    return min(max(256, 1 << (used - 1).bit_length()), cap)


@pytest.mark.parametrize("cap", [2560, 4096, 12288])
@pytest.mark.parametrize("base,caps", [(0, 0), (1, 0), (2, 0), (255, 0), (256, 0), (257, 0),
                                       (-1, 1), (0, 1), (1, 1)],
                         ids=["0", "1", "2", "255", "256", "257", "cap-1", "cap", "cap+1"])
def test_prefix_bucket_keeps_both_old_formulas(cap, base, caps):
    """`mpeg1.prefix_bytes`, the one bucket of both fetches, gives what the
    correct-mode and the compat formula gave for used = base + caps * cap."""
    from ec504_imageencoder_tpu_torch.models.mpeg1 import prefix_bytes

    used = base + caps * cap
    want = _old_correct_bucket(used, cap)
    assert prefix_bytes(used, cap) == want == _old_compat_bucket(used, cap)
