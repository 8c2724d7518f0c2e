"""The port's `encode.*` spans, on the CPU.

Under `utils.profiling.device_trace`, one call of each encoder entry
(`encode_from_planes`, `encode_from_coeffs`, `encode`, `encode_compat`,
and the sharded encoder's) writes its stage spans once each, in order,
one after another inside the caller's own `record_function` (the planes
and RGB entries pad on the device in `encode.edge_pad`, after the copy);
`encode.levels` sits inside `encode.enqueue` on exactly the routes that
call `plane_levels` (the f32 DCT and the generic `pack=` route, not the
AAN kernel route), and on the RGB route `encode.rgb420` (colour and 4:2:0)
before it.  A regrow adds one `encode.enqueue` and one `encode.fetch_bits`
per re-run, on the same device copies, and one more colour pass, counted
in `rgb420_passes`.  The sharded encoder copies and launches shard by
shard.  Compat copies the RGB
frames, then converts their colour in `encode.color`: on the card, that
span holds the colour kernel's launch span.  No stage span ends in
`_launch` (the suffix that names a kernel launch).  With the profiler
off, `record_function` is never called.  The bytes are the same traced
or not.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.encoder import encode_compat
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.parallel.mesh import make_mesh
from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import ShardedTorchMPEG1Encoder
from ec504_imageencoder_tpu_torch.utils import profiling

PORT = Path(__file__).resolve().parent.parent / "ec504_imageencoder_tpu_torch"
CALLER = "caller.span"
CORRECT = ["encode.pad", "encode.h2d", "encode.edge_pad", "encode.enqueue", "encode.fetch_bits",
           "encode.fetch_prefix", "encode.assemble", "encode.release"]
COEFFS = CORRECT[:2] + ["encode.intake"] + CORRECT[3:]
COMPAT = ["encode.h2d", "encode.color", "encode.tables", "encode.enqueue",
          "encode.fetch_bits", "encode.fetch_prefix", "encode.fetch_planes", "encode.assemble"]
H, W = 40, 56  # two macroblock rows and columns of padding


def _planes(seed=3, b=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, H, W), dtype=np.uint8),
            *(rng.integers(0, 256, (b, H // 2, W // 2), dtype=np.uint8) for _ in range(2)))


def _rgb(seed=4, b=2, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _coeffs(seed=5, b=2):
    """Dequantized int16 coefficient blocks of an H x W 4:2:0 picture."""
    rng = np.random.default_rng(seed)
    ny = -(-H // 8) * -(-W // 8)
    nc = -(-H // 16) * -(-W // 16)
    out = []
    for n in (ny, nc, nc):
        c = np.zeros((b, n, 64), np.int16)
        c[..., 0] = rng.integers(-1000, 1000, (b, n))
        c[..., 1:6] = rng.integers(-60, 60, (b, n, 5))
        out.append(c)
    return out


def _traced(tmp_path, fn):
    """Run fn inside the caller's span under `device_trace` -> (its result,
    every recorded span as (name, parent name), in start order)."""
    with profiling.device_trace(str(tmp_path)):
        with record_function(CALLER):
            out = fn()
    (path,) = tmp_path.glob("trace_*.pt.trace.json")
    spans = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                   key=lambda e: (e["ts"], -e["dur"]))
    tree, stack = [], []
    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        tree.append((e["name"], stack[-1]["name"] if stack else None))
        stack.append(e)
    return out, tree


def _children(tree, parent):
    return [name for name, p in tree if p == parent]


def _check_correct_mode(tree, top, levels, rgb=False):
    assert _children(tree, None) == [CALLER]
    assert _children(tree, CALLER) == top
    assert _children(tree, "encode.enqueue") == (["encode.rgb420"] * rgb
                                                 + ["encode.levels"] * levels)
    assert sum(name == "encode.levels" for name, _ in tree) == int(levels)
    assert sum(name == "encode.rgb420" for name, _ in tree) == int(rgb)


@pytest.mark.parametrize("intake,dct_impl,pack,levels", [
    ("planes", "f32", "fused4", True),
    ("planes", "aan", "fused4", False),
    ("planes", "aan", "pallas1", True),
    ("rgb", "f32", "fused4", True),
    ("rgb", "aan", "fused4", False),
    ("coeffs", "f32", "fused4", True),
    ("coeffs", "aan", "fused4", False),
])
def test_correct_mode_spans(tmp_path, intake, dct_impl, pack, levels):
    enc = TorchMPEG1IntraEncoder(quality=50, dct_impl=dct_impl, pack=pack, device="cpu")
    call = {"planes": lambda: enc.encode_from_planes(*_planes()),
            "rgb": lambda: enc.encode(_rgb()),
            "coeffs": lambda: enc.encode_from_coeffs(*_coeffs(), H, W)}[intake]
    want = call()
    got, tree = _traced(tmp_path, call)
    assert got == want
    _check_correct_mode(tree, COEFFS if intake == "coeffs" else CORRECT, levels,
                        rgb=intake == "rgb")


def _count_forward(monkeypatch):
    """A list that gains an entry each time `EncodeCore.forward` runs."""
    runs = []
    forward = mpeg1.EncodeCore.forward

    def counted(self, *args, **kw):
        runs.append(1)
        return forward(self, *args, **kw)

    monkeypatch.setattr(mpeg1.EncodeCore, "forward", counted)
    return runs


@pytest.mark.parametrize("max_slice_bytes", [None, 8])
def test_sharded_encoder_spans(tmp_path, monkeypatch, max_slice_bytes):
    """The sharded encoder pads on the host and makes the shards' slabs
    contiguous in a second `encode.pad` (no `encode.edge_pad`), then
    copies each shard (`encode.h2d`) and launches it (`encode.enqueue`,
    with its own `plane_levels`) before the next one.
    A regrow launches every shard again on the same copies."""
    runs = _count_forward(monkeypatch)
    enc = ShardedTorchMPEG1Encoder(quality=80, mesh=make_mesh(2, 1, ["cpu"] * 2), device="cpu",
                                   max_slice_bytes=max_slice_bytes)
    want = TorchMPEG1IntraEncoder(quality=80, device="cpu").encode_from_planes(*_planes(b=3))
    runs.clear()
    got, tree = _traced(tmp_path, lambda: enc.encode_from_planes(*_planes(b=3)))
    assert got == want
    shards = ["encode.h2d", "encode.enqueue"] * 2
    rerun = ["encode.enqueue"] * 2 + ["encode.fetch_bits"] if max_slice_bytes else []
    assert len(runs) == 2 + rerun.count("encode.enqueue")
    assert _children(tree, CALLER) == (["encode.pad"] * 2 + shards + ["encode.fetch_bits"]
                                       + rerun + CORRECT[5:])
    assert _children(tree, "encode.enqueue") == ["encode.levels"] * len(runs)


def test_compat_spans(tmp_path):
    frames = _rgb(b=2, h=150, w=101)
    want = encode_compat(frames, 12, device="cpu")
    got, tree = _traced(tmp_path, lambda: encode_compat(frames, 12, device="cpu"))
    assert got == want
    assert _children(tree, CALLER) == COMPAT
    assert not any(p is not None and p.startswith("encode.") for _, p in tree)


@pytest.mark.requires_cuda
def test_compat_color_launch_inside_its_span(tmp_path):
    """On the card `encode.color` holds the colour kernel's launch and
    nothing else; B4b and B2 launch inside `encode.enqueue`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`python -m pytest --noconftest tests/test_torch_spans.py`")
    frames = _rgb(b=2, h=150, w=101)
    want = encode_compat(frames, 12, device="cpu")
    got, tree = _traced(tmp_path, lambda: encode_compat(frames, 12, device="cuda"))
    assert got == want
    assert _children(tree, CALLER) == COMPAT
    assert _children(tree, "encode.color") == ["compat_color_launch"]
    assert _children(tree, "encode.enqueue") == ["vlc_compat_fused4_launch",
                                                 "pack_fused4_launch"]


@pytest.mark.parametrize("intake", ["planes", "rgb", "coeffs"])
def test_regrow_spans_count_the_reruns(tmp_path, monkeypatch, intake):
    """From an 8-byte slice buffer the first call overflows and re-runs
    once; the second starts from the grown buffer and does not.  The
    re-runs are the `encode.enqueue` spans beyond one a call, each with
    its own bit-count fetch and no second copy."""
    runs = _count_forward(monkeypatch)
    enc = TorchMPEG1IntraEncoder(quality=50, max_slice_bytes=8, device="cpu")
    call = {"planes": lambda: enc.encode_from_planes(*_planes()),
            "rgb": lambda: enc.encode(_rgb()),
            "coeffs": lambda: enc.encode_from_coeffs(*_coeffs(), H, W)}[intake]
    calls = 2
    _, tree = _traced(tmp_path, lambda: [call() for _ in range(calls)])
    assert enc.max_slice_bytes > 8
    reruns = len(runs) - calls
    assert reruns == 1
    top = COEFFS if intake == "coeffs" else CORRECT
    first = top[:top.index("encode.fetch_bits") + 1]
    rerun = ["encode.enqueue", "encode.fetch_bits"]
    assert _children(tree, CALLER) == first + rerun + top[len(first):] + top
    assert sum(name == "encode.enqueue" for name, _ in tree) - calls == reruns
    assert sum(name == "encode.h2d" for name, _ in tree) == calls
    assert sum(name == "encode.edge_pad" for name, _ in tree) == (calls if top is CORRECT else 0)


@pytest.mark.parametrize("max_slice_bytes,passes", [(None, 1), (8, 2)])
def test_rgb420_passes_count_the_colour_passes(tmp_path, monkeypatch, max_slice_bytes, passes):
    """One colour-and-subsampling pass a call, one more for a regrow's
    re-run, each an `encode.rgb420` span inside its `encode.enqueue`;
    the planes intakes make none."""
    monkeypatch.setattr(mpeg1, "rgb420_passes", 0)
    enc = TorchMPEG1IntraEncoder(quality=50, max_slice_bytes=max_slice_bytes, device="cpu")
    _, tree = _traced(tmp_path, lambda: enc.encode(_rgb()))
    assert mpeg1.rgb420_passes == passes
    assert _children(tree, "encode.enqueue") == ["encode.rgb420"] * passes
    enc.encode_from_planes(*_planes())
    enc.encode_from_coeffs(*_coeffs(), H, W)
    assert mpeg1.rgb420_passes == passes
    enc.encode(_rgb(seed=9))
    assert mpeg1.rgb420_passes == passes + 1


def _stage_names():
    """The literal names of every `stage_scope("...")` in the port."""
    pattern = re.compile(r'stage_scope\(\s*"([^"]+)"')
    return {m for path in PORT.rglob("*.py") for m in pattern.findall(path.read_text())}


def test_no_stage_span_ends_in_launch():
    names = _stage_names()
    assert set(CORRECT + COMPAT) | {"encode.intake", "encode.levels", "encode.rgb420",
                                    "encode.jpeg_decode"} == names
    assert not [n for n in names if n.endswith("_launch")]


@pytest.mark.parametrize("intake", ["planes", "rgb", "coeffs", "compat", "regrow"])
def test_no_span_is_built_with_the_profiler_off(monkeypatch, intake):
    def forbidden(name):
        raise AssertionError(f"span {name!r} built with the profiler off")

    monkeypatch.setattr(profiling, "record_function", forbidden)
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu",
                                 max_slice_bytes=8 if intake == "regrow" else None)
    {"planes": lambda: enc.encode_from_planes(*_planes()),
     "regrow": lambda: enc.encode_from_planes(*_planes()),
     "rgb": lambda: enc.encode(_rgb()),
     "coeffs": lambda: enc.encode_from_coeffs(*_coeffs(), H, W),
     "compat": lambda: encode_compat(_rgb(b=1, h=150, w=101), 12, device="cpu")}[intake]()
    assert intake != "regrow" or enc.max_slice_bytes > 8
