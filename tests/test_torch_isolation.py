"""The port never imports JAX nor the JAX package (nor loads a library of
it: its JPEG decoder and C shim are its own g++ builds), and chip_smoke.py
has no CPU path.

The runs are subprocesses: tests/conftest.py imports JAX into this one.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ec504_imageencoder_tpu_torch"
REFERENCE = "ec504_imageencoder_tpu"

_NO_JAX = """
import importlib
import pkgutil
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
sys.modules["ec504_imageencoder_tpu"] = None  # and so does the JAX package
import numpy as np
import ec504_imageencoder_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, "ec504_imageencoder_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "ec504_imageencoder_tpu_torch.syntax.headers" in names
assert {"ec504_imageencoder_tpu_torch.ops.rle_vlc",
        "ec504_imageencoder_tpu_torch.models.oracle"} <= set(names)
import ec504_imageencoder_tpu_torch.models.encoder as c
import ec504_imageencoder_tpu_torch.models.mpeg1 as m
frames = np.random.default_rng(0).integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
enc = m.TorchMPEG1IntraEncoder(quality=50, device="cpu")
es = enc.encode(frames)
es2 = enc.encode_from_planes(frames[..., 0], frames[:, ::2, ::2, 1], frames[:, ::2, ::2, 2])
assert es[:4] == es2[:4] == bytes([0, 0, 1, 0xB3])
rng = np.random.default_rng(1)
yc, cc = (rng.integers(-64, 65, (2, n, 64)).astype(np.int16) for n in (15, 6))  # 24 x 40, 4:2:0
assert enc.encode_from_coeffs(yc, cc, cc, 24, 40)[:4] == es[:4]
assert m.TorchMPEG1IntraEncoder(quality=50, fuse=8, device="cpu").encode(frames) == es
for pack in m.PACKS:
    assert m.TorchMPEG1IntraEncoder(quality=50, pack=pack, device="cpu").encode(frames) == es
import torch
from ec504_imageencoder_tpu_torch.ops.bitpack import compact_slices, split_compact_slices
planes = [torch.from_numpy(p) for p in m.pad_planes_to_macroblocks(
    frames[..., 0], frames[:, ::2, ::2, 1], frames[:, ::2, ::2, 2])]
seg, bits = m.correct_pipeline_planes(enc.core, *planes, enc.max_slice_bytes)
dense, _ = compact_slices(seg, bits, 1 << 16)
assert enc.assemble(split_compact_slices(dense.numpy(), bits.numpy()), bits.numpy(), 40, 24) == es2
hq = m.TorchMPEG1IntraEncoder(quality=85, device="cpu")
assert hq.dct_impl == "f32" and hq.encode(frames)[:4] == es[:4]
for q in (50, 85):
    dbg = m.TorchMPEG1IntraEncoder(quality=q, debug_checks=True, device="cpu")
    want = m.TorchMPEG1IntraEncoder(quality=q, device="cpu").encode(frames)
    assert dbg.encode(frames) == want
mpeg, dumps = c.encode_compat(np.zeros((2, 144, 96, 3), np.uint8), 12, device="cpu")
assert mpeg[:4] == bytes([0, 0, 1, 0xBA]) and len(dumps) == 2
mpeg2, _ = c.encode_compat(np.zeros((2, 144, 96, 3), np.uint8), 12, device="cpu", debug_checks=True)
assert mpeg2 == mpeg
from ec504_imageencoder_tpu_torch.models import oracle
assert oracle.encode_compat(list(np.zeros((2, 144, 96, 3), np.uint8)), 12) == (mpeg, dumps)
from ec504_imageencoder_tpu_torch.models.decoder import decode_stream
from ec504_imageencoder_tpu_torch.parallel.mesh import make_mesh
from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import ShardedTorchMPEG1Encoder
from ec504_imageencoder_tpu_torch.syntax.headers import sequence_end
dec = decode_stream(es + sequence_end())
assert len(dec) == 2 and dec[0].shape == (24, 40, 3)
sharded = ShardedTorchMPEG1Encoder(quality=50, mesh=make_mesh(2, 2, ["cpu"] * 4))
assert sharded.encode(frames) == es
import os
import shutil
import tempfile
from ec504_imageencoder_tpu_torch import mpeg_encode_procedure
from ec504_imageencoder_tpu_torch import cli
from ec504_imageencoder_tpu_torch.io import jpeg
tmp = tempfile.mkdtemp()
os.mkdir(os.path.join(tmp, "imgs"))
for k in range(3):
    shutil.copy(f"tests/data/torch_jpegs/frame_{k}.jpg", os.path.join(tmp, "imgs"))
assert mpeg_encode_procedure(os.path.join(tmp, "imgs"), os.path.join(tmp, "bits"),
                             os.path.join(tmp, "out.mpeg"), 12, device="cpu") == 0
assert len(os.listdir(os.path.join(tmp, "bits"))) == 3
import contextlib
import io
with contextlib.redirect_stdout(io.StringIO()) as said:
    assert cli.main([os.path.join(tmp, "imgs"), "-o", os.path.join(tmp, "c.mpeg"), "--device",
                     "cpu", "--stream", "--intake", "coeffs", "--container", "ps"]) == 0
assert said.getvalue().startswith("wrote ")
shutil.rmtree(tmp)
assert "/ec504_imageencoder_tpu_torch/" in jpeg._load_native()._name
maps = open("/proc/self/maps").read()
assert "/ec504_imageencoder_tpu/" not in maps, "a file of the JAX package is mapped"
loaded = [k for k in sys.modules if sys.modules[k] is not None]
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib")) for k in loaded)
assert not any(k == "ec504_imageencoder_tpu" or k.startswith("ec504_imageencoder_tpu.")
               for k in loaded)
print("OK", len(names), len(es), len(es2))
"""


def _run(args, cwd, **kw):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=120, **kw)


def test_port_runs_with_jax_unimportable():
    proc = _run(["-c", _NO_JAX], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_needs_cuda():
    """Without a CUDA card (here, or with none visible) the script exits
    non-zero and prints no result: it has no CPU path."""
    proc = _run(["chip_smoke.py"], ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _imported_modules(path: Path):
    """(line, module) of every import statement in the file at `path`."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


_SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _SOURCES, ids=[str(p.relative_to(ROOT)) for p in _SOURCES])
def test_no_import_of_the_jax_package(path):
    """No module of the port, and not chip_smoke.py, imports the JAX
    package or anything in it (lazy imports inside functions included)."""
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod == REFERENCE or mod.startswith(REFERENCE + ".")
           or mod == "jax" or mod.startswith("jax.")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
