"""The port never imports JAX, and chip_smoke.py has no CPU path.

Both run in subprocesses: tests/conftest.py imports JAX into this one.
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_NO_JAX = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import numpy as np
import ec504_imageencoder_tpu_torch.models.mpeg1 as m
import ec504_imageencoder_tpu_torch.ops.cuda_pack
import ec504_imageencoder_tpu_torch.ops.cuda_vlc
import ec504_imageencoder_tpu_torch.shared
frames = np.random.default_rng(0).integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
enc = m.TorchMPEG1IntraEncoder(quality=50, device="cpu")
es = enc.encode(frames)
es2 = enc.encode_from_planes(frames[..., 0], frames[:, ::2, ::2, 1], frames[:, ::2, ::2, 2])
assert es[:4] == es2[:4] == bytes([0, 0, 1, 0xB3])
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib")) for k in sys.modules
               if sys.modules[k] is not None)
print("OK", len(es), len(es2))
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
