"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Module names are compared by their
whole top-level name: the port's name begins with the JAX package's."""

from __future__ import annotations

import io
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT, cells

JAX_SIDE = {"jax", "jaxlib", "flax", "ec504_imageencoder_tpu"}
PORT = "ec504_imageencoder_tpu_torch"


def _loaded_after(code: str) -> set[str]:
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    top = _loaded_after("import portbench.reference.entries.encode_from_planes, "
                        "portbench.reference.entries.encode_from_coeffs, "
                        "portbench.reference.entries.encode_compat")
    assert not top & JAX_SIDE and PORT not in top


def test_a_whole_rehearsal_loads_no_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['run.py', '--workload', 'hd1080.q50.coeffs', '--seed', '3', "
            "'--seconds', '0.3', '--rehearse', '--trace', '1']\n"
            "try:\n    runpy.run_path('portbench/run.py', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n")
    top = _loaded_after(code)
    assert PORT in top and not top & JAX_SIDE


def test_the_harness_names_what_it_finds(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "ec504_imageencoder_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "ec504_imageencoder_tpu_torch.fake", object())
    assert harness.forbidden_modules() == ["ec504_imageencoder_tpu.fake", "jaxlib.fake"]


def _plant(monkeypatch, module: str, attr: str):
    """Make `module.attr` load a JAX module (by name) when it runs."""
    import importlib

    mod = importlib.import_module(module)
    real = getattr(mod, attr)

    def planted(*a, **k):
        monkeypatch.setitem(sys.modules, "jax.fake", object())
        return real(*a, **k)

    monkeypatch.setattr(mod, attr, planted)


@pytest.mark.parametrize("package,attr,trace", [
    ("portbench.reference.entries", "prepare", False),
    ("portbench.reference.entries", "expected", False),
    ("portbench.work", "least", True),
    ("portbench.layer_metrics", "read", True),
])
def test_jax_loaded_after_the_window_gives_no_result(monkeypatch, package, attr, trace):
    """The look for JAX comes after every module the run imports once the
    window has closed: the reference, the work counts, the metric readers."""
    from portbench import harness

    workload = cells()[0]
    spec = harness.load_cell(workload)
    name = spec["per_layer"][0]["name"] if package == "portbench.layer_metrics" else spec["mix"]["entry"]
    _plant(monkeypatch, f"{package}.{name}", attr)
    err = io.StringIO()
    code, result = harness.run(workload, 2**31 + 21, 0.3, trace, rehearse=True, log=err)
    assert code == 3 and result is None and "jax.fake" in err.getvalue()
