"""The port's library surface covers the JAX package's.

Every public top-level function and class of every module of
`ec504_imageencoder_tpu/`, and every public method of its public classes,
has a counterpart in `ec504_imageencoder_tpu_torch/`: a definition of the
same name in the mirror module (the same path, or the one `MIRRORS`
names), or an entry of `COUNTERPARTS`, which names the port's function,
class or method that does that work.  No entry says a name is not needed.

AST only: neither package is imported, so the test is fast and runs
anywhere.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "ec504_imageencoder_tpu"
PORT = ROOT / "ec504_imageencoder_tpu_torch"

# reference module -> the port's module of the same role, where the name differs
MIRRORS = {
    "ops/jpeg_tpu.py": "ops/jpeg_device.py",
    "ops/mxu_lut.py": "ops/cuda_lut.py",
}

# (reference module, name) -> (port module, counterpart, what does the work)
COUNTERPARTS = {
    # the Pallas VLC kernels and their layout helpers -> the CUDA kernels' wrappers
    ("ops/pallas_vlc.py", "vlc_slots_tpu"): (
        "ops/cuda_vlc_levels.py", "vlc_levels4", "B3: levels -> VLC slots"),
    ("ops/pallas_vlc.py", "vlc_from_blocks_tpu"): (
        "ops/cuda_vlc_raw.py", "vlc_raw", "B6a: raw slots from the planes"),
    ("ops/pallas_vlc.py", "vlc_fused_slots_from_blocks_tpu"): (
        "ops/cuda_vlc.py", "vlc_fused4", "B1: 4:1 fused slots from the planes"),
    ("ops/pallas_vlc.py", "vlc_fused8_slots_from_blocks_tpu"): (
        "ops/cuda_vlc.py", "vlc_fused8", "B6b: 8:1 fused slots from the planes"),
    ("ops/pallas_vlc.py", "vlc_compat_slots_from_blocks_tpu"): (
        "ops/cuda_vlc_compat.py", "vlc_compat_slots", "B4a: compat raw slots"),
    ("ops/pallas_vlc.py", "vlc_compat_fused_slots_from_blocks_tpu"): (
        "ops/cuda_vlc_compat.py", "vlc_compat_fused4", "B4b: compat 4:1 fused slots"),
    ("ops/pallas_vlc.py", "fuse_slots_streamwise"): (
        "ops/bitpack.py", "fuse4", "4:1 slot fusion in stream order"),
    ("ops/pallas_vlc.py", "fused_stack_to_stream"): (
        "ops/cuda_vlc.py", "vlc_fused4", "B1 stores its fused slots in stream order"),
    ("ops/pallas_vlc.py", "fused8_stack_to_stream"): (
        "ops/cuda_vlc.py", "vlc_fused8", "B6b stores its fused slots in stream order"),
    ("ops/pallas_vlc.py", "slot_violations"): (
        "ops/vlc_device.py", "slot_violations", "the slot invariant count"),
    ("ops/pallas_vlc.py", "blocks_to_px64"): (
        "ops/cuda_vlc.py", "vlc_fused4", "TPU layout: the kernels read the planes"),
    ("ops/pallas_vlc.py", "px64_to_packed16"): (
        "ops/cuda_vlc.py", "vlc_fused4", "TPU layout: the kernels read the planes"),
    # the Pallas pack kernels -> the CUDA pack kernels' wrappers
    ("ops/pallas_pack.py", "pack_words_pallas"): (
        "ops/cuda_pack.py", "pack_raw", "K1: raw-code pack"),
    ("ops/pallas_pack.py", "pack_bytes_pallas"): (
        "ops/cuda_pack.py", "pack_raw", "K1 writes the big-endian bytes"),
    ("ops/pallas_pack.py", "pack_words_pallas2"): (
        "ops/cuda_pack.py", "pack_raw", "B6e: one kernel with K1"),
    ("ops/pallas_pack.py", "pack_words_pallas3"): (
        "ops/cuda_pack_split.py", "pack_windows", "K3: two-level pack"),
    ("ops/pallas_pack.py", "pack_words_fused"): (
        "ops/cuda_pack_split.py", "pack_split", "K4: one-pass pack"),
    ("ops/pallas_pack.py", "pack_words_fused2w"): (
        "ops/cuda_pack.py", "pack_pairs", "K2: 2:1 pair pack"),
    ("ops/pallas_pack.py", "pack_words_fused4"): (
        "ops/cuda_pack.py", "pack_fused4", "B2: 4:1 fused-slot pack"),
    ("ops/pallas_pack.py", "pack_words_fused4_core"): (
        "ops/cuda_pack.py", "pack_fused4", "B2 takes the fused slots"),
    ("ops/pallas_pack.py", "pack_words_fused8"): (
        "ops/cuda_pack.py", "pack_fused8", "B6c: 8:1 fused-slot pack"),
    ("ops/pallas_pack.py", "pack_words_fused8_core"): (
        "ops/cuda_pack.py", "pack_fused8", "B6c takes the fused slots"),
    # the MXU one-hot lookups -> the lookup kernel B5 and the port's tables
    ("ops/mxu_lut.py", "onehot_lookup_packed"): (
        "ops/cuda_lut.py", "lut_lookup", "B5: small-table lookup"),
    ("ops/mxu_lut.py", "onehot_lookup_u32"): (
        "ops/cuda_lut.py", "lut_lookup", "TPU layout: one-hot matmul lookup"),
    ("ops/mxu_lut.py", "packed_lookup_matrix"): (
        "ops/cuda_lut.py", "lut_lookup", "TPU layout: B5 reads the packed table itself"),
    ("ops/mxu_lut.py", "ac_packed_table"): (
        "utils/tables.py", "ac_packed_table", "the packed AC table"),
    # the TPU layout forms of the host-visible ops
    ("ops/dct.py", "aan_dct_nb"): (
        "ops/dct.py", "aan_dct", "TPU layout: blocks on lanes"),
    ("ops/color.py", "pack_rgbx_u32"): (
        "ops/color.py", "rgb_to_ycbcr", "TPU layout: RGB as packed u32"),
    ("ops/color.py", "rgb_to_ycbcr_packed"): (
        "ops/color.py", "rgb_to_ycbcr", "TPU layout: RGB as packed u32"),
    ("ops/bitpack.py", "words_be_to_bytes"): (
        "ops/cuda_pack.py", "pack_fused8", "B6c writes the big-endian bytes"),
    ("ops/bitpack.py", "pack_words_mxu"): (
        "ops/bitpack.py", "pack_words", "TPU layout: one-hot matmul pack"),
    ("ops/bitpack.py", "pack_bytes_device"): (
        "models/mpeg1.py", "EncodeCore", "the pack= keyword picks the pack kernel"),
    # GSPMD's shardings -> the port's explicit split and gather
    ("parallel/mesh.py", "frame_sharding"): (
        "parallel/mesh.py", "shard_host", "frames over data, MB rows over rows"),
    ("parallel/mesh.py", "segment_sharding"): (
        "parallel/mesh.py", "ShardedTensor", "per-shard slice buffers, gathered"),
    ("parallel/mesh.py", "bits_sharding"): (
        "parallel/mesh.py", "ShardedTensor", "per-shard bit counts, gathered"),
    ("parallel/mesh.py", "replicated"): (
        "parallel/sharded_encoder.py", "ShardedTorchMPEG1Encoder",
        "the quantizer on every device: one EncodeCore per distinct device"),
    # the encoders, under the port's class names
    ("models/mpeg1.py", "MPEG1IntraEncoder"): (
        "models/mpeg1.py", "TorchMPEG1IntraEncoder", "the correct-mode encoder"),
    ("parallel/sharded_encoder.py", "ShardedMPEG1Encoder"): (
        "parallel/sharded_encoder.py", "ShardedTorchMPEG1Encoder", "the sharded encoder"),
    ("models/encoder.py", "compat_pipeline"): (
        "models/encoder.py", "CompatCore", "the compat device pipeline"),
    ("models/encoder.py", "compat_blockize_px64"): (
        "ops/cuda_vlc_compat.py", "compat_blockize", "the compat crop blockize"),
    # the wall-clock stage timer -> spans on the profiler's clock
    ("utils/profiling.py", "WallTimer"): (
        "utils/profiling.py", "stage_scope", "a stage's time: its span in the trace"),
    ("utils/profiling.py", "WallTimer.stage"): (
        "utils/profiling.py", "stage_scope", "one named stage, timed by the profiler"),
    ("utils/profiling.py", "WallTimer.report"): (
        "utils/profiling.py", "device_trace", "the trace holds every stage's times"),
}


def _public(path: Path) -> set[str]:
    """Public top-level functions and classes of the module at path, and
    "Class.method" for the public methods of its public classes."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and \
                not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{m.name}" for m in node.body
                             if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and not m.name.startswith("_"))
    return names


def _port_defines(module: str, name: str) -> bool:
    path = PORT / module
    return path.exists() and name in _public(path)


REFERENCE_MODULES = sorted(str(p.relative_to(REFERENCE)) for p in REFERENCE.rglob("*.py"))


def _counterpart(module: str, name: str) -> tuple[str, str]:
    """The port module and name that must define the reference's `name`."""
    cls, _, method = name.partition(".")
    if (module, name) in COUNTERPARTS:
        port_module, port_name, _ = COUNTERPARTS[(module, name)]
        return port_module, port_name
    if method and (module, cls) in COUNTERPARTS:  # a method of a renamed class
        port_module, port_cls, _ = COUNTERPARTS[(module, cls)]
        return port_module, f"{port_cls}.{method}"
    return MIRRORS.get(module, module), name


def test_the_reference_has_modules():
    assert len(REFERENCE_MODULES) > 30 and "ops/bitpack.py" in REFERENCE_MODULES


@pytest.mark.parametrize("module", REFERENCE_MODULES)
def test_every_public_name_has_a_counterpart(module):
    missing = [(name, *_counterpart(module, name)) for name in sorted(_public(REFERENCE / module))
               if not _port_defines(*_counterpart(module, name))]
    assert not missing, f"{module}: (name, port module, counterpart) without a definition: {missing}"


@pytest.mark.parametrize("key", sorted(COUNTERPARTS), ids=[f"{m}::{n}" for m, n in
                                                          sorted(COUNTERPARTS)])
def test_counterpart_table_entry(key):
    """Each entry names a reference name that has no mirror of its own and a
    counterpart that the port defines, with what it does."""
    module, name = key
    port_module, port_name, what = COUNTERPARTS[key]
    assert name in _public(REFERENCE / module), f"the reference has no {module}::{name}"
    assert not _port_defines(MIRRORS.get(module, module), name), \
        f"the port's mirror of {module} defines {name}: the entry is not needed"
    assert _port_defines(port_module, port_name), f"the port has no {port_module}::{port_name}"
    assert what


def test_new_mirrors_exist():
    """The modules this surface closed: the scalar oracles and the
    compaction."""
    assert _public(PORT / "ops/rle_vlc.py") >= {"rle_pairs", "compat_block_codes",
                                                "correct_block_codes", "mv_code"}
    assert _public(PORT / "models/oracle.py") == {"compat_frame_slice_bytes", "encode_compat"}
    assert _public(PORT / "ops/bitpack.py") >= {"compact_slices", "split_compact_slices",
                                                "pack_bytes"}
