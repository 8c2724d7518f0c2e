"""The kernel build cache key: no nvcc needed.

A built library is reused while its key holds, so the key must change
whenever anything that goes into the build changes: the `.cu` source and
every shared header under `csrc/` (an edited header must rebuild every
kernel that includes it).
"""

import shutil

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
