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
