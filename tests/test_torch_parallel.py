"""The port's `parallel/` against the JAX package's, on the CPU.

* `ShardedTorchMPEG1Encoder` on meshes of CPU entries (the five shapes of
  tests/test_sharding.py::test_sharded_matches_oracle) gives the bytes of
  the reference's numpy encoder; q=85 (the f32 DCT) the bytes of the
  unsharded port; the planes intake the reference's; `fuse=8`,
  `pack="fused"`, `debug_checks=True`, a forced regrow, uneven and short
  batches the unsharded bytes; frames of 117 x 59 are padded on the host
  (`pad_sites["host"]`) and keep those bytes.  Every shard runs the pipeline once a
  batch, its slice headers numbered from its first MB row
  (`or_slice_headers(first_row=)`, against the reference's whole-picture
  headers).  `encode_from_coeffs` raises NotImplementedError and an
  indivisible rows axis ValueError, with the reference's messages.
* `make_mesh`: the reference's error, CPU entries and repeats, and no CPU
  fallback (RuntimeError without CUDA).
* `encode_multihost` over gloo in two processes, and the fault drill
  (ports of tests/test_runtime.py's multi-process cases, on
  device="cpu"), byte-equal to the JAX package's numpy single-process
  encode; one process without a process group.
* The CLI's `--mesh 2,2 --device cpu` equals the unsharded CLI.

Every child process and every rendezvous has its own time limit.
Tolerance: exact (equal bytes) everywhere.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.models import mpeg1 as ref_mpeg1
from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu.ops.color import rgb_to_ycbcr_studio
from ec504_imageencoder_tpu.ops.color import subsample_420 as ref_subsample_420
from ec504_imageencoder_tpu.parallel import mesh as ref_mesh_lib
from ec504_imageencoder_tpu.parallel.sharded_encoder import ShardedMPEG1Encoder
from ec504_imageencoder_tpu.syntax import headers as ref_headers
from ec504_imageencoder_tpu_torch import cli
from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.ops.bitpack import or_slice_headers
from ec504_imageencoder_tpu_torch.parallel import distributed
from ec504_imageencoder_tpu_torch.parallel import mesh as mesh_lib
from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import ShardedTorchMPEG1Encoder

ROOT = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT = 120   # seconds a child process may take
RENDEZVOUS_TIMEOUT = 60  # seconds init_process_group and the barrier may wait

SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)]


def _mesh(nd, nr):
    return mesh_lib.make_mesh(nd, nr, ["cpu"] * (nd * nr))


def _sharded(shape, **kw):
    return ShardedTorchMPEG1Encoder(mesh=_mesh(*shape), **kw)


@pytest.fixture(scope="module")
def frames(fixture_frames):
    return np.stack([fixture_frames["0"], fixture_frames["1"]] * 2)[:, :128, :192]


@pytest.fixture(scope="module")
def narrow(frames):
    """The same frames cut to 64 columns (8 MB rows of 4 MBs): the routes'
    cases, a third of the CPU work."""
    return np.ascontiguousarray(frames[:, :, :64])


@pytest.fixture(scope="module")
def reference_bytes(frames):
    enc = MPEG1IntraEncoder(quality=45, backend="numpy", max_slice_bytes=8192)
    return enc.encode(frames)


@pytest.fixture(scope="module")
def unsharded(narrow):
    """The unsharded port's bytes of `narrow` per (quality, keywords)."""
    cache = {}

    def get(quality, **kw):
        key = (quality, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = TorchMPEG1IntraEncoder(quality=quality, device="cpu",
                                                **kw).encode(narrow)
        return cache[key]

    return get


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_matches_oracle(frames, reference_bytes, shape):
    enc = _sharded(shape, quality=45, max_slice_bytes=8192)
    assert enc.encode(frames) == reference_bytes


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_high_quality_f32_dct(narrow, unsharded, shape):
    enc = _sharded(shape, quality=85)
    assert enc.dct_impl == "f32"  # the auto switch engaged
    assert enc.encode(narrow) == unsharded(85)


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_sharded_planes_intake_matches_reference(frames, shape):
    y, cb, cr = rgb_to_ycbcr_studio(frames, np)
    cbs, crs = ref_subsample_420(cb, np), ref_subsample_420(cr, np)
    host = MPEG1IntraEncoder(quality=45, backend="numpy").encode_from_planes(y, cbs, crs)
    assert _sharded(shape, quality=45).encode_from_planes(y, cbs, crs) == host


ROUTES = {
    "fuse=8": dict(quality=50, fuse=8),
    "pack=fused": dict(quality=50, pack="fused"),
    "pack=fused q=85": dict(quality=85, pack="fused"),
    "debug_checks": dict(quality=50, debug_checks=True),
    "debug_checks q=85": dict(quality=85, debug_checks=True),
}


@pytest.mark.parametrize("shape", [(2, 2), (1, 8)])
@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_routes_match_unsharded(narrow, unsharded, route, shape):
    kw = ROUTES[route]
    enc = _sharded(shape, **kw)
    assert enc.encode(narrow) == unsharded(kw["quality"])


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_regrow(narrow, unsharded, shape):
    """An 8 B starting buffer overflows; one regrow lands on every shard
    and the bytes are the unsharded encoder's."""
    enc = _sharded(shape, quality=45, max_slice_bytes=8)
    assert enc.encode(narrow) == unsharded(45)
    assert enc.max_slice_bytes > 8


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("entry", ["encode", "encode_from_planes"])
@pytest.mark.parametrize("h,w", [(117, 59), (128, 64)])
def test_sharded_encoder_pads_on_the_host(frames, monkeypatch, shape, entry, h, w):
    """The sharded encoder cuts its slabs by macroblock rows on the host,
    so it pads there (`np.pad`) before any copy: 117 x 59 frames (rows
    and columns, odd chroma) give the bytes of the JAX package's numpy
    encoder and of the unsharded port, which pads on its device; each
    call counts one host pad and no device pad.  Aligned frames pad
    nowhere."""
    monkeypatch.setattr(mpeg1, "pad_sites", Counter())
    clip = np.ascontiguousarray(frames[:, :h, :w])
    arrays = ((clip,) if entry == "encode" else
              tuple(np.ascontiguousarray(p) for p in (clip[..., 0], clip[:, ::2, ::2, 1],
                                                      clip[:, ::2, ::2, 2])))
    want = getattr(MPEG1IntraEncoder(quality=45, backend="numpy"), entry)(*arrays)
    enc = _sharded(shape, quality=45)
    for calls in (1, 2):
        assert getattr(enc, entry)(*arrays) == want
        assert mpeg1.pad_sites == ({"host": calls} if (h, w) != (128, 64) else {})
    single = TorchMPEG1IntraEncoder(quality=45, device="cpu")
    assert getattr(single, entry)(*arrays) == want
    assert mpeg1.pad_sites == ({"host": 2, "device": 1} if (h, w) != (128, 64) else {})


@pytest.mark.parametrize("shape,batch", [((2, 2), 3), ((8, 1), 1), ((4, 2), 5)])
def test_uneven_and_short_batches(narrow, shape, batch):
    """The batch splits unevenly over `data` (no padding frames); a data
    shard with no frame is skipped; GOP numbering follows first_frame_index."""
    clip = np.concatenate([narrow, narrow[:1]])[:batch]
    enc = _sharded(shape, quality=45, gop_size=2)
    want = TorchMPEG1IntraEncoder(quality=45, gop_size=2, device="cpu")
    assert enc.encode(clip, first_frame_index=3) == want.encode(clip, first_frame_index=3)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (3, 1)])
def test_one_pipeline_run_per_shard(narrow, shape, monkeypatch):
    """Each non-empty shard runs the device pipeline once per batch, on its
    own band of MB rows, numbered from the band's first row."""
    calls = []
    forward = mpeg1.EncodeCore.forward

    def counted(self, y, cb, cr, msb, debug_checks=False, first_row=0):
        calls.append((y.shape[0], y.shape[1] // 16, first_row))
        return forward(self, y, cb, cr, msb, debug_checks, first_row)

    monkeypatch.setattr(mpeg1.EncodeCore, "forward", counted)
    nd, nr = shape
    _sharded(shape, quality=45, max_slice_bytes=8192).encode(narrow)
    band = 8 // nr
    sizes = [len(c) for c in np.array_split(np.arange(4), nd) if len(c)]
    assert sorted(calls) == sorted((b, band, j * band) for b in sizes for j in range(nr))


def test_one_core_per_distinct_device():
    enc = _sharded((4, 2), quality=45)
    assert list(enc.cores) == [torch.device("cpu")] and enc.cores[enc.device] is enc.core


def test_encode_from_coeffs_raises_as_reference():
    ref = ShardedMPEG1Encoder(quality=45, backend="jax", mesh=ref_mesh_lib.make_mesh(4, 2))
    with pytest.raises(NotImplementedError) as want:
        ref.encode_from_coeffs(None, None, None, 0, 0)
    with pytest.raises(NotImplementedError) as got:
        _sharded((4, 2), quality=45).encode_from_coeffs(None, None, None, 0, 0)
    assert str(got.value) == str(want.value)


def test_rows_divisibility_error_equals_reference(frames):
    ref = ShardedMPEG1Encoder(quality=45, backend="jax", mesh=ref_mesh_lib.make_mesh(1, 3))
    with pytest.raises(ValueError) as want:
        ref.encode(frames)
    with pytest.raises(ValueError) as got:
        _sharded((1, 3), quality=45).encode(frames)
    assert str(got.value) == str(want.value)
    assert "8 MB rows" in str(got.value)


@pytest.mark.parametrize("first_row,n", [(0, 6), (0, 3), (3, 3), (2, 2), (5, 1)])
def test_or_slice_headers_first_row_equals_reference(first_row, n):
    """A band of MB rows numbered from first_row gets the bytes that the
    reference's whole-picture header OR writes there."""
    rng = np.random.default_rng(11)
    seg = rng.integers(0, 256, (2, 6, 16), dtype=np.uint8)
    seg[..., :4] = 0
    seg[..., 4] &= 0x03  # the pack leaves the 38 header bits zero
    want, _ = ref_mpeg1._or_slice_headers(seg.copy(), None, 2, 6, 12, np)
    band = torch.from_numpy(seg[:, first_row:first_row + n].copy())
    got = or_slice_headers(band, 12, first_row=first_row)
    assert np.array_equal(got.numpy(), want[:, first_row:first_row + n])


# ---- mesh.py ----------------------------------------------------------------


def test_make_mesh_shapes_and_errors():
    m = mesh_lib.make_mesh(2, 3, ["cpu"] * 7)
    assert m.shape == {"data": 2, "rows": 3}
    assert len(m.devices) == 2 and all(len(r) == 3 for r in m.devices)
    assert m.distinct_devices() == [torch.device("cpu")]
    assert mesh_lib.make_mesh(None, 2, ["cpu"] * 5).shape == {"data": 2, "rows": 2}
    with pytest.raises(ValueError) as got:
        mesh_lib.make_mesh(4, 2, ["cpu"] * 7)
    with pytest.raises(ValueError) as want:
        ref_mesh_lib.make_mesh(4, 2, list(range(7)))
    assert str(got.value) == str(want.value)
    assert (mesh_lib.DATA_AXIS, mesh_lib.ROWS_AXIS) == (ref_mesh_lib.DATA_AXIS,
                                                         ref_mesh_lib.ROWS_AXIS)


def test_make_mesh_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh_lib.make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        mesh_lib.make_mesh(1, 1, ["cuda:0"])
    with pytest.raises(RuntimeError, match="is_available"):
        ShardedTorchMPEG1Encoder(quality=45)


@pytest.mark.parametrize("batch,n_data", [(16, 2), (5, 2), (3, 4), (1, 8), (7, 3)])
def test_split_batch_is_tensor_split(batch, n_data):
    want = [len(t) for t in torch.tensor_split(torch.arange(batch), n_data)]
    assert [e - s for s, e in mesh_lib.split_batch(batch, n_data)] == want


def test_sharded_tensor_gathers_rows_then_frames():
    full = torch.arange(5 * 6 * 4).reshape(5, 6, 4)
    grid = [[full[b0:b1, r:r + 2] for r in (0, 2, 4)] for b0, b1 in ((0, 3), (3, 5))]
    st = mesh_lib.ShardedTensor(grid)
    assert torch.equal(st.cpu(), full)
    assert torch.equal(st[:, :, :3].cpu(), full[:, :, :3])


# ---- distributed.py ---------------------------------------------------------

_CHILD_HEAD = r"""
import os, sys
sys.path.insert(0, __REPO__)
sys.modules["jax"] = None  # the port runs without JAX
sys.modules["ec504_imageencoder_tpu"] = None
import numpy as np
import torch.distributed as dist
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.parallel.distributed import encode_multihost, init_distributed
pid, nproc, workdir, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
assert init_distributed("127.0.0.1:__PORT__", nproc, pid, timeout=__TIMEOUT__) == (pid, nproc)
rng = np.random.default_rng(0)  # same frames on every process
"""

_MULTIPROC_SCRIPT = _CHILD_HEAD + r"""
frames = rng.integers(0, 256, (4, 64, 80, 3), dtype=np.uint8)
enc = TorchMPEG1IntraEncoder(quality=40, gop_size=1, device="cpu")
n = encode_multihost(lambda s, e: frames[s:e], 4, workdir, out, encoder=enc)
print("RESULT", pid, n)
dist.destroy_process_group()
"""

_FAULT_SCRIPT = _CHILD_HEAD + r"""
log = sys.argv[5]
frames = rng.integers(0, 256, (6, 64, 80, 3), dtype=np.uint8)

calls = []
def source(s, e):
    if os.environ.get("EC504_DRILL") == "die" and pid == 1 and calls:
        os._exit(42)  # hard kill mid-encode: after GOP 1, before 3 starts
    calls.append((s, e))
    with open(log, "a") as f:
        f.write("%d %d %d\n" % (pid, s, e))
    return frames[s:e]

enc = TorchMPEG1IntraEncoder(quality=40, gop_size=1, device="cpu")
if os.environ.get("EC504_DRILL") and pid == 0:
    # phase 1, surviving process: encode own GOPs, then the job is torn
    # down before the barrier (preemption semantics) - no stitch yet
    from ec504_imageencoder_tpu_torch.runtime.checkpoint import CheckpointedEncode
    sess = CheckpointedEncode(workdir, enc, 6)
    sess.manifest_path = os.path.join(workdir, "manifest_0.json")
    sess.segments = {}
    sess._load_manifest()
    for g in range(sess.n_gops()):
        if g % nproc == 0 and g not in sess.segments:
            s, e = sess.gop_frame_range(g)
            sess.encode_gop(g, source(s, e))
    # wait until process 1 has banked its first GOP, so the drill state
    # is deterministic, then tear down without a barrier
    import time
    deadline = time.time() + 60
    while not os.path.exists(os.path.join(workdir, "seg_000001.m1vseg")):
        if time.time() > deadline:
            os._exit(3)
        time.sleep(0.05)
    os._exit(0)  # preemption semantics
n = encode_multihost(source, 6, workdir, out, encoder=enc)
print("RESULT", pid, n)
dist.destroy_process_group()
"""


def _fresh_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text.replace("__PORT__", str(_fresh_port()))
                    .replace("__REPO__", repr(str(ROOT)))
                    .replace("__TIMEOUT__", str(RENDEZVOUS_TIMEOUT)))
    return str(path)


def _run_two_procs(script, *args, env=None):
    full_env = dict(os.environ, **(env or {}))
    procs = [subprocess.Popen([sys.executable, script, str(pid), "2", *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=full_env)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def _reference_encode(n):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n, 64, 80, 3), dtype=np.uint8)
    enc = MPEG1IntraEncoder(quality=40, gop_size=1, backend="numpy")
    return enc.encode(frames) + ref_headers.sequence_end()


def test_multiprocess_two_processes(tmp_path):
    wd, out = tmp_path / "wd", tmp_path / "out.mpeg"
    procs, outs = _run_two_procs(_script(tmp_path, "mp.py", _MULTIPROC_SCRIPT), wd, out)
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    want = _reference_encode(4)
    assert outs[0][0].decode().split() == ["RESULT", "0", str(len(want))]
    assert outs[1][0].decode().split() == ["RESULT", "1", "None"]
    assert out.read_bytes() == want


def test_multihost_fault_drill(tmp_path):
    """Kill one process mid-encode, restart the job, and assert only the
    missing GOPs re-encode and the stitched stream is byte-identical to a
    single-process encode."""
    wd, out, log = tmp_path / "wd", tmp_path / "out.mpeg", tmp_path / "encodes.log"

    # phase 1: process 1 dies after encoding GOP 1 (of its share 1,3,5);
    # process 0 finishes its share (0,2,4) and the job tears down
    procs, outs = _run_two_procs(_script(tmp_path, "p1.py", _FAULT_SCRIPT), wd, out, log,
                                 env={"EC504_DRILL": "die"})
    assert procs[0].returncode == 0, outs[0][1].decode()[-2000:]
    assert procs[1].returncode == 42, outs[1][1].decode()[-2000:]
    assert not out.exists()  # no stitched stream yet
    segs = sorted(f for f in os.listdir(wd) if f.endswith(".m1vseg"))
    assert segs == [f"seg_00000{g}.m1vseg" for g in (0, 1, 2, 4)]

    # phase 2: plain restart, same workdir, fresh rendezvous
    procs, outs = _run_two_procs(_script(tmp_path, "p2.py", _FAULT_SCRIPT), wd, out, log)
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]

    # only the dead process's missing GOPs (3, 5) were re-encoded
    phase2 = [tuple(map(int, ln.split())) for ln in log.read_text().splitlines()][4:]
    assert sorted(phase2) == [(1, 3, 4), (1, 5, 6)], phase2
    assert out.read_bytes() == _reference_encode(6)


def test_single_process_without_a_group(tmp_path):
    """No process group: rank 0 of 1, a no-op barrier, and the stream of one
    encode; the default encoder runs on "cuda" and raises without it."""
    assert distributed.init_distributed() == (0, 1)
    assert distributed.process_index_count() == (0, 1)
    distributed.barrier("noop")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 64, 80, 3), dtype=np.uint8)
    enc = TorchMPEG1IntraEncoder(quality=40, gop_size=1, device="cpu")
    n = distributed.encode_multihost(lambda s, e: frames[s:e], 4, str(tmp_path / "wd"),
                                     str(tmp_path / "o.mpeg"), encoder=enc)
    assert (tmp_path / "o.mpeg").read_bytes() == _reference_encode(4) and n == len(
        _reference_encode(4))
    with pytest.raises(RuntimeError, match="is_available"):
        distributed.encode_multihost(lambda s, e: frames[s:e], 4, str(tmp_path / "wd2"),
                                     str(tmp_path / "o2.mpeg"))


# ---- the CLI's --mesh ------------------------------------------------------


@pytest.fixture(scope="module")
def small_folder(tmp_path_factory, fixture_frames):
    """Five 96 x 112 crops of the fixture frames, 4:2:0, quality 90 (6 MB rows)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("small")
    for i in range(5):
        crop = fixture_frames[str(i % 3)][i * 7:i * 7 + 96, i * 5:i * 5 + 112]
        Image.fromarray(np.ascontiguousarray(crop)).save(d / f"f{i}.jpg", quality=90,
                                                         subsampling=2)
    return d


def _cli(argv):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        assert cli.main([str(a) for a in argv]) == 0
    return err.getvalue()


@pytest.mark.parametrize("flags", [[], ["--stream", "--intake", "ycbcr"], ["-q", "85"]],
                         ids=["rgb", "ycbcr stream", "q85"])
def test_cli_mesh_equals_unsharded(small_folder, tmp_path, flags):
    base = [small_folder, "--device", "cpu", "--batch", 3, *flags]
    _cli([*base, "-o", tmp_path / "one.mpeg"])
    report = _cli([*base, "-o", tmp_path / "mesh.mpeg", "--mesh", "2,2", "--metrics"])
    assert (tmp_path / "mesh.mpeg").read_bytes() == (tmp_path / "one.mpeg").read_bytes()
    assert '"n_devices": 1' in report


def test_cli_mesh_rejects_indivisible_rows(small_folder, tmp_path):
    with pytest.raises(ValueError, match="not divisible by the rows mesh axis"):
        _cli([small_folder, "--device", "cpu", "--mesh", "1,4", "-o", tmp_path / "o.mpeg"])
