#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's encode paths once on one GPU.

Run from the repository root on a machine with one CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Every encode on the card is held against the same encoder on the CPU
(`device="cpu"`, the kernels' plain twins) for the same frames, and
compat mode also against the reference C encoder's golden stream; the
CPU tests hold the CPU path byte-equal to the JAX package.  Each
configuration's CPU bytes are computed once and reused by every card
route that must equal them.

Phases (any failure raises and exits non-zero; there is no CPU path):

1. print the card's name and power limit (nvidia-smi) and build every
   CUDA kernel library from ec504_imageencoder_tpu_torch/csrc/, one nvcc
   per source, all at once (cold build time), then the three host
   libraries of io/native/ (the JPEG decoder, the C ABI shim and its JNI
   binding), one g++ each, all at once (cold build time);
2. kernel B1 (vlc_fused4) against its plain PyTorch twin on the card, on
   16 x 1080p planes of natural content, on 1000 x 1400 noise (padded to
   1408: 528 blocks a slice row, a half-warp in B1's last group of 128, as
   1080p's 720 leave one), and on 2 x 1080p flat planes (every AC level 0)
   and checkerboards (the last zigzag level nonzero): exact;
3. kernel B2 (pack_fused4) against its twin on those slots, including a
   slice buffer that overflows and one too large for shared memory, and on
   the 16 x 1080p slots with each plane one element off its alignment (no
   vector loads) and cut to one B2 tile -1, +0 and +1 slots (the last not
   a multiple of the slots per thread), each with the auto buffer, 7 words
   (overflows) and the 342,528 B one: exact;
4. the q=50 main path: TorchMPEG1IntraEncoder(quality=50, device="cuda")
   .encode() and .encode_from_planes() on 16 x 1080p frames, plus a forced
   slice regrow, byte-equal to the CPU path; the B1 and B2 launch counts,
   reset just before, went up;
5. steady-state times with CUDA events: B1 and B2 against their twins
   (B2 also as the profiler's device time), and q=50 encode() /
   encode_from_planes() in frames/s with every output byte fetched to the
   host;
6. the f32 levels kernel (f32_levels) against its twin on the 16 x
   1080p planes at q=85 and the 2 x 1000 x 1400 noise (padded to 1008 x
   1408) at q=100: exact; kernel B3 (vlc_levels4) against its twin: 16 x
   1080p at q=85 (levels computed once on the card by the f32 levels
   kernel), 2 x 1000 x 1400 noise
   at q=100 (28-bit escapes), the flat planes and checkerboards of phase 2
   at q=100, and the noise's levels with each block's largest AC level
   moved to the last slot and the others cleared (runs of 62, escapes):
   exact;
7. kernels B4a (vlc_compat_slots) and B4b (vlc_compat_fused4) against
   their twins on the 30 golden frames and on 480 frames of 400 x 600
   (16 copies of the golden sequence), and at q=12 and q=100 on 1 golden
   frame, 30 noise frames of odd width, 30 flat and checkerboard frames
   and 2 noise frames each of widths 601, 602 and 610 (rows read as bytes)
   (the last group of 128 blocks holds 68, 120, 8 or all): exact; the
   compat colour kernel (compat_color) against the host f64 colour
   (rgb_to_ycbcr_exact) on the 30 golden frames, the 480 frames and 30
   noise frames of 150 x 101 (the scalar path): exact;
8. the q=85 path (f32 DCT): encode() and encode_from_planes() on the 16 x
   1080p frames byte-equal to the CPU path; the same bytes for 16 frames
   at once, 2 x 8 and 16 x 1 (first_frame_index), and with TF32 matmuls
   allowed; dct_impl="aan" at q=85 byte-equal to the CPU path; the f32
   levels, B3 and B2 launch counts went up (the f32 levels kernel once a
   B3 launch, that is once a call) and B1's did not;
9. compat mode: encode_compat(device="cuda") equals the golden stream and
   .bit dump md5s on the 30 golden frames, also with debug_checks (raw
   slots through B4a, then B2's checked form), and equals the CPU path's
   encode_compat on the 480 frames; the B4b and B4a launch counts went up,
   and the colour kernel's by one a call;
10. times: the f32 levels kernel, B3, B4b and B4a against their twins
   (the f32 levels kernel beside its f32 instruction bound; B4b and B4a also as
   the profiler's device time, beside their bound), the compat colour at
   30 and 480 frames of 400 x 600 (events and device time, beside its
   bytes bound; its twin at 30 frames), q=85
   encode()/encode_from_planes() and compat encode_compat() in frames/s;
11. kernel B6a (vlc_raw, the sanitizer's raw slots) against its twin on
   phase 2's planes (16 x 1080p, the 1000 x 1400 noise padded to 1408,
   2 x 1080p flat planes) at q=50, on the noise and the checkerboards at
   q=100 (escapes) and on checkerboards whose AAN levels at q=5 are the
   last slot alone (runs of 62): exact;
12. kernel B5 (lut_lookup) against its twin on the AC rank indices of the
   16 x 1080p q=85 levels and on random indices in and around both
   packed tables: exact;
13. B2's checked form (pack_fused4 checks=True) against the unchecked
   kernel and its twin: equal bytes and 0 violations on healthy slots
   (phase 3's cases), the twin's exact counts for fused lengths of 200
   and 129 (also at the first slot of a row's last tile and the last slot
   of its first tile, aligned and not), counts > 0 on injected
   overlapping bits;
14. the sanitizer: TorchMPEG1IntraEncoder(debug_checks=True) encode() and
   encode_from_planes() on the 16 x 1080p frames at q=50 (through B6a)
   and q=85 (through B5), byte-equal to the CPU bytes of phases 4 and 8;
   B6a / B5 and the checked B2 launch, B1, B3 and the unchecked B2 do
   not; a slot violation injected on the card raises RuntimeError;
15. times: B6a, B5 and the checked B2 against their twins (the checked
   B2 also as the profiler's device time), and the debug_checks
   encode()/encode_from_planes() in frames/s;
16. kernel B6b (vlc_fused8) against its twin on phase 11's planes, and
   kernel B6c (pack_fused8) against its twin on the slots of the 16 x
   1080p planes and the noise at q=50 with the auto buffer, an
   overflowing buffer and one too large for shared memory: exact;
17. the 8:1-fusion path: TorchMPEG1IntraEncoder(quality=50, fuse=8)
   encode() and encode_from_planes() on the 16 x 1080p frames and a
   forced regrow, byte-equal to the CPU bytes of phase 4; B6b and B6c
   launch, B1 and the unchecked B2 do not;
18. times: B6b and B6c against their twins, fuse=8 frames/s;
19. the raw-code pack kernels K1 (pack_raw), K2 (pack_pairs), K3
   (pack_windows) and K4 (pack_split) against their twins on the raw
   slots of the generic emission (`EncodeCore.raw_slots`) of the 16 x
   1080p planes at q=50 and of the 1000 x 1400 noise at q=100 (escapes),
   each with the auto buffer, a 2,560 B buffer that overflows and a
   342,528 B one (global memory for K1 and K2): exact, and equal to B2 on
   the same slots fused 4:1; K3 and K4 also on 1,088 rows of 46,080
   codes whose lengths are all 0, all 1, all 32, or carry runs of empty
   codes across their chunks and tiles, and on random rows of 4,095 codes
   (no 16-byte loads), each with the auto buffer, one of exactly the
   longest row's words and the 342,528 B one: exact; K1 and K2 also on
   1,088 rows of 511, 512 and 513 codes (their tile is 512) of random,
   all-1 and all-32 lengths, with a buffer of the used words, one of 7
   words (overflows) and the 342,528 B one, and on the 16 x 1080p raw
   slots one element off their alignment: exact;
20. the generic route, TorchMPEG1IntraEncoder(pack=...) for "pallas1",
   "pallas3", "fused" and "fused2w": encode(), encode_from_planes() and a
   forced regrow at q=50 byte-equal to the CPU bytes of phase 4, and
   pack="fused" at q=85 to those of phase 8; B5 and the chosen kernel
   launch, B1, B2, B3 and B6a do not;
21. times: K1-K4 against their twins, and the routes' frames/s;
22. the coefficients intake: a JPEG encoder's dequantized int16
   coefficients of phase 2's 16 x 1080p planes (scipy's orthonormal 8x8
   DCT, the Annex K tables at quality 75), a quarter of frame 0's luma
   blocks replaced by int16 extremes; the IDCT and edge padding on the card
   against the CPU's (exact); TorchMPEG1IntraEncoder.encode_from_coeffs on
   the card byte-equal to encode_from_planes on the card from the CPU
   IDCT's planes at q=50 (B1 and B2 launch), q=85 (B3 and B2), with fuse=8
   and with a forced regrow; the IDCT and padding stage's ms beside its
   bytes floor, and encode_from_coeffs against encode_from_planes in
   frames/s;
23. the entry points on JPEG folders made of the committed fixtures
   (tests/data/torch_jpegs, written by tools/make_torch_jpegs.py): the
   native decoder alone (RGB, planes, coefficients) in frames/s over 40
   1080p JPEGs; the CLI (`cli.main`) with --stream --batch 16 on the card
   with --intake ycbcr, coeffs and rgb at q=50 and ycbcr at q=85, each
   byte-equal to the same CLI with --device cpu (coeffs to ycbcr's CPU
   bytes), the rgb intake without --stream too, each with its launch
   counts (B1 and B2, or B3 and B2) and its --metrics split into decode_s
   and encode_s (a second run, timed); a --workdir run, cut back to its
   first GOP and resumed, byte-equal to the rgb stream; on 30 frames of
   400 x 600, mpeg_encode_procedure on the card (B4b and B2 launch; its
   wall time), on the CPU and through the C ABI shim (ctypes, running the
   CLI in a child process on the card): the stream and every .bit dump
   equal; --mode compat --debug-checks (B4a and the checked B2) equal
   too; a --profile trace, from the CLI in a process of its own, whose
   spans name the vlc_fused4 and pack_fused4 launches and which holds
   B1's and B2's kernels; a --container ps run on 4 copies of one 1080p
   JPEG, byte-equal to --device cpu (phase 24 decodes it);
24. (after phase 25) the port's decoder (models/decoder.py, host
   numpy), in worker processes while phase 26 runs: decode_stream of the 16 x 1080p
   rgb-intake streams at q=50 and q=85 (frame count, shapes, per-frame
   PSNR against the source frames, studio range both sides, gated on the
   floors that tools/decode_psnr_floor.py derives on the CPU, and the
   decoder's frames/s on the host), of phase 23's program stream, and of
   the compat golden stream (which no ISO decoder reads through: the
   reference's decoder stops at bit 4696 with CorruptStreamError, and the
   port's must stop there too); decode_es (the scalar oracle) against
   decode_stream on a small card-made stream; mpeg-decode-torch (the
   module, in a process of its own) on phase 23's program stream with -o
   as PPM and --psnr-ref on its JPEG folder, and once with the default
   format (PNG, or PPM with the reference's message where PIL is missing);
25. (before phase 24, so that its frames/s have the host to themselves)
   the sharded encoder (parallel/sharded_encoder.py) on meshes (1, 1),
   (1, 2), (1, 4), (2, 1) and (2, 2) of cuda:0: the 16 x 1080p frames
   (encode) and planes (encode_from_planes) at q=50 with fuse 4 and 8 and
   at q=85, byte-equal to the unsharded card bytes of phases 4, 8 and 17,
   each with one emission and one pack launch per shard; debug_checks and
   a forced regrow on (2, 2); (1, 3) raises the reference's ValueError (68
   MB rows); each mesh's frames/s between two readings of the unsharded
   rate; with two cards a (2, 1) mesh over both, run while the other card
   is current (hazard C-h5), else the multi-card claim is printed as
   unverified;
26. two processes on the one card: encode_multihost
   (parallel/distributed.py) over gloo on 127.0.0.1, both on cuda:0, 6
   1080p frames in GOPs of one, the stitched stream byte-equal to one
   process's encode, and its wall time; then the fault drill of
   tests/test_runtime.py: rank 1 dies after its first GOP, rank 0 banks
   its share, the job restarts and re-encodes only GOPs 3 and 5, and the
   stream is the same;
27. device-side slice compaction (after phase 26): phase 8's 16 x 1080p
   planes through correct_pipeline_planes at q=85 (B3, B2) and q=50 (B1,
   B2), compact_slices on the card at bench.py's capacity, the dense
   prefix fetched (rounded up to 65,536 words), split_compact_slices and
   assemble(rows) byte-equal to encode_from_planes; the card's dense
   words and offsets equal to compact_slices on CPU tensors of the same
   slices; compact_slices' ms beside its bytes floor and the two
   device-to-host copies (the dense prefix, the encoder's bucketed
   prefix) with their byte counts, recorded, not claimed.

The whole run's time is printed before the kernels line.  The line
before the last is a JSON summary of the kernels (time, twin time, least
time the card could take and what sets it, the time of one PyTorch call
computing the same function where there is one); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import io
import itertools
import json
import multiprocessing
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
BATCH, HEIGHT, WIDTH = 16, 1080, 1920
QUALITY = 50
HQ_QUALITY = 85
COMPAT_QUALITY = 12
COMPAT_COPIES = 16  # 480 frames of 400 x 600
JPEGS = ROOT / "tests" / "data" / "torch_jpegs"
HD_FRAMES = 40      # phase 23: 1080p JPEGs in the CLI's folder
ENTRY_COMPAT_FRAMES = 30

# The least time the card could take for a kernel's work: the
# larger of the bytes a function must move over the H100's 3.35 TB/s and
# its integer operations over the H100's 32-bit integer issue rate, 64
# add/shift/compare/multiply-add per SM per clock (CUDA C++ Programming
# Guide, compute capability 9.0) x 132 SMs x 1.98 GHz.
MEM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
# The f32 levels kernel's floor is its f32 instructions: 128 FMUL or FADD
# per SM per clock x 132 SMs x 1.98 GHz, and per 8x8 block 512 products
# d[v][y] * x[y][k], 4,096 products by d[u][k] and 64 chains of 63 adds
# (numpy's order: no two of them merge into an FMA).
F32_OPS_PER_S = 128 * 132 * 1.98e9
OPS_F32_LEVELS_BLOCK = 512 + 4096 + 64 * 63
# Integer operations per 8x8 block of the planes -> slots kernels: the AAN
# DCT (16 butterflies of 36 adds and multiplies, 64 descaling shifts),
# quantization (6 per coefficient) and the emission (4 per slot).
OPS_DCT_BLOCK = 16 * 36 + 64 + 64 * 6
OPS_EMIT_BLOCK = 64 * 4
OPS_PACK_SLOT = 30   # scan, window shifts and atomics of one fused slot
OPS_LOOKUP = 3       # bounds test, load, select


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _unaligned(torch, t):
    """t as a contiguous view one element into a larger tensor: its base is
    not aligned for the kernels' vector loads."""
    return torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)


def _frames(np, rng, n: int):
    """n 1080p frames of natural content: the three fixture images tiled
    to 1080 x 1920 and shifted per frame."""
    with np.load(ROOT / "tests" / "golden" / "fixture_rgb.npz") as z:
        imgs = [z[k] for k in sorted(z.files)]
    out = np.empty((n, HEIGHT, WIDTH, 3), np.uint8)
    for i in range(n):
        im = imgs[i % len(imgs)]
        reps = (-(-HEIGHT // im.shape[0]) + 1, -(-WIDTH // im.shape[1]) + 1, 1)
        tiled = np.tile(im, reps)
        dy, dx = (int(v) for v in rng.integers(0, im.shape[:2]))
        out[i] = tiled[dy:dy + HEIGHT, dx:dx + WIDTH]
    return out


def _golden(np):
    """The reference C encoder's 30 input frames, its stream and its .bit
    dump md5s (tests/golden)."""
    g = ROOT / "tests" / "golden"
    order = json.loads((g / "frame_order.json").read_text())["unique_ids"]
    with np.load(g / "fixture_rgb.npz") as z:
        frames = np.stack([z[k] for k in order])
    md5s = json.loads((g / "bit_dump_md5.json").read_text())
    return frames, (g / "awesome_video.mpeg").read_bytes(), md5s


def _pad_planes(np, y, cb, cr):
    ph, pw = -y.shape[1] % 16, -y.shape[2] % 16
    y = np.pad(y, ((0, 0), (0, ph), (0, pw)), mode="edge")
    c = ((0, 0), (0, y.shape[1] // 2 - cb.shape[1]), (0, y.shape[2] // 2 - cb.shape[2]))
    return y, np.pad(cb, c, mode="edge"), np.pad(cr, c, mode="edge")


def _pattern_planes(np, rng, content: str, n: int):
    """n 1080p frames of 4:2:0 planes, padded: "flat" (one value per frame
    and plane, so every AC level is 0), "checker" (a checkerboard of
    random contrast, so the last zigzag level is nonzero) or "last" (a
    checkerboard of contrast 100..110, whose AAN levels at q=5 are the
    last slot alone)."""
    h = HEIGHT + -HEIGHT % 16
    out = []
    for s in ((n, h, WIDTH), (n, h // 2, WIDTH // 2), (n, h // 2, WIDTH // 2)):
        if content == "flat":
            p = np.broadcast_to(rng.integers(0, 256, (n, 1, 1)), s)
        else:
            yy, xx = np.indices(s[1:])
            hi = 128 if content == "checker" else 111
            p = 128 + rng.integers(100, hi, (n, 1, 1)) * (((yy + xx) & 1) * 2 - 1)
        out.append(np.ascontiguousarray(p, dtype=np.uint8))
    return out


# JPEG Annex K tables K.1 (luminance) and K.2 (chrominance)
JPEG_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
             14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
             18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
             49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
JPEG_CHROMA = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
               24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32


def _jpeg_coeffs(np, planes, seed: int):
    """A JPEG encoder's dequantized coefficients of the 4:2:0 planes, as
    `io/jpeg.decode_coeffs_batch` gives them ((B, blocks, 64) int16,
    natural order, raster block order) for a HEIGHT x WIDTH frame: the
    orthonormal 8x8 DCT of each block minus 128, quantized by the Annex K
    tables scaled to quality 75, dequantized; a quarter of frame 0's luma blocks
    replaced by int16 extremes (-32768, -32767, 0, 32767)."""
    from scipy.fft import dctn

    rng = np.random.default_rng(seed)
    ch, cw = -(-HEIGHT // 2), -(-WIDTH // 2)
    out = []
    for plane, (ph, pw), table in zip(planes, ((HEIGHT, WIDTH), (ch, cw), (ch, cw)),
                                      (JPEG_LUMA, JPEG_CHROMA, JPEG_CHROMA)):
        bh, bw = -(-ph // 8), -(-pw // 8)
        px = plane[:, :bh * 8, :bw * 8].cpu().numpy().astype(np.float64) - 128
        blocks = px.reshape(-1, bh, 8, bw, 8).transpose(0, 1, 3, 2, 4)
        q = np.clip((np.array(table) * 50 + 50) // 100, 1, 255).reshape(8, 8)
        f = np.round(dctn(blocks, axes=(-2, -1), norm="ortho") / q) * q
        out.append(f.reshape(len(px), bh * bw, 64).astype(np.int16))
    y = out[0]
    pick = rng.random(y.shape[1]) < 0.25
    y[0, pick] = np.array([-32768, -32767, 0, 32767], np.int16)[
        rng.integers(0, 4, (int(pick.sum()), 64))]
    return out


def _flat(out):
    """A kernel's outputs as a flat tuple of tensors (B6b returns its 8
    word planes as a tuple beside the lengths)."""
    flat = []
    for t in out:
        flat.extend(t if isinstance(t, (tuple, list)) else (t,))
    return flat


def _max_abs_err(torch, got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(_flat(got), _flat(want)))


def _event_ms(torch, fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters: int):
    """Device time per call of fn() over `iters` calls, as "x ms" with the
    fewest records of any kernel or memset (iters unless the profiler lost
    some): each one's mean over its records, summed; "not measured" where
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        recs = [(e.device_time_total, e.count) for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0]
    except RuntimeError as err:
        print(f"torch.profiler: {err}")
        return "not measured"
    if not recs:
        return "not measured"
    ms = sum(us / n for us, n in recs) / 1e3
    return f"{ms:.4f} ms ({min(n for _, n in recs)} of {iters} launches recorded)"


def _frames_per_s(torch, fn, n_frames: int, reps: int) -> tuple[float, float]:
    """(frames/s, ms per call) of fn(), which returns host bytes."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    return n_frames * reps / dt, 1e3 * dt / reps


def _bound(nbytes: float, int_ops: float, f32_ops: float = 0.0) -> tuple[float, str]:
    """(least ms, "bytes", "operations" or "f32 operations")."""
    terms = {"bytes": nbytes / MEM_BYTES_PER_S, "operations": int_ops / INT_OPS_PER_S,
             "f32 operations": f32_ops / F32_OPS_PER_S}
    which = max(terms, key=terms.get)
    return 1e3 * terms[which], which


def _check_twin(torch, name, kernel, twin, args) -> int:
    got, want = kernel(*args), twin(*args)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, got, want)
    print(f"{name}: outputs {tuple(_flat(got)[0].shape)}, max_abs_err {err}")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    return err


def _check_launches(path: str, counts: dict, must_run, must_not_run=()) -> None:
    print(f"{path}: launches {counts}")
    for name in must_run:
        if counts[name] <= 0:
            raise AssertionError(f"{path} never launched {name}")
    for name in must_not_run:
        if counts[name] != 0:
            raise AssertionError(f"{path} launched {name}")


def _check_equal(name: str, got: bytes, want: bytes, what: str = "the CPU path") -> None:
    print(f"{name}: {len(got)} B, {what} {len(want)} B, equal {got == want}")
    if got != want:
        raise AssertionError(f"{name} differs from {what}")


def _jpeg_folder(folder: Path, names, n: int) -> Path:
    """A folder of n copies of the fixture JPEGs `names`, in turn."""
    folder.mkdir()
    for i in range(n):
        shutil.copy(JPEGS / names[i % len(names)], folder / f"img_{i:03d}.jpg")
    return folder


def _cli(argv) -> dict:
    """Run the port's CLI in this process; its --metrics report, if asked."""
    from ec504_imageencoder_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    text = "\n" + err.getvalue()
    return json.loads(text[text.rindex("\n{\n") + 1:]) if "--metrics" in argv else {}


def _dumps(folder: Path) -> list:
    return [hashlib.md5((folder / f"image_{i + 1}.bit").read_bytes()).hexdigest()
            for i in range(len(list(folder.glob("image_*.bit"))))]


def _entry_points(work: Path, tag: str, reset_launches, read_launches):
    """Phase 23: the entry points on the card against the CPU.  Returns the
    --container ps stream and its JPEG folder, for phase 24."""
    from ec504_imageencoder_tpu_torch import mpeg_encode_procedure
    from ec504_imageencoder_tpu_torch.io import _native
    from ec504_imageencoder_tpu_torch.io import jpeg as jpeg_io

    # the child processes (the C ABI shim's CLI, --profile) import this tree
    os.environ["EC504_PYTHON"] = sys.executable
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT),
                                                             os.environ.get("PYTHONPATH"))))
    hd = _jpeg_folder(work / "hd", sorted(p.name for p in JPEGS.glob("hd_*.jpg")), HD_FRAMES)
    paths = jpeg_io.scan_folder(str(hd))
    geom = jpeg_io.probe_jpeg(paths[0])
    print(f"JPEG folder: {len(paths)} x {geom['width']}x{geom['height']} 4:2:0 "
          f"({sum(os.path.getsize(p) for p in paths) / 1e6:.1f} MB)")
    for label, fn in (("RGB (load_folder)", lambda: jpeg_io.load_folder(str(hd))),
                      ("planes", lambda: jpeg_io.decode_planes_batch(paths, geom)),
                      ("coefficients", lambda: jpeg_io.decode_coeffs_batch(paths, geom))):
        fn()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        print(f"native decoder, {label}: {len(paths) / min(ts):.2f} frames/s "
              f"(best of 3: {1e3 * min(ts):.1f} ms for {len(paths)}; "
              f"{os.cpu_count()} host cores) {tag}")

    # correct mode: the card against the CPU, byte for byte
    stream = ["--stream", "--batch", 16, "--metrics"]
    routes = (  # label, flags, kernels that must launch, CPU bytes it must equal
        ("ycbcr q=50", ["--intake", "ycbcr", *stream], ("vlc_fused4", "pack_fused4"),
         "ycbcr q=50"),
        ("coeffs q=50", ["--intake", "coeffs", *stream], ("vlc_fused4", "pack_fused4"),
         "ycbcr q=50"),
        ("rgb q=50", ["--intake", "rgb", *stream], ("vlc_fused4", "pack_fused4"), "rgb q=50"),
        ("ycbcr q=85", ["--intake", "ycbcr", "-q", 85, *stream], ("vlc_levels4", "pack_fused4"),
         "ycbcr q=85"),
        ("rgb q=50, whole folder decoded first", ["--batch", 16, "--metrics"],
         ("vlc_fused4", "pack_fused4"), "rgb q=50"),
    )
    cpu = {}
    t0 = time.perf_counter()
    for label, flags, _, _ in routes[:4]:
        if label != "coeffs q=50":
            _cli([hd, "-o", work / "cpu.mpeg", "--device", "cpu", *flags])
            cpu[label] = (work / "cpu.mpeg").read_bytes()
    print(f"CPU path CLI, {len(cpu)} configurations x {HD_FRAMES} frames: "
          f"{time.perf_counter() - t0:.2f} s on the host")
    card = {}
    for label, flags, must, want in routes:
        reset_launches()
        _cli([hd, "-o", work / "card.mpeg", *flags])
        counts = {k: v for k, v in read_launches().items() if v}
        print(f"CLI {label}: launches {counts}")
        for name in must:
            if not counts.get(name):
                raise AssertionError(f"CLI {label} never launched {name}")
        card[label] = (work / "card.mpeg").read_bytes()
        _check_equal(f"CLI {label}, {HD_FRAMES} x 1080p on the card", card[label], cpu[want])
        m = _cli([hd, "-o", work / "card.mpeg", *flags])  # timed: the second run
        wall = m["decode_s"] + m["encode_s"]
        print(f"CLI {label}: {HD_FRAMES / wall:.2f} frames/s end to end (decode_s "
              f"{m['decode_s']:.4f}, encode_s {m['encode_s']:.4f}, encode_fps "
              f"{m['encode_fps']:.2f}, n_devices {m.get('n_devices')}, "
              f"{m['bytes_per_frame']:.0f} B a frame) {tag}")

    # --workdir: a run, cut back to its first GOP, resumed
    wd = work / "wd"
    _cli([hd, "-o", work / "wd1.mpeg", "--workdir", wd, "--batch", 16])
    manifest = json.loads((wd / "manifest.json").read_text())
    n_gops = len(manifest["segments"])
    manifest["segments"] = manifest["segments"][:1]
    (wd / "manifest.json").write_text(json.dumps(manifest))
    stamp = (wd / "seg_000000.m1vseg").stat().st_mtime_ns
    reset_launches()
    _cli([hd, "-o", work / "wd2.mpeg", "--workdir", wd, "--batch", 16])
    resumed = read_launches()["vlc_fused4"]
    _check_equal(f"--workdir run ({n_gops} GOPs)", (work / "wd1.mpeg").read_bytes(),
                 card["rgb q=50"])
    _check_equal("--workdir run resumed after GOP 0", (work / "wd2.mpeg").read_bytes(),
                 card["rgb q=50"])
    print(f"--workdir resume: B1 launched {resumed} times for GOPs 1..{n_gops - 1}")
    if (wd / "seg_000000.m1vseg").stat().st_mtime_ns != stamp or not resumed:
        raise AssertionError("the resume re-encoded GOP 0, or encoded nothing")

    # compat: mpeg_encode_procedure on the card, on the CPU and through the shim
    small = _jpeg_folder(work / "small", sorted(p.name for p in JPEGS.glob("frame_*.jpg")),
                         ENTRY_COMPAT_FRAMES)
    reset_launches()
    t0 = time.perf_counter()
    rc = mpeg_encode_procedure(str(small), str(work / "bits_card"), str(work / "card.mpeg"), 12)
    compat_s = time.perf_counter() - t0
    _check_launches(f"mpeg_encode_procedure, {ENTRY_COMPAT_FRAMES} frames", read_launches(),
                    ("compat_color", "vlc_compat_fused4", "pack_fused4"), ("vlc_compat_slots",))
    t0 = time.perf_counter()
    rc_cpu = mpeg_encode_procedure(str(small), str(work / "bits_cpu"), str(work / "cpu.mpeg"),
                                   12, device="cpu")
    cpu_s = time.perf_counter() - t0
    shim = _native.load("encoder_compat").mpeg_encode_procedure
    shim.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    shim.restype = ctypes.c_int
    t0 = time.perf_counter()
    rc_shim = shim(str(small).encode(), str(work / "bits_shim").encode(),
                   str(work / "shim.mpeg").encode(), 12)
    shim_s = time.perf_counter() - t0
    if (rc, rc_cpu, rc_shim) != (0, 0, 0):
        raise AssertionError(f"compat entry points returned {rc}, {rc_cpu}, {rc_shim}")
    want = (work / "cpu.mpeg").read_bytes()
    _check_equal(f"mpeg_encode_procedure, {ENTRY_COMPAT_FRAMES} x 400x600 on the card",
                 (work / "card.mpeg").read_bytes(), want)
    _check_equal("the C ABI shim (CLI in a child process on the card)",
                 (work / "shim.mpeg").read_bytes(), want)
    reset_launches()
    _cli([small, "-o", work / "dbg.mpeg", "--mode", "compat", "--debug-checks",
          "--bitstream-dir", work / "bits_dbg"])
    _check_launches("CLI --mode compat --debug-checks", read_launches(),
                    ("compat_color", "vlc_compat_slots", "pack_fused4_checked"),
                    ("vlc_compat_fused4",))
    _check_equal("CLI --mode compat --debug-checks", (work / "dbg.mpeg").read_bytes(), want)
    md5s = [_dumps(work / d) for d in ("bits_card", "bits_cpu", "bits_shim", "bits_dbg")]
    print(f".bit dumps: {len(md5s[1])} each, card, shim and debug-checks equal to the CPU's "
          f"{md5s[0] == md5s[1] == md5s[2] == md5s[3]}")
    if len(md5s[1]) != ENTRY_COMPAT_FRAMES or not md5s[0] == md5s[1] == md5s[2] == md5s[3]:
        raise AssertionError("compat .bit dumps differ from the CPU path")
    print(f"mpeg_encode_procedure, {ENTRY_COMPAT_FRAMES} x 400x600 q=12: {compat_s:.3f} s on "
          f"the card ({ENTRY_COMPAT_FRAMES / compat_s:.2f} frames/s, decode included), "
          f"{cpu_s:.3f} s on the CPU; through the C ABI shim {shim_s:.3f} s "
          f"(a child process: interpreter start, imports, kernel loads) {tag}")

    # --container ps on 4 copies of one 1080p JPEG (rgb intake: studio range,
    # what phase 24's PSNR compares), on the card and on the CPU
    hd4 = _jpeg_folder(work / "hd4", ["hd_0.jpg"], 4)
    ps = ["--stream", "--intake", "rgb", "--container", "ps"]
    reset_launches()
    _cli([hd4, "-o", work / "ps.mpeg", *ps])
    _check_launches("CLI --container ps", read_launches(), ("vlc_fused4", "pack_fused4"))
    _cli([hd4, "-o", work / "ps_cpu.mpeg", "--device", "cpu", *ps])
    _check_equal("CLI --container ps, 4 x 1080p", (work / "ps.mpeg").read_bytes(),
                 (work / "ps_cpu.mpeg").read_bytes())

    # --profile, as a user runs it (a process of its own): the trace names the
    # kernel launches and holds the card's kernels
    prof = work / "prof"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "ec504_imageencoder_tpu_torch.cli",
                    str(hd4), "-o", str(work / "p.mpeg"),
                    "--stream", "--intake", "ycbcr", "--profile", str(prof)],
                   check=True, cwd=ROOT, timeout=600, stdout=subprocess.DEVNULL)
    (trace,) = prof.glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted({e["name"].split("<")[0].removeprefix("void ") for e in events
                      if e.get("cat") == "kernel"})
    print(f"--profile (CLI in a child process, {time.perf_counter() - t0:.1f} s): trace "
          f"{trace.stat().st_size} B, {len(events)} events; spans vlc_fused4_launch "
          f"{'vlc_fused4_launch' in names}, pack_fused4_launch {'pack_fused4_launch' in names}; "
          f"card kernels {kernels}")
    if not {"vlc_fused4_launch", "pack_fused4_launch"} <= names or not any(
            "vlc_slots_kernel" in k for k in kernels) or not any(
            "pack_tiles_kernel" in k for k in kernels):
        raise AssertionError("the --profile trace lacks the kernel launches")
    return work / "ps.mpeg", hd4


# Phase 24's decoded-PSNR floors in dB, (mean, least frame): the port's CPU
# path decoded by the port's decoder, studio range both sides, for the same
# frames (`python3 tools/decode_psnr_floor.py`: 32.26403013230161 /
# 30.522338088600755 at q=50, 38.02445871293405 / 36.280377150731255 at
# q=85, 35.05529734460338 for 4 x hd_0.jpg at q=50), cut to 0.01 dB.  The
# card's bytes equal the CPU path's, so its decodes must reach them.
PSNR_FLOORS = {f"q={QUALITY}": (32.26, 30.52), f"q={HQ_QUALITY}": (38.02, 36.28),
               "ps": (35.05, 35.05)}
# The compat golden stream is the C encoder's, bugs included (SURVEY.md
# §2.9): the JAX package's decoder stops in it with this error, on the CPU.
GOLDEN_DECODE_ERROR = ("CorruptStreamError", "invalid AC prefix at bit 4696")
MULTIHOST_FRAMES = 6  # phase 26: 1080p frames, GOPs of one


def _decode_job(path: str, color_range: str, ref_path: str | None) -> dict:
    """Phase 24, in a worker process: decode_stream of the stream at path;
    its frame count, shapes, per-frame PSNR against the frames saved at
    ref_path, and seconds; or the decoder's error."""
    import numpy as np

    from ec504_imageencoder_tpu_torch.models.decoder import decode_stream, psnr

    data = Path(path).read_bytes()
    t0 = time.perf_counter()
    try:
        dec = decode_stream(data, color_range)
    except ValueError as e:
        return {"error": (type(e).__name__, str(e)), "s": time.perf_counter() - t0}
    out = {"frames": len(dec), "shapes": sorted({d.shape for d in dec}),
           "s": time.perf_counter() - t0}
    if ref_path:
        ref = np.load(ref_path)
        out["psnr"] = [float(psnr(r, d)) for r, d in zip(ref, dec)]
    return out


# Phase 26's child: rank argv[1] of argv[2] processes, encode_multihost over
# gloo on the card; EC504_DRILL=die runs the fault drill's first half (rank 1
# dies after its first GOP, rank 0 banks its share and leaves before the
# barrier).  Each process logs the frame ranges it encoded.
_MULTIHOST_CHILD = r"""
import os, sys, time
import numpy as np
import torch.distributed as dist
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.parallel.distributed import encode_multihost, init_distributed
from ec504_imageencoder_tpu_torch.runtime.checkpoint import CheckpointedEncode

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
workdir, out, log, frames_path, quality = sys.argv[4:9]
assert init_distributed(f"127.0.0.1:{port}", nproc, pid, timeout=120) == (pid, nproc)
frames = np.load(frames_path)
enc = TorchMPEG1IntraEncoder(quality=int(quality), gop_size=1, device="cuda:0")
calls = []

def source(s, e):
    if os.environ.get("EC504_DRILL") == "die" and pid == 1 and calls:
        os._exit(42)  # a hard kill mid-encode: after GOP 1, before GOP 3
    calls.append((s, e))
    with open(log, "a") as f:
        f.write(f"{pid} {s} {e}\n")
    return frames[s:e]

if os.environ.get("EC504_DRILL") and pid == 0:
    sess = CheckpointedEncode(workdir, enc, len(frames))
    sess.manifest_path = os.path.join(workdir, "manifest_0.json")
    sess.segments = {}
    sess._load_manifest()
    for g in range(sess.n_gops()):
        if g % nproc == 0 and g not in sess.segments:
            s, e = sess.gop_frame_range(g)
            sess.encode_gop(g, source(s, e))
    deadline = time.time() + 120
    while not os.path.exists(os.path.join(workdir, "seg_000001.m1vseg")):
        if time.time() > deadline:
            os._exit(3)
        time.sleep(0.05)
    os._exit(0)  # preempted before the barrier: no stitch
n = encode_multihost(source, len(frames), workdir, out, encoder=enc)
print("RESULT", pid, n, len(calls))
dist.destroy_process_group()
"""


def _two_processes(script: Path, args, env=None, timeout: float = 300):
    """Run script as ranks 0 and 1 of 2 on a fresh gloo port: (return codes,
    (stdout, stderr) each, wall seconds).  Both are killed on a timeout."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    full_env = dict(os.environ, PYTHONPATH=str(ROOT), **(env or {}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), "2", str(port),
                               *map(str, args)], cwd=ROOT, env=full_env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2

    from ec504_imageencoder_tpu_torch.io import _native
    from ec504_imageencoder_tpu_torch.models import mpeg1
    from ec504_imageencoder_tpu_torch.models.encoder import encode_compat
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder, plane_levels
    from ec504_imageencoder_tpu_torch.ops import (
        _build,
        cuda_lut,
        cuda_pack,
        cuda_pack_split,
        cuda_vlc,
        cuda_vlc_compat,
        cuda_vlc_levels,
        cuda_vlc_raw,
        jpeg_device,
    )
    from ec504_imageencoder_tpu_torch.ops.bitpack import (
        compact_slices,
        fuse4,
        split_compact_slices,
    )
    from ec504_imageencoder_tpu_torch.ops.color import (
        rgb_to_ycbcr,
        rgb_to_ycbcr_exact,
        subsample_420,
    )
    from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts
    from ec504_imageencoder_tpu_torch.ops.vlc_device import zero_runs
    from ec504_imageencoder_tpu_torch.utils.tables import scale_quantization_matrix

    reset_launches = _build.launches.clear
    read_launches = _build.launches.copy  # a Counter: 0 for a kernel never launched

    sanitizer_kernels = ("vlc_raw", "lut_lookup", "pack_fused4_checked")
    fuse8_kernels = ("vlc_fused8", "pack_fused8")
    # pack= value of the generic route -> (its kernel, wrapper, plain twin)
    raw_packs = {
        "pallas1": ("pack_raw", cuda_pack.pack_raw, cuda_pack.pack_raw_plain),
        "pallas3": ("pack_windows", cuda_pack_split.pack_windows, cuda_pack.pack_raw_plain),
        "fused": ("pack_split", cuda_pack_split.pack_split, cuda_pack.pack_raw_plain),
        "fused2w": ("pack_pairs", cuda_pack.pack_pairs, cuda_pack.pack_pairs_plain),
    }
    raw_pack_kernels = tuple(v[0] for v in raw_packs.values())

    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    tag = f"[{gpu}]"
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(["vlc_fused4", "pack_fused4", "vlc_levels4", "vlc_compat", "lut_lookup",
                  "pack_split"])
    for mod in (cuda_vlc, cuda_pack, cuda_vlc_levels, cuda_vlc_compat, cuda_lut, cuda_pack_split):
        mod.load_kernel()
    cold_build_s = time.perf_counter() - t0
    for name, (secs, log) in sorted(_build.build_info.items()):
        print(f"build {name}: nvcc done after {secs:.2f} s")
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"cold kernel build (parallel) + load: {cold_build_s:.2f} s {tag}")
    t0 = time.perf_counter()
    _native.build()
    host_build_s = time.perf_counter() - t0
    for name, (secs, _) in sorted(_native.build_info.items()):
        print(f"build {name}: g++ done after {secs:.2f} s")
    print(f"cold host library build (g++, parallel): {host_build_s:.2f} s "
          f"({len(_native.build_info)} built) {tag}")

    rng = np.random.default_rng(SEED)
    frames = _frames(np, rng, BATCH)
    enc = TorchMPEG1IntraEncoder(quality=QUALITY, device=dev)
    core = enc.core
    luts = core.luts()

    # 16 x 1080p planes (studio range, as encode() makes them) and a noise
    # frame pair at an odd size
    rgb = torch.from_numpy(np.pad(frames, ((0, 0), (0, -HEIGHT % 16), (0, 0), (0, 0)),
                                  mode="edge")).to(dev)
    y, cb, cr = rgb_to_ycbcr(rgb, "studio")
    planes_hd = (y, subsample_420(cb), subsample_420(cr))
    del rgb, y, cb, cr
    n_rows_hd = planes_hd[0].shape[0] * planes_hd[0].shape[1] // 16
    n_blocks_hd = n_rows_hd * (WIDTH // 16) * 6
    plane_bytes_hd = sum(p.numel() for p in planes_hd)
    oh, ow = 1000, 1400
    noise = [rng.integers(0, 256, s, dtype=np.uint8)
             for s in ((2, oh, ow), (2, oh // 2, ow // 2), (2, oh // 2, ow // 2))]
    planes_odd = tuple(torch.from_numpy(p).to(dev) for p in _pad_planes(np, *noise))
    planes_pattern = {c: tuple(torch.from_numpy(p).to(dev) for p in _pattern_planes(np, rng, c, 2))
                      for c in ("flat", "checker")}

    # ---- 2. B1 against its twin ------------------------------------------
    b1_err = 0
    slots = {}
    for name, planes in (("16x1080p", planes_hd), (f"2x{oh}x{ow} noise", planes_odd),
                         *((f"2x1080p {c}", p) for c, p in planes_pattern.items())):
        got = cuda_vlc.vlc_fused4(*planes, core.qw, luts)
        want = cuda_vlc.vlc_fused4_plain(*planes, core.qw, luts)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        b1_err = max(b1_err, err)
        print(f"B1 vlc_fused4 vs twin, {name}: slots {tuple(got[0].shape)}, "
              f"max flen {int(got[4].max())}, max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"B1 disagrees with its twin on {name}")
        slots[name] = got
    del want

    # ---- 3. B2 against its twin ------------------------------------------
    msb_hd = enc.resolve_slice_bytes(WIDTH // 16)
    cases = [
        ("16x1080p, auto buffer (shared memory)", slots["16x1080p"], msb_hd // 4, False),
        ("noise, 2560 B buffer (overflows)", slots[f"2x{oh}x{ow} noise"], 640, True),
        ("noise, 342528 B buffer (global memory)", slots[f"2x{oh}x{ow} noise"], 342528 // 4, False),
    ]
    # the 16 x 1080p slots off alignment and cut to B2's tile edges (full
    # size: 1,088 rows)
    tile = cuda_pack.fused4_tile()
    b2_edges = {"16x1080p, planes one element off alignment":
                [_unaligned(torch, t) for t in slots["16x1080p"]]}
    for d in (-1, 0, 1):
        b2_edges[f"16x1080p cut to {tile + d} slots (a tile {d:+d})"] = [
            t[:, :tile + d].contiguous() for t in slots["16x1080p"]]
    for ename, sl in b2_edges.items():
        cases += [(f"{ename}, auto buffer", sl, msb_hd // 4, False),
                  (f"{ename}, 7 words (overflows)", sl, 7, True),
                  (f"{ename}, 342528 B buffer", sl, 342528 // 4, False)]
    b2_err = 0
    for name, sl, mw, must_overflow in cases:
        got = cuda_pack.pack_fused4(*sl, mw, bit_offset=38)
        want = cuda_pack.pack_fused4_plain(*sl, mw, bit_offset=38)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        b2_err = max(b2_err, err)
        over = int((got[1] > 32 * mw).sum())
        print(f"B2 pack_fused4 vs twin, {name}: {got[0].shape[0]} slices, "
              f"max nbits {int(got[1].max())}, {over} over the buffer, max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"B2 disagrees with its twin on {name}")
        if must_overflow and over == 0:
            raise AssertionError(f"{name}: no slice overflowed")

    # ---- 4. the q=50 main path -------------------------------------------
    ycc = rgb_to_ycbcr(torch.from_numpy(frames), "full")  # JPEG-style planes, on the host
    jy, jcb, jcr = ycc[0].numpy(), subsample_420(ycc[1]).numpy(), subsample_420(ycc[2]).numpy()
    regrow_frames = rng.integers(0, 256, (2, HEIGHT, WIDTH, 3), dtype=np.uint8)

    reset_launches()
    t0 = time.perf_counter()
    es_rgb = TorchMPEG1IntraEncoder(quality=QUALITY, device=dev).encode(frames)
    es_planes = TorchMPEG1IntraEncoder(quality=QUALITY, device=dev).encode_from_planes(jy, jcb, jcr)
    regrow = TorchMPEG1IntraEncoder(quality=QUALITY, max_slice_bytes=2560, device=dev)
    es_regrow = regrow.encode(regrow_frames)
    main_s = time.perf_counter() - t0
    launches = read_launches()
    _check_launches(f"q={QUALITY} path (encode + encode_from_planes + regrow encode, "
                    f"{main_s:.2f} s)", launches, ("vlc_fused4", "pack_fused4"),
                    ("vlc_levels4", "f32_levels", "vlc_compat_slots", "vlc_compat_fused4",
                     "compat_color", *sanitizer_kernels, *fuse8_kernels, *raw_pack_kernels))
    if regrow.max_slice_bytes <= 2560:
        raise AssertionError("the forced-regrow run did not regrow")
    print(f"regrow: 2560 B -> {regrow.max_slice_bytes} B per slice")

    t0 = time.perf_counter()
    cpu_rgb = TorchMPEG1IntraEncoder(quality=QUALITY, device="cpu").encode(frames)
    cpu_planes = TorchMPEG1IntraEncoder(quality=QUALITY, device="cpu").encode_from_planes(
        jy, jcb, jcr)
    cpu_regrow = TorchMPEG1IntraEncoder(quality=QUALITY, max_slice_bytes=2560,
                                        device="cpu").encode(regrow_frames)
    print(f"CPU path encodes, q={QUALITY}: {time.perf_counter() - t0:.2f} s on the host")
    for name, got, want in (("encode", es_rgb, cpu_rgb),
                            ("encode_from_planes", es_planes, cpu_planes),
                            ("regrow encode", es_regrow, cpu_regrow)):
        _check_equal(name, got, want)

    # ---- 5. steady-state times, q=50 -------------------------------------
    sl_hd = slots["16x1080p"]
    times = {
        "vlc_fused4": (
            _event_ms(torch, lambda: cuda_vlc.vlc_fused4(*planes_hd, core.qw, luts), 20),
            _event_ms(torch, lambda: cuda_vlc.vlc_fused4_plain(*planes_hd, core.qw, luts), 3),
        ),
        "pack_fused4": (
            _event_ms(torch, lambda: cuda_pack.pack_fused4(*sl_hd, msb_hd // 4), 20),
            _event_ms(torch, lambda: cuda_pack.pack_fused4_plain(*sl_hd, msb_hd // 4), 3),
        ),
    }
    # bytes each function must move and its integer operations
    work = {
        "vlc_fused4": (plane_bytes_hd + 5 * 4 * sl_hd[4].numel(),
                       n_blocks_hd * (OPS_DCT_BLOCK + OPS_EMIT_BLOCK)),
        "pack_fused4": (5 * 4 * sl_hd[4].numel() + n_rows_hd * (msb_hd + 4),
                        OPS_PACK_SLOT * sl_hd[4].numel()),
    }
    for name, (k_ms, p_ms) in times.items():
        print(f"{name} at 16x1080p: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms {tag}")
    print(f"pack_fused4 at 16x1080p: device time (profiler records) "
          f"{_device_ms(torch, lambda: cuda_pack.pack_fused4(*sl_hd, msb_hd // 4), 20)} {tag}")
    # one frame's slices: fewer blocks than SMs, where a slice's latency is the time
    sl_one = [t[:n_rows_hd // BATCH] for t in sl_hd]
    for name, checks in (("pack_fused4", False), ("pack_fused4_checked", True)):
        fn = lambda: cuda_pack.pack_fused4(*sl_one, msb_hd // 4, checks=checks)  # noqa: E731
        print(f"{name} at one frame ({len(sl_one[4])} slices): kernel "
              f"{_event_ms(torch, fn, 20):.4f} ms, device time (profiler records) "
              f"{_device_ms(torch, fn, 20)} {tag}")
    for label, fn in (
        ("encode", lambda: enc.encode(frames)),
        ("encode_from_planes", lambda: enc.encode_from_planes(jy, jcb, jcr)),
    ):
        fps, ms = _frames_per_s(torch, fn, BATCH, 5)
        print(f"{label} 16x1080p q={QUALITY}: {fps:.2f} frames/s ({ms:.2f} ms per batch) {tag}")

    # ---- 6. B3 against its twin ------------------------------------------
    hq = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device=dev)
    if hq.dct_impl != "f32":
        raise AssertionError(f"dct_impl 'auto' at q={HQ_QUALITY} did not pick f32")
    hq_args = (*planes_hd, hq.core.qw, hq.core.zigzag)
    q100 = TorchMPEG1IntraEncoder(quality=100, device=dev).core
    levels_err = max(
        _check_twin(torch, f"f32 levels vs twin, {name}", cuda_vlc_levels.f32_levels,
                    cuda_vlc_levels.f32_levels_plain, args)
        for name, args in ((f"16x1080p q={HQ_QUALITY}", hq_args),
                           (f"2x{oh}x{ow} noise q=100", (*planes_odd, q100.qw, q100.zigzag))))
    hq_in = plane_levels(*planes_hd, hq.core.qw, hq.core.zigzag)
    noise_in = plane_levels(*planes_odd, q100.qw, q100.zigzag)
    if int(noise_in[0][..., 1:].abs().max()) < 128:
        raise AssertionError("the q=100 noise levels hold no 28-bit escape")
    # each noise block keeps its largest AC level, moved to the last slot
    ac = noise_in[0][..., 1:]
    last_only = noise_in[0].clone()
    last_only[..., 1:63] = 0
    last_only[..., 63] = ac.gather(-1, ac.abs().argmax(-1, keepdim=True)).squeeze(-1)
    pattern_in = {c: plane_levels(*p, q100.qw, q100.zigzag) for c, p in planes_pattern.items()}
    if pattern_in["flat"][0][..., 1:].any() or not pattern_in["checker"][0][..., 63].all():
        raise AssertionError("flat planes gave an AC level, or a checkerboard no last level")
    b3_err = max(
        _check_twin(torch, f"B3 vlc_levels4 vs twin, {name}", cuda_vlc_levels.vlc_levels4,
                    cuda_vlc_levels.vlc_levels4_plain, (*lv_in, luts))
        for name, lv_in in ((f"16x1080p q={HQ_QUALITY}", hq_in),
                            (f"2x{oh}x{ow} noise q=100", noise_in),
                            *((f"2x1080p {c} q=100", v) for c, v in pattern_in.items()),
                            (f"2x{oh}x{ow} noise q=100, last AC level only",
                             (last_only, noise_in[1])))
    )
    del noise_in, ac, last_only, pattern_in

    # ---- 7. B4a and B4b against their twins ------------------------------
    gold_frames, gold_mpeg, gold_md5 = _golden(np)
    compat_frames = np.concatenate([gold_frames] * COMPAT_COPIES)
    cluts = Luts.compat(dev)
    sq = torch.from_numpy(scale_quantization_matrix(COMPAT_QUALITY).astype(np.int32)).to(dev)
    compat_planes = {}
    for name, fr in (("30 golden frames", gold_frames), (f"{len(compat_frames)} frames", compat_frames)):
        compat_planes[name] = tuple(torch.from_numpy(p).to(dev) for p in rgb_to_ycbcr_exact(fr))
    # the compat colour kernel against the host f64 colour: the wide path
    # on the 400 x 600 frames, the scalar path at 150 x 101
    color_err = 0
    noise_rgb = np.random.default_rng(SEED + 6).integers(0, 256, (30, 150, 101, 3), dtype=np.uint8)
    for name, fr in (("30 golden frames", gold_frames),
                     (f"{len(compat_frames)} frames", compat_frames),
                     ("30 noise frames 150x101", noise_rgb)):
        want = (compat_planes[name] if name in compat_planes else
                tuple(torch.from_numpy(p).to(dev) for p in rgb_to_ycbcr_exact(fr)))
        got = cuda_vlc_compat.compat_color(torch.from_numpy(fr).to(dev))
        torch.cuda.synchronize()
        err = _max_abs_err(torch, tuple(got), want)
        print(f"compat_color vs rgb_to_ycbcr_exact, {name}: planes {tuple(got.shape)}, "
              f"max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"compat_color disagrees with the host colour on {name}")
        color_err = max(color_err, err)
    del noise_rgb, want, got
    # B4b's flat groups of 128 blocks (324 a frame): 1 frame leaves a last
    # group of 68, 30 frames one of 120, 480 none; at q=12 and q=100
    # (escapes), on 1 golden frame, 30 noise frames of odd width 101, and
    # 30 flat frames (the DC alone) and checkerboards (the last zigzag
    # level nonzero) of 144 x 96
    sq100 = torch.from_numpy(scale_quantization_matrix(100).astype(np.int32)).to(dev)
    erng = np.random.default_rng(SEED + 7)
    edge_planes = {"1 golden frame": tuple(p[:1] for p in compat_planes["30 golden frames"]),
                   "30 noise frames 150x101": tuple(
                       torch.from_numpy(erng.integers(0, 256, (30, 150, 101), dtype=np.uint8)).to(dev)
                       for _ in range(3))}
    # widths around the golden frames' 600 whose rows the kernels read as
    # bytes (W % 8 != 0), 2 frames each (a last group of 8 blocks)
    for w in (601, 602, 610):
        edge_planes[f"2 noise frames 150x{w}"] = tuple(
            torch.from_numpy(erng.integers(0, 256, (2, 150, w), dtype=np.uint8)).to(dev)
            for _ in range(3))
    yy, xx = np.indices((144, 96))
    for content in ("flat", "checker"):
        if content == "flat":
            arrays = [np.broadcast_to(erng.integers(0, 256, (30, 1, 1)), (30, 144, 96))
                      for _ in range(3)]
        else:
            arrays = [128 + erng.integers(100, 128, (30, 1, 1)) * (((yy + xx) & 1) * 2 - 1)
                      for _ in range(3)]
        edge_planes[f"30 {content} frames 144x96"] = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(dev) for a in arrays)
    b4a_err = b4b_err = 0
    for name, planes, qs in (*((n, p, ((COMPAT_QUALITY, sq),)) for n, p in compat_planes.items()),
                             *((n, p, ((COMPAT_QUALITY, sq), (100, sq100)))
                               for n, p in edge_planes.items())):
        for q, qm in qs:
            b4a_err = max(b4a_err, _check_twin(
                torch, f"B4a vlc_compat_slots vs twin, {name} q={q}",
                cuda_vlc_compat.vlc_compat_slots, cuda_vlc_compat.vlc_compat_slots_plain,
                (*planes, qm, cluts)))
            b4b_err = max(b4b_err, _check_twin(
                torch, f"B4b vlc_compat_fused4 vs twin, {name} q={q}",
                cuda_vlc_compat.vlc_compat_fused4, cuda_vlc_compat.vlc_compat_fused4_plain,
                (*planes, qm, cluts)))
    del edge_planes

    # ---- 8. the q=85 path (f32 DCT) --------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    hq_rgb = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device=dev).encode(frames)
    hq_planes = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device=dev).encode_from_planes(jy, jcb, jcr)
    hq_s = time.perf_counter() - t0
    hq_launches = read_launches()
    _check_launches(f"q={HQ_QUALITY} path (encode + encode_from_planes, {hq_s:.2f} s)",
                    hq_launches, ("f32_levels", "vlc_levels4", "pack_fused4"),
                    ("vlc_fused4", *sanitizer_kernels, *fuse8_kernels, *raw_pack_kernels))
    if hq_launches["f32_levels"] != hq_launches["vlc_levels4"]:
        raise AssertionError("the f32 levels kernel did not launch once a B3 launch")

    t0 = time.perf_counter()
    cpu_hq_rgb = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device="cpu").encode(frames)
    cpu_hq_planes = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device="cpu").encode_from_planes(
        jy, jcb, jcr)
    cpu_aan = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, dct_impl="aan", device="cpu").encode(frames)
    print(f"CPU path encodes, q={HQ_QUALITY} (f32 DCT, and aan): "
          f"{time.perf_counter() - t0:.2f} s on the host")
    _check_equal(f"q={HQ_QUALITY} encode", hq_rgb, cpu_hq_rgb)
    _check_equal(f"q={HQ_QUALITY} encode_from_planes", hq_planes, cpu_hq_planes)

    splits = {
        f"2 x {BATCH // 2}": b"".join(TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device=dev).encode(
            frames[i:i + BATCH // 2], first_frame_index=i) for i in (0, BATCH // 2)),
        f"{BATCH} x 1": b"".join(TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device=dev).encode(
            frames[i:i + 1], first_frame_index=i) for i in range(BATCH)),
    }
    prec, tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        splits["TF32 allowed"] = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, device=dev).encode(frames)
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, es in splits.items():
        print(f"q={HQ_QUALITY} encode, {name}: equal to {BATCH} at once {es == hq_rgb}")
        if es != hq_rgb:
            raise AssertionError(f"q={HQ_QUALITY} bytes differ for {name}")
    aan = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, dct_impl="aan", device=dev).encode(frames)
    _check_equal(f"q={HQ_QUALITY} dct_impl='aan'", aan, cpu_aan)

    # ---- 9. compat mode --------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    c_gold, c_dumps = encode_compat(gold_frames, COMPAT_QUALITY, device=dev)
    c_many, c_many_dumps = encode_compat(compat_frames, COMPAT_QUALITY, device=dev)
    compat_s = time.perf_counter() - t0
    compat_launches = read_launches()
    _check_launches(f"compat path (30 + {len(compat_frames)} frames, {compat_s:.2f} s)",
                    compat_launches, ("compat_color", "vlc_compat_fused4", "pack_fused4"),
                    ("vlc_compat_slots", "vlc_fused4", "vlc_levels4", *sanitizer_kernels,
                     *fuse8_kernels))
    reset_launches()
    c_debug, _ = encode_compat(gold_frames, COMPAT_QUALITY, device=dev, debug_checks=True)
    debug_launches = read_launches()
    _check_launches("compat path with debug_checks (30 frames)", debug_launches,
                    ("compat_color", "vlc_compat_slots", "pack_fused4_checked"),
                    ("vlc_compat_fused4", "pack_fused4"))
    if (compat_launches["compat_color"], debug_launches["compat_color"]) != (2, 1):
        raise AssertionError("the compat colour did not launch once a call")

    md5_ok = all(hashlib.md5(d).hexdigest() == gold_md5[f"image_{i + 1}.bit"]
                 for i, d in enumerate(c_dumps))
    print(f"compat, golden frames: {len(c_gold)} B, golden {len(gold_mpeg)} B, equal "
          f"{c_gold == gold_mpeg}, debug_checks equal {c_debug == gold_mpeg}, dump md5s {md5_ok}")
    if c_gold != gold_mpeg or c_debug != gold_mpeg or not md5_ok:
        raise AssertionError("compat output differs from the golden stream or dumps")
    t0 = time.perf_counter()
    cpu_many, cpu_many_dumps = encode_compat(compat_frames, COMPAT_QUALITY, device="cpu")
    print(f"CPU path encode_compat, {len(compat_frames)} frames: "
          f"{time.perf_counter() - t0:.2f} s on the host")
    _check_equal(f"compat, {len(compat_frames)} frames", c_many, cpu_many)
    if c_many_dumps != cpu_many_dumps:
        raise AssertionError("compat .bit dumps differ from the CPU path")
    del cpu_many_dumps, c_many_dumps

    # ---- 10. steady-state times, q=85 and compat -------------------------
    big = compat_planes[f"{len(compat_frames)} frames"]
    n_compat_blocks = len(compat_frames) * 6 * 54
    work["vlc_levels4"] = (hq_in[0].numel() * 4 + hq_in[1].numel() * 4 + 5 * 4 * sl_hd[4].numel(),
                           n_blocks_hd * OPS_EMIT_BLOCK)
    # the planes read once, the levels and predictors written once
    work["f32_levels"] = (plane_bytes_hd + hq_in[0].numel() * 4 + hq_in[1].numel() * 4, 0,
                          n_blocks_hd * OPS_F32_LEVELS_BLOCK)
    # compat reads the 96 x 144 crop of each plane: 64 B per block
    work["vlc_compat_fused4"] = (n_compat_blocks * (64 + 5 * 4 * 16),
                                 n_compat_blocks * (OPS_DCT_BLOCK + OPS_EMIT_BLOCK))
    work["vlc_compat_slots"] = (n_compat_blocks * (64 + 2 * 4 * 64),
                                n_compat_blocks * (OPS_DCT_BLOCK + OPS_EMIT_BLOCK))
    for name, kernel, twin, args in (
        ("f32_levels", cuda_vlc_levels.f32_levels, cuda_vlc_levels.f32_levels_plain, hq_args),
        ("vlc_levels4", cuda_vlc_levels.vlc_levels4, cuda_vlc_levels.vlc_levels4_plain,
         (*hq_in, luts)),
        ("vlc_compat_fused4", cuda_vlc_compat.vlc_compat_fused4,
         cuda_vlc_compat.vlc_compat_fused4_plain, (*big, sq, cluts)),
        ("vlc_compat_slots", cuda_vlc_compat.vlc_compat_slots,
         cuda_vlc_compat.vlc_compat_slots_plain, (*big, sq, cluts)),
    ):
        times[name] = (_event_ms(torch, lambda: kernel(*args), 20),
                       _event_ms(torch, lambda: twin(*args), 3))
        hd = name in ("f32_levels", "vlc_levels4")
        where = f"16x1080p q={HQ_QUALITY}" if hd else f"{len(compat_frames)} frames"
        print(f"{name} at {where}: kernel {times[name][0]:.4f} ms, "
              f"plain twin {times[name][1]:.4f} ms {tag}")
        if name == "f32_levels":
            print(f"f32_levels at {where}: device time (profiler records) "
                  f"{_device_ms(torch, lambda: kernel(*args), 20)}, events "
                  f"{times[name][0]:.4f} ms, bound {_bound(*work[name])[0]:.4f} ms "
                  f"({_bound(*work[name])[1]}) {tag}")
        if not hd:
            # a compat launch is short enough that the wrapper's host cost
            # can show in the event time: the profiler's device time too
            print(f"{name} at {where}: device time (profiler records) "
                  f"{_device_ms(torch, lambda: kernel(*args), 20)}, events "
                  f"{times[name][0]:.4f} ms, bound {_bound(*work[name])[0]:.4f} ms {tag}")
    for label, fn, n in (
        (f"encode 16x1080p q={HQ_QUALITY}", lambda: hq.encode(frames), BATCH),
        (f"encode_from_planes 16x1080p q={HQ_QUALITY}",
         lambda: hq.encode_from_planes(jy, jcb, jcr), BATCH),
        (f"encode_compat {len(compat_frames)} x 400x600 q={COMPAT_QUALITY}",
         lambda: encode_compat(compat_frames, COMPAT_QUALITY, device=dev), len(compat_frames)),
    ):
        fps, ms = _frames_per_s(torch, fn, n, 3)
        print(f"{label}: {fps:.2f} frames/s ({ms:.2f} ms per call) {tag}")
    # the compat colour: 3 B of RGB read and 3 B of planes written a pixel;
    # the kernels table's row at the cell's 30 frames, its twin on the card
    for fr in (gold_frames, compat_frames):
        rgb_dev = torch.from_numpy(fr).to(dev)
        px = rgb_dev.numel() // 3
        kernel_ms = _event_ms(torch, lambda: cuda_vlc_compat.compat_color(rgb_dev), 20)
        if len(fr) == len(gold_frames):
            times["compat_color"] = (kernel_ms, _event_ms(
                torch, lambda: cuda_vlc_compat.compat_color_plain(rgb_dev), 3))
            work["compat_color"] = (6 * px, 0)
        print(f"compat_color at {len(fr)} x 400x600: events {kernel_ms:.4f} ms, device time "
              f"(profiler records) "
              f"{_device_ms(torch, lambda: cuda_vlc_compat.compat_color(rgb_dev), 20)}, bound "
              f"{_bound(6 * px, 0)[0]:.4f} ms (bytes, {6 * px / 1e6:.1f} MB) {tag}")
        del rgb_dev
    print(f"compat_color's plain twin at 30 x 400x600 on the card: "
          f"{times['compat_color'][1]:.4f} ms {tag}")
    del big, compat_planes, hq_args

    # ---- 11. B6a against its twin ----------------------------------------
    # the planes kernels' cases (name, planes, qw, phase 2's slots key):
    # phase 2's, escapes at q=100, and runs of 62 from checkerboards whose
    # AAN levels at q=5 are the last slot alone
    q5 = TorchMPEG1IntraEncoder(quality=5, device=dev).core
    last62 = tuple(torch.from_numpy(p).to(dev)
                   for p in _pattern_planes(np, np.random.default_rng(SEED + 11), "last", 2))
    lv62 = plane_levels(*last62, q5.qw, q5.zigzag, dct_impl="aan")[0]
    if lv62[..., 1:63].any() or not lv62[..., 63].all():
        raise AssertionError("the q=5 checkerboards' levels are not the last slot alone")
    del lv62
    plane_cases = (
        (f"16x1080p q={QUALITY}", planes_hd, core.qw, "16x1080p"),
        (f"2x{oh}x{ow} noise q={QUALITY}", planes_odd, core.qw, f"2x{oh}x{ow} noise"),
        (f"2x{oh}x{ow} noise q=100", planes_odd, q100.qw, None),
        (f"2x1080p flat q={QUALITY}", planes_pattern["flat"], core.qw, None),
        ("2x1080p checker q=100", planes_pattern["checker"], q100.qw, None),
        ("2x1080p last slot only q=5", last62, q5.qw, None),
    )
    b6a_err = max(
        _check_twin(torch, f"B6a vlc_raw vs twin, {name}", cuda_vlc_raw.vlc_raw,
                    cuda_vlc_raw.vlc_raw_plain, (*planes, qw, luts))
        for name, planes, qw, _ in plane_cases
    )

    # ---- 12. B5 against its twin -----------------------------------------
    hq_levels = hq_in[0]
    ranks, _ = cuda_lut.ac_rank(zero_runs(hq_levels, force_slot0=True), hq_levels.abs())
    ac_tab, dc_tab = cuda_lut.AC_PACKED.to(dev), cuda_lut.DC_PACKED.to(dev)
    rand_idx = torch.from_numpy(rng.integers(-64, 192, 10_000_000).astype(np.int32)).to(dev)

    def lookup(idx, table):
        return (cuda_lut.lut_lookup(idx, table),)

    def lookup_plain(idx, table):
        return (cuda_lut.lut_lookup_plain(idx, table),)

    b5_err = max(
        _check_twin(torch, f"B5 lut_lookup vs twin, {name}", lookup, lookup_plain, args)
        for name, args in ((f"AC ranks of the 16x1080p q={HQ_QUALITY} levels", (ranks, ac_tab)),
                           ("10M random indices, AC table", (rand_idx, ac_tab)),
                           ("10M random indices, DC table", (rand_idx, dc_tab)))
    )
    del rand_idx

    # ---- 13. B2's checked form -------------------------------------------
    mw_hd = msb_hd // 4
    b2c_err = 0
    for name, sl, mw, _ in cases:
        got = cuda_pack.pack_fused4(*sl, mw, bit_offset=38, checks=True)
        unchecked = cuda_pack.pack_fused4(*sl, mw, bit_offset=38)
        want = cuda_pack.pack_fused4_plain(*sl, mw, bit_offset=38, checks=True)
        torch.cuda.synchronize()
        err = max(_max_abs_err(torch, got, want), _max_abs_err(torch, got[:2], unchecked))
        b2c_err = max(b2c_err, err)
        print(f"B2 checked vs twin and unchecked, {name}: violations {int(got[2].sum())}, "
              f"max_abs_err {err}")
        if err != 0 or got[2].any():
            raise AssertionError(f"checked B2 on healthy slots, {name}")
    n_sl = sl_hd[4].shape[0]
    bad = [t.clone() for t in sl_hd]
    bad[4][1, 100] = 200
    bad[4][n_sl - 1, 5] = 129
    got = cuda_pack.pack_fused4(*bad, mw_hd, bit_offset=38, checks=True)
    want = cuda_pack.pack_fused4_plain(*bad, mw_hd, bit_offset=38, checks=True)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, got, want)
    b2c_err = max(b2c_err, err)
    hit = got[2].nonzero().flatten().tolist()
    print(f"B2 checked, fused lengths 200 and 129: violations in slices {hit}, max_abs_err {err}")
    if err != 0 or hit != [1, n_sl - 1] or int(got[2].sum()) != 2:
        raise AssertionError("checked B2 miscounts bad fused lengths")
    # the same at B2's tile edges: the first slot of row 2's last tile and
    # the last slot of row 3's first tile, with aligned planes and not
    kf_hd = sl_hd[4].shape[1]
    for aname, base in (("aligned", sl_hd), ("one element off alignment",
                                             b2_edges["16x1080p, planes one element off alignment"])):
        bad = [t.clone() for t in base]
        bad[4][2, (kf_hd - 1) // tile * tile] = 200
        bad[4][3, tile - 1] = 129
        if aname != "aligned":
            bad = [_unaligned(torch, t) for t in bad]
        got = cuda_pack.pack_fused4(*bad, mw_hd, bit_offset=38, checks=True)
        want = cuda_pack.pack_fused4_plain(*bad, mw_hd, bit_offset=38, checks=True)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        b2c_err = max(b2c_err, err)
        hit = got[2].nonzero().flatten().tolist()
        print(f"B2 checked, {aname}, lengths 200 at slot {(kf_hd - 1) // tile * tile} and 129 at "
              f"slot {tile - 1}: violations in slices {hit}, max_abs_err {err}")
        if err != 0 or hit != [2, 3] or int(got[2].sum()) != 2:
            raise AssertionError(f"checked B2 miscounts bad fused lengths at its tile edges, {aname}")
    row = n_sl // 2
    over = [t.clone() for t in sl_hd]
    for t in over[:3]:
        t[row, :20] = 0
    over[3][row, :20] = -1  # 16 one bits above each 16-bit length
    over[4][row, :20] = 16
    got = cuda_pack.pack_fused4(*over, mw_hd, bit_offset=38, checks=True)
    want = cuda_pack.pack_fused4_plain(*over, mw_hd, bit_offset=38, checks=True)
    hit, want_hit = got[2].nonzero().flatten().tolist(), want[2].nonzero().flatten().tolist()
    print(f"B2 checked, overlapping bits in slice {row}: kernel counts {int(got[2][row])} in "
          f"slices {hit}, twin {int(want[2][row])} in {want_hit}")
    if hit != [row] or want_hit != [row]:
        raise AssertionError("checked B2 misses overlapping bits")
    del bad, over, got, want, unchecked

    # ---- 14. the sanitizer: debug_checks=True ----------------------------
    debug_counts = {}
    for q, must, cpu_pair in ((QUALITY, "vlc_raw", (cpu_rgb, cpu_planes)),
                              (HQ_QUALITY, "lut_lookup", (cpu_hq_rgb, cpu_hq_planes))):
        reset_launches()
        t0 = time.perf_counter()
        dbg = TorchMPEG1IntraEncoder(quality=q, debug_checks=True, device=dev)
        d_rgb = dbg.encode(frames)
        d_planes = dbg.encode_from_planes(jy, jcb, jcr)
        debug_s = time.perf_counter() - t0
        debug_counts[q] = read_launches()
        other = "lut_lookup" if must == "vlc_raw" else "vlc_raw"
        _check_launches(f"q={q} debug_checks path ({dbg.dct_impl}; encode + encode_from_planes, "
                        f"{debug_s:.2f} s)", debug_counts[q], (must, "pack_fused4_checked"),
                        ("vlc_fused4", "vlc_levels4", "pack_fused4", other, *fuse8_kernels,
                         *raw_pack_kernels))
        _check_equal(f"q={q} debug_checks encode", d_rgb, cpu_pair[0])
        _check_equal(f"q={q} debug_checks encode_from_planes", d_planes, cpu_pair[1])
    debug_counts["sum"] = debug_counts[QUALITY] + debug_counts[HQ_QUALITY]

    real_raw = mpeg1.vlc_raw

    def corrupt(*args):
        codes, lens, viol = real_raw(*args)
        lens[0, 5, 0] = 31  # a slot length over 30
        return codes, lens, viol

    mpeg1.vlc_raw = corrupt
    raised = None
    try:
        TorchMPEG1IntraEncoder(quality=QUALITY, debug_checks=True, device=dev).encode(frames[:2])
    except RuntimeError as e:
        if "invariant violations" not in str(e):
            raise
        raised = str(e)
    finally:
        mpeg1.vlc_raw = real_raw
    print(f"injected slot violation on the card: RuntimeError {raised!r}")
    if raised is None:
        raise AssertionError("an injected slot violation did not raise")

    # ---- 15. steady-state times, sanitizer -------------------------------
    torch.cuda.empty_cache()
    work["vlc_raw"] = (plane_bytes_hd + n_blocks_hd * 2 * 4 * 64 + n_rows_hd * 4,
                       n_blocks_hd * (OPS_DCT_BLOCK + OPS_EMIT_BLOCK))
    work["lut_lookup"] = (8 * ranks.numel() + ac_tab.numel() * 4, OPS_LOOKUP * ranks.numel())
    work["pack_fused4_checked"] = (work["pack_fused4"][0] + n_rows_hd * 4,
                                   OPS_PACK_SLOT * sl_hd[4].numel())
    for name, kernel, twin, args, where in (
        ("vlc_raw", cuda_vlc_raw.vlc_raw, cuda_vlc_raw.vlc_raw_plain,
         (*planes_hd, core.qw, luts), f"16x1080p q={QUALITY}"),
        ("lut_lookup", cuda_lut.lut_lookup, cuda_lut.lut_lookup_plain,
         (ranks, ac_tab), f"{ranks.numel()} AC ranks, 16x1080p q={HQ_QUALITY}"),
        ("pack_fused4_checked", lambda *a: cuda_pack.pack_fused4(*a, checks=True),
         lambda *a: cuda_pack.pack_fused4_plain(*a, checks=True), (*sl_hd, mw_hd),
         f"16x1080p q={QUALITY}"),
    ):
        times[name] = (_event_ms(torch, lambda: kernel(*args), 20),
                       _event_ms(torch, lambda: twin(*args), 3))
        print(f"{name} at {where}: kernel {times[name][0]:.4f} ms, "
              f"plain twin {times[name][1]:.4f} ms {tag}")
    dms = _device_ms(torch, lambda: cuda_pack.pack_fused4(*sl_hd, mw_hd, checks=True), 20)
    print(f"pack_fused4_checked at 16x1080p q={QUALITY}: device time (profiler records) {dms} "
          f"{tag}")
    # one PyTorch call computing the same function: B5's lookup is a gather
    # (every AC rank lies inside the table)
    library = {"lut_lookup": _event_ms(torch, lambda: ac_tab[ranks], 20)}
    print(f"lut_lookup's library call (ac_tab[ranks]): {library['lut_lookup']:.4f} ms {tag}")
    for q in (QUALITY, HQ_QUALITY):
        dbg = TorchMPEG1IntraEncoder(quality=q, debug_checks=True, device=dev)
        for label, fn in (("encode", lambda: dbg.encode(frames)),
                          ("encode_from_planes", lambda: dbg.encode_from_planes(jy, jcb, jcr))):
            fps, ms = _frames_per_s(torch, fn, BATCH, 3)
            print(f"debug_checks {label} 16x1080p q={q}: {fps:.2f} frames/s "
                  f"({ms:.2f} ms per batch) {tag}")
    del hq_in, hq_levels, ranks, dbg

    # ---- 16. B6b and B6c against their twins -----------------------------
    torch.cuda.empty_cache()
    b6b_err = 0
    slots8 = {}
    for name, planes, qw, key in plane_cases:
        got = cuda_vlc.vlc_fused8(*planes, qw, luts)
        want = cuda_vlc.vlc_fused8_plain(*planes, qw, luts)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        b6b_err = max(b6b_err, err)
        print(f"B6b vlc_fused8 vs twin, {name}: slots {tuple(got[1].shape)}, "
              f"max flen {int(got[1].max())}, max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"B6b disagrees with its twin on {name}")
        if key is not None:
            slots8[key] = got
    del want, plane_cases, planes_pattern, last62
    b6c_err = 0
    for name, key, mw, must_overflow in (
        ("16x1080p, auto buffer (shared memory)", "16x1080p", msb_hd // 4, False),
        ("noise, 2560 B buffer (overflows)", f"2x{oh}x{ow} noise", 640, True),
        ("noise, 342528 B buffer (global memory)", f"2x{oh}x{ow} noise", 342528 // 4, False),
    ):
        got = cuda_pack.pack_fused8(*slots8[key], mw, bit_offset=38)
        want = cuda_pack.pack_fused8_plain(*slots8[key], mw, bit_offset=38)
        via4 = cuda_pack.pack_fused4(*slots[key], mw, bit_offset=38)  # B1 + B2: the same stream
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        b6c_err = max(b6c_err, err)
        over = int((got[1] > 32 * mw).sum())
        same4 = _max_abs_err(torch, got, via4) == 0
        print(f"B6c pack_fused8 vs twin, {name}: {got[0].shape[0]} slices, "
              f"max nbits {int(got[1].max())}, {over} over the buffer, max_abs_err {err}, "
              f"equal to B2 on the 4:1 slots {same4}")
        if err != 0 or not same4:
            raise AssertionError(f"B6c disagrees with its twin or B2 on {name}")
        if must_overflow and over == 0:
            raise AssertionError(f"{name}: no slice overflowed")
    del got, want, via4

    # ---- 17. the 8:1-fusion path -----------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    f8 = TorchMPEG1IntraEncoder(quality=QUALITY, fuse=8, device=dev)
    f8_rgb = f8.encode(frames)
    f8_planes = TorchMPEG1IntraEncoder(quality=QUALITY, fuse=8, device=dev).encode_from_planes(
        jy, jcb, jcr)
    regrow8 = TorchMPEG1IntraEncoder(quality=QUALITY, fuse=8, max_slice_bytes=2560, device=dev)
    f8_regrow = regrow8.encode(regrow_frames)
    f8_s = time.perf_counter() - t0
    f8_launches = read_launches()
    _check_launches(f"q={QUALITY} fuse=8 path (encode + encode_from_planes + regrow encode, "
                    f"{f8_s:.2f} s)", f8_launches, fuse8_kernels,
                    ("vlc_fused4", "pack_fused4", "vlc_levels4", "vlc_compat_slots",
                     "vlc_compat_fused4", "compat_color", *sanitizer_kernels, *raw_pack_kernels))
    if regrow8.max_slice_bytes <= 2560:
        raise AssertionError("the fuse=8 forced-regrow run did not regrow")
    print(f"fuse=8 regrow: 2560 B -> {regrow8.max_slice_bytes} B per slice")
    for name, got, want in (("fuse=8 encode", f8_rgb, cpu_rgb),
                            ("fuse=8 encode_from_planes", f8_planes, cpu_planes),
                            ("fuse=8 regrow encode", f8_regrow, cpu_regrow)):
        _check_equal(name, got, want)

    # ---- 18. steady-state times, fuse=8 ----------------------------------
    w8_hd, fl8_hd = slots8["16x1080p"]
    times["vlc_fused8"] = (
        _event_ms(torch, lambda: cuda_vlc.vlc_fused8(*planes_hd, core.qw, luts), 20),
        _event_ms(torch, lambda: cuda_vlc.vlc_fused8_plain(*planes_hd, core.qw, luts), 3),
    )
    times["pack_fused8"] = (
        _event_ms(torch, lambda: cuda_pack.pack_fused8(w8_hd, fl8_hd, mw_hd), 20),
        _event_ms(torch, lambda: cuda_pack.pack_fused8_plain(w8_hd, fl8_hd, mw_hd), 3),
    )
    work["vlc_fused8"] = (plane_bytes_hd + 9 * 4 * fl8_hd.numel(),
                          n_blocks_hd * (OPS_DCT_BLOCK + OPS_EMIT_BLOCK))
    work["pack_fused8"] = (9 * 4 * fl8_hd.numel() + n_rows_hd * (msb_hd + 4),
                           OPS_PACK_SLOT * fl8_hd.numel())
    for name in fuse8_kernels:
        print(f"{name} at 16x1080p: kernel {times[name][0]:.4f} ms, "
              f"plain twin {times[name][1]:.4f} ms {tag}")
    for label, fn in (("encode", lambda: f8.encode(frames)),
                      ("encode_from_planes", lambda: f8.encode_from_planes(jy, jcb, jcr))):
        fps, ms = _frames_per_s(torch, fn, BATCH, 5)
        print(f"fuse=8 {label} 16x1080p q={QUALITY}: {fps:.2f} frames/s "
              f"({ms:.2f} ms per batch) {tag}")

    # ---- 19. K1-K4 against their twins ------------------------------------
    del w8_hd, fl8_hd, slots8
    torch.cuda.empty_cache()
    raw = {f"16x1080p q={QUALITY}": core.raw_slots(*planes_hd),
           f"2x{oh}x{ow} noise q=100": q100.raw_slots(*planes_odd)}
    raw_err = dict.fromkeys(raw_pack_kernels, 0)
    for (sname, (codes, lens)), (bname, mw, must_overflow) in itertools.product(
            raw.items(), (("auto buffer", msb_hd // 4, False), ("2560 B buffer", 640, True),
                          ("342528 B buffer", 342528 // 4, False))):
        want = cuda_pack.pack_raw_plain(codes, lens, mw, bit_offset=38)
        via_b2 = cuda_pack.pack_fused4(*(cuda_vlc.to_i32_bits(t) for t in fuse4(codes, lens)),
                                       mw, bit_offset=38)
        if _max_abs_err(torch, via_b2, want) != 0:
            raise AssertionError(f"B2 on the fused raw slots differs from the raw twin, {sname}")
        over = int((want[1] > 32 * mw).sum())
        if must_overflow and over == 0:
            raise AssertionError(f"{sname}, {bname}: no slice overflowed")
        for name, kernel, twin in raw_packs.values():
            got = kernel(codes, lens, mw, bit_offset=38)
            twin_out = want if twin is cuda_pack.pack_raw_plain else twin(codes, lens, mw, bit_offset=38)
            torch.cuda.synchronize()
            err = _max_abs_err(torch, got, twin_out)
            raw_err[name] = max(raw_err[name], err)
            same_b2 = _max_abs_err(torch, got, via_b2) == 0
            print(f"{name} vs twin, {sname}, {bname}: {lens.shape[0]} slices of {lens.shape[1]} "
                  f"slots, {over} over the buffer, max_abs_err {err}, equal to B2 on the 4:1 "
                  f"fusion {same_b2}")
            if err != 0 or not same_b2:
                raise AssertionError(f"{name} disagrees with its twin or B2, {sname}, {bname}")
        del want, via_b2, got, twin_out
    codes_hd, lens_hd = raw[f"16x1080p q={QUALITY}"]
    del raw
    torch.cuda.empty_cache()
    # K3 and K4 edge cases at the full 1,088 x 46,080 (and an odd K of
    # 4,095): every length 0, 1 or 32; runs of empty codes across their
    # chunks (2,048 codes) and tiles (4,096); buffers of the auto size,
    # exactly the longest row's words and 342,528 B
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for content, k in (("zeros", 46080), ("ones", 46080), ("all32", 46080),
                       ("zero-runs", 46080), ("random", 4095)):
        n = lens_hd.shape[0]
        if content in ("zeros", "ones", "all32"):
            e_lens = torch.full((n, k), {"zeros": 0, "ones": 1, "all32": 32}[content],
                                dtype=torch.int32, device=dev)
        else:
            e_lens = torch.randint(0 if content == "random" else 1, 31, (n, k), generator=gen,
                                   dtype=torch.int32, device=dev)
            if content == "zero-runs":
                e_lens[:, 3000:9500] = 0
                e_lens[:, 20000:30001] = 0
        e_codes = cuda_vlc.to_i32_bits(
            torch.randint(0, 1 << 32, (n, k), generator=gen, dtype=torch.int64, device=dev)
            & ((1 << e_lens.long()) - 1))
        used = max(-(-(38 + int(e_lens.sum(dim=1, dtype=torch.int64).max())) // 32), 1)
        for bname, mw in (("auto buffer", msb_hd // 4), (f"{used}-word buffer (used)", used),
                          ("342528 B buffer", 342528 // 4)):
            want = cuda_pack.pack_raw_plain(e_codes, e_lens, mw, bit_offset=38)
            over = int((want[1] > 32 * mw).sum())
            for name in ("pack_windows", "pack_split"):
                got = getattr(cuda_pack_split, name)(e_codes, e_lens, mw, bit_offset=38)
                torch.cuda.synchronize()
                err = _max_abs_err(torch, got, want)
                raw_err[name] = max(raw_err[name], err)
                print(f"{name} vs twin, {content}, {n} x {k}, {bname}: {over} over the buffer, "
                      f"max_abs_err {err}")
                if err != 0:
                    raise AssertionError(f"{name} disagrees with its twin, {content}, {bname}")
            del want, got
        del e_codes, e_lens
    # K1 and K2 at their tile edges (512 codes a tile): one code short,
    # one tile, one code past it (not a multiple of 4: scalar loads)
    for content, k in itertools.product(("random", "ones", "all32"), (511, 512, 513)):
        n = lens_hd.shape[0]
        if content == "random":
            e_lens = torch.randint(0, 33, (n, k), generator=gen, dtype=torch.int32, device=dev)
        else:
            e_lens = torch.full((n, k), {"ones": 1, "all32": 32}[content], dtype=torch.int32,
                                device=dev)
        e_codes = cuda_vlc.to_i32_bits(
            torch.randint(0, 1 << 32, (n, k), generator=gen, dtype=torch.int64, device=dev)
            & ((1 << e_lens.long()) - 1))
        used = max(-(-(38 + int(e_lens.sum(dim=1, dtype=torch.int64).max())) // 32), 1)
        for mw, (name, kernel, twin) in itertools.product(
                (used, 7, 342528 // 4), (raw_packs["pallas1"], raw_packs["fused2w"])):
            want = twin(e_codes, e_lens, mw, bit_offset=38)
            got = kernel(e_codes, e_lens, mw, bit_offset=38)
            torch.cuda.synchronize()
            err = _max_abs_err(torch, got, want)
            raw_err[name] = max(raw_err[name], err)
            print(f"{name} vs twin, {content}, {n} x {k}, {mw}-word buffer: "
                  f"{int((want[1] > 32 * mw).sum())} over the buffer, max_abs_err {err}")
            if err != 0:
                raise AssertionError(f"{name} disagrees with its twin, {content}, {k} codes")
        del e_codes, e_lens, want, got
    # K1 and K2 on the 16 x 1080p raw slots one element off alignment
    off_codes, off_lens = _unaligned(torch, codes_hd), _unaligned(torch, lens_hd)
    for name, kernel, twin in (raw_packs["pallas1"], raw_packs["fused2w"]):
        got = kernel(off_codes, off_lens, mw_hd, bit_offset=38)
        want = twin(codes_hd, lens_hd, mw_hd, bit_offset=38)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        raw_err[name] = max(raw_err[name], err)
        print(f"{name} vs twin, 16x1080p q={QUALITY} raw slots one element off alignment: "
              f"max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its twin off alignment")
    del off_codes, off_lens, want, got
    torch.cuda.empty_cache()

    # ---- 20. the generic route: pack= ------------------------------------
    route_counts = {}
    others = ("vlc_fused4", "pack_fused4", "vlc_levels4", "vlc_raw", "pack_fused4_checked",
              "vlc_compat_slots", "vlc_compat_fused4", "compat_color", *fuse8_kernels)
    for pack, (name, _, _) in raw_packs.items():
        reset_launches()
        t0 = time.perf_counter()
        r_rgb = TorchMPEG1IntraEncoder(quality=QUALITY, pack=pack, device=dev).encode(frames)
        r_planes = TorchMPEG1IntraEncoder(quality=QUALITY, pack=pack, device=dev).encode_from_planes(
            jy, jcb, jcr)
        r_grow = TorchMPEG1IntraEncoder(quality=QUALITY, pack=pack, max_slice_bytes=2560,
                                        device=dev)
        r_regrow = r_grow.encode(regrow_frames)
        r_s = time.perf_counter() - t0
        route_counts[name] = read_launches()
        _check_launches(f"q={QUALITY} pack={pack!r} path (encode + encode_from_planes + regrow "
                        f"encode, {r_s:.2f} s)", route_counts[name], ("lut_lookup", name),
                        (*others, *(k for k in raw_pack_kernels if k != name)))
        if r_grow.max_slice_bytes <= 2560:
            raise AssertionError(f"the pack={pack!r} forced-regrow run did not regrow")
        print(f"pack={pack!r} regrow: 2560 B -> {r_grow.max_slice_bytes} B per slice")
        for label, got, want in (("encode", r_rgb, cpu_rgb),
                                 ("encode_from_planes", r_planes, cpu_planes),
                                 ("regrow encode", r_regrow, cpu_regrow)):
            _check_equal(f"pack={pack!r} {label}", got, want)
    reset_launches()
    hq_route = TorchMPEG1IntraEncoder(quality=HQ_QUALITY, pack="fused", device=dev)
    _check_equal(f"q={HQ_QUALITY} pack='fused' encode", hq_route.encode(frames), cpu_hq_rgb)
    _check_equal(f"q={HQ_QUALITY} pack='fused' encode_from_planes",
                 hq_route.encode_from_planes(jy, jcb, jcr), cpu_hq_planes)
    _check_launches(f"q={HQ_QUALITY} pack='fused' path ({hq_route.dct_impl})", read_launches(),
                    ("lut_lookup", "pack_split"), (*others, "pack_raw", "pack_windows", "pack_pairs"))
    del hq_route

    # ---- 21. steady-state times, the generic route ------------------------
    n_raw = lens_hd.numel()
    for name, kernel, twin in raw_packs.values():
        times[name] = (
            _event_ms(torch, lambda: kernel(codes_hd, lens_hd, mw_hd), 20),
            _event_ms(torch, lambda: twin(codes_hd, lens_hd, mw_hd), 3),
        )
        # codes and lengths read once, the slice buffers and bit counts written
        work[name] = (8 * n_raw + n_rows_hd * (msb_hd + 4), OPS_PACK_SLOT * n_raw)
        print(f"{name} at 16x1080p q={QUALITY} ({n_raw} raw slots): kernel {times[name][0]:.4f} "
              f"ms, plain twin {times[name][1]:.4f} ms {tag}")
    # one frame: 68 slices for the card's 132 SMs, where spreading a slice
    # over many blocks (K3, K4) could pay; a call there is short enough
    # that the event time also holds the host's launch cost, so the
    # device time of its kernels and memsets is read from the profiler too
    mbh_hd = planes_hd[0].shape[1] // 16
    one = (codes_hd[:mbh_hd], lens_hd[:mbh_hd])
    for name, kernel, _ in raw_packs.values():
        ms = _event_ms(torch, lambda: kernel(*one, mw_hd), 20)
        dms = [_device_ms(torch, lambda: kernel(*args, mw_hd), 20)
               for args in (one, (codes_hd, lens_hd))]
        print(f"{name} at 1x1080p ({one[1].shape[0]} slices): kernel {ms:.4f} ms (events); device "
              f"time (profiler records) {dms[0]}, at 16x1080p {dms[1]} {tag}")
    del codes_hd, lens_hd, one
    torch.cuda.empty_cache()
    for pack in raw_packs:
        enc_r = TorchMPEG1IntraEncoder(quality=QUALITY, pack=pack, device=dev)
        for label, fn in (("encode", lambda: enc_r.encode(frames)),
                          ("encode_from_planes", lambda: enc_r.encode_from_planes(jy, jcb, jcr))):
            fps, ms = _frames_per_s(torch, fn, BATCH, 3)
            print(f"pack={pack!r} {label} 16x1080p q={QUALITY}: {fps:.2f} frames/s "
                  f"({ms:.2f} ms per batch) {tag}")

    # ---- 22. the coefficients intake (encode_from_coeffs) ------------------
    torch.cuda.empty_cache()
    coeffs = _jpeg_coeffs(np, planes_hd, SEED + 22)
    del planes_hd
    h, w = HEIGHT, WIDTH
    n_coeffs = sum(c.size for c in coeffs)
    t0 = time.perf_counter()
    cpu_planes = mpeg1.coeffs_to_planes(*(torch.from_numpy(c).int() for c in coeffs), h, w)
    cpu_crop = jpeg_device.decode_planes_from_coeffs(*(torch.from_numpy(c) for c in coeffs), h, w)
    print(f"coefficients of {BATCH} x {h}x{w} (JPEG Annex K tables at quality 75, dequantized, "
          f"int16; {n_coeffs} of them, int16 extremes in frame 0): the CPU IDCT took "
          f"{time.perf_counter() - t0:.2f} s on the host")
    dev16 = [torch.from_numpy(c).to(dev) for c in coeffs]
    card_planes = mpeg1.coeffs_to_planes(*(c.int() for c in dev16), h, w)
    torch.cuda.synchronize()
    idct_err = _max_abs_err(torch, card_planes, [p.to(dev) for p in cpu_planes])
    print(f"IDCT and padding on the card vs the CPU: planes {[tuple(p.shape) for p in card_planes]}, "
          f"max_abs_err {idct_err}")
    if idct_err != 0:
        raise AssertionError("the card's IDCT planes differ from the CPU's")
    del card_planes, cpu_planes
    planes_np = [p.numpy() for p in cpu_crop]
    for label, kw, must in (
        (f"q={QUALITY}", {"quality": QUALITY}, ("vlc_fused4", "pack_fused4")),
        (f"q={HQ_QUALITY}", {"quality": HQ_QUALITY}, ("vlc_levels4", "pack_fused4")),
        (f"q={QUALITY} fuse=8", {"quality": QUALITY, "fuse": 8}, fuse8_kernels),
        (f"q={QUALITY} from a 2560 B buffer", {"quality": QUALITY, "max_slice_bytes": 2560},
         ("vlc_fused4", "pack_fused4")),
    ):
        reset_launches()
        enc_c = TorchMPEG1IntraEncoder(device=dev, **kw)
        got = enc_c.encode_from_coeffs(*coeffs, h, w)
        _check_launches(f"encode_from_coeffs {label}", read_launches(), must)
        if "max_slice_bytes" in kw:
            if enc_c.max_slice_bytes <= 2560:
                raise AssertionError("the encode_from_coeffs forced-regrow run did not regrow")
            print(f"encode_from_coeffs regrow: 2560 B -> {enc_c.max_slice_bytes} B per slice")
        want = TorchMPEG1IntraEncoder(device=dev, **kw).encode_from_planes(*planes_np)
        print(f"encode_from_coeffs {label}: {len(got)} B, encode_from_planes on the CPU IDCT's "
              f"planes {len(want)} B, equal {got == want}")
        if got != want:
            raise AssertionError(f"encode_from_coeffs {label} differs from encode_from_planes")
    stage = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpeg1.coeffs_to_planes(*(c.int() for c in dev16), h, w)
        torch.cuda.synchronize()
        stage.append(1e3 * (time.perf_counter() - t0))
    floor_ms = 1e3 * (2 * n_coeffs + sum(p.numel() for p in out)) / MEM_BYTES_PER_S
    print(f"IDCT + padding stage on the card, {BATCH} x {h}x{w}: median "
          f"{sorted(stage)[len(stage) // 2]:.4f} ms (min {min(stage):.4f}) against a bytes floor "
          f"of {floor_ms:.4f} ms ({2 * n_coeffs / 1e6:.1f} MB int16 in, "
          f"{sum(p.numel() for p in out) / 1e6:.1f} MB u8 out) {tag}")
    del out, dev16
    enc_c = TorchMPEG1IntraEncoder(quality=QUALITY, device=dev)
    for label, fn in (("encode_from_coeffs", lambda: enc_c.encode_from_coeffs(*coeffs, h, w)),
                      ("encode_from_planes", lambda: enc_c.encode_from_planes(*planes_np))):
        fps, ms = _frames_per_s(torch, fn, BATCH, 3)
        print(f"{label} 16x1080p q={QUALITY}: {fps:.2f} frames/s ({ms:.2f} ms per batch) {tag}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")

    # ---- 23. the entry points: JPEG folders, the CLI, the API, the C ABI shim
    entry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    pool = None
    clis = []
    try:
        ps_path, ps_jpegs = _entry_points(entry_dir, tag, reset_launches, read_launches)

        # ---- 25. the sharded encoder on the one card: before phase 24's decodes
        # start, so that its frames/s have the host to themselves
        from ec504_imageencoder_tpu_torch.parallel.mesh import make_mesh
        from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import (
            ShardedTorchMPEG1Encoder,
        )

        def sharded(shape, **kw):
            return ShardedTorchMPEG1Encoder(mesh=make_mesh(*shape, [dev] * (shape[0] * shape[1])),
                                            **kw)

        def shard_run(label, shape, n_shards, fn, want, must):
            reset_launches()
            got = fn()
            counts = read_launches()
            print(f"mesh {shape} {label}: {len(got)} B, unsharded card bytes {len(want)} B, "
                  f"equal {got == want}, launches {({k: counts[k] for k in must})}")
            if got != want:
                raise AssertionError(f"mesh {shape} {label} differs from the unsharded bytes")
            if any(counts[k] != n_shards for k in must):
                raise AssertionError(f"mesh {shape} {label}: not {n_shards} launches of {must}")

        sh_runs = (  # label, keywords, intake, unsharded card bytes, kernels
            (f"encode q={QUALITY}", {"quality": QUALITY}, "rgb", es_rgb,
             ("vlc_fused4", "pack_fused4")),
            (f"encode_from_planes q={QUALITY}", {"quality": QUALITY}, "planes", es_planes,
             ("vlc_fused4", "pack_fused4")),
            (f"encode q={QUALITY} fuse=8", {"quality": QUALITY, "fuse": 8}, "rgb", f8_rgb,
             fuse8_kernels),
            (f"encode_from_planes q={QUALITY} fuse=8", {"quality": QUALITY, "fuse": 8}, "planes",
             f8_planes, fuse8_kernels),
            (f"encode q={HQ_QUALITY}", {"quality": HQ_QUALITY}, "rgb", hq_rgb,
             ("vlc_levels4", "pack_fused4")),
            (f"encode_from_planes q={HQ_QUALITY}", {"quality": HQ_QUALITY}, "planes", hq_planes,
             ("vlc_levels4", "pack_fused4")),
        )
        def rate_pair(e):
            return [_frames_per_s(torch, lambda: e.encode(frames), BATCH, 5)[0],
                    _frames_per_s(torch, lambda: e.encode_from_planes(jy, jcb, jcr), BATCH, 5)[0]]

        rates = {"unsharded, before the meshes": rate_pair(enc)}
        t_sh = time.perf_counter()
        for shape in ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2)):
            n_shards = shape[0] * shape[1]
            for label, kw, intake, want, must in sh_runs:
                enc_s = sharded(shape, **kw)
                run = ((lambda e=enc_s: e.encode(frames)) if intake == "rgb" else
                       (lambda e=enc_s: e.encode_from_planes(jy, jcb, jcr)))
                shard_run(label, shape, n_shards, run, want, must)
            rates[f"mesh {shape}"] = rate_pair(sharded(shape, quality=QUALITY))
        rates["unsharded, after the meshes"] = rate_pair(enc)
        dbg = sharded((2, 2), quality=QUALITY, debug_checks=True)
        shard_run(f"encode q={QUALITY} debug_checks", (2, 2), 4, lambda: dbg.encode(frames),
                  es_rgb, ("vlc_raw", "pack_fused4_checked"))
        grow = sharded((2, 2), quality=QUALITY, max_slice_bytes=2560)
        shard_run(f"regrow encode q={QUALITY} from 2560 B (two runs a shard)", (2, 2), 8,
                  lambda: grow.encode(regrow_frames), es_regrow, ("vlc_fused4", "pack_fused4"))
        if grow.max_slice_bytes <= 2560:
            raise AssertionError("the sharded forced-regrow run did not regrow")
        want_err = ("padded frame has 68 MB rows, not divisible by the rows mesh axis (3); "
                    "pick n_rows dividing 68")
        try:
            sharded((1, 3), quality=QUALITY).encode(frames)
            raise AssertionError("mesh (1, 3) did not raise on 68 MB rows")
        except ValueError as e:
            print(f"mesh (1, 3): ValueError {str(e)!r}")
            if str(e) != want_err:
                raise
        print(f"sharded encodes on cuda:0, 5 meshes x 6 runs + 2: "
              f"{time.perf_counter() - t_sh:.2f} s {tag}")
        for key, (rgb_fps, planes_fps) in rates.items():
            print(f"{key} on cuda:0, 16x1080p q={QUALITY}: encode {rgb_fps:.2f} frames/s, "
                  f"encode_from_planes {planes_fps:.2f} frames/s {tag}")
        if torch.cuda.device_count() >= 2:
            two = [torch.device("cuda", 0), torch.device("cuda", 1)]
            with torch.cuda.device(1):
                got = ShardedTorchMPEG1Encoder(quality=QUALITY, mesh=make_mesh(2, 1, two)).encode(
                    frames)
                kept = torch.cuda.current_device() == 1
            _check_equal("mesh (2, 1) over cuda:0 and cuda:1", got, cpu_rgb)
            print(f"mesh (2, 1) over two cards with cuda:1 current: current device kept {kept}")
            if not kept:
                raise AssertionError("a two-card encode changed the current device (C-h5)")
        else:
            print(f"multi-card claim unverified: {torch.cuda.device_count()} CUDA device "
                  "visible, so no mesh spans two cards and hazard C-h5 across cards is not shown")

        # ---- 24. the port's decoder: started here, read after phase 26 --------
        from concurrent.futures import ProcessPoolExecutor

        from ec504_imageencoder_tpu_torch.io.jpeg import load_folder
        from ec504_imageencoder_tpu_torch.models.decoder import decode_es, decode_stream, psnr
        from ec504_imageencoder_tpu_torch.syntax.headers import sequence_end

        dec_dir = entry_dir / "decode"
        dec_dir.mkdir()
        np.save(dec_dir / "frames.npy", frames)
        np.save(dec_dir / "ps_frames.npy", load_folder(str(ps_jpegs))[0])
        decodes = {  # name -> (stream, colour range, source frames, PSNR floor key)
            f"16x1080p rgb q={QUALITY}": (es_rgb + sequence_end(), "studio", "frames.npy",
                                          f"q={QUALITY}"),
            f"16x1080p rgb q={HQ_QUALITY}": (hq_rgb + sequence_end(), "studio", "frames.npy",
                                             f"q={HQ_QUALITY}"),
            "phase 23's --container ps stream, 4 x 1080p q=50": (ps_path.read_bytes(), "studio",
                                                                 "ps_frames.npy", "ps"),
            "compat golden stream": (gold_mpeg, "full", None, None),
        }
        t_dec = time.perf_counter()
        pool = ProcessPoolExecutor(max_workers=len(decodes),
                                   mp_context=multiprocessing.get_context("spawn"))
        jobs = {}
        for i, (name, (data, cr, ref, _)) in enumerate(decodes.items()):
            path = dec_dir / f"stream_{i}.mpeg"
            path.write_bytes(data)
            jobs[name] = pool.submit(_decode_job, str(path), cr, ref and str(dec_dir / ref))
        # mpeg-decode-torch (its module, as the console script runs it) on the
        # program stream: PPM with --psnr-ref, and the default format
        cli_runs = {"ppm": ["-o", dec_dir / "ppm", "--format", "ppm", "--psnr-ref", ps_jpegs],
                    "default format": ["-o", dec_dir / "default"]}
        for flags in cli_runs.values():
            clis.append(subprocess.Popen(
                [sys.executable, "-m", "ec504_imageencoder_tpu_torch.decode_cli", str(ps_path),
                 *map(str, flags)], cwd=ROOT, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=dict(os.environ, PYTHONPATH=str(ROOT))))
        # the scalar spec oracle against decode_stream on a small card-made stream
        small = TorchMPEG1IntraEncoder(quality=QUALITY, device=dev).encode(
            frames[:2, :144, :176]) + sequence_end()
        t0 = time.perf_counter()
        slow = decode_es(small)
        slow_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fast = decode_stream(small)
        fast_s = time.perf_counter() - t0
        same = len(slow) == len(fast) == 2 and all(
            a.shape == (144, 176, 3) and np.array_equal(a, b) for a, b in zip(slow, fast))
        small_psnr = [round(float(psnr(a, b)), 4) for a, b in zip(frames[:2, :144, :176], fast)]
        print(f"decode_es (scalar oracle) vs decode_stream, 2 x 144x176 q={QUALITY} from the "
              f"card: pixels equal {same}, PSNR {small_psnr} dB; "
              f"{slow_s:.3f} s against {fast_s:.3f} s on the host {tag}")
        if not same:
            raise AssertionError("decode_es and decode_stream disagree")

        # ---- 26. two processes on the one card: encode_multihost over gloo ------
        mh = entry_dir / "multihost"
        mh.mkdir()
        mh_frames = np.ascontiguousarray(frames[:MULTIHOST_FRAMES])
        np.save(mh / "frames.npy", mh_frames)
        (mh / "child.py").write_text(_MULTIHOST_CHILD)
        t0 = time.perf_counter()
        want_mh = TorchMPEG1IntraEncoder(quality=QUALITY, gop_size=1, device=dev).encode(
            mh_frames) + sequence_end()
        one_s = time.perf_counter() - t0

        def job(wd, name, env=None):
            return _two_processes(mh / "child.py", (mh / wd, mh / name, mh / f"{wd}.log",
                                                    mh / "frames.npy", QUALITY), env)

        rcs, outs, wall = job("wd", "out.mpeg")
        if rcs != [0, 0]:
            raise AssertionError(f"encode_multihost returned {rcs}: {outs[0][1][-2000:]}"
                                 f"{outs[1][1][-2000:]}")
        print(f"encode_multihost, 2 processes on cuda:0 over gloo: {outs[0][0].strip()!r}, "
              f"{outs[1][0].strip()!r}")
        _check_equal(f"encode_multihost stitched stream ({MULTIHOST_FRAMES} x 1080p, GOPs of 1)",
                     (mh / "out.mpeg").read_bytes(), want_mh, "one process's encode")
        print(f"encode_multihost wall time {wall:.2f} s for {MULTIHOST_FRAMES} frames (two "
              f"processes started, torch imported, the card reached, encoded, stitched); one "
              f"process's encode in this process {one_s:.3f} s {tag}")
        rcs, outs, wall1 = job("drill", "drill.mpeg", {"EC504_DRILL": "die"})
        segs = sorted(p.name for p in (mh / "drill").glob("*.m1vseg"))
        print(f"fault drill, first run: return codes {rcs}, segments {segs}")
        if rcs != [0, 42] or (mh / "drill.mpeg").exists() or segs != [
                f"seg_00000{g}.m1vseg" for g in (0, 1, 2, 4)]:
            raise AssertionError(f"the fault drill's first run went wrong: {outs[0][1][-2000:]}"
                                 f"{outs[1][1][-2000:]}")
        rcs, outs, wall2 = job("drill", "drill.mpeg")
        again = [tuple(map(int, ln.split())) for ln in
                 (mh / "drill.log").read_text().splitlines()][4:]
        print(f"fault drill, restart: return codes {rcs}, re-encoded (rank, start, end) "
              f"{sorted(again)}; {wall1:.2f} s + {wall2:.2f} s {tag}")
        if rcs != [0, 0] or sorted(again) != [(1, 3, 4), (1, 5, 6)]:
            raise AssertionError(f"the restart re-encoded {again}: {outs[0][1][-2000:]}"
                                 f"{outs[1][1][-2000:]}")
        _check_equal("fault drill, stitched after the restart", (mh / "drill.mpeg").read_bytes(),
                     want_mh, "one process's encode")

        # ---- 24, read: the decodes and mpeg-decode-torch --------------------------
        for name, (_, _, _, floor) in decodes.items():
            r = jobs[name].result(timeout=600)
            if floor is None:
                print(f"decode {name}: {r.get('error')!r} after {r['s']:.2f} s {tag}; the "
                      f"reference's decoder on the CPU: {GOLDEN_DECODE_ERROR!r}")
                if r.get("error") != GOLDEN_DECODE_ERROR:
                    raise AssertionError(f"decoding the {name} went otherwise than the reference")
                continue
            if "error" in r:
                raise AssertionError(f"decode {name}: {r['error']}")
            n_want = 4 if floor == "ps" else BATCH
            mean, least = float(np.mean(r["psnr"])), min(r["psnr"])
            f_mean, f_least = PSNR_FLOORS[floor]
            print(f"decode {name}: {r['frames']} frames {r['shapes']}, PSNR mean {mean!r} dB, "
                  f"least {least!r} dB (floors {f_mean}, {f_least}); {r['frames'] / r['s']:.3f} "
                  f"frames/s on the host ({r['s']:.2f} s in one worker process, {len(decodes)} "
                  f"decodes, 2 CLI decodes and phase 26 running beside it; {os.cpu_count()} "
                  f"host cores) "
                  f"{tag}")
            if r["frames"] != n_want or r["shapes"] != [(HEIGHT, WIDTH, 3)]:
                raise AssertionError(f"decode {name}: wrong frame count or shape")
            if mean < f_mean or least < f_least:
                raise AssertionError(f"decode {name}: PSNR below its CPU-derived floor")
        outs = [p.communicate(timeout=600) for p in clis]
        for (label, flags), p, (out, err) in zip(cli_runs.items(), clis, outs):
            folder = Path(flags[1])
            files = sorted(f.name for f in folder.iterdir())
            print(f"mpeg-decode-torch {label}: rc {p.returncode}, stdout {out.strip()!r}, "
                  f"stderr {err.strip()[-300:]!r}, files {files}")
            if p.returncode != 0 or not out.startswith("decoded 4 frames, 1920x1080\n"):
                raise AssertionError(f"mpeg-decode-torch {label} failed")
            exts = {f.rsplit(".", 1)[1] for f in files}
            if len(files) != 4 or not (exts == {"ppm"} or (label != "ppm" and exts == {"png"})):
                raise AssertionError(f"mpeg-decode-torch {label} wrote {files}")
            if exts == {"ppm"} and label != "ppm" and "PIL unavailable" not in err:
                raise AssertionError("mpeg-decode-torch fell back to PPM without saying so")
            if label == "ppm":
                said = float(re.search(r"mean PSNR: ([0-9.]+) dB", out).group(1))
                if said < PSNR_FLOORS["ps"][0]:
                    raise AssertionError(f"mpeg-decode-torch --psnr-ref: {said} dB")
        print(f"phase 24's decodes took {time.perf_counter() - t_dec:.2f} s of wall time beside "
              f"phase 26 {tag}")
    finally:
        for p in clis:
            if p.poll() is None:
                p.kill()
                p.wait()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(entry_dir, ignore_errors=True)

    # ---- 27. device-side slice compaction and assemble's compacted form ------
    torch.cuda.empty_cache()
    planes_dev = [torch.from_numpy(p).to(dev) for p in mpeg1.pad_planes_to_macroblocks(jy, jcb, jcr)]
    for q, want, must in ((HQ_QUALITY, hq_planes, ("vlc_levels4", "pack_fused4")),
                          (QUALITY, es_planes, ("vlc_fused4", "pack_fused4"))):
        enc_k = TorchMPEG1IntraEncoder(quality=q, device=dev)
        _check_equal(f"phase 27 encode_from_planes q={q}", enc_k.encode_from_planes(jy, jcb, jcr),
                     want, "phase 4's or 8's bytes")
        msb = enc_k.max_slice_bytes
        reset_launches()
        seg, bits_dev = mpeg1.correct_pipeline_planes(enc_k.core, *planes_dev, msb)
        _check_launches(f"phase 27 q={q} slices", read_launches(), must)
        bits = bits_dev.cpu().numpy()
        if int(bits.max()) > 8 * msb or int(bits.min()) < 0:
            raise AssertionError(f"q={q}: a slice overflowed {msb} B or reported violations")
        n_slices, mw = seg.shape[0] * seg.shape[1], msb // 4
        # bench.py's capacity and its fetch, rounded up to 65,536 words
        cap = 1 << (n_slices * mw + mw - 1).bit_length()
        used_w = int(((bits.astype(np.int64) + 31) // 32).sum())
        fetch_w = min(-(-used_w // 65536) * 65536, cap)
        dense, offs = compact_slices(seg, bits_dev, cap)
        rows = split_compact_slices(dense[:fetch_w].cpu().numpy(), bits)
        _check_equal(f"q={q} assemble(compacted rows)", enc_k.assemble(rows, bits, WIDTH, HEIGHT),
                     want, "encode_from_planes")
        cpu_dense, cpu_offs = compact_slices(seg.cpu(), bits_dev.cpu(), cap)
        same = torch.equal(dense.cpu(), cpu_dense) and torch.equal(offs.cpu(), cpu_offs)
        print(f"q={q} compact_slices on the card vs the CPU: {cap} words, offsets "
              f"{tuple(offs.shape)}, word-equal {same}")
        if not same:
            raise AssertionError(f"q={q}: the card's compacted words differ from the CPU's")
        used = -(-int(bits.max()) // 8)
        bucket = min(max(256, 1 << max(used - 1, 1).bit_length()), msb)
        compact_ms = _event_ms(torch, lambda: compact_slices(seg, bits_dev, cap), 20)
        floor_ms = 1e3 * 2 * 4 * used_w / MEM_BYTES_PER_S
        dense_ms = _event_ms(torch, lambda: dense[:fetch_w].cpu(), 20)
        prefix_ms = _event_ms(torch, lambda: seg[:, :, :bucket].cpu(), 20)
        print(f"q={q} compact_slices, 16x1080p ({n_slices} slices of {msb} B, {used_w} used "
              f"words): {compact_ms:.4f} ms against a bytes floor of {floor_ms:.4f} ms {tag}")
        print(f"q={q} device-to-host copy: dense[:{fetch_w}] {4 * fetch_w} B in {dense_ms:.4f} ms, "
              f"the encoder's bucketed prefix seg[:, :, :{bucket}] {n_slices * bucket} B in "
              f"{prefix_ms:.4f} ms {tag}")
        del seg, bits_dev, dense, offs, cpu_dense, cpu_offs, rows
    del planes_dev
    print(f"chip_smoke: the whole run took {time.perf_counter() - t_start:.1f} s {tag}")

    src = "ec504_imageencoder_tpu_torch/csrc/"
    rows = [
        ("vlc_fused4", "vlc_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_vlc.py:556",
         launches, b1_err),
        ("pack_fused4", "pack_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:763",
         launches, b2_err),
        ("vlc_levels4", "vlc_levels4.cu", "ec504_imageencoder_tpu/ops/pallas_vlc.py:222",
         hq_launches, b3_err),
        ("f32_levels", "vlc_levels4.cu",
         "none: the reference's XLA einsum ops/dct.py::matmul_dct and elementwise ops",
         hq_launches, levels_err),
        ("vlc_compat_slots", "vlc_compat.cu", "ec504_imageencoder_tpu/ops/pallas_vlc.py:851",
         debug_launches, b4a_err),
        ("vlc_compat_fused4", "vlc_compat.cu", "ec504_imageencoder_tpu/ops/pallas_vlc.py:859",
         compat_launches, b4b_err),
        ("compat_color", "vlc_compat.cu",
         "none: the reference's host numpy ops/color.py::rgb_to_ycbcr_exact",
         compat_launches, color_err),
        ("vlc_raw", "vlc_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_vlc.py:468",
         debug_counts[QUALITY], b6a_err),
        ("lut_lookup", "lut_lookup.cu", "ec504_imageencoder_tpu/ops/mxu_lut.py:249",
         debug_counts[HQ_QUALITY], b5_err),
        ("pack_fused4_checked", "pack_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:763",
         debug_counts["sum"], b2c_err),
        ("vlc_fused8", "vlc_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_vlc.py:664",
         f8_launches, b6b_err),
        ("pack_fused8", "pack_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:980",
         f8_launches, b6c_err),
        # B6d and B6e: one function, one kernel (K1)
        ("pack_raw", "pack_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:65",
         route_counts["pack_raw"], raw_err["pack_raw"]),
        ("pack_raw", "pack_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:189",
         route_counts["pack_raw"], raw_err["pack_raw"]),
        ("pack_windows", "pack_split.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:288",
         route_counts["pack_windows"], raw_err["pack_windows"]),
        ("pack_split", "pack_split.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:416",
         route_counts["pack_split"], raw_err["pack_split"]),
        ("pack_pairs", "pack_fused4.cu", "ec504_imageencoder_tpu/ops/pallas_pack.py:610",
         route_counts["pack_pairs"], raw_err["pack_pairs"]),
    ]
    kernels = []
    for name, cu, replaces, counts, err in rows:
        bound_ms, bound_by = _bound(*work[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src + cu, "replaces": replaces,
            "launches": counts[name], "max_abs_err": err,
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library.get(name),
        })
        f32_ops = f", {work[name][2] / 1e9:.3f} G f32 ops" if len(work[name]) > 2 else ""
        print(f"{name}: {times[name][0]:.4f} ms against a bound of {bound_ms:.4f} ms "
              f"({bound_by}; {work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.3f} G int ops"
              f"{f32_ops}) {tag}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
