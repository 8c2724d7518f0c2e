#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's correct-mode main path once on one GPU.

Run from the repository root on a machine with one CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU path):

1. print the card's name and power limit (nvidia-smi) and build both
   CUDA kernels from ec504_imageencoder_tpu_torch/csrc/ (cold build time);
2. kernel B1 (vlc_fused4) against its plain PyTorch twin on the card, on
   16 x 1080p planes of natural content and on 1000 x 1400 noise: exact;
3. kernel B2 (pack_fused4) against its twin on those slots, including a
   slice buffer that overflows and one too large for shared memory: exact;
4. the main path: TorchMPEG1IntraEncoder(quality=50, device="cuda").encode()
   and .encode_from_planes() on 16 x 1080p frames, plus a forced slice
   regrow, byte-equal to the host numpy reference encoder; the stream
   decodes through the spec decoder (PSNR printed); both kernels' launch
   counts, reset just before, went up;
5. steady-state times with CUDA events: each kernel against its twin,
   and encode()/encode_from_planes() in frames/s with every output byte
   fetched to the host.

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
BATCH, HEIGHT, WIDTH = 16, 1080, 1920
QUALITY = 50


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


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


def _pad_planes(np, y, cb, cr):
    ph, pw = -y.shape[1] % 16, -y.shape[2] % 16
    y = np.pad(y, ((0, 0), (0, ph), (0, pw)), mode="edge")
    c = ((0, 0), (0, y.shape[1] // 2 - cb.shape[1]), (0, y.shape[2] // 2 - cb.shape[2]))
    return y, np.pad(cb, c, mode="edge"), np.pad(cr, c, mode="edge")


def _max_abs_err(torch, got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2

    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
    from ec504_imageencoder_tpu_torch.ops import _build, cuda_pack, cuda_vlc
    from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420
    from ec504_imageencoder_tpu_torch.shared import (
        MPEG1IntraEncoder,
        decode_es_fast,
        headers,
        psnr,
    )

    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    tag = f"[{gpu}]"
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    cuda_vlc.load_kernel()
    cuda_pack.load_kernel()
    cold_build_s = time.perf_counter() - t0
    for name, (secs, log) in sorted(_build.build_info.items()):
        print(f"build {name}: nvcc {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"cold kernel build + load: {cold_build_s:.2f} s {tag}")

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
    oh, ow = 1000, 1400
    noise = [rng.integers(0, 256, s, dtype=np.uint8)
             for s in ((2, oh, ow), (2, oh // 2, ow // 2), (2, oh // 2, ow // 2))]
    planes_odd = tuple(torch.from_numpy(p).to(dev) for p in _pad_planes(np, *noise))

    # ---- 2. B1 against its twin ------------------------------------------
    b1_err = 0
    slots = {}
    for name, planes in (("16x1080p", planes_hd), (f"2x{oh}x{ow} noise", planes_odd)):
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

    # ---- 3. B2 against its twin ------------------------------------------
    msb_hd = enc.resolve_slice_bytes(WIDTH // 16)
    cases = [
        ("16x1080p, auto buffer (shared memory)", slots["16x1080p"], msb_hd // 4, False),
        ("noise, 2560 B buffer (overflows)", slots[f"2x{oh}x{ow} noise"], 640, True),
        ("noise, 342528 B buffer (global memory)", slots[f"2x{oh}x{ow} noise"], 342528 // 4, False),
    ]
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

    # ---- 4. the main path ------------------------------------------------
    ycc = rgb_to_ycbcr(torch.from_numpy(frames), "full")  # JPEG-style planes, on the host
    jy, jcb, jcr = ycc[0].numpy(), subsample_420(ycc[1]).numpy(), subsample_420(ycc[2]).numpy()
    regrow_frames = rng.integers(0, 256, (2, HEIGHT, WIDTH, 3), dtype=np.uint8)

    cuda_vlc.launches = 0
    cuda_pack.launches = 0
    t0 = time.perf_counter()
    es_rgb = TorchMPEG1IntraEncoder(quality=QUALITY, device=dev).encode(frames)
    es_planes = TorchMPEG1IntraEncoder(quality=QUALITY, device=dev).encode_from_planes(jy, jcb, jcr)
    regrow = TorchMPEG1IntraEncoder(quality=QUALITY, max_slice_bytes=2560, device=dev)
    es_regrow = regrow.encode(regrow_frames)
    main_s = time.perf_counter() - t0
    launches = {"vlc_fused4": cuda_vlc.launches, "pack_fused4": cuda_pack.launches}
    print(f"main path (encode + encode_from_planes + regrow encode): {main_s:.2f} s, "
          f"launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if regrow.max_slice_bytes <= 2560:
        raise AssertionError("the forced-regrow run did not regrow")
    print(f"regrow: 2560 B -> {regrow.max_slice_bytes} B per slice")

    t0 = time.perf_counter()
    ref_rgb = MPEG1IntraEncoder(quality=QUALITY, backend="numpy").encode(frames)
    ref_planes = MPEG1IntraEncoder(quality=QUALITY, backend="numpy").encode_from_planes(jy, jcb, jcr)
    ref_regrow = MPEG1IntraEncoder(quality=QUALITY, max_slice_bytes=2560,
                                   backend="numpy").encode(regrow_frames)
    print(f"numpy reference encodes: {time.perf_counter() - t0:.2f} s on the host")
    for name, got, want in (("encode", es_rgb, ref_rgb),
                            ("encode_from_planes", es_planes, ref_planes),
                            ("regrow encode", es_regrow, ref_regrow)):
        print(f"{name}: {len(got)} B, reference {len(want)} B, equal {got == want}")
        if got != want:
            raise AssertionError(f"{name} differs from the numpy reference")

    dec = decode_es_fast(es_rgb + headers.sequence_end())
    if len(dec) != BATCH or any(d.shape != f.shape for d, f in zip(dec, frames)):
        raise AssertionError("decoded stream has the wrong frame count or shape")
    p = [psnr(f, d) for f, d in zip(frames, dec)]
    print(f"decoded {len(dec)} frames, PSNR mean {np.mean(p):.3f} dB, min {min(p):.3f} dB")
    if min(p) < 30.0:
        raise AssertionError(f"PSNR {min(p):.2f} dB below 30 dB")

    # ---- 5. steady-state times -------------------------------------------
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
    for name, (k_ms, p_ms) in times.items():
        print(f"{name} at 16x1080p: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms {tag}")
    for label, fn in (
        ("encode", lambda: enc.encode(frames)),
        ("encode_from_planes", lambda: enc.encode_from_planes(jy, jcb, jcr)),
    ):
        fn()
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()  # returns bytes: every slice was fetched to the host
        dt = time.perf_counter() - t0
        print(f"{label} 16x1080p q={QUALITY}: {BATCH * reps / dt:.2f} frames/s "
              f"({1e3 * dt / reps:.2f} ms per batch) {tag}")

    kernels = [
        {"name": "vlc_fused4", "route": "cuda",
         "source": "ec504_imageencoder_tpu_torch/csrc/vlc_fused4.cu",
         "replaces": "ec504_imageencoder_tpu/ops/pallas_vlc.py:556",
         "launches": launches["vlc_fused4"], "max_abs_err": b1_err,
         "ms": times["vlc_fused4"][0], "plain_ms": times["vlc_fused4"][1]},
        {"name": "pack_fused4", "route": "cuda",
         "source": "ec504_imageencoder_tpu_torch/csrc/pack_fused4.cu",
         "replaces": "ec504_imageencoder_tpu/ops/pallas_pack.py:763",
         "launches": launches["pack_fused4"], "max_abs_err": b2_err,
         "ms": times["pack_fused4"][0], "plain_ms": times["pack_fused4"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
