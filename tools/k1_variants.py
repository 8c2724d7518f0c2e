#!/usr/bin/env python3
"""Time kernel K1 (`pack_raw`) in other tile geometries beside the committed one.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/k1_variants.py

Each variant is `csrc/pack_fused4.cu` with K1's three constants replaced
(threads per block, the least blocks per SM its launch bounds ask for,
consecutive codes per thread), built by nvcc with the port's flags into
`ec504_imageencoder_tpu_torch/build/k1_variants/` and called through its C
entry point.  Every variant is held against the plain twin on the raw
slots of `chip_smoke.py`'s 16 x 1080p q=50 frames (the `pack="pallas1"`
route's input) with the auto-sized buffer; then each is timed with CUDA
events (mean of 20 launches after a warm-up), three rounds in turns.  The
card's name and power limit head the output.  Nothing in the port reads
the variants.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (threads, least blocks per SM, codes per thread); the first is the
# committed geometry
VARIANTS = ((128, 9, 4), (128, 9, 8), (128, 8, 8), (256, 4, 8), (512, 2, 8), (256, 8, 4),
            (128, 4, 16))


def _variant_source(src: str, threads: int, min_blocks: int, v: int) -> str:
    for name, value in (("kRawThreads", threads), ("kRawMinBlocks", min_blocks), ("kRawV", v)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in pack_fused4.cu")
    return src


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k1_variants: needs one CUDA card", file=sys.stderr)
        return 2
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
    from ec504_imageencoder_tpu_torch.ops import _build, cuda_pack
    from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420

    tag = f"[{cs._gpu_line()}]"
    print(tag)
    dev = torch.device("cuda", 0)
    out_dir = _build.BUILD_DIR / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "pack_fused4.cu").read_text()
    procs = {}
    for threads, min_blocks, v in VARIANTS:
        name = f"{threads} threads, {min_blocks} blocks/SM, {v} codes/thread"
        cu = out_dir / f"k1_t{threads}_b{min_blocks}_v{v}.cu"
        cu.write_text(_variant_source(src, threads, min_blocks, v))
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}{err}")
        regs = sorted(set(re.findall(r"pack_raw_kernel.*?Used (\d+) registers", err + out, re.S)))
        print(f"{name}: K1 registers {', '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        lib.pack_raw_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4,
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        libs[name] = lib

    frames = cs._frames(np, np.random.default_rng(cs.SEED), cs.BATCH)
    enc = TorchMPEG1IntraEncoder(quality=cs.QUALITY, device=dev)
    rgb = torch.from_numpy(np.pad(frames, ((0, 0), (0, -cs.HEIGHT % 16), (0, 0), (0, 0)),
                                  mode="edge")).to(dev)
    y, cb, cr = rgb_to_ycbcr(rgb, "studio")
    codes, lens = enc.core.raw_slots(y, subsample_420(cb), subsample_420(cr))
    del rgb, y, cb, cr
    mw = enc.resolve_slice_bytes(cs.WIDTH // 16) // 4
    n, k = lens.shape
    print(f"{n} slices of {k} raw slots, {mw}-word buffers")

    def call(lib):
        seg = torch.empty((n, 4 * mw), dtype=torch.uint8, device=dev)
        nbits = torch.empty((n,), dtype=torch.int32, device=dev)
        err = lib.pack_raw_launch(codes.data_ptr(), lens.data_ptr(), n, k, mw, 38,
                                  seg.data_ptr(), nbits.data_ptr(), 0,
                                  torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"pack_raw_launch: CUDA error {err}")
        return seg, nbits

    want = cuda_pack.pack_raw_plain(codes, lens, mw)
    for name, lib in libs.items():
        got = call(lib)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name} differs from the twin")
    print("every variant equals the twin")
    for rnd in range(3):
        for name, lib in libs.items():
            print(f"round {rnd}, {name}: {cs._event_ms(torch, lambda: call(lib), 20):.4f} ms {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
