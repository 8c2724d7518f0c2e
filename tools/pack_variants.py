#!/usr/bin/env python3
"""Time the tile-loop pack kernels in other geometries beside the committed one.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/pack_variants.py [--parent OTHER/csrc/pack_fused4.cu]

The kernels are K1 (`pack_raw`), K2 (`pack_pairs`), B2 (`pack_fused4`) and
B2's checked form.  Each variant is `csrc/pack_fused4.cu` with some of its
geometry constants replaced: K1's and K2's threads per block, the least
blocks per SM their launch bounds ask for and raw codes per thread
(`kRaw*`), and B2's (`kFused*`).  `--parent` adds another tree's
`pack_fused4.cu` (the same C entry points), e.g. the parent commit's from
a `git archive`, as the variant "parent".  Every variant is built by nvcc
with the port's flags into `ec504_imageencoder_tpu_torch/build/pack_variants/`
(its ptxas lines printed) and called through its C entry points.

Inputs: `chip_smoke.py`'s 16 x 1080p frames at q=50, as the encoder makes
them: B1's 4:1-fused slots for B2 and the generic route's raw slots
(`EncodeCore.raw_slots`) for K1 and K2, with the auto-sized buffer; and
the first frame's 68 slices of each (fewer blocks than SMs).  Every
variant is held against the plain twin on them before it is timed; then
the kernels a variant changes (all four for the committed source and the
parent) are timed at both sizes with CUDA events (mean of 20 launches
after a warm-up), three rounds in turns; the committed source's and the
parent's also by the profiler's device time per recorded launch.  The
card's name and power limit head the output.  Nothing in the port reads
the variants.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

RAW = ("kRawThreads", "kRawMinBlocks", "kRawV")
FUSED = ("kFusedThreads", "kFusedMinBlocks", "kFusedV")
# each variant: the constants it replaces; the first is the committed source
VARIANTS = (
    {},
    *(dict(zip(RAW, g)) for g in ((128, 9, 8), (128, 4, 16))),
    *(dict(zip(FUSED, g)) for g in ((128, 9, 4), (128, 9, 2), (64, 9, 4), (256, 4, 2),
                                    (256, 4, 4), (512, 2, 2), (1024, 1, 2), (1024, 1, 4))),
)


def _label(consts) -> str:
    if consts is None:
        return "parent"
    return ", ".join(f"{k}={v}" for k, v in consts.items()) or "committed"


def _variant_source(src: str, consts: dict) -> str:
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \w+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in pack_fused4.cu")
    return src


def _ptxas(log: str) -> list[str]:
    """One line per tile-loop kernel (`pack_tiles_kernel` over its sources;
    a parent's own `pack_raw_kernel` for K1 too): its template arguments,
    registers, spill stores and static shared memory."""
    out = []
    for m in re.finditer(r"entry function '(\S*(?:pack_tiles|pack_raw)_kernelI\S*)'.*?"
                         r"(\d+) bytes spill stores.*?"
                         r"Used (\d+) registers[^\n]*?(\d+) bytes smem", log, re.S):
        name, spills, regs, smem = m.groups()
        src = re.search(r"pack_tiles_kernelIN\w*?_(\d+)(\w+?)ELb", name)
        flags = "".join(re.findall(r"Lb([01])E", name))
        label = f"{src.group(2)} shared/vec/checks" if src else "Raw shared/vec"
        out.append(f"{label} {flags}: {regs} registers, {spills} B spilled, {smem} B smem")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another tree's pack_fused4.cu, timed beside")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("pack_variants: needs one CUDA card", file=sys.stderr)
        return 2
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
    from ec504_imageencoder_tpu_torch.ops import _build, cuda_pack, cuda_vlc
    from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420

    tag = f"[{cs._gpu_line()}]"
    print(tag)
    dev = torch.device("cuda", 0)
    out_dir = _build.BUILD_DIR / "pack_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "pack_fused4.cu").read_text()
    variants = [(consts, _variant_source(src, consts)) for consts in VARIANTS]
    if args.parent:
        variants.append((None, args.parent.read_text()))
    procs = []
    for i, (consts, text) in enumerate(variants):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs.append((consts, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.PIPE, text=True)))
    libs = []
    for consts, so, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {_label(consts)}:\n{out}{err}")
        print(f"{_label(consts)}:")
        for line in _ptxas(err + out):
            print(f"  {line}")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in cuda_pack._ARGTYPES.items():
            if hasattr(lib, name):  # a parent may lack an entry that launches nothing
                getattr(lib, name).argtypes = argtypes
        libs.append((consts, lib))

    frames = cs._frames(np, np.random.default_rng(cs.SEED), cs.BATCH)
    enc = TorchMPEG1IntraEncoder(quality=cs.QUALITY, device=dev)
    rgb = torch.from_numpy(np.pad(frames, ((0, 0), (0, -cs.HEIGHT % 16), (0, 0), (0, 0)),
                                  mode="edge")).to(dev)
    y, cb, cr = rgb_to_ycbcr(rgb, "studio")
    planes = (y, subsample_420(cb), subsample_420(cr))
    del rgb, y, cb, cr
    slots = cuda_vlc.vlc_fused4(*planes, enc.core.qw, enc.core.luts())
    codes, lens = enc.core.raw_slots(*planes)
    del planes
    mw = enc.resolve_slice_bytes(cs.WIDTH // 16) // 4
    n, kf = slots[4].shape
    k = lens.shape[1]
    nonempty = float((slots[4] > 0).float().mean())
    print(f"{n} slices of {kf} fused slots ({nonempty:.4f} non-empty) and {k} raw slots, "
          f"{mw}-word buffers")

    sizes = {"16x1080p": n, "one frame": n // cs.BATCH}

    def call(lib, kernel, rows):
        seg = torch.empty((rows, 4 * mw), dtype=torch.uint8, device=dev)
        nbits = torch.empty((rows,), dtype=torch.int32, device=dev)
        viol = torch.empty((rows,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel.startswith("pack_fused4"):
            err = lib.pack_fused4_launch(*(t.data_ptr() for t in slots), rows, kf, mw, 38,
                                         seg.data_ptr(), nbits.data_ptr(),
                                         viol.data_ptr() if kernel.endswith("checked") else None,
                                         0, stream)
        else:
            err = getattr(lib, f"{kernel}_launch")(codes.data_ptr(), lens.data_ptr(), rows, k, mw,
                                                   38, seg.data_ptr(), nbits.data_ptr(), 0, stream)
        if err:
            raise RuntimeError(f"{kernel}: CUDA error {err}")
        return (seg, nbits, viol) if kernel.endswith("checked") else (seg, nbits)

    raw_kernels, fused_kernels = ("pack_raw", "pack_pairs"), ("pack_fused4", "pack_fused4_checked")
    want = {"pack_raw": cuda_pack.pack_raw_plain(codes, lens, mw),
            "pack_pairs": cuda_pack.pack_pairs_plain(codes, lens, mw),
            "pack_fused4": cuda_pack.pack_fused4_plain(*slots, mw),
            "pack_fused4_checked": cuda_pack.pack_fused4_plain(*slots, mw, checks=True)}
    runs = []  # (label, lib, kernel, whether its device time is read) of every timed pair
    for consts, lib in libs:
        full = not consts  # the committed source or the parent
        timed = ((*raw_kernels, *fused_kernels) if full
                 else raw_kernels if set(consts) <= set(RAW) else fused_kernels)
        for kernel in (*raw_kernels, *fused_kernels):
            for rows in sizes.values():
                got = call(lib, kernel, rows)
                if not all(torch.equal(g, w[:rows].to(g.device))
                           for g, w in zip(got, want[kernel])):
                    raise AssertionError(f"{_label(consts)}: {kernel} differs from the twin "
                                         f"on {rows} slices")
        runs.extend((_label(consts), lib, kernel, full) for kernel in timed)
    print("every variant's four kernels equal their twins at both sizes")
    for rnd in range(3):
        for size, rows in sizes.items():
            for label, lib, kernel, full in runs:
                fn = lambda: call(lib, kernel, rows)  # noqa: E731
                ms = cs._event_ms(torch, fn, 20)
                dev_ms = f", device {cs._device_ms(torch, fn, 20)}" if full else ""
                print(f"round {rnd}, {size}, {kernel}, {label}: {ms:.4f} ms{dev_ms} {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
