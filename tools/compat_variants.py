#!/usr/bin/env python3
"""Split the compat kernels' time into their DCT phase and their emission.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/compat_variants.py [--parent OTHER/csrc/vlc_compat.cu]

The kernels are B4a (`vlc_compat_slots`, raw slots) and B4b
(`vlc_compat_fused4`).  Beside them the tool builds variant kernels, each
appended to a copy of `csrc/vlc_compat.cu` (so it calls that source's own
device functions) and built on every source that defines the functions it
calls:

* "rows dct": the DCT phase alone in the row geometry of B4a's first port
  (a CUDA block of 64 threads per slice row, 54 busy): pixels, AAN DCT,
  C's `/`, zigzag into a column of shared memory; each block's 64 levels
  folded into one checksum word (h = 31 h + level, in zigzag order);
* "rows emit": that port's emission and slot-major store alone (a thread
  per block, a serial 64-step carry), from fixed levels;
* "flat dct bytes" / "flat dct wide": the shared compat DCT phase of the
  flat groups of 128 blocks (`compat_dct_phase`) with byte loads or with
  4-byte loads, then the checksum;
* "flat emit": B4a's cooperative emission and slot-major store alone
  (`emit_raw_slots`), from fixed levels;
* "flat store": B4a's slot-major store alone (`store_raw_slots`), from
  fixed slot words (`code | 1 << len`, the twin's raw slots).

The fixed levels are the plain twin's (`cuda_vlc_compat.compat_levels`),
copied to the card once, slot-major (row, 64, 54) for "rows emit" and
block-major (block, 64) for "flat emit": the emission and store variants
read 256 B a block where the kernels read 64 B of pixels.  Besides the
committed source, the tool builds it with some of its constants replaced
(`CONSTANTS`: the launch bounds' blocks per SM of B4a and B4b), each with
the variants above.  `--parent` adds
another tree's `vlc_compat.cu` (the same C entry points), e.g. the parent
commit's from a `git archive`: its B4a and B4b, and the variants its
functions allow, labelled "parent".

Input: `chip_smoke.py`'s compat batch, 480 frames of 400 x 600 (the 30
golden frames 16 times over) at q=12.  Every kernel and variant is held
against the twin (checksums against the twin's levels) before it is
timed; then each is timed with CUDA events (mean of 20 launches after a
warm-up) and by the profiler's device time per recorded launch, three
rounds in turns.  The card's name and power limit head the output, the
ptxas lines (registers, spills, shared memory) follow the build.  Nothing
in the port reads the variants.
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

# the C signature of every variant's launcher: the kernels' first twelve
# arguments, then fixed levels (or null), two outputs, device and stream
_P, _I = ctypes.c_void_p, ctypes.c_int
VARIANT_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]
_SIG = ("const void* y, const void* cb, const void* cr, int batch, int H, int W, "
        "const void* scaled_q, const void* zigzag, const void* ac_code, const void* ac_len, "
        "const void* dc_code, const void* dc_len, const void* levels, void* out0, void* out1, "
        "int device, void* stream")
_ARGS = ("(const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr")
_TABLES = ("(const int32_t*)scaled_q, (const int32_t*)zigzag, (const int32_t*)ac_code, "
           "(const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len")

ROWS_DCT = """
namespace {
__global__ void __launch_bounds__(64)
rows_dct_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                const uint8_t* __restrict__ cr, int H, int W, const int32_t* __restrict__ scaled_q,
                const int32_t* __restrict__ zigzag, int32_t* __restrict__ sums) {
  __shared__ int s_lv[64][64];
  __shared__ int s_q[64];
  __shared__ int s_zpos[64];
  const int tid = threadIdx.x, row = blockIdx.x;
  const int b = row / kSlices, s = row - kSlices * b;
  s_q[tid] = scaled_q[tid];
  s_zpos[zigzag[tid]] = tid;
  __syncthreads();
  const int n = tid;
  if (n >= kNB) return;
  int stride;
  const uint8_t* p = compat_origin(y, cb, cr, b, s, n, H, W, &stride);
  int x[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) x[r][c] = p[r * stride + c];
  aan_dct(x);
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 8; ++u) s_lv[s_zpos[v * 8 + u]][tid] = x[v][u] / s_q[v * 8 + u];
  uint32_t h = 0u;
  for (int k = 0; k < 64; ++k) h = h * 31u + (uint32_t)s_lv[k][tid];
  sums[row * kNB + n] = (int32_t)h;
}
}  // namespace
extern "C" int rows_dct_launch(SIG) {
  rows_dct_kernel<<<batch * kSlices, 64, 0, (cudaStream_t)stream>>>(
      ARGS, H, W, (const int32_t*)scaled_q, (const int32_t*)zigzag, (int32_t*)out0);
  return (int)cudaGetLastError();
}
"""

ROWS_EMIT = """
namespace {
__global__ void __launch_bounds__(64)
rows_emit_kernel(const int32_t* __restrict__ levels, const int32_t* __restrict__ ac_code,
                 const int32_t* __restrict__ ac_len, const int32_t* __restrict__ dc_code,
                 const int32_t* __restrict__ dc_len, int32_t* __restrict__ codes,
                 int32_t* __restrict__ lens) {
  __shared__ int s_lv[64][64];
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];
  __shared__ uint32_t s_dcc[2 * kDcSizes];
  const int tid = threadIdx.x, row = blockIdx.x;
  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, tid, 64);
  const int n = tid;
  if (n < kNB)
    for (int k = 0; k < 64; ++k) s_lv[k][tid] = levels[((size_t)row * 64 + k) * kNB + n];
  __syncthreads();
  if (n >= kNB) return;
  const int comp = n - 6 * (n / 6);
  const int dc = s_lv[0][tid];
  int len0;
  const uint32_t code0 = emit_dc_compat(dc, comp, s_dcc, len0);
  int run = dc == 0;
  bool dropped = false;
  for (int j = 0; j < 16; ++j) {
    uint32_t c[4];
    int l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * j + i;
      if (k == 0) {
        c[i] = code0;
        l[i] = len0;
        continue;
      }
      c[i] = emit_ac_compat(s_lv[k][tid], run, dropped, s_ac, l[i]);
      if (k == 63) {
        c[i] = (c[i] << 2) | 2u;
        l[i] += 2;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t o = ((size_t)row * 64 + 4 * j + i) * kNB + n;
      codes[o] = (int32_t)c[i];
      lens[o] = l[i];
    }
  }
}
}  // namespace
extern "C" int rows_emit_launch(SIG) {
  rows_emit_kernel<<<batch * kSlices, 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)levels, (const int32_t*)ac_code, (const int32_t*)ac_len,
      (const int32_t*)dc_code, (const int32_t*)dc_len, (int32_t*)out0, (int32_t*)out1);
  return (int)cudaGetLastError();
}
"""

FLAT_DCT = """
namespace {
template <bool kWide>
__global__ void __launch_bounds__(kGroup)
flat_dct_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                const uint8_t* __restrict__ cr, int H, int W, int nblk,
                const int32_t* __restrict__ scaled_q, const int32_t* __restrict__ zigzag,
                const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
                const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
                int32_t* __restrict__ sums) {
  __shared__ CompatShared sh;
  const int tid = threadIdx.x, lane = tid & 31, g0 = blockIdx.x * kGroup;
  sh.load(scaled_q, zigzag, ac_code, ac_len, dc_code, dc_len, tid);
  __syncthreads();
  compat_dct_phase<kWide>(y, cb, cr, H, W, nblk, g0, tid, sh);
  __syncwarp();
  if (g0 + tid < nblk) {
    const int* blk = sh.lv + tid * 64;
    uint32_t h = 0u;
    for (int k = 0; k < 64; ++k) h = h * 31u + (uint32_t)blk[swizzle_slot(k) ^ lane];
    sums[g0 + tid] = (int32_t)h;
  }
}
}  // namespace
extern "C" int flat_dct_bytes_launch(SIG) {
  const int nblk = batch * kSlices * kNB;
  flat_dct_kernel<false><<<(nblk + kGroup - 1) / kGroup, kGroup, 0, (cudaStream_t)stream>>>(
      ARGS, H, W, nblk, TABLES, (int32_t*)out0);
  return (int)cudaGetLastError();
}
extern "C" int flat_dct_wide_launch(SIG) {
  const int nblk = batch * kSlices * kNB;
  flat_dct_kernel<true><<<(nblk + kGroup - 1) / kGroup, kGroup, 0, (cudaStream_t)stream>>>(
      ARGS, H, W, nblk, TABLES, (int32_t*)out0);
  return (int)cudaGetLastError();
}
"""

FLAT_EMIT = """
namespace {
__global__ void __launch_bounds__(kGroup)
flat_emit_kernel(const int32_t* __restrict__ levels, int nblk,
                 const int32_t* __restrict__ scaled_q, const int32_t* __restrict__ zigzag,
                 const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
                 const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
                 int32_t* __restrict__ codes, int32_t* __restrict__ lens) {
  __shared__ CompatShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp0 = tid - lane, g0 = blockIdx.x * kGroup;
  sh.load(scaled_q, zigzag, ac_code, ac_len, dc_code, dc_len, tid);
  // the warp's 32 blocks are 2,048 consecutive words: 16 int4 a lane, all
  // in flight before the scatter into the swizzled levels
  const int words = 64 * min(32, nblk - g0 - warp0);
  const int4* src = reinterpret_cast<const int4*>(levels + (size_t)(g0 + warp0) * 64);
  int4 v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = i * 128 + lane * 4 < words ? __ldg(src + i * 32 + lane) : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int w = i * 128 + lane * 4, t = warp0 + (w >> 6), k = w & 63;
    int* const blk = sh.lv + t * 64;
    blk[swizzle_slot(k) ^ (t & 31)] = v[i].x;
    blk[swizzle_slot(k + 1) ^ (t & 31)] = v[i].y;
    blk[swizzle_slot(k + 2) ^ (t & 31)] = v[i].z;
    blk[swizzle_slot(k + 3) ^ (t & 31)] = v[i].w;
  }
  __syncthreads();
  emit_raw_slots(sh, g0, nblk, tid, codes, lens);
}
}  // namespace
extern "C" int flat_emit_launch(SIG) {
  const int nblk = batch * kSlices * kNB;
  flat_emit_kernel<<<(nblk + kGroup - 1) / kGroup, kGroup, 0, (cudaStream_t)stream>>>(
      (const int32_t*)levels, nblk, TABLES, (int32_t*)out0, (int32_t*)out1);
  return (int)cudaGetLastError();
}
"""

FLAT_STORE = """
namespace {
__global__ void __launch_bounds__(kGroup)
flat_store_kernel(const int32_t* __restrict__ words, int nblk, int32_t* __restrict__ codes,
                  int32_t* __restrict__ lens) {
  __shared__ int lv[kGroup * 64];
  const int tid = threadIdx.x, lane = tid & 31, warp0 = tid - lane, g0 = blockIdx.x * kGroup;
  const int n = 64 * min(32, nblk - g0 - warp0);
  const int4* src = reinterpret_cast<const int4*>(words + (size_t)(g0 + warp0) * 64);
  int4 v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = i * 128 + lane * 4 < n ? __ldg(src + i * 32 + lane) : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int w = i * 128 + lane * 4, t = warp0 + (w >> 6), k = w & 63;
    int* const blk = lv + t * 64;
    blk[swizzle_slot(k) ^ (t & 31)] = v[i].x;
    blk[swizzle_slot(k + 1) ^ (t & 31)] = v[i].y;
    blk[swizzle_slot(k + 2) ^ (t & 31)] = v[i].z;
    blk[swizzle_slot(k + 3) ^ (t & 31)] = v[i].w;
  }
  __syncthreads();
  store_raw_slots(lv, g0, nblk, tid, codes, lens);
}
}  // namespace
extern "C" int flat_store_launch(SIG) {
  const int nblk = batch * kSlices * kNB;
  flat_store_kernel<<<(nblk + kGroup - 1) / kGroup, kGroup, 0, (cudaStream_t)stream>>>(
      (const int32_t*)levels, nblk, (int32_t*)out0, (int32_t*)out1);
  return (int)cudaGetLastError();
}
"""

# name -> (kind, the device functions it calls, its CUDA text, its entry points)
VARIANTS = {
    "rows dct": ("dct", ("compat_origin", "aan_dct"), ROWS_DCT, ("rows_dct_launch",)),
    "rows emit": ("emit rows", ("emit_dc_compat", "emit_ac_compat"), ROWS_EMIT,
                  ("rows_emit_launch",)),
    "flat dct": ("dct", ("compat_dct_phase", "CompatShared"), FLAT_DCT,
                 ("flat_dct_bytes_launch", "flat_dct_wide_launch")),
    "flat emit": ("emit flat", ("emit_raw_slots", "CompatShared"), FLAT_EMIT,
                  ("flat_emit_launch",)),
    "flat store": ("store flat", ("store_raw_slots",), FLAT_STORE, ("flat_store_launch",)),
}
KERNELS = ("vlc_compat_slots_launch", "vlc_compat_fused4_launch")
# builds of the committed source with some of its constants replaced (B4a
# and B4b only); the first is the committed source, with the variants above
CONSTANTS = ({}, {"kMinBlocksRaw": 5}, {"kMinBlocksFused": 4})


def _label(consts: dict) -> str:
    return ", ".join(f"{k}={v}" for k, v in consts.items()) or "committed"


def _with_constants(src: str, consts: dict) -> str:
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr (int|bool) {name} = \w+;", rf"constexpr \1 {name} = {value};",
                         src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in vlc_compat.cu")
    return src


def _text(cuda: str) -> str:
    return cuda.replace("SIG", _SIG).replace("ARGS", _ARGS).replace("TABLES", _TABLES)


def _ptxas(log: str) -> list[str]:
    """One line per kernel: its name, registers, spill stores and static
    shared memory."""
    out = []
    for m in re.finditer(r"entry function '(\S+)'.*?(\d+) bytes spill stores.*?"
                         r"Used (\d+) registers[^\n]*?(\d+) bytes smem", log, re.S):
        name, spills, regs, smem = m.groups()
        short = re.search(r"(\w+?_kernel)", name)
        wide = "<wide>" if "ILb1E" in name else ("<bytes>" if "ILb0E" in name else "")
        out.append(f"{short.group(1) if short else name}{wide}: {regs} registers, "
                   f"{spills} B spilled, {smem} B smem")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another tree's vlc_compat.cu, timed beside")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("compat_variants: needs one CUDA card", file=sys.stderr)
        return 2
    from ec504_imageencoder_tpu_torch.ops import _build, cuda_vlc_compat
    from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr_exact
    from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts, to_i32_bits
    from ec504_imageencoder_tpu_torch.utils.tables import scale_quantization_matrix

    tag = f"[{cs._gpu_line()}]"
    print(tag)
    dev = torch.device("cuda", 0)
    out_dir = _build.build_dir() / "compat_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    committed = (_build.CSRC / "vlc_compat.cu").read_text()
    sources = [(_label(c), _with_constants(committed, c)) for c in CONSTANTS]
    if args.parent:
        sources.append(("parent", args.parent.read_text()))
    procs = []
    for i, (label, src) in enumerate(sources):
        names = [v for v, (_, needs, _, _) in VARIANTS.items()
                 if all(re.search(rf"\b{fn}\b", src) for fn in needs)]
        text = src + "".join(_text(VARIANTS[v][2]) for v in names)
        cu = out_dir / f"source{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs.append((label, names, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = []
    for label, names, so, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {label}:\n{out}{err}")
        print(f"{label} (variants: {', '.join(names) or 'none'}):")
        for line in _ptxas(err + out):
            print(f"  {line}")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in cuda_vlc_compat._ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
        entries = [e for v in names for e in VARIANTS[v][3]]
        for e in entries:
            getattr(lib, e).argtypes = VARIANT_ARGTYPES
        libs.append((label, lib, names))

    gold, _, _ = cs._golden(np)
    frames = np.concatenate([gold] * cs.COMPAT_COPIES)
    planes = tuple(torch.from_numpy(p).to(dev) for p in rgb_to_ycbcr_exact(frames))
    bsz, h, w = planes[0].shape
    sq = torch.from_numpy(scale_quantization_matrix(cs.COMPAT_QUALITY).astype(np.int32)).to(dev)
    luts = Luts.compat(dev)
    nblk = bsz * 6 * cuda_vlc_compat.NB
    zz = cuda_vlc_compat.compat_levels(*planes, sq, luts).reshape(nblk, 64)
    sums = torch.zeros(nblk, dtype=torch.int64, device=dev)
    for k in range(64):
        sums = (sums * 31 + zz[:, k]) & 0xFFFFFFFF
    levels_flat = zz.to(torch.int32).contiguous()
    levels_rows = levels_flat.view(bsz * 6, cuda_vlc_compat.NB, 64).transpose(1, 2).contiguous()
    want_slots = cuda_vlc_compat.vlc_compat_slots_plain(*planes, sq, luts)
    # the raw slots as the words B4a parks, code | 1 << len, block-major
    slot_words = (want_slots[0].long() & 0xFFFFFFFF | (1 << want_slots[1].long()))
    slot_words = to_i32_bits(
        slot_words.view(bsz * 6, 64, cuda_vlc_compat.NB).transpose(1, 2).reshape(nblk, 64)
    ).contiguous()
    want_fused = cuda_vlc_compat.vlc_compat_fused4_plain(*planes, sq, luts)
    print(f"{bsz} frames of {h} x {w}, q={cs.COMPAT_QUALITY}: {nblk} blocks, "
          f"{int((zz[:, 1:] != 0).sum())} nonzero AC levels")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*planes,)]
    tabs = [t.data_ptr() for t in (sq, *luts)]

    def call(lib, entry):
        if entry == "vlc_compat_fused4_launch":
            out = torch.empty((5, bsz * 6, cuda_vlc_compat.NB * 16), dtype=torch.int32, device=dev)
            err = lib.vlc_compat_fused4_launch(*ptrs, bsz, h, w, *tabs,
                                               *(t.data_ptr() for t in out), 0, stream)
            return err, tuple(out)
        slots = torch.empty((2, bsz * 6, 64, cuda_vlc_compat.NB), dtype=torch.int32, device=dev)
        if entry == "vlc_compat_slots_launch":
            err = lib.vlc_compat_slots_launch(*ptrs, bsz, h, w, *tabs, slots[0].data_ptr(),
                                              slots[1].data_ptr(), 0, stream)
            return err, tuple(slots)
        if "dct" in entry:
            out = torch.empty(nblk, dtype=torch.int32, device=dev)
            err = getattr(lib, entry)(*ptrs, bsz, h, w, *tabs, None, out.data_ptr(), None, 0,
                                      stream)
            return err, (out,)
        lv = (levels_rows if entry.startswith("rows") else
              slot_words if entry.startswith("flat_store") else levels_flat)
        err = getattr(lib, entry)(*ptrs, bsz, h, w, *tabs, lv.data_ptr(), slots[0].data_ptr(),
                                  slots[1].data_ptr(), 0, stream)
        return err, tuple(slots)

    def want(entry):
        if entry == "vlc_compat_fused4_launch":
            return want_fused
        if "dct" in entry:
            return ((sums & 0xFFFFFFFF),)
        return want_slots

    runs = []
    for label, lib, names in libs:
        entries = [*KERNELS, *(e for v in names for e in VARIANTS[v][3])]
        for entry in entries:
            if entry == "flat_dct_wide_launch" and w % 8:
                continue
            err, got = call(lib, entry)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{label} {entry}: CUDA error {err}")
            for g, wt in zip(got, want(entry), strict=True):
                g = g.long() & 0xFFFFFFFF if "dct" in entry else g
                if not torch.equal(g, wt):
                    raise AssertionError(f"{label} {entry} differs from the twin")
            runs.append((label, lib, entry))
    print("every kernel and variant equals the twin")
    pixel_mb = nblk * 64 / 1e6
    print(f"bytes: {pixel_mb:.1f} MB of pixels read, {nblk * 512 / 1e6:.1f} MB of raw slots "
          f"or {nblk * 320 / 1e6:.1f} MB of fused slots written, {nblk * 256 / 1e6:.1f} MB of "
          f"fixed levels read by the emission variants")
    for rnd in range(3):
        for label, lib, entry in runs:
            fn = lambda: call(lib, entry)  # noqa: E731
            ms = cs._event_ms(torch, fn, 20)
            print(f"round {rnd}, {entry.removesuffix('_launch')}, {label}: {ms:.4f} ms, "
                  f"device {cs._device_ms(torch, fn, 20)} {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
