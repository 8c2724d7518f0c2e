// vlc_compat: compat-mode frames -> VLC slots of the reference C encoder's
// bitstream, bug for bug.
//
// Replaces the Pallas kernels ec504_imageencoder_tpu/ops/pallas_vlc.py
// `_vlc_compat_kernel` (raw slots, entry point vlc_compat_slots_launch)
// and `_vlc_compat_fused_kernel` (4:1-fused slots in stream order, entry
// point vlc_compat_fused4_launch), launched through `_compat_call`,
// together with the compat blockize in front of them
// (models/encoder.py::compat_blockize_px64) and `fused_stack_to_stream`
// behind the fused one.  Per 8x8 block: the reference's integer AAN DCT,
// truncating division by the scaled JPEG matrix (C's `/`), zigzag, and the
// compat emission: absolute DC, no AC sign bit, Q5 truncation, the
// compat AC table (run-0 off-by-one and the (16, 2) typo), escapes with
// unclamped levels; the MB header '11' folds into the DC slot of the first
// block of each macroblock and EOB '10' into slot 63.
//
// Geometry (reference encoder.h): the 96 x 144 crop is 6 column-band
// slices of 9 macroblocks; slice row r = frame * 6 + band.  Luma block b of
// MB m in band s covers rows 16m + 8(b / 2) and columns 16s + 8(b % 2) of
// the Y plane.  Chroma quirk Q3: the block reads the full-resolution plane
// through a half-width pointer view, pixel (py, px) at flat index
// (8m + py) * (W / 2) + 8s + px of the frame (valid at odd W).
//
// What bounds it on the H100: nothing big.  A frame is 54 x 6 = 324
// blocks; per block it reads 64 B of pixels and writes 320 B (fused) or
// 512 B (raw) of slots.  The work is the DCT, 64 integer divisions and the
// emission: integer instruction throughput and latency.
//
// Compat blocks are independent (an absolute DC, a macroblock header that
// depends only on n % 6, the EOB always in slot 63), so both kernels take
// the batch's blocks as one flat sequence, g = row * 54 + n, 128
// consecutive blocks a CUDA block, across slice rows and frames:
//  - the compat DCT phase (compat_dct_phase), shared by both: a thread per
//    block reads its pixels (as bytes, or as 4-byte words when W % 8 == 0
//    and the planes are 4-byte aligned: then every luma and chroma row of a
//    block starts on a multiple of 4), runs the AAN DCT, divides by the
//    scaled matrix as C's `/` does through a multiply-high by a per-entry
//    multiplier built once per CUDA block (compat_div), and scatters the
//    zigzag levels into B1's swizzled block-major layout (planes_dct.cuh);
//  - the emission (compat_emission): B1's lanes (vlc_emit.cuh), a half-warp
//    per block, lane j emitting slots 4j .. 4j+3, the compat rules from
//    ballots instead of a serial carry (compat_lane_slots);
//  - B4b stores each lane's 4:1 value at g * 16 + j (B1's store_fused4), so
//    each warp store writes 32 consecutive int32;
//  - B4a parks each lane's four slots as one word each (slot_word) where
//    their levels were, and then lane t stores slot k of the warp's block
//    t slot-major at (row * 64 + k) * 54 + n, B6a's store (all the codes,
//    then the lens): for each k the warp's 32 consecutive blocks lie in at
//    most two slice rows, so each store instruction writes at most two
//    runs of consecutive words.  The store holds B4a: alone, from fixed
//    slot words, it takes 0.062 of its 0.085 ms at 480 frames.
// Before: B4a took a CUDA block of 64 threads per slice row (54 busy), a
// thread per block from the DCT to a serial 64-step emission (0.09 ms for
// 480 frames); B4b the same (0.21 ms) until its flat groups; each kernel
// had its own copy of the DCT phase with 64 signed divisions a block
// (NVIDIA H100 80GB HBM3, 700.00 W).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "planes_dct.cuh"
#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kGroup = 128;          // threads of a CUDA block: the flat blocks of its group
constexpr int kSlices = 6;           // column bands of the crop
constexpr int kMbs = 9;              // macroblocks per band
constexpr int kNB = kMbs * 6;        // 8x8 blocks per slice row
constexpr int kCropW = 96, kCropH = 144;

// Top-left pixel and row stride of block n of band s of frame b.
__device__ __forceinline__ const uint8_t* compat_origin(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int b, int s, int n, int H,
    int W, int* stride) {
  const int mb = n / 6, comp = n - 6 * (n / 6);
  const size_t frame = (size_t)b * H * W;
  if (comp < 4) {  // luma order in a macroblock: TL, TR, BL, BR
    *stride = W;
    return y + frame + (size_t)(16 * mb + 8 * (comp >> 1)) * W + 16 * s + 8 * (comp & 1);
  }
  const int half = W / 2;  // Q3: the full-resolution plane at half stride
  *stride = half;
  return (comp == 4 ? cb : cr) + frame + (size_t)(8 * mb) * half + 8 * s;
}

// The compat DC slot (ops/vlc_device.py::block_streams_compat, slot 0):
// the absolute quantized DC, size max(bit_length(|dc| & 0xFF), 1) after
// its dct_dc_size VLC, one's-complement-style bits for a negative DC; a
// zero DC is the size-0 VLC alone.  MB header '11' in front where
// comp == 0.
__device__ __forceinline__ uint32_t emit_dc_compat(int dc, int comp, const uint32_t* s_dcc,
                                                   int& len) {
  const int tab = comp < 4 ? kDcSizes : 0;
  uint32_t code;
  if (dc != 0) {
    const int adc = abs(dc);
    const int sz = max(32 - __clz(adc & 0xFF), 1);
    const int coe = dc < 0 ? adc ^ (1 << (sz - 1)) : adc;
    const uint32_t sc = s_dcc[tab + sz];
    code = ((sc & 0xFFFFu) << sz) | ((uint32_t)coe & ((1u << sz) - 1u));
    len = (int)(sc >> 16) + sz;
  } else {
    const uint32_t sc = s_dcc[tab];
    code = sc & 0xFFFFu;
    len = (int)(sc >> 16);
  }
  if (comp == 0) {  // macroblock header '11'
    code |= 3u << len;
    len += 2;
  }
  return code;
}

// One compat AC slot (ops/vlc_device.py::ac_codes_compat and the Q5 mask
// of block_streams_compat).  `run` counts the zero slots since the
// previous nonzero one, the DC included; `dropped` turns on at the first
// nonzero AC with no zero before it and drops it and every later slot.
__device__ __forceinline__ uint32_t emit_ac_compat(int lvl, int& run, bool& dropped,
                                                   const uint32_t* s_ac, int& len) {
  len = 0;
  if (lvl == 0) {
    ++run;
    return 0u;
  }
  const int zb = run;
  run = 0;
  dropped = dropped || zb == 0;
  if (dropped) return 0u;
  const int ri = zb - 1;
  const int al = abs(lvl);
  if (ri == 0 && al == 1) {
    len = 2;
    return 3u;
  }
  const uint32_t t = (ri < kAcRuns && al < kAcLevels) ? s_ac[ri * kAcLevels + al] : 0u;
  if ((t >> 16) > 0) {  // no sign bit (Q4)
    len = (int)(t >> 16);
    return t & 0xFFFFu;
  }
  // escape: 6-bit escape, 6-bit run, 8- or 16-bit level (low bits only)
  const bool s = lvl < 0;
  const uint32_t base = 64u | (uint32_t)ri;
  const uint32_t lo = s ? (uint32_t)(256 - al) & 0xFFu : (uint32_t)al & 0xFFu;
  if (al >= 128) {
    len = 28;
    return (base << 16) | ((s ? 0x80u : 0u) << 8) | lo;
  }
  len = 20;
  return (base << 8) | lo;
}

// Slots 4j .. 4j+3 of the half-warp's block under the compat rules (lane =
// the lane in the warp, j = lane & 15; lv = levels 4j .. 4j+3, lv[0] of
// lane 0 the DC; code0 / len0: the DC slot, read on lane 0 only), emitted
// into c and l as emit_ac_compat's serial carry would, from two ballots:
//  - the zero run in front of slot 4j: a slot counts as nonzero if its
//    level is (the DC only if dc != 0, unlike half_warp_run, where the DC
//    always counts), and the nearest lane below with one hands its last
//    such slot p over by a shuffle: run = 4j - 1 - p, p = -1 if none;
//  - the Q5 drop: a trigger is a slot k >= 1 that is nonzero after a
//    nonzero slot k - 1 (for the lane's first slot, lane j - 1's slot 3,
//    by a shuffle up); every slot from the block's first trigger on emits
//    nothing.  A lane with a trigger below it starts dropped; its own
//    first trigger turns emit_ac_compat's flag on (a run of 0 before a
//    nonzero level).
// The EOB '10' still goes into slot 63 when it is dropped.  Call with all
// 32 lanes.
__device__ __forceinline__ void compat_lane_slots(const int lv[4], int lane, uint32_t code0,
                                                  int len0, const uint32_t* s_ac, uint32_t c[4],
                                                  int l[4]) {
  const int j = lane & 15;
  const unsigned below_j = (1u << j) - 1u;
  int last = -1;
  bool trig = false;
  bool prev_nz = __shfl_up_sync(0xFFFFFFFFu, lv[3] != 0, 1) && j > 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool nz = lv[i] != 0;
    if (nz) last = 4 * j + i;
    trig = trig || (nz && prev_nz);  // slot 0 has no prev_nz: lane 0's is false
    prev_nz = nz;
  }
  const unsigned have = (__ballot_sync(0xFFFFFFFFu, last >= 0) >> (lane & 16)) & below_j;
  const int src = (lane & 16) + (have ? 31 - __clz(have) : 0);
  const int prev = __shfl_sync(0xFFFFFFFFu, last, src);
  int run = 4 * j - 1 - (have ? prev : -1);
  bool dropped = ((__ballot_sync(0xFFFFFFFFu, trig) >> (lane & 16)) & below_j) != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * j + i;
    if (k == 0) {
      c[i] = code0;
      l[i] = len0;
      run = lv[0] == 0;  // a zero DC is a zero before slot 1
      continue;
    }
    c[i] = emit_ac_compat(lv[i], run, dropped, s_ac, l[i]);
    if (k == 63) {  // end of block '10'
      c[i] = (c[i] << 2) | 2u;
      l[i] += 2;
    }
  }
}

// ---- both kernels: flat groups of 128 blocks -------------------------------

// The largest divisor compat_div's multiply-high serves.
constexpr int kMaxMulQ = 65535;
// The least CUDA blocks per SM the launch bounds ask for, B4a's and B4b's.
// B4a compiles to 112 registers (4 blocks); B4b held to 5 blocks (96
// registers, 40 B spilled) took 0.054 ms instead of 0.058, B4a held to 5
// 0.089 instead of 0.085 (tools/compat_variants.py, 480 frames; NVIDIA H100
// 80GB HBM3, 700.00 W).
constexpr int kMinBlocksRaw = 4;
constexpr int kMinBlocksFused = 5;

// What both kernels keep in shared memory.
struct CompatShared {
  int lv[kGroup * 64];               // the group's levels, swizzled block-major (planes_dct.cuh)
  uint32_t ac[kAcRuns * kAcLevels];  // code | len << 16
  uint32_t dcc[2 * kDcSizes];        // code | len << 16, [luma][size]
  int q[64];                         // the scaled matrix, natural order
  uint32_t m[64];                    // compat_div's multiplier of each entry
  int zpos[64];                      // natural index -> swizzled scan position

  // The tables, from every thread of the CUDA block; then __syncthreads().
  __device__ __forceinline__ void load(const int32_t* scaled_q, const int32_t* zigzag,
                                       const int32_t* ac_code, const int32_t* ac_len,
                                       const int32_t* dc_code, const int32_t* dc_len, int tid) {
    load_vlc_tables(ac, dcc, ac_code, ac_len, dc_code, dc_len, tid, kGroup);
    if (tid < 64) {
      const int d = scaled_q[tid];
      q[tid] = d;
      m[tid] = d >= 1 && d <= kMaxMulQ ? 0x80000000u / (uint32_t)d + 1u : 0u;
      zpos[zigzag[tid]] = swizzle_slot(tid);
    }
  }
};

// C's x / d, truncated toward zero, for |x| < 2^15 (every coefficient the
// AAN DCT makes of 8-bit pixels), with m = 2^31 / d + 1 = (2^31 + e) / d,
// 0 < e <= d: |x| / d rounded down is floor(2|x| m / 2^32) = floor(|x| / d
// + |x| e / (d 2^31)), and |x| e < 2^31 for d <= 65535 keeps the second
// term below the distance from |x| / d to the next integer.  m = 0 (any
// other d): C's `/`.  tests/test_torch_compat_store.py checks every such x
// against every d that scale_quantization_matrix gives at quality 1..100.
// Against `/` it cut the DCT phase from 0.031 to 0.028 ms at 480 frames
// (tools/compat_variants.py).
__device__ __forceinline__ int compat_div(int x, int d, uint32_t m) {
  if (m == 0u) return x / d;
  const int k = (int)__umulhi((uint32_t)abs(x) << 1, m);
  return x < 0 ? -k : k;
}

// The compat DCT phase of both kernels: thread tid takes flat block g0 +
// tid of nblk (frame-major slice rows of kNB blocks): its 64 pixels (kWide:
// two 4-byte loads a row, else byte loads), the AAN DCT, compat_div and the
// zigzag into the group's swizzled levels, level k at word tid * 64 +
// (swizzle_slot(k) ^ lane).
template <bool kWide>
__device__ __forceinline__ void compat_dct_phase(const uint8_t* __restrict__ y,
                                                 const uint8_t* __restrict__ cb,
                                                 const uint8_t* __restrict__ cr, int H, int W,
                                                 int nblk, int g0, int tid, CompatShared& sh) {
  const int g = g0 + tid;
  if (g >= nblk) return;
  const int row = g / kNB, n = g - kNB * row;
  const int b = row / kSlices, s = row - kSlices * b;
  int stride;
  const uint8_t* p = compat_origin(y, cb, cr, b, s, n, H, W, &stride);
  int x[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if constexpr (kWide) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(p + r * stride) + h);
#pragma unroll
        for (int i = 0; i < 4; ++i) x[r][4 * h + i] = (w >> (8 * i)) & 0xFFu;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) x[r][c] = __ldg(p + r * stride + c);
    }
  }
  aan_dct(x);
  int* const blk = sh.lv + tid * 64;
  const int lane = tid & 31;
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = v * 8 + u;
      blk[sh.zpos[i] ^ lane] = compat_div(x[v][u], sh.q[i], sh.m[i]);
    }
}

// The emission of a group, after its DCT phase: each warp its own 32
// blocks, two per pass (lanes 0-15 and 16-31, neighbours in stream order).
// nblk and g0 are even, so the warp's pass count is uniform: 16, fewer in
// the last group, or none.  Lane j of the half-warp on the group's block t
// (flat block g) reads levels 4j .. 4j+3, emits their slots and hands them
// to emit(t, g, j, c, l).
template <class Emit>
__device__ __forceinline__ void compat_emission(const CompatShared& sh, int g0, int nblk,
                                                int tid, Emit emit) {
  const int lane = tid & 31, warp0 = tid - lane, j = lane & 15;
  const int passes = min(16, (nblk - g0 - warp0) / 2);
  for (int q = 0; q < passes; ++q) {
    const int t = warp0 + 2 * q + (lane >> 4);
    const int g = g0 + t;
    int lv[4];
    SwizzledLevels{sh.lv + t * 64, t}(j, lv);
    uint32_t code0 = 0;
    int len0 = 0;
    if (j == 0) code0 = emit_dc_compat(lv[0], g % 6, sh.dcc, len0);  // n % 6 == g % 6
    uint32_t c[4];
    int l[4];
    compat_lane_slots(lv, lane, code0, len0, sh.ac, c, l);
    emit(t, g, j, c, l);
  }
}

// B4a's store: the group's parked slot words (level k's word of each
// block) go out slot-major, codes and lens at (row * 64 + k) * kNB + n:
// lane t of the warp stores slot k of the warp's block t, the codes of
// every k and then the lens.  For each k the warp's 32 blocks lie in at
// most two slice rows, so each store instruction writes at most two runs
// of consecutive words.  Measured alternatives, all slower
// (tools/compat_variants.py, 480 frames): the codes and lens of each k in
// one loop (0.087 ms against 0.085), pairs of blocks in int2 stores (0.086),
// streaming stores (0.086), and the CUDA block storing each slice row's
// runs after a barrier (0.096).
__device__ __forceinline__ void store_raw_slots(const int* lv, int g0, int nblk, int tid,
                                                int32_t* __restrict__ codes,
                                                int32_t* __restrict__ lens) {
  __syncwarp();
  const int g = g0 + tid;
  if (g >= nblk) return;
  const int row = g / kNB, n = g - kNB * row, lane = tid & 31;
  const int* const blk = lv + tid * 64;
  int32_t* const cp = codes + (size_t)row * 64 * kNB + n;
  int32_t* const lp = lens + (size_t)row * 64 * kNB + n;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    const uint32_t w = (uint32_t)blk[swizzle_slot(k) ^ lane];
    cp[k * kNB] = (int32_t)(w ^ (1u << slot_word_len(w)));
  }
#pragma unroll 8
  for (int k = 0; k < 64; ++k) lp[k * kNB] = slot_word_len((uint32_t)blk[swizzle_slot(k) ^ lane]);
}

// B4a's emission: each lane parks its four slots as one word each where
// their levels were (slot_word); then store_raw_slots.
__device__ __forceinline__ void emit_raw_slots(CompatShared& sh, int g0, int nblk, int tid,
                                               int32_t* __restrict__ codes,
                                               int32_t* __restrict__ lens) {
  int* const lv = sh.lv;
  compat_emission(sh, g0, nblk, tid, [lv](int t, int, int j, const uint32_t* c, const int* l) {
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[t * 64 + swizzled_word(t, j, i)] = (int)slot_word(c[i], l[i]);
  });
  store_raw_slots(lv, g0, nblk, tid, codes, lens);
}

// B4a: raw slots, (nblk / 54, 64, 54) codes and lens.
template <bool kWide>
__global__ void __launch_bounds__(kGroup, kMinBlocksRaw)
vlc_compat_slots_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                        const uint8_t* __restrict__ cr, int H, int W, int nblk,
                        const int32_t* __restrict__ scaled_q, const int32_t* __restrict__ zigzag,
                        const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
                        const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
                        int32_t* __restrict__ codes, int32_t* __restrict__ lens) {
  __shared__ CompatShared sh;
  const int tid = threadIdx.x, g0 = blockIdx.x * kGroup;
  sh.load(scaled_q, zigzag, ac_code, ac_len, dc_code, dc_len, tid);
  __syncthreads();
  compat_dct_phase<kWide>(y, cb, cr, H, W, nblk, g0, tid, sh);
  __syncwarp();  // a warp emits only the blocks it transformed
  emit_raw_slots(sh, g0, nblk, tid, codes, lens);
}

// B4b: 4:1-fused slots, g * 16 + j.
template <bool kWide>
__global__ void __launch_bounds__(kGroup, kMinBlocksFused)
vlc_compat_fused4_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                         const uint8_t* __restrict__ cr, int H, int W, int nblk,
                         const int32_t* __restrict__ scaled_q,
                         const int32_t* __restrict__ zigzag, const int32_t* __restrict__ ac_code,
                         const int32_t* __restrict__ ac_len, const int32_t* __restrict__ dc_code,
                         const int32_t* __restrict__ dc_len, FusedOut out) {
  __shared__ CompatShared sh;
  const int tid = threadIdx.x, g0 = blockIdx.x * kGroup;
  sh.load(scaled_q, zigzag, ac_code, ac_len, dc_code, dc_len, tid);
  __syncthreads();
  compat_dct_phase<kWide>(y, cb, cr, H, W, nblk, g0, tid, sh);
  __syncwarp();  // a warp emits only the blocks it transformed
  compat_emission(sh, g0, nblk, tid, [&out](int, int g, int j, const uint32_t* c, const int* l) {
    store_fused4(c, l, out, (size_t)g * 16 + j);
  });
}

bool valid_frames(int batch, int H, int W) {
  return batch >= 0 && H >= kCropH && W >= kCropW && (long long)batch * kSlices * kNB <= INT_MAX;
}

// The byte loads or the 4-byte ones: W % 8 == 0 and every plane 4-byte
// aligned put each block row of the crop on a multiple of 4 (the frame
// size, luma offsets and rows are multiples of 8; chroma's half-width rows
// and offsets multiples of 4).
bool wide_loads(const void* y, const void* cb, const void* cr, int W) {
  return W % 8 == 0 && (uintptr_t)y % 4 == 0 && (uintptr_t)cb % 4 == 0 &&
         (uintptr_t)cr % 4 == 0;
}

}  // namespace

// B4a: codes and lens, each (batch * 6, 64, 54) int32 (slot-major rows).
extern "C" int vlc_compat_slots_launch(const void* y, const void* cb, const void* cr,
                                       int batch, int H, int W, const void* scaled_q,
                                       const void* zigzag, const void* ac_code,
                                       const void* ac_len, const void* dc_code,
                                       const void* dc_len, void* codes, void* lens,
                                       int device, void* stream) {
  if (!valid_frames(batch, H, W)) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  const cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  const int nblk = batch * kSlices * kNB;
  const auto kernel = wide_loads(y, cb, cr, W) ? vlc_compat_slots_kernel<true>
                                               : vlc_compat_slots_kernel<false>;
  kernel<<<(nblk + kGroup - 1) / kGroup, kGroup, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, H, W, nblk,
      (const int32_t*)scaled_q, (const int32_t*)zigzag, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      (int32_t*)codes, (int32_t*)lens);
  return (int)cudaGetLastError();
}

// B4b: v0..v3 and flens, each (batch * 6, 54 * 16) int32 in stream order.
extern "C" int vlc_compat_fused4_launch(const void* y, const void* cb, const void* cr,
                                        int batch, int H, int W, const void* scaled_q,
                                        const void* zigzag, const void* ac_code,
                                        const void* ac_len, const void* dc_code,
                                        const void* dc_len, void* v0, void* v1, void* v2,
                                        void* v3, void* flens, int device, void* stream) {
  if (!valid_frames(batch, H, W)) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  const cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  const int nblk = batch * kSlices * kNB;
  const auto kernel = wide_loads(y, cb, cr, W) ? vlc_compat_fused4_kernel<true>
                                               : vlc_compat_fused4_kernel<false>;
  kernel<<<(nblk + kGroup - 1) / kGroup, kGroup, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, H, W, nblk,
      (const int32_t*)scaled_q, (const int32_t*)zigzag, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      FusedOut{(int32_t*)v0, (int32_t*)v1, (int32_t*)v2, (int32_t*)v3, (int32_t*)flens});
  return (int)cudaGetLastError();
}

extern "C" const char* vlc_compat_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
