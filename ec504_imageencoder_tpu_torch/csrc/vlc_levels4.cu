// vlc_levels4: zigzag levels + DC predictors -> 4:1-fused VLC slots.
//
// Replaces the Pallas kernel ec504_imageencoder_tpu/ops/pallas_vlc.py
// `_vlc_kernel` (launched by `vlc_slots_tpu`) and the XLA
// `fuse_slots_streamwise` behind it: the VLC emission of the high-quality
// path (f32 DCT at quality >= 70), whose DCT, quantization, zigzag and DC
// prediction the second entry point of this file, f32_levels_launch (its
// own section at the end), computes in front of it.  Per 8x8 block it emits
// the 64 correct-mode slots (dct_dc_size VLC + differential DC with the
// MB header folded in, AC run/level codes or escapes, EOB folded into slot
// 63) and fuses them 4:1 exactly, in stream order: B1's output format,
// ready for the pack kernel.
//
// What bounds it on the H100: bytes, by design.  Per block it reads 256 B
// of levels and 4 B of predictor and writes 320 B of fused slots (about
// 450 MB at 16 x 1080p, 0.14 ms at 3.35 TB/s).  A thread per block took
// 1.76 ms there (H100 SXM, 700 W): neighbouring threads loaded 16 B 256 B
// apart and stored 4 B 64 B apart, and the 64-step emission was a serial
// chain.  Now both sides coalesce and a block's emission is 16 lanes wide:
// 0.20 ms, 1.5x the bound.  What is left is the latency of one load per
// warp and pass, hidden by loading the next pair while emitting this one;
// 32 registers and 5.3 KB of shared memory keep 8 blocks of 256 threads
// (64 warps) on each SM.
//
// Design: the warp-cooperative emission of vlc_emit.cuh (emit_fused4_lane),
// B1's emission, on levels read from memory instead of computed in
// registers.  Blocks go in pairs to warps, over the whole batch at once (a
// slice row holds NB blocks, a multiple of 6, so a pair never straddles
// rows and block i of the batch is component i % 6): lanes 0-15 take the
// even block, 16-31 the odd one, lane j one 16-byte load of levels 4j ..
// 4j+3, so a warp reads 512 B and writes five 128-byte lines.  A block
// needs nothing from any other block (the predictors are an input), so
// there is no shared memory beyond the tables, and the grid is as many
// blocks as the card holds at once, each walking pairs with a stride.  The
// 4:1 fusion happens in registers, so the raw slots never reach device
// memory (the TPU wrote them and fused them in XLA).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "device_guard.cuh"
#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNB = 6 * 256;  // width 4096, as B1

__global__ void __launch_bounds__(kThreads)
vlc_levels4_kernel(const int4* __restrict__ levels, const int32_t* __restrict__ preds,
                   int pairs, const int32_t* __restrict__ ac_code,
                   const int32_t* __restrict__ ac_len, const int32_t* __restrict__ dc_code,
                   const int32_t* __restrict__ dc_len, int32_t* __restrict__ out_v0,
                   int32_t* __restrict__ out_v1, int32_t* __restrict__ out_v2,
                   int32_t* __restrict__ out_v3, int32_t* __restrict__ out_len) {
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];  // code | len << 16
  __shared__ uint32_t s_dcc[2 * kDcSizes];        // code | len << 16, [luma][size]

  const int lane = threadIdx.x & 31, j = lane & 15;
  const FusedOut out{out_v0, out_v1, out_v2, out_v3, out_len};

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, threadIdx.x, kThreads);
  __syncthreads();

  // the half-warp's block of pair p, its levels 4j .. 4j+3 and (lane j = 0)
  // its predictor
  auto load = [&](int p, int4& q, int& pred) {
    const int blk = 2 * p + (lane >> 4);
    q = __ldg(levels + (size_t)blk * 16 + j);
    pred = j == 0 ? __ldg(preds + blk) : 0;
  };
  const int stride = gridDim.x * kWarps;
  int p = blockIdx.x * kWarps + (threadIdx.x >> 5);  // warp-uniform
  int4 q = {0, 0, 0, 0};
  int pred = 0;
  if (p < pairs) load(p, q, pred);
  for (; p < pairs; p += stride) {
    const int blk = 2 * p + (lane >> 4);
    const int lv[4] = {q.x, q.y, q.z, q.w};
    const int pr = pred;
    if (p + stride < pairs) load(p + stride, q, pred);
    uint32_t code0 = 0;
    int len0 = 0;
    if (j == 0) code0 = emit_dc(lv[0], pr, blk % 6, s_dcc, len0);
    emit_fused4_lane(lv, lane, code0, len0, s_ac, out, (size_t)blk * 16 + j);
  }
}

}  // namespace

extern "C" int vlc_levels4_launch(const void* levels, const void* preds, int rows, int nb,
                                  const void* ac_code, const void* ac_len,
                                  const void* dc_code, const void* dc_len, void* v0,
                                  void* v1, void* v2, void* v3, void* flens, int device,
                                  void* stream) {
  if (rows < 0 || nb < 0 || nb % 6 || nb > kMaxNB || ((uintptr_t)levels & 15) ||
      (long long)rows * nb > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || nb == 0) return (int)cudaSuccess;
  // as many blocks as are resident at once, or fewer for a small input
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vlc_levels4_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int pairs = rows * nb / 2;
  const int grid = (int)std::min<long long>((pairs + kWarps - 1) / kWarps,
                                            (long long)sms * std::max(per_sm, 1));
  vlc_levels4_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)levels, (const int32_t*)preds, pairs, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      (int32_t*)v0, (int32_t*)v1, (int32_t*)v2, (int32_t*)v3, (int32_t*)flens);
  return (int)cudaGetLastError();
}

extern "C" const char* vlc_levels4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ---- f32_levels: padded 4:2:0 planes -> B3's levels and DC predictors ----
//
// The f32 route's `plane_levels` (models/mpeg1.py) in one launch: blockize,
// the orthonormal f32 DCT D @ X @ D.T, rounding half away from zero,
// intra quantization, zigzag and DC prediction.  It replaces no Pallas
// kernel: the reference runs this stage as an XLA einsum and elementwise
// ops (`_generic_pipeline_from_planes`).  Its plain twin is
// ops/cuda_vlc_levels.py::f32_levels_plain (`matmul_dct`, `quantize_intra`,
// `zigzag_scan`, `dc_predictors`).
//
// The arithmetic is numpy's einsum "vy,...yx,ux->...vu", operation for
// operation, as `matmul_dct` repeats it: coefficient (v, u) is one chain
// over y (outer) and k (inner) of acc += (d[v][y] * x[y][k]) * d[u][k],
// starting from its first product, every product and every sum rounded to
// f32 on its own (__fmul_rn / __fadd_rn, which nvcc never contracts into an
// FFMA).  The DCT's coefficients often sit on an exact .5, so another
// order, an FMA or TF32 would round some of them to the other integer.  The basis kDct holds dct_matrix_f32()'s f32 numbers as hex
// literals (a CPU test holds them equal).
//
// What bounds it on the H100: f32 instruction issue.  A block needs 512
// products d[v][y] * x[y][k], 4,096 products by d[u][k] and as many adds:
// ~8,700 instructions, no two of which can merge.  At 16 x 1080p (783,360
// blocks) that is 6.8 G instructions, 0.20 ms at 128 a clock on each of 132
// SMs at 1.98 GHz, against 0.075 ms for the bytes (~50 MB of planes read,
// 200 MB of levels written).  It takes 0.367-0.370 ms there by CUDA events
// (H100 SXM, 700 W), 1.8x that floor; the plain PyTorch ops it replaces
// took 27.2 ms.
//
// Design: a CUDA block takes kLevelsMbs consecutive macroblocks in stream
// order (6 blocks each, so a group never splits a macroblock) and a thread
// per (block, row v): the block's eight threads sit in one warp.  The
// threads stage the group's pixels in shared memory as f32 (a 8-byte load
// of one pixel row each); thread (b, v) keeps coefficient row v's eight
// accumulators in registers and reads the block's rows from shared memory
// (broadcast to its eight threads); d[u][k] is a constant-bank operand.
// Quantization is integer, as `quantize_intra`: the division by 2 qW a
// multiply-high by a per-entry multiplier built once per CUDA block.  The
// levels go back to the block's own shared memory (the pixels are no longer
// read after a __syncwarp), and the CUDA block stores its blocks' levels in
// zigzag order as coalesced 16-byte words, lane 0 the absolute DC.
// Predictors: the previous same-component DC in stream order, 128 at a
// slice row's start.  Inside the group they come from shared memory; for
// the group's first macroblock, whose predecessors (the previous
// macroblock's BR, Cb and Cr) lie in another group, three lanes of warp 0
// recompute those three DCs from their pixels (a 64-term chain each, 2% of
// the group's work), so the launch needs nothing from any other CUDA block.
// Geometry, timed in turns at 16 x 1080p (macroblocks per CUDA block x
// CUDA blocks per SM, ms): 8 x 4 0.367, 4 x 8 0.368, 2 x 16 0.378, 4 x 6
// 0.384, 16 x 2 0.397, 8 x 3 0.403, 16 x 1 0.495.

namespace {

// dct_matrix_f32(): kDct[v * 8 + y] = d[v][y]
__constant__ float kDct[64] = {
    0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,
    0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,
    0x1.f6297cp-2f,  0x1.a9b662p-2f,  0x1.1c73b4p-2f,  0x1.8f8b84p-4f,
    -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b662p-2f, -0x1.f6297cp-2f,
    0x1.d906bcp-2f,  0x1.87de2ap-3f,  -0x1.87de2ap-3f, -0x1.d906bcp-2f,
    -0x1.d906bcp-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f,  0x1.d906bcp-2f,
    0x1.a9b662p-2f,  -0x1.8f8b84p-4f, -0x1.f6297cp-2f, -0x1.1c73b4p-2f,
    0x1.1c73b4p-2f,  0x1.f6297cp-2f,  0x1.8f8b84p-4f,  -0x1.a9b662p-2f,
    0x1.6a09e6p-2f,  -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.6a09e6p-2f,  -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.1c73b4p-2f,  -0x1.f6297cp-2f, 0x1.8f8b84p-4f,  0x1.a9b662p-2f,
    -0x1.a9b662p-2f, -0x1.8f8b84p-4f, 0x1.f6297cp-2f,  -0x1.1c73b4p-2f,
    0x1.87de2ap-3f,  -0x1.d906bcp-2f, 0x1.d906bcp-2f,  -0x1.87de2ap-3f,
    -0x1.87de2ap-3f, 0x1.d906bcp-2f,  -0x1.d906bcp-2f, 0x1.87de2ap-3f,
    0x1.8f8b84p-4f,  -0x1.1c73b4p-2f, 0x1.a9b662p-2f,  -0x1.f6297cp-2f,
    0x1.f6297cp-2f,  -0x1.a9b662p-2f, 0x1.1c73b4p-2f,  -0x1.8f8b84p-4f,
};

constexpr int kLevelsMbs = 8;                   // macroblocks per CUDA block
constexpr int kLevelsBlocks = kLevelsMbs * 6;   // 8x8 blocks per CUDA block
constexpr int kLevelsThreads = kLevelsBlocks * 8;
constexpr int kLevelsMinBlocks = 4;             // CUDA blocks per SM (<= 40 registers)
// The largest divisor 2 qW whose multiply-high division is exact for every
// numerator 16 |F| + qW (|F| <= 2040): numerator * divisor < 2^32.
constexpr int kMaxMulDiv = 32767;

// f32 -> the nearest integer, halves away from zero (`matmul_dct`'s last line)
__device__ __forceinline__ int round_half_away(float f) {
  return (int)(f >= 0.f ? floorf(__fadd_rn(f, 0.5f)) : ceilf(__fsub_rn(f, 0.5f)));
}

// floor(num / d) for the quantizer's num >= 0 and 1 <= d (`torch.div(...,
// rounding_mode="floor")`): a multiply-high by m = ceil(2^32 / d) where
// 2 <= d <= kMaxMulDiv (then m != 0), else the division itself.
__device__ __forceinline__ int quant_div(int num, int d, uint32_t m) {
  if (m != 0u) return (int)__umulhi((uint32_t)num, m);
  const int q = num / d;
  return q * d != num && (num < 0) != (d < 0) ? q - 1 : q;
}

// The DC level of a block's f00: clamp((f00 + 4) >> 3, 0, 255)
__device__ __forceinline__ int dc_level(int f00) { return min(max((f00 + 4) >> 3, 0), 255); }

// Row `y` of the DCT for one coefficient row v: p[k] = d[v][y] * x[y][k],
// then acc[u] += p[k] * d[u][k] for k = 0 .. 7 (the first product of row 0
// starts each chain).
template <bool kFirst>
__device__ __forceinline__ void dct_row(const float4* __restrict__ row, float dvy, float acc[8]) {
  const float4 a = row[0], b = row[1];
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = __fmul_rn(dvy, x[k]);
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float t = __fmul_rn(p[k], kDct[u * 8 + k]);
      acc[u] = kFirst && k == 0 ? t : __fadd_rn(acc[u], t);
    }
}

// The 8x8 block of stream block g (= (row * mbw + mx) * 6 + c, row = the
// slice row b * mbh + my), its pixel row r: luma TL, TR, BL, BR, then Cb, Cr
// (`blockize`'s order).
__device__ __forceinline__ const uint8_t* block_row(const uint8_t* y, const uint8_t* cb,
                                                    const uint8_t* cr, int w, int mbw, int g,
                                                    int r) {
  const int mb = g / 6, c = g - mb * 6;
  const int row = mb / mbw, mx = mb - row * mbw;
  if (c < 4) return y + ((size_t)row * 16 + (c >> 1) * 8 + r) * w + mx * 16 + (c & 1) * 8;
  return (c == 4 ? cb : cr) + ((size_t)row * 8 + r) * (w / 2) + mx * 8;
}

__global__ void __launch_bounds__(kLevelsThreads, kLevelsMinBlocks)
f32_levels_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                  const uint8_t* __restrict__ cr, int w, int mbw, int nblocks,
                  const int32_t* __restrict__ qw, const int32_t* __restrict__ zigzag,
                  int4* __restrict__ levels, int32_t* __restrict__ preds) {
  // the group's blocks, then the previous macroblock's BR, Cb and Cr: 64
  // pixels each as f32 (16 float4), later the group's natural-order levels
  __shared__ float4 s_px[(kLevelsBlocks + 3) * 16];
  __shared__ int s_dc[kLevelsBlocks + 3];  // DC levels, the same order
  __shared__ int s_qw[64];
  __shared__ uint32_t s_m[64];             // quant_div's multipliers
  __shared__ int s_zz[64];                 // scan position -> natural index

  const int t = threadIdx.x;
  const int g0 = blockIdx.x * kLevelsBlocks;
  // the group's first macroblock continues a slice row: its predecessors
  // (blocks g0 - 3 .. g0 - 1) are needed
  const bool carry = (g0 / 6) % mbw != 0;

  if (t < 64) {
    const int q = qw[t], d = 2 * q;
    s_qw[t] = q;
    s_m[t] = d >= 2 && d <= kMaxMulDiv ? 0xFFFFFFFFu / (uint32_t)d + 1u : 0u;  // ceil(2^32 / d)
    s_zz[t] = zigzag[t] & 63;
  }
  for (int i = t; i < (kLevelsBlocks + 3) * 8; i += kLevelsThreads) {
    const int lb = i >> 3, r = i & 7;
    const int g = lb < kLevelsBlocks ? g0 + lb : g0 - 3 + (lb - kLevelsBlocks);
    const bool live = lb < kLevelsBlocks ? g < nblocks : carry;
    uint2 v = {0u, 0u};
    if (live) v = __ldg((const uint2*)block_row(y, cb, cr, w, mbw, g, r));
    float4* out = s_px + lb * 16 + r * 2;
    out[0] = make_float4((float)(v.x & 255u), (float)(v.x >> 8 & 255u),
                         (float)(v.x >> 16 & 255u), (float)(v.x >> 24));
    out[1] = make_float4((float)(v.y & 255u), (float)(v.y >> 8 & 255u),
                         (float)(v.y >> 16 & 255u), (float)(v.y >> 24));
  }
  __syncthreads();

  // the three predecessors' DCs: row 0 of the DCT, u = 0 alone
  if (t < 3 && carry) {
    const float4* px = s_px + (kLevelsBlocks + t) * 16;
    float acc = 0.f;
#pragma unroll
    for (int yy = 0; yy < 8; ++yy) {
      const float4 a = px[yy * 2], b = px[yy * 2 + 1];
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float p = __fmul_rn(__fmul_rn(kDct[yy], x[k]), kDct[k]);
        acc = yy == 0 && k == 0 ? p : __fadd_rn(acc, p);
      }
    }
    s_dc[kLevelsBlocks + t] = dc_level(round_half_away(acc));
  }

  const int lb = t >> 3, v = t & 7;
  const int g = g0 + lb;
  if (g < nblocks) {
    const float4* px = s_px + lb * 16;
    float acc[8];
    dct_row<true>(px, kDct[v * 8], acc);
#pragma unroll
    for (int yy = 1; yy < 8; ++yy) dct_row<false>(px + yy * 2, kDct[v * 8 + yy], acc);
    int lv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = round_half_away(acc[u]), n = v * 8 + u;
      const int mag = min(max(quant_div(16 * abs(f) + s_qw[n], 2 * s_qw[n], s_m[n]), 0), 255);
      lv[u] = f > 0 ? mag : f < 0 ? -mag : 0;
      if (n == 0) s_dc[lb] = dc_level(f);
    }
    __syncwarp(0xFFu << (t & 24));  // the block's eight lanes have read its pixels
    int4* dst = (int4*)(s_px + lb * 16) + v * 2;
    dst[0] = make_int4(lv[0], lv[1], lv[2], lv[3]);
    dst[1] = make_int4(lv[4], lv[5], lv[6], lv[7]);
  }
  __syncthreads();

  for (int j = t; j < kLevelsBlocks * 16; j += kLevelsThreads) {
    const int jb = j >> 4, q = j & 15;
    if (g0 + jb >= nblocks) break;
    const int* lvs = (const int*)(s_px + jb * 16);
    const int i = q * 4;
    levels[(size_t)(g0 + jb) * 16 + q] =
        make_int4(q == 0 ? s_dc[jb] : lvs[s_zz[i]], lvs[s_zz[i + 1]], lvs[s_zz[i + 2]],
                  lvs[s_zz[i + 3]]);
  }
  if (t < kLevelsBlocks && g0 + t < nblocks) {
    const int c = t % 6;  // g0 is a multiple of 6
    const bool first = (g0 + t) / 6 % mbw == 0;
    int p;
    if (c >= 1 && c <= 3) p = s_dc[t - 1];
    else if (first) p = 128;
    else if (c == 0) p = t >= 3 ? s_dc[t - 3] : s_dc[kLevelsBlocks];
    else p = t >= 6 ? s_dc[t - 6] : s_dc[kLevelsBlocks + c - 3];
    preds[g0 + t] = p;
  }
}

}  // namespace

// y (B, H, W), cb and cr (B, H/2, W/2) u8 planes, H and W multiples of 16,
// each 8-byte aligned; qw and zigzag 64 int32 ->
// levels (B * H/16, W/16 * 6, 64) int32 (16-byte aligned) and preds
// (B * H/16, W/16 * 6) int32.
extern "C" int f32_levels_launch(const void* y, const void* cb, const void* cr, int batch,
                                 int h, int w, const void* qw, const void* zigzag, void* levels,
                                 void* preds, int device, void* stream) {
  const long long nblocks = (long long)batch * (h / 16) * (w / 16) * 6;
  if (batch < 0 || h < 0 || w < 0 || h % 16 || w % 16 || nblocks > INT_MAX ||
      ((uintptr_t)y | (uintptr_t)cb | (uintptr_t)cr) & 7 || (uintptr_t)levels & 15)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  const cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (nblocks == 0) return (int)cudaSuccess;
  const int grid = (int)((nblocks + kLevelsBlocks - 1) / kLevelsBlocks);
  f32_levels_kernel<<<grid, kLevelsThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, w, w / 16, (int)nblocks,
      (const int32_t*)qw, (const int32_t*)zigzag, (int4*)levels, (int32_t*)preds);
  return (int)cudaGetLastError();
}
