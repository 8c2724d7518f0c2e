// bit_count: 4:2:0 planes -> every slice's exact coded bits at each
// quantizer_scale 1..31, the table the rate control (`bit_rate`) picks each
// picture's scale from.
//
// No TPU kernel of the reference does this: the JAX package codes every
// picture at one scale.  Per 8x8 block it computes what B1 computes up to
// the emission (vlc_fused4.cu: the integer AAN DCT, the quantized DC from
// the pixel sum, the DC predictor), then, for each of the 31 scales, the
// ISO intra quantization of the 63 AC coefficients in zigzag order and
// the length of each run/level code, escapes included (20 or 28 bits).
// A slice's bits at a scale are its 38 header bits, per macroblock the
// 2-bit header ('1' address increment, '1' intra), per block the DC size
// code and differential bits, the AC codes and the 2-bit EOB: the nbits
// B1 + B2 give at that scale.
//
// Output: (rows, 31) int32, rows = batch * H/16 slice rows in picture
// order, entry [r, q - 1] the exact bits of slice r at quantizer_scale q
// (not rounded to bytes: the caller rounds each slice up, as B2 lays the
// slices out byte-aligned).
//
// What bounds it: the integer instruction rate.  It reads 1.5 B of pixels
// a sample once and writes 124 B a slice; per block and scale it does 63 quantizations
// and length lookups.  Each is an add, a multiply-high by the divisor's
// reciprocal (exact, see quantize_mag), a clamp, a length load, an add and
// the run update.
//
// Design: one CUDA block per slice row, 128 threads, a thread per 8x8
// block (B1's geometry: the DC pass over every block of the row into
// shared memory first, then groups of 128 blocks).  A thread keeps its
// block's 64 coefficients in registers, as 16 |F|, and walks the 31 scales;
// for each, the 63 AC coefficients unrolled in zigzag order (their
// register index a compile-time constant).  The per-scale constants (qW and
// the multiplier of 2 qW for each scan position) are a warp-uniform
// broadcast load from shared memory; the code length is one byte load from
// a (run, |level|) table of 63 x 256 entries whose rows are 260 bytes
// apart, so that the zero-level loads of lanes at different runs fall on
// different banks.  A warp sums each scale's bits with one reduction and
// adds it to the row's shared total.
//
// Quantization (ops/quant.py::quantize_intra): |level| = min(255,
// floor((16 |F| + qW) / (2 qW))).  With n = 16 |F| + qW < 2^18 (|F| of the
// AAN DCT of u8 pixels stays below 2^12) and d = 2 qW <= 2 x 255 x 31 <
// 2^14, the multiplier m = ceil(2^32 / d), m d = 2^32 + e with 0 <= e < d,
// gives floor(n m / 2^32) = floor(n / d) exactly, since n e < 2^32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "planes_dct.cuh"
#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 128;
constexpr int kMaxNB = 6 * 256;  // width 4096
constexpr int kScales = 31;      // quantizer_scale 1..31
constexpr int kRuns = 63;        // zero runs 0..62 before a nonzero AC level
constexpr int kLenRow = 260;     // bytes between (run, .) rows of the length table
constexpr int kSliceHeaderBits = 38;

// ISO 11172-2 zigzag: scan position k -> natural index v * 8 + u
// (utils/tables.py::ZIGZAG_GATHER; tests/test_torch_rate.py holds them equal).
__host__ __device__ constexpr int zigzag_nat(int k) {
  constexpr int t[64] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  return t[k];
}

// The length of a nonzero AC level's code, sign bit included
// (emit_ac): run 0 |level| 1 is '11s'; a table row, its length + 1; else
// the escape, 20 bits below |level| 128, 28 from it.  Level 0: 0.
__device__ __forceinline__ uint8_t ac_code_len(int run, int al, const int32_t* ac_len) {
  if (al == 0) return 0;
  if (run == 0 && al == 1) return 3;
  const int t = (run < kAcRuns && al < kAcLevels) ? ac_len[run * kAcLevels + al] : 0;
  if (t > 0) return (uint8_t)(t + 1);
  return al >= 128 ? 28 : 20;
}

// min(255, floor(n / d)) for the multiplier m = ceil(2^32 / d) (see the
// file's head for why it is exact).
__device__ __forceinline__ int quantize_mag(uint32_t n, uint32_t m) {
  return min((int)__umulhi(n, m), 255);
}

// AC scan positions K .. 63 of one block at one scale: a16 the block's
// 16 |F| in natural order, qm the scale's constants by scan position;
// `bits` gets their code lengths, `runoff` carries the zero run (as its
// row offset in s_len).  A template over K, so that each register index
// is a constant.
template <int K>
__device__ __forceinline__ void count_ac(const uint32_t (&a16)[64], const uint2* qm,
                                         const uint8_t* s_len, int& bits, int& runoff) {
  constexpr int nat = zigzag_nat(K);
  const uint2 c = qm[K];
  const int mag = quantize_mag(a16[nat] + c.x, c.y);
  bits += s_len[runoff + mag];
  runoff = mag ? 0 : runoff + kLenRow;
  if constexpr (K < 63) count_ac<K + 1>(a16, qm, s_len, bits, runoff);
}

__global__ void __launch_bounds__(kThreads)
bit_count_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                 const uint8_t* __restrict__ cr, int mbh, int H, int W,
                 const int32_t* __restrict__ intra_q, const int32_t* __restrict__ ac_len,
                 const int32_t* __restrict__ dc_len, int32_t* __restrict__ out) {
  __shared__ uint8_t s_len[kRuns * kLenRow];
  __shared__ uint2 s_qm[kScales][64];  // (qW, ceil(2^32 / 2 qW)) by scale and scan position
  __shared__ int s_dc[kMaxNB];
  __shared__ int s_dcl[2 * kDcSizes];  // [is_luma][size]
  __shared__ int s_bits[kScales];
  __shared__ int s_base;  // the row's bits at every scale: DC codes, MB headers, EOBs

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int b = row / mbh, my = row - b * mbh;
  const int nb = (W / 16) * 6;

  for (int i = tid; i < kRuns * kLenRow; i += kThreads) {
    const int run = i / kLenRow, al = i - run * kLenRow;
    s_len[i] = al < 256 ? ac_code_len(run, al, ac_len) : 0;
  }
  for (int i = tid; i < kScales * 64; i += kThreads) {
    const int q = i / 64 + 1, k = i - (i / 64) * 64;
    const uint32_t qw = (uint32_t)(intra_q[zigzag_nat(k)] * q);
    s_qm[q - 1][k] = make_uint2(qw, 0xFFFFFFFFu / (2u * qw) + 1u);
  }
  if (tid < 2 * kDcSizes) s_dcl[tid] = dc_len[tid];
  if (tid < kScales) s_bits[tid] = 0;
  if (tid == 0) s_base = 0;

  // pass 1: quantized DC of every block, from the pixel sum
  for (int n = tid; n < nb; n += kThreads) {
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    s_dc[n] = block_dc(p, stride);
  }
  __syncthreads();

  // pass 2, by groups of kThreads blocks, every lane of a warp in every
  // reduction (a lane past the row's last block counts zeros)
  const int lane = tid & 31;
  int base = 0;
  for (int g = 0; g < nb; g += kThreads) {
    const int n = g + tid;
    uint32_t a16[64];
    if (n < nb) {
      int stride;
      const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
      int x[8][8];
      block_aan_dct(p, stride, x);
#pragma unroll
      for (int i = 0; i < 64; ++i) a16[i] = 16u * (uint32_t)abs(x[i >> 3][i & 7]);
      // the DC slot (emit_dc's length) and the EOB
      const int comp = n - 6 * (n / 6);
      const int back = comp == 0 ? 3 : (comp >= 4 ? 6 : 1);
      const int diff = s_dc[n] - (n >= back ? s_dc[n - back] : 128);
      const int sz = 32 - __clz(min(abs(diff), 255));
      base += s_dcl[(comp < 4 ? kDcSizes : 0) + sz] + sz + (comp == 0 ? 2 : 0) + 2;
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) a16[i] = 0u;
    }
#pragma unroll 1
    for (int q = 0; q < kScales; ++q) {
      int bits = 0, runoff = 0;
      count_ac<1>(a16, s_qm[q], s_len, bits, runoff);
      const int warp_bits = __reduce_add_sync(0xFFFFFFFFu, bits);
      if (lane == 0) atomicAdd(&s_bits[q], warp_bits);
    }
  }
  const int warp_base = __reduce_add_sync(0xFFFFFFFFu, base);
  if (lane == 0) atomicAdd(&s_base, warp_base);
  __syncthreads();
  if (tid < kScales) out[(size_t)row * kScales + tid] = kSliceHeaderBits + s_base + s_bits[tid];
}

}  // namespace

// out: (batch * H/16, 31) int32, contiguous; intra_q (8, 8) int32, natural
// order, entries 1..255; ac_len (32, 41), dc_len (2, 9) int32: the ISO
// tables of correct mode (cuda_vlc.Luts).
extern "C" int bit_count_launch(const void* y, const void* cb, const void* cr, int batch, int H,
                                int W, const void* intra_q, const void* ac_len,
                                const void* dc_len, void* out, int device, void* stream) {
  if (H % 16 || W % 16 || (W / 16) * 6 > kMaxNB || batch < 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  const int mbh = H / 16;
  const int rows = batch * mbh;
  if (rows == 0 || W == 0) return (int)cudaSuccess;
  bit_count_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, mbh, H, W,
      (const int32_t*)intra_q, (const int32_t*)ac_len, (const int32_t*)dc_len, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* bit_count_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
