// vlc_raw: 4:2:0 planes -> raw (code, len) VLC slots of every 8x8 block,
// and the DCT-magnitude guard.
//
// Replaces the Pallas kernel ec504_imageencoder_tpu/ops/pallas_vlc.py
// `_vlc_blocks_kernel` (launched by `vlc_from_blocks_tpu`) and the XLA
// blockize in front of it.  It is the raw-slot route of the sanitizer
// (`debug_checks`): B1 without the fusion, so that the slot invariants can
// be checked before the slots are fused and packed.  Per 8x8 block it
// computes the reference's integer AAN DCT, ISO intra quantization,
// zigzag, differential DC and the 64-slot emission (MB header folded into
// the DC slot, EOB into slot 63), and counts the blocks whose largest
// |F| reaches 2^19: the DCT-magnitude guard of `_vlc_blocks_core`'s debug
// form (the quantizer of the reference is exact only below that).
//
// Output: codes and lens (R, 64, NB) int32, slot k of block n of slice row
// r at [r, k, n] (codes hold u32 bits), and the guard counts (R,) int32.
//
// What bounds it on the H100: the work, not bytes.  It reads 1.5 B of
// pixels per sample (twice: the DC pass and the block pass) and writes
// 512 B of slots per block (400 MB at 16 x 1080p, 0.12 ms at 3.35 TB/s);
// the DCT and the 64-step sequential emission are B1's.
//
// Design: B1's (one CUDA block per slice row, a first pass of DCs from the
// pixel sums into shared memory for the predictors, the DCT in registers,
// the zigzag levels in a per-thread column of shared memory), from the
// same device code (planes_dct.cuh, vlc_emit.cuh).  Only the store
// differs: slot-major rows, so for each slot the block's threads store
// neighbouring words (coalesced), where B1 fuses in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "planes_dct.cuh"
#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 128;
constexpr int kMaxNB = 6 * 256;   // width 4096, as B1
constexpr int kFMax = 1 << 19;    // the DCT-magnitude guard

__global__ void __launch_bounds__(kThreads)
vlc_raw_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
               const uint8_t* __restrict__ cr, int mbh, int H, int W,
               const int32_t* __restrict__ qw, const int32_t* __restrict__ zigzag,
               const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
               const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
               int32_t* __restrict__ codes, int32_t* __restrict__ lens,
               int32_t* __restrict__ dct_viol) {
  __shared__ int s_lv[64][kThreads];
  __shared__ int s_dc[kMaxNB];
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];  // code | len << 16
  __shared__ uint32_t s_dcc[2 * kDcSizes];        // code | len << 16, [luma][size]
  __shared__ int s_qw[64];
  __shared__ int s_zpos[64];                      // natural index -> scan position
  __shared__ int s_viol;

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int b = row / mbh, my = row - b * mbh;
  const int nb = (W / 16) * 6;

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, tid, kThreads);
  if (tid < 64) {
    s_qw[tid] = qw[tid];
    s_zpos[zigzag[tid]] = tid;
  }
  if (tid == 0) s_viol = 0;

  // pass 1: quantized DC of every block, from the pixel sum
  for (int n = tid; n < nb; n += kThreads) {
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    s_dc[n] = block_dc(p, stride);
  }
  __syncthreads();

  // pass 2: DCT, guard, quantize, zigzag, emit
  int big = 0;
  for (int n = tid; n < nb; n += kThreads) {
    const int comp = n - 6 * (n / 6);
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    int x[8][8];
    block_aan_dct(p, stride, x);
    int fmax = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v)
#pragma unroll
      for (int u = 0; u < 8; ++u) fmax = max(fmax, abs(x[v][u]));
    big += fmax >= kFMax;
    const int dc = min(max((x[0][0] + 4) >> 3, 0), 255);
    quantize_to_column<kThreads>(x, s_qw, s_zpos, &s_lv[0][tid]);

    // previous same-component DC in stream order, 128 at slice start
    const int back = comp == 0 ? 3 : (comp >= 4 ? 6 : 1);
    const int pred = n >= back ? s_dc[n - back] : 128;
    int len0;
    const uint32_t code0 = emit_dc(dc, pred, comp, s_dcc, len0);
    const size_t o = (size_t)row * 64 * nb + n;
    emit_block_raw(ColumnLevels<kThreads>{&s_lv[0][tid]}, code0, len0, s_ac, codes + o,
                   lens + o, (size_t)nb);
  }
  if (big) atomicAdd(&s_viol, big);
  __syncthreads();
  if (tid == 0) dct_viol[row] = s_viol;
}

}  // namespace

extern "C" int vlc_raw_launch(const void* y, const void* cb, const void* cr, int batch, int H,
                              int W, const void* qw, const void* zigzag, const void* ac_code,
                              const void* ac_len, const void* dc_code, const void* dc_len,
                              void* codes, void* lens, void* dct_viol, int device,
                              void* stream) {
  if (H % 16 || W % 16 || (W / 16) * 6 > kMaxNB || batch < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int mbh = H / 16;
  const int rows = batch * mbh;
  if (rows == 0 || W == 0) return (int)cudaSuccess;
  vlc_raw_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, mbh, H, W,
      (const int32_t*)qw, (const int32_t*)zigzag, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      (int32_t*)codes, (int32_t*)lens, (int32_t*)dct_viol);
  return (int)cudaGetLastError();
}

extern "C" const char* vlc_raw_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
