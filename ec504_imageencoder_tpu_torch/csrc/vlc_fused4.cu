// vlc_fused4 / vlc_fused8: 4:2:0 planes -> 4:1- or 8:1-fused VLC slots of
// every 8x8 block.
//
// Replaces the Pallas kernels ec504_imageencoder_tpu/ops/pallas_vlc.py
// `_vlc_blocks_fused_kernel` (B1, launched by
// `vlc_fused_slots_from_blocks_tpu`) and `_vlc_blocks_fused8_kernel` (B6b,
// `vlc_fused8_slots_from_blocks_tpu`, the EC504_FUSE=8 route), each with
// the XLA blockize in front of it and the `fused_stack_to_stream` /
// `fused8_stack_to_stream` transpose behind it.  Per 8x8 block it computes
// the reference's integer AAN DCT, ISO intra quantization, zigzag,
// differential DC, 64-slot VLC emission (MB header folded into the DC
// slot, EOB into slot 63) and the exact 4:1 slot fusion; at 8:1 a third
// fusion level pairs the block's 16 fused values (slots 2k, 2k+1) into 8
// values of <= 256 bits, in registers.  One kernel template, kFuse = 4 or
// 8; only the store differs.
//
// Output, in stream order: planes of (R, NB * 64 / kFuse) int32 in one
// buffer, plane p < kFuse the word p (most significant first) of each
// fused slot of kFuse * 32 bits, plane kFuse its length.
//
// What bounds it on the H100: not bytes.  It reads 1.5 B of pixels per
// sample and writes 5 x 16 x 4 = 320 B (kFuse 4) or 9 x 8 x 4 = 288 B
// (kFuse 8) of fused slots per 8x8 block; the stream-order stores are
// uncoalesced (neighbouring threads 64 B or 32 B apart), and they set its
// time (PERF.md).
//
// Design: one CUDA block per slice (macroblock row); threads loop over the
// NB = 6 * mbw 8x8 blocks of the slice (NB reaches 1536 at width 4095, more
// than a block's threads).  A first pass computes every block's quantized
// DC from its pixel sum (the AAN DC is exactly (sum + 16) >> 3) into shared
// memory, so the DC predictor of any block is one shared read after a
// __syncthreads; the second pass does the full block.  The DCT lives in
// registers; the 64 zigzag levels of a thread's block live in a per-thread
// column of shared memory (level k of thread t at [k][t], conflict-free),
// because the zigzag scatter indexes them at run time.  Tables (AC run/
// level LUT, DC size VLCs, zigzag, qscale*W) are copied to shared memory
// once per block.  Pixel loads and slot stores are not coalesced: a later
// PR can stage them through shared memory.  The block geometry, DCT and
// quantizer are shared with B6a (planes_dct.cuh), the DC/AC slot emission
// and the fusion stores with the other VLC kernels (vlc_emit.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "planes_dct.cuh"
#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 128;
constexpr int kMaxNB = 6 * 256;   // width 4096

// kFuse = 4: out holds 5 planes (v0..v3, len); kFuse = 8: 9 planes
// (w0..w7, len); `plane` is the int32 count of one plane.
template <int kFuse>
__global__ void __launch_bounds__(kThreads)
vlc_fused_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                 const uint8_t* __restrict__ cr, int mbh, int H, int W,
                 const int32_t* __restrict__ qw, const int32_t* __restrict__ zigzag,
                 const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
                 const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
                 int32_t* __restrict__ out, size_t plane) {
  static_assert(kFuse == 4 || kFuse == 8, "4:1 or 8:1 fusion");
  constexpr int kSlots = 64 / kFuse;  // fused slots per 8x8 block
  __shared__ int s_lv[64][kThreads];
  __shared__ int s_dc[kMaxNB];
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];  // code | len << 16
  __shared__ uint32_t s_dcc[2 * kDcSizes];        // code | len << 16, [luma][size]
  __shared__ int s_qw[64];
  __shared__ int s_zpos[64];                      // natural index -> scan position

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int b = row / mbh, my = row - b * mbh;
  const int nb = (W / 16) * 6;
  const size_t kf = (size_t)nb * kSlots;

  const FusedOut out4{out, out + plane, out + 2 * plane, out + 3 * plane, out + 4 * plane};

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, tid, kThreads);
  if (tid < 64) {
    s_qw[tid] = qw[tid];
    s_zpos[zigzag[tid]] = tid;
  }

  // pass 1: quantized DC of every block, from the pixel sum
  for (int n = tid; n < nb; n += kThreads) {
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    s_dc[n] = block_dc(p, stride);
  }
  __syncthreads();

  // pass 2: DCT, quantize, zigzag, emit, fuse
  for (int n = tid; n < nb; n += kThreads) {
    const int comp = n - 6 * (n / 6);
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    int x[8][8];
    block_aan_dct(p, stride, x);
    const int dc = min(max((x[0][0] + 4) >> 3, 0), 255);
    quantize_to_column<kThreads>(x, s_qw, s_zpos, &s_lv[0][tid]);

    // previous same-component DC in stream order, 128 at slice start
    const int back = comp == 0 ? 3 : (comp >= 4 ? 6 : 1);
    const int pred = n >= back ? s_dc[n - back] : 128;
    int len0;
    const uint32_t code0 = emit_dc(dc, pred, comp, s_dcc, len0);
    const ColumnLevels<kThreads> levels{&s_lv[0][tid]};
    const size_t obase = (size_t)row * kf + (size_t)n * kSlots;
    if constexpr (kFuse == 4) {
      emit_block_fused4(levels, code0, len0, s_ac, out4, obase);
    } else {
      emit_block_fused8(levels, code0, len0, s_ac, out, plane, obase);
    }
  }
}

template <int kFuse>
int launch(const void* y, const void* cb, const void* cr, int batch, int H, int W,
           const void* qw, const void* zigzag, const void* ac_code, const void* ac_len,
           const void* dc_code, const void* dc_len, void* out, int device, void* stream) {
  if (H % 16 || W % 16 || (W / 16) * 6 > kMaxNB || batch < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int mbh = H / 16;
  const int rows = batch * mbh;
  if (rows == 0 || W == 0) return (int)cudaSuccess;
  const size_t plane = (size_t)rows * (W / 16) * 6 * (64 / kFuse);
  vlc_fused_kernel<kFuse><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, mbh, H, W,
      (const int32_t*)qw, (const int32_t*)zigzag, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      (int32_t*)out, plane);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (kFuse + 1, batch * H/16, 6 * W/16 * 64/kFuse) int32, contiguous.
extern "C" int vlc_fused4_launch(const void* y, const void* cb, const void* cr,
                                 int batch, int H, int W, const void* qw,
                                 const void* zigzag, const void* ac_code,
                                 const void* ac_len, const void* dc_code,
                                 const void* dc_len, void* out, int device, void* stream) {
  return launch<4>(y, cb, cr, batch, H, W, qw, zigzag, ac_code, ac_len, dc_code, dc_len, out,
                   device, stream);
}

extern "C" int vlc_fused8_launch(const void* y, const void* cb, const void* cr,
                                 int batch, int H, int W, const void* qw,
                                 const void* zigzag, const void* ac_code,
                                 const void* ac_len, const void* dc_code,
                                 const void* dc_len, void* out, int device, void* stream) {
  return launch<8>(y, cb, cr, batch, H, W, qw, zigzag, ac_code, ac_len, dc_code, dc_len, out,
                   device, stream);
}

extern "C" const char* vlc_fused4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
