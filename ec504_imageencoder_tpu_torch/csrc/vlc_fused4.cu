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
// 8: the tables, the DC pass and the DCT are shared, the emission differs.
//
// Output, in stream order: planes of (R, NB * 64 / kFuse) int32 in one
// buffer, plane p < kFuse the word p (most significant first) of each
// fused slot of kFuse * 32 bits, plane kFuse its length.
//
// What bounds it on the H100: not bytes.  It reads 1.5 B of pixels per
// sample and writes 5 x 16 x 4 = 320 B (kFuse 4) or 9 x 8 x 4 = 288 B
// (kFuse 8) of fused slots per 8x8 block: 0.090 ms at 16 x 1080p.  At kFuse
// 4 (B1) the stores coalesce and B1 takes 0.36 ms there (H100 SXM, 700 W;
// 0.89 ms as a thread per block).  What is left is the per-thread DCT:
// 128 byte loads of pixels per block (pass 1 and pass 2, not coalesced)
// and its integer arithmetic.  95 registers and 44.7 KB of shared memory
// a block let 5 blocks of 128 threads share an SM (20 warps; 3 at the 168
// registers of the thread-per-block form), so 1,088 slice rows take 1.65
// waves on 132 SMs.
// kFuse 8 (B6b) still stores a thread per block, neighbouring threads 32 B
// apart, at 168 registers.
//
// Design: one CUDA block per slice (macroblock row).  A first pass computes
// every block's quantized DC from its pixel sum (the AAN DC is exactly
// (sum + 16) >> 3) into shared memory, so the DC predictor of any block is
// one shared read after a __syncthreads.  The DCT lives in registers, and
// the zigzag scatter indexes the levels at run time, so they go to shared
// memory.  The tables (AC run/level LUT, DC size VLCs, zigzag, qscale*W) are
// copied to shared memory once per block.
//  - kFuse 4 (B1): the second pass walks the NB = 6 * mbw blocks (1536 at
//    width 4096) in groups of 128, a thread per block for the DCT and
//    quantization into a swizzled block-major layout (conflict-free both
//    ways, planes_dct.cuh), then each warp emits its 32 blocks with one lane
//    per fused slot (vlc_emit.cuh, emit_fused4_lane): two blocks per pass,
//    each store one 128-byte line.  The group loop keeps every lane of a
//    warp together for the ballot and the shuffle of the zero run; a last
//    group shorter than 128 gives some warps fewer passes, or none.  Tried
//    before it: a thread per block storing its 16 fused slots in stream
//    order (64 B apart).  Staging the fused slots of a group in shared
//    memory instead needs ~40 KB more than the 44 KB the kernel has
//    (dynamic shared memory, fewer blocks per SM): not tried.
//  - kFuse 8 (B6b): a thread per block from DCT to store, levels in a
//    per-thread column of shared memory (level k of thread t at [k][t]);
//    a third fusion level pairs the 16 fused values into 8 of <= 256 bits
//    in registers (vlc_emit.cuh, emit_block_fused8).
// The block geometry, DCT and quantizer are shared with B6a
// (planes_dct.cuh), the DC/AC slot emission and the fusion with the other
// VLC kernels (vlc_emit.cuh).

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

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, tid, kThreads);
  if (tid < 64) {
    s_qw[tid] = qw[tid];
    // kFuse 4 keeps the levels swizzled (planes_dct.cuh, SwizzledLevels)
    s_zpos[zigzag[tid]] = kFuse == 4 ? swizzle_slot(tid) : tid;
  }

  // pass 1: quantized DC of every block, from the pixel sum
  for (int n = tid; n < nb; n += kThreads) {
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    s_dc[n] = block_dc(p, stride);
  }
  __syncthreads();

  if constexpr (kFuse == 4) {
    // pass 2, by groups of kThreads blocks: each thread the DCT, quantize
    // and zigzag of one block into the group's swizzled levels; then each
    // warp emits its own 32 blocks cooperatively, two per pass (lanes 0-15
    // and 16-31, blocks of a pass neighbours in stream order).  Only the
    // warp reads what it wrote, so __syncwarp orders it.
    const FusedOut out4{out, out + plane, out + 2 * plane, out + 3 * plane, out + 4 * plane};
    const int lane = tid & 31, warp0 = tid - lane;
    int* const lv_sh = &s_lv[0][0];
    for (int g = 0; g < nb; g += kThreads) {
      if (g + tid < nb) {
        int stride;
        const uint8_t* p = block_origin(y, cb, cr, b, my, g + tid, H, W, &stride);
        int x[8][8];
        block_aan_dct(p, stride, x);
        int* const blk = lv_sh + tid * 64;
        quantize_zigzag(x, s_qw, s_zpos, [blk, lane](int k, int lv) { blk[k ^ lane] = lv; });
      }
      __syncwarp();
      // nb is even, so the warp's pass count is uniform: 16, fewer in the
      // last group (a half warp at nb = 720 or 528), or none
      const int passes = min(16, (nb - g - warp0) / 2);
      for (int q = 0; q < passes; ++q) {
        const int t = warp0 + 2 * q + (lane >> 4);  // the block of this half-warp
        const int n = g + t;
        int lv[4];
        SwizzledLevels{lv_sh + t * 64, t}(lane & 15, lv);
        uint32_t code0 = 0;
        int len0 = 0;
        if ((lane & 15) == 0) {
          // previous same-component DC in stream order, 128 at slice start
          const int comp = n - 6 * (n / 6);
          const int back = comp == 0 ? 3 : (comp >= 4 ? 6 : 1);
          code0 = emit_dc(s_dc[n], n >= back ? s_dc[n - back] : 128, comp, s_dcc, len0);
        }
        emit_fused4_lane(lv, lane, code0, len0, s_ac, out4,
                         (size_t)row * kf + (size_t)n * kSlots + (lane & 15));
      }
      __syncwarp();
    }
  } else {
    // pass 2, a thread per block: DCT, quantize, zigzag, emit, fuse
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
      emit_block_fused8(levels, code0, len0, s_ac, out, plane,
                        (size_t)row * kf + (size_t)n * kSlots);
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
