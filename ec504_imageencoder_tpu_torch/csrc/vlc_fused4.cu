// vlc_fused4 / vlc_fused8 / vlc_raw: 4:2:0 planes -> the VLC slots of
// every 8x8 block, 4:1-fused, 8:1-fused or raw.
//
// Replaces the Pallas kernels ec504_imageencoder_tpu/ops/pallas_vlc.py
// `_vlc_blocks_fused_kernel` (B1, launched by
// `vlc_fused_slots_from_blocks_tpu`), `_vlc_blocks_fused8_kernel` (B6b,
// `vlc_fused8_slots_from_blocks_tpu`, the EC504_FUSE=8 route) and
// `_vlc_blocks_kernel` (B6a, `vlc_from_blocks_tpu`, the raw slots of the
// sanitizer), each with the XLA blockize in front of it and, for the fused
// forms, the `fused_stack_to_stream` / `fused8_stack_to_stream` transpose
// behind it.  Per 8x8 block it computes the reference's integer AAN DCT,
// ISO intra quantization, zigzag, differential DC and the 64-slot VLC
// emission (MB header folded into the DC slot, EOB into slot 63); then the
// exact 4:1 slot fusion (B1), a third fusion level that pairs the block's
// 16 fused values (slots 2k, 2k+1) into 8 values of <= 256 bits (B6b), or
// no fusion and the DCT-magnitude guard of `_vlc_blocks_core`'s debug form
// (B6a: the blocks whose largest |F| reaches 2^19, where the reference's
// quantizer stops being exact).  One kernel template over the store: the
// tables, the DC pass, the DCT and the emission are shared.
//
// Output: B1 and B6b, in stream order, planes of (R, NB * 64 / f) int32 in
// one buffer (f = 4 or 8), plane p < f the word p (most significant first)
// of each fused slot of 32 f bits, plane f its length.  B6a, slot-major:
// codes then lengths, each (R, 64, NB) int32, slot k of block n of slice
// row r at [r, k, n] (codes hold u32 bits), and the guard counts (R,)
// int32, added to a buffer the caller zeroes.
//
// What bounds it on the H100: not bytes.  It reads 1.5 B of pixels per
// sample and writes 5 x 16 x 4 = 320 B (B1), 9 x 8 x 4 = 288 B (B6b) or
// 2 x 64 x 4 = 512 B (B6a) per 8x8 block: 0.08-0.13 ms at 16 x 1080p.
// There B1 takes 0.36-0.37 ms, B6b 0.41 and B6a 0.41 (CUDA events, NVIDIA
// H100 80GB HBM3, 700.00 W): what holds all three is the shared per-thread
// DCT, 128 byte loads of pixels per block (pass 1 and pass 2, not
// coalesced) and its integer arithmetic; B6a adds its 150 MB of extra
// stores.  95-96 registers and 44.7 KB of shared memory a block let 5
// blocks of 128 threads share an SM (20 warps), so 1,088 slice rows take
// 1.65 waves on 132 SMs.
//
// Design: one CUDA block per slice (macroblock row).  A first pass computes
// every block's quantized DC from its pixel sum (the AAN DC is exactly
// (sum + 16) >> 3) into shared memory, so the DC predictor of any block is
// one shared read after a __syncthreads.  The tables (AC run/level LUT, DC
// size VLCs, zigzag, qscale*W with the slice's picture's scale where the
// caller gives one a picture) are copied to shared memory once per block.
// The second pass walks the NB = 6 * mbw blocks (1536 at width 4096) in
// groups of 128: a thread per block for the DCT (in registers) and the
// quantization into a swizzled block-major layout (conflict-free both ways,
// planes_dct.cuh), then each warp emits its 32 blocks with one lane per
// four slots (vlc_emit.cuh, half_warp_run): two blocks per pass.  The group
// loop keeps every lane of a warp together for the ballot and the shuffles;
// a last group shorter than 128 gives some warps fewer passes, or none.
// Only the warp reads what it wrote, so __syncwarp orders it.  The stores:
//  - B1 (emit_fused4_lane): lane j fuses slots 4j .. 4j+3; each of its five
//    stores writes 32 consecutive int32 (one 128-byte line).  Tried before
//    it: a thread per block storing its 16 fused slots in stream order (64
//    B apart), 0.89 ms at 168 registers.  Staging a group's fused slots in
//    shared memory instead needs ~40 KB more (fewer blocks per SM): not
//    tried.
//  - B6b (emit_fused8_lane): lanes 2k and 2k+1 exchange their 4:1 values and
//    both form fused-8 slot k; the even lane stores words 0-3 and the
//    length, the odd lane words 4-7, so each store fills two 64-byte runs.
//    Before it: a thread per block from DCT to store, neighbouring threads
//    32 B apart, 168 registers, 0.68 ms (same card and shape).
//  - B6a: each lane parks its four slots, code and length in one word
//    (slot_word), in the shared words it read their levels from; then the
//    warp stores slot-major, lane t slot k of its own block g + warp0 + t,
//    one 128-byte run per instruction (the read is the scatter's
//    conflict-free pattern).  Before it: a thread per block, a 64-step
//    serial emission and 255 registers (2 blocks per SM), 0.42 ms (same
//    card and shape).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "planes_dct.cuh"
#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 128;
constexpr int kMaxNB = 6 * 256;  // width 4096
constexpr int kFMax = 1 << 19;   // B6a's DCT-magnitude guard

// What the kernel stores: B1's 4:1-fused slots, B6b's 8:1-fused slots or
// B6a's raw slots.
enum class Store { kFused4, kFused8, kRaw };

// Int32 words of a plane per 8x8 block.
__host__ __device__ constexpr int plane_slots(Store st) {
  return st == Store::kFused4 ? 16 : (st == Store::kFused8 ? 8 : 64);
}

// out holds 5 planes (v0..v3, len; kFused4), 9 (w0..w7, len; kFused8) or
// 2 (codes, lens; kRaw); `plane` is the int32 count of one plane.
// dct_viol: kRaw's guard counts (R,), zeroed by the caller.
template <Store kStore>
__global__ void __launch_bounds__(kThreads)
vlc_slots_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                 const uint8_t* __restrict__ cr, int mbh, int H, int W,
                 const int32_t* __restrict__ qw, const int32_t* __restrict__ qscale,
                 const int32_t* __restrict__ zigzag,
                 const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
                 const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
                 int32_t* __restrict__ out, size_t plane, int32_t* __restrict__ dct_viol) {
  constexpr int kSlots = plane_slots(kStore);
  __shared__ int s_lv[64][kThreads];
  __shared__ int s_dc[kMaxNB];
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];  // code | len << 16
  __shared__ uint32_t s_dcc[2 * kDcSizes];        // code | len << 16, [luma][size]
  __shared__ int s_qw[64];
  __shared__ int s_zpos[64];                      // natural index -> swizzled scan position

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int b = row / mbh, my = row - b * mbh;
  const int nb = (W / 16) * 6;
  const size_t kf = (size_t)nb * kSlots;

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, tid, kThreads);
  if (tid < 64) {
    s_qw[tid] = qscale ? qw[tid] * qscale[b] : qw[tid];
    s_zpos[zigzag[tid]] = swizzle_slot(tid);
  }

  // pass 1: quantized DC of every block, from the pixel sum
  for (int n = tid; n < nb; n += kThreads) {
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    s_dc[n] = block_dc(p, stride);
  }
  __syncthreads();

  // pass 2, by groups of kThreads blocks: each thread the DCT, quantize
  // and zigzag of one block into the group's swizzled levels; then each
  // warp emits its own 32 blocks cooperatively, two per pass (lanes 0-15
  // and 16-31, blocks of a pass neighbours in stream order).
  const FusedOut out4{out, out + plane, out + 2 * plane, out + 3 * plane, out + 4 * plane};
  const int lane = tid & 31, warp0 = tid - lane;
  int* const lv_sh = &s_lv[0][0];
  int big = 0;  // kRaw: this thread's blocks over the guard
  for (int g = 0; g < nb; g += kThreads) {
    if (g + tid < nb) {
      int stride;
      const uint8_t* p = block_origin(y, cb, cr, b, my, g + tid, H, W, &stride);
      int x[8][8];
      block_aan_dct(p, stride, x);
      if constexpr (kStore == Store::kRaw) {
        int fmax = 0;
#pragma unroll
        for (int v = 0; v < 8; ++v)
#pragma unroll
          for (int u = 0; u < 8; ++u) fmax = max(fmax, abs(x[v][u]));
        big += fmax >= kFMax;
      }
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
      const int j = lane & 15;
      int lv[4];
      SwizzledLevels{lv_sh + t * 64, t}(j, lv);
      uint32_t code0 = 0;
      int len0 = 0;
      if (j == 0) {
        // previous same-component DC in stream order, 128 at slice start
        const int comp = n - 6 * (n / 6);
        const int back = comp == 0 ? 3 : (comp >= 4 ? 6 : 1);
        code0 = emit_dc(s_dc[n], n >= back ? s_dc[n - back] : 128, comp, s_dcc, len0);
      }
      if constexpr (kStore == Store::kFused4) {
        emit_fused4_lane(lv, lane, code0, len0, s_ac, out4,
                         (size_t)row * kf + (size_t)n * kSlots + j);
      } else if constexpr (kStore == Store::kFused8) {
        emit_fused8_lane(lv, lane, code0, len0, s_ac, out, plane,
                         (size_t)row * kf + (size_t)n * kSlots + (j >> 1));
      } else {
        // the four slots, each as one word, where their levels were
        int run = half_warp_run(lv, lane);
        uint32_t c[4];
        int l[4];
        emit_four_slots(LaneLevels{lv}, j, code0, len0, s_ac, run, c, l);
        int* const blk = lv_sh + t * 64;
#pragma unroll
        for (int i = 0; i < 4; ++i) blk[swizzled_word(t, j, i)] = (int)slot_word(c[i], l[i]);
      }
    }
    if constexpr (kStore == Store::kRaw) {
      // slot-major: lane t stores slot k of the warp's block t, which is
      // its own block of the DCT phase (level k at word swizzle_slot(k) ^ t)
      __syncwarp();
      const int n = g + tid;
      if (n < nb) {
        const int* const blk = lv_sh + tid * 64;
        int32_t* const codes = out + (size_t)row * kf + n;
        int32_t* const lens = codes + plane;
#pragma unroll 8
        for (int k = 0; k < 64; ++k) {
          const uint32_t w = (uint32_t)blk[swizzle_slot(k) ^ lane];
          const int len = slot_word_len(w);
          codes[(size_t)k * nb] = (int32_t)(w ^ (1u << len));
          lens[(size_t)k * nb] = len;
        }
      }
    }
    __syncwarp();
  }
  if constexpr (kStore == Store::kRaw) {
    const int warp_big = __reduce_add_sync(0xFFFFFFFFu, big);
    if (lane == 0 && warp_big) atomicAdd(&dct_viol[row], warp_big);
  }
}

template <Store kStore>
int launch(const void* y, const void* cb, const void* cr, int batch, int H, int W,
           const void* qw, const void* qscale, const void* zigzag, const void* ac_code,
           const void* ac_len,
           const void* dc_code, const void* dc_len, void* out, void* dct_viol, int device,
           void* stream) {
  if (H % 16 || W % 16 || (W / 16) * 6 > kMaxNB || batch < 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  const int mbh = H / 16;
  const int rows = batch * mbh;
  if (rows == 0 || W == 0) return (int)cudaSuccess;
  const size_t plane = (size_t)rows * (W / 16) * 6 * plane_slots(kStore);
  vlc_slots_kernel<kStore><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, mbh, H, W,
      (const int32_t*)qw, (const int32_t*)qscale, (const int32_t*)zigzag,
      (const int32_t*)ac_code, (const int32_t*)ac_len, (const int32_t*)dc_code,
      (const int32_t*)dc_len,
      (int32_t*)out, plane, (int32_t*)dct_viol);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (kFuse + 1, batch * H/16, 6 * W/16 * 64/kFuse) int32, contiguous.
// qscale: null (qw is qscale * W for every picture), or (batch,) int32,
// each picture's quantizer_scale (qw is then the intra matrix W, and
// picture b quantizes with qscale[b] * W).
extern "C" int vlc_fused4_launch(const void* y, const void* cb, const void* cr,
                                 int batch, int H, int W, const void* qw,
                                 const void* qscale, const void* zigzag,
                                 const void* ac_code, const void* ac_len,
                                 const void* dc_code, const void* dc_len, void* out,
                                 int device, void* stream) {
  return launch<Store::kFused4>(y, cb, cr, batch, H, W, qw, qscale, zigzag, ac_code, ac_len,
                                dc_code, dc_len, out, nullptr, device, stream);
}

extern "C" int vlc_fused8_launch(const void* y, const void* cb, const void* cr,
                                 int batch, int H, int W, const void* qw,
                                 const void* qscale, const void* zigzag,
                                 const void* ac_code, const void* ac_len,
                                 const void* dc_code, const void* dc_len, void* out,
                                 int device, void* stream) {
  return launch<Store::kFused8>(y, cb, cr, batch, H, W, qw, qscale, zigzag, ac_code, ac_len,
                                dc_code, dc_len, out, nullptr, device, stream);
}

// out: (2, batch * H/16, 64, 6 * W/16) int32 (codes, lens), contiguous;
// dct_viol: (batch * H/16,) int32, zeroed.
extern "C" int vlc_raw_launch(const void* y, const void* cb, const void* cr, int batch, int H,
                              int W, const void* qw, const void* qscale, const void* zigzag,
                              const void* ac_code, const void* ac_len, const void* dc_code,
                              const void* dc_len, void* out, void* dct_viol, int device,
                              void* stream) {
  return launch<Store::kRaw>(y, cb, cr, batch, H, W, qw, qscale, zigzag, ac_code, ac_len,
                             dc_code, dc_len, out, dct_viol, device, stream);
}

extern "C" const char* vlc_fused4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
