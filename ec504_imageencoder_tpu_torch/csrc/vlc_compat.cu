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
// 64-step sequential emission: integer issue rate and latency.
//
// Design: one CUDA block per slice row, one thread per 8x8 block (54 of
// 64 threads busy), the pixels read straight from the planes.  As in B1,
// the DCT lives in registers and the zigzag levels in a per-thread column
// of shared memory; the tables are copied to shared memory once per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 64;
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

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
vlc_compat_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                  const uint8_t* __restrict__ cr, int H, int W,
                  const int32_t* __restrict__ scaled_q, const int32_t* __restrict__ zigzag,
                  const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
                  const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
                  int32_t* __restrict__ codes, int32_t* __restrict__ lens, FusedOut out) {
  __shared__ int s_lv[64][kThreads];
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];  // code | len << 16
  __shared__ uint32_t s_dcc[2 * kDcSizes];        // code | len << 16, [luma][size]
  __shared__ int s_q[64];
  __shared__ int s_zpos[64];                      // natural index -> scan position

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int b = row / kSlices, s = row - kSlices * (row / kSlices);

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, tid, kThreads);
  if (tid < 64) {
    s_q[tid] = scaled_q[tid];
    s_zpos[zigzag[tid]] = tid;
  }
  __syncthreads();

  const int n = tid;
  if (n >= kNB) return;
  const int comp = n - 6 * (n / 6);
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
    for (int u = 0; u < 8; ++u)  // C's int division truncates toward zero
      s_lv[s_zpos[v * 8 + u]][tid] = x[v][u] / s_q[v * 8 + u];

  const int dc = s_lv[0][tid];
  int len0;
  const uint32_t code0 = emit_dc_compat(dc, comp, s_dcc, len0);
  int run = dc == 0;  // a zero DC is a zero before slot 1
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
      if (k == 63) {  // end of block '10'
        c[i] = (c[i] << 2) | 2u;
        l[i] += 2;
      }
    }
    if constexpr (kFused) {
      store_fused4(c, l, out, ((size_t)row * kNB + n) * 16 + j);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t o = ((size_t)row * 64 + 4 * j + i) * kNB + n;
        codes[o] = (int32_t)c[i];
        lens[o] = l[i];
      }
    }
  }
}

template <bool kFused>
int launch(const void* y, const void* cb, const void* cr, int batch, int H, int W,
           const void* scaled_q, const void* zigzag, const void* ac_code, const void* ac_len,
           const void* dc_code, const void* dc_len, int32_t* codes, int32_t* lens,
           const FusedOut& out, int device, void* stream) {
  if (batch < 0 || H < kCropH || W < kCropW) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  vlc_compat_kernel<kFused><<<batch * kSlices, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, H, W,
      (const int32_t*)scaled_q, (const int32_t*)zigzag, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len, codes, lens,
      out);
  return (int)cudaGetLastError();
}

}  // namespace

// B4a: codes and lens, each (batch * 6, 64, 54) int32 (slot-major rows).
extern "C" int vlc_compat_slots_launch(const void* y, const void* cb, const void* cr,
                                       int batch, int H, int W, const void* scaled_q,
                                       const void* zigzag, const void* ac_code,
                                       const void* ac_len, const void* dc_code,
                                       const void* dc_len, void* codes, void* lens,
                                       int device, void* stream) {
  return launch<false>(y, cb, cr, batch, H, W, scaled_q, zigzag, ac_code, ac_len, dc_code,
                       dc_len, (int32_t*)codes, (int32_t*)lens,
                       FusedOut{nullptr, nullptr, nullptr, nullptr, nullptr}, device, stream);
}

// B4b: v0..v3 and flens, each (batch * 6, 54 * 16) int32 in stream order.
extern "C" int vlc_compat_fused4_launch(const void* y, const void* cb, const void* cr,
                                        int batch, int H, int W, const void* scaled_q,
                                        const void* zigzag, const void* ac_code,
                                        const void* ac_len, const void* dc_code,
                                        const void* dc_len, void* v0, void* v1, void* v2,
                                        void* v3, void* flens, int device, void* stream) {
  return launch<true>(y, cb, cr, batch, H, W, scaled_q, zigzag, ac_code, ac_len, dc_code,
                      dc_len, nullptr, nullptr,
                      FusedOut{(int32_t*)v0, (int32_t*)v1, (int32_t*)v2, (int32_t*)v3,
                               (int32_t*)flens},
                      device, stream);
}

extern "C" const char* vlc_compat_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
