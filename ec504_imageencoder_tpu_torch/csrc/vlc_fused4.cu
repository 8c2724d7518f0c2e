// vlc_fused4: 4:2:0 planes -> 4:1-fused VLC slots of every 8x8 block.
//
// Replaces the Pallas kernel ec504_imageencoder_tpu/ops/pallas_vlc.py
// `_vlc_blocks_fused_kernel` (launched by `vlc_fused_slots_from_blocks_tpu`)
// and the XLA blockize in front of it and the `fused_stack_to_stream`
// transpose behind it.  Per 8x8 block it computes the reference's integer
// AAN DCT, ISO intra quantization, zigzag, differential DC, 64-slot VLC
// emission (MB header folded into the DC slot, EOB into slot 63) and the
// exact 4:1 slot fusion, and writes the fused slots in stream order.
//
// What bounds it on the H100: not bytes.  It reads 1.5 B of pixels per
// sample and writes 5 x 16 x 4 = 320 B of fused slots per 8x8 block
// (about 5 B per sample); the per-block work is a 64-step sequential
// emission with table lookups and ~1.3k integer ops of DCT, i.e. integer
// issue rate and latency.
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
// PR can stage them through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxNB = 6 * 256;   // width 4096
constexpr int kAcRuns = 32;       // run 0..31
constexpr int kAcLevels = 41;     // |level| 0..40
constexpr int kDcSizes = 9;

// AAN constants (reference ops/dct.py)
constexpr int C1 = 1004, S1 = 200, C3 = 851, S3 = 569;
constexpr int R2C6 = 554, R2S6 = 1337, R2 = 181;

// Stages 1-3 of the 8-point AAN transform (ops/dct.py::_aan_butterfly):
// n = (e0, e4, e2, e6, o1, o5, o7, o3).  Plain int arithmetic: products
// wrap as in int32 and >> of a negative int is arithmetic on nvcc.
__device__ __forceinline__ void aan_butterfly(const int a[8], int n[8]) {
  int s8 = a[7] + a[0], d0 = a[0] - a[7];
  int s7 = a[1] + a[6], d1 = a[1] - a[6];
  int s6 = a[2] + a[5], d2 = a[2] - a[5];
  int s5 = a[3] + a[4], d3 = a[3] - a[4];
  int ex4 = s8 + s5, ex8 = s8 - s5, ex5 = s7 + s6, ex7 = s7 - s6;
  int t6 = C1 * (d1 + d2);
  int ox2 = (-S1 - C1) * d2 + t6;
  int ox1 = (S1 - C1) * d1 + t6;
  int t6b = C3 * (d0 + d3);
  int ox3 = (-S3 - C3) * d3 + t6b;
  int ox0 = (S3 - C3) * d0 + t6b;
  int t5 = R2C6 * (ex7 + ex8);
  n[0] = ex4 + ex5;
  n[1] = ex4 - ex5;
  n[2] = (R2S6 - R2C6) * ex8 + t5;
  n[3] = (-R2S6 - R2C6) * ex7 + t5;
  n[4] = ox3 + ox1;
  n[5] = ox0 + ox2;
  n[6] = ox3 - ox1;
  n[7] = ox0 - ox2;
}

// In place: x[y][x] pixels -> x[v][u] coefficients (ops/dct.py::aan_dct).
__device__ __forceinline__ void aan_dct(int x[8][8]) {
  int a[8], n[8];
#pragma unroll
  for (int y = 0; y < 8; ++y) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = x[y][k];
    aan_butterfly(a, n);
    x[y][0] = n[0];
    x[y][4] = n[1];
    x[y][2] = n[2] >> 10;
    x[y][6] = n[3] >> 10;
    x[y][7] = (n[4] - n[5]) >> 10;
    x[y][1] = (n[4] + n[5]) >> 10;
    x[y][3] = (n[6] * R2) >> 17;
    x[y][5] = (n[7] * R2) >> 17;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = x[k][u];
    aan_butterfly(a, n);
    x[0][u] = (n[0] + 16) >> 3;
    x[4][u] = (n[1] + 16) >> 3;
    x[2][u] = (n[2] + 16384) >> 13;
    x[6][u] = (n[3] + 16384) >> 13;
    x[7][u] = (n[4] - n[5] + 16384) >> 13;
    x[1][u] = (n[4] + n[5] + 16384) >> 13;
    x[3][u] = ((n[6] >> 8) * R2 + 8192) >> 12;
    x[5][u] = ((n[7] >> 8) * R2 + 8192) >> 12;
  }
}

// One AC slot (ops/vlc_device.py::ac_codes_correct): `run` is the count of
// zero levels since the previous nonzero one (the DC counts as nonzero).
// Returns the code; its length goes to `len` (0: nothing emitted).
__device__ __forceinline__ uint32_t emit_ac(int lvl, int& run, const uint32_t* s_ac,
                                            int& len) {
  if (lvl == 0) {
    ++run;
    len = 0;
    return 0u;
  }
  const int al = abs(lvl);
  const uint32_t s = lvl < 0;
  const int r = run;
  run = 0;
  if (r == 0 && al == 1) {
    len = 3;
    return 6u | s;
  }
  const uint32_t t = (r < kAcRuns && al < kAcLevels) ? s_ac[r * kAcLevels + al] : 0u;
  if ((t >> 16) > 0) {
    len = (int)(t >> 16) + 1;
    return ((t & 0xFFFFu) << 1) | s;
  }
  // escape: 6-bit escape, 6-bit TRUE run (up to 62), 8- or 16-bit level
  const uint32_t base = 64u | (uint32_t)r;
  const uint32_t lo = s ? (uint32_t)(256 - al) & 0xFFu : (uint32_t)al & 0xFFu;
  if (al >= 128) {
    len = 28;
    return (base << 16) | ((s ? 0x80u : 0u) << 8) | lo;
  }
  len = 20;
  return (base << 8) | lo;
}

__device__ __forceinline__ const uint8_t* block_origin(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int b, int my,
    int n, int H, int W, int* stride) {
  const int mb = n / 6, comp = n - 6 * (n / 6);
  if (comp < 4) {  // luma order in a macroblock: TL, TR, BL, BR
    *stride = W;
    return y + ((size_t)b * H + my * 16 + (comp >> 1) * 8) * W + mb * 16 + (comp & 1) * 8;
  }
  const int h2 = H / 2, w2 = W / 2;
  *stride = w2;
  return (comp == 4 ? cb : cr) + ((size_t)b * h2 + my * 8) * w2 + mb * 8;
}

__global__ void __launch_bounds__(kThreads)
vlc_fused4_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                  const uint8_t* __restrict__ cr, int mbh, int H, int W,
                  const int32_t* __restrict__ qw, const int32_t* __restrict__ zigzag,
                  const int32_t* __restrict__ ac_code, const int32_t* __restrict__ ac_len,
                  const int32_t* __restrict__ dc_code, const int32_t* __restrict__ dc_len,
                  int32_t* __restrict__ out_v0, int32_t* __restrict__ out_v1,
                  int32_t* __restrict__ out_v2, int32_t* __restrict__ out_v3,
                  int32_t* __restrict__ out_len) {
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
  const size_t kf = (size_t)nb * 16;

  for (int i = tid; i < kAcRuns * kAcLevels; i += kThreads)
    s_ac[i] = (uint32_t)ac_code[i] | ((uint32_t)ac_len[i] << 16);
  if (tid < 2 * kDcSizes) s_dcc[tid] = (uint32_t)dc_code[tid] | ((uint32_t)dc_len[tid] << 16);
  if (tid < 64) {
    s_qw[tid] = qw[tid];
    s_zpos[zigzag[tid]] = tid;
  }

  // pass 1: quantized DC of every block, from the pixel sum
  for (int n = tid; n < nb; n += kThreads) {
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    int sum = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) sum += p[r * stride + c];
    s_dc[n] = min(max((((sum + 16) >> 3) + 4) >> 3, 0), 255);
  }
  __syncthreads();

  // pass 2: DCT, quantize, zigzag, emit, fuse
  for (int n = tid; n < nb; n += kThreads) {
    const int comp = n - 6 * (n / 6);
    int stride;
    const uint8_t* p = block_origin(y, cb, cr, b, my, n, H, W, &stride);
    int x[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) x[r][c] = p[r * stride + c];
    aan_dct(x);

    const int dc = min(max((x[0][0] + 4) >> 3, 0), 255);
#pragma unroll
    for (int v = 0; v < 8; ++v)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int f = x[v][u];
        const int q = s_qw[v * 8 + u];
        const int mag = min((16 * abs(f) + q) / (2 * q), 255);
        s_lv[s_zpos[v * 8 + u]][tid] = f > 0 ? mag : (f < 0 ? -mag : 0);
      }

    // previous same-component DC in stream order, 128 at slice start
    const int back = comp == 0 ? 3 : (comp >= 4 ? 6 : 1);
    const int pred = n >= back ? s_dc[n - back] : 128;
    const int diff = dc - pred;
    const int sz = 32 - __clz(abs(diff));
    const uint32_t dbits = (uint32_t)(diff >= 0 ? diff : diff + (1 << sz) - 1) & ((1u << sz) - 1u);
    const uint32_t sc = s_dcc[(comp < 4 ? kDcSizes : 0) + sz];
    uint32_t code = sz > 0 ? ((sc & 0xFFFFu) << sz) | dbits : (sc & 0xFFFFu);
    int len = (int)(sc >> 16) + sz;
    if (comp == 0) {  // macroblock header '11'
      code |= 3u << len;
      len += 2;
    }

    int run = 0;
    const size_t obase = (size_t)row * kf + (size_t)n * 16;
    for (int j = 0; j < 16; ++j) {
      uint32_t c[4];
      int l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * j + i;
        if (k == 0) {
          c[i] = code;
          l[i] = len;
          continue;
        }
        c[i] = emit_ac(s_lv[k][tid], run, s_ac, l[i]);
        if (k == 63) {  // end of block '10'
          c[i] = (c[i] << 2) | 2u;
          l[i] += 2;
        }
      }
      // exact 4:1 fusion: the four codes concatenated, <= 120 bits
      const uint64_t a = ((uint64_t)c[0] << l[1]) | c[1];
      const uint64_t bb = ((uint64_t)c[2] << l[3]) | c[3];
      const int lb = l[2] + l[3];  // <= 60
      const uint64_t vlo = (a << lb) | bb;
      const uint64_t vhi = lb > 0 ? a >> (64 - lb) : 0;
      const size_t o = obase + j;
      out_v0[o] = (int32_t)(uint32_t)(vhi >> 32);
      out_v1[o] = (int32_t)(uint32_t)vhi;
      out_v2[o] = (int32_t)(uint32_t)(vlo >> 32);
      out_v3[o] = (int32_t)(uint32_t)vlo;
      out_len[o] = l[0] + l[1] + l[2] + l[3];
    }
  }
}

}  // namespace

extern "C" int vlc_fused4_launch(const void* y, const void* cb, const void* cr,
                                 int batch, int H, int W, const void* qw,
                                 const void* zigzag, const void* ac_code,
                                 const void* ac_len, const void* dc_code,
                                 const void* dc_len, void* v0, void* v1, void* v2,
                                 void* v3, void* flens, int device, void* stream) {
  if (H % 16 || W % 16 || (W / 16) * 6 > kMaxNB || batch < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int mbh = H / 16;
  const int rows = batch * mbh;
  if (rows == 0 || W == 0) return (int)cudaSuccess;
  vlc_fused4_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, mbh, H, W,
      (const int32_t*)qw, (const int32_t*)zigzag, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      (int32_t*)v0, (int32_t*)v1, (int32_t*)v2, (int32_t*)v3, (int32_t*)flens);
  return (int)cudaGetLastError();
}

extern "C" const char* vlc_fused4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
