// Device code shared by the kernels that read padded 4:2:0 planes directly
// (vlc_fused4.cu, B1; vlc_raw.cu, B6a): where an 8x8 block of a slice row
// starts, its quantized DC from the pixel sum, the integer AAN DCT of its
// pixels and the ISO intra quantization + zigzag into a per-thread column
// of shared memory.
//
// Every function mirrors the PyTorch twins (ops/cuda_vlc.py::blockize,
// ops/dct.py::aan_dct, ops/quant.py::quantize_intra, ops/zigzag.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vlc_emit.cuh"

namespace vlc {

// Top-left pixel and row stride of block n (mb * 6 + comp) of slice row
// `my` of frame b; luma order in a macroblock is TL, TR, BL, BR.
__device__ __forceinline__ const uint8_t* block_origin(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int b, int my,
    int n, int H, int W, int* stride) {
  const int mb = n / 6, comp = n - 6 * (n / 6);
  if (comp < 4) {
    *stride = W;
    return y + ((size_t)b * H + my * 16 + (comp >> 1) * 8) * W + mb * 16 + (comp & 1) * 8;
  }
  const int h2 = H / 2, w2 = W / 2;
  *stride = w2;
  return (comp == 4 ? cb : cr) + ((size_t)b * h2 + my * 8) * w2 + mb * 8;
}

// The quantized DC of a block from its pixel sum: the AAN DC is exactly
// (sum + 16) >> 3, then the DC step 8, rounded, clipped to [0, 255].
__device__ __forceinline__ int block_dc(const uint8_t* p, int stride) {
  int sum = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) sum += p[r * stride + c];
  return min(max((((sum + 16) >> 3) + 4) >> 3, 0), 255);
}

// x[v][u] = the AAN DCT of the block's pixels.
__device__ __forceinline__ void block_aan_dct(const uint8_t* p, int stride, int x[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) x[r][c] = p[r * stride + c];
  aan_dct(x);
}

// ISO intra AC quantization of x, written in zigzag order to a column of
// shared memory: scan position k at col[k * kStride] (slot 0 holds the
// quantized F00, which the emission does not read: the DC slot comes from
// block_dc / emit_dc).
template <int kStride>
__device__ __forceinline__ void quantize_to_column(const int x[8][8], const int* s_qw,
                                                   const int* s_zpos, int* col) {
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = x[v][u];
      const int q = s_qw[v * 8 + u];
      const int mag = min((16 * abs(f) + q) / (2 * q), 255);
      col[s_zpos[v * 8 + u] * kStride] = f > 0 ? mag : (f < 0 ? -mag : 0);
    }
}

// The zigzag levels of a thread's block, in its column of shared memory:
// slot k at col[k * kStride].
template <int kStride>
struct ColumnLevels {
  const int* col;
  __device__ __forceinline__ void operator()(int j, int lv[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[i] = col[(4 * j + i) * kStride];
  }
};

}  // namespace vlc
