// Device code of the kernels that read padded 4:2:0 planes directly
// (vlc_fused4.cu: B1, B6b, B6a): where an 8x8 block of a slice row starts,
// its quantized DC from the pixel sum, the integer AAN DCT of its pixels
// and the ISO intra quantization + zigzag into a swizzled block-major
// layout in shared memory.  B4a and B4b (vlc_compat.cu) scatter their
// compat levels into the same layout and read them back with
// SwizzledLevels.
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

// ISO intra AC quantization of x in zigzag order: store(s_zpos[v * 8 + u],
// level of coefficient (v, u)) for each coefficient, in one fixed order
// (slot 0 is the quantized F00, which the emission does not read: the DC
// slot comes from block_dc / emit_dc).
template <class Store>
__device__ __forceinline__ void quantize_zigzag(const int x[8][8], const int* s_qw,
                                                const int* s_zpos, Store store) {
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = x[v][u];
      const int q = s_qw[v * 8 + u];
      const int mag = min((16 * abs(f) + q) / (2 * q), 255);
      store(s_zpos[v * 8 + u], f > 0 ? mag : (f < 0 ? -mag : 0));
    }
}

// A group's levels for the warp-cooperative emission: block-major, 64
// words per block, XOR-swizzled so that both of its accesses are free of
// bank conflicts.  Level k of the group's block t lies at word
// t * 64 + (swizzle_slot(k) ^ (t & 31)).
//  - The zigzag scatter: the 32 threads of a warp each store the same k of
//    their own block; the banks are swizzle_slot(k) ^ lane, 32 distinct.
//  - The cooperative read: lanes 0-15 read block t (even), lanes 16-31
//    block t + 1, lane j its levels 4j .. 4j+3, one 4-byte load each; for
//    level i the banks are (4 (j & 7) + i) ^ (t & 31) ^ 2 (j >> 3), whose
//    low two bits differ between the four groups of 8 lanes: 32 distinct.
// A 16-byte read per lane would need a lane's four levels in one aligned
// 16-byte chunk; every store of the scatter would then fall on a bank of
// k mod 4, 32 threads on 8 banks (4-way).  Four conflict-free 4-byte loads
// move the warp's 512 B in the same four shared-memory wavefronts.
__device__ __forceinline__ int swizzle_slot(int k) { return k ^ ((k >> 5) << 1); }

// The word of level 4j + i of the group's block t (among its 64 words),
// as the cooperative read finds it.
__device__ __forceinline__ int swizzled_word(int t, int j, int i) {
  return (4 * j + i) ^ (t & 31) ^ ((j >> 3) << 1);
}

// The levels of block t of a group (its 64 words at blk), for the
// cooperative read: lane j gets levels 4j .. 4j+3.
struct SwizzledLevels {
  const int* blk;
  int t;
  __device__ __forceinline__ void operator()(int j, int lv[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[i] = blk[swizzled_word(t, j, i)];
  }
};

}  // namespace vlc
