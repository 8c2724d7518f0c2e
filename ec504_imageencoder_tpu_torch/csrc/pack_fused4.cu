// pack_fused4: 4:1-fused VLC slots -> big-endian slice bytes + bit counts.
//
// Replaces the Pallas kernel ec504_imageencoder_tpu/ops/pallas_pack.py
// `_fused4_kernel` as launched by `pack_words_fused4_core(..., emit_be=True)`,
// and the `words_be_to_bytes` bitcast behind it.  Each fused slot holds a
// right-aligned value of <= 128 bits (four 32-bit words, most significant
// first) and its length.  Slot i of a slice lands MSB first at bit offset
// bit_offset + sum(len[0..i)), spanning at most 5 consecutive 32-bit
// words.  Words past max_words are dropped, but nbits is the true total
// (bit_offset included), so the host can regrow the buffer exactly.
//
// What bounds it on the H100: bytes.  Per slice it reads 20 B per fused
// slot (230 KB at 1080p) and writes the slice buffer once; the scan and the
// placement are a few dozen integer ops per slot.
//
// Design: one CUDA block per slice.  The block walks the slots in chunks of
// its thread count; a warp-shuffle exclusive scan of the lengths, with the
// running total carried across chunks in shared memory, gives each slot its
// bit offset.  Each slot ORs its (up to 5) shifted words into a zeroed
// slice buffer with atomicOr: the contributions are bit-disjoint and OR is
// order-free, so the result is deterministic.  The buffer lives in dynamic
// shared memory when it fits the card's opt-in limit (227 KB on the H100:
// every auto-sized and worst-case 1080p buffer); a larger regrown buffer
// (e.g. 342,528 B at width 4095) is ORed in place in the zeroed output row
// in global memory instead.  A final coalesced pass byte-swaps the words
// into stream byte order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// word j of the value shifted to the top of a 160-bit window by
// sig = 32 q + r bits, over the words u = [0, v0, v1, v2, v3]
__device__ __forceinline__ uint32_t window_word(const uint32_t u[5], int j, int q, int r) {
  const int i = j + q;
  if (i > 4) return 0u;
  uint32_t hi = 0u, lo = 0u;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    if (t == i) hi = u[t];
    if (t == i + 1) lo = u[t];
  }
  return r ? (hi << r) | (lo >> (32 - r)) : hi;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pack_fused4_kernel(const int32_t* __restrict__ v0, const int32_t* __restrict__ v1,
                   const int32_t* __restrict__ v2, const int32_t* __restrict__ v3,
                   const int32_t* __restrict__ flens, int kf, int max_words,
                   int bit_offset, uint32_t* __restrict__ seg_words,
                   int32_t* __restrict__ nbits) {
  extern __shared__ uint32_t s_buf[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_carry;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  uint32_t* out = seg_words + (size_t)row * max_words;
  uint32_t* buf = kShared ? s_buf : out;

  for (int i = tid; i < max_words; i += kThreads) buf[i] = 0u;
  if (tid == 0) s_carry = bit_offset;
  __syncthreads();

  const size_t base = (size_t)row * kf;
  for (int c0 = 0; c0 < kf; c0 += kThreads) {
    const int i = c0 + tid;
    const int len = i < kf ? flens[base + i] : 0;
    const int incl = warp_inclusive_scan(len, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kWarps ? s_warp[lane] : 0;
      const int ws = warp_inclusive_scan(w, lane);
      if (lane < kWarps) s_warp[lane] = ws;
    }
    __syncthreads();
    const int off = s_carry + (warp ? s_warp[warp - 1] : 0) + incl - len;
    const int total = s_warp[kWarps - 1];
    if (len > 0) {
      const uint32_t u[5] = {0u, (uint32_t)v0[base + i], (uint32_t)v1[base + i],
                             (uint32_t)v2[base + i], (uint32_t)v3[base + i]};
      const int word = off >> 5;
      const int sig = 160 - (off & 31) - len;
      const int q = sig >> 5, r = sig & 31;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const uint32_t w = window_word(u, j, q, r);
        if (w && word + j < max_words) atomicOr(&buf[word + j], w);
      }
    }
    __syncthreads();  // everyone has read s_carry and s_warp
    if (tid == 0) s_carry += total;
  }
  __syncthreads();
  if (tid == 0) nbits[row] = s_carry;
  // stream byte order: word w's most significant byte first
  for (int i = tid; i < max_words; i += kThreads) out[i] = __byte_perm(buf[i], 0u, 0x0123);
}

}  // namespace

extern "C" int pack_fused4_launch(const void* v0, const void* v1, const void* v2,
                                  const void* v3, const void* flens, int n, int kf,
                                  int max_words, int bit_offset, void* seg,
                                  void* nbits, int device, void* stream) {
  if (n < 0 || kf < 0 || max_words <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)max_words * 4;
  const size_t static_bytes = (kWarps + 1) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes + static_bytes <= (size_t)optin) {
    err = cudaFuncSetAttribute(pack_fused4_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    pack_fused4_kernel<true><<<n, kThreads, bytes, s>>>(
        (const int32_t*)v0, (const int32_t*)v1, (const int32_t*)v2, (const int32_t*)v3,
        (const int32_t*)flens, kf, max_words, bit_offset, (uint32_t*)seg, (int32_t*)nbits);
  } else {
    pack_fused4_kernel<false><<<n, kThreads, 0, s>>>(
        (const int32_t*)v0, (const int32_t*)v1, (const int32_t*)v2, (const int32_t*)v3,
        (const int32_t*)flens, kf, max_words, bit_offset, (uint32_t*)seg, (int32_t*)nbits);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pack_fused4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
