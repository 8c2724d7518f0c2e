// pack_split: raw VLC codes -> big-endian slice bytes, one slice spread over
// many CUDA blocks (kernels K3 and K4).
//
// Both compute `bitpack.pack_words` of (n, k) raw codes of <= 32 bits: code
// i of a row lands MSB first at bit offset ends[i] - lens[i], where ends is
// the inclusive prefix sum of the lengths plus the row's bit offset, taken
// in PyTorch before the launch (the reference takes its cumsum in XLA
// outside its kernels too).  Words past max_words are dropped; the caller
// reads the true bit count from ends.  The output words hold the stream's
// bytes (the first byte of word w is its most significant one).
//
// K3 (pack_windows_launch) replaces ec504_imageencoder_tpu/ops/pallas_pack.py
// `_pack3_kernel` and its level-2 placement (`pack_words_pallas3`, the
// reference's EC504_PACK=pallas3).  Two levels and no global atomics.
// Level 1, one block per (row, chunk of kChunk codes): the chunk's codes
// land in a private shared-memory window that starts at the 128-word tile
// of its first code (kChunk codes of <= 32 bits touch at most kChunk + 1
// words, so kChunk + 128 words hold them from any start in the tile), and
// the window goes to a scratch buffer with its tile index.  Level 2, one
// block per (row, output tile of 128 words): each word is the OR of that
// word of every window that covers the tile, a gather, as the TPU's
// level-2 contraction is.  Offsets are monotone, so the windows that cover
// a tile are a contiguous range of chunks, found by a binary search over
// the tiles.
//
// K4 (pack_split_launch) replaces `_fused_kernel` (`pack_words_fused`,
// EC504_PACK=fused), whose output block stays resident across the grid
// steps of a slice.  Here one block per (row, superchunk of kSuper codes)
// atomicOrs each code's one or two words straight into the output row,
// which a memset on the same stream zeroed first.  OR commutes with a byte
// permutation, so each word is byte-swapped into stream order as it is
// placed and no final pass is needed.  A block whose first code starts
// past the buffer returns at once.
//
// What bounds them on the H100: bytes.  12 B per code read (code, length,
// end) and the slice buffer written once; K3 also writes and gathers its
// windows (4 (kChunk + 128) B per chunk).  The arithmetic is a few shifts
// per code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;            // K3: codes per level-1 block
constexpr int kWindow = kChunk + 128;   // K3: words per window
constexpr int kSpan = kWindow / 128;    // K3: output tiles a window covers
constexpr int kSuper = 4096;            // K4: codes per block

// The code of length len (1..32) at bit offset off shifted to the top of
// the 64-bit window [w0, w1] that starts at word off >> 5: a left shift by
// 64 - (off & 31) - len, which lies in [1, 63].
__device__ __forceinline__ void place_words(uint32_t code, int len, int off, uint32_t& w0,
                                            uint32_t& w1) {
  const int sh = 64 - (off & 31) - len;
  if (sh >= 32) {
    w0 = code << (sh - 32);
    w1 = 0u;
  } else {
    w0 = code >> (32 - sh);
    w1 = code << sh;
  }
}

__global__ void __launch_bounds__(kThreads)
pack_windows_kernel(const int32_t* __restrict__ codes, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ ends, int k, int nch,
                    uint32_t* __restrict__ windows, int32_t* __restrict__ tiles) {
  __shared__ uint32_t s_win[kWindow];
  const int tid = threadIdx.x;
  const int row = blockIdx.x / nch, c = blockIdx.x % nch;
  const size_t base = (size_t)row * k;
  const int i0 = c * kChunk;
  const int tile = ((ends[base + i0] - lens[base + i0]) >> 5) >> 7;
  for (int t = tid; t < kWindow; t += kThreads) s_win[t] = 0u;
  if (tid == 0) tiles[(size_t)row * nch + c] = tile;
  __syncthreads();

  for (int q = 0; q < kChunk / kThreads; ++q) {
    const int i = i0 + q * kThreads + tid;
    if (i >= k) break;
    const int len = lens[base + i];
    if (len <= 0 || len > 32) continue;
    const int off = ends[base + i] - len;
    uint32_t w0, w1;
    place_words((uint32_t)codes[base + i], len, off, w0, w1);
    const int lw = (off >> 5) - (tile << 7);
    // unsigned compares: only lengths that break the monotone offsets
    // (negative ones) could leave the window
    if (w0 && (unsigned)lw < (unsigned)kWindow) atomicOr(&s_win[lw], w0);
    if (w1 && (unsigned)(lw + 1) < (unsigned)kWindow) atomicOr(&s_win[lw + 1], w1);
  }
  __syncthreads();
  uint32_t* out = windows + ((size_t)row * nch + c) * kWindow;
  for (int t = tid; t < kWindow; t += kThreads) out[t] = s_win[t];
}

__global__ void __launch_bounds__(128)
place_windows_kernel(const uint32_t* __restrict__ windows, const int32_t* __restrict__ tiles,
                     int nch, int ntiles, int max_words, uint32_t* __restrict__ seg) {
  const int row = blockIdx.x / ntiles, t = blockIdx.x % ntiles;
  const int32_t* tl = tiles + (size_t)row * nch;
  // the first chunk whose window reaches tile t: tile > t - kSpan
  int lo = 0, hi = nch;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tl[mid] <= t - kSpan) lo = mid + 1;
    else hi = mid;
  }
  const int j = threadIdx.x;
  uint32_t acc = 0u;
  for (int c = lo; c < nch; ++c) {
    const int a = t - tl[c];
    if (a < 0) break;  // this chunk and every later one start past tile t
    if (a < kSpan) acc |= windows[((size_t)row * nch + c) * kWindow + a * 128 + j];
  }
  const int w = t * 128 + j;
  if (w < max_words) seg[(size_t)row * max_words + w] = __byte_perm(acc, 0u, 0x0123);
}

__global__ void __launch_bounds__(kThreads)
pack_split_kernel(const int32_t* __restrict__ codes, const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ ends, int k, int nsc, int max_words,
                  uint32_t* __restrict__ seg) {
  const int tid = threadIdx.x;
  const int row = blockIdx.x / nsc, sc = blockIdx.x % nsc;
  const size_t base = (size_t)row * k;
  const int i0 = sc * kSuper;
  if ((ends[base + i0] - lens[base + i0]) >> 5 >= max_words) return;  // all past the buffer
  uint32_t* out = seg + (size_t)row * max_words;
  for (int q = 0; q < kSuper / kThreads; ++q) {
    const int i = i0 + q * kThreads + tid;
    if (i >= k) break;
    const int len = lens[base + i];
    if (len <= 0 || len > 32) continue;
    const int off = ends[base + i] - len;
    uint32_t w0, w1;
    place_words((uint32_t)codes[base + i], len, off, w0, w1);
    const int word = off >> 5;
    if (w0 && (unsigned)word < (unsigned)max_words)
      atomicOr(&out[word], __byte_perm(w0, 0u, 0x0123));
    if (w1 && (unsigned)(word + 1) < (unsigned)max_words)
      atomicOr(&out[word + 1], __byte_perm(w1, 0u, 0x0123));
  }
}

int blocks(int n, int per_row, int* out) {
  const long long b = (long long)n * per_row;
  if (b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *out = (int)b;
  return (int)cudaSuccess;
}

}  // namespace

// The scratch K3 needs: (n, nch) windows of `window` words and (n, nch)
// int32 tiles, nch = ceil(k / chunk).
extern "C" int pack_windows_scratch(int* chunk, int* window) {
  *chunk = kChunk;
  *window = kWindow;
  return (int)cudaSuccess;
}

// K3: codes, lens, ends (n, k) int32; windows (n, nch, kWindow) u32 and
// tiles (n, nch) int32 scratch; seg (n, max_words) u32.
extern "C" int pack_windows_launch(const void* codes, const void* lens, const void* ends, int n,
                                   int k, int max_words, void* windows, void* tiles, void* seg,
                                   int device, void* stream) {
  if (n < 0 || k < 0 || max_words <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (k + kChunk - 1) / kChunk;
  const int ntiles = (max_words + 127) / 128;
  int b1 = 0, b2 = 0;
  if (blocks(n, nch, &b1) || blocks(n, ntiles, &b2)) return (int)cudaErrorInvalidValue;
  if (b1 > 0) {
    pack_windows_kernel<<<b1, kThreads, 0, s>>>((const int32_t*)codes, (const int32_t*)lens,
                                                (const int32_t*)ends, k, nch,
                                                (uint32_t*)windows, (int32_t*)tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  place_windows_kernel<<<b2, 128, 0, s>>>((const uint32_t*)windows, (const int32_t*)tiles, nch,
                                          ntiles, max_words, (uint32_t*)seg);
  return (int)cudaGetLastError();
}

// K4: codes, lens, ends (n, k) int32; seg (n, max_words) u32, zeroed here.
extern "C" int pack_split_launch(const void* codes, const void* lens, const void* ends, int n,
                                 int k, int max_words, void* seg, int device, void* stream) {
  if (n < 0 || k < 0 || max_words <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(seg, 0, (size_t)n * max_words * 4, s);
  if (err != cudaSuccess) return (int)err;
  const int nsc = (k + kSuper - 1) / kSuper;
  int b = 0;
  if (blocks(n, nsc, &b)) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  pack_split_kernel<<<b, kThreads, 0, s>>>((const int32_t*)codes, (const int32_t*)lens,
                                           (const int32_t*)ends, k, nsc, max_words,
                                           (uint32_t*)seg);
  return (int)cudaGetLastError();
}

extern "C" const char* pack_split_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
