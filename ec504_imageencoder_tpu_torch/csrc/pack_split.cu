// pack_split: raw VLC codes -> big-endian slice bytes + bit counts, one slice
// spread over many CUDA blocks (kernels K3 and K4).
//
// Both compute `bitpack.pack_words` of (n, k) raw codes of <= 32 bits: code
// i of a row lands MSB first at bit offset bit_offset + sum(lens[0..i)).
// The prefix sum is taken inside the kernels; nothing runs in front of them.
// The scan sums every length, but only codes of length 1..32 are placed.
// Words past max_words are dropped; nbits is the row's true bit count,
// bit_offset included, even when it overflows the buffer.  The output words
// hold the stream's bytes (the first byte of word w is its most significant
// one), so each word is byte-swapped as it is stored.
//
// Both cut a row into tiles of codes, in rounds of one int4 (4 codes) per
// thread: a round of a tile is 1024 consecutive codes, so a warp's 16-byte
// loads cover 512 contiguous bytes.  A tile scans its lengths in registers,
// across the warp with shuffles and across the block through 32 warp totals
// in shared memory; it places its codes into a shared-memory window that
// starts at the word of its first bit (a tile of T codes of <= 32 bits
// touches at most T + 1 words), and stores the words from there.  A row
// whose length count or base is not a multiple of 16 bytes loads scalars.
//
// K4 (pack_split_launch) replaces ec504_imageencoder_tpu/ops/pallas_pack.py
// `_fused_kernel` (`pack_words_fused`, the reference's EC504_PACK=fused),
// many blocks per slice.  Single pass, decoupled look-back: one block per
// tile of 4096 codes; tile ids come from a global counter in the order
// blocks start, so a tile only ever waits for tiles that are already
// running.  A tile publishes its total in a 64-bit status word per (row,
// tile) as soon as it has scanned, then warp 0 reads its predecessors' status
// words 32 at a time and sums back to the nearest one that holds an
// inclusive prefix, and publishes its own.  Every word only the tile touches
// goes out with 16-byte stores; its first and last words, which it may share
// with its neighbours, are ORed into the row, which a memset on the same
// stream zeroed (it also leaves the zero tail).  The row's last tile writes
// nbits.  A tile past the buffer still publishes; only its stores are
// skipped.  The status words and the counter are scratch the caller
// allocates and this launcher zeroes on the stream, so launches never share
// state.
//
// K3 (pack_windows_launch) replaces `_pack3_kernel` and its level-2
// placement (`pack_words_pallas3`, EC504_PACK=pallas3): two levels, no
// global atomics.  Level 1 reads only the lengths and writes each chunk's
// (2048 codes) bit total, (n, nch) int32.  Level 2, one block per (row,
// chunk): warp 0 sums the row's totals before and after the chunk (its
// first bit; whether it holds the row's last bit), the block scans its own
// lengths and places into a window, and every output word is stored exactly
// once by its owner: the chunk that holds the word's last bit.  The owner
// fills the word's leading bits, which earlier chunks hold, by reading the
// codes before its own backwards, a warp of 32 at a time, skipping chunks
// whose total is 0, until the word's first bit (or the row's bit offset) is
// covered.  The chunk that holds the row's last bit (chunk 0 of an empty
// row) also stores the partial last word, the zero tail up to max_words and
// nbits; chunk 0 stores the words before the bit offset.
//
// What bounds them on the H100: bytes.  The function reads 8 B per code
// and writes the slice buffer once.  K4 adds the memset of the buffer and
// its status words (8 B per tile); K3 reads the lengths twice (level 1) and
// its totals.  The arithmetic is a few dozen integer ops per code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 4 * kThreads;  // codes per round: one int4 per thread
constexpr int kSplitRounds = 4;       // K4: 4096 codes per tile
constexpr int kWindowsRounds = 2;     // K3: 2048 codes per chunk
constexpr int kSplitCodes = kSplitRounds * kRound;
constexpr int kChunkCodes = kWindowsRounds * kRound;

// K4 status word: flag << 32 | value; 0 means not yet published
constexpr unsigned long long kAggregate = 1ull;  // value: the tile's total
constexpr unsigned long long kPrefix = 2ull;     // value: the row's bits up to its end

__device__ __forceinline__ uint32_t bswap(uint32_t w) { return __byte_perm(w, 0u, 0x0123); }

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

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

// This thread's codes and lengths of the tile that starts at code i0 of a
// row of k codes (at element base): in round q, codes q kRound + 4 tid .. +3
// of the tile.  Codes past the row read as length 0.  kVec: k % 4 == 0 and
// both arrays 16-byte aligned, so a row's round is whole int4s.
template <int R, bool kVec>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ codes,
                                          const int32_t* __restrict__ lens, size_t base, int i0,
                                          int k, int tid, int (&c)[R][4], int (&l)[R][4]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = i0 + q * kRound + 4 * tid;
    if constexpr (kVec) {
      int4 a = make_int4(0, 0, 0, 0), b = make_int4(0, 0, 0, 0);
      if (i < k) {
        a = __ldg(reinterpret_cast<const int4*>(lens + base + i));
        b = __ldg(reinterpret_cast<const int4*>(codes + base + i));
      }
      l[q][0] = a.x; l[q][1] = a.y; l[q][2] = a.z; l[q][3] = a.w;
      c[q][0] = b.x; c[q][1] = b.y; c[q][2] = b.z; c[q][3] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = i + e < k;
        l[q][e] = in ? __ldg(lens + base + i + e) : 0;
        c[q][e] = in ? __ldg(codes + base + i + e) : 0;
      }
    }
  }
}

// Step 1 of the tile scan, every thread: wexcl[q] = the lengths of round q
// before this thread's 4 within its warp; lane 31 leaves the warp's total
// of round q in s_tot[q kWarps + warp].  The caller synchronises.
template <int R>
__device__ __forceinline__ void scan_rounds(const int (&l)[R][4], int lane, int warp, int* s_tot,
                                            int (&wexcl)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int s = l[q][0] + l[q][1] + l[q][2] + l[q][3];
    const int incl = warp_inclusive_scan(s, lane);
    wexcl[q] = incl - s;
    if (lane == 31) s_tot[q * kWarps + warp] = incl;
  }
}

// Step 2, warp 0 only: turn the R kWarps (<= 32) warp totals, in code order,
// into exclusive prefixes in place; returns the tile's total.
template <int R>
__device__ __forceinline__ int scan_warp_totals(int lane, int* s_tot) {
  static_assert(R * kWarps <= 32, "one warp scans the warp totals");
  const int v = lane < R * kWarps ? s_tot[lane] : 0;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane < R * kWarps) s_tot[lane] = incl - v;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Step 3, every thread after a barrier: OR this thread's codes into the
// window of the words from wbase on, their offsets counted from the tile's
// first bit `start`.  Consecutive codes of a thread mostly share a word,
// so its contributions are merged in a register before each shared atomic.
template <int R, int kWin>
__device__ __forceinline__ void place_tile(const int (&c)[R][4], const int (&l)[R][4],
                                           const int (&wexcl)[R], const int* s_tot, int warp,
                                           int start, int wbase, uint32_t* s_win) {
  int cw = -1;
  uint32_t cv = 0u;
  auto flush = [&]() {
    if (cv && (unsigned)cw < (unsigned)kWin) atomicOr(&s_win[cw], cv);
  };
  auto put = [&](int w, uint32_t v) {
    if (!v) return;
    if (w == cw) {
      cv |= v;
    } else {
      flush();
      cw = w;
      cv = v;
    }
  };
#pragma unroll
  for (int q = 0; q < R; ++q) {
    int off = start + s_tot[q * kWarps + warp] + wexcl[q];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int len = l[q][e];
      if (len >= 1 && len <= 32) {
        uint32_t w0, w1;
        place_words((uint32_t)c[q][e], len, off, w0, w1);
        const int lw = (off >> 5) - wbase;
        put(lw, w0);
        put(lw + 1, w1);
      }
      off += len;
    }
  }
  flush();
}

// Store words [a, b) of the row at seg + row_off, word(w) each (seg is
// 16-byte aligned): a head and a tail of <= 3 scalar stores, 16-byte stores
// between.
template <class F>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ seg, size_t row_off, int a,
                                            int b, int tid, F word) {
  if (a >= b) return;
  const int a4 = min(a + (int)((4 - ((row_off + a) & 3)) & 3), b);
  const int nvec = (b - a4) >> 2;
  const int b4 = a4 + 4 * nvec;
  uint32_t* out = seg + row_off;
  if (tid < a4 - a) out[a + tid] = word(a + tid);
  if (tid < b - b4) out[b4 + tid] = word(b4 + tid);
  for (int v = tid; v < nvec; v += kThreads) {
    const int w = a4 + 4 * v;
    *reinterpret_cast<uint4*>(out + w) = make_uint4(word(w), word(w + 1), word(w + 2), word(w + 3));
  }
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long flag, int value) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(p) = flag << 32 | (uint32_t)value;
}

// K4, warp 0: the row's first bit of tile t (bit_offset included), summed
// back from tile t - 1 to the nearest tile that published an inclusive
// prefix (tile 0 always does), 32 status words at a time.  Every predecessor started before this
// tile and publishes its total without waiting, so the spin ends.
__device__ int look_back(const unsigned long long* st, int t, int lane) {
  int prefix = 0;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long s = kPrefix << 32;  // before the row: nothing
    if (idx >= 0) {
      do {
        s = load_status(st + idx);
      } while ((s >> 32) == 0ull);
    }
    const unsigned pm = __ballot_sync(0xffffffffu, (s >> 32) == kPrefix);
    const int stop = pm ? __ffs(pm) - 1 : 32;  // the nearest inclusive prefix
    prefix += warp_sum(lane <= stop ? (int)(uint32_t)s : 0);
    if (pm) return prefix;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_split_kernel(const int32_t* __restrict__ codes, const int32_t* __restrict__ lens, int k,
                  int ntiles, int max_words, int bit_offset, uint32_t* __restrict__ seg,
                  int32_t* __restrict__ nbits, unsigned long long* __restrict__ status,
                  unsigned int* __restrict__ counter) {
  constexpr int R = kSplitRounds, kWin = kSplitCodes + 1;
  __shared__ uint32_t s_win[kWin];
  __shared__ int s_tot[R * kWarps];
  __shared__ int s_id, s_start, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_id = (int)atomicAdd(counter, 1u);
  for (int w = tid; w < kWin; w += kThreads) s_win[w] = 0u;
  __syncthreads();
  const int id = s_id, row = id / ntiles, t = id - row * ntiles;
  int c[R][4], l[R][4], wexcl[R];
  load_tile<R, kVec>(codes, lens, (size_t)row * k, t * kSplitCodes, k, tid, c, l);
  scan_rounds<R>(l, lane, warp, s_tot, wexcl);
  __syncthreads();

  if (warp == 0) {
    const int total = scan_warp_totals<R>(lane, s_tot);
    unsigned long long* st = status + (size_t)row * ntiles;
    // the prefixes count from bit 0 of the row: tile 0's holds bit_offset
    int start = bit_offset;
    if (t == 0) {
      if (lane == 0) publish(st, kPrefix, start + total);
    } else {
      if (lane == 0) publish(st + t, kAggregate, total);
      start = look_back(st, t, lane);
      if (lane == 0) publish(st + t, kPrefix, start + total);
    }
    if (lane == 0) {
      s_start = start;
      s_total = total;
      if (t == ntiles - 1) nbits[row] = start + total;
    }
  }
  __syncthreads();

  const int start = s_start, end = start + s_total;
  const int wbase = start >> 5;
  place_tile<R, kWin>(c, l, wexcl, s_tot, warp, start, wbase, s_win);
  __syncthreads();
  if (end <= start) return;  // no bits
  // words [wbase, wl] hold the tile's bits; the inner ones are its alone
  const int wl = min((end - 1) >> 5, wbase + kWin - 1);
  const size_t row_off = (size_t)row * max_words;
  if (tid == 0 && wbase >= 0 && wbase < max_words)
    atomicOr(&seg[row_off + wbase], bswap(s_win[0]));
  if (tid == 32 && wl > wbase && wl >= 0 && wl < max_words)
    atomicOr(&seg[row_off + wl], bswap(s_win[wl - wbase]));
  store_words(seg, row_off, max(wbase + 1, 0), min(wl, max_words), tid,
              [&](int w) { return bswap(s_win[w - wbase]); });
}

// K3 level 1: one warp per chunk; totals[row nch + c] = the chunk's bits.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
chunk_totals_kernel(const int32_t* __restrict__ lens, int n, int k, int nch,
                    int32_t* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= (long long)n * nch) return;  // whole warps
  const int row = (int)(g / nch), c = (int)(g - (long long)row * nch);
  const int32_t* lr = lens + (size_t)row * k;
  const int i0 = c * kChunkCodes, i1 = min(i0 + kChunkCodes, k);
  int s = 0;
  if constexpr (kVec) {
    for (int i = i0 + 4 * lane; i < i1; i += 128) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(lr + i));
      s += v.x + v.y + v.z + v.w;
    }
  } else {
    for (int i = i0 + lane; i < i1; i += 32) s += __ldg(lr + i);
  }
  s = warp_sum(s);
  if (lane == 0) totals[g] = s;
}

// K3, warp 0: the bits that codes before code i0 of the row place into word
// start >> 5 at and after bit lo (lo >= the word's first bit; start is the
// chunk's first bit), read backwards 32 codes at a time from code i0 - 1;
// a chunk whose total is 0 is skipped whole.
__device__ uint32_t back_bits(const int32_t* __restrict__ codes, const int32_t* __restrict__ lens,
                              const int32_t* __restrict__ row_totals, size_t base, int i0,
                              int start, int lo, int lane) {
  const int need = start - lo, wf = start >> 5;
  uint32_t acc = 0u;
  int done = 0;  // bits of the codes read so far
  for (int j = i0 - 1; done < need && j >= 0; j -= 32) {
    while (j >= 0 && __ldg(row_totals + j / kChunkCodes) == 0) j = j / kChunkCodes * kChunkCodes - 1;
    if (j < 0) break;
    const int i = j - lane;  // lane 0 holds the code nearest the chunk
    const int len = i >= 0 ? __ldg(lens + base + i) : 0;
    const int incl = warp_inclusive_scan(len, lane);
    if (len >= 1 && len <= 32) {
      const int off = start - done - incl;
      uint32_t w0, w1;
      place_words((uint32_t)__ldg(codes + base + i), len, off, w0, w1);
      if ((off >> 5) == wf) acc |= w0;
      else if ((off >> 5) + 1 == wf) acc |= w1;
    }
    done += __shfl_sync(0xffffffffu, incl, 31);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc |= __shfl_xor_sync(0xffffffffu, acc, d);
  return acc;
}

// K3 level 2: one block per (row, chunk).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_windows_kernel(const int32_t* __restrict__ codes, const int32_t* __restrict__ lens, int k,
                    int nch, int max_words, int bit_offset, const int32_t* __restrict__ totals,
                    uint32_t* __restrict__ seg, int32_t* __restrict__ nbits) {
  constexpr int R = kWindowsRounds, kWin = kChunkCodes + 1;
  __shared__ uint32_t s_win[kWin];
  __shared__ int s_tot[R * kWarps];
  __shared__ int s_start, s_total, s_tail;
  __shared__ uint32_t s_back;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / nch, ch = blockIdx.x - row * nch;
  const size_t base = (size_t)row * k;

  for (int w = tid; w < kWin; w += kThreads) s_win[w] = 0u;
  int c[R][4], l[R][4], wexcl[R];
  load_tile<R, kVec>(codes, lens, base, ch * kChunkCodes, k, tid, c, l);
  scan_rounds<R>(l, lane, warp, s_tot, wexcl);
  __syncthreads();

  if (warp == 0) {
    const int total = scan_warp_totals<R>(lane, s_tot);
    const int32_t* rt = totals + (size_t)row * nch;
    int before = 0, after = 0;
    for (int j = lane; j < nch; j += 32) {
      const int v = __ldg(rt + j);
      if (j < ch) before += v;
      else if (j > ch) after += v;
    }
    before = warp_sum(before);
    after = warp_sum(after);
    const int start = bit_offset + before;
    // the row's last bit is here (chunk 0 of an empty row)
    const bool tail = after == 0 && (total != 0 || ch == 0);
    const uint32_t back = back_bits(codes, lens, rt, base, ch * kChunkCodes, start,
                                    max(start & ~31, bit_offset), lane);
    if (lane == 0) {
      s_start = start;
      s_total = total;
      s_tail = tail;
      s_back = back;
      if (tail) nbits[row] = start + total;
    }
  }
  __syncthreads();

  const int start = s_start, end = start + s_total;
  const int wbase = start >> 5;
  place_tile<R, kWin>(c, l, wexcl, s_tot, warp, start, wbase, s_win);
  __syncthreads();
  // this chunk's words: those whose last bit it holds; chunk 0 also those
  // before the bit offset, the row's last chunk with bits the rest
  const uint32_t back = s_back;
  const int a = ch == 0 ? 0 : wbase;
  const int b = min(s_tail ? max_words : end >> 5, max_words);
  store_words(seg, (size_t)row * max_words, max(a, 0), b, tid, [&](int w) {
    const int lw = w - wbase;
    const uint32_t v = (unsigned)lw < (unsigned)kWin ? s_win[lw] : 0u;
    return bswap(lw == 0 ? v | back : v);
  });
}

int blocks(long long n, long long per_row, long long div, int* out) {
  const long long b = (n * per_row + div - 1) / div;
  if (b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *out = (int)b;
  return (int)cudaSuccess;
}

// Tiles (or chunks) of `size` codes in a row of k codes: at least one, so
// that an empty row still writes its bit count and its zeros.
int tiles(int k, int size) { return k > size ? (k + size - 1) / size : 1; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// The scratch each kernel needs for (n, k) codes, in bytes: K3's chunk
// totals, K4's status words and its tile counter.
extern "C" int pack_split_scratch(int n, int k, long long* windows_bytes, long long* split_bytes) {
  if (n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  *windows_bytes = 4LL * n * tiles(k, kChunkCodes);
  *split_bytes = 8LL * n * tiles(k, kSplitCodes) + 8;
  return (int)cudaSuccess;
}

// K3: codes, lens (n, k) int32; scratch of pack_split_scratch's
// windows_bytes; seg (n, max_words) u32 and nbits (n,) int32, written here.
extern "C" int pack_windows_launch(const void* codes, const void* lens, int n, int k,
                                   int max_words, int bit_offset, void* scratch, void* seg,
                                   void* nbits, int device, void* stream) {
  if (n < 0 || k < 0 || max_words <= 0 || bit_offset < 0 || !aligned16(seg))
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = tiles(k, kChunkCodes);
  int b1 = 0, b2 = 0;
  if (blocks(n, nch, kWarps, &b1) || blocks(n, nch, 1, &b2)) return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && aligned16(codes) && aligned16(lens);
  int32_t* totals = (int32_t*)scratch;
  if (vec) chunk_totals_kernel<true><<<b1, kThreads, 0, s>>>((const int32_t*)lens, n, k, nch, totals);
  else chunk_totals_kernel<false><<<b1, kThreads, 0, s>>>((const int32_t*)lens, n, k, nch, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec)
    pack_windows_kernel<true><<<b2, kThreads, 0, s>>>((const int32_t*)codes, (const int32_t*)lens,
                                                      k, nch, max_words, bit_offset, totals,
                                                      (uint32_t*)seg, (int32_t*)nbits);
  else
    pack_windows_kernel<false><<<b2, kThreads, 0, s>>>((const int32_t*)codes, (const int32_t*)lens,
                                                       k, nch, max_words, bit_offset, totals,
                                                       (uint32_t*)seg, (int32_t*)nbits);
  return (int)cudaGetLastError();
}

// K4: the same arguments, scratch of pack_split_scratch's split_bytes.
extern "C" int pack_split_launch(const void* codes, const void* lens, int n, int k, int max_words,
                                 int bit_offset, void* scratch, void* seg, void* nbits,
                                 int device, void* stream) {
  if (n < 0 || k < 0 || max_words <= 0 || bit_offset < 0 || !aligned16(seg) || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = tiles(k, kSplitCodes);
  int b = 0;
  if (blocks(n, ntiles, 1, &b)) return (int)cudaErrorInvalidValue;
  const size_t nstatus = (size_t)n * ntiles;
  err = cudaMemsetAsync(seg, 0, (size_t)n * max_words * 4, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(scratch, 0, nstatus * 8 + 8, s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status = (unsigned long long*)scratch;
  unsigned int* counter = (unsigned int*)(status + nstatus);
  if (k % 4 == 0 && aligned16(codes) && aligned16(lens))
    pack_split_kernel<true><<<b, kThreads, 0, s>>>((const int32_t*)codes, (const int32_t*)lens, k,
                                                   ntiles, max_words, bit_offset, (uint32_t*)seg,
                                                   (int32_t*)nbits, status, counter);
  else
    pack_split_kernel<false><<<b, kThreads, 0, s>>>((const int32_t*)codes, (const int32_t*)lens,
                                                    k, ntiles, max_words, bit_offset,
                                                    (uint32_t*)seg, (int32_t*)nbits, status,
                                                    counter);
  return (int)cudaGetLastError();
}

extern "C" const char* pack_split_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
