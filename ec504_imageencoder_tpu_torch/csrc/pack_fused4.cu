// pack_fused4: 4:1-fused VLC slots -> big-endian slice bytes + bit counts
// (kernel B2, and its checked form), the same for 8:1-fused slots (kernel
// B6c), for raw codes (K1) and for raw codes fused 2:1 as they are loaded
// (K2).
//
// B2 replaces the Pallas kernel ec504_imageencoder_tpu/ops/pallas_pack.py
// `_fused4_kernel` as launched by `pack_words_fused4_core(..., emit_be=True)`,
// and the `words_be_to_bytes` bitcast behind it.  Each fused slot holds a
// right-aligned value of <= 128 bits (four 32-bit words, most significant
// first) and its length.  Slot i of a slice lands MSB first at bit offset
// bit_offset + sum(len[0..i)), spanning at most 5 consecutive 32-bit
// words.  Words past max_words are dropped, but nbits is the true total
// (bit_offset included), so the host can regrow the buffer exactly.
//
// B6c (pack_fused8_launch) replaces `_fused8_kernel`
// (`pack_words_fused8_core`, the reference's EC504_FUSE=8 route) and its
// bitcast: slots of <= 256 bits (eight words), each spanning at most 9
// words, placed from a 288-bit window.  It has none of the TPU kernel's
// limits on max_words (a multiple of 128, at least 384): those were its
// tiling.
//
// K1 (pack_raw_launch) replaces two Pallas kernels that compute
// `bitpack.pack_words` of raw codes of <= 32 bits: `_pack_kernel`
// (`pack_words_pallas`, the reference's EC504_PACK=pallas1) and
// `_pack2_kernel` (`pack_words_pallas2`, no caller).  They differ only in
// their MXU formulation: f32 half-words against a one-hot window, or bf16
// byte planes with the carry words added at the same window position and
// shifted afterwards; neither has a meaning on a GPU, where a code is two
// shifted words ORed in place.  K2 (pack_pairs_launch) replaces
// `_fused2w_kernel` (`pack_words_fused2w`, EC504_PACK=fused2w) and the
// `_fuse2_32` in front of it: the raw pair (2i, 2i+1) of a row is fused in
// registers after the load (V = c1 2^l2 | c2, <= 64 bits) and placed from a
// 96-bit window.
//
// What bounds them on the H100: bytes.  Per slice B2 reads 20 B per fused
// slot (230 KB at 1080p), K1 and K2 8 B per raw code (369 KB), and each
// writes the slice buffer once; the scan and the placement are a few dozen
// integer ops per slot.
//
// Common to all: one CUDA block per slice.  A warp-shuffle scan of the
// lengths gives each slot its bit offset.  Each slot ORs its shifted words
// into a zeroed slice buffer with atomicOr: the contributions are
// bit-disjoint and OR is order-free, so the result is deterministic.  The
// buffer lives in dynamic shared memory when it fits the card's opt-in
// limit (227 KB on the H100: every auto-sized and worst-case 1080p buffer);
// a larger regrown buffer (e.g. 342,528 B at width 4095) is ORed in place
// in the zeroed output row in global memory instead.  A final coalesced
// pass byte-swaps the words into stream byte order.
//
// The tile loop: pack_tiles_kernel, one body over a slot source for K1,
// K2, B2 and B2 checked.  A chunk loop that scans a
// chunk's lengths and only then loads its words pays two dependent global
// round trips and three barriers per chunk, and nothing is in flight across
// a barrier: latency, not bytes (K1 took 0.41 ms on it, B2 0.17, K2 0.27,
// against bounds of 0.13, 0.08 and 0.13).  Here each thread holds kV
// consecutive slots of a tile; their lengths and words come in one vector
// load per array (a warp's load is contiguous), and the loads of tile t + 1
// go out before the scan and placement of tile t, so each tile's one
// barrier overlaps loads in flight.  The block scan is a warp shuffle scan
// of each thread's sum plus the warp totals, double-buffered in shared
// memory so that one barrier per tile suffices; every thread carries the
// running bit offset in a register.  A row whose slot count or bases do not
// allow the vector loads loads scalars.  The geometries were chosen by time
// on the card (tools/pack_variants.py; CUDA events at 16 x 1080p q=50,
// NVIDIA H100 80GB HBM3, 700.00 W):
// - K1 (Raw): 128 threads x 4 codes, 40-42 registers, 9 blocks per SM, so a
//   16 x 1080p batch's 1,088 slices run in one wave on 132 SMs: 0.16 ms
//   (bound 0.13).  Other geometries measured within 7% of it (8 or 16 codes
//   per thread, 256 or 512 threads; 16 codes, at 86-94 registers, 3%
//   faster).  Its own copy of the loop, at 40 registers in every form, was
//   no faster than this source's (42 in the shared-memory scalar-load form).
// - K2 (Pairs): K1's geometry, loads and scan (a thread's pair lengths sum
//   to its code lengths); each thread fuses its codes (0, 1) and (2, 3) and
//   places two pairs from a 96-bit window: 0.19 ms.  An odd k's last code
//   pairs with a code past the row, which reads as length 0.
// - B2 (Fused4): 512 threads x 4 fused slots, five 16-byte loads per thread
//   and tile, 60-64 registers, 2 blocks per SM: 0.114 ms (bound 0.083); on
//   one frame's 68 slices, where a slice's latency is the time and a tile of
//   2,048 slots cuts a row to 6 tiles, 0.019 ms on the device against the
//   chunk loop's 0.033.  The other geometries tried read slower at 16 x
//   1080p: 256 x 2 0.118 ms (0.034 on the device at one frame), 128 x 2
//   0.123, 256 x 4 0.125, 128 x 4 0.128, 512 x 2 0.132, 1024 x 4 0.132,
//   64 x 4 0.149.  Whole tiles are loaded: loading the lengths a tile ahead of
//   the words and a group's words only where one of its slots is non-empty
//   (28% of the slots are at q=50) measured no faster.  Slots are placed from
//   a 160-bit window.
//
// B2's checked form (kChecks, a non-null `viol`) replaces the debug outputs
// of `_fused4_kernel` (`pack_words_fused4_core(..., debug=True)`): per slice
// it counts fused lengths outside [0, 128] and placements whose bits overlap
// bits already placed.  The TPU finds an overlap as a byte-plane sum above
// 255; here atomicOr returns the old word, and old & w != 0 is an overlap
// (which of two overlapping slots counts depends on the order of the
// atomics, so the overlap term is exact only as zero / nonzero).  It also
// skips a slot whose value would start above its 160-bit window (length >
// 160 - bit offset in its word) and keeps words below the buffer, as the
// plain twin does, so corrupted lengths cannot write out of bounds.  The
// unchecked form compiles to the code it had without the flag.
//
// The chunk loop (pack_fused8_kernel: B6c alone, within twice its bound):
// 512 threads per slice walk the slots in chunks of 512; a chunk's lengths
// are scanned (running total in shared memory) before the words of its
// non-empty slots are loaded.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// word j of the value shifted to the top of a 32 (kWords + 1)-bit window by
// sig = 32 q + r bits, over the words u = [0, v0, ..., v_{kWords-1}]
template <int kWords>
__device__ __forceinline__ uint32_t window_word(const uint32_t u[kWords + 1], int j, int q,
                                                int r) {
  const int i = j + q;
  if (i > kWords) return 0u;
  uint32_t hi = 0u, lo = 0u;
#pragma unroll
  for (int t = 0; t <= kWords; ++t) {
    if (t == i) hi = u[t];
    if (t == i + 1) lo = u[t];
  }
  return r ? (hi << r) | (lo >> (32 - r)) : hi;
}

// OR a value of len bits (words u[1..kWords], most significant first, below
// u[0] = 0) at bit offset off into buf, from the top of its 32 (kWords + 1)-
// bit window; words at or past max_words are dropped.  kChecks: a value
// that would start above its window is skipped, and hits counts the
// placements that found bits already set.
template <int kWords, bool kChecks>
__device__ __forceinline__ void place_window(const uint32_t u[kWords + 1], int len, int off,
                                             uint32_t* buf, int max_words, int& hits) {
  const int sig = 32 * (kWords + 1) - (off & 31) - len;
  if (len <= 0 || (kChecks && sig < 0)) return;
  const int word = off >> 5;
  const int q = sig >> 5, r = sig & 31;
#pragma unroll
  for (int j = 0; j <= kWords; ++j) {
    const uint32_t w = window_word<kWords>(u, j, q, r);
    // one unsigned compare keeps words below the buffer (after a negative
    // length) out too
    const bool in = (unsigned)(word + j) < (unsigned)max_words;
    if constexpr (kChecks) {
      if (w && in) hits += (atomicOr(&buf[word + j], w) & w) != 0u;
    } else {
      if (w && in) atomicOr(&buf[word + j], w);
    }
  }
}

// ---- K1's and K2's geometry, loads and placement ---------------------------

constexpr int kRawThreads = 128;
constexpr int kRawMinBlocks = 9;  // blocks per SM (<= 56 registers)
constexpr int kRawV = 4;          // consecutive codes per thread

// One thread's kRawV codes and lengths of a tile.
struct RawCodes {
  int l[kRawV];
  uint32_t c[kRawV];
};

// The codes i .. i + kRawV - 1 of a row of k (codes and lens point at the
// row); codes past the row read as length 0.  kVec: k % 4 == 0 and both
// rows 16-byte aligned, so each group of 4 is one int4 of each array, all
// of it in the row or none (i is a multiple of kRawV).
template <bool kVec>
__device__ __forceinline__ void load_raw(const int32_t* __restrict__ codes,
                                         const int32_t* __restrict__ lens, int k, int i,
                                         RawCodes& r) {
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kRawV; h += 4) {
      int4 a = make_int4(0, 0, 0, 0), b = make_int4(0, 0, 0, 0);
      if (i + h < k) {
        a = __ldg(reinterpret_cast<const int4*>(lens + i + h));
        b = __ldg(reinterpret_cast<const int4*>(codes + i + h));
      }
      r.l[h] = a.x; r.l[h + 1] = a.y; r.l[h + 2] = a.z; r.l[h + 3] = a.w;
      r.c[h] = (uint32_t)b.x; r.c[h + 1] = (uint32_t)b.y;
      r.c[h + 2] = (uint32_t)b.z; r.c[h + 3] = (uint32_t)b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRawV; ++e) {
      const bool in = i + e < k;
      r.l[e] = in ? __ldg(lens + i + e) : 0;
      r.c[e] = in ? (uint32_t)__ldg(codes + i + e) : 0u;
    }
  }
}

// OR a code of length 1..32 at bit offset off into buf: shifted to the top
// of the 64-bit window of words off >> 5 and the next, by 64 - (off & 31) -
// len bits (in [1, 63]).  Words at or past max_words are dropped.
__device__ __forceinline__ void place_raw(uint32_t code, int len, int off, uint32_t* buf,
                                          int max_words) {
  if (len <= 0) return;
  const int word = off >> 5;
  const int sh = 64 - (off & 31) - len;
  const uint32_t w0 = sh >= 32 ? code << (sh - 32) : code >> (32 - sh);
  const uint32_t w1 = sh >= 32 ? 0u : code << sh;
  if (w0 && (unsigned)word < (unsigned)max_words) atomicOr(&buf[word], w0);
  if (w1 && (unsigned)(word + 1) < (unsigned)max_words) atomicOr(&buf[word + 1], w1);
}

// ---- the tile loop: K1, K2, B2 and B2 checked -----------------------------

// B2's geometry: threads per block, the least blocks per SM the launch
// bounds ask for (<= 64 registers) and consecutive fused slots per thread
// (2, 4 or 8).  K1 and K2 run kRaw*.
constexpr int kFusedThreads = 512;
constexpr int kFusedMinBlocks = 2;
constexpr int kFusedV = 4;

// The int32 of a vector load of a thread's kV slots: 4 (16 bytes) or 2.
__host__ __device__ constexpr int vec_width(int v) { return v % 4 == 0 ? 4 : 2; }

// kV consecutive int32 of a row of k from element i (a multiple of kV): in
// vector loads of kW = vec_width(kV) when kVec (k % kW == 0 and the row
// aligned to 4 kW bytes, so a group lies in the row whole or not at all),
// else one by one.  Elements past the row read as 0.
template <int kV, bool kVec>
__device__ __forceinline__ void load_run(const int32_t* __restrict__ p, int k, int i,
                                         int (&v)[kV]) {
  constexpr int kW = vec_width(kV);
  static_assert(kV % 2 == 0, "kV must be even");
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kV; h += kW) {
      if constexpr (kW == 4) {
        int4 a = make_int4(0, 0, 0, 0);
        if (i + h < k) a = __ldg(reinterpret_cast<const int4*>(p + i + h));
        v[h] = a.x; v[h + 1] = a.y; v[h + 2] = a.z; v[h + 3] = a.w;
      } else {
        int2 a = make_int2(0, 0);
        if (i + h < k) a = __ldg(reinterpret_cast<const int2*>(p + i + h));
        v[h] = a.x; v[h + 1] = a.y;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) v[e] = i + e < k ? __ldg(p + i + e) : 0;
  }
}

// A slot source of pack_tiles_kernel: its geometry, one thread's Tile of kV
// slots (their lengths l among what it holds), the loads of a tile (load)
// and the placement of its slots from bit offset off on.

// K1 and K2 read (n, k) raw codes of <= 32 bits and their lengths alike:
// K1's geometry, kRawV codes per thread, loaded by load_raw.
struct RawSource {
  static constexpr int kThreads = kRawThreads, kMinBlocks = kRawMinBlocks, kV = kRawV;
  using Tile = RawCodes;
  const int32_t* codes;
  const int32_t* lens;
  __device__ __forceinline__ void seek(int row, int k) {
    codes += (size_t)row * k;
    lens += (size_t)row * k;
  }
  template <bool kVec>
  __device__ __forceinline__ void load(int k, int i, Tile& t) const {
    load_raw<kVec>(codes, lens, k, i, t);
  }
};

// K1: each code placed on its own.
struct Raw : RawSource {
  template <bool kChecks>
  __device__ __forceinline__ static void place(const Tile& t, int off, uint32_t* buf,
                                               int max_words, int&) {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      place_raw(t.c[e], t.l[e], off, buf, max_words);
      off += t.l[e];
    }
  }
};

// K2: the thread's raw codes (0, 1), (2, 3), ... fused as the reference's
// `_fuse2_32` does (a code of length 0 contributes nothing) and placed as
// one value of <= 64 bits each.
struct Pairs : RawSource {
  template <bool kChecks>
  __device__ __forceinline__ static void place(const Tile& t, int off, uint32_t* buf,
                                               int max_words, int& hits) {
#pragma unroll
    for (int p = 0; p < kV; p += 2) {
      const int l1 = t.l[p], l2 = t.l[p + 1];
      const uint32_t c1 = l1 > 0 ? t.c[p] : 0u;
      const uint32_t c2 = l2 > 0 ? t.c[p + 1] : 0u;
      const int r = l2 & 31;  // l2 == 32: r = 0, the pair is (c1, c2)
      const uint32_t u[3] = {0u, l2 > 0 ? (r ? c1 >> (32 - r) : c1) : 0u,
                             (l2 < 32 ? c1 << r : 0u) | c2};
      place_window<2, false>(u, l1 + l2, off, buf, max_words, hits);
      off += l1 + l2;
    }
  }
};

// B2: (n, k) fused slots, their lengths and word planes v[0] (most
// significant) .. v[3].
struct Fused4 {
  static constexpr int kThreads = kFusedThreads, kMinBlocks = kFusedMinBlocks, kV = kFusedV;
  static constexpr int kW = vec_width(kV);
  struct Tile {
    int l[kV];
    int w[4][kV];
  };
  const int32_t* flens;
  const int32_t* v[4];
  __device__ __forceinline__ void seek(int row, int k) {
    flens += (size_t)row * k;
#pragma unroll
    for (int p = 0; p < 4; ++p) v[p] += (size_t)row * k;
  }
  template <bool kVec>
  __device__ __forceinline__ void load(int k, int i, Tile& t) const {
    load_run<kV, kVec>(flens, k, i, t.l);
#pragma unroll
    for (int p = 0; p < 4; ++p) load_run<kV, kVec>(v[p], k, i, t.w[p]);
  }
  template <bool kChecks>
  __device__ __forceinline__ static void place(const Tile& t, int off, uint32_t* buf,
                                               int max_words, int& hits) {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int len = t.l[e];
      if (kChecks) hits += len < 0 || len > 128;
      const uint32_t u[5] = {0u, (uint32_t)t.w[0][e], (uint32_t)t.w[1][e], (uint32_t)t.w[2][e],
                             (uint32_t)t.w[3][e]};
      place_window<4, kChecks>(u, len, off, buf, max_words, hits);
      off += len;
    }
  }
};

template <class Src, bool kShared, bool kVec, bool kChecks>
__global__ void __launch_bounds__(Src::kThreads, Src::kMinBlocks)
pack_tiles_kernel(Src src, int k, int max_words, int bit_offset,
                  uint32_t* __restrict__ seg_words, int32_t* __restrict__ nbits,
                  int32_t* __restrict__ viol) {
  constexpr int kThreads = Src::kThreads, kWarps = kThreads / 32, kV = Src::kV;
  constexpr int kTile = kThreads * kV;  // slots per tile
  extern __shared__ uint32_t s_buf[];
  __shared__ int s_warp[2][kWarps];  // warp totals of tiles 2m and 2m + 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  src.seek(row, k);
  uint32_t* out = seg_words + (size_t)row * max_words;
  uint32_t* buf = kShared ? s_buf : out;

  typename Src::Tile cur, nxt;
  src.template load<kVec>(k, kV * tid, cur);
  for (int i = tid; i < max_words; i += kThreads) buf[i] = 0u;
  int carry = bit_offset;  // the row's bits before the tile, in every thread
  int hits = 0;            // this thread's violations (kChecks)
  const int ntiles = (k + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    // tile t + 1 in flight (past the row: no load) while tile t is placed
    src.template load<kVec>(k, (t + 1) * kTile + kV * tid, nxt);
    int sum = 0;
#pragma unroll
    for (int e = 0; e < kV; ++e) sum += cur.l[e];
    const int incl = warp_inclusive_scan(sum, lane);
    if (lane == 31) s_warp[t & 1][warp] = incl;
    // the warp totals are complete (and, at t = 0, the buffer zeroed); the
    // other half of s_warp was last read before the previous barrier
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_warp[t & 1][w];
      before += w < warp ? v : 0;
      total += v;
    }
    const int off = carry + before + incl - sum;
    carry += total;
    Src::template place<kChecks>(cur, off, buf, max_words, hits);
    cur = nxt;
  }
  if constexpr (kChecks) {
    // the warps' counts go to the half of s_warp that no thread reads after
    // the last tile's barrier
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) hits += __shfl_down_sync(0xffffffffu, hits, d);
    if (lane == 0) s_warp[ntiles & 1][warp] = hits;
  }
  __syncthreads();  // every slot placed
  if (tid == 0) nbits[row] = carry;
  if constexpr (kChecks) {
    if (tid == 0) {
      int v = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_warp[ntiles & 1][w];
      viol[row] = v;
    }
  }
  // stream byte order: word w's most significant byte first
  for (int i = tid; i < max_words; i += kThreads) out[i] = __byte_perm(buf[i], 0u, 0x0123);
}

// ---- the chunk loop: B6c --------------------------------------------------

constexpr int kChunkThreads = 512;
constexpr int kChunkWarps = kChunkThreads / 32;

// (n, kf) 8:1-fused slots, w[p] holding word p (most significant first) of
// every slot.
struct Slots8 {
  const int32_t* w[8];
  const int32_t* flens;
  int kf;
};

template <bool kShared>
__global__ void __launch_bounds__(kChunkThreads)
pack_fused8_kernel(const Slots8 src, int max_words, int bit_offset,
                   uint32_t* __restrict__ seg_words, int32_t* __restrict__ nbits) {
  extern __shared__ uint32_t s_buf[];
  __shared__ int s_warp[kChunkWarps];
  __shared__ int s_carry;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  uint32_t* out = seg_words + (size_t)row * max_words;
  uint32_t* buf = kShared ? s_buf : out;

  for (int i = tid; i < max_words; i += kChunkThreads) buf[i] = 0u;
  if (tid == 0) s_carry = bit_offset;
  int hits = 0;  // unused: B6c has no checked form
  __syncthreads();

  const int kf = src.kf;
  for (int c0 = 0; c0 < kf; c0 += kChunkThreads) {
    const int i = c0 + tid;
    const size_t at = (size_t)row * kf + i;
    const int len = i < kf ? src.flens[at] : 0;
    const int incl = warp_inclusive_scan(len, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kChunkWarps ? s_warp[lane] : 0;
      const int ws = warp_inclusive_scan(w, lane);
      if (lane < kChunkWarps) s_warp[lane] = ws;
    }
    __syncthreads();
    const int off = s_carry + (warp ? s_warp[warp - 1] : 0) + incl - len;
    const int total = s_warp[kChunkWarps - 1];
    if (len > 0) {
      uint32_t u[9];
      u[0] = 0u;
#pragma unroll
      for (int p = 0; p < 8; ++p) u[p + 1] = (uint32_t)src.w[p][at];
      place_window<8, false>(u, len, off, buf, max_words, hits);
    }
    __syncthreads();  // everyone has read s_carry and s_warp
    if (tid == 0) s_carry += total;
  }
  __syncthreads();
  if (tid == 0) nbits[row] = s_carry;
  // stream byte order: word w's most significant byte first
  for (int i = tid; i < max_words; i += kChunkThreads) out[i] = __byte_perm(buf[i], 0u, 0x0123);
}

// ---- launchers -------------------------------------------------------------

// Whether a slice buffer of max_words words (and static_bytes of other
// shared memory) fits the device's opt-in shared memory per block: the
// buffer regime of a launch.
cudaError_t fits_shared(int device, int max_words, size_t static_bytes, bool* shared) {
  int optin = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *shared = (size_t)max_words * 4 + static_bytes <= (size_t)optin;
  return err;
}

template <class Src, bool kShared, bool kVec, bool kChecks>
cudaError_t launch_tiles(const Src& src, int n, int k, int max_words, int bit_offset, void* seg,
                         void* nbits, void* viol, cudaStream_t s) {
  const size_t bytes = kShared ? (size_t)max_words * 4 : 0;
  if constexpr (kShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(pack_tiles_kernel<Src, kShared, kVec, kChecks>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  pack_tiles_kernel<Src, kShared, kVec, kChecks><<<n, Src::kThreads, bytes, s>>>(
      src, k, max_words, bit_offset, (uint32_t*)seg, (int32_t*)nbits, (int32_t*)viol);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return ((uintptr_t)p % bytes) == 0; }

// One tile-loop launch: the buffer regime and the loads (vector when `vec`).
template <class Src, bool kChecks>
int dispatch_tiles(const Src& src, int n, int k, int max_words, int bit_offset, bool vec,
                   void* seg, void* nbits, void* viol, int device, void* stream) {
  if (n < 0 || k < 0 || max_words <= 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  bool shared = false;
  err = fits_shared(device, max_words, sizeof(int[2][Src::kThreads / 32]), &shared);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (shared)
    err = vec ? launch_tiles<Src, true, true, kChecks>(src, n, k, max_words, bit_offset, seg,
                                                       nbits, viol, s)
              : launch_tiles<Src, true, false, kChecks>(src, n, k, max_words, bit_offset, seg,
                                                        nbits, viol, s);
  else
    err = vec ? launch_tiles<Src, false, true, kChecks>(src, n, k, max_words, bit_offset, seg,
                                                        nbits, viol, s)
              : launch_tiles<Src, false, false, kChecks>(src, n, k, max_words, bit_offset, seg,
                                                         nbits, viol, s);
  return (int)err;
}

}  // namespace

// B2.  viol == nullptr: the production kernel; otherwise the checked form,
// which also writes the (n,) int32 violation counts to viol.
extern "C" int pack_fused4_launch(const void* v0, const void* v1, const void* v2,
                                  const void* v3, const void* flens, int n, int kf,
                                  int max_words, int bit_offset, void* seg,
                                  void* nbits, void* viol, int device, void* stream) {
  const Fused4 src{(const int32_t*)flens,
                   {(const int32_t*)v0, (const int32_t*)v1, (const int32_t*)v2,
                    (const int32_t*)v3}};
  constexpr size_t kAlign = 4 * Fused4::kW;
  const bool vec = kf % Fused4::kW == 0 && aligned(flens, kAlign) && aligned(v0, kAlign) &&
                   aligned(v1, kAlign) && aligned(v2, kAlign) && aligned(v3, kAlign);
  return viol == nullptr
             ? dispatch_tiles<Fused4, false>(src, n, kf, max_words, bit_offset, vec, seg, nbits,
                                             nullptr, device, stream)
             : dispatch_tiles<Fused4, true>(src, n, kf, max_words, bit_offset, vec, seg, nbits,
                                            viol, device, stream);
}

// B6c: 8-word slots, w0 the most significant word plane.
extern "C" int pack_fused8_launch(const void* w0, const void* w1, const void* w2,
                                  const void* w3, const void* w4, const void* w5,
                                  const void* w6, const void* w7, const void* flens, int n,
                                  int kf, int max_words, int bit_offset, void* seg,
                                  void* nbits, int device, void* stream) {
  if (n < 0 || kf < 0 || max_words <= 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  const Slots8 src{{(const int32_t*)w0, (const int32_t*)w1, (const int32_t*)w2,
                    (const int32_t*)w3, (const int32_t*)w4, (const int32_t*)w5,
                    (const int32_t*)w6, (const int32_t*)w7},
                   (const int32_t*)flens, kf};
  bool shared = false;
  err = fits_shared(device, max_words, (kChunkWarps + 2) * sizeof(int), &shared);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = shared ? (size_t)max_words * 4 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    err = cudaFuncSetAttribute(pack_fused8_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    pack_fused8_kernel<true><<<n, kChunkThreads, bytes, s>>>(src, max_words, bit_offset,
                                                             (uint32_t*)seg, (int32_t*)nbits);
  } else {
    pack_fused8_kernel<false><<<n, kChunkThreads, 0, s>>>(src, max_words, bit_offset,
                                                          (uint32_t*)seg, (int32_t*)nbits);
  }
  return (int)cudaGetLastError();
}

// K1: (n, k) raw codes of <= 32 bits and their lengths.
extern "C" int pack_raw_launch(const void* codes, const void* lens, int n, int k, int max_words,
                               int bit_offset, void* seg, void* nbits, int device,
                               void* stream) {
  Raw src;
  src.codes = (const int32_t*)codes;
  src.lens = (const int32_t*)lens;
  const bool vec = k % 4 == 0 && aligned(codes, 16) && aligned(lens, 16);
  return dispatch_tiles<Raw, false>(src, n, k, max_words, bit_offset, vec, seg, nbits, nullptr,
                                    device, stream);
}

// K2: the same raw codes, fused 2:1 after they are loaded.
extern "C" int pack_pairs_launch(const void* codes, const void* lens, int n, int k,
                                 int max_words, int bit_offset, void* seg, void* nbits,
                                 int device, void* stream) {
  Pairs src;
  src.codes = (const int32_t*)codes;
  src.lens = (const int32_t*)lens;
  // K1's vector loads: k % 4 == 0 and both rows 16-byte aligned
  const bool vec = k % 4 == 0 && aligned(codes, 16) && aligned(lens, 16);
  return dispatch_tiles<Pairs, false>(src, n, k, max_words, bit_offset, vec, seg, nbits, nullptr,
                                      device, stream);
}

// Slots per tile of B2's tile loop (threads per block x slots per thread):
// where its tile edges lie, for the tests.
extern "C" int pack_fused4_tile() { return Fused4::kThreads * Fused4::kV; }

extern "C" const char* pack_fused4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
