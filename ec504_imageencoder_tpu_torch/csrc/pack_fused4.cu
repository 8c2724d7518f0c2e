// pack_fused4: 4:1-fused VLC slots -> big-endian slice bytes + bit counts
// (kernel B2), the same for 8:1-fused slots (kernel B6c), for raw codes
// (K1) and for raw codes fused 2:1 as they are loaded (K2).
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
// B6c (kWords = 8, entry point pack_fused8_launch) replaces `_fused8_kernel`
// (`pack_words_fused8_core`, the reference's EC504_FUSE=8 route) and its
// bitcast: slots of <= 256 bits (eight words), each spanning at most 9
// words, placed from a 288-bit window.  It has none of the TPU kernel's
// limits on max_words (a multiple of 128, at least 384): those were its
// tiling.
//
// K1 (pack_raw_launch, its own kernel beside the template) replaces two
// Pallas kernels that compute `bitpack.pack_words` of raw codes of <= 32
// bits: `_pack_kernel` (`pack_words_pallas`, the reference's
// EC504_PACK=pallas1) and `_pack2_kernel` (`pack_words_pallas2`, no
// caller).  They differ only in their MXU formulation: f32 half-words
// against a one-hot window, or bf16 byte planes with the carry words added
// at the same window position and shifted afterwards; neither has a
// meaning on a GPU, where a code is two shifted words ORed in place.  K2
// (Pairs, pack_pairs_launch) replaces `_fused2w_kernel`
// (`pack_words_fused2w`, EC504_PACK=fused2w) and the `_fuse2_32` in front
// of it: slot i of a row is the raw pair (2i, 2i+1), fused in registers as
// it is loaded (V = c1 2^l2 | c2, <= 64 bits) and placed from a 96-bit
// window.
//
// What bounds it on the H100: bytes.  Per slice it reads 4 (kWords + 1) B
// per fused slot (230 KB at 1080p for either fusion) and writes the slice
// buffer once; the scan and the placement are a few dozen integer ops per
// slot.
//
// Design: one CUDA block per slice.  The block walks the slots in chunks of
// its thread count; a warp-shuffle exclusive scan of the lengths, with the
// running total carried across chunks in shared memory, gives each slot its
// bit offset.  Each slot ORs its (up to kWords + 1) shifted words into a
// zeroed slice buffer with atomicOr: the contributions are bit-disjoint and
// OR is order-free, so the result is deterministic.  The buffer lives in
// dynamic shared memory when it fits the card's opt-in limit (227 KB on the
// H100: every auto-sized and worst-case 1080p buffer); a larger regrown
// buffer (e.g. 342,528 B at width 4095) is ORed in place in the zeroed
// output row in global memory instead.  A final coalesced pass byte-swaps
// the words into stream byte order.
//
// K1 keeps that design (one block per slice, the same buffer regimes) but
// not the template's chunk loop, whose every chunk of 512 codes waited on
// two dependent global loads (the lengths, then the codes of the non-empty
// slots) and three barriers, 90 chunks in series per slice at 16 x 1080p:
// latency, not bytes.  K1 walks tiles of
// kRawV = 4 consecutive codes per thread, the lengths and the codes of a
// tile read together with one 16-byte load each (a warp's load covers 512
// contiguous bytes), and the loads of tile t + 1 go out before the scan and
// placement of tile t, so each tile's one barrier overlaps a load in
// flight.  The block scan is a warp shuffle scan of each thread's sum plus
// the warp totals, double-buffered in shared memory so that one barrier per
// tile suffices; every thread carries the running bit offset in a
// register.  At 128 threads and 40 registers, 9 blocks (each with its 23.6
// KB buffer at 1080p) share an SM, and a 16 x 1080p batch's 1,088 slices
// run in one wave on 132 SMs: 0.16 ms against the chunk loop's 0.41 (CUDA
// events, NVIDIA H100 80GB HBM3, 700.00 W; the bound is 0.13).  Other geometries measured no better
// (tools/k1_variants.py): 8 or 16 codes per thread, or 256 and 512
// threads.  A row whose length count or base is not a multiple of 16 bytes
// loads scalars.
//
// B2's checked form (kChecks, entry point with a non-null `viol`) replaces
// the debug outputs of `_fused4_kernel` (`pack_words_fused4_core(...,
// debug=True)`): per slice it counts fused lengths outside [0, 128] and
// placements whose bits overlap bits already placed.  The TPU finds an
// overlap as a byte-plane sum above 255; here atomicOr returns the old
// word, and old & w != 0 is an overlap (which of two overlapping slots
// counts depends on the order of the atomics, so the overlap term is
// exact only as zero / nonzero).  It also skips a slot whose value would
// start above its 160-bit window (length > 160 - bit offset in its word)
// and keeps words below the buffer, as the plain twin does, so corrupted
// lengths cannot write out of bounds.  The unchecked form compiles to the
// code it had without the flag.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_guard.cuh"

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

// The slots the kernel places, as a source: count() slots per row, the
// length of slot i of a row, and its value as words u[1..kW] (most
// significant first) below u[0] = 0.
//
// Slots: (n, kf) fused slots, v[p] holding word p of every slot.
template <int kWords>
struct Slots {
  static constexpr int kW = kWords;
  const int32_t* v[kWords];
  const int32_t* flens;
  int kf;
  __device__ __forceinline__ int count() const { return kf; }
  __device__ __forceinline__ int len(int row, int i) const {
    return flens[(size_t)row * kf + i];
  }
  __device__ __forceinline__ void words(int row, int i, uint32_t u[kWords + 1]) const {
    u[0] = 0u;
#pragma unroll
    for (int p = 0; p < kWords; ++p) u[p + 1] = (uint32_t)v[p][(size_t)row * kf + i];
  }
};

// Pairs: (n, k) raw codes of <= 32 bits; slot i is the pair (2i, 2i+1)
// fused as the reference's `_fuse2_32` does, an odd k's last code paired
// with an empty slot.
struct Pairs {
  static constexpr int kW = 2;
  const int32_t* codes;
  const int32_t* lens;
  int k;
  __device__ __forceinline__ int count() const { return (k + 1) >> 1; }
  __device__ __forceinline__ int len(int row, int i) const {
    const size_t a = (size_t)row * k + 2 * i;
    return lens[a] + (2 * i + 1 < k ? lens[a + 1] : 0);
  }
  __device__ __forceinline__ void words(int row, int i, uint32_t u[3]) const {
    const size_t a = (size_t)row * k + 2 * i;
    const bool two = 2 * i + 1 < k;
    const int l1 = lens[a], l2 = two ? lens[a + 1] : 0;
    const uint32_t c1 = l1 > 0 ? (uint32_t)codes[a] : 0u;
    const uint32_t c2 = l2 > 0 ? (uint32_t)codes[a + 1] : 0u;
    const int r = l2 & 31;  // l2 == 32: r = 0, the pair is (c1, c2)
    u[0] = 0u;
    u[1] = l2 > 0 ? (r ? c1 >> (32 - r) : c1) : 0u;
    u[2] = (l2 < 32 ? c1 << r : 0u) | c2;
  }
};

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

template <class Src, bool kShared, bool kChecks>
__global__ void __launch_bounds__(kThreads)
pack_fused_kernel(const Src src, int max_words, int bit_offset, uint32_t* __restrict__ seg_words,
                  int32_t* __restrict__ nbits, int32_t* __restrict__ viol) {
  constexpr int kWords = Src::kW;
  extern __shared__ uint32_t s_buf[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_carry;
  __shared__ int s_viol;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  uint32_t* out = seg_words + (size_t)row * max_words;
  uint32_t* buf = kShared ? s_buf : out;

  for (int i = tid; i < max_words; i += kThreads) buf[i] = 0u;
  if (tid == 0) s_carry = bit_offset;
  if (kChecks && tid == 0) s_viol = 0;
  int hits = 0;  // this thread's violations (kChecks)
  __syncthreads();

  const int kf = src.count();
  for (int c0 = 0; c0 < kf; c0 += kThreads) {
    const int i = c0 + tid;
    const int len = i < kf ? src.len(row, i) : 0;
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
    if (kChecks) hits += len < 0 || len > 32 * kWords;
    const int sig = 32 * (kWords + 1) - (off & 31) - len;
    if (len > 0 && (!kChecks || sig >= 0)) {
      uint32_t u[kWords + 1];
      src.words(row, i, u);
      const int word = off >> 5;
      const int q = sig >> 5, r = sig & 31;
#pragma unroll
      for (int j = 0; j <= kWords; ++j) {
        const uint32_t w = window_word<kWords>(u, j, q, r);
        // one unsigned compare keeps words below the buffer (after a
        // negative length) out too
        const bool in = (unsigned)(word + j) < (unsigned)max_words;
        if constexpr (kChecks) {
          if (w && in) hits += (atomicOr(&buf[word + j], w) & w) != 0u;
        } else {
          if (w && in) atomicOr(&buf[word + j], w);
        }
      }
    }
    __syncthreads();  // everyone has read s_carry and s_warp
    if (tid == 0) s_carry += total;
  }
  if constexpr (kChecks) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) hits += __shfl_down_sync(0xffffffffu, hits, d);
    if (lane == 0 && hits) atomicAdd(&s_viol, hits);
  }
  __syncthreads();
  if (tid == 0) nbits[row] = s_carry;
  if (kChecks && tid == 0) viol[row] = s_viol;
  // stream byte order: word w's most significant byte first
  for (int i = tid; i < max_words; i += kThreads) out[i] = __byte_perm(buf[i], 0u, 0x0123);
}

// ---- K1: raw codes, whole tiles per thread --------------------------------

constexpr int kRawThreads = 128;
constexpr int kRawWarps = kRawThreads / 32;
constexpr int kRawMinBlocks = 9;               // blocks per SM (<= 56 registers)
constexpr int kRawV = 4;                       // consecutive codes per thread
constexpr int kRawTile = kRawThreads * kRawV;  // codes per tile

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

template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kRawThreads, kRawMinBlocks)
pack_raw_kernel(const int32_t* __restrict__ codes, const int32_t* __restrict__ lens, int k,
                int max_words, int bit_offset, uint32_t* __restrict__ seg_words,
                int32_t* __restrict__ nbits) {
  extern __shared__ uint32_t s_buf[];
  __shared__ int s_warp[2][kRawWarps];  // warp totals of tiles 2m and 2m + 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  codes += (size_t)row * k;
  lens += (size_t)row * k;
  uint32_t* out = seg_words + (size_t)row * max_words;
  uint32_t* buf = kShared ? s_buf : out;

  RawCodes cur, nxt;
  load_raw<kVec>(codes, lens, k, kRawV * tid, cur);
  for (int i = tid; i < max_words; i += kRawThreads) buf[i] = 0u;
  int carry = bit_offset;  // the row's bits before the tile, in every thread
  const int ntiles = (k + kRawTile - 1) / kRawTile;
  for (int t = 0; t < ntiles; ++t) {
    // tile t + 1 in flight (past the row: no load) while tile t is placed
    load_raw<kVec>(codes, lens, k, (t + 1) * kRawTile + kRawV * tid, nxt);
    int sum = 0;
#pragma unroll
    for (int e = 0; e < kRawV; ++e) sum += cur.l[e];
    const int incl = warp_inclusive_scan(sum, lane);
    if (lane == 31) s_warp[t & 1][warp] = incl;
    // the warp totals are complete (and, at t = 0, the buffer zeroed); the
    // other half of s_warp was last read before the previous barrier
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kRawWarps; ++w) {
      const int v = s_warp[t & 1][w];
      before += w < warp ? v : 0;
      total += v;
    }
    int off = carry + before + incl - sum;
    carry += total;
#pragma unroll
    for (int e = 0; e < kRawV; ++e) {
      place_raw(cur.c[e], cur.l[e], off, buf, max_words);
      off += cur.l[e];
    }
    cur = nxt;
  }
  __syncthreads();  // every code placed
  if (tid == 0) nbits[row] = carry;
  // stream byte order: word w's most significant byte first
  for (int i = tid; i < max_words; i += kRawThreads) out[i] = __byte_perm(buf[i], 0u, 0x0123);
}

template <class Src, bool kShared, bool kChecks>
cudaError_t launch(const Src& src, int n, int max_words, int bit_offset, void* seg, void* nbits,
                   void* viol, size_t bytes, cudaStream_t s) {
  if constexpr (kShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_fused_kernel<Src, kShared, kChecks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  pack_fused_kernel<Src, kShared, kChecks><<<n, kThreads, kShared ? bytes : 0, s>>>(
      src, max_words, bit_offset, (uint32_t*)seg, (int32_t*)nbits, (int32_t*)viol);
  return cudaGetLastError();
}

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

// The buffer regime (shared or global memory) and the form (checked when
// viol is non-null; B2 only) of one launch; k is the slots (or raw codes)
// per row.
template <class Src>
int dispatch(const Src& src, int n, int k, int max_words, int bit_offset, void* seg, void* nbits,
             void* viol, int device, void* stream) {
  if (n < 0 || k < 0 || max_words <= 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  bool shared = false;
  err = fits_shared(device, max_words, (kWarps + 2) * sizeof(int), &shared);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)max_words * 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (viol == nullptr) {
    err = shared ? launch<Src, true, false>(src, n, max_words, bit_offset, seg, nbits, viol,
                                            bytes, s)
                 : launch<Src, false, false>(src, n, max_words, bit_offset, seg, nbits, viol,
                                             bytes, s);
  } else if constexpr (std::is_same_v<Src, Slots<4>>) {
    err = shared ? launch<Src, true, true>(src, n, max_words, bit_offset, seg, nbits, viol,
                                           bytes, s)
                 : launch<Src, false, true>(src, n, max_words, bit_offset, seg, nbits, viol,
                                            bytes, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

template <bool kShared, bool kVec>
cudaError_t launch_raw(const int32_t* codes, const int32_t* lens, int n, int k, int max_words,
                       int bit_offset, void* seg, void* nbits, cudaStream_t s) {
  const size_t bytes = kShared ? (size_t)max_words * 4 : 0;
  if constexpr (kShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_raw_kernel<kShared, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  pack_raw_kernel<kShared, kVec><<<n, kRawThreads, bytes, s>>>(
      codes, lens, k, max_words, bit_offset, (uint32_t*)seg, (int32_t*)nbits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// B2.  viol == nullptr: the production kernel; otherwise the checked form,
// which also writes the (n,) int32 violation counts to viol.
extern "C" int pack_fused4_launch(const void* v0, const void* v1, const void* v2,
                                  const void* v3, const void* flens, int n, int kf,
                                  int max_words, int bit_offset, void* seg,
                                  void* nbits, void* viol, int device, void* stream) {
  const Slots<4> src{{(const int32_t*)v0, (const int32_t*)v1, (const int32_t*)v2,
                      (const int32_t*)v3},
                     (const int32_t*)flens, kf};
  return dispatch(src, n, kf, max_words, bit_offset, seg, nbits, viol, device, stream);
}

// B6c: 8-word slots, w0 the most significant word plane.
extern "C" int pack_fused8_launch(const void* w0, const void* w1, const void* w2,
                                  const void* w3, const void* w4, const void* w5,
                                  const void* w6, const void* w7, const void* flens, int n,
                                  int kf, int max_words, int bit_offset, void* seg,
                                  void* nbits, int device, void* stream) {
  const Slots<8> src{{(const int32_t*)w0, (const int32_t*)w1, (const int32_t*)w2,
                      (const int32_t*)w3, (const int32_t*)w4, (const int32_t*)w5,
                      (const int32_t*)w6, (const int32_t*)w7},
                     (const int32_t*)flens, kf};
  return dispatch(src, n, kf, max_words, bit_offset, seg, nbits, nullptr, device, stream);
}

// K1: (n, k) raw codes of <= 32 bits and their lengths.
extern "C" int pack_raw_launch(const void* codes, const void* lens, int n, int k, int max_words,
                               int bit_offset, void* seg, void* nbits, int device,
                               void* stream) {
  if (n < 0 || k < 0 || max_words <= 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  bool shared = false;
  err = fits_shared(device, max_words, sizeof(int[2][kRawWarps]), &shared);
  if (err != cudaSuccess) return (int)err;
  const bool vec = k % 4 == 0 && aligned16(codes) && aligned16(lens);
  const int32_t* c = (const int32_t*)codes;
  const int32_t* l = (const int32_t*)lens;
  cudaStream_t s = (cudaStream_t)stream;
  if (shared)
    err = vec ? launch_raw<true, true>(c, l, n, k, max_words, bit_offset, seg, nbits, s)
              : launch_raw<true, false>(c, l, n, k, max_words, bit_offset, seg, nbits, s);
  else
    err = vec ? launch_raw<false, true>(c, l, n, k, max_words, bit_offset, seg, nbits, s)
              : launch_raw<false, false>(c, l, n, k, max_words, bit_offset, seg, nbits, s);
  return (int)err;
}

// K2: the same raw codes, fused 2:1 as they are loaded.
extern "C" int pack_pairs_launch(const void* codes, const void* lens, int n, int k,
                                 int max_words, int bit_offset, void* seg, void* nbits,
                                 int device, void* stream) {
  const Pairs src{(const int32_t*)codes, (const int32_t*)lens, k};
  return dispatch(src, n, k, max_words, bit_offset, seg, nbits, nullptr, device, stream);
}

extern "C" const char* pack_fused4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
