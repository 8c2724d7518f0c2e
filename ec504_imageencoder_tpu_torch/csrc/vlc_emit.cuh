// Device code shared by the VLC kernels (vlc_fused4.cu, vlc_levels4.cu,
// vlc_compat.cu): the reference's integer AAN forward DCT, the VLC table
// layout in shared memory, the correct-mode DC and AC slot emission, the
// exact 4:1 and 8:1 slot fusions with their stream-order stores
// (warp-cooperative: B1, B3, B6b and, with its own compat rules, B4b), and
// the one-word form of a raw slot (B6a).
//
// Every function mirrors a function of the PyTorch twins (ops/dct.py,
// ops/vlc_device.py, ops/bitpack.py::fuse4 and fuse8), which mirror the
// reference package; the kernels are held against the twins exactly.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vlc {

constexpr int kAcRuns = 32;    // run 0..31
constexpr int kAcLevels = 41;  // |level| 0..40
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

// The VLC tables in shared memory, each entry `code | len << 16`: the AC
// run/level LUT (s_ac, [run][|level|], len 0 = no row) and the
// dct_dc_size VLCs (s_dcc, [is_luma][size]).  Call with every thread of
// the block, then __syncthreads().
__device__ __forceinline__ void load_vlc_tables(
    uint32_t* s_ac, uint32_t* s_dcc, const int32_t* ac_code, const int32_t* ac_len,
    const int32_t* dc_code, const int32_t* dc_len, int tid, int nthreads) {
  for (int i = tid; i < kAcRuns * kAcLevels; i += nthreads)
    s_ac[i] = (uint32_t)ac_code[i] | ((uint32_t)ac_len[i] << 16);
  for (int i = tid; i < 2 * kDcSizes; i += nthreads)
    s_dcc[i] = (uint32_t)dc_code[i] | ((uint32_t)dc_len[i] << 16);
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

// The DC slot of a correct-mode block (ops/vlc_device.py::
// block_streams_correct64, slot 0): dct_dc_size VLC and the differential
// bits of dc - pred (|diff| capped at 255 for the size, as the twin does),
// with the macroblock header '11' in front where comp == 0.
__device__ __forceinline__ uint32_t emit_dc(int dc, int pred, int comp, const uint32_t* s_dcc,
                                            int& len) {
  const int diff = dc - pred;
  const int sz = 32 - __clz(min(abs(diff), 255));
  const uint32_t dbits = (uint32_t)(diff >= 0 ? diff : diff + (1 << sz) - 1) & ((1u << sz) - 1u);
  const uint32_t sc = s_dcc[(comp < 4 ? kDcSizes : 0) + sz];
  uint32_t code = sz > 0 ? ((sc & 0xFFFFu) << sz) | dbits : (sc & 0xFFFFu);
  len = (int)(sc >> 16) + sz;
  if (comp == 0) {  // macroblock header '11'
    code |= 3u << len;
    len += 2;
  }
  return code;
}

// The four fused-slot outputs and their lengths, each (rows, NB * 16)
// int32 in stream order.
struct FusedOut {
  int32_t* v0;
  int32_t* v1;
  int32_t* v2;
  int32_t* v3;
  int32_t* len;
};

// Exact 4:1 fusion (ops/bitpack.py::fuse4) of four slots of <= 30 bits:
// the codes concatenated, <= 120 bits, as four 32-bit words v (most
// significant first).  Returns the length.
__device__ __forceinline__ int fuse4_value(const uint32_t c[4], const int l[4], uint32_t v[4]) {
  const uint64_t a = ((uint64_t)c[0] << l[1]) | c[1];
  const uint64_t bb = ((uint64_t)c[2] << l[3]) | c[3];
  const int lb = l[2] + l[3];  // <= 60
  const uint64_t vlo = (a << lb) | bb;
  const uint64_t vhi = lb > 0 ? a >> (64 - lb) : 0;
  v[0] = (uint32_t)(vhi >> 32);
  v[1] = (uint32_t)vhi;
  v[2] = (uint32_t)(vlo >> 32);
  v[3] = (uint32_t)vlo;
  return l[0] + l[1] + l[2] + l[3];
}

// The fused value of four slots stored at fused slot o.
__device__ __forceinline__ void store_fused4(const uint32_t c[4], const int l[4],
                                             const FusedOut& out, size_t o) {
  uint32_t v[4];
  out.len[o] = fuse4_value(c, l, v);
  out.v0[o] = (int32_t)v[0];
  out.v1[o] = (int32_t)v[1];
  out.v2[o] = (int32_t)v[2];
  out.v3[o] = (int32_t)v[3];
}

// Slots 4j .. 4j+3 of one correct-mode block, emitted in order into c and
// l (`run` carries the zero run across calls).  `levels(j, lv)` gives
// their zigzag levels (slot 0's value is not read: code0/len0 are the DC
// slot).  EOB '10' folds into slot 63.
template <class Levels>
__device__ __forceinline__ void emit_four_slots(const Levels& levels, int j, uint32_t code0,
                                                int len0, const uint32_t* s_ac, int& run,
                                                uint32_t c[4], int l[4]) {
  int lv[4];
  levels(j, lv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * j + i;
    if (k == 0) {
      c[i] = code0;
      l[i] = len0;
      continue;
    }
    c[i] = emit_ac(lv[i], run, s_ac, l[i]);
    if (k == 63) {  // end of block '10'
      c[i] = (c[i] << 2) | 2u;
      l[i] += 2;
    }
  }
}

// ---- warp-cooperative 4:1 emission (B1, B3) --------------------------------
//
// One lane per fused slot: the 16 lanes of a half-warp emit one block, lane
// j its slots 4j .. 4j+3, so a warp emits two neighbouring blocks and each
// of its five stores writes 32 consecutive int32 (one 128-byte line) where
// a thread per block stores 4 B 64 B apart.  The zero run, the only thing
// that ties a block's slots together, comes from a ballot instead of a
// serial carry: slot k >= 1 with a nonzero level has run k - 1 - p, p the
// last nonzero slot before k (the DC, slot 0, counts as nonzero), which is
// what emit_ac's ++run / run = 0 computes, escapes included (runs up to 62).

// The zero run in front of slot 4j of the half-warp's block (lane = the
// lane in the warp, j = lane & 15; lv = levels 4j .. 4j+3).  Each lane
// finds its last nonzero slot; a ballot marks the lanes that have one, and
// the nearest such lane below j hands its slot over by a shuffle.  Call
// with all 32 lanes of the warp.
__device__ __forceinline__ int half_warp_run(const int lv[4], int lane) {
  const int j = lane & 15;
  int last = -1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lv[i] != 0 || 4 * j + i == 0) last = 4 * j + i;
  const unsigned have = __ballot_sync(0xFFFFFFFFu, last >= 0) >> (lane & 16);
  const unsigned below = have & ((1u << j) - 1u);  // lane 0 (the DC) is always in it
  const int src = (lane & 16) + (below ? 31 - __clz(below) : 0);
  const int prev = __shfl_sync(0xFFFFFFFFu, last, src);
  return j == 0 ? 0 : 4 * j - 1 - prev;
}

// Four levels held in registers, as a `levels` functor of emit_four_slots.
struct LaneLevels {
  const int* lv;
  __device__ __forceinline__ void operator()(int, int out[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = lv[i];
  }
};

// Fused slot j = lane & 15 of the half-warp's block: slots 4j .. 4j+3 of
// levels lv emitted (code0 / len0: the DC slot, read on lane j = 0 only),
// fused 4:1 and stored at fused slot o.  Call with all 32 lanes.
__device__ __forceinline__ void emit_fused4_lane(const int lv[4], int lane, uint32_t code0,
                                                 int len0, const uint32_t* s_ac,
                                                 const FusedOut& out, size_t o) {
  int run = half_warp_run(lv, lane);
  uint32_t c[4];
  int l[4];
  emit_four_slots(LaneLevels{lv}, lane & 15, code0, len0, s_ac, run, c, l);
  store_fused4(c, l, out, o);
}

// Exact 8:1 fusion (ops/bitpack.py::fuse8) of two 4:1-fused values: a
// (<= 128 bits) shifted above b (lb <= 128 bits), as eight 32-bit words w
// (most significant first).  a moves up by lb = 32 q + r bits over the
// words [0, a0, a1, a2, a3]; the r == 0 case needs its own branch (a
// shift by 32 is undefined).
__device__ __forceinline__ void fuse8_value(const uint32_t a[4], const uint32_t b[4], int lb,
                                            uint32_t w[8]) {
  const int q = lb >> 5, r = lb & 31;
  uint32_t f[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint32_t hi = i > 0 ? a[i - 1] : 0u;
    const uint32_t lo = i < 4 ? a[i] : 0u;
    f[i] = r ? (hi << r) | (lo >> (32 - r)) : hi;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t acc = 0u;
#pragma unroll
    for (int qq = 0; qq < 5; ++qq) {
      const int k = j + qq - 3;
      if (k >= 0 && k <= 4 && q == qq) acc = f[k];
    }
    w[j] = j >= 4 ? acc | b[j - 4] : acc;
  }
}

// ---- warp-cooperative 8:1 emission (B6b) --------------------------------
//
// B1's lanes, then a lane-pair fusion: lanes 2k and 2k+1 of a half-warp
// hold the 4:1 values of slots 8k .. 8k+3 and 8k+4 .. 8k+7, swap them with
// one exchange and both form fused-8 slot k.  The even lane stores words
// 0-3 and the length, the odd lane words 4-7: each store of the warp writes
// 16 consecutive int32 (two blocks of 8 fused slots) into each of two
// planes, whole 32-byte sectors.

// Fused-8 slot (lane & 15) >> 1 of the half-warp's block: emit_fused4_lane's
// emission, the pair exchange and the 8:1 fusion; word p of the value goes
// to out[p * plane + o], its length to out[8 * plane + o].  Call with all
// 32 lanes.
__device__ __forceinline__ void emit_fused8_lane(const int lv[4], int lane, uint32_t code0,
                                                 int len0, const uint32_t* s_ac, int32_t* out,
                                                 size_t plane, size_t o) {
  int run = half_warp_run(lv, lane);
  uint32_t c[4], v[4], p[4];
  int l[4];
  emit_four_slots(LaneLevels{lv}, lane & 15, code0, len0, s_ac, run, c, l);
  const int len = fuse4_value(c, l, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __shfl_xor_sync(0xFFFFFFFFu, v[i], 1);
  const int plen = __shfl_xor_sync(0xFFFFFFFFu, len, 1);
  const bool odd = lane & 1;  // the pair's second half: b, the lower bits
  uint32_t a[4], b[4], w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = odd ? p[i] : v[i];
    b[i] = odd ? v[i] : p[i];
  }
  fuse8_value(a, b, odd ? len : plen, w);
  int32_t* const dst = out + (odd ? 4 * plane : 0) + o;
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i * plane] = (int32_t)(odd ? w[4 + i] : w[i]);
  if (!odd) out[8 * plane + o] = len + plen;
}

// ---- raw slots (B6a) -------------------------------------------------------
//
// A slot's code and length in one 32-bit word, the length as a marker bit
// above the code: code | 1 << len.  Exact because the emission never sets
// a code bit at or above the slot's length and no slot is longer than 30
// bits (a 28-bit escape with the EOB).  B6a parks a block's 64 slots so in
// the shared words that held its levels, then stores them slot-major.
__device__ __forceinline__ uint32_t slot_word(uint32_t code, int len) {
  return code | (1u << len);
}

__device__ __forceinline__ int slot_word_len(uint32_t word) { return 31 - __clz(word); }

}  // namespace vlc
