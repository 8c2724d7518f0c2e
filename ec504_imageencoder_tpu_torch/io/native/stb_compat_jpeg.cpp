// Native JPEG decoder with stb_image-compatible output semantics.
//
// The reference encoder ingests JPEGs through the vendored stb_image
// (reference include/stb_image.h), and bit-exact compat output requires
// pixel-identical decode.  JPEG decoding is only *coefficient*-exact
// across implementations; IDCT, chroma upsampling and YCbCr->RGB rounding
// are implementation-defined, so this decoder implements the same
// published algorithms stb uses with matching fixed-point semantics:
//   * entropy decode per ISO/IEC 10918-1 (baseline + progressive,
//     successive approximation, restart markers),
//   * dequantized coefficients truncated through int16 (stb_image.h:2227),
//   * the libjpeg "islow" integer IDCT (jidctint-derived; column pass
//     +512 >>10, row pass +65536+(128<<17) >>17, stb_image.h:2430-2523),
//   * JFIF-centered triangular 2x chroma upsampling with >>2 / >>4
//     truncating descales (stb_image.h:3454-3527),
//   * 20-bit fixed-point YCbCr->RGB with the green-channel
//     "& 0xffff0000" truncation quirk (stb_image.h:3659-3683).
//
// Validated byte-for-byte against stb decodes of the reference fixtures.
// This is an original implementation — structure and code are not derived
// from stb; only observable numeric behavior is matched.
//
// Build: io/_native.py compiles it with g++ at first use (libstbjpeg_<hash>.so).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// scan position -> natural (row-major) index
constexpr uint8_t kZigzagNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kFastBits = 9;  // first-level LUT covers code lens 1..9

struct Huffman {
  // canonical decode state per code length 1..16
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t values[256];
  // single-probe fast path: top kFastBits of the bit buffer -> (value,
  // length) for codes of length <= kFastBits, 0 length = slow path.
  // JPEG Huffman tables put the overwhelming majority of symbol mass in
  // short codes, so this removes the per-bit canonical walk from the
  // entropy-decode hot loop (the one inherently serial stage).
  uint8_t fast_val[1 << kFastBits];
  uint8_t fast_len[1 << kFastBits];
  bool present = false;

  void build(const uint8_t counts[16], const uint8_t *vals, int nvals) {
    std::memcpy(values, vals, nvals);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      valptr[len] = k;
      mincode[len] = code;
      code += counts[len - 1];
      k += counts[len - 1];
      maxcode[len] = code - 1;
      if (counts[len - 1] == 0) maxcode[len] = -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(fast_len, 0, sizeof fast_len);
    code = 0;
    k = 0;
    for (int len = 1; len <= kFastBits; len++) {
      for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
        int lo = code << (kFastBits - len);
        int hi = lo + (1 << (kFastBits - len));
        for (int e = lo; e < hi; e++) {
          fast_val[e] = values[k];
          fast_len[e] = uint8_t(len);
        }
      }
      code <<= 1;
    }
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int x = 0, y = 0;        // actual sample dimensions
  int w2 = 0, h2 = 0;      // MCU-aligned buffer dimensions
  int bw = 0, bh = 0;      // coefficient blocks (w2/8, h2/8)
  std::vector<int16_t> coeff;   // bw*bh blocks of 64, block-row-major
  std::vector<uint8_t> pixels;  // w2 * h2 after IDCT
  int dc_pred = 0;
};

class Decoder {
 public:
  // stop stages for the hybrid host/device pipeline: COEFFS ends after
  // entropy decode (+ dequantization), PLANES after the IDCT (per-
  // component YCbCr pixel planes, no resample/color), FULL is the
  // original interleaved-RGB decode.
  enum Stage { COEFFS = 0, PLANES = 1, FULL = 2 };
  bool decode(const uint8_t *data, size_t len, Stage stage = FULL);
  bool probe(const uint8_t *data, size_t len);  // parse through SOF only
  int width() const { return img_w_; }
  int height() const { return img_h_; }
  int channels() const { return ncomp_ >= 3 ? 3 : 1; }
  int ncomp() const { return ncomp_; }
  // entropy-coded segments decoded: one a scan, one more a restart marker
  int segments() const { return segments_; }
  int comp_w(int k) const { return comp_[k].x; }
  int comp_h(int k) const { return comp_[k].y; }
  int comp_stride(int k) const { return comp_[k].w2; }
  int comp_hs(int k) const { return comp_[k].h; }
  int comp_vs(int k) const { return comp_[k].v; }
  const uint8_t *comp_pixels(int k) const { return comp_[k].pixels.data(); }
  // dequantized int16 coefficients, block-row-major over the full
  // MCU-aligned (bw x bh) grid, 64 natural-order values per block
  const int16_t *comp_coeffs(int k) const { return comp_[k].coeff.data(); }
  int comp_bw(int k) const { return (comp_[k].x + 7) / 8; }
  int comp_bh(int k) const { return (comp_[k].y + 7) / 8; }
  int comp_bstride(int k) const { return comp_[k].bw; }
  std::vector<uint8_t> output;

 private:
  const uint8_t *p_ = nullptr, *end_ = nullptr;
  int img_w_ = 0, img_h_ = 0, ncomp_ = 0;
  bool progressive_ = false;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  uint16_t quant_[4][64] = {};
  Huffman huff_dc_[4], huff_ac_[4];
  Component comp_[4];
  int restart_interval_ = 0;
  int segments_ = 0;

  // entropy state
  uint32_t bitbuf_ = 0;
  int bitcnt_ = 0;
  int pending_marker_ = 0;
  int eobrun_ = 0;

  bool fail(const char *why) {
    std::fprintf(stderr, "stbjpeg: %s\n", why);
    return false;
  }
  int u8() { return p_ < end_ ? *p_++ : 0; }
  int u16() { int a = u8(); return (a << 8) | u8(); }

  void reset_entropy() {
    bitbuf_ = 0;
    bitcnt_ = 0;
    pending_marker_ = 0;
    eobrun_ = 0;
    for (auto &c : comp_) c.dc_pred = 0;
  }

  void fill_bits() {
    while (bitcnt_ <= 24) {
      int b;
      if (pending_marker_ || p_ >= end_) {
        b = 0;  // feed zeros once a marker/EOF is hit
      } else {
        b = *p_++;
        if (b == 0xFF) {
          int m = p_ < end_ ? *p_ : 0xD9;
          if (m == 0x00) {
            p_++;  // stuffed byte
          } else {
            pending_marker_ = m;
            p_--;  // leave the marker for the caller
            b = 0;
          }
        }
      }
      bitbuf_ |= uint32_t(b) << (24 - bitcnt_);
      bitcnt_ += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (bitcnt_ < n) fill_bits();
    int v = int(bitbuf_ >> (32 - n));
    bitbuf_ <<= n;
    bitcnt_ -= n;
    return v;
  }
  int get_bit() { return get_bits(1); }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  int decode_huff(const Huffman &h) {
    if (bitcnt_ < 16) fill_bits();
    int look = int(bitbuf_ >> (32 - kFastBits));
    int fl = h.fast_len[look];
    if (fl) {
      bitbuf_ <<= fl;
      bitcnt_ -= fl;
      return h.fast_val[look];
    }
    int code = 0;
    for (int len = 1; len <= 16; len++) {
      code = (code << 1) | int(bitbuf_ >> 31);
      bitbuf_ <<= 1;
      bitcnt_--;
      if (len > kFastBits &&
          h.maxcode[len] >= code && code >= h.mincode[len]) {
        return h.values[h.valptr[len] + code - h.mincode[len]];
      }
    }
    return -1;
  }

  bool parse_dqt(int seglen);
  bool parse_dht(int seglen);
  bool parse_sof(bool prog);
  bool parse_sos();
  bool decode_scan(const int *ids, int ns, int ss, int se, int ah, int al);
  bool decode_block_baseline(Component &c, int16_t *blk);
  bool dc_first(Component &c, int16_t *blk, int al);
  void dc_refine(int16_t *blk, int al);
  bool ac_first(Component &c, int16_t *blk, int ss, int se, int al);
  bool ac_refine(Component &c, int16_t *blk, int ss, int se, int al);
  bool handle_restart();
  void dequantize_blocks();
  void finish_blocks();
  void resample_color();
};

// ---------------------------------------------------------------------------
// marker parsing

bool Decoder::parse_dqt(int seglen) {
  int remain = seglen - 2;
  while (remain > 0) {
    int pq_tq = u8();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3) return fail("bad DQT id");
    for (int i = 0; i < 64; i++)
      quant_[tq][kZigzagNat[i]] = uint16_t(pq ? u16() : u8());
    remain -= 1 + 64 * (pq ? 2 : 1);
  }
  return true;
}

bool Decoder::parse_dht(int seglen) {
  int remain = seglen - 2;
  while (remain > 0) {
    int tc_th = u8();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) return fail("bad DHT id");
    uint8_t counts[16];
    int total = 0;
    for (int i = 0; i < 16; i++) {
      counts[i] = uint8_t(u8());
      total += counts[i];
    }
    if (total > 256) return fail("bad DHT count");
    uint8_t vals[256];
    for (int i = 0; i < total; i++) vals[i] = uint8_t(u8());
    (tc ? huff_ac_ : huff_dc_)[th].build(counts, vals, total);
    remain -= 17 + total;
  }
  return true;
}

bool Decoder::parse_sof(bool prog) {
  progressive_ = prog;
  u16();  // length
  if (u8() != 8) return fail("only 8-bit precision supported");
  img_h_ = u16();
  img_w_ = u16();
  ncomp_ = u8();
  if (img_w_ <= 0 || img_h_ <= 0) return fail("bad dimensions");
  if (ncomp_ != 1 && ncomp_ != 3) return fail("unsupported component count");
  hmax_ = vmax_ = 1;
  for (int i = 0; i < ncomp_; i++) {
    Component &c = comp_[i];
    c.id = u8();
    int hv = u8();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = u8();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return fail("bad sampling");
    if (c.h > hmax_) hmax_ = c.h;
    if (c.v > vmax_) vmax_ = c.v;
  }
  mcux_ = (img_w_ + hmax_ * 8 - 1) / (hmax_ * 8);
  mcuy_ = (img_h_ + vmax_ * 8 - 1) / (vmax_ * 8);
  for (int i = 0; i < ncomp_; i++) {
    Component &c = comp_[i];
    c.x = (img_w_ * c.h + hmax_ - 1) / hmax_;
    c.y = (img_h_ * c.v + vmax_ - 1) / vmax_;
    c.w2 = mcux_ * c.h * 8;
    c.h2 = mcuy_ * c.v * 8;
    c.bw = c.w2 / 8;
    c.bh = c.h2 / 8;
    c.coeff.assign(size_t(c.bw) * c.bh * 64, 0);
    c.pixels.assign(size_t(c.w2) * c.h2, 0);
  }
  return true;
}

bool Decoder::handle_restart() {
  // skip to the RSTn marker that must follow, then reset entropy state
  bitbuf_ = 0;
  bitcnt_ = 0;
  if (!pending_marker_) {
    // search forward for a marker
    while (p_ + 1 < end_) {
      if (p_[0] == 0xFF && p_[1] != 0x00) {
        pending_marker_ = p_[1];
        break;
      }
      p_++;
    }
  }
  if (pending_marker_ >= 0xD0 && pending_marker_ <= 0xD7) {
    p_ += 2;  // consume FF Dn
    pending_marker_ = 0;
    segments_++;
    eobrun_ = 0;
    for (auto &c : comp_) c.dc_pred = 0;
  }
  // a non-RST marker here means the scan is over (the final restart
  // interval has no trailing RST) — leave it for the marker loop
  return true;
}

// ---------------------------------------------------------------------------
// block decoding

bool Decoder::decode_block_baseline(Component &c, int16_t *blk) {
  const Huffman &hd = huff_dc_[c.dc_tbl];
  const Huffman &ha = huff_ac_[c.ac_tbl];
  int s = decode_huff(hd);
  if (s < 0 || s > 11) return fail("bad DC code");
  int diff = s ? extend(get_bits(s), s) : 0;
  c.dc_pred += diff;
  const uint16_t *q = quant_[c.tq];
  blk[0] = int16_t(c.dc_pred * q[0]);
  int k = 1;
  while (k < 64) {
    int rs = decode_huff(ha);
    if (rs < 0) return fail("bad AC code");
    int r = rs >> 4;
    s = rs & 15;
    if (s == 0) {
      if (r != 15) break;  // EOB
      k += 16;
    } else {
      k += r;
      if (k > 63) return fail("AC overflow");
      int nat = kZigzagNat[k];
      blk[nat] = int16_t(extend(get_bits(s), s) * q[nat]);
      k++;
    }
  }
  return true;
}

bool Decoder::dc_first(Component &c, int16_t *blk, int al) {
  int s = decode_huff(huff_dc_[c.dc_tbl]);
  if (s < 0 || s > 11) return fail("bad DC code");
  int diff = s ? extend(get_bits(s), s) : 0;
  c.dc_pred += diff;
  blk[0] = int16_t(c.dc_pred * (1 << al));
  return true;
}

void Decoder::dc_refine(int16_t *blk, int al) {
  if (get_bit()) blk[0] = int16_t(blk[0] | (1 << al));
}

bool Decoder::ac_first(Component &c, int16_t *blk, int ss, int se, int al) {
  if (eobrun_ > 0) {
    eobrun_--;
    return true;
  }
  int k = ss;
  while (k <= se) {
    int rs = decode_huff(huff_ac_[c.ac_tbl]);
    if (rs < 0) return fail("bad AC code");
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r < 15) {
        eobrun_ = (1 << r) - 1;
        if (r) eobrun_ += get_bits(r);
        break;
      }
      k += 16;
    } else {
      k += r;
      if (k > 63) return fail("AC overflow");
      blk[kZigzagNat[k]] = int16_t(extend(get_bits(s), s) * (1 << al));
      k++;
    }
  }
  return true;
}

bool Decoder::ac_refine(Component &c, int16_t *blk, int ss, int se, int al) {
  int bit = 1 << al;
  int k = ss;
  if (eobrun_ == 0) {
    while (k <= se) {
      int rs = decode_huff(huff_ac_[c.ac_tbl]);
      if (rs < 0) return fail("bad AC code");
      int r = rs >> 4, s = rs & 15;
      int newval = 0;
      if (s == 0) {
        if (r < 15) {
          eobrun_ = (1 << r);
          if (r) eobrun_ += get_bits(r);
          break;
        }
        // r == 15: skip 16 zero-history coefficients
      } else {
        if (s != 1) return fail("bad refinement size");
        newval = get_bit() ? bit : -bit;
      }
      while (k <= se) {
        int16_t &cf = blk[kZigzagNat[k]];
        if (cf != 0) {
          if (get_bit() && (cf & bit) == 0)
            cf = int16_t(cf + (cf > 0 ? bit : -bit));
        } else {
          if (r == 0) {
            if (newval) cf = int16_t(newval);
            k++;
            break;
          }
          r--;
        }
        k++;
      }
    }
  }
  if (eobrun_ > 0) {
    eobrun_--;
    for (; k <= se; k++) {
      int16_t &cf = blk[kZigzagNat[k]];
      if (cf != 0 && get_bit() && (cf & bit) == 0)
        cf = int16_t(cf + (cf > 0 ? bit : -bit));
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// scans

bool Decoder::parse_sos() {
  u16();  // length
  int ns = u8();
  int ids[4] = {};
  for (int i = 0; i < ns; i++) {
    int cs = u8();
    int td_ta = u8();
    int found = -1;
    for (int k = 0; k < ncomp_; k++)
      if (comp_[k].id == cs) found = k;
    if (found < 0) return fail("unknown scan component");
    comp_[found].dc_tbl = td_ta >> 4;
    comp_[found].ac_tbl = td_ta & 15;
    ids[i] = found;
  }
  int ss = u8();
  int se = u8();
  int a = u8();
  return decode_scan(ids, ns, ss, se, a >> 4, a & 15);
}

bool Decoder::decode_scan(const int *ids, int ns, int ss, int se, int ah, int al) {
  reset_entropy();
  segments_++;
  int todo = restart_interval_ ? restart_interval_ : 0x7fffffff;

  auto maybe_restart = [&]() -> bool {
    if (restart_interval_ && --todo == 0) {
      if (!handle_restart()) return false;
      todo = restart_interval_;
    }
    return true;
  };

  if (ns == 1) {
    Component &c = comp_[ids[0]];
    int cbw = (c.x + 7) / 8, cbh = (c.y + 7) / 8;
    for (int j = 0; j < cbh; j++) {
      for (int i = 0; i < cbw; i++) {
        int16_t *blk = &c.coeff[size_t(j * c.bw + i) * 64];
        if (!progressive_) {
          // sequential single-component scan (rare); decode directly
          std::vector<int16_t> tmp(64, 0);
          if (!decode_block_baseline(c, tmp.data())) return false;
          std::memcpy(blk, tmp.data(), 128);
        } else if (ss == 0) {
          if (ah == 0) {
            if (!dc_first(c, blk, al)) return false;
          } else {
            dc_refine(blk, al);
          }
        } else {
          if (ah == 0) {
            if (!ac_first(c, blk, ss, se, al)) return false;
          } else {
            if (!ac_refine(c, blk, ss, se, al)) return false;
          }
        }
        if (!maybe_restart()) return false;
      }
    }
    return true;
  }

  // interleaved scan: full MCUs
  for (int my = 0; my < mcuy_; my++) {
    for (int mx = 0; mx < mcux_; mx++) {
      for (int s = 0; s < ns; s++) {
        Component &c = comp_[ids[s]];
        for (int v = 0; v < c.v; v++) {
          for (int h = 0; h < c.h; h++) {
            int bx = mx * c.h + h, by = my * c.v + v;
            int16_t *blk = &c.coeff[size_t(by * c.bw + bx) * 64];
            if (!progressive_) {
              if (!decode_block_baseline(c, blk)) return false;
            } else {
              // interleaved progressive scans are DC-only
              if (ah == 0) {
                if (!dc_first(c, blk, al)) return false;
              } else {
                dc_refine(blk, al);
              }
            }
          }
        }
      }
      if (!maybe_restart()) return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// IDCT (jidctint "islow" semantics at stb's fixed-point scales)

inline int f2f(double x) { return int(x * 4096 + 0.5); }

void idct_1d(int s0, int s1, int s2, int s3, int s4, int s5, int s6, int s7,
             int &x0, int &x1, int &x2, int &x3,
             int &t0, int &t1, int &t2, int &t3) {
  int p1 = (s2 + s6) * f2f(0.5411961);
  int u2 = p1 + s6 * f2f(-1.847759065);
  int u3 = p1 + s2 * f2f(0.765366865);
  int ev0 = (s0 + s4) * 4096;
  int ev1 = (s0 - s4) * 4096;
  x0 = ev0 + u3;
  x3 = ev0 - u3;
  x1 = ev1 + u2;
  x2 = ev1 - u2;
  int a0 = s7, a1 = s5, a2 = s3, a3 = s1;
  int q3 = a0 + a2;
  int q4 = a1 + a3;
  int q1 = a0 + a3;
  int q2 = a1 + a2;
  int q5 = (q3 + q4) * f2f(1.175875602);
  t0 = a0 * f2f(0.298631336);
  t1 = a1 * f2f(2.053119869);
  t2 = a2 * f2f(3.072711026);
  t3 = a3 * f2f(1.501321110);
  q1 = q5 + q1 * f2f(-0.899976223);
  q2 = q5 + q2 * f2f(-2.562915447);
  q3 = q3 * f2f(-1.961570560);
  q4 = q4 * f2f(-0.390180644);
  t3 += q1 + q4;
  t2 += q2 + q3;
  t1 += q2 + q4;
  t0 += q1 + q3;
}

uint8_t clamp_u8(int x) {
  if (unsigned(x) > 255) return x < 0 ? 0 : 255;
  return uint8_t(x);
}

void idct_block(uint8_t *out, int stride, const int16_t *d) {
  int val[64];
  for (int i = 0; i < 8; i++) {
    const int16_t *col = d + i;
    int *v = val + i;
    if (!(col[8] | col[16] | col[24] | col[32] | col[40] | col[48] | col[56])) {
      int dc = col[0] * 4;
      for (int k = 0; k < 8; k++) v[k * 8] = dc;
    } else {
      int x0, x1, x2, x3, t0, t1, t2, t3;
      idct_1d(col[0], col[8], col[16], col[24], col[32], col[40], col[48],
              col[56], x0, x1, x2, x3, t0, t1, t2, t3);
      x0 += 512; x1 += 512; x2 += 512; x3 += 512;
      v[0] = (x0 + t3) >> 10;
      v[56] = (x0 - t3) >> 10;
      v[8] = (x1 + t2) >> 10;
      v[48] = (x1 - t2) >> 10;
      v[16] = (x2 + t1) >> 10;
      v[40] = (x2 - t1) >> 10;
      v[24] = (x3 + t0) >> 10;
      v[32] = (x3 - t0) >> 10;
    }
  }
  for (int i = 0; i < 8; i++) {
    const int *r = val + i * 8;
    uint8_t *o = out + i * stride;
    int x0, x1, x2, x3, t0, t1, t2, t3;
    idct_1d(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
            x0, x1, x2, x3, t0, t1, t2, t3);
    const int bias = 65536 + (128 << 17);
    x0 += bias; x1 += bias; x2 += bias; x3 += bias;
    o[0] = clamp_u8((x0 + t3) >> 17);
    o[7] = clamp_u8((x0 - t3) >> 17);
    o[1] = clamp_u8((x1 + t2) >> 17);
    o[6] = clamp_u8((x1 - t2) >> 17);
    o[2] = clamp_u8((x2 + t1) >> 17);
    o[5] = clamp_u8((x2 - t1) >> 17);
    o[3] = clamp_u8((x3 + t0) >> 17);
    o[4] = clamp_u8((x3 - t0) >> 17);
  }
}

void Decoder::dequantize_blocks() {
  // COEFFS stage: leave coefficients dequantized in place (baseline
  // blocks already are — decode_block_baseline multiplies during decode;
  // progressive blocks carry raw levels until now, stb_image.h:2227
  // semantics: products truncated through int16)
  if (!progressive_) return;
  for (int k = 0; k < ncomp_; k++) {
    Component &c = comp_[k];
    const uint16_t *q = quant_[c.tq];
    int cbw = (c.x + 7) / 8, cbh = (c.y + 7) / 8;
    for (int j = 0; j < cbh; j++) {
      for (int i = 0; i < cbw; i++) {
        int16_t *blk = &c.coeff[size_t(j * c.bw + i) * 64];
        for (int t = 0; t < 64; t++) blk[t] = int16_t(blk[t] * q[t]);
      }
    }
  }
}

void Decoder::finish_blocks() {
  for (int k = 0; k < ncomp_; k++) {
    Component &c = comp_[k];
    const uint16_t *q = quant_[c.tq];
    int cbw = (c.x + 7) / 8, cbh = (c.y + 7) / 8;
    for (int j = 0; j < cbh; j++) {
      for (int i = 0; i < cbw; i++) {
        int16_t *blk = &c.coeff[size_t(j * c.bw + i) * 64];
        int16_t dq[64];
        if (progressive_) {
          for (int t = 0; t < 64; t++) dq[t] = int16_t(blk[t] * q[t]);
        } else {
          std::memcpy(dq, blk, sizeof dq);  // already dequantized
        }
        idct_block(&c.pixels[size_t(j * 8) * c.w2 + i * 8], c.w2, dq);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// resample + color (stb's jfif-centered triangular filters, truncating)

inline uint8_t div4(int x) { return uint8_t(x >> 2); }
inline uint8_t div16(int x) { return uint8_t(x >> 4); }

void resample_hv2(uint8_t *out, const uint8_t *near, const uint8_t *far, int w) {
  if (w == 1) {
    out[0] = out[1] = div4(3 * near[0] + far[0] + 2);
    return;
  }
  int t1 = 3 * near[0] + far[0];
  out[0] = div4(t1 + 2);
  for (int i = 1; i < w; i++) {
    int t0 = t1;
    t1 = 3 * near[i] + far[i];
    out[i * 2 - 1] = div16(3 * t0 + t1 + 8);
    out[i * 2] = div16(3 * t1 + t0 + 8);
  }
  out[w * 2 - 1] = div4(t1 + 2);
}

void resample_v2(uint8_t *out, const uint8_t *near, const uint8_t *far, int w) {
  for (int i = 0; i < w; i++) out[i] = div4(3 * near[i] + far[i] + 2);
}

void resample_h2(uint8_t *out, const uint8_t *in, int w) {
  if (w == 1) {
    out[0] = out[1] = in[0];
    return;
  }
  out[0] = in[0];
  out[1] = div4(in[0] * 3 + in[1] + 2);
  int i;
  for (i = 1; i < w - 1; i++) {
    int n = 3 * in[i] + 2;
    out[i * 2] = div4(n + in[i - 1]);
    out[i * 2 + 1] = div4(n + in[i + 1]);
  }
  out[i * 2] = div4(in[w - 2] * 3 + in[w - 1] + 2);
  out[i * 2 + 1] = in[w - 1];
}

inline int fx(double v) { return (int(v * 4096.0 + 0.5)) << 8; }

void ycbcr_row(uint8_t *out, const uint8_t *y, const uint8_t *cbp,
               const uint8_t *crp, int count, int step) {
  for (int i = 0; i < count; i++) {
    int yf = (y[i] << 20) + (1 << 19);
    int cr = crp[i] - 128;
    int cb = cbp[i] - 128;
    int r = yf + cr * fx(1.40200);
    int g = yf + cr * -fx(0.71414) + ((cb * -fx(0.34414)) & 0xffff0000);
    int b = yf + cb * fx(1.77200);
    out[0] = clamp_u8(r >> 20);
    out[1] = clamp_u8(g >> 20);
    out[2] = clamp_u8(b >> 20);
    out += step;
  }
}

void Decoder::resample_color() {
  int n = channels();
  output.assign(size_t(img_w_) * img_h_ * n, 0);

  struct Line {
    const uint8_t *l0, *l1;
    int hs, vs, ystep, ypos, wlo;
  } rs[4];
  std::vector<std::vector<uint8_t>> linebuf(ncomp_);
  const uint8_t *rows[4] = {};

  for (int k = 0; k < ncomp_; k++) {
    Component &c = comp_[k];
    Line &r = rs[k];
    r.hs = hmax_ / c.h;
    r.vs = vmax_ / c.v;
    r.ystep = r.vs >> 1;
    r.wlo = (img_w_ + r.hs - 1) / r.hs;
    r.ypos = 0;
    r.l0 = r.l1 = c.pixels.data();
    linebuf[k].assign(img_w_ + 3, 0);
  }

  for (int j = 0; j < img_h_; j++) {
    uint8_t *out = output.data() + size_t(n) * img_w_ * j;
    for (int k = 0; k < ncomp_; k++) {
      Component &c = comp_[k];
      Line &r = rs[k];
      bool ybot = r.ystep >= (r.vs >> 1);
      const uint8_t *near = ybot ? r.l1 : r.l0;
      const uint8_t *far = ybot ? r.l0 : r.l1;
      uint8_t *lb = linebuf[k].data();
      if (r.hs == 1 && r.vs == 1) {
        rows[k] = near;
      } else if (r.hs == 1 && r.vs == 2) {
        resample_v2(lb, near, far, r.wlo);
        rows[k] = lb;
      } else if (r.hs == 2 && r.vs == 1) {
        resample_h2(lb, near, r.wlo);
        rows[k] = lb;
      } else if (r.hs == 2 && r.vs == 2) {
        resample_hv2(lb, near, far, r.wlo);
        rows[k] = lb;
      } else {
        // nearest-neighbour generic fallback (stb_image.h:3646)
        for (int i = 0; i < r.wlo; i++)
          for (int s = 0; s < r.hs; s++) lb[i * r.hs + s] = near[i];
        rows[k] = lb;
      }
      if (++r.ystep >= r.vs) {
        r.ystep = 0;
        r.l0 = r.l1;
        if (++r.ypos < c.y) r.l1 += c.w2;
      }
    }
    if (n >= 3) {
      ycbcr_row(out, rows[0], rows[1], rows[2], img_w_, n);
    } else {
      std::memcpy(out, rows[0], img_w_);
    }
  }
}

// ---------------------------------------------------------------------------

bool Decoder::probe(const uint8_t *data, size_t len) {
  p_ = data;
  end_ = data + len;
  if (u8() != 0xFF || u8() != 0xD8) return fail("not a JPEG (no SOI)");
  while (p_ < end_) {
    int m = u8();
    if (m != 0xFF) continue;
    while (m == 0xFF && p_ < end_) m = u8();
    switch (m) {
      case 0xC0:
      case 0xC1:
        return parse_sof(false);
      case 0xC2:
        return parse_sof(true);
      case 0xD9:
        return fail("no SOF before EOI");
      default:
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) break;
        p_ += u16() - 2;
        break;
    }
  }
  return fail("no SOF found");
}

bool Decoder::decode(const uint8_t *data, size_t len, Stage stage) {
  auto finish = [&]() {
    if (stage == COEFFS) {
      dequantize_blocks();
      return;
    }
    finish_blocks();
    if (stage == FULL) resample_color();
  };
  p_ = data;
  end_ = data + len;
  if (u8() != 0xFF || u8() != 0xD8) return fail("not a JPEG (no SOI)");
  bool have_sof = false;
  while (p_ < end_) {
    int m = u8();
    if (m != 0xFF) continue;  // tolerate fill bytes
    while (m == 0xFF && p_ < end_) m = u8();
    switch (m) {
      case 0xC0:
      case 0xC1:
        if (!parse_sof(false)) return false;
        have_sof = true;
        break;
      case 0xC2:
        if (!parse_sof(true)) return false;
        have_sof = true;
        break;
      case 0xC4:
        if (!parse_dht(u16())) return false;
        break;
      case 0xDB:
        if (!parse_dqt(u16())) return false;
        break;
      case 0xDD:
        u16();
        restart_interval_ = u16();
        break;
      case 0xDA:
        if (!have_sof) return fail("SOS before SOF");
        if (!parse_sos()) return false;
        // skip any trailing entropy bytes up to the next marker
        if (pending_marker_) { /* positioned at marker */ }
        break;
      case 0xD9:  // EOI
        finish();
        return true;
      case 0xC3:
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        return fail("unsupported SOF type");
      default:
        if (m >= 0xD0 && m <= 0xD7) break;  // stray RST
        if (m == 0x01) break;               // TEM
        p_ += u16() - 2;                    // skip segment
        break;
    }
  }
  if (have_sof) {  // missing EOI: decode what we have
    finish();
    return true;
  }
  return fail("no image data");
}

}  // namespace

extern "C" {

unsigned char *stbj_decode_mem(const unsigned char *data, long len, int *w,
                               int *h, int *comp) {
  Decoder d;
  if (!d.decode(data, size_t(len))) return nullptr;
  *w = d.width();
  *h = d.height();
  *comp = d.channels();
  auto *out = (unsigned char *)std::malloc(d.output.size());
  if (out) std::memcpy(out, d.output.data(), d.output.size());
  return out;
}

unsigned char *stbj_decode_file(const char *path, int *w, int *h, int *comp) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> buf(static_cast<size_t>(len), 0);
  if (std::fread(buf.data(), 1, size_t(len), f) != size_t(len)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  return stbj_decode_mem(buf.data(), len, w, h, comp);
}

void stbj_free(unsigned char *p) { std::free(p); }

}  // extern "C" (reopened below for the batch entry points)

// ---------------------------------------------------------------------------
// Batch decode from memory: the host-side intake of batched device
// encodes, and the one decode path of every batch (reference counterpart:
// stb's host-only pipeline, stb_image.h:2430-2523 + encoder.h:126-171).
// Callers that hold paths (io/jpeg.py) read each file into memory first,
// so frames from files and frames from memory take the same code.  The
// staged stages stop early for the hybrid host/device pipeline: after the
// inherently serial entropy decode, or after the IDCT.

namespace {

// Stage 0 and 1 need the expected 3-component layout: 3 unsupported
// layout (not 3-component, Y subsampled, or chroma dims other than the
// expected), 2 dimension mismatch.
int check_layout(const Decoder &d, int ew, int eh, int ecw, int ech) {
  if (d.ncomp() != 3) return 3;
  if (d.width() != ew || d.height() != eh) return 2;
  if (d.comp_w(0) != ew || d.comp_h(0) != eh) return 3;  // Y subsampled?!
  for (int k = 1; k < 3; k++)
    if (d.comp_w(k) != ecw || d.comp_h(k) != ech) return 3;
  return 0;
}

// Frame i of a batch into its slot of the outputs; -> its status.
int decode_one(const unsigned char *buf, long len, int stage, int ew, int eh,
               int ecw, int ech, void *out0, void *out1, void *out2,
               size_t i, int *segments) {
  Decoder d;
  if (!buf || len <= 0 ||
      !d.decode(buf, size_t(len), Decoder::Stage(stage)))
    return 1;
  segments[i] = d.segments();
  if (stage == Decoder::FULL) {
    if (d.width() != ew || d.height() != eh) return 2;
    const size_t frame_px = size_t(ew) * size_t(eh);
    unsigned char *dst = static_cast<unsigned char *>(out0) + i * frame_px * 3;
    const uint8_t *pix = d.output.data();
    if (d.channels() == 3) {
      std::memcpy(dst, pix, frame_px * 3);
    } else {  // grayscale -> RGB replicate
      for (size_t p = 0; p < frame_px; ++p)
        dst[p * 3] = dst[p * 3 + 1] = dst[p * 3 + 2] = pix[p];
    }
    return 0;
  }
  int rc = check_layout(d, ew, eh, ecw, ech);
  if (rc) return rc;
  void *outs[3] = {out0, out1, out2};
  for (int k = 0; k < 3; k++) {
    int kw = k ? ecw : ew, kh = k ? ech : eh;
    if (stage == Decoder::PLANES) {
      unsigned char *dst = static_cast<unsigned char *>(outs[k]) + i * size_t(kw) * kh;
      const uint8_t *src = d.comp_pixels(k);
      for (int r = 0; r < kh; r++)
        std::memcpy(dst + size_t(r) * kw, src + size_t(r) * d.comp_stride(k), kw);
    } else {
      int bw = d.comp_bw(k), bh = d.comp_bh(k), bstride = d.comp_bstride(k);
      int16_t *dst = static_cast<int16_t *>(outs[k]) + i * size_t(bw) * bh * 64;
      const int16_t *src = d.comp_coeffs(k);
      for (int r = 0; r < bh; r++)
        std::memcpy(dst + size_t(r) * bw * 64, src + size_t(r) * bstride * 64,
                    size_t(bw) * 64 * sizeof(int16_t));
    }
  }
  return 0;
}

}  // namespace

// Header-only probe of a JPEG in memory: image dims, component count, and
// the (cropped) chroma plane dims of component 1 (equal to comp 2 for all
// real JPEGs).  Returns 1 on success, 0 on failure.
extern "C" int stbj_probe_mem(const unsigned char *data, long len, int *w, int *h,
                              int *ncomp, int *cw, int *ch, int *hsamp, int *vsamp) {
  Decoder d;
  if (!data || len <= 0 || !d.probe(data, size_t(len))) return 0;
  *w = d.width();
  *h = d.height();
  *ncomp = d.ncomp();
  if (d.ncomp() >= 3) {
    *cw = d.comp_w(1);
    *ch = d.comp_h(1);
    *hsamp = d.comp_hs(0) / d.comp_hs(1);
    *vsamp = d.comp_vs(0) / d.comp_vs(1);
  } else {
    *cw = *ch = 0;
    *hsamp = *vsamp = 0;
  }
  return 1;
}

// Decodes the n JPEGs bufs[i] (lens[i] bytes) into the caller's contiguous
// outputs on a pool of worker threads (ctypes releases the GIL, so Python
// callers get real parallelism).  stage 0: dequantized int16 coefficient
// blocks, Y ceil(eh/8)*ceil(ew/8) blocks of 64 natural-order values in
// out0, Cb and Cr likewise at (ech, ecw) in out1 and out2; 1: the
// per-component YCbCr pixel planes after the IDCT (no resample or colour),
// Y (eh, ew) and Cb, Cr (ech, ecw) u8, exactly the 4:2:0 planes the MPEG
// encoder ingests; 2: (eh, ew, 3) u8 RGB in out0 (stb's upsampling and
// colour; grayscale replicated).  Per-frame status: 0 ok, 1 decode failure
// (the reference skips such a file, encoder.h:163-167), 2 dimension
// mismatch (the reference aborts, image_processing.c:48-66), 3 unsupported
// layout (stages 0 and 1).  segments[i]: the entropy-coded segments frame i
// held (one a scan, one more a restart marker).  Returns the worker
// threads used: n_threads, or one per hardware thread where it is <= 0,
// at most n.
extern "C" int stbj_decode_batch_mem(const unsigned char **bufs, const long *lens,
                                     int n, int stage, int ew, int eh, int ecw,
                                     int ech, void *out0, void *out1, void *out2,
                                     int *status, int *segments, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      segments[i] = 0;
      status[i] = decode_one(bufs[i], lens[i], stage, ew, eh, ecw, ech, out0,
                             out1, out2, size_t(i), segments);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(size_t(n_threads));
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto &th : pool) th.join();
  return n_threads;
}
