// JPEG decoder for the data loader: baseline and progressive Huffman
// JPEG, 8-bit, to uint8 RGB with libjpeg's (libjpeg-turbo's) arithmetic,
// so the pixels equal those of a libjpeg-based reader that asks for RGB
// with the library's defaults (ISLOW IDCT, fancy upsampling, block
// smoothing on):
//
//   * the IDCT is jidctint.c's jpeg_idct_islow (13 constant bits, 2
//     pass-1 bits, the post-IDCT range-limit table of jdmaster.c);
//   * chroma is upsampled by jdsample.c's h2v1_fancy_upsample and
//     h2v2_fancy_upsample (triangle filter, alternating rounding biases,
//     edges replicated; box replication where the downsampled width is
//     2 or less, as jinit_upsampler chooses);
//   * YCbCr -> RGB is jdcolor.c's fixed-point table conversion (16 scale
//     bits, ONE_HALF rounding);
//   * the colour space is guessed as default_decompress_parms guesses it
//     (JFIF -> YCbCr, Adobe APP14 transform 0 -> RGB, component ids).
//
// It reads 1 component (gray, returned in three equal channels) or 3
// components with each component's factors dividing the largest ones by
// 1x1, 2x1 or 2x2 (4:4:4, 4:2:2, 4:2:0); sequential (SOF0/SOF1) and
// progressive (SOF2) Huffman scans; restart intervals; any size.
// Everything else returns 1 with the feature named in `err`: arithmetic
// coding, 12-bit samples, lossless and hierarchical processes, 2 or 4
// components, other sampling factors, and progressive files whose scans
// leave the low AC coefficients unrefined (libjpeg block-smooths those).
// A corrupt or truncated file returns 2.
//
// No global state: concurrent calls from threads are independent (the
// ctypes wrapper releases the GIL for the call).
//
// Build: g++ -O3 -shared -fPIC jpeg_decode.cc -o libjpeg_decode.so
// (compiled at first use by visionllm_tpu_torch/kernels/host_build.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Failure {
  int code;
  std::string what;
};

[[noreturn]] void unsupported(const std::string& what) {
  throw Failure{kUnsupported, what};
}
[[noreturn]] void corrupt(const std::string& what) {
  throw Failure{kCorrupt, what};
}

// zigzag position -> natural (row-major) position, with libjpeg's 16
// trailing entries so a corrupt run past 63 lands on coefficient 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  int maxcode[18];   // largest code of each length, -1 if none
  int valoffset[17]; // index of a length's first value minus its code
  uint8_t vals[256];
  uint16_t fast[1 << 9];  // 9-bit lookahead: length << 8 | value, 0 = miss

  // Rejects a table as libjpeg's jpeg_make_d_derived_tbl does, before
  // any write: the codes of each length must fit in that many bits with
  // the all-ones code left free, and DC symbols must lie in 0..15.
  void build(const uint8_t* bits, const uint8_t* huffval, int nvals,
             bool is_dc) {
    for (int i = 0; is_dc && i < nvals; ++i)
      if (huffval[i] > 15) corrupt("bad Huffman table");
    for (int l = 1, code = 0; l <= 16; ++l) {
      code += bits[l - 1];
      if (code >= (1 << l)) corrupt("bad Huffman table");
      code <<= 1;
    }
    std::memcpy(vals, huffval, nvals);
    int code = 0, k = 0;
    std::memset(fast, 0, sizeof(fast));
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled width and height in samples
  int bw = 0, bh = 0;        // blocks a row and rows of blocks, MCU-padded
  int dc_tbl = 0, ac_tbl = 0;
  int dc_pred = 0;
  bool quant_latched = false;
  uint16_t quant[64];        // natural order, latched at the first scan
  int coef_bits[64];         // progressive: Al of each coefficient, -1 unseen
  std::vector<int16_t> coef; // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bw * 8) x (bh * 8) samples after the IDCT
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  void fill() {
    while (bits_ <= 56) {
      uint64_t b = 0;
      if (!marker_) {
        if (pos_ >= n_) corrupt("data ends inside an entropy-coded segment");
        b = d_[pos_];
        if (b == 0xFF) {
          size_t p = pos_ + 1;
          while (p < n_ && d_[p] == 0xFF) ++p;
          if (p >= n_) corrupt("data ends inside an entropy-coded segment");
          if (d_[p] == 0x00) {
            pos_ = p + 1;
          } else {  // a marker: feed zeros from here on, as libjpeg does
            marker_ = true;
            marker_pos_ = pos_;
            b = 0;
          }
        } else {
          ++pos_;
        }
      }
      buf_ |= b << (56 - bits_);
      bits_ += 8;
    }
  }

  int bits(int n) {  // n in 1..16
    if (bits_ < n) fill();
    int v = (int)(buf_ >> (64 - n));
    buf_ <<= n;
    bits_ -= n;
    return v;
  }

  int bit() { return bits(1); }

  int decode(const Huffman& t) {
    if (bits_ < 16) fill();
    int e = t.fast[buf_ >> (64 - 9)];
    if (e) {
      int l = e >> 8;
      buf_ <<= l;
      bits_ -= l;
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int code = (int)(buf_ >> (64 - l));
      if (code <= t.maxcode[l]) {
        buf_ <<= l;
        bits_ -= l;
        return t.vals[t.valoffset[l] + code];
      }
    }
    corrupt("bad Huffman code");
  }

  // The position of the marker that ends this segment.
  size_t marker_pos() {
    if (marker_) return marker_pos_;
    size_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 &&
                           d_[p + 1] != 0xFF))
      ++p;
    if (p + 1 >= n_) corrupt("data ends inside an entropy-coded segment");
    return p;
  }

  // Drop buffered bits and restart reading after the marker at `pos`.
  void restart(size_t pos) {
    pos_ = pos;
    buf_ = 0;
    bits_ = 0;
    marker_ = false;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t buf_ = 0;
  int bits_ = 0;
  bool marker_ = false;
  size_t marker_pos_ = 0;
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// IDCT: jidctint.c jpeg_idct_islow
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// jdmaster.c prepare_range_limit_table, the post-IDCT half: index by
// (x & 1023) where x is the descaled IDCT output before +128
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    tmp0 = (z2 + z3) * (1 << kConstBits);
    tmp1 = (z2 - z3) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, s);
    wp[56] = (int)descale(tmp10 - tmp3, s);
    wp[8] = (int)descale(tmp11 + tmp2, s);
    wp[48] = (int)descale(tmp11 - tmp2, s);
    wp[16] = (int)descale(tmp12 + tmp1, s);
    wp[40] = (int)descale(tmp12 - tmp1, s);
    wp[24] = (int)descale(tmp13 + tmp0, s);
    wp[32] = (int)descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, s) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, s) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, s) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, s) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, s) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, s) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, s) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, s) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  // Reads markers up to the frame header; fills width and height.
  void read_header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("no SOI marker");
    pos_ = 2;
    while (!frame_) {
      int m = next_marker();
      handle_marker(m);
    }
  }

  void decode(uint8_t* out) {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        read_scan();
        continue;
      }
      handle_marker(m);
    }
    if (!scans_) corrupt("no scan before EOI");
    if (progressive_) check_smoothing();
    for (auto& c : comps_) inverse_dct(c);
    to_rgb(out);
  }

  int width = 0, height = 0;

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  bool frame_ = false, progressive_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int scans_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];

  int u8(size_t p) {
    if (p >= n_) corrupt("data ends inside a marker segment");
    return d_[p];
  }
  int u16(size_t p) { return (u8(p) << 8) | u8(p + 1); }

  int next_marker() {
    // skip fill bytes and any garbage up to the next 0xFF xx (xx != 0)
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_) corrupt("data ends before EOI");
    return d_[pos_++];
  }

  // Reads the segment's length and returns [start, end) of its body.
  std::pair<size_t, size_t> segment() {
    int len = u16(pos_);
    if (len < 2 || pos_ + len > n_) corrupt("bad marker segment length");
    size_t start = pos_ + 2, end = pos_ + len;
    pos_ = end;
    return {start, end};
  }

  void handle_marker(int m) {
    if (m == 0xD8) corrupt("second SOI marker");
    if (m == 0xD9) corrupt("EOI before the frame header");
    if (m == 0xDA) corrupt("scan before the frame header");
    if (m >= 0xD0 && m <= 0xD7) return;  // stray RSTn: libjpeg ignores it
    if (m == 0x01) return;                // TEM
    auto [s, e] = segment();
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_frame(m, s, e);
        return;
      case 0xC3:
        unsupported("lossless coding (SOF3)");
      case 0xC5: case 0xC6: case 0xC7:
        unsupported("hierarchical coding (SOF" + std::to_string(m - 0xC0) +
                    ")");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        unsupported("arithmetic coding (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xCC:
        unsupported("arithmetic coding (DAC)");
      case 0xDE: case 0xDF:
        unsupported("hierarchical coding (DHP/EXP)");
      case 0xC4: read_dht(s, e); return;
      case 0xDB: read_dqt(s, e); return;
      case 0xDD:
        if (e - s < 2) corrupt("bad DRI");
        restart_interval_ = u16(s);
        return;
      case 0xE0:
        if (e - s >= 14 && std::memcmp(d_ + s, "JFIF\0", 5) == 0) jfif_ = true;
        return;
      case 0xEE:
        if (e - s >= 12 && std::memcmp(d_ + s, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[s + 11];
        }
        return;
      default:
        return;  // APPn, COM and others: skipped
    }
  }

  void read_frame(int m, size_t s, size_t e) {
    if (frame_) corrupt("second frame header");
    if (e - s < 6) corrupt("short frame header");
    int precision = u8(s);
    if (precision != 8)
      unsupported(std::to_string(precision) + "-bit samples");
    height = u16(s + 1);
    width = u16(s + 3);
    int nc = u8(s + 5);
    if (height == 0) unsupported("a height given by a DNL marker");
    if (width == 0) corrupt("zero width");
    if (nc == 4) unsupported("4 components (CMYK/YCCK)");
    if (nc != 1 && nc != 3)
      unsupported(std::to_string(nc) + " components");
    if (e - s < (size_t)(6 + 3 * nc)) corrupt("short frame header");
    progressive_ = m == 0xC2;
    comps_.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      c.id = u8(s + 6 + 3 * i);
      c.h = u8(s + 7 + 3 * i) >> 4;
      c.v = u8(s + 7 + 3 * i) & 15;
      c.tq = u8(s + 8 + 3 * i);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        corrupt("bad component in the frame header");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    if (nc == 3) {
      for (auto& c : comps_) {
        int hr = hmax_ % c.h ? 0 : hmax_ / c.h;
        int vr = vmax_ % c.v ? 0 : vmax_ / c.v;
        if (!((hr == 1 && vr == 1) || (hr == 2 && vr == 1) ||
              (hr == 2 && vr == 2))) {
          std::string f;
          for (auto& k : comps_)
            f += (f.empty() ? "" : ",") + std::to_string(k.h) + "x" +
                 std::to_string(k.v);
          unsupported("sampling factors " + f +
                      " (reads 4:4:4, 4:2:2 and 4:2:0)");
        }
      }
    }
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.dw = (int)(((int64_t)width * c.h + hmax_ - 1) / hmax_);
      c.dh = (int)(((int64_t)height * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    frame_ = true;
  }

  void read_dht(size_t s, size_t e) {
    while (s < e) {
      int tc = u8(s) >> 4, th = u8(s) & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT");
      if (s + 17 > e) corrupt("short DHT");
      uint8_t bits[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        bits[i] = (uint8_t)u8(s + 1 + i);
        total += bits[i];
      }
      if (total > 256 || s + 17 + total > e) corrupt("bad DHT");
      (tc ? ac_ : dc_)[th].build(bits, d_ + s + 17, total, tc == 0);
      s += 17 + total;
    }
  }

  void read_dqt(size_t s, size_t e) {
    while (s < e) {
      int pq = u8(s) >> 4, tq = u8(s) & 15;
      if (tq > 3 || pq > 1) corrupt("bad DQT");
      size_t len = 1 + 64 * (pq + 1);
      if (s + len > e) corrupt("short DQT");
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNatural[i]] =
            (uint16_t)(pq ? u16(s + 1 + 2 * i) : u8(s + 1 + i));
      qt_defined_[tq] = true;
      s += len;
    }
  }

  void read_scan() {
    if (!frame_) corrupt("scan before the frame header");
    auto [s, e] = segment();
    int ns = u8(s);
    if (ns < 1 || ns > 4 || e - s < (size_t)(4 + 2 * ns)) corrupt("bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(s + 1 + 2 * i), t = u8(s + 2 + 2 * i);
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == id) c = &k;
      if (!c) corrupt("scan names an unknown component");
      c->dc_tbl = t >> 4;
      c->ac_tbl = t & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) corrupt("bad table selector");
      sc.push_back(c);
    }
    int ss = u8(s + 1 + 2 * ns), se = u8(s + 2 + 2 * ns);
    int ah = u8(s + 3 + 2 * ns) >> 4, al = u8(s + 3 + 2 * ns) & 15;
    if (progressive_) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (bad || al > 13 || (ah && ah - 1 != al)) corrupt("bad progressive scan");
    } else if (ss != 0 || se != 63 || ah || al) {
      corrupt("bad sequential scan");
    }
    for (Component* c : sc) {
      if (!c->quant_latched) {
        if (!qt_defined_[c->tq]) corrupt("missing quantization table");
        std::memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      c->dc_pred = 0;
      if (progressive_) {
        for (int k = ss; k <= se; ++k) {
          if (ah && c->coef_bits[k] != ah) corrupt("bad refinement scan");
          c->coef_bits[k] = al;
        }
      }
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss != 0;
      if (need_dc && !dc_[c->dc_tbl].defined) corrupt("missing DC table");
      if (need_ac && !ac_[c->ac_tbl].defined) corrupt("missing AC table");
    }
    ++scans_;

    BitReader br(d_, n_, pos_);
    int mcus_x, mcus_y;
    if (sc.size() == 1) {
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = mcux_;
      mcus_y = mcuy_;
    }
    int total = mcus_x * mcus_y, eobrun = 0, todo = restart_interval_;
    int expect_rst = 0;
    for (int mcu = 0; mcu < total; ++mcu) {
      if (restart_interval_ && todo == 0) {
        size_t p = br.marker_pos();
        if (d_[p + 1] != 0xD0 + expect_rst)
          corrupt("missing restart marker");
        br.restart(p + 2);
        expect_rst = (expect_rst + 1) & 7;
        for (Component* c : sc) c->dc_pred = 0;
        eobrun = 0;
        todo = restart_interval_;
      }
      int my = mcu / mcus_x, mx = mcu % mcus_x;
      if (sc.size() == 1) {
        Component* c = sc[0];
        decode_block(br, *c, &c->coef[((size_t)my * c->bw + mx) * 64], ss, se,
                     ah, al, eobrun);
      } else {
        for (Component* c : sc)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h) {
              size_t b = (size_t)(my * c->v + v) * c->bw + mx * c->h + h;
              decode_block(br, *c, &c->coef[b * 64], ss, se, ah, al, eobrun);
            }
      }
      --todo;
    }
    pos_ = br.marker_pos();
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk, int ss, int se,
                    int ah, int al, int& eobrun) {
    if (!progressive_) {
      int s = br.decode(dc_[c.dc_tbl]);
      if (s) s = extend(br.bits(s), s);
      c.dc_pred += s;
      blk[0] = (int16_t)c.dc_pred;
      const Huffman& t = ac_[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(t), r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {
      if (ah == 0) {
        int s = br.decode(dc_[c.dc_tbl]);
        if (s) s = extend(br.bits(s), s);
        c.dc_pred += s;
        blk[0] = (int16_t)(c.dc_pred * (1 << al));
      } else if (br.bit()) {
        blk[0] |= (int16_t)(1 << al);
      }
      return;
    }
    const Huffman& t = ac_[c.ac_tbl];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = (int16_t)(extend(br.bits(s), s) * (1 << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* cp = blk + kNatural[k];
          if (*cp != 0) {
            if (br.bit() && (*cp & p1) == 0)
              *cp = (int16_t)(*cp >= 0 ? *cp + p1 : *cp + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* cp = blk + kNatural[k];
        if (*cp != 0 && br.bit() && (*cp & p1) == 0)
          *cp = (int16_t)(*cp >= 0 ? *cp + p1 : *cp + m1);
      }
      --eobrun;
    }
  }

  // libjpeg block-smooths a progressive image (jdcoefct.c smoothing_ok)
  // when a component's DC is known and any of its first nine AC
  // coefficients (zigzag 1..9) was left with unrefined bits.
  void check_smoothing() {
    for (auto& c : comps_) {
      if (c.coef_bits[0] < 0) continue;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          unsupported("a progressive scan script that leaves AC "
                      "coefficients unrefined (libjpeg block-smooths it)");
    }
  }

  void inverse_dct(Component& c) {
    int stride = c.bw * 8;
    c.plane.assign((size_t)stride * c.bh * 8, 0);
    int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                   &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
  }

  // One component upsampled to the full output width, output row `y`.
  void upsampled_row(const Component& c, int y, uint8_t* out) const {
    int hr = hmax_ / c.h, vr = vmax_ / c.v;
    int stride = c.bw * 8;
    int n = c.dw;
    if (hr == 1 && vr == 1) {
      std::memcpy(out, &c.plane[(size_t)y * stride], n);
      return;
    }
    int r = y / vr;
    const uint8_t* in = &c.plane[(size_t)r * stride];
    if (n <= 2 || (hr == 2 && vr == 1 && n <= 2)) {  // box replication
      for (int x = 0; x < n; ++x) out[2 * x] = out[2 * x + 1] = in[x];
      return;
    }
    if (vr == 1) {  // h2v1_fancy_upsample
      int v = in[0];
      out[0] = (uint8_t)v;
      out[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < n - 1; ++x) {
        v = in[x] * 3;
        out[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
        out[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      v = in[n - 1];
      out[2 * n - 2] = (uint8_t)((v * 3 + in[n - 2] + 1) >> 2);
      out[2 * n - 1] = (uint8_t)v;
      return;
    }
    // h2v2_fancy_upsample: the nearer row and the row above (even output
    // rows) or below (odd), clamped to the component's real rows
    int r1 = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
    const uint8_t* in1 = &c.plane[(size_t)r1 * stride];
    int last = in[0] * 3 + in1[0];
    int cur = last;
    int next = in[1] * 3 + in1[1];
    out[0] = (uint8_t)((cur * 4 + 8) >> 4);
    out[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int x = 1; x < n - 1; ++x) {
      next = in[x + 1] * 3 + in1[x + 1];
      out[2 * x] = (uint8_t)((cur * 3 + last + 8) >> 4);
      out[2 * x + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    out[2 * n - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
    out[2 * n - 1] = (uint8_t)((cur * 4 + 7) >> 4);
  }

  void to_rgb(uint8_t* out) const {
    const size_t w = width;
    if (comps_.size() == 1) {
      std::vector<uint8_t> row(comps_[0].bw * 8 * 2);
      for (int y = 0; y < height; ++y) {
        upsampled_row(comps_[0], y, row.data());
        uint8_t* o = out + (size_t)y * w * 3;
        for (size_t x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table
    constexpr int kScale = 16;
    constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    bool rgb = !jfif_ && ((adobe_ && adobe_transform_ == 0) ||
                          (!adobe_ && comps_[0].id == 82 &&
                           comps_[1].id == 71 && comps_[2].id == 66));
    size_t rw = (size_t)hmax_ * mcux_ * 8 + 16;
    std::vector<uint8_t> r0(rw), r1(rw), r2(rw);
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < height; ++y) {
      upsampled_row(comps_[0], y, r0.data());
      upsampled_row(comps_[1], y, r1.data());
      upsampled_row(comps_[2], y, r2.data());
      uint8_t* o = out + (size_t)y * w * 3;
      if (rgb) {
        for (size_t x = 0; x < w; ++x) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (size_t x = 0; x < w; ++x) {
        int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

int fail(const Failure& f, char* err, int64_t cap) {
  if (err && cap > 0) std::snprintf(err, (size_t)cap, "%s", f.what.c_str());
  return f.code;
}

}  // namespace

extern "C" {

// Reads the headers up to the frame header: the image's height and
// width. Returns 0, or 1 (unsupported) / 2 (corrupt) with a message.
int jpeg_info(const uint8_t* data, int64_t n, int64_t* h, int64_t* w,
              char* err, int64_t cap) {
  try {
    Decoder dec(data, (size_t)n);
    dec.read_header();
    *h = dec.height;
    *w = dec.width;
    return kOk;
  } catch (const Failure& f) {
    return fail(f, err, cap);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, err, cap);
  }
}

// Decodes into out, uint8 [h, w, 3] as jpeg_info gave them.
int jpeg_decode_rgb(const uint8_t* data, int64_t n, uint8_t* out, int64_t h,
                    int64_t w, char* err, int64_t cap) {
  try {
    Decoder dec(data, (size_t)n);
    dec.read_header();
    if (dec.height != h || dec.width != w)
      throw Failure{kCorrupt, "size differs from jpeg_info's"};
    dec.decode(out);
    return kOk;
  } catch (const Failure& f) {
    return fail(f, err, cap);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, err, cap);
  }
}

}  // extern "C"
