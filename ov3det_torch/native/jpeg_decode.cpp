// Baseline JPEG decoder for the datasets' image branches.
//
// It gives, value for value, what libjpeg-turbo gives under PIL's defaults
// (`np.asarray(PIL.Image.open(path))`): Huffman decoding of baseline
// sequential files (SOF0, and SOF1 with 8-bit samples), restart intervals,
// the ISLOW integer IDCT of jidctint.c with its range-limit table, libjpeg's
// "fancy" triangle upsampling for h2v1 (4:2:2) and h2v2 (4:2:0) chroma, and
// the fixed-point YCbCr->RGB of jdcolor.c.  A 3-component file decodes to
// RGB, a 1-component file to greyscale.  Everything else raises: progressive,
// arithmetic, lossless or 12-bit files, CMYK or Adobe-RGB files, several
// scans, other sampling factors, and data that ends or breaks before the
// last MCU.  Nothing is returned from a file that raised.
//
// Plain C ABI for ctypes (ov3det_torch/utils/jpeg.py).  The decoder holds no
// state between calls; it runs in the data loader's worker processes.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// natural (row-major) index of the k-th coefficient in zigzag order
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

// A decoding table as jdhuff.c's jpeg_make_d_derived_tbl builds it, with a
// 9-bit lookahead: look[prefix] = (code length << 8) | symbol, 0 if longer.
struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym, bool dc) {
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l - 1]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1u << si)) throw Error("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += counts[l - 1];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memcpy(vals, symbols, nsym);
    for (int i = 0; i < nsym; i++)
      if (dc && symbols[i] > 15) throw Error("bad DC Huffman table");
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < counts[l - 1]; i++, p++) {
        const uint32_t base = huffcode[p] << (kLookBits - l);
        for (uint32_t j = 0; j < (1u << (kLookBits - l)); j++)
          look[base + j] = static_cast<uint16_t>((l << 8) | symbols[p]);
      }
    }
    defined = true;
  }
};

// MSB-first bit reader over entropy-coded data.  At a marker or at the end
// of the file it appends zero bits, as libjpeg does; `pad` counts them, and
// consuming one of them means that the data ran out (checked a block).
struct Bits {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;
  int cnt = 0;
  int pad = 0;
  bool stopped = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t byte = 0;
      if (!stopped && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;  // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;  // a stuffed 0xFF
          } else {
            stopped = true;  // a marker (or the end): p stays on it
            byte = 0;
          }
        } else {
          p++;
        }
      } else {
        stopped = true;
      }
      if (stopped) pad += 8;
      buf |= static_cast<uint64_t>(byte) << (56 - cnt);
      cnt += 8;
    }
  }

  uint32_t get(int n) {  // n <= 16, after fill() left at least n bits
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }

  int decode(const Huffman& h) {
    if (cnt < 32) fill();
    const uint16_t e = h.look[buf >> (64 - kLookBits)];
    if (e) {
      const int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; l++) {
      const int32_t code = static_cast<int32_t>(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return h.vals[code + h.valoffset[l]];
      }
    }
    throw Error("corrupt data: no Huffman code matches");
  }

  bool overrun() const { return cnt < pad; }

  void reset() {
    buf = 0;
    cnt = 0;
    pad = 0;
    stopped = false;
  }
};

inline int extend(uint32_t v, int s) {  // HUFF_EXTEND
  return static_cast<int>(v) < (1 << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                              : static_cast<int>(v);
}

// libjpeg's sample_range_limit table (jdmaster.c prepare_range_limit_table):
// limit(x) clamps x to [0, 255] for -256 <= x < 512; idct(x) is the
// post-IDCT table indexed by x & 1023, which clamps [-512, 511] after the
// +128 level shift and wraps outside it, as libjpeg does.
struct RangeLimit {
  uint8_t table[256 + 1024 + 128];
  uint8_t* simple;  // simple[x], -256 <= x < 512
  uint8_t* post;    // post[x & 1023]

  RangeLimit() {
    uint8_t* t = table + 256;
    std::memset(table, 0, 256);
    for (int i = 0; i < 256; i++) t[i] = static_cast<uint8_t>(i);
    simple = t;
    t += 128;
    for (int i = 128; i < 512; i++) t[i] = 255;
    std::memset(t + 512, 0, 512 - 128);
    std::memcpy(t + 1024 - 128, simple, 128);
    post = t;
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit r;
  return r;
}

// jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, int stride) {
  const uint8_t* limit = range_limit().post;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int dc = static_cast<int>(int64_t{in[0]} * q[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t{in[16]} * q[16], z3 = int64_t{in[48]} * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t{in[0]} * q[0];
    z3 = int64_t{in[32]} * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t{in[56]} * q[56];
    tmp1 = int64_t{in[40]} * q[40];
    tmp2 = int64_t{in[24]} * q[24];
    tmp3 = int64_t{in[8]} * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = limit[descale(w[0], kPass1Bits + 3) & 1023];
      for (int i = 0; i < 8; i++) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t{w[0]} + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t{w[0]} - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit[descale(tmp10 + tmp3, s2) & 1023];
    o[7] = limit[descale(tmp10 - tmp3, s2) & 1023];
    o[1] = limit[descale(tmp11 + tmp2, s2) & 1023];
    o[6] = limit[descale(tmp11 - tmp2, s2) & 1023];
    o[2] = limit[descale(tmp12 + tmp1, s2) & 1023];
    o[5] = limit[descale(tmp12 - tmp1, s2) & 1023];
    o[3] = limit[descale(tmp13 + tmp0, s2) & 1023];
    o[4] = limit[descale(tmp13 - tmp0, s2) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int64_t half = int64_t{1} << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int width = 0, height = 0;  // downsampled_width, downsampled_height
  int stride = 0, rows = 0;   // the plane, padded to whole MCUs
  std::vector<uint8_t> plane;
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t n) : data_(data), end_(data + n) {}

  // Reads the markers up to the first scan's header.
  void header() {
    pos_ = data_;
    if (end_ - pos_ < 2 || pos_[0] != 0xFF || pos_[1] != 0xD8) throw Error("not a JPEG file");
    pos_ += 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xDA) {
        read_sos();
        break;
      }
      if (m == 0xD9) throw Error("no image data before the end of the file");
      read_segment(m);
    }
    if (!frame_) throw Error("no frame header before the scan");
    // libjpeg's colour-space guess for 3 components (jdapimin.c
    // default_decompress_parms): only YCbCr is decoded
    if (comps_.size() == 3 && !jfif_) {
      if (adobe_ && adobe_transform_ != 1) throw Error("Adobe RGB JPEG is not decoded (YCbCr only)");
      if (!adobe_ && comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66)
        throw Error("RGB JPEG is not decoded (YCbCr only)");
    }
  }

  int height() const { return height_; }
  int width() const { return width_; }
  int channels() const { return static_cast<int>(comps_.size()); }

  void decode(uint8_t* out) {
    decode_scan();
    output(out);
  }

 private:
  const uint8_t* data_;
  const uint8_t* end_;
  const uint8_t* pos_ = nullptr;
  Huffman dc_[4], ac_[4];
  int16_t quant_[4][64];
  bool quant_defined_[4] = {false, false, false, false};
  bool frame_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int height_ = 0, width_ = 0, hmax_ = 1, vmax_ = 1;
  int restart_interval_ = 0;
  std::vector<Component> comps_;
  std::vector<int> scan_;  // indices into comps_, in scan order

  int byte() {
    if (pos_ >= end_) throw Error("truncated file");
    return *pos_++;
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    int c = byte();
    while (c != 0xFF) c = byte();  // libjpeg skips garbage before a marker too
    do c = byte();
    while (c == 0xFF);
    if (c == 0) throw Error("corrupt marker");
    return c;
  }

  void read_segment(int m) {
    const int len = word();
    if (len < 2 || end_ - pos_ < len - 2) throw Error("truncated marker segment");
    const uint8_t* seg = pos_;
    const uint8_t* seg_end = pos_ + len - 2;
    pos_ = seg_end;
    if (m == 0xC0 || m == 0xC1) {
      read_sof(seg, seg_end);
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      throw Error("progressive JPEG is not decoded (baseline sequential only)");
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      throw Error("lossless JPEG is not decoded (baseline sequential only)");
    } else if (m == 0xC5 || m == 0xC9 || m == 0xCD || m == 0xCC) {
      throw Error("arithmetic-coded or hierarchical JPEG is not decoded");
    } else if (m == 0xC4) {
      read_dht(seg, seg_end);
    } else if (m == 0xDB) {
      read_dqt(seg, seg_end);
    } else if (m == 0xDD) {
      if (seg_end - seg < 2) throw Error("bad DRI segment");
      restart_interval_ = (seg[0] << 8) | seg[1];
    } else if (m == 0xDC) {
      throw Error("DNL marker: the height is not in the frame header");
    } else if (m == 0xE0) {
      if (seg_end - seg >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) jfif_ = true;
    } else if (m == 0xEE) {
      if (seg_end - seg >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = seg[11];
      }
    } else if (m >= 0xD0 && m <= 0xD7) {
      throw Error("restart marker outside a scan");
    }
    // other APPn, COM and the rest: skipped
  }

  void read_sof(const uint8_t* s, const uint8_t* e) {
    if (frame_) throw Error("two frame headers");
    if (e - s < 6) throw Error("bad frame header");
    if (s[0] != 8) throw Error(std::to_string(s[0]) + "-bit samples: only 8-bit JPEG is decoded");
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    const int nf = s[5];
    if (height_ == 0) throw Error("DNL marker: the height is not in the frame header");
    if (width_ == 0) throw Error("zero image width");
    if (nf == 4) throw Error("4-component (CMYK) JPEG is not decoded");
    if (nf != 1 && nf != 3) throw Error(std::to_string(nf) + "-component JPEG is not decoded");
    if (e - s < 6 + 3 * nf) throw Error("bad frame header");
    comps_.resize(nf);
    for (int i = 0; i < nf; i++) {
      Component& c = comps_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) throw Error("bad frame header");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    const int mcux = ceil_div(width_, 8 * hmax_), mcuy = ceil_div(height_, 8 * vmax_);
    for (Component& c : comps_) {
      const int rh = hmax_ / c.h, rv = vmax_ / c.v;
      if (hmax_ % c.h || vmax_ % c.v || !((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                                          (rh == 2 && rv == 2)))
        throw Error("chroma subsampling other than 4:4:4, 4:2:2 and 4:2:0 is not decoded");
      c.width = ceil_div(width_ * c.h, hmax_);
      c.height = ceil_div(height_ * c.v, vmax_);
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
    }
    frame_ = true;
  }

  void read_dht(const uint8_t* s, const uint8_t* e) {
    while (s < e) {
      if (e - s < 17) throw Error("bad DHT segment");
      const int tc = s[0] >> 4, th = s[0] & 15;
      if (tc > 1 || th > 3) throw Error("bad DHT segment");
      int nsym = 0;
      for (int i = 0; i < 16; i++) nsym += s[1 + i];
      if (nsym > 256 || e - s < 17 + nsym) throw Error("bad DHT segment");
      (tc ? ac_ : dc_)[th].build(s + 1, s + 17, nsym, tc == 0);
      s += 17 + nsym;
    }
  }

  void read_dqt(const uint8_t* s, const uint8_t* e) {
    while (s < e) {
      const int pq = s[0] >> 4, tq = s[0] & 15;
      if (pq > 1 || tq > 3 || e - s < 1 + 64 * (pq + 1)) throw Error("bad DQT segment");
      for (int k = 0; k < 64; k++) {
        const int v = pq ? (s[1 + 2 * k] << 8) | s[2 + 2 * k] : s[1 + k];
        quant_[tq][kNatural[k]] = static_cast<int16_t>(v);
      }
      quant_defined_[tq] = true;
      s += 1 + 64 * (pq + 1);
    }
  }

  void read_sos() {
    if (!frame_) throw Error("scan before the frame header");
    const int len = word();
    if (len < 3 || end_ - pos_ < len - 2) throw Error("truncated scan header");
    const uint8_t* s = pos_;
    pos_ += len - 2;
    const int ns = s[0];
    if (len != 6 + 2 * ns) throw Error("bad scan header");
    if (ns != static_cast<int>(comps_.size()))
      throw Error("a scan without every component: only single-scan baseline files are decoded");
    scan_.clear();
    for (int i = 0; i < ns; i++) {
      int found = -1;
      for (size_t j = 0; j < comps_.size(); j++)
        if (comps_[j].id == s[1 + 2 * i]) found = static_cast<int>(j);
      if (found < 0) throw Error("scan names an unknown component");
      Component& c = comps_[found];
      c.td = s[2 + 2 * i] >> 4;
      c.ta = s[2 + 2 * i] & 15;
      if (c.td > 3 || c.ta > 3 || !dc_[c.td].defined || !ac_[c.ta].defined)
        throw Error("scan uses an undefined Huffman table");
      if (!quant_defined_[c.tq]) throw Error("component uses an undefined quantisation table");
      scan_.push_back(found);
    }
    const uint8_t* t = s + 1 + 2 * ns;
    if (t[0] != 0 || t[1] != 63 || t[2] != 0) throw Error("not a baseline sequential scan");
  }

  void decode_block(Bits& bits, Component& c, int& dc, uint8_t* out) {
    int16_t coef[64] = {0};
    const int s = bits.decode(dc_[c.td]);
    int diff = 0;
    if (s) diff = extend(bits.get(s), s);
    dc += diff;
    coef[0] = static_cast<int16_t>(dc);
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64; k++) {
      const int rs = bits.decode(ac);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) throw Error("corrupt data: coefficient index past 63");
        coef[kNatural[k]] = static_cast<int16_t>(extend(bits.get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    if (bits.overrun()) throw Error("truncated or corrupt entropy-coded data");
    idct_islow(coef, quant_[c.tq], out, c.stride);
  }

  void decode_scan() {
    for (Component& c : comps_) c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
    Bits bits;
    bits.p = pos_;
    bits.end = end_;
    int dc[4] = {0, 0, 0, 0};
    const bool single = scan_.size() == 1;
    // a non-interleaved scan takes one block an MCU over the component's own
    // block grid; an interleaved one h x v blocks a component an MCU
    const Component& c0 = comps_[scan_[0]];
    const int mcux = single ? ceil_div(c0.width, 8) : ceil_div(width_, 8 * hmax_);
    const int mcuy = single ? ceil_div(c0.height, 8) : ceil_div(height_, 8 * vmax_);
    int restarts_left = restart_interval_;
    int next_rst = 0;
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        if (restart_interval_) {
          if (restarts_left == 0) {
            restart(bits, next_rst);
            next_rst = (next_rst + 1) & 7;
            for (int& d : dc) d = 0;
            restarts_left = restart_interval_;
          }
          restarts_left--;
        }
        for (size_t si = 0; si < scan_.size(); si++) {
          Component& c = comps_[scan_[si]];
          const int bh = single ? 1 : c.h, bv = single ? 1 : c.v;
          for (int v = 0; v < bv; v++) {
            for (int h = 0; h < bh; h++) {
              const size_t row = static_cast<size_t>(my * bv + v) * 8;
              const size_t col = static_cast<size_t>(mx * bh + h) * 8;
              decode_block(bits, c, dc[si], c.plane.data() + row * c.stride + col);
            }
          }
        }
      }
    }
  }

  void restart(Bits& bits, int expected) {
    // drop the bits left in the buffer, then find the marker (libjpeg
    // discards extraneous bytes before it too)
    const uint8_t* p = bits.p;
    while (p < end_ && *p != 0xFF) p++;
    while (p < end_ && *p == 0xFF) p++;
    if (p >= end_) throw Error("truncated file: a restart marker is missing");
    if (*p != 0xD0 + expected) throw Error("corrupt data: a restart marker is missing or out of order");
    bits.reset();
    bits.p = p + 1;
  }

  // the upsampled row y of component c, W samples
  void upsample_row(const Component& c, int y, uint8_t* out, std::vector<int>& sums) {
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const int cw = c.width;
    if (rh == 1) {  // 4:4:4
      std::memcpy(out, c.plane.data() + static_cast<size_t>(y) * c.stride, width_);
      return;
    }
    if (rv == 1) {  // h2v1 (jdsample.c h2v1_fancy_upsample)
      const uint8_t* in = c.plane.data() + static_cast<size_t>(y) * c.stride;
      std::vector<uint8_t>& tmp = row_tmp_;
      tmp.resize(2 * static_cast<size_t>(cw));
      if (cw > 2) {
        int v = in[0];
        tmp[0] = static_cast<uint8_t>(v);
        tmp[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; x++) {
          v = in[x] * 3;
          tmp[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          tmp[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        v = in[cw - 1];
        tmp[2 * cw - 2] = static_cast<uint8_t>((v * 3 + in[cw - 2] + 1) >> 2);
        tmp[2 * cw - 1] = static_cast<uint8_t>(v);
      } else {  // h2v1_upsample: each sample twice
        for (int x = 0; x < cw; x++) tmp[2 * x] = tmp[2 * x + 1] = in[x];
      }
      std::memcpy(out, tmp.data(), width_);
      return;
    }
    // h2v2 (jdsample.c h2v2_fancy_upsample); rows above the first and below
    // the last real row repeat them, as jdmainct.c's context pointers do
    const int i = y >> 1;
    const uint8_t* in0 = c.plane.data() + static_cast<size_t>(i) * c.stride;
    std::vector<uint8_t>& tmp = row_tmp_;
    tmp.resize(2 * static_cast<size_t>(cw));
    if (cw > 2) {
      const int j = (y & 1) ? std::min(i + 1, c.height - 1) : std::max(i - 1, 0);
      const uint8_t* in1 = c.plane.data() + static_cast<size_t>(j) * c.stride;
      sums.resize(cw);
      for (int x = 0; x < cw; x++) sums[x] = in0[x] * 3 + in1[x];
      tmp[0] = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
      tmp[1] = static_cast<uint8_t>((sums[0] * 3 + sums[1] + 7) >> 4);
      for (int x = 1; x < cw - 1; x++) {
        tmp[2 * x] = static_cast<uint8_t>((sums[x] * 3 + sums[x - 1] + 8) >> 4);
        tmp[2 * x + 1] = static_cast<uint8_t>((sums[x] * 3 + sums[x + 1] + 7) >> 4);
      }
      tmp[2 * cw - 2] = static_cast<uint8_t>((sums[cw - 1] * 3 + sums[cw - 2] + 8) >> 4);
      tmp[2 * cw - 1] = static_cast<uint8_t>((sums[cw - 1] * 4 + 7) >> 4);
    } else {  // h2v2_upsample: each sample over 2 x 2
      for (int x = 0; x < cw; x++) tmp[2 * x] = tmp[2 * x + 1] = in0[x];
    }
    std::memcpy(out, tmp.data(), width_);
  }

  std::vector<uint8_t> row_tmp_;

  void output(uint8_t* out) {
    const size_t W = static_cast<size_t>(width_);
    if (comps_.size() == 1) {
      for (int y = 0; y < height_; y++) upsample_row(comps_[0], y, out + y * W, sums_);
      return;
    }
    const YccTables& t = ycc_tables();
    const uint8_t* limit = range_limit().simple;
    std::vector<uint8_t> rows(3 * W);
    uint8_t* yrow = rows.data();
    uint8_t* cb = yrow + W;
    uint8_t* cr = cb + W;
    for (int y = 0; y < height_; y++) {
      upsample_row(comps_[0], y, yrow, sums_);
      upsample_row(comps_[1], y, cb, sums_);
      upsample_row(comps_[2], y, cr, sums_);
      uint8_t* o = out + static_cast<size_t>(y) * W * 3;
      for (size_t x = 0; x < W; x++) {
        const int Y = yrow[x], b = cb[x], r = cr[x];
        o[3 * x] = limit[Y + t.cr_r[r]];
        o[3 * x + 1] = limit[Y + static_cast<int>((t.cb_g[b] + t.cr_g[r]) >> 16)];
        o[3 * x + 2] = limit[Y + t.cb_b[b]];
      }
    }
  }

  std::vector<int> sums_;
};

void set_error(char* err, int errlen, const char* what) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", what);
}

}  // namespace

extern "C" {

// dims = (height, width, channels) of the file's image.  0 on success, else
// 1 with the reason in err.
int ov3_jpeg_header(const uint8_t* data, int64_t n, int32_t* dims, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.header();
    dims[0] = d.height();
    dims[1] = d.width();
    dims[2] = d.channels();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decodes into out: height x width x channels uint8 (capacity bytes).
int ov3_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t capacity, char* err,
                    int errlen) {
  try {
    Decoder d(data, n);
    d.header();
    if (static_cast<int64_t>(d.height()) * d.width() * d.channels() > capacity)
      throw Error("output buffer too small");
    d.decode(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
