// Baseline JPEG decode and encode, and PNG scanline unfiltering, in integer
// arithmetic only: the image codec of the port (`data/codec.py` binds it).
//
// The decoder gives the pixels libjpeg-turbo 3.x gives with its default
// decompression settings, which is what cv2.imdecode(..., IMREAD_COLOR)
// returns (channels reversed): the slow-but-accurate integer IDCT
// (jidctint.c: CONST_BITS 13, PASS1_BITS 2, the wrapping range-limit
// table), "fancy" triangle upsampling for h2v1 / h2v2 (where the
// component's downsampled width is above 2) and h1v2 chroma, box
// replication for the other integral factors (4:1:1 among them), and
// jdcolor.c's YCbCr -> RGB tables. Huffman-coded 8-bit DCT streams:
// sequential (SOF0, SOF1) and progressive (SOF2), interleaved scans or not,
// restart markers; arithmetic-coded, lossless, hierarchical and 12-bit
// streams are refused with their own error code. Entropy data cut short by
// a marker decodes as zero bits up to the end of that MCU, and the MCUs
// after it in the segment are left as they are (jdhuff.c / jdphuff.c
// insufficient_data); a body that ends before its EOI marker is refused
// (E_TRUNCATED), as cv2.imdecode returns nothing for it.
//
// Progressive scans (jdphuff.c: DC first and refine, AC first with EOB
// runs, AC refine with correction bits) fill the whole-image coefficient
// buffer; the IDCT, upsampling and colour conversion then run as for a
// sequential stream. libjpeg-turbo smooths the blocks of a progressive
// image (jdcoefct.c decompress_smooth_data) when, after the last scan, one
// of the first nine AC coefficients (zigzag 1-9) of some component is not
// fully refined: its coef_bits entry is not 0 (-1 for never sent, the
// missing low bits otherwise). Such a body is refused (E_PARTIAL) rather
// than decoded to pixels that differ from cv2's. Accepted: every component
// with coef_bits[1..9] all 0 (every complete file cv2 writes), or a stream
// libjpeg would not smooth anyway (a component with no DC data, with no
// scan at all, or with a zero among its first ten quantizers).
//
// The encoder writes what libjpeg-turbo's jpeg_set_defaults + set_quality
// writes (cv2.imencode's stream): JFIF APP0, the standard tables scaled by
// the quality, the islow forward DCT (jfdctint.c), the standard Huffman
// tables, jcsample.c's biased downsampling and libjpeg's edge padding.
//
// Built for the host by `ops/cuda/_build.py` and called through ctypes,
// which releases the GIL: server threads decode in parallel. Being integer
// only, a body decodes to the same bytes on every host.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Error {
  OK = 0,
  E_NOT_JPEG = 1,
  E_CORRUPT = 2,
  E_ARITHMETIC = 4,
  E_LOSSLESS = 5,
  E_PRECISION = 6,
  E_COMPONENTS = 7,
  E_SAMPLING = 8,
  E_HUFFMAN = 9,
  E_NO_FRAME = 10,
  E_BUFFER = 11,
  E_SIZE = 12,
  E_TABLES = 13,
  E_PNG_FILTER = 14,
  E_MEMORY = 15,
  E_PARTIAL = 16,
  E_TRUNCATED = 17,
};

// Largest image decoded or encoded (pixels): a body of a few bytes may
// declare 65535 x 65535, and a server must not allocate for it.
constexpr int64_t kMaxPixels = int64_t(1) << 28;

// zigzag index -> natural index, with libjpeg's 16 guard entries for
// corrupt runs past the end of a block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- IDCT

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: x taken modulo 1024 into [-512, 511],
// then clamped to [0, 255] after adding 128
inline uint8_t idct_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jpeg_idct_islow: one block of natural-order coefficients and its
// natural-order quantization table -> 8x8 samples at `out` (row stride)
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int(in[0]) * int(qt[0])) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qt[16];
    int64_t z3 = int64_t(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qt[0];
    z3 = int64_t(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(in[56]) * qt[56];
    tmp1 = int64_t(in[40]) * qt[40];
    tmp2 = int64_t(in[24]) * qt[24];
    tmp3 = int64_t(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int S = CONST_BITS - PASS1_BITS;
    w[0] = int(descale(tmp10 + tmp3, S));
    w[56] = int(descale(tmp10 - tmp3, S));
    w[8] = int(descale(tmp11 + tmp2, S));
    w[48] = int(descale(tmp11 - tmp2, S));
    w[16] = int(descale(tmp12 + tmp1, S));
    w[40] = int(descale(tmp12 - tmp1, S));
    w[24] = int(descale(tmp13 + tmp0, S));
    w[32] = int(descale(tmp13 - tmp0, S));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    constexpr int S = CONST_BITS + PASS1_BITS + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = idct_limit(descale(tmp10 + tmp3, S));
    o[7] = idct_limit(descale(tmp10 - tmp3, S));
    o[1] = idct_limit(descale(tmp11 + tmp2, S));
    o[6] = idct_limit(descale(tmp11 - tmp2, S));
    o[2] = idct_limit(descale(tmp12 + tmp1, S));
    o[5] = idct_limit(descale(tmp12 - tmp1, S));
    o[3] = idct_limit(descale(tmp13 + tmp0, S));
    o[4] = idct_limit(descale(tmp13 - tmp0, S));
  }
}

// ------------------------------------------------------------- Huffman

struct HuffDecode {
  bool defined = false;
  uint8_t fast_len[512];    // 9-bit lookahead: code length, 0 = slow path
  uint8_t fast_val[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// jpeg_make_d_derived_tbl; false on an over-subscribed table
bool build_huff(HuffDecode& t, const uint8_t bits[17], const uint8_t* vals,
                int nvals) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) size[p++] = uint8_t(l);
  size[p] = 0;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (uint32_t(1) << si)) return false;
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t.valoffset[l] = p - int32_t(code[p]);
      p += bits[l];
      t.maxcode[l] = int32_t(code[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.fast_len, 0, sizeof t.fast_len);
  for (int i = 0; i < nvals; ++i) {
    int l = size[i];
    if (l > 9) break;
    uint32_t lo = code[i] << (9 - l), n = uint32_t(1) << (9 - l);
    for (uint32_t k = 0; k < n; ++k) {
      t.fast_len[lo + k] = uint8_t(l);
      t.fast_val[lo + k] = vals[i];
    }
  }
  std::memcpy(t.vals, vals, nvals);
  t.defined = true;
  return true;
}

// Entropy-coded bits: 0xFF00 is a data 0xFF; a marker stops the stream,
// after which (as at the end of the buffer) zero bits are fed.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;
  int marker = 0;             // the marker that stopped the stream
  const uint8_t* marker_at = nullptr;   // its first 0xFF
  const uint8_t* after_marker = nullptr;
  int pad = 0;                // zero bits fed past the data, at buf's end
  bool starved = false;       // a bit past the data was consumed

  void fill() {
    while (n <= 56) {
      unsigned c = 0;
      if (!marker && p < end) {
        const uint8_t* at = p;
        c = *p++;
        if (c == 0xFF) {
          unsigned c2 = 0xFF;
          while (p < end && (c2 = *p++) == 0xFF) {
          }
          if (c2 == 0) {
            c = 0xFF;
          } else {
            marker = (c2 == 0xFF) ? 0x100 : int(c2);   // 0x100: buffer end
            marker_at = at;
            after_marker = p;
            c = 0;
          }
        }
      } else if (!marker) {
        marker = 0x100;
        marker_at = after_marker = end;
      }
      buf = (buf << 8) | c;
      n += 8;
      if (marker) pad += 8;
    }
  }
  inline unsigned peek(int k) {
    if (n < k) fill();
    return unsigned(buf >> (n - k)) & ((1u << k) - 1);
  }
  inline void skip(int k) {
    n -= k;
    if (n < pad) {
      starved = true;
      pad = n;
    }
  }
  inline int get(int k) {
    if (k == 0) return 0;
    unsigned v = peek(k);
    skip(k);
    return int(v);
  }
  void reset() {
    buf = 0;
    n = 0;
    pad = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int decode_huff(BitReader& br, const HuffDecode& t) {
  unsigned look = br.peek(9);
  int l = t.fast_len[look];
  if (l) {
    br.skip(l);
    return t.fast_val[look];
  }
  unsigned code = br.peek(16);
  for (l = 10; l <= 16; ++l) {
    int32_t c = int32_t(code >> (16 - l));
    if (c <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[c + t.valoffset[l]];
    }
  }
  return -1;
}

// ------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;         // downsampled size in samples
  int wib = 0, hib = 0;       // width / height in blocks
  int bw = 0, bh = 0;         // allocated blocks (MCU padded)
  bool q_latched = false;
  uint16_t q[64];
  int dc_tbl = 0, ac_tbl = 0, pred = 0;
  std::vector<int16_t> coef;
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffDecode dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int orientation = 1;
  bool have_frame = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Component comp[3];
  int scans = 0;
  bool saw_eoi = false;
  bool progressive = false;
  int coef_bits[3][64];       // jdphuff.c: the low bit last sent, -1 none
  int eobrun = 0;

  int u16(const uint8_t* q) const { return (q[0] << 8) | q[1]; }

  // the next marker code at or after p (skipping garbage, as libjpeg's
  // next_marker does); 0 at the end of the buffer
  int next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) return 0;
      int m = *p++;
      if (m != 0) return m;
    }
  }

  int segment(const uint8_t*& seg, int& len) {
    if (end - p < 2) return E_CORRUPT;
    len = u16(p) - 2;
    if (len < 0 || end - p < len + 2) return E_CORRUPT;
    seg = p + 2;
    p += len + 2;
    return OK;
  }

  void parse_exif(const uint8_t* s, int len) {
    if (len < 14 || std::memcmp(s, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = s + 6;
    int tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](int o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](int o) -> uint32_t {
      return le ? (uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                   (uint32_t(t[o + 2]) << 16) | (uint32_t(t[o + 3]) << 24))
                : ((uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                   (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]));
    };
    if (rd16(2) != 42) return;
    uint32_t ifd = rd32(4);
    if (ifd > uint32_t(tl) - 2) return;
    int count = rd16(int(ifd));
    for (int i = 0; i < count; ++i) {
      int o = int(ifd) + 2 + 12 * i;
      if (o + 12 > tl) return;
      if (rd16(o) == 0x0112 && rd16(o + 2) == 3) {
        int v = rd16(o + 8);
        if (v >= 1 && v <= 8) orientation = v;
        return;
      }
    }
  }

  int parse_sof(const uint8_t* s, int len, bool prog) {
    if (have_frame) return E_CORRUPT;
    progressive = prog;
    std::memset(coef_bits, 0xFF, sizeof coef_bits);
    if (len < 6) return E_CORRUPT;
    if (s[0] != 8) return E_PRECISION;
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = s[5];
    if (ncomp != 1 && ncomp != 3) return E_COMPONENTS;
    if (len < 6 + 3 * ncomp) return E_CORRUPT;
    if (width <= 0 || height <= 0 ||
        int64_t(width) * height > kMaxPixels)
      return E_SIZE;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return E_SAMPLING;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return E_SAMPLING;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = std::max(mcux * c.h, c.wib);
      c.bh = std::max(mcuy * c.v, c.hib);
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    have_frame = true;
    return OK;
  }

  int parse_dht(const uint8_t* s, int len) {
    int o = 0;
    while (o < len) {
      if (len - o < 17) return E_CORRUPT;
      int tc = s[o] >> 4, th = s[o] & 15;
      if (tc > 1 || th > 3) return E_TABLES;
      uint8_t bits[17];
      bits[0] = 0;
      int total = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = s[o + i];
        total += bits[i];
      }
      o += 17;
      if (total > 256 || len - o < total) return E_TABLES;
      if (!build_huff(tc ? ac[th] : dc[th], bits, s + o, total))
        return E_TABLES;
      o += total;
    }
    return OK;
  }

  int parse_dqt(const uint8_t* s, int len) {
    int o = 0;
    while (o < len) {
      int pq = s[o] >> 4, tq = s[o] & 15;
      if (tq > 3 || pq > 1) return E_TABLES;
      int need = 1 + 64 * (pq + 1);
      if (len - o < need) return E_CORRUPT;
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = pq ? uint16_t(u16(s + o + 1 + 2 * i))
                                 : uint16_t(s[o + 1 + i]);
      qt_defined[tq] = true;
      o += need;
    }
    return OK;
  }

  int decode_block(BitReader& br, Component& c, int16_t* blk) {
    int s = decode_huff(br, dc[c.dc_tbl]);
    if (s < 0) return E_HUFFMAN;
    if (s > 15) return E_HUFFMAN;
    int diff = s ? extend(br.get(s), s) : 0;
    if (!add_pred(c, diff)) return E_CORRUPT;
    blk[0] = int16_t(c.pred);
    const HuffDecode& t = ac[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huff(br, t);
      if (rs < 0) return E_HUFFMAN;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return OK;
  }

  // the DC predictor plus a difference; false where libjpeg errs
  // (JERR_BAD_DCT_COEF: the sum leaves int)
  static bool add_pred(Component& c, int diff) {
    const int64_t v = int64_t(c.pred) + diff;
    if (v > INT32_MAX || v < INT32_MIN) return false;
    c.pred = int(v);
    return true;
  }

  // jdphuff.c decode_mcu_DC_first, one block
  int dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int s = decode_huff(br, dc[c.dc_tbl]);
    if (s < 0 || s > 15) return E_HUFFMAN;
    int diff = s ? extend(br.get(s), s) : 0;
    if (!add_pred(c, diff)) return E_CORRUPT;
    blk[0] = int16_t(unsigned(c.pred) << al);
    return OK;
  }

  // decode_mcu_AC_first: the band ss..se of one block, or one block of
  // the current EOB run
  int ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se,
               int al) {
    if (eobrun > 0) {
      --eobrun;
      return OK;
    }
    const HuffDecode& t = ac[c.ac_tbl];
    for (int k = ss; k <= se; ++k) {
      int rs = decode_huff(br, t);
      if (rs < 0) return E_HUFFMAN;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(unsigned(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + br.get(r) - 1;
        break;
      }
    }
    return OK;
  }

  // decode_mcu_AC_refine: a correction bit for each nonzero coefficient
  // of the band, newly nonzero ones placed past runs of zero ones
  int ac_refine(BitReader& br, const Component& c, int16_t* blk, int ss,
                int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t& v) {
      if (br.get(1) && (v & p1) == 0) v = int16_t(v + (v >= 0 ? p1 : m1));
    };
    const HuffDecode& t = ac[c.ac_tbl];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode_huff(br, t);
        if (rs < 0) return E_HUFFMAN;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = (1 << r) + br.get(r);
          break;
        }
        do {
          int16_t& v = blk[kNatural[k]];
          if (v != 0) correct(v);
          else if (--r < 0) break;
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& v = blk[kNatural[k]];
        if (v != 0) correct(v);
      }
      --eobrun;
    }
    return OK;
  }

  // jdcoefct.c smoothing_ok, after the last scan (SAVED_COEFS 10)
  bool would_smooth() const {
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.q_latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.q[kNatural[k]] == 0) return false;
      if (coef_bits[i][0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful |= coef_bits[i][k] != 0;
    }
    return useful;
  }

  void restart(BitReader& br) {
    br.reset();
    if (!br.marker) {
      // the stream has not reached the marker yet: find it
      while (br.p < br.end) {
        if (*br.p == 0xFF && br.p + 1 < br.end && br.p[1] != 0 &&
            br.p[1] != 0xFF) {
          br.marker = br.p[1];
          br.marker_at = br.p;
          br.after_marker = br.p + 2;
          break;
        }
        ++br.p;
      }
    }
    if (br.marker >= 0xD0 && br.marker <= 0xD7) {
      br.p = br.after_marker;
      br.marker = 0;
    }
  }

  // one block of the current scan: sequential, or the progressive kind
  enum Kind { SEQUENTIAL, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE };
  int block(Kind kind, BitReader& br, Component& c, int16_t* blk, int ss,
            int se, int al) {
    switch (kind) {
      case SEQUENTIAL: return decode_block(br, c, blk);
      case DC_FIRST: return dc_first(br, c, blk, al);
      case DC_REFINE:
        if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
        return OK;
      case AC_FIRST: return ac_first(br, c, blk, ss, se, al);
      default: return ac_refine(br, c, blk, ss, se, al);
    }
  }

  int parse_sos(const uint8_t* s, int len) {
    if (!have_frame) return E_NO_FRAME;
    if (len < 1) return E_CORRUPT;
    int ns = s[0];
    if (ns < 1 || ns > ncomp || len < 4 + 2 * ns) return E_CORRUPT;
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    Kind kind = SEQUENTIAL;
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder's JERR_BAD_PROGRESSION
      if (ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1))
        return E_CORRUPT;
      if ((ah != 0 && al != ah - 1) || al > 13) return E_CORRUPT;
      kind = ss == 0 ? (ah ? DC_REFINE : DC_FIRST)
                     : (ah ? AC_REFINE : AC_FIRST);
    }
    // the Huffman tables this kind of scan reads
    const bool need_dc = kind == SEQUENTIAL || kind == DC_FIRST;
    const bool need_ac = kind == SEQUENTIAL || kind >= AC_FIRST;
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) sc[i] = &comp[j];
      if (!sc[i]) return E_CORRUPT;
      sc[i]->dc_tbl = s[2 + 2 * i] >> 4;
      sc[i]->ac_tbl = s[2 + 2 * i] & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) return E_TABLES;
      if ((need_dc && !dc[sc[i]->dc_tbl].defined) ||
          (need_ac && !ac[sc[i]->ac_tbl].defined))
        return E_TABLES;
      if (!sc[i]->q_latched) {
        if (!qt_defined[sc[i]->tq]) return E_TABLES;
        std::memcpy(sc[i]->q, qt[sc[i]->tq], sizeof sc[i]->q);
        sc[i]->q_latched = true;
      }
      sc[i]->pred = 0;
      if (progressive)
        for (int k = ss; k <= se; ++k) coef_bits[sc[i] - comp][k] = al;
    }
    eobrun = 0;

    BitReader br;
    br.p = p;
    br.end = end;
    long total, across;
    if (ns == 1) {
      across = sc[0]->wib;
      total = long(sc[0]->wib) * sc[0]->hib;
    } else {
      across = mcux;
      total = long(mcux) * mcuy;
    }
    int togo = restart_interval;
    for (long m = 0; m < total; ++m) {
      if (restart_interval) {
        if (togo == 0) {
          restart(br);
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          eobrun = 0;
          if (!br.marker) br.starved = false;
          togo = restart_interval;
        }
        --togo;
      }
      // jdhuff.c / jdphuff.c: once the data has run out, the rest of the
      // segment is left as it is (a DC refinement reading zero bits changes
      // nothing)
      if (br.starved && kind != DC_REFINE) continue;
      long mx = m % across, my = m / across;
      if (ns == 1) {
        Component& c = *sc[0];
        int16_t* blk = &c.coef[(size_t(my) * c.bw + mx) * 64];
        int e = block(kind, br, c, blk, ss, se, al);
        if (e) return e;
        continue;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        for (int y = 0; y < c.v; ++y)
          for (int x = 0; x < c.h; ++x) {
            size_t bx = size_t(mx) * c.h + x, by = size_t(my) * c.v + y;
            int e = block(kind, br, c, &c.coef[(by * c.bw + bx) * 64], ss,
                          se, al);
            if (e) return e;
          }
      }
    }
    // resume the marker parser at the marker that ended the scan
    if (br.marker && br.marker != 0x100) p = br.marker_at;
    else if (br.marker == 0x100) p = end;
    else p = br.p;
    ++scans;
    return OK;
  }

  // markers up to the frame header (header_only) or to the end of image
  int parse(bool header_only) {
    p = data;
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) return E_NOT_JPEG;
    p += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) saw_eoi = true;
      if (m == 0 || m == 0xD9) break;            // end of buffer / EOI
      if (m >= 0xD0 && m <= 0xD7) continue;      // stray RSTn
      if (m == 0x01) continue;                   // TEM
      const uint8_t* s;
      int len, e;
      if ((e = segment(s, len))) return e;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          if ((e = parse_sof(s, len, m == 0xC2))) return e;
          if (header_only) return OK;
          break;
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
          return E_LOSSLESS;
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          return E_ARITHMETIC;
        case 0xC4:
          if ((e = parse_dht(s, len))) return e;
          break;
        case 0xDB:
          if ((e = parse_dqt(s, len))) return e;
          break;
        case 0xDD:
          if (len < 2) return E_CORRUPT;
          restart_interval = u16(s);
          break;
        case 0xDA:
          if (header_only) return have_frame ? OK : E_NO_FRAME;
          if ((e = parse_sos(s, len))) return e;
          break;
        case 0xE0:
          if (len >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xE1:
          parse_exif(s, len);
          break;
        case 0xEE:
          if (len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = s[11];
          }
          break;
        default:
          break;                                 // APPn, COM, DNL, ...
      }
    }
    if (!have_frame) return E_NO_FRAME;
    if (!header_only && scans == 0) return E_CORRUPT;
    if (!header_only && !saw_eoi) return E_TRUNCATED;
    if (!header_only && progressive && would_smooth()) return E_PARTIAL;
    return OK;
  }

  bool is_rgb() const {
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // component plane (IDCT of its blocks), then upsampled to width x height
  void component_plane(const Component& c, std::vector<uint8_t>& full) {
    int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> plane(size_t(pw) * ph);
    int bx_n = c.wib, by_n = c.hib;
    for (int by = 0; by < by_n; ++by)
      for (int bx = 0; bx < bx_n; ++bx)
        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.q,
                   &plane[size_t(by) * 8 * pw + size_t(bx) * 8], pw);
    full.resize(size_t(width) * height);
    int he = hmax / c.h, ve = vmax / c.v;
    const int dw = c.dw, dh = c.dh;
    auto row = [&](int r) -> const uint8_t* {
      r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
      return &plane[size_t(r) * pw];
    };
    std::vector<uint8_t> line(size_t(dw) * he + 8);
    if (he == 1 && ve == 1) {
      for (int y = 0; y < height; ++y)
        std::memcpy(&full[size_t(y) * width], row(y), width);
    } else if (he == 2 && ve == 1 && dw > 2) {            // h2v1 fancy
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = row(y);
        uint8_t* o = line.data();
        int v = in[0];
        *o++ = uint8_t(v);
        *o++ = uint8_t((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = in[x] * 3;
          *o++ = uint8_t((v + in[x - 1] + 1) >> 2);
          *o++ = uint8_t((v + in[x + 1] + 2) >> 2);
        }
        v = in[dw - 1];
        *o++ = uint8_t((v * 3 + in[dw - 2] + 1) >> 2);
        *o++ = uint8_t(v);
        std::memcpy(&full[size_t(y) * width], line.data(), width);
      }
    } else if (he == 1 && ve == 2) {                      // h1v2 fancy
      for (int y = 0; y < height; ++y) {
        int r = y >> 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = &full[size_t(y) * width];
        for (int x = 0; x < width; ++x)
          o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (he == 2 && ve == 2 && dw > 2) {            // h2v2 fancy
      for (int y = 0; y < height; ++y) {
        int r = y >> 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
        uint8_t* o = line.data();
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        *o++ = uint8_t((this_sum * 4 + 8) >> 4);
        *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < dw; ++x) {
          next_sum = in0[x] * 3 + in1[x];
          *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = uint8_t((this_sum * 4 + 7) >> 4);
        std::memcpy(&full[size_t(y) * width], line.data(), width);
      }
    } else {                                               // box
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = row(y / ve);
        uint8_t* o = &full[size_t(y) * width];
        for (int x = 0; x < width; ++x) o[x] = in[x / he];
      }
    }
  }

  void color(uint8_t* out) {
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < ncomp; ++i) component_plane(comp[i], planes[i]);
    size_t n = size_t(width) * height;
    if (ncomp == 1) {
      const uint8_t* y = planes[0].data();
      for (size_t i = 0; i < n; ++i)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    const uint8_t *a = planes[0].data(), *b = planes[1].data(),
                  *c = planes[2].data();
    if (is_rgb()) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = a[i];
        out[3 * i + 1] = b[i];
        out[3 * i + 2] = c[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((91881 * x + half) >> 16);
      cb_b[i] = int((116130 * x + half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + half;
    }
    auto lim = [](int v) -> uint8_t {
      return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < n; ++i) {
      int y = a[i], cb = b[i], cr = c[i];
      out[3 * i] = lim(y + cr_r[cr]);
      out[3 * i + 1] = lim(y + int((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = lim(y + cb_b[cb]);
    }
  }
};

// ------------------------------------------------------------- encoder

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kBitsDcLuma[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChroma[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLuma[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValsAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChroma[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValsAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEncode {
  uint32_t code[256];
  uint8_t size[256];
};

void build_encode(HuffEncode& t, const uint8_t bits[17], const uint8_t* vals) {
  std::memset(t.size, 0, sizeof t.size);
  uint32_t c = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      t.code[vals[p]] = c++;
      t.size[vals[p]] = uint8_t(l);
    }
    c <<= 1;
  }
}

struct ByteOut {
  uint8_t* out;
  long cap;
  long n = 0;
  bool overflow = false;
  void put(uint8_t b) {
    if (n < cap) out[n] = b;
    else overflow = true;
    ++n;
  }
  void put16(int v) {
    put(uint8_t(v >> 8));
    put(uint8_t(v));
  }
};

struct BitWriter {
  ByteOut& o;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(ByteOut& out) : o(out) {}
  void emit(uint32_t code, int size) {
    for (int i = size - 1; i >= 0; --i) {
      acc = (acc << 1) | ((code >> i) & 1);
      if (++n == 8) {
        o.put(uint8_t(acc));
        if (acc == 0xFF) o.put(0);
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {
    if (n) emit(0x7F, 8 - n);
  }
};

// jfdctint.c jpeg_fdct_islow on centered samples, in place
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = int((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int S = CONST_BITS - PASS1_BITS;
    p[2] = int(descale(z1 + tmp13 * FIX_0_765366865, S));
    p[6] = int(descale(z1 + tmp12 * -FIX_1_847759065, S));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, S));
    p[5] = int(descale(tmp5 + z2 + z4, S));
    p[3] = int(descale(tmp6 + z2 + z3, S));
    p[1] = int(descale(tmp7 + z1 + z4, S));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, PASS1_BITS));
    p[32] = int(descale(tmp10 - tmp11, PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int S = CONST_BITS + PASS1_BITS;
    p[16] = int(descale(z1 + tmp13 * FIX_0_765366865, S));
    p[48] = int(descale(z1 + tmp12 * -FIX_1_847759065, S));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, S));
    p[40] = int(descale(tmp5 + z2 + z4, S));
    p[24] = int(descale(tmp6 + z2 + z3, S));
    p[8] = int(descale(tmp7 + z1 + z4, S));
  }
}

struct EncComponent {
  int h, v, tq;
  int wib, hib;               // width / height in blocks
  int pw, ph;                 // padded plane size
  std::vector<uint8_t> plane;
  std::vector<int16_t> blocks;  // quantized, natural order, wib x hib
  int pred = 0;
};

// one component's downsampled plane, padded as libjpeg pads it: pixel
// columns replicated out to the blocks' width, pixel rows to a multiple of
// vmax, downsampled rows to the iMCU rows' height
void downsample(const std::vector<uint8_t>& full, int width, int height,
                int hmax, int vmax, int mcuy, EncComponent& c) {
  int he = hmax / c.h, ve = vmax / c.v;
  c.pw = c.wib * 8;
  c.ph = mcuy * c.v * 8;
  c.plane.assign(size_t(c.pw) * c.ph, 0);
  int rows = (height + vmax - 1) / vmax * c.v;   // computed rows
  auto px = [&](int y, int x) -> int {
    y = std::min(y, height - 1);
    x = std::min(x, width - 1);
    return full[size_t(y) * width + x];
  };
  for (int r = 0; r < rows; ++r) {
    uint8_t* o = &c.plane[size_t(r) * c.pw];
    if (he == 1 && ve == 1) {
      for (int x = 0; x < c.pw; ++x) o[x] = uint8_t(px(r, x));
    } else if (he == 2 && ve == 1) {
      int bias = 0;
      for (int x = 0; x < c.pw; ++x) {
        o[x] = uint8_t((px(r, 2 * x) + px(r, 2 * x + 1) + bias) >> 1);
        bias ^= 1;
      }
    } else if (he == 2 && ve == 2) {
      int bias = 1;
      for (int x = 0; x < c.pw; ++x) {
        o[x] = uint8_t((px(2 * r, 2 * x) + px(2 * r, 2 * x + 1) +
                        px(2 * r + 1, 2 * x) + px(2 * r + 1, 2 * x + 1) +
                        bias) >> 2);
        bias ^= 3;
      }
    } else {
      int n = he * ve;
      for (int x = 0; x < c.pw; ++x) {
        int s = 0;
        for (int dy = 0; dy < ve; ++dy)
          for (int dx = 0; dx < he; ++dx) s += px(r * ve + dy, x * he + dx);
        o[x] = uint8_t((s + n / 2) / n);
      }
    }
  }
  for (int r = rows; r < c.ph; ++r)
    std::memcpy(&c.plane[size_t(r) * c.pw], &c.plane[size_t(rows - 1) * c.pw],
                c.pw);
}

void quantize_blocks(EncComponent& c, const uint16_t* q) {
  c.blocks.assign(size_t(c.wib) * c.hib * 64, 0);
  int d[64];
  for (int by = 0; by < c.hib; ++by)
    for (int bx = 0; bx < c.wib; ++bx) {
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          d[8 * y + x] =
              int(c.plane[size_t(by * 8 + y) * c.pw + bx * 8 + x]) - 128;
      fdct_islow(d);
      int16_t* o = &c.blocks[(size_t(by) * c.wib + bx) * 64];
      for (int i = 0; i < 64; ++i) {
        int qv = int(q[i]) << 3;
        int t = d[i];
        if (t < 0) o[i] = int16_t(-((-t + (qv >> 1)) / qv));
        else o[i] = int16_t((t + (qv >> 1)) / qv);
      }
    }
}

void encode_block(BitWriter& bw, const int16_t* blk, int& pred,
                  const HuffEncode& dc, const HuffEncode& ac) {
  int t = blk[0] - pred, t2 = t;
  pred = blk[0];
  if (t < 0) {
    t = -t;
    --t2;
  }
  int nb = 0;
  while (t) {
    ++nb;
    t >>= 1;
  }
  bw.emit(dc.code[nb], dc.size[nb]);
  if (nb) bw.emit(uint32_t(t2) & ((1u << nb) - 1), nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    t = blk[kNatural[k]];
    if (t == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.emit(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      --t2;
    }
    nb = 1;
    while ((t >>= 1)) ++nb;
    int i = (r << 4) + nb;
    bw.emit(ac.code[i], ac.size[i]);
    bw.emit(uint32_t(t2) & ((1u << nb) - 1), nb);
    r = 0;
  }
  if (r > 0) bw.emit(ac.code[0], ac.size[0]);
}

void write_dqt(ByteOut& o, int id, const uint16_t* q) {
  o.put16(0xFFDB);
  o.put16(67);
  o.put(uint8_t(id));
  for (int i = 0; i < 64; ++i) o.put(uint8_t(q[kNatural[i]]));
}

void write_dht(ByteOut& o, int index, const uint8_t bits[17],
               const uint8_t* vals) {
  int n = 0;
  for (int i = 1; i <= 16; ++i) n += bits[i];
  o.put16(0xFFC4);
  o.put16(2 + 1 + 16 + n);
  o.put(uint8_t(index));
  for (int i = 1; i <= 16; ++i) o.put(bits[i]);
  for (int i = 0; i < n; ++i) o.put(vals[i]);
}

}  // namespace

extern "C" {

// Frame header of a JPEG body: info = {width, height, components,
// EXIF orientation (1-8)}. 0, or an error code.
int og_jpeg_info(const uint8_t* buf, long len, int* info) try {
  Decoder d;
  d.data = buf;
  d.end = buf + len;
  int e = d.parse(true);
  if (e) return e;
  info[0] = d.width;
  info[1] = d.height;
  info[2] = d.ncomp;
  info[3] = d.orientation;
  return OK;
} catch (...) {
  return E_MEMORY;
}

// Decode a JPEG body into out, (height, width, 3) uint8 RGB, as stored
// (the EXIF orientation is left to the caller). 0, or an error code.
int og_jpeg_decode(const uint8_t* buf, long len, uint8_t* out, int width,
                   int height) try {
  Decoder d;
  d.data = buf;
  d.end = buf + len;
  int e = d.parse(false);
  if (e) return e;
  if (d.width != width || d.height != height) return E_SIZE;
  d.color(out);
  return OK;
} catch (...) {       // std::bad_alloc: no exception crosses the C ABI
  return E_MEMORY;
}

// Encode (height, width, channels) uint8 pixels (channels 1, or 3 in RGB
// order) as baseline JPEG with luma sampling factors (hs, vs) and chroma
// 1x1, at quality 1-100, a restart marker every `restart` MCUs (0: none).
// Writes up to cap bytes to out and the body's length to out_len; 0, or
// an error code (E_BUFFER: out_len holds the size needed).
int og_jpeg_encode(const uint8_t* px, int width, int height, int channels,
                   int quality, int hs, int vs, int restart, uint8_t* out,
                   long cap, long* out_len) try {
  if (width < 1 || height < 1 || width > 65500 || height > 65500 ||
      int64_t(width) * height > kMaxPixels)
    return E_SIZE;
  if (channels != 1 && channels != 3) return E_COMPONENTS;
  if (channels == 1) hs = vs = 1;
  if (hs < 1 || hs > 4 || vs < 1 || vs > 4) return E_SAMPLING;
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[2][64];
  for (int i = 0; i < 64; ++i) {
    const uint8_t base[2] = {kStdLuma[i], kStdChroma[i]};
    for (int t = 0; t < 2; ++t) {
      long v = (long(base[t]) * scale + 50) / 100;
      q[t][i] = uint16_t(std::min(std::max(v, 1L), 255L));
    }
  }
  int nc = channels;
  size_t n = size_t(width) * height;
  std::vector<uint8_t> planes[3];
  for (int i = 0; i < nc; ++i) planes[i].resize(n);
  if (nc == 1) {
    std::memcpy(planes[0].data(), px, n);
  } else {
    // jccolor.c rgb_ycc_convert
    int64_t tab[8 * 256];
    const int64_t half = int64_t(1) << 15, cbcr = int64_t(128) << 16;
    for (int i = 0; i < 256; ++i) {
      tab[i] = 19595LL * i;
      tab[256 + i] = 38470LL * i;
      tab[512 + i] = 7471LL * i + half;
      tab[768 + i] = -11059LL * i;
      tab[1024 + i] = -21709LL * i;
      tab[1280 + i] = 32768LL * i + cbcr + half - 1;
      tab[1536 + i] = -27439LL * i;
      tab[1792 + i] = -5329LL * i;
    }
    for (size_t i = 0; i < n; ++i) {
      int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      planes[0][i] = uint8_t((tab[r] + tab[256 + g] + tab[512 + b]) >> 16);
      planes[1][i] =
          uint8_t((tab[768 + r] + tab[1024 + g] + tab[1280 + b]) >> 16);
      planes[2][i] =
          uint8_t((tab[1280 + r] + tab[1536 + g] + tab[1792 + b]) >> 16);
    }
  }
  int hmax = hs, vmax = vs;
  int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  EncComponent comp[3];
  for (int i = 0; i < nc; ++i) {
    EncComponent& c = comp[i];
    c.h = i == 0 ? hs : 1;
    c.v = i == 0 ? vs : 1;
    c.tq = i == 0 ? 0 : 1;
    c.wib = int((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
    c.hib = int((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
    downsample(planes[i], width, height, hmax, vmax, mcuy, c);
    quantize_blocks(c, q[c.tq]);
  }

  ByteOut o{out, cap};
  o.put16(0xFFD8);
  const uint8_t jfif[16] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                            1,    1,    0, 0,  1,   0,   1};
  for (uint8_t b : jfif) o.put(b);
  o.put(0);
  o.put(0);
  write_dqt(o, 0, q[0]);
  if (nc == 3) write_dqt(o, 1, q[1]);
  o.put16(0xFFC0);
  o.put16(8 + 3 * nc);
  o.put(8);
  o.put16(height);
  o.put16(width);
  o.put(uint8_t(nc));
  for (int i = 0; i < nc; ++i) {
    o.put(uint8_t(i + 1));
    o.put(uint8_t((comp[i].h << 4) | comp[i].v));
    o.put(uint8_t(comp[i].tq));
  }
  write_dht(o, 0x00, kBitsDcLuma, kValsDc);
  write_dht(o, 0x10, kBitsAcLuma, kValsAcLuma);
  if (nc == 3) {
    write_dht(o, 0x01, kBitsDcChroma, kValsDc);
    write_dht(o, 0x11, kBitsAcChroma, kValsAcChroma);
  }
  if (restart > 0) {
    o.put16(0xFFDD);
    o.put16(4);
    o.put16(restart);
  }
  o.put16(0xFFDA);
  o.put16(6 + 2 * nc);
  o.put(uint8_t(nc));
  for (int i = 0; i < nc; ++i) {
    o.put(uint8_t(i + 1));
    o.put(i == 0 ? 0x00 : 0x11);
  }
  o.put(0);
  o.put(63);
  o.put(0);

  HuffEncode dc[2], ac[2];
  build_encode(dc[0], kBitsDcLuma, kValsDc);
  build_encode(ac[0], kBitsAcLuma, kValsAcLuma);
  build_encode(dc[1], kBitsDcChroma, kValsDc);
  build_encode(ac[1], kBitsAcChroma, kValsAcChroma);
  BitWriter bw(o);
  long total, across;
  if (nc == 1) {
    across = comp[0].wib;
    total = long(comp[0].wib) * comp[0].hib;
  } else {
    across = mcux;
    total = long(mcux) * mcuy;
  }
  int togo = restart, next_rst = 0;
  int16_t dummy[64];
  for (long m = 0; m < total; ++m) {
    if (restart > 0) {
      if (togo == 0) {
        bw.flush();
        o.put(0xFF);
        o.put(uint8_t(0xD0 + next_rst));
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < nc; ++i) comp[i].pred = 0;
        togo = restart;
      }
      --togo;
    }
    long mx = m % across, my = m / across;
    if (nc == 1) {
      EncComponent& c = comp[0];
      encode_block(bw, &c.blocks[(size_t(my) * c.wib + mx) * 64], c.pred,
                   dc[0], ac[0]);
      continue;
    }
    for (int i = 0; i < nc; ++i) {
      EncComponent& c = comp[i];
      int t = c.tq;
      // blocks of this MCU; those past the component's blocks are
      // libjpeg's dummies: zero AC and the DC of the MCU's block before
      // them (at the bottom: the last block of the row above)
      int16_t last_dc = 0;
      for (int y = 0; y < c.v; ++y) {
        int by = int(my) * c.v + y;
        for (int x = 0; x < c.h; ++x) {
          int bx = int(mx) * c.h + x;
          const int16_t* blk = dummy;
          if (by < c.hib && bx < c.wib) {
            blk = &c.blocks[(size_t(by) * c.wib + bx) * 64];
          } else {
            std::memset(dummy, 0, sizeof dummy);
            dummy[0] = last_dc;
          }
          encode_block(bw, blk, c.pred, dc[t], ac[t]);
          last_dc = blk[0];
        }
      }
    }
  }
  bw.flush();
  o.put16(0xFFD9);
  *out_len = o.n;
  return o.overflow ? E_BUFFER : OK;
} catch (...) {
  return E_MEMORY;
}

// PNG scanline unfiltering: `in` holds rows of (1 filter byte + rowbytes)
// bytes; `out` receives rows x rowbytes. bpp is the filter's byte
// distance (bytes per complete pixel, at least 1). 0, or E_PNG_FILTER.
int og_png_unfilter(const uint8_t* in, int rows, int rowbytes, int bpp,
                    uint8_t* out) {
  for (int r = 0; r < rows; ++r) {
    const uint8_t* f = in + size_t(r) * (rowbytes + 1);
    int type = f[0];
    const uint8_t* s = f + 1;
    uint8_t* o = out + size_t(r) * rowbytes;
    const uint8_t* up = r ? o - rowbytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(o, s, rowbytes);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          o[i] = uint8_t(s[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i)
          o[i] = uint8_t(s[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          o[i] = uint8_t(s[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
              pc = p > c ? p - c : c - p;
          o[i] = uint8_t(s[i] + ((pa <= pb && pa <= pc) ? a
                                 : (pb <= pc ? b : c)));
        }
        break;
      default:
        return E_PNG_FILTER;
    }
  }
  return OK;
}

}  // extern "C"
