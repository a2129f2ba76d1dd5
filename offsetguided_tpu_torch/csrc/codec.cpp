// JPEG decode and baseline encode, and PNG scanline unfiltering, in integer
// arithmetic only: the image codec of the port (`data/codec.py` binds it).
//
// The decoder gives the pixels libjpeg-turbo 3.x gives with its default
// decompression settings, which is what cv2.imdecode(..., IMREAD_COLOR)
// returns (channels reversed): the slow-but-accurate integer IDCT
// (jidctint.c: CONST_BITS 13, PASS1_BITS 2) with the 16-bit wraps and
// saturations of the x86 SIMD code cv2 runs, "fancy" triangle upsampling for h2v1 / h2v2 (where the
// component's downsampled width is above 2) and h1v2 components, box
// replication for the other integral factors (4:1:1 among them), and
// jdcolor.c's YCbCr -> RGB tables.
//
// Decoded: 8-bit DCT streams, sequential or progressive, Huffman-coded
// (SOF0, SOF1, SOF2) or arithmetic-coded (SOF9, SOF10), interleaved scans
// or not, restart markers (resynchronized as jdmarker.c does when their
// numbers are off), one, three or four components with any integral
// sampling factors. Refused, each with its own error code, where
// cv2.imdecode returns nothing: lossless (SOF3, SOF7, SOF11, SOF15),
// hierarchical (SOF5-7, SOF13-15) and 12-bit streams, two or more than four
// components, fractional sampling, an interleaved scan of more than ten
// blocks to the MCU, a dimension above 65500.
//
// Huffman entropy data cut short by a marker decodes as zero bits up to
// the end of that MCU, and the MCUs after it in the segment are left as
// they are (jdhuff.c / jdphuff.c insufficient_data). Arithmetic-coded data
// (jdarith.c: the QM decoder with T.81's Table D.2, DAC conditioning, the
// Kx split of the AC magnitude contexts, the fixed 0.5 bin for signs and
// DC refinement) reads zero bytes past a marker, and after a bad code (a
// magnitude or a run past the block) the rest of its restart interval is
// left as it is. A body that ends before its EOI marker is refused
// (E_TRUNCATED), as cv2.imdecode returns nothing for it.
//
// Progressive scans fill the whole-image coefficient buffer; the IDCT,
// upsampling and colour conversion then run as for a sequential stream.
// Where, after the last scan, one of the first nine AC coefficients
// (zigzag 1-9) of some component is not fully refined, the blocks are
// smoothed as libjpeg-turbo 3.x smooths them (jdcoefct.c smoothing_ok and
// decompress_smooth_data): those coefficients, where still zero, are
// estimated from the DC values of the 5x5 blocks around, with the previous
// scan's precision for the iMCU rows a starved last scan did not reach.
//
// Four components are CMYK, or YCCK where an Adobe marker's transform is
// not 0 (jdapimin.c); YCCK goes to CMYK by jdcolor.c's ycck_cmyk_convert,
// and CMYK to RGB by OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, which cv2.imdecode
// applies under IMREAD_COLOR: each of R, G, B is k - ((255 - x) * k >> 8)
// of C, M, Y (k = K).
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

// One 1-D pass of the islow IDCT over 8 values (stride `st`) as
// libjpeg-turbo's x86 SIMD code (jidctint-sse2 / -avx2.asm) computes it:
// the products in 32 bits, but in0 + in4, in0 - in4 and the odd part's z3
// = in7 + in3, z4 = in5 + in1 as 16-bit sums, which wrap. `out` gets the
// eight results before their descale.
inline void idct_pass(const int16_t* in, int st, int64_t* out) {
  auto w16 = [](int64_t x) -> int64_t { return int16_t(uint16_t(x)); };
  const int64_t z2 = in[2 * st], z3 = in[6 * st];
  const int64_t tmp3 = z2 * (FIX_0_541196100 + FIX_0_765366865) +
                       z3 * FIX_0_541196100;
  const int64_t tmp2 = z2 * FIX_0_541196100 +
                       z3 * (FIX_0_541196100 - FIX_1_847759065);
  const int64_t tmp0 = w16(int64_t(in[0]) + in[4 * st]) * (1 << CONST_BITS);
  const int64_t tmp1 = w16(int64_t(in[0]) - in[4 * st]) * (1 << CONST_BITS);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t t0 = in[7 * st], t1 = in[5 * st], t2 = in[3 * st],
                t3 = in[st];
  const int64_t z3s = w16(t0 + t2), z4s = w16(t1 + t3);
  const int64_t z3r = z3s * (FIX_1_175875602 - FIX_1_961570560) +
                      z4s * FIX_1_175875602;
  const int64_t z4r = z3s * FIX_1_175875602 +
                      z4s * (FIX_1_175875602 - FIX_0_390180644);
  const int64_t o0 = t0 * (FIX_0_298631336 - FIX_0_899976223) +
                     t3 * -FIX_0_899976223 + z3r;
  const int64_t o3 = t0 * -FIX_0_899976223 +
                     t3 * (FIX_1_501321110 - FIX_0_899976223) + z4r;
  const int64_t o1 = t1 * (FIX_2_053119869 - FIX_2_562915447) +
                     t2 * -FIX_2_562915447 + z4r;
  const int64_t o2 = t1 * -FIX_2_562915447 +
                     t2 * (FIX_3_072711026 - FIX_2_562915447) + z3r;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

inline int16_t sat16(int64_t x) {
  return int16_t(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}

// jpeg_idct_islow as libjpeg-turbo runs it on x86 (what cv2.imdecode runs):
// one block of natural-order coefficients and its natural-order
// quantization table -> 8x8 samples at `out` (row stride). The
// dequantized coefficients are 16-bit products (pmullw) and the pass-1
// results 16-bit saturated (packssdw); a block whose rows 1-7 are all zero
// takes the shortcut (coef * q) << PASS1_BITS in 16 bits; the outputs
// saturate to [-128, 127] before the +128 (packsswb). On any block of a
// body libjpeg writes this equals jidctint.c's C code, whose range-limit
// table wraps instead.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int16_t dq[64], ws[64];
  bool ac_rows = false;
  for (int i = 0; i < 64; ++i) {
    dq[i] = int16_t(uint16_t(uint32_t(uint16_t(coef[i])) * q[i]));
    ac_rows |= i >= 8 && coef[i] != 0;
  }
  int64_t t[8];
  if (!ac_rows) {
    for (int c = 0; c < 8; ++c) {
      const int16_t v = int16_t(uint16_t(uint16_t(dq[c]) << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      idct_pass(dq + c, 8, t);
      for (int r = 0; r < 8; ++r)
        ws[8 * r + c] = sat16(descale(t[r], CONST_BITS - PASS1_BITS));
    }
  }
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + 8 * r, 1, t);
    uint8_t* o = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      int64_t v = descale(t[c], CONST_BITS + PASS1_BITS + 3);
      o[c] = uint8_t((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// ------------------------------------------------------------- Huffman

struct HuffDecode {
  bool defined = false;
  bool valid = false;         // defined, and not over-subscribed
  bool dc_ok = false;         // every symbol <= 15: usable as a DC table
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
  t.dc_ok = std::all_of(vals, vals + nvals, [](uint8_t v) { return v <= 15; });
  return true;
}

// The standard Huffman tables (T.81 K.3): the encoder's, and the decoder's
// when a stream leaves slots 0 and 1 undefined (jstdhuff.c).
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

// ------------------------------------------------------- entropy data

// jdmarker.c next_marker from p: bytes up to an 0xFF skipped, fill 0xFFs
// skipped, FF00 passed over; `at` gets the marker's first 0xFF and p
// points past its code. 0x100 (with p and at at the end) when the buffer
// ends first.
int scan_marker(const uint8_t*& p, const uint8_t* end, const uint8_t*& at) {
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    if (p >= end) break;
    at = p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) break;
    int m = *p++;
    if (m != 0) return m;
  }
  at = p = end;
  return 0x100;
}

// The entropy-coded data of a scan: the read position, and the marker
// that stopped it (libjpeg's unread_marker: 0 none, 0x100 the buffer's
// end) with its first byte.
struct Stream {
  const uint8_t* p;
  const uint8_t* end;
  int marker = 0;
  const uint8_t* marker_at = nullptr;

  // the next data byte, -1 (marker set) at a marker or the buffer's end
  int byte() {
    if (p >= end) {
      marker = 0x100;
      marker_at = end;
      return -1;
    }
    const uint8_t* at = p;
    int c = *p++;
    if (c != 0xFF) return c;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) {
      marker = 0x100;
      marker_at = end;
      return -1;
    }
    c = *p++;
    if (c == 0) return 0xFF;
    marker = c;
    marker_at = at;
    return -1;
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart for restart
  // number `want`: true when a marker was taken and the data resumes
  // after it, false when a marker is left in the way (the segment then
  // reads past the data)
  bool restart(int want) {
    if (!marker) marker = scan_marker(p, end, marker_at);
    for (;;) {
      int action;
      const int rst = 0xD0;
      if (marker == rst + want) action = 1;
      else if (marker < 0xC0) action = 2;              // not a valid marker
      else if (marker < rst || marker > rst + 7) action = 3;
      else if (marker == rst + ((want + 1) & 7) ||
               marker == rst + ((want + 2) & 7)) action = 3;
      else if (marker == rst + ((want - 1) & 7) ||
               marker == rst + ((want - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) {
        marker = 0;
        return true;
      }
      if (action == 3) return false;
      marker = scan_marker(p, end, marker_at);
    }
  }
};

// Huffman-coded bits: 0xFF00 is a data 0xFF; a marker stops the stream,
// after which (as at the end of the buffer) zero bits are fed.
struct BitReader {
  Stream s;
  uint64_t buf = 0;
  int n = 0;
  int pad = 0;                // zero bits fed past the data, at buf's end
  bool starved = false;       // a bit past the data was consumed

  void fill() {
    while (n <= 56) {
      unsigned c = 0;
      if (!s.marker) {
        int b = s.byte();
        c = b < 0 ? 0 : unsigned(b);
      }
      buf = (buf << 8) | c;
      n += 8;
      if (s.marker) pad += 8;
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
  // jdhuff.c process_restart: the buffered bits dropped; the out-of-data
  // flag cleared unless a marker is left in the way
  void restart(int want) {
    buf = 0;
    n = 0;
    pad = 0;
    if (s.restart(want)) starved = false;
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
  // jdhuff.c jpeg_huff_decode: no code of 16 bits or fewer; the 17th bit
  // is read too and the symbol taken as 0 (a warning, not an error)
  br.peek(17);
  br.skip(17);
  return 0;
}

// T.81 Table D.2 as jdarith.c's jpeg_aritab packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is
// libjpeg's fixed 0.5 bin
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's QM decoder: C and A registers, the bit counter (-16 before
// the first two bytes; -1 after a bad code, until the next restart)
struct ArithReader {
  Stream s;
  int64_t c = 0, a = 0;
  int ct = -16;

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  // arith_decode: one binary decision with the statistics bin st
  int decode(uint8_t& st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!s.marker) {
          data = s.byte();
          if (data < 0) data = 0;     // a marker: zero data from here on
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // got the two initial bytes
      }
      a <<= 1;
    }
    int sv = st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// ------------------------------------------------------------- decoder

constexpr int kMaxDimension = 65500;   // libjpeg's JPEG_MAX_DIMENSION
constexpr int kMaxBlocksInMcu = 10;    // D_MAX_BLOCKS_IN_MCU

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;         // downsampled size in samples
  int wib = 0, hib = 0;       // width / height in blocks
  int bw = 0, bh = 0;         // allocated blocks (MCU padded)
  bool q_latched = false;
  uint16_t q[64];
  int dc_tbl = 0, ac_tbl = 0, pred = 0;
  int dc_ctx = 0;             // arithmetic DC conditioning (0, 4, 8, 12, 16)
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
  Component comp[4];
  int scans = 0;
  bool saw_eoi = false;
  // libjpeg's has_multiple_scans is false (one sequential scan of every
  // component); the last scan's data ran to the buffer's end
  bool single_scan = false, past_end = false;
  bool progressive = false, arith = false;
  // jdphuff.c / jdarith.c progression status by zigzag index: the low bit
  // last sent (-1 none), and its value before the component's last scan
  int coef_bits[4][64], prev_bits[4][64];
  int eobrun = 0;
  // jdcoefct.c: the last iMCU row fetched before the data ran out, and
  // whether the blocks are smoothed
  long last_good_row = 0;
  bool smoothing = false;
  // jdarith.c statistics and DAC conditioning (get_soi's defaults)
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  int arith_L[16], arith_U[16], arith_K[16];

  Decoder() {
    for (int i = 0; i < 16; ++i) {
      arith_L[i] = 0;
      arith_U[i] = 1;
      arith_K[i] = 5;
    }
  }

  int u16(const uint8_t* q) const { return (q[0] << 8) | q[1]; }

  // the next marker code at or after p (skipping garbage, as libjpeg's
  // next_marker does); 0 at the end of the buffer
  int next_marker() {
    const uint8_t* at;
    int m = scan_marker(p, end, at);
    return m == 0x100 ? 0 : m;
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

  int parse_sof(const uint8_t* s, int len, bool prog, bool ac) {
    if (have_frame) return E_CORRUPT;
    progressive = prog;
    arith = ac;
    std::memset(coef_bits, 0xFF, sizeof coef_bits);
    std::memset(prev_bits, 0xFF, sizeof prev_bits);
    if (len < 6) return E_CORRUPT;
    if (s[0] != 8) return E_PRECISION;
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = s[5];
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return E_COMPONENTS;
    if (len != 6 + 3 * ncomp) return E_CORRUPT;
    if (width <= 0 || height <= 0 || width > kMaxDimension ||
        height > kMaxDimension || int64_t(width) * height > kMaxPixels)
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
      // an over-subscribed table is refused where a scan uses it
      // (jpeg_make_d_derived_tbl), not where it is defined
      HuffDecode& t = tc ? ac[th] : dc[th];
      t.valid = build_huff(t, bits, s + o, total);
      t.defined = true;
      o += total;
    }
    return OK;
  }

  int parse_dqt(const uint8_t* s, int len) {
    int o = 0;
    while (o < len) {
      int pq = s[o] >> 4, tq = s[o] & 15;
      if (tq > 3) return E_TABLES;
      if (pq) pq = 1;                      // jdmarker.c: any nonzero is 16-bit
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

  // jdmarker.c get_dac: (table, value) pairs; DC tables 0-15 take L (low
  // nibble) <= U (high nibble), AC tables 16-31 take Kx
  int parse_dac(const uint8_t* s, int len) {
    if (len % 2) return E_CORRUPT;
    for (int o = 0; o < len; o += 2) {
      int index = s[o], val = s[o + 1];
      if (index >= 32) return E_TABLES;
      if (index >= 16) {
        arith_K[index - 16] = val;
      } else {
        arith_L[index] = val & 15;
        arith_U[index] = val >> 4;
        if (arith_L[index] > arith_U[index]) return E_TABLES;
      }
    }
    return OK;
  }

  // ---------------------------------------------- Huffman-coded blocks

  int decode_block(BitReader& br, Component& c, int16_t* blk) {
    int s = decode_huff(br, dc[c.dc_tbl]);
    int diff = s ? extend(br.get(s), s) : 0;
    if (!add_pred(c, diff)) return E_CORRUPT;
    blk[0] = int16_t(c.pred);
    const HuffDecode& t = ac[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huff(br, t);
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

  // ------------------------------------------ arithmetic-coded blocks

  // jdarith.c F.2.4.1: the component's DC difference added to its
  // predictor (modulo 2^16); false on a bad code (ct = -1)
  bool arith_dc(ArithReader& ar, Component& c) {
    const int tbl = c.dc_tbl;
    uint8_t* st = dc_stats[tbl] + c.dc_ctx;
    if (ar.decode(*st) == 0) {
      c.dc_ctx = 0;
      return true;
    }
    const int sign = ar.decode(st[1]);
    st += 2 + sign;
    int m = ar.decode(*st);
    if (m) {
      st = dc_stats[tbl] + 20;                   // X1
      while (ar.decode(*st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;                            // magnitude overflow
          return false;
        }
        ++st;
      }
    }
    if (m < ((1 << arith_L[tbl]) >> 1)) c.dc_ctx = 0;
    else if (m > ((1 << arith_U[tbl]) >> 1)) c.dc_ctx = 12 + sign * 4;
    else c.dc_ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(*st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c.pred = (c.pred + v) & 0xFFFF;
    return true;
  }

  // F.2.4.2 / G.2: the band ss..se of one block, scaled by 2^al; false on
  // a bad code (a run or a magnitude past its end)
  bool arith_ac(ArithReader& ar, const Component& c, int16_t* blk, int ss,
                int se, int al) {
    const int tbl = c.ac_tbl;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(*st)) break;                 // EOB
      while (ar.decode(st[1]) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;                            // spectral overflow
          return false;
        }
      }
      const int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(*st);
      if (m && ar.decode(*st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_K[tbl] ? 189 : 217);
        while (ar.decode(*st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;                          // magnitude overflow
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(*st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(unsigned(v) << al);
    }
    return true;
  }

  // decode_mcu_AC_refine: past the previous stage's end of block an EOB
  // decision, then a correction bit for each nonzero coefficient and a
  // new-coefficient decision for each zero one
  bool arith_ac_refine(ArithReader& ar, const Component& c, int16_t* blk,
                       int ss, int se, int al) {
    const int tbl = c.ac_tbl;
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(*st)) break;     // EOB
      for (;;) {
        int16_t& coef = blk[kNatural[k]];
        if (coef) {
          if (ar.decode(st[2])) coef = int16_t(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st[1])) {
          coef = int16_t(ar.decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;                            // spectral overflow
          return false;
        }
      }
    }
    return true;
  }

  // jdcoefct.c smoothing_ok, after the last scan (SAVED_COEFS 10)
  bool smoothing_ok() const {
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

  // one block of the current scan: sequential, or the progressive kind;
  // for arithmetic scans, OK also after a bad code (ct = -1)
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
  void arith_block(Kind kind, ArithReader& ar, Component& c, int16_t* blk,
                   int ss, int se, int al) {
    switch (kind) {
      case SEQUENTIAL:
        if (!arith_dc(ar, c)) return;
        blk[0] = int16_t(c.pred);
        arith_ac(ar, c, blk, 1, 63, 0);
        return;
      case DC_FIRST:
        if (arith_dc(ar, c)) blk[0] = int16_t(unsigned(c.pred) << al);
        return;
      case DC_REFINE:
        if (ar.decode(fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
        return;
      case AC_FIRST:
        arith_ac(ar, c, blk, ss, se, al);
        return;
      default:
        arith_ac_refine(ar, c, blk, ss, se, al);
    }
  }

  int parse_sos(const uint8_t* s, int len) {
    if (!have_frame) return E_NO_FRAME;
    if (len < 1) return E_CORRUPT;
    int ns = s[0];
    if (ns < 1 || ns > ncomp || len != 4 + 2 * ns) return E_CORRUPT;
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    Kind kind = SEQUENTIAL;
    if (progressive) {
      // start_pass's JERR_BAD_PROGRESSION
      if (ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1))
        return E_CORRUPT;
      if ((ah != 0 && al != ah - 1) || al > 13) return E_CORRUPT;
      kind = ss == 0 ? (ah ? DC_REFINE : DC_FIRST)
                     : (ah ? AC_REFINE : AC_FIRST);
    }
    // the Huffman tables this kind of scan reads
    const bool need_dc = kind == SEQUENTIAL || kind == DC_FIRST;
    const bool need_ac = kind == SEQUENTIAL || kind >= AC_FIRST;
    if (!arith && !progressive && scans == 0) {
      // jdhuff.c std_huff_tables, when the sequential decoder starts
      const uint8_t* bits[4] = {kBitsDcLuma, kBitsDcChroma, kBitsAcLuma,
                                kBitsAcChroma};
      const uint8_t* vals[4] = {kValsDc, kValsDc, kValsAcLuma,
                                kValsAcChroma};
      for (int i = 0; i < 4; ++i) {
        HuffDecode& t = i < 2 ? dc[i] : ac[i - 2];
        if (t.defined) continue;
        int n = 0;
        for (int l = 1; l <= 16; ++l) n += bits[i][l];
        t.valid = t.defined = build_huff(t, bits[i], vals[i], n);
      }
    }
    Component* sc[4];
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) sc[i] = &comp[j];
      if (!sc[i]) return E_CORRUPT;
      sc[i]->dc_tbl = s[2 + 2 * i] >> 4;
      sc[i]->ac_tbl = s[2 + 2 * i] & 15;
      if (!arith) {
        // jdhuff.c jpeg_make_d_derived_tbl, for the tables the scan reads
        if ((need_dc && (sc[i]->dc_tbl > 3 || !dc[sc[i]->dc_tbl].valid)) ||
            (need_ac && (sc[i]->ac_tbl > 3 || !ac[sc[i]->ac_tbl].valid)))
          return E_TABLES;
        if (need_dc && !dc[sc[i]->dc_tbl].dc_ok) return E_HUFFMAN;
      }
      if (!sc[i]->q_latched) {
        if (!qt_defined[sc[i]->tq]) return E_TABLES;
        std::memcpy(sc[i]->q, qt[sc[i]->tq], sizeof sc[i]->q);
        sc[i]->q_latched = true;
      }
      blocks_in_mcu += sc[i]->h * sc[i]->v;
    }
    // jdinput.c per_scan_setup's JERR_BAD_MCU_SIZE
    if (ns > 1 && blocks_in_mcu > kMaxBlocksInMcu) return E_SAMPLING;
    const int scan_number = scans + 1;
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      c.pred = 0;
      c.dc_ctx = 0;
      if (!progressive) continue;
      int* bits = coef_bits[&c - comp];
      int* prev = prev_bits[&c - comp];
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
        prev[k] = scan_number > 1 ? bits[k] : 0;
      for (int k = ss; k <= se; ++k) bits[k] = al;
    }
    const bool dc_stats_used = !progressive || (ss == 0 && ah == 0);
    const bool ac_stats_used = !progressive || ss != 0;
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (dc_stats_used) {
          std::memset(dc_stats[sc[i]->dc_tbl], 0, sizeof dc_stats[0]);
          sc[i]->pred = 0;
          sc[i]->dc_ctx = 0;
        }
        if (ac_stats_used)
          std::memset(ac_stats[sc[i]->ac_tbl], 0, sizeof ac_stats[0]);
      }
    };
    if (arith) reset_stats();
    eobrun = 0;

    BitReader br;
    ArithReader ar;
    br.s.p = ar.s.p = p;
    br.s.end = ar.s.end = end;
    long total, across;
    if (ns == 1) {
      across = sc[0]->wib;
      total = long(sc[0]->wib) * sc[0]->hib;
    } else {
      across = mcux;
      total = long(mcux) * mcuy;
    }
    int togo = restart_interval, next_rst = 0;
    for (long m = 0; m < total; ++m) {
      long mx = m % across, my = m / across;
      // jdcoefct.c consume_data, before the MCU (and its restart)
      if (arith || !br.starved) last_good_row = ns == 1 ? my / sc[0]->v : my;
      if (restart_interval) {
        if (togo == 0) {
          if (arith) {
            ar.s.restart(next_rst);
            reset_stats();
            ar.reset();
          } else {
            br.restart(next_rst);
            for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
            eobrun = 0;
          }
          next_rst = (next_rst + 1) & 7;
          togo = restart_interval;
        }
        --togo;
      }
      if (arith) {
        // jdarith.c: after a bad code, nothing until the next restart
        if (ar.ct == -1) continue;
      } else if (br.starved && kind != DC_REFINE) {
        // jdhuff.c / jdphuff.c: once the data has run out, the rest of
        // the segment is left as it is (a DC refinement reading zero bits
        // changes nothing)
        continue;
      }
      if (ns == 1) {
        Component& c = *sc[0];
        int16_t* blk = &c.coef[(size_t(my) * c.bw + mx) * 64];
        if (arith) {
          arith_block(kind, ar, c, blk, ss, se, al);
        } else {
          int e = block(kind, br, c, blk, ss, se, al);
          if (e) return e;
        }
        continue;
      }
      for (int i = 0; i < ns && ar.ct != -1; ++i) {
        Component& c = *sc[i];
        for (int y = 0; y < c.v && ar.ct != -1; ++y)
          for (int x = 0; x < c.h && ar.ct != -1; ++x) {
            size_t bx = size_t(mx) * c.h + x, by = size_t(my) * c.v + y;
            int16_t* blk = &c.coef[(by * c.bw + bx) * 64];
            if (arith) {
              arith_block(kind, ar, c, blk, ss, se, al);
            } else {
              int e = block(kind, br, c, blk, ss, se, al);
              if (e) return e;
            }
          }
      }
    }
    // resume the marker parser at the marker that ended the scan
    const Stream& st = arith ? ar.s : br.s;
    if (st.marker == 0x100) p = end;
    else if (st.marker) p = st.marker_at;
    else p = st.p;
    if (scans == 0) single_scan = !progressive && ns == ncomp;
    past_end = st.marker == 0x100;
    ++scans;
    return OK;
  }

  // markers up to the frame header (header_only) or to the end of image
  int parse(bool header_only) {
    // SOI, and the first byte of the next marker: the signature by which
    // cv2.imdecode picks its JPEG decoder
    p = data;
    if (end - p < 3 || p[0] != 0xFF || p[1] != 0xD8 || p[2] != 0xFF)
      return E_NOT_JPEG;
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
        case 0xC9:
        case 0xCA:
          if ((e = parse_sof(s, len, m == 0xC2 || m == 0xCA, m >= 0xC9)))
            return e;
          if (header_only) return OK;
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC8:
        case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return E_LOSSLESS;
        case 0xCC:
          if ((e = parse_dac(s, len))) return e;
          break;
        case 0xC4:
          if ((e = parse_dht(s, len))) return e;
          break;
        case 0xDB:
          if ((e = parse_dqt(s, len))) return e;
          break;
        case 0xDD:
          if (len != 2) return E_CORRUPT;
          restart_interval = u16(s);
          break;
        case 0xDA:
          if (header_only) return have_frame ? OK : E_NO_FRAME;
          if ((e = parse_sos(s, len))) return e;
          // one scan of every component: cv2 has the pixels once it is
          // decoded, and the markers after it (read by
          // jpeg_finish_decompress) no longer matter; the data must not
          // have run past the buffer's end
          if (single_scan) return past_end ? E_TRUNCATED : OK;
          break;
        case 0xE0:
          // jdmarker.c examine_app0: 14 bytes at least, before the first
          // scan (jpeg_read_header fixes the colour space there)
          if (!scans && len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0)
            saw_jfif = true;
          break;
        case 0xE1:
          parse_exif(s, len);
          break;
        case 0xEE:
          if (!scans && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = s[11];
          }
          break;
        default:
          // other APPn, COM and DNL are skipped; jdmarker.c read_markers
          // errs on any other marker (a second SOI among them)
          if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC))
            return E_CORRUPT;
      }
    }
    if (!have_frame) return E_NO_FRAME;
    if (!header_only && scans == 0) return E_CORRUPT;
    if (!header_only && !saw_eoi) return E_TRUNCATED;
    if (!header_only) {
      smoothing = progressive && smoothing_ok();
      if (smoothing) latch();
    }
    return OK;
  }

  // smoothing_ok's coef_bits_latch: the precision of zigzag 1-9 after the
  // last scan, and before each component's last scan (-1 with one scan)
  int latch_bits[4][10], latch_prev[4][10];
  void latch() {
    for (int i = 0; i < ncomp; ++i)
      for (int k = 0; k < 10; ++k) {
        latch_bits[i][k] = coef_bits[i][k];
        latch_prev[i][k] = scans > 1 ? prev_bits[i][k] : -1;
      }
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.x) for block (by,
  // bx) of component ci, into ws: where a coefficient of zigzag 1-9 is zero
  // and not known to full precision, it is estimated from the DC values of
  // the 5x5 blocks around (rows as the iMCU row arithmetic gives them,
  // columns clamped to the component's blocks). With no AC data at all the
  // DC is interpolated and the nine are estimated with Gaussian-like
  // kernels; otherwise the first five with those of T.81 K.8 widened to
  // 5x5.
  void smooth_block(int ci, int by, int bx, int16_t* ws) const {
    const Component& c = comp[ci];
    std::memcpy(ws, &c.coef[(size_t(by) * c.bw + bx) * 64], 64 * 2);
    const long T = mcuy, R = by / c.v, br = by % c.v;
    long block_rows = c.v;
    if (R == T - 1) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const long ibr = R * block_rows + br, ibrs = block_rows * T;
    int rows[5];
    rows[2] = by;
    rows[1] = ibr > 0 ? by - 1 : by;
    rows[0] = ibr > 1 ? by - 2 : rows[1];
    rows[3] = ibr < ibrs - 1 ? by + 1 : by;
    rows[4] = ibr < ibrs - 2 ? by + 2 : rows[3];
    int64_t D[26];                        // DC01 .. DC25 at D[1] .. D[25]
    for (int r = 0; r < 5; ++r)
      for (int k = 0; k < 5; ++k) {
        int x = std::min(std::max(bx + k - 2, 0), c.wib - 1);
        D[1 + 5 * r + k] = c.coef[(size_t(rows[r]) * c.bw + x) * 64];
      }
    const int* bits = R > last_good_row ? latch_prev[ci] : latch_bits[ci];
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc &= bits[k] == -1;
    const int64_t Q00 = c.q[0];
    auto estimate = [&](int zz, int pos, int64_t num) {
      const int Al = bits[zz];
      if (Al == 0 || ws[pos] != 0) return;
      const int64_t q = c.q[pos];
      num *= Q00;
      int pred;
      if (num >= 0) {
        pred = int(((q << 7) + num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      } else {
        pred = int(((q << 7) - num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
        pred = -pred;
      }
      ws[pos] = int16_t(pred);
    };
    if (change_dc) {
      // the DC itself: a 5x5 kernel of sum 128, rounded half away from 0
      const int64_t num =
          -D[1] - 3 * D[2] - 4 * D[3] - 3 * D[4] - D[5] - 3 * D[6] +
          3 * D[7] + 21 * D[8] + 3 * D[9] - 3 * D[10] - 4 * D[11] +
          21 * D[12] + 76 * D[13] + 21 * D[14] - 4 * D[15] - 3 * D[16] +
          3 * D[17] + 21 * D[18] + 3 * D[19] - 3 * D[20] - D[21] -
          3 * D[22] - 4 * D[23] - 3 * D[24] - D[25];
      ws[0] = int16_t(num >= 0 ? (num + 64) / 128 : -((64 - num) / 128));
      estimate(1, 1,
               -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] -
                   13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12] -
                   38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
                   13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]);
      estimate(2, 8,
               -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                   13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] -
                   13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                   3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]);
      estimate(3, 16,
               D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                   14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] +
                   2 * D[19] + D[23]);
      estimate(4, 9,
               -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] +
                   D[21] - D[25]);
      estimate(5, 2,
               2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] -
                   14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] +
                   2 * D[19]);
      estimate(6, 3,
               D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
      estimate(7, 10,
               D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
      estimate(8, 17,
               D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
      estimate(9, 24,
               D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
    } else {
      estimate(1, 1, -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
      estimate(2, 8, -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
      estimate(3, 16, -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
      estimate(4, 9,
               D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] +
                   D[22] - D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9]);
      estimate(5, 2, -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
    }
  }

  bool is_rgb() const {
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // component plane (IDCT of its blocks), then upsampled to width x height
  void component_plane(int ci, std::vector<uint8_t>& full) {
    const Component& c = comp[ci];
    int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> plane(size_t(pw) * ph);
    int bx_n = c.wib, by_n = c.hib;
    int16_t ws[64];
    for (int by = 0; by < by_n; ++by)
      for (int bx = 0; bx < bx_n; ++bx) {
        const int16_t* blk = &c.coef[(size_t(by) * c.bw + bx) * 64];
        if (smoothing) {
          smooth_block(ci, by, bx, ws);
          blk = ws;
        }
        idct_islow(blk, c.q, &plane[size_t(by) * 8 * pw + size_t(bx) * 8],
                   pw);
      }
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
    std::vector<uint8_t> planes[4];
    for (int i = 0; i < ncomp; ++i) component_plane(i, planes[i]);
    size_t n = size_t(width) * height;
    if (ncomp == 1) {
      const uint8_t* y = planes[0].data();
      for (size_t i = 0; i < n; ++i)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    const uint8_t *a = planes[0].data(), *b = planes[1].data(),
                  *c = planes[2].data();
    if (ncomp == 3 && is_rgb()) {
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
    auto lim = [](int v) -> int { return v < 0 ? 0 : (v > 255 ? 255 : v); };
    if (ncomp == 3) {
      for (size_t i = 0; i < n; ++i) {
        int y = a[i], cb = b[i], cr = c[i];
        out[3 * i] = uint8_t(lim(y + cr_r[cr]));
        out[3 * i + 1] = uint8_t(lim(y + int((cb_g[cb] + cr_g[cr]) >> 16)));
        out[3 * i + 2] = uint8_t(lim(y + cb_b[cb]));
      }
      return;
    }
    // four components: CMYK, or YCCK (jdcolor.c ycck_cmyk_convert); then
    // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
    const bool ycck = saw_adobe && adobe_transform != 0;
    const uint8_t* kp = planes[3].data();
    for (size_t i = 0; i < n; ++i) {
      int x0 = a[i], x1 = b[i], x2 = c[i];
      const int k = kp[i];
      if (ycck) {
        const int y = x0, cb = x1, cr = x2;
        x0 = lim(255 - (y + cr_r[cr]));
        x1 = lim(255 - (y + int((cb_g[cb] + cr_g[cr]) >> 16)));
        x2 = lim(255 - (y + cb_b[cb]));
      }
      out[3 * i] = uint8_t(k - ((255 - x0) * k >> 8));
      out[3 * i + 1] = uint8_t(k - ((255 - x1) * k >> 8));
      out[3 * i + 2] = uint8_t(k - ((255 - x2) * k >> 8));
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
