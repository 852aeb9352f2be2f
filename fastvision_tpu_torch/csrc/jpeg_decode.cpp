// Baseline JPEG decoder: the port's counterpart of cv2.imdecode(...,
// IMREAD_COLOR) followed by BGR -> RGB (fastvision_tpu/infer/serving.py:39-46,
// fastvision_tpu/data/dataset.py:28-35), for machines without cv2 or PIL.
//
// Host code, not a kernel: it is built with the host compiler
// (cuda_build.load("jpeg_decode")) and called through ctypes, which releases the
// GIL, so the loaders' thread backend decodes in parallel.
//
// Scope: DCT-based JPEG at 8 bits, sequential (SOF0, SOF1; SOF9 arithmetic)
// or progressive (SOF2; SOF10 arithmetic: spectral selection, successive
// approximation, EOB runs; jdphuff.c's and jdarith.c's four block decoders
// and their scan-header checks), 1, 3 or 4 components (CMYK, or YCCK under
// an Adobe transform but 0, as jdcolor.c and OpenCV's icvCvt_CMYK2BGR do),
// any integral sampling factors, restart intervals, tables (re)defined
// anywhere before a scan, 16-bit quantization tables, arithmetic
// conditioning (DAC), interleaved and non-interleaved scans, the Adobe APP14
// transform flag and the EXIF orientation, applied as OpenCV applies it. A
// sequential scan that names Huffman table 0 or 1 where no DHT defined it
// gets the standard tables of T.81 Annex K.3, as libjpeg-turbo installs them
// (jstdhuff.c; Motion-JPEG frames leave them out); a progressive or
// lossless one fails there, as in libjpeg. A progressive file whose scans
// leave any of a component's coefficients 1-9 short of full precision is
// block-smoothed before its IDCT, as jdcoefct.c does by default. The
// arithmetic decoder is a second source of the same coefficients (T.81
// Annex D as jdarith.c and jaricom.c run it): everything after the entropy
// layer is shared.
//
// Lossless JPEG (SOF3, Huffman, 2 to 8 bits: jdlhuff.c, jddiffct.c,
// jdlossls.c; samples below 8 bits come out as they are, not scaled):
// predictors 1-7, the point transform, restarts, any integral sampling
// (upsampled by replication, as libjpeg does at a 1x1 "IDCT"), decoded where
// libjpeg-turbo 3.1 gives cv2 5.0 an image: RGB-coded three components and
// CMYK four. YCbCr-tagged, YCCK and gray lossless files fail (libjpeg-turbo
// converts no colour in lossless mode, so cv2 returns no image either), as
// do 12-bit DCT data and lossless above 8 bits, hierarchical, SOF11 / SOF15
// and a frame whose height is left to a DNL marker, for none of which cv2
// 5.0 returns an image (a DNL segment elsewhere is skipped, as jdmarker.c
// skips it). The reduced decodes of a
// lossless file are full size (libjpeg does not scale it); the fused I420
// decode refuses it, as the JAX package's libjpeg 2.1.5 does.
//
// The end of the data follows the route's source (Decoder's `route`):
// cv2.imdecode's suspends, so a read past the end fails (a one-pass scan's
// libjpeg fills are followed to know where); cv2.imread's and jpeg_mem_src
// insert a fake EOI, so a truncated scan is finished from zero bits and what
// the scans read is decoded. Corrupt data is recovered from as libjpeg does:
// a bad Huffman code reads as symbol 0 (17 bits dropped), a scan that runs
// into a marker finishes its MCU on zero bits and leaves the rest of the
// restart interval as it is, a bad arithmetic code leaves the rest of the
// restart interval (jdarith.c's ct = -1), a restart marker out of place goes
// through jpeg_resync_to_restart, and an arithmetic decoder that meets a
// marker reads zeros from there on, which T.81 allows and jdarith.c does.
// What libjpeg refuses (ERREXIT) fails with a message.
//
// The pixels are libjpeg-turbo's defaults, bit for bit: the ISLOW integer
// IDCT (jidctint.c: 13-bit constants, DESCALE rounding; the output clamped
// as the x86 SIMD build's saturating packs clamp it), "fancy" triangular
// chroma upsampling (jdsample.c: h2v1, h1v2 and h2v2 with their alternating
// rounding biases; edge columns and rows replicated, as jdmainct.c's
// context pointers replicate the first and the last real row; plain
// replication where libjpeg falls back to it), and the fixed-point
// YCbCr -> RGB tables of jdcolor.c.
//
// Reduced decodes (scale 1/2, 1/4, 1/8: libjpeg's scale_denom, what cv2's
// IMREAD_REDUCED_COLOR_{2,4,8} asks for) run libjpeg-turbo's scaled IDCTs
// (jidctred.c: 4x4, 2x2, 1x1, with the coefficients they skip) at the
// per-component sizes jdmaster.c picks (a chroma component is decoded at a
// larger IDCT while that spares its upsampling), then jdsample.c's upsampler
// choice on what is left (no fancy upsampling when the smallest IDCT is 1x1).
//
// The fused JPEG -> letterboxed packed I420 decode is the port's copy of
// fastvision_tpu/native/jpeg_i420.cpp, which reads libjpeg's raw planes
// (jpeg_read_raw_data: the stored YCbCr at each component's scaled size, no
// upsampling, no colour conversion): the same planes come from the IDCTs
// above, then its resize_affine and letterbox geometry, copied exactly. The
// JAX package builds that file with -march=native, where GCC contracts a
// multiply and an add into one fused multiply-add: the copy writes those
// fmaf calls out and the library is built with -ffp-contract=off, so every
// host computes what an FMA host's build of the original computes. Unlike
// the original, it applies the EXIF orientation to each plane before the
// letterbox (as the RGB decode does), so both paths see the same frame.
//
// C interface (returns 0, or 1 with a message in `err`):
//   fvj_dims_reduced(data, n, denom, dims[2], err, errlen) -> output height, width
//   fvj_decode_reduced(data, n, denom, out, out_bytes, err, errlen) -> RGB uint8 HWC
//     at scale 1/denom (denom 1 for the full image, 2, 4 or 8)
//   fvj_decode_i420_letterbox(data, n, out_size, pad_y, reduce_target, out,
//     scale, pads, dims, err, errlen) -> 0; 1 where the JAX package falls
//     back to its plain chain (colour space or sampling it does not take);
//     2 with a message for data this decoder refuses (lossless JPEG included)
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw DecodeError{buf};
}

constexpr const char* kItem = "(ROADMAP Queue 1, item 11)";
// the end-of-data rules of the three routes (see Decoder)
constexpr int kMemory = 0, kFile = 1, kFused = 2;
// The fake EOI repeats (FF D9 FF D9 ...): a marker segment that ends an odd
// number of bytes past the end leaves its D9, which the entropy decoder
// reads as a data byte before the next FF D9.
constexpr uint8_t kOddTail[1] = {0xD9};
// the kinds libjpeg-turbo 3.1 refuses, so cv2 5.0's imdecode returns None for them
constexpr const char* kNoCv2 = "cv2 5.0 returns no image for it either";
// the largest image taken: OpenCV's default CV_IO_MAX_IMAGE_PIXELS
constexpr int64_t kMaxPixels = int64_t(1) << 30;

// zigzag position -> natural (row-major) index; the 16 extra entries absorb
// a run that overshoots the block, as libjpeg's jpeg_natural_order does
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  bool standard = false;  // T.81 Annex K's table, installed where no DHT defined one
  uint16_t fast[512];  // (length << 8) | symbol for codes of <= 9 bits, else 0
  int32_t maxcode[18];
  int32_t valoff[17];
  uint8_t vals[256];
  int nvals = 0;
  int max_symbol = 0;  // a DC table's symbols are checked where a scan uses it (jdhuff.c)

  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    standard = false;
    std::memcpy(vals, symbols, n);
    nvals = n;
    max_symbol = n ? *std::max_element(vals, vals + n) : 0;
    std::fill(fast, fast + 512, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      int cnt = counts[len - 1];
      // the codes must fit in len bits, the all-ones code excluded (jdhuff.c)
      if (cnt && code + cnt >= (1 << len)) fail("corrupt JPEG data: bad Huffman table");
      valoff[len] = k - code;
      for (int i = 0; i < cnt; ++i, ++k, ++code) {
        if (len <= 9) {
          for (int j = code << (9 - len); j < (code + 1) << (9 - len); ++j)
            fast[j] = static_cast<uint16_t>((len << 8) | vals[k]);
        }
      }
      maxcode[len] = cnt ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = INT32_MAX;
    defined = true;
  }
};

// T.81 Annex K.3: the standard Huffman tables, which libjpeg-turbo's
// sequential decoder installs (jstdhuff.c, from jinit_huff_decoder) in slots
// 0 (luminance) and 1 (chrominance) where no DHT defined them before it
// starts; a later DHT replaces them. Its progressive decoder installs none.
constexpr uint8_t kDCLumaCounts[16] = {
    0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDCLumaSymbols[12] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
constexpr uint8_t kDCChromaCounts[16] = {
    0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDCChromaSymbols[12] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
constexpr uint8_t kACLumaCounts[16] = {
    0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
constexpr uint8_t kACLumaSymbols[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kACChromaCounts[16] = {
    0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
constexpr uint8_t kACChromaSymbols[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct StandardTables {
  Huffman dc[2], ac[2];
  StandardTables() {
    dc[0].build(kDCLumaCounts, kDCLumaSymbols, 12);
    dc[1].build(kDCChromaCounts, kDCChromaSymbols, 12);
    ac[0].build(kACLumaCounts, kACLumaSymbols, 162);
    ac[1].build(kACChromaCounts, kACChromaSymbols, 162);
  }
};

const StandardTables& standard_tables() {
  static const StandardTables t;
  return t;
}

// Entropy-coded data: byte stuffing removed (an 0xFF run before 0x00 is
// one 0xFF byte, as jdhuff.c's jpeg_fill_bit_buffer reads it), a marker
// feeds zero bits. Where `eoi_at_end` the end of the data reads as a marker
// too (the fake EOI that libjpeg's stdio and memory sources insert: cv2.imread
// and jpeg_mem_src); otherwise reading past the end is a truncation
// (cv2.imdecode's source suspends and cv2 returns no image). Consuming a zero
// bit past a marker sets `insufficient` (jdhuff.c's insufficient_data): the
// MCU in hand is finished on zero bits, the later ones of the restart
// interval are left as they are.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  bool eoi_at_end = false;
  uint64_t acc = 0;
  int n = 0;    // bits in acc
  int pad = 0;  // zero bits appended past the data, at the low end of acc
  bool at_marker = false;
  bool insufficient = false;

  void fill() {
    while (n <= 56) {
      unsigned byte = 0;
      if (!at_marker) {
        if (p < end && *p != 0xFF) {
          byte = *p++;
        } else {
          const uint8_t* q = p < end ? p + 1 : end;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {  // a stuffed 0xFF
            byte = 0xFF;
            p = q + 1;
          } else if (q >= end && !eoi_at_end && !shadow) {
            fail("truncated JPEG data: the entropy-coded segment ends early, with no EOI marker");
          } else {
            at_marker = true;  // p stays on the marker's first 0xFF (or at the end)
          }
        }
      }
      if (at_marker) pad += 8;
      acc = (acc << 8) | byte;
      n += 8;
    }
  }
  uint32_t peek(int k) {
    if (n < k) fill();
    return static_cast<uint32_t>(acc >> (n - k)) & ((1u << k) - 1);
  }
  void skip(int k) {
    n -= k;
    if (n < pad) {
      insufficient = true;
      pad = n;
    }
  }
  void skip_code(int k) {
    if (shadow) reads.push_back(int8_t(k));
    skip(k);
  }
  int get(int k) {
    uint32_t v = peek(k);
    if (shadow) reads.push_back(int8_t(-k));
    skip(k);
    return static_cast<int>(v);
  }

  // cv2.imdecode's one-pass decode fails only where libjpeg's own bit buffer
  // asks its source for a byte past the end (a scan without a marker after
  // it may still decode). `shadow` follows that buffer (jdhuff.c: 64 bits,
  // refilled to 57; decode_mcu_fast where no restart interval is set and
  // 512 bytes an MCU block remain, decode_mcu_slow otherwise) over each
  // MCU's reads: code lengths (> 0) and extra bits (< 0).
  bool shadow = false;
  std::vector<int8_t> reads;
  const uint8_t* lp = nullptr;
  int lbits = 0;
  bool lmarker = false;

  void shadow_reset(const uint8_t* q, bool unread) {
    lp = q;
    lbits = 0;
    lmarker = unread;
  }
  void lfill(int nbits) {  // jpeg_fill_bit_buffer
    while (!lmarker && lbits < 57) {
      if (lp >= end) fail("truncated JPEG data: the entropy-coded segment ends early");
      int c = *lp++;
      if (c == 0xFF) {
        do {
          if (lp >= end) fail("truncated JPEG data: the entropy-coded segment ends early");
          c = *lp++;
        } while (c == 0xFF);
        if (c != 0) lmarker = true;
      }
      if (!lmarker) lbits += 8;
    }
    if (lmarker && nbits > lbits) lbits = 57;
  }
  bool lfill_fast() {  // FILL_BIT_BUFFER_FAST; true where it met a marker
    bool marker = false;
    if (lbits <= 16)
      for (int i = 0; i < 6; ++i) {
        const int c0 = *lp++, c1 = *lp;
        lbits += 8;
        if (c0 == 0xFF) {
          ++lp;
          if (c1 != 0) {
            marker = true;
            lp -= 2;
          }
        }
      }
    return marker;
  }
  void shadow_mcu(int blocks, bool restarts) {
    if (!restarts && !lmarker && end - lp >= 512 * blocks) {
      const uint8_t* p0 = lp;
      const int b0 = lbits;
      bool marker = false;
      for (int r : reads) {
        marker = lfill_fast() || marker;
        lbits -= r > 0 ? r : -r;
      }
      reads.clear();
      if (!marker) return;
      lp = p0;  // decode_mcu_fast met a marker: decode_mcu_slow does the MCU again
      lbits = b0;
      return shadow_mcu(blocks, true);
    }
    for (int r : reads) {
      if (r < 0) {  // CHECK_BIT_BUFFER, GET_BITS
        if (lbits < -r) lfill(-r);
        lbits += r;
        continue;
      }
      // HUFF_DECODE: the 8-bit lookahead, else jpeg_huff_decode from 9 bits
      // (from 1 where the buffer holds fewer than 8 after a fill)
      bool lookahead = true;
      if (lbits < 8) {
        lfill(0);
        lookahead = lbits >= 8;
      }
      if (lookahead && r <= 8) {
        lbits -= r;
        continue;
      }
      const int min_bits = lookahead ? 9 : 1;
      if (lbits < min_bits) lfill(min_bits);
      lbits -= min_bits;
      for (int l = min_bits; l < r; ++l) {
        if (lbits < 1) lfill(1);
        --lbits;
      }
    }
    reads.clear();
  }
  // resume at q: on data, or (unread) on a marker left for the next restart
  void reset(const uint8_t* q, bool unread = false) {
    p = q;
    acc = 0;
    n = pad = 0;
    at_marker = unread;
  }
};

// jdhuff.c's jpeg_huff_decode: a code matching no symbol after 16 bits is a
// warning; the 17 bits read are dropped and the symbol is 0
inline int decode_symbol(Bits& b, const Huffman& h) {
  uint16_t e = h.fast[b.peek(9)];
  if (e) {
    b.skip_code(e >> 8);
    return e & 255;
  }
  uint32_t code16 = b.peek(16);
  for (int len = 10; len <= 16; ++len) {
    int32_t c = static_cast<int32_t>(code16 >> (16 - len));
    if (c <= h.maxcode[len]) {
      int i = h.valoff[len] + c;
      if (i < 0 || i >= h.nvals) break;
      b.skip_code(len);
      return h.vals[i];
    }
  }
  b.peek(17);
  b.skip_code(17);
  return 0;
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---- arithmetic decoding (T.81 Annex D, as libjpeg's jdarith.c runs it) ----
// Table D.2 packed as jaricom.c packs it:
// Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; the last
// entry is the fixed 0.5 estimate (T.851 Table 5) of signs and refinement bits.
#define V(qe, lps, mps, sw) \
  ((uint32_t(qe) << 16) | (uint32_t(mps) << 8) | (uint32_t(sw) << 7) | uint32_t(lps))
constexpr uint32_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V
constexpr int kFixedBin = 113;

// The decoder's registers (D.2: C, A, CT) over entropy-coded data. A marker
// (or 0xFF fill bytes before one) stops the input: zeros are fed from there,
// and the reader stays on the marker. The end of the data is a marker where
// `eoi_at_end` (the sources' fake EOI), else a truncation (jdarith.c's
// get_byte cannot suspend). `dead` is jdarith.c's ct == -1 after a bad code:
// nothing more is decoded until the next restart.
struct Arith {
  const uint8_t* p;
  const uint8_t* end;
  bool eoi_at_end = false;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: the two initial bytes are still to come
  bool at_marker = false;
  bool dead = false;

  void reset(const uint8_t* q, bool unread = false) {
    p = q;
    c = a = 0;
    ct = -16;
    at_marker = unread;
    dead = false;
  }
  int next_byte() {
    if (at_marker) return 0;
    const uint8_t* q = p < end && *p == 0xFF ? p + 1 : p;
    while (q < end && *q == 0xFF) ++q;  // fill bytes
    if (q >= end) {
      if (!eoi_at_end)
        fail("truncated JPEG data: the arithmetic-coded segment ends early, with no EOI marker");
      at_marker = true;
      return 0;
    }
    if (q == p) return *p++;
    if (*q == 0x00) {  // a stuffed 0xFF
      p = q + 1;
      return 0xFF;
    }
    at_marker = true;
    return 0;
  }
  // one binary decision with the adaptive estimate *st (D.2.4 - D.2.6)
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kAriTab[sv & 0x7F];
    const int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    const int64_t qe = e >> 16;
    a -= qe;
    const int64_t temp = a << ct;
    if (c >= temp) {  // the LPS interval, or the MPS one after a conditional exchange
      c -= temp;
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// A DAC segment's conditioning (jdmarker.c's defaults at SOI: L 0, U 1, Kx 5)
// and the statistics areas of one scan (jdarith.c: 64 DC and 256 AC bins per
// table), reset at each scan's start and restart for the tables it uses.
struct ArithStats {
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  uint8_t dc[16][64], ac[16][256];
  uint8_t fixed = kFixedBin;
  ArithStats() {
    std::fill(dc_l, dc_l + 16, 0);
    std::fill(dc_u, dc_u + 16, 1);
    std::fill(ac_k, ac_k + 16, 5);
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int cw = 0, ch = 0;  // downsampled size in samples (libjpeg's downsampled_width/height)
  int bw = 0, bh = 0;  // blocks per row / column of the MCU-padded grid
  int dct = 8;         // the IDCT's output size a block side (libjpeg's DCT_scaled_size)
  int sw = 0, sh = 0;  // downsampled size at that IDCT size
  int td = 0, ta = 0;  // entropy-coding tables of the current scan
  int dc_pred = 0;
  int dc_context = 0;  // arithmetic: the DC statistics' conditioning offset (F.1.4.4.1.2)
  bool coded = false;
  int16_t qt[64];     // latched at the component's first scan, natural order, as the IDCT
                      // multiplies (jddctmgr.c's ISLOW_MULT_TYPE: 16 bits)
  uint16_t qraw[64];  // the same table as stored, which block smoothing divides by
  int coef_bits[64];  // progressive: each coefficient's point transform Al so far, -1 while
                      // no scan has coded it (jdinput.c's coef_bits)
  int prev_bits[10];  // coefficients 1-9's coef_bits before the last scan of this component
                      // (jdphuff.c's second half of coef_bits; 0 at the file's first scan)
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // (bh * dct) x (bw * dct); lossless: bh x bw samples
};

// ---- ISLOW IDCT (jidctint.c) ----
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }
inline uint8_t clamp_u8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = int(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, s));
    wp[56] = int(descale(tmp10 - tmp3, s));
    wp[8] = int(descale(tmp11 + tmp2, s));
    wp[48] = int(descale(tmp11 - tmp2, s));
    wp[16] = int(descale(tmp12 + tmp1, s));
    wp[40] = int(descale(tmp12 - tmp1, s));
    wp[24] = int(descale(tmp13 + tmp0, s));
    wp[32] = int(descale(tmp13 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = clamp_u8(int(descale(wp[0], kPass1Bits + 3)) + 128);
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp_u8(int(descale(tmp10 + tmp3, s2)) + 128);
    op[7] = clamp_u8(int(descale(tmp10 - tmp3, s2)) + 128);
    op[1] = clamp_u8(int(descale(tmp11 + tmp2, s2)) + 128);
    op[6] = clamp_u8(int(descale(tmp11 - tmp2, s2)) + 128);
    op[2] = clamp_u8(int(descale(tmp12 + tmp1, s2)) + 128);
    op[5] = clamp_u8(int(descale(tmp12 - tmp1, s2)) + 128);
    op[3] = clamp_u8(int(descale(tmp13 + tmp0, s2)) + 128);
    op[4] = clamp_u8(int(descale(tmp13 - tmp0, s2)) + 128);
  }
}

// ---- reduced-size IDCTs (jidctred.c: 4x4, 2x2 and 1x1 outputs of an 8x8 block) ----
constexpr int64_t R0_211 = 1730, R0_509 = 4176, R0_601 = 4926, R0_720 = 5906, R0_765 = 6270,
                  R0_850 = 6967, R0_899 = 7373, R1_061 = 8697, R1_272 = 10426, R1_451 = 11893,
                  R1_847 = 15137, R2_172 = 17799, R2_562 = 20995, R3_624 = 29692;

inline int64_t deq(const int16_t* in, const int16_t* q, int k) { return int64_t(in[k]) * q[k]; }

void idct_4x4(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[32];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // the second pass does not read column 4
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = int(deq(ip, qp, 0) * (1 << kPass1Bits));
      for (int r = 0; r < 4; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t tmp0 = deq(ip, qp, 0) * (int64_t(1) << (kConstBits + 1));
    int64_t tmp2 = deq(ip, qp, 16) * R1_847 + deq(ip, qp, 48) * -R0_765;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = deq(ip, qp, 56), z2 = deq(ip, qp, 40), z3 = deq(ip, qp, 24), z4 = deq(ip, qp, 8);
    tmp0 = z1 * -R0_211 + z2 * R1_451 + z3 * -R2_172 + z4 * R1_061;
    tmp2 = z1 * -R0_509 + z2 * -R0_601 + z3 * R0_899 + z4 * R2_562;
    constexpr int s = kConstBits - kPass1Bits + 1;
    wp[0] = int(descale(tmp10 + tmp2, s));
    wp[24] = int(descale(tmp10 - tmp2, s));
    wp[8] = int(descale(tmp12 + tmp0, s));
    wp[16] = int(descale(tmp12 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = clamp_u8(int(descale(wp[0], kPass1Bits + 3)) + 128);
      for (int c = 0; c < 4; ++c) op[c] = dc;
      continue;
    }
    int64_t tmp0 = int64_t(wp[0]) * (int64_t(1) << (kConstBits + 1));
    int64_t tmp2 = int64_t(wp[2]) * R1_847 + int64_t(wp[6]) * -R0_765;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -R0_211 + z2 * R1_451 + z3 * -R2_172 + z4 * R1_061;
    tmp2 = z1 * -R0_509 + z2 * -R0_601 + z3 * R0_899 + z4 * R2_562;
    op[0] = clamp_u8(int(descale(tmp10 + tmp2, s2)) + 128);
    op[3] = clamp_u8(int(descale(tmp10 - tmp2, s2)) + 128);
    op[1] = clamp_u8(int(descale(tmp12 + tmp0, s2)) + 128);
    op[2] = clamp_u8(int(descale(tmp12 - tmp0, s2)) + 128);
  }
}

void idct_2x2(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[16];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;  // not read by the second pass
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[24] && !ip[40] && !ip[56]) {
      wp[0] = wp[8] = int(deq(ip, qp, 0) * (1 << kPass1Bits));
      continue;
    }
    int64_t tmp10 = deq(ip, qp, 0) * (int64_t(1) << (kConstBits + 2));
    int64_t tmp0 = deq(ip, qp, 56) * -R0_720 + deq(ip, qp, 40) * R0_850 +
                   deq(ip, qp, 24) * -R1_272 + deq(ip, qp, 8) * R3_624;
    constexpr int s = kConstBits - kPass1Bits + 2;
    wp[0] = int(descale(tmp10 + tmp0, s));
    wp[8] = int(descale(tmp10 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[3] && !wp[5] && !wp[7]) {
      op[0] = op[1] = clamp_u8(int(descale(wp[0], kPass1Bits + 3)) + 128);
      continue;
    }
    int64_t tmp10 = int64_t(wp[0]) * (int64_t(1) << (kConstBits + 2));
    int64_t tmp0 = int64_t(wp[7]) * -R0_720 + int64_t(wp[5]) * R0_850 +
                   int64_t(wp[3]) * -R1_272 + int64_t(wp[1]) * R3_624;
    op[0] = clamp_u8(int(descale(tmp10 + tmp0, s2)) + 128);
    op[1] = clamp_u8(int(descale(tmp10 - tmp0, s2)) + 128);
  }
}

// jpeg_idct_1x1: the block's mean, through libjpeg's post-IDCT range-limit
// table (which wraps outside [-512, 511]; it has no SIMD version to saturate)
void idct_1x1(const int16_t* in, const int16_t* q, uint8_t* out, int) {
  int x = int(descale(int64_t(in[0]) * q[0], 3)) & 1023;
  out[0] = static_cast<uint8_t>(x < 128 ? x + 128 : (x < 512 ? 255 : (x < 896 ? 0 : x - 896)));
}

using IdctFn = void (*)(const int16_t*, const int16_t*, uint8_t*, int);

IdctFn idct_for(int size) {
  switch (size) {
    case 8: return idct_islow;
    case 4: return idct_4x4;
    case 2: return idct_2x2;
    default: return idct_1x1;
  }
}

// ---- YCbCr -> RGB tables (jdcolor.c build_ycc_rgb_table) ----
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

// OpenCV's ExifTransform: 2 flip x, 3 flip both, 4 flip y, 5 transpose,
// 6 transpose + flip x, 7 transpose + flip both, 8 transpose + flip y. `in` is
// H x W pixels of `ch` bytes, rows `stride` bytes apart; `out` is packed, W x H
// when o >= 5.
void orient_image(const uint8_t* in, int H, int W, size_t stride, int ch, int o, uint8_t* out) {
  const int oh = o >= 5 ? W : H, ow = o >= 5 ? H : W;
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int sy, sx;
      switch (o) {
        case 2: sy = y; sx = W - 1 - x; break;
        case 3: sy = H - 1 - y; sx = W - 1 - x; break;
        case 4: sy = H - 1 - y; sx = x; break;
        case 5: sy = x; sx = y; break;
        case 6: sy = H - 1 - x; sx = y; break;
        case 7: sy = H - 1 - x; sx = W - 1 - y; break;
        default: sy = x; sx = W - 1 - y; break;  // 8
      }
      std::memcpy(out + (size_t(y) * ow + x) * ch, in + size_t(sy) * stride + size_t(sx) * ch, ch);
    }
}

// ---- fastvision_tpu/native/jpeg_i420.cpp, copied: resize_affine and the letterbox ----
// Bilinear resize (cv2 INTER_LINEAR half-pixel mapping) of one plane with a
// fused affine range conversion out = a*in + b, clamped to [0,255]; 7-bit
// fixed-point taps. The fmaf calls are the multiply-adds that GCC contracts
// in the original's -march=native build.
void resize_affine(const uint8_t* src, int sh, int sw, int sstride, uint8_t* dst, int dh, int dw,
                   int dstride, float a, float b) {
  if (dh <= 0 || dw <= 0) return;
  if (sh == dh && sw == dw) {  // no resize: affine copy
    for (int y = 0; y < dh; ++y) {
      const uint8_t* s = src + size_t(y) * sstride;
      uint8_t* d = dst + size_t(y) * dstride;
      for (int x = 0; x < dw; ++x) {
        float v = std::fmaf(a, float(s[x]), b) + 0.5f;
        d[x] = uint8_t(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
      }
    }
    return;
  }
  std::vector<int> x0(dw), x1(dw);
  std::vector<uint16_t> wx1(dw), wx0(dw);
  const float rx = float(sw) / dw, ry = float(sh) / dh;
  for (int x = 0; x < dw; ++x) {
    float sx = std::fmaf(x + 0.5f, rx, -0.5f);
    if (sx < 0) sx = 0;
    if (sx > sw - 1) sx = float(sw - 1);
    x0[x] = int(sx);
    x1[x] = x0[x] + 1 < sw ? x0[x] + 1 : sw - 1;
    int w = int((sx - x0[x]) * 128.f + 0.5f);
    wx1[x] = uint16_t(w);
    wx0[x] = uint16_t(128 - w);
  }
  std::vector<uint16_t> h0(dw), h1(dw);
  int h0_row = -1, h1_row = -1;
  auto hpass = [&](int sy, std::vector<uint16_t>& out) {
    const uint8_t* s = src + size_t(sy) * sstride;
    for (int x = 0; x < dw; ++x) out[x] = uint16_t(s[x0[x]] * wx0[x] + s[x1[x]] * wx1[x]);
  };
  const float inv = a / (128.f * 128.f);
  for (int y = 0; y < dh; ++y) {
    float sy = std::fmaf(y + 0.5f, ry, -0.5f);
    if (sy < 0) sy = 0;
    if (sy > sh - 1) sy = float(sh - 1);
    int y0 = int(sy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    int wy = int((sy - y0) * 128.f + 0.5f);
    if (h0_row != y0) {
      if (h1_row == y0) {  // downscale walks forward: reuse the y1 row
        std::swap(h0, h1);
        h0_row = y0;
        h1_row = -1;
      } else {
        hpass(y0, h0);
        h0_row = y0;
      }
    }
    if (h1_row != y1) {
      if (y1 == y0) {
        h1_row = y0;
        std::copy(h0.begin(), h0.end(), h1.begin());
      } else {
        hpass(y1, h1);
        h1_row = y1;
      }
    }
    uint8_t* d = dst + size_t(y) * dstride;
    const int w1 = wy, w0 = 128 - wy;
    for (int x = 0; x < dw; ++x) {
      float v = std::fmaf(inv, float(h0[x] * w0 + h1[x] * w1), b) + 0.5f;
      d[x] = uint8_t(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
    }
  }
}

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

class Decoder {
 public:
  // route: kMemory (cv2.imdecode: OpenCV's source suspends past the end of
  // the buffer, and cv2 returns no image), kFile (cv2.imread: libjpeg's
  // stdio source reads a fake EOI at the end) or kFused (the JAX package's
  // fused decode: jpeg_mem_src's fake EOI, and jpeg_finish_decompress's
  // errors are fatal)
  Decoder(const uint8_t* data, size_t n, int route)
      : data_(data), end_(data + n), eoi_at_end_(route != kMemory),
        one_pass_reads_on_(route == kFused) {
    const StandardTables& t = standard_tables();
    for (int i = 0; i < 2; ++i) {
      dc_[i] = t.dc[i];
      ac_[i] = t.ac[i];
      dc_[i].standard = ac_[i].standard = true;
    }
  }

  // Parses the markers up to the first scan: size and orientation.
  void read_header() { parse(true); }

  // the output's height and width at scale 1/denom, in the oriented frame
  // (libjpeg scales no lossless image: its reduced decodes are full size)
  int out_h(int denom = 1) const {
    return ceil_div(orientation_ >= 5 ? width_ : height_, lossless_ ? 1 : denom);
  }
  int out_w(int denom = 1) const {
    return ceil_div(orientation_ >= 5 ? height_ : width_, lossless_ ? 1 : denom);
  }

  bool lossless() const { return lossless_; }

  // RGB uint8 HWC at scale 1/denom (1, 2, 4 or 8), oriented
  void decode(uint8_t* out, int denom = 1) {
    decode_planes(denom);
    std::vector<uint8_t> rgb;
    bool direct = orientation_ <= 1;
    uint8_t* dst = out;
    if (!direct) {
      rgb.resize(size_t(oh_) * ow_ * 3);
      dst = rgb.data();
    }
    to_rgb(dst);
    if (!direct) orient_image(rgb.data(), oh_, ow_, size_t(ow_) * 3, 3, orientation_, out);
  }

  // libjpeg's colour space for three components (jdapimin.c): RGB rather
  // than YCbCr; a lossless file without a JFIF or Adobe marker is RGB
  bool rgb_coded() const {
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return lossless_ || (comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B');
  }

  // What fastvision_tpu/native/jpeg_i420.cpp takes (after the header): gray,
  // or YCbCr with luma sampling (1|2) x (1|2) and 1x1 chroma, sequential or
  // progressive; not CMYK / YCCK
  bool i420_eligible() const {
    const Component& y = comps_[0];
    bool ok = comps_.size() != 4 && y.h >= 1 && y.h <= 2 && y.v >= 1 && y.v <= 2;
    if (comps_.size() == 3)
      ok = ok && !rgb_coded() && comps_[1].h == 1 && comps_[1].v == 1 && comps_[2].h == 1 &&
           comps_[2].v == 1;
    return ok;
  }

  // After the header: the reduction jpeg_i420.cpp takes for `reduce_target`
  // (the largest f in {8, 4, 2} with max(h, w) >= f * target, else 1), the
  // rule of data/dataset.py::imread_rgb_scaled
  int reduction(int reduce_target) const {
    if (reduce_target > 0)
      for (int f : {8, 4, 2})
        if (std::max(height_, width_) >= f * reduce_target) return f;
    return 1;
  }

  // jpeg_i420.cpp's jpeg_decode_i420_letterbox on this decoder's planes, each
  // oriented first, decoded at scale 1/denom. out: [S*3/2, S]; scale:
  // letterbox scale in the decoded frame; pads {left, top}; dims {orig_h,
  // orig_w, decoded_h, decoded_w}
  void decode_i420(int S, uint8_t pad_y, int denom, uint8_t* out, float* scale, int32_t* pads,
                   int32_t* dims) {
    decode_planes(denom);
    const int n = int(comps_.size());
    std::vector<uint8_t> turned[3];
    const uint8_t* pp[3];
    int ph[3], pw[3], pst[3];
    for (int i = 0; i < n; ++i) {
      const Component& c = comps_[i];
      const int o = orientation_;
      if (o > 1) {
        ph[i] = o >= 5 ? c.sw : c.sh;
        pw[i] = o >= 5 ? c.sh : c.sw;
        turned[i].resize(size_t(c.sw) * c.sh);
        orient_image(c.plane.data(), c.sh, c.sw, size_t(c.bw) * c.dct, 1, o, turned[i].data());
        pp[i] = turned[i].data();
        pst[i] = pw[i];
      } else {
        ph[i] = c.sh;
        pw[i] = c.sw;
        pp[i] = c.plane.data();
        pst[i] = c.bw * c.dct;
      }
    }
    const int dh = ph[0], dw = pw[0];
    dims[0] = out_h();
    dims[1] = out_w();
    dims[2] = dh;
    dims[3] = dw;
    // letterbox geometry as data/dataset.py::letterbox (banker's rounding)
    const double sc = double(S) / (dh > dw ? dh : dw);
    const int nh = int(std::nearbyint(dh * sc));
    const int nw = int(std::nearbyint(dw * sc));
    const int top = (S - nh) / 2, left = (S - nw) / 2;
    *scale = float(sc);
    pads[0] = left;
    pads[1] = top;
    uint8_t* Y = out;
    uint8_t* U = out + size_t(S) * S;
    uint8_t* V = U + size_t(S / 2) * (S / 2);
    std::memset(Y, pad_y, size_t(S) * S);
    std::memset(U, 128, size_t(S / 2) * (S / 2));
    std::memset(V, 128, size_t(S / 2) * (S / 2));
    // full-range JFIF -> studio-swing BT.601 (cv2's RGB2YUV_I420 convention)
    const float ay = 219.f / 255.f, by = 16.f;
    const float ac = 224.f / 255.f, bc = 128.f * (1.f - 224.f / 255.f);
    resize_affine(pp[0], dh, dw, pst[0], Y + size_t(top) * S + left, nh, nw, S, ay, by);
    if (n == 3) {  // chroma: the canvas region covering the luma's at half resolution
      const int ctop = top >> 1, cleft = left >> 1;
      const int cbh = ((top + nh + 1) >> 1) - ctop;
      const int cbw = ((left + nw + 1) >> 1) - cleft;
      const int cs = S / 2;
      resize_affine(pp[1], ph[1], pw[1], pst[1], U + size_t(ctop) * cs + cleft, cbh, cbw, cs, ac, bc);
      resize_affine(pp[2], ph[2], pw[2], pst[2], V + size_t(ctop) * cs + cleft, cbh, cbw, cs, ac, bc);
    }
  }

 private:
  const uint8_t* data_;
  const uint8_t* end_;
  const bool eoi_at_end_;
  const uint8_t* p_ = nullptr;
  int scans_ = 0;          // scans read (libjpeg's input_scan_number)
  int last_scan_comps_ = 0;
  bool one_pass_reads_on_;  // the fused route: markers after a one-pass scan are read to EOI
  int last_good_row_ = 0;  // jdcoefct.c's last_good_iMCU_row: the last iMCU row an MCU of
                           // began with data to decode
  int width_ = 0, height_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int min_dct_ = 8, oh_ = 0, ow_ = 0;  // the smallest IDCT size; the output before orientation
  int restart_interval_ = 0;
  int orientation_ = 1;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  int precision_ = 8;
  int eobrun_ = 0;  // progressive AC scans: blocks left in the current end-of-band run
  ArithStats stats_;
  std::vector<Component> comps_;
  uint16_t qtables_[4][64];
  bool qdefined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];

  std::vector<uint8_t> tail_;  // a marker segment cut by the end, completed with the fake EOI

  // The k bytes of a marker segment at q. Past the end of the data they are
  // the fake EOI's (FF D9 FF D9 ...), as jdmarker.c reads them from a source
  // that inserts one; else the segment is truncated.
  const uint8_t* segment(const uint8_t* q, size_t k) {
    const int64_t at = q - data_, n = end_ - data_;
    if (at + int64_t(k) <= n) return q;
    if (!eoi_at_end_) fail("truncated JPEG data: a marker segment ends early");
    tail_.resize(k);
    for (size_t i = 0; i < k; ++i) {
      const int64_t pos = at + int64_t(i);
      tail_[i] = pos < n ? data_[pos] : ((pos - n) % 2 ? 0xD9 : 0xFF);
    }
    return tail_.data();
  }

  // The next marker at or after q (fill bytes and extraneous data skipped).
  const uint8_t* next_marker(const uint8_t* q) {
    while (q + 1 < end_) {
      if (q[0] == 0xFF && q[1] != 0x00 && q[1] != 0xFF) return q;
      ++q;
    }
    return nullptr;
  }

  void parse(bool header_only) {
    if (end_ - data_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8) fail("not a JPEG stream");
    p_ = data_ + 2;
    for (;;) {
      const uint8_t* m = next_marker(p_);
      if (!m && !eoi_at_end_) fail("truncated JPEG data: no EOI marker");
      const int marker = m ? m[1] : 0xD9;  // the end of the data: the source's fake EOI
      p_ = m ? m + 2 : end_;
      if (marker == 0xD9) {  // EOI
        if (!frame_) fail("truncated JPEG data: EOI before a frame");
        if (header_only || scans_ == 0) fail("truncated JPEG data: EOI before a scan");
        return;
      }
      if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RSTn
      if (marker == 0x01) continue;                    // TEM
      if (marker == 0xD8) fail("corrupt JPEG data: a second SOI");
      int len = be16(segment(p_, 2));
      if (len < 2) fail("corrupt JPEG data: marker length %d", len);
      const uint8_t* seg = segment(p_, len) + 2;
      int seg_len = len - 2;
      p_ += len;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          read_sof(seg, seg_len, marker);
          break;
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("hierarchical JPEG is not supported: %s %s", kNoCv2, kItem);
        case 0xCB:
          fail("arithmetic-coded lossless JPEG is not supported: %s %s", kNoCv2, kItem);
        case 0xCC:
          read_dac(seg, seg_len);
          break;
        case 0xC4:
          read_dht(seg, seg_len);
          break;
        case 0xDB:
          read_dqt(seg, seg_len);
          break;
        case 0xDD:
          if (seg_len != 2) fail("corrupt JPEG data: DRI length");
          restart_interval_ = be16(seg);
          break;
        case 0xE0:
          if (seg_len >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xE1:
          read_exif(seg, seg_len);
          break;
        case 0xEE:
          if (seg_len >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        case 0xDA:
          if (!frame_) fail("corrupt JPEG data: a scan before the frame header");
          if (lossless_) check_lossless_colour();
          if (header_only) return;
          read_scan(seg, seg_len);
          break;
        case 0xDC:  // DNL: skipped (a frame without a height fails at its SOF)
          break;
        default:
          // APPn and COM are skipped; DHP, EXP, JPGn and the reserved markers
          // are fatal in jdmarker.c
          if (!(marker >= 0xE0 && marker <= 0xEF) && marker != 0xFE)
            fail("corrupt JPEG data: unknown marker 0x%02x", marker);
      }
      // libjpeg's one-pass decode (one sequential scan of every component)
      // reads no marker after its scan: what follows is left to
      // jpeg_finish_decompress, whose errors cv2 ignores once the rows are
      // out (the fused decode's are fatal)
      if (marker == 0xDA && !one_pass_reads_on_ && scans_ == 1 && !progressive_ &&
          last_scan_comps_ == int(comps_.size()))
        return;
    }
  }

  void read_sof(const uint8_t* s, int n, int marker) {
    if (frame_) fail("corrupt JPEG data: a second frame header");
    if (n < 6) fail("corrupt JPEG data: SOF length");
    progressive_ = marker == 0xC2 || marker == 0xCA;
    arith_ = marker == 0xC9 || marker == 0xCA;
    lossless_ = marker == 0xC3;
    precision_ = s[0];
    // libjpeg-turbo 3.1's 8-bit API (cv2's) reads 8-bit DCT data and 2- to 8-bit lossless data
    if (lossless_ ? precision_ < 2 || precision_ > 8 : precision_ != 8)
      fail("%d-bit %sJPEG is not supported: %s %s", precision_, lossless_ ? "lossless " : "",
           kNoCv2, kItem);
    height_ = be16(s + 1);
    width_ = be16(s + 3);
    int nc = s[5];
    if (height_ == 0 || width_ == 0)
      fail("JPEG without a frame height (DNL) is not supported: %s %s", kNoCv2, kItem);
    if (int64_t(width_) * height_ > kMaxPixels)
      fail("JPEG of %d x %d exceeds %lld pixels", width_, height_, (long long)kMaxPixels);
    if (nc != 1 && nc != 3 && nc != 4)
      fail("JPEG with %d components is not supported %s", nc, kItem);
    if (n != 6 + 3 * nc) fail("corrupt JPEG data: SOF length");
    comps_.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG data: component %d sampling %dx%d table %d", c.id, c.h, c.v, c.tq);
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    const int unit = lossless_ ? 1 : 8;  // samples a block side: lossless codes samples
    mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        fail("JPEG with fractional sampling factors is not supported %s", kItem);
      c.cw = int((int64_t(width_) * c.h + hmax_ - 1) / hmax_);
      c.ch = int((int64_t(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
    frame_ = true;
  }

  void read_dht(const uint8_t* s, int n) {
    while (n > 0) {
      if (n < 17) fail("corrupt JPEG data: DHT length");
      int tc = s[0] >> 4, th = s[0] & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG data: DHT class %d id %d", tc, th);
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[1 + i];
      if (total > 256 || 17 + total > n) fail("corrupt JPEG data: DHT length");
      (tc ? ac_[th] : dc_[th]).build(s + 1, s + 17, total);
      s += 17 + total;
      n -= 17 + total;
    }
  }

  // DAC (jdmarker.c's get_dac): conditioning of DC tables 0-15 (L, U) and AC
  // tables 0-15 (Kx)
  void read_dac(const uint8_t* s, int n) {
    if (n % 2) fail("corrupt JPEG data: DAC length");
    for (int i = 0; i < n; i += 2) {
      const int index = s[i], val = s[i + 1];
      if (index >= 32) fail("corrupt JPEG data: DAC table index %d", index);
      if (index >= 16) {
        stats_.ac_k[index - 16] = uint8_t(val);
      } else {
        if ((val & 15) > (val >> 4)) fail("corrupt JPEG data: DAC value %d", val);
        stats_.dc_l[index] = uint8_t(val & 15);
        stats_.dc_u[index] = uint8_t(val >> 4);
      }
    }
  }

  // libjpeg-turbo converts no colour in lossless mode (jdcolor.c), so the
  // RGB (three components) or CMYK (four) output OpenCV asks for exists only
  // where the file is coded in it
  void check_lossless_colour() const {
    const char* kind = nullptr;
    if (comps_.size() == 1) kind = "gray";
    else if (comps_.size() == 3 && !rgb_coded()) kind = "YCbCr";
    else if (comps_.size() == 4 && adobe_ && adobe_transform_ != 0) kind = "YCCK";
    if (kind)
      fail("lossless %s JPEG is not supported (libjpeg-turbo converts no colour in lossless "
           "mode): %s %s", kind, kNoCv2, kItem);
  }

  void read_dqt(const uint8_t* s, int n) {
    while (n > 0) {
      int pq = s[0] >> 4, tq = s[0] & 15;
      if (pq > 1 || tq > 3) fail("corrupt JPEG data: DQT precision %d id %d", pq, tq);
      int size = 1 + 64 * (pq + 1);
      if (n < size) fail("corrupt JPEG data: DQT length");
      for (int k = 0; k < 64; ++k)
        qtables_[tq][kNatural[k]] = pq ? be16(s + 1 + 2 * k) : s[1 + k];
      qdefined_[tq] = true;
      s += size;
      n -= size;
    }
  }

  // EXIF orientation (APP1 "Exif\0\0", IFD0 tag 0x0112), either byte order.
  void read_exif(const uint8_t* s, int n) {
    if (n < 14 || std::memcmp(s, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = s + 6;
    int tn = n - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto u16 = [&](int off) -> int {
      return le ? t[off] | (t[off + 1] << 8) : (t[off] << 8) | t[off + 1];
    };
    auto u32 = [&](int off) -> uint32_t {
      return le ? uint32_t(t[off]) | (uint32_t(t[off + 1]) << 8) | (uint32_t(t[off + 2]) << 16) |
                      (uint32_t(t[off + 3]) << 24)
                : (uint32_t(t[off]) << 24) | (uint32_t(t[off + 1]) << 16) |
                      (uint32_t(t[off + 2]) << 8) | uint32_t(t[off + 3]);
    };
    if (u16(2) != 42) return;
    uint64_t ifd = u32(4);
    if (ifd + 2 > uint64_t(tn)) return;
    int count = u16(int(ifd));
    for (int i = 0; i < count; ++i) {
      uint64_t e = ifd + 2 + 12 * uint64_t(i);
      if (e + 12 > uint64_t(tn)) return;
      if (u16(int(e)) == 0x0112 && u16(int(e) + 2) == 3) {
        int o = u16(int(e) + 8);
        orientation_ = (o >= 1 && o <= 8) ? o : 1;
        return;
      }
    }
  }

  void decode_block(Bits& b, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const Huffman& dc = dc_[c.td];
    const Huffman& ac = ac_[c.ta];
    int s = decode_symbol(b, dc);
    int64_t pred = int64_t(c.dc_pred) + (s ? extend(b.get(s), s) : 0);
    if (pred > INT32_MAX || pred < INT32_MIN) fail("corrupt JPEG data: DC coefficient overflows");
    c.dc_pred = int(pred);
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = decode_symbol(b, ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // ---- progressive block decoders (jdphuff.c) ----
  void dc_first(Bits& b, Component& c, int16_t* blk, int al) {
    int s = decode_symbol(b, dc_[c.td]);
    int64_t pred = int64_t(c.dc_pred) + (s ? extend(b.get(s), s) : 0);
    if (pred > INT32_MAX || pred < INT32_MIN) fail("corrupt JPEG data: DC coefficient overflows");
    c.dc_pred = int(pred);
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
  }

  static void dc_refine(Bits& b, int16_t* blk, int al) {
    if (b.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void ac_first(Bits& b, const Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {  // a block of the current end-of-band run: nothing coded
      --eobrun_;
      return;
    }
    const Huffman& h = ac_[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = decode_symbol(b, h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(b.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {    // EOBr: this block and 2^r - 1 + r bits' worth more end here
        eobrun_ = 1 << r;
        if (r) eobrun_ += b.get(r);
        --eobrun_;
        break;
      }
    }
  }

  // One refinement bit for each coefficient already nonzero; newly nonzero
  // ones are +-2^al. A correction bit of 1 grows the magnitude.
  static void refine(Bits& b, int16_t* coef, int p1) {
    if (b.get(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : -p1));
  }

  void ac_refine(Bits& b, const Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun_ == 0) {
      const Huffman& h = ac_[c.ta];
      for (; k <= se; ++k) {
        int rs = decode_symbol(b, h);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a size other than 1 is a warning in libjpeg, read as 1
          s = b.get(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += b.get(r);
          break;  // the rest of the block is the end-of-band run's
        }
        // pass r zero coefficients (and every nonzero one, refining it)
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            refine(b, coef, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) refine(b, coef, p1);
      }
      --eobrun_;
    }
  }

  // ---- arithmetic block decoders (jdarith.c; F.2.4 with the statistics of F.1.4.4) ----
  // jdarith.c's JWRN_ARITH_BAD_CODE: the block keeps what was decoded, the
  // rest of the MCU and of the restart interval is left as it is
  struct ArithBadCode {};
  [[noreturn]] static void bad_arith_code() { throw ArithBadCode{}; }

  // decode_mcu_DC_first, and the DC part of the sequential decode_mcu (Al 0)
  void arith_dc_first(Arith& ar, Component& c, int16_t* blk, int al) {
    uint8_t* const base = stats_.dc[c.td];
    uint8_t* st = base + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
    } else {
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = base + 20;  // X1
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) bad_arith_code();
          ++st;
        }
      }
      // the conditioning category of the next difference: zero, small or large
      if (m < ((1 << stats_.dc_l[c.td]) >> 1)) c.dc_context = 0;
      else if (m > ((1 << stats_.dc_u[c.td]) >> 1)) c.dc_context = 12 + sign * 4;
      else c.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.dc_pred = (c.dc_pred + v) & 0xFFFF;
    }
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
  }

  // decode_mcu_AC_first, and the AC part of the sequential decode_mcu (1-63, Al 0)
  void arith_ac_first(Arith& ar, const Component& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* const base = stats_.ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (ar.decode(st)) break;  // end of block
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) bad_arith_code();
      }
      const int sign = ar.decode(&stats_.fixed);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = base + (k <= stats_.ac_k[c.ta] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) bad_arith_code();
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
  }

  void arith_dc_refine(Arith& ar, int16_t* blk, int al) {
    if (ar.decode(&stats_.fixed)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  // decode_mcu_AC_refine: past the block's last nonzero coefficient (EOBx) an
  // end-of-block decision comes first; a nonzero coefficient takes a
  // correction bit, a zero one may become +-2^al
  void arith_ac_refine(Arith& ar, const Component& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* const base = stats_.ac[c.ta];
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;
    while (kex > 0 && !blk[kNatural[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = static_cast<int16_t>(ar.decode(&stats_.fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) bad_arith_code();
      }
    }
  }

  // jdarith.c's start_pass / process_restart: the statistics of the tables
  // this scan reads start over, as do the DC predictions
  void reset_arith(const std::vector<Component*>& sc, bool uses_dc, bool uses_ac) {
    for (auto* c : sc) {
      if (uses_dc) {
        std::memset(stats_.dc[c->td], 0, sizeof stats_.dc[0]);
        c->dc_pred = c->dc_context = 0;
      }
      if (uses_ac) std::memset(stats_.ac[c->ta], 0, sizeof stats_.ac[0]);
    }
  }

  // Where the entropy decoder resumes after a restart: on the data after
  // the marker, or (unread) on a marker it leaves for later, which it reads
  // as an empty segment.
  struct Resume {
    const uint8_t* at;
    bool unread;
  };

  // The first marker at or after q, or the end of the data read as the
  // source's fake EOI (nullptr); the end fails where nothing is inserted.
  const uint8_t* marker_or_eoi(const uint8_t* q) {
    if (q == kOddTail || q == kOddTail + 1) return nullptr;
    const uint8_t* m = next_marker(q);
    if (!m && !eoi_at_end_) fail("truncated JPEG data: no marker after a restart interval");
    return m;
  }

  // jdmarker.c's read_restart_marker: the expected RSTn is swallowed; any
  // other marker goes to jpeg_resync_to_restart, whose action depends on
  // its distance from the expected one: 1 discard it and go on, 2 scan on to
  // the next marker and decide again, 3 leave it unread (an empty segment)
  Resume restart(const uint8_t* q, int desired) {
    const uint8_t* m = marker_or_eoi(q);
    for (;;) {
      const int marker = m ? m[1] : 0xD9;
      int action = 1;  // (the expected marker among them)
      if (marker < 0xC0) action = 2;
      else if (marker < 0xD0 || marker > 0xD7) action = 3;
      else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
        action = 2;
      if (action == 1) return {m + 2, false};
      if (action == 3) return {m ? m : end_, true};
      m = marker_or_eoi(m + 2);
    }
  }

  void read_scan(const uint8_t* s, int n) {
    if (n < 1) fail("corrupt JPEG data: SOS length");
    int ns = s[0];
    if (ns < 1 || ns > 4 || n != 4 + 2 * ns) fail("corrupt JPEG data: SOS length");
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4,
              al = s[3 + 2 * ns] & 15;
    if (lossless_) {  // jdlossls.c: Ss selects the predictor, Al is the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision_)
        fail("corrupt JPEG data: lossless scan Ss %d Se %d Ah %d Al %d", ss, se, ah, al);
    } else if (progressive_) {  // jdphuff.c's and jdarith.c's start_pass
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) fail("corrupt JPEG data: progressive scan Ss %d Se %d Ah %d Al %d", ss, se, ah, al);
    }  // (a sequential scan's Ss, Se, Ah and Al are only warned of: coefficients 0-63 are decoded)
    // the tables this kind of scan reads (jdhuff.c and jdarith.c: both;
    // jdphuff.c and jdarith.c: the first DC scan its DC table, an AC scan its
    // AC table, a DC refinement none; jdlhuff.c: the DC table)
    const bool uses_dc = !progressive_ || (ss == 0 && ah == 0);
    const bool uses_ac = !lossless_ && (!progressive_ || ss != 0);
    // (the standard tables stand in for the sequential DCT decoder only: jdhuff.c)
    auto usable = [&](const Huffman& h) {
      return h.defined && !((progressive_ || lossless_) && h.standard);
    };
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* c = nullptr;
      for (auto& cc : comps_)
        if (cc.id == id) c = &cc;
      if (!c) fail("corrupt JPEG data: scan names component %d", id);
      c->td = s[2 + 2 * i] >> 4;
      c->ta = s[2 + 2 * i] & 15;
      if (!arith_) {
        if ((uses_dc && (c->td > 3 || !usable(dc_[c->td]))) ||
            (uses_ac && (c->ta > 3 || !usable(ac_[c->ta]))))
          fail("corrupt JPEG data: a scan uses an undefined Huffman table");
        // DC symbols are difference sizes: 0-15, or 0-16 in lossless mode
        if (uses_dc && dc_[c->td].max_symbol > (lossless_ ? 16 : 15))
          fail("corrupt JPEG data: bad DC Huffman table");
      }
      if (!c->coded) {  // the quantization table is latched at the first scan
        if (lossless_) {
          c->plane.assign(size_t(c->bw) * c->bh, 0);
        } else {
          if (!qdefined_[c->tq]) fail("corrupt JPEG data: undefined quantization table %d", c->tq);
          for (int k = 0; k < 64; ++k) {
            c->qraw[k] = qtables_[c->tq][k];
            c->qt[k] = static_cast<int16_t>(qtables_[c->tq][k]);
          }
          c->coef.assign(size_t(c->bw) * c->bh * 64, 0);
        }
      }
      c->coded = true;
      c->dc_pred = c->dc_context = 0;
      if (progressive_) {  // out-of-order refinements are only warnings in libjpeg
        for (int k = 1; k < 10; ++k) c->prev_bits[k] = scans_ > 0 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      }
      sc.push_back(c);
    }
    eobrun_ = 0;
    ++scans_;
    last_scan_comps_ = ns;
    if (lossless_) return scan_lossless(sc, ss, al);

    // the entropy decoder: Huffman (jdhuff.c, jdphuff.c) or arithmetic
    // (jdarith.c), each writing the same coefficient store
    const bool odd = p_ > end_ && (p_ - end_) % 2;
    Bits bits{odd ? kOddTail : p_, odd ? kOddTail + 1 : end_, eoi_at_end_};
    Arith ar{bits.p, bits.end, eoi_at_end_};
    if (arith_) reset_arith(sc, uses_dc, uses_ac);
    // a one-pass scan on the memory route: its end is decided by libjpeg's fills
    bits.shadow = !eoi_at_end_ && !arith_ && !progressive_ && !one_pass_reads_on_ &&
                  scans_ == 1 && ns == int(comps_.size());
    bits.shadow_reset(bits.p, false);
    int mcu_blocks = 0;
    for (auto* c : sc) mcu_blocks += ns == 1 ? 1 : c->h * c->v;
    int64_t total;
    int nbx = 0;
    if (ns == 1) {
      nbx = (sc[0]->cw + 7) / 8;
      total = int64_t(nbx) * ((sc[0]->ch + 7) / 8);
    } else {
      int blocks = 0;
      for (auto* c : sc) blocks += c->h * c->v;
      if (blocks > 10) fail("corrupt JPEG data: %d blocks in an MCU", blocks);
      total = int64_t(mcux_) * mcuy_;
    }
    auto unit = [&](Component& c, int16_t* blk) {
      if (arith_) {
        if (!progressive_) {
          std::memset(blk, 0, 64 * sizeof(int16_t));
          arith_dc_first(ar, c, blk, 0);
          arith_ac_first(ar, c, blk, 1, 63, 0);
        } else if (ss == 0) {
          ah == 0 ? arith_dc_first(ar, c, blk, al) : arith_dc_refine(ar, blk, al);
        } else {
          ah == 0 ? arith_ac_first(ar, c, blk, ss, se, al)
                  : arith_ac_refine(ar, c, blk, ss, se, al);
        }
      } else if (!progressive_) {
        decode_block(bits, c, blk);
      } else if (ss == 0) {
        ah == 0 ? dc_first(bits, c, blk, al) : dc_refine(bits, blk, al);
      } else {
        ah == 0 ? ac_first(bits, c, blk, ss, se, al) : ac_refine(bits, c, blk, ss, se, al);
      }
    };
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
        const Resume r = restart(arith_ ? ar.p : bits.p, next_rst);
        next_rst = (next_rst + 1) & 7;
        for (auto* c : sc) c->dc_pred = 0;
        eobrun_ = 0;
        if (arith_) {
          ar.reset(r.at, r.unread);
          reset_arith(sc, uses_dc, uses_ac);
        } else {
          bits.reset(r.at, r.unread);
          bits.shadow_reset(r.at, r.unread);
          if (!r.unread) bits.insufficient = false;
        }
      }
      // out of data or past a bad arithmetic code: the MCU is left as it is
      // (jdarith.c leaves insufficient_data unset: its rows all count as good)
      const int row = ns == 1 ? int(m / nbx) / sc[0]->v : int(m / mcux_);
      if (!bits.insufficient) last_good_row_ = row;
      if (arith_ ? ar.dead : bits.insufficient) continue;
      if (ns == 1) {
        Component& c = *sc[0];
        int by = int(m / nbx), bx = int(m % nbx);
        try {
          unit(c, &c.coef[(size_t(by) * c.bw + bx) * 64]);
        } catch (const ArithBadCode&) {
          ar.dead = true;
        }
        if (bits.shadow) bits.shadow_mcu(mcu_blocks, restart_interval_ != 0);
      } else {
        int my = int(m / mcux_), mx = int(m % mcux_);
        try {
          for (auto* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x) {
                size_t by = size_t(my) * c->v + y, bx = size_t(mx) * c->h + x;
                unit(*c, &c->coef[(by * c->bw + bx) * 64]);
              }
        } catch (const ArithBadCode&) {
          ar.dead = true;
        }
        if (bits.shadow) bits.shadow_mcu(mcu_blocks, restart_interval_ != 0);
      }
    }
    p_ = arith_ ? ar.p : bits.p;  // the marker parser finds what follows the entropy-coded data
    if (p_ == kOddTail || p_ == kOddTail + 1) p_ = end_;
  }

  // ---- lossless (jddiffct.c over jdlhuff.c's differences and jdlossls.c's undifferencing) ----
  static int decode_difference(Bits& b, const Huffman& h) {
    const int s = decode_symbol(b, h);
    if (s == 0) return 0;
    if (s == 16) return 32768;  // no extra bits
    return extend(b.get(s), s);
  }

  // One row of one component: the first row of a scan or restart interval
  // is predicted from 2^(P - Pt - 1), then leftwards; every other row starts
  // from the sample above, then runs the scan's predictor. Sums wrap at 16 bits.
  static void undifference(const int* d, const int* above, int* out, int w, int psv, bool first,
                           int initial) {
    int ra = (d[0] + (first ? initial : above[0])) & 0xFFFF;
    out[0] = ra;
    if (first || psv == 1) {
      for (int x = 1; x < w; ++x) out[x] = ra = (d[x] + ra) & 0xFFFF;
      return;
    }
    int rb = above[0];
    for (int x = 1; x < w; ++x) {
      const int rc = rb;
      rb = above[x];
      int pred;
      switch (psv) {
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;  // 7
      }
      out[x] = ra = (d[x] + pred) & 0xFFFF;
    }
  }

  // An iMCU row's differences are decoded MCU row by MCU row, then each
  // component's rows are undifferenced and point-transformed (sample << Pt,
  // kept to 8 bits as libjpeg's JSAMPLE cast keeps it) into its plane. A
  // restart resets the predictor of the next row undifferenced: libjpeg's
  // order, which in a non-interleaved scan of a vertically subsampled
  // component is the iMCU row's first row.
  void scan_lossless(const std::vector<Component*>& sc, int psv, int pt) {
    const int ns = int(sc.size());
    const int per_row = ns == 1 ? sc[0]->cw : mcux_;  // MCUs in an MCU row
    if (restart_interval_ % per_row)
      fail("corrupt JPEG data: lossless restart interval %d is not a multiple of the %d MCUs of "
           "a row", restart_interval_, per_row);
    const int restart_rows = restart_interval_ / per_row;
    const int initial = 1 << (precision_ - pt - 1);
    std::vector<std::vector<int>> diff(ns), above(ns), cur(ns);
    std::vector<int> width(ns);  // differences decoded a row (the MCUs' padding included)
    std::vector<char> first(ns, 1);
    for (int i = 0; i < ns; ++i) {
      const Component& c = *sc[i];
      width[i] = ns == 1 ? c.cw : mcux_ * c.h;
      diff[i].assign(size_t(c.v) * width[i], 0);
      above[i].assign(c.cw, 0);
      cur[i].assign(c.cw, 0);
    }
    auto rows_in = [&](const Component& c, bool last) {  // libjpeg's last_row_height
      return last && c.ch % c.v ? c.ch % c.v : c.v;
    };
    const bool odd = p_ > end_ && (p_ - end_) % 2;
    Bits bits{odd ? kOddTail : p_, odd ? kOddTail + 1 : end_, eoi_at_end_};
    int rows_to_go = restart_rows, next_rst = 0;
    for (int r = 0; r < mcuy_; ++r) {
      const bool last = r == mcuy_ - 1;
      const int mcu_rows = ns > 1 ? 1 : rows_in(*sc[0], last);
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval_ && rows_to_go == 0) {
          const Resume rs = restart(bits.p, next_rst);
          bits.reset(rs.at, rs.unread);
          if (!rs.unread) bits.insufficient = false;
          next_rst = (next_rst + 1) & 7;
          rows_to_go = restart_rows;
          std::fill(first.begin(), first.end(), 1);
        }
        // jdlhuff.c: out of data, the row's differences are left zero
        const bool skip = bits.insufficient;
        for (int mx = 0; mx < per_row && skip; ++mx) {
          for (int i = 0; i < ns; ++i) {
            const Component& c = *sc[i];
            const int rows = ns == 1 ? 1 : c.v, cols = ns == 1 ? 1 : c.h;
            for (int yy = 0; yy < rows; ++yy)
              for (int xx = 0; xx < cols; ++xx)
                diff[i][size_t(ns == 1 ? y : yy) * width[i] + mx * cols + xx] = 0;
          }
        }
        for (int mx = 0; mx < per_row && !skip; ++mx) {
          if (ns == 1) {
            diff[0][size_t(y) * width[0] + mx] = decode_difference(bits, dc_[sc[0]->td]);
            continue;
          }
          for (int i = 0; i < ns; ++i) {
            const Component& c = *sc[i];
            for (int yy = 0; yy < c.v; ++yy)
              for (int xx = 0; xx < c.h; ++xx)
                diff[i][size_t(yy) * width[i] + mx * c.h + xx] = decode_difference(bits, dc_[c.td]);
          }
        }
        if (restart_interval_) --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        for (int y = 0, rows = rows_in(c, last); y < rows; ++y) {
          undifference(&diff[i][size_t(y) * width[i]], above[i].data(), cur[i].data(), c.cw, psv,
                       first[i], initial);
          first[i] = 0;
          uint8_t* out = &c.plane[size_t(r * c.v + y) * c.bw];
          for (int x = 0; x < c.cw; ++x) out[x] = static_cast<uint8_t>(cur[i][x] << pt);
          std::swap(above[i], cur[i]);
        }
      }
    }
    p_ = bits.p == kOddTail || bits.p == kOddTail + 1 ? end_ : bits.p;
  }

  static int ceil_div(int a, int b) { return (a + b - 1) / b; }

  // Decode every scan, then IDCT every block at scale 1/denom: each
  // component's IDCT size as jdmaster.c picks it (the smallest, 8 / denom,
  // doubled for a subsampled component while its upsampling ratio allows).
  void decode_planes(int denom) {
    parse(false);
    for (auto& c : comps_) {
      if (c.coded) continue;
      // an EOI before this component's first scan: libjpeg's pre-zeroed
      // coefficients, so a flat 128 (a lossless plane has no such default)
      if (lossless_) fail("truncated JPEG data: component %d has no scan", c.id);
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      std::fill(c.qt, c.qt + 64, int16_t(0));
      std::fill(c.qraw, c.qraw + 64, uint16_t(0));
    }
    if (lossless_) {  // the scans wrote the planes; a 1 x 1 "IDCT" at any scale
      min_dct_ = 1;
      oh_ = height_;
      ow_ = width_;
      for (auto& c : comps_) {
        c.dct = 1;
        c.sw = c.cw;
        c.sh = c.ch;
      }
      return;
    }
    const bool smooth = smoothing_on();
    min_dct_ = 8 / denom;
    oh_ = ceil_div(height_, denom);
    ow_ = ceil_div(width_, denom);
    for (auto& c : comps_) {
      int ss = min_dct_;
      while (ss < 8 && (hmax_ * min_dct_) % (c.h * ss * 2) == 0 &&
             (vmax_ * min_dct_) % (c.v * ss * 2) == 0)
        ss *= 2;
      c.dct = ss;
      c.sw = int((int64_t(width_) * c.h * ss + hmax_ * 8 - 1) / (hmax_ * 8));
      c.sh = int((int64_t(height_) * c.v * ss + vmax_ * 8 - 1) / (vmax_ * 8));
      const int stride = c.bw * ss;
      c.plane.assign(size_t(stride) * c.bh * ss, 0);
      const IdctFn idct = idct_for(ss);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct(&c.coef[(size_t(by) * c.bw + bx) * 64], c.qt,
               &c.plane[size_t(by) * ss * stride + size_t(bx) * ss], stride);
      if (smooth) idct_smoothed(c, idct);
    }
    for (auto& c : comps_) std::vector<int16_t>().swap(c.coef);
  }

  // jdcoefct.c's smoothing_ok: a progressive file in which some component
  // has one of its coefficients 1-9 short of full precision (coef_bits not
  // 0, never-coded ones included) and every component its DC
  bool smoothing_on() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.coded) return false;  // no quantization table latched
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.qraw[pos] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data (libjpeg-turbo 2.1 and later): each
  // block of the component's output grid is transformed again after
  // estimating its coefficients 1-5 that are still 0 and not known exact
  // from the DC values of its 5 x 5 neighbourhood (the Annex K.8 idea), and,
  // when no AC coefficient was ever coded, also its coefficients 6-9 and a
  // smoothed DC. The rows at the image's edges are replicated by its
  // iMCU-row rule, copied as it stands (the last iMCU row counts its block
  // rows from the component's height).
  void idct_smoothed(Component& c, IdctFn idct) {
    const int ss = c.dct, stride = c.bw * ss;
    const int wib = (c.cw + 7) / 8, hib = (c.ch + 7) / 8, total = mcuy_, last = total - 1;
    // an iMCU row past the last one with data (a scan cut short) is
    // smoothed by the coef_bits from before that scan (jdcoefct.c's
    // prev_coef_bits_latch; -1 where the file has one scan)
    int prev[10] = {0};
    for (int k = 1; k < 10; ++k) prev[k] = scans_ > 1 ? c.prev_bits[k] : -1;
    const int64_t Q00 = c.qraw[0], Q01 = c.qraw[1], Q10 = c.qraw[8], Q20 = c.qraw[16],
                  Q11 = c.qraw[9], Q02 = c.qraw[2], Q03 = c.qraw[3], Q12 = c.qraw[10],
                  Q21 = c.qraw[17], Q30 = c.qraw[24];
    auto dc_at = [&](int by, int bx) { return int(c.coef[(size_t(by) * c.bw + bx) * 64]); };
    // the estimate for one coefficient, limited below 2^Al when Al > 0
    auto estimate = [](int64_t num, int64_t q, int al) {
      int pred = int(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return num >= 0 ? pred : -pred;
    };
    int16_t ws[64];
    for (int r = 0; r < total; ++r) {
      const int* cb = r > last_good_row_ ? prev : c.coef_bits;
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && cb[k] == -1;
      const int block_rows = r < last ? c.v : (hib % c.v ? hib % c.v : c.v);
      const int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; ++br) {
        const int y = r * c.v + br, iy = r * block_rows + br;
        const int yp = iy > 0 ? y - 1 : y, ypp = iy > 1 ? y - 2 : yp;
        const int yn = iy < image_block_rows - 1 ? y + 1 : y;
        const int ynn = iy < image_block_rows - 2 ? y + 2 : yn;
        const int rows[5] = {ypp, yp, y, yn, ynn};
        int D[5][5];  // D[i][j] is libjpeg's DC(5 i + j + 1): rows top to bottom
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) D[i][j] = dc_at(rows[i], 0);
        for (int bx = 0; bx < wib; ++bx) {
          std::memcpy(ws, &c.coef[(size_t(y) * c.bw + bx) * 64], sizeof ws);
          if (bx == 0 && bx < wib - 1)
            for (int i = 0; i < 5; ++i) D[i][3] = D[i][4] = dc_at(rows[i], 1);
          if (bx + 1 < wib - 1)
            for (int i = 0; i < 5; ++i) D[i][4] = dc_at(rows[i], bx + 2);
          const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3], DC05 = D[0][4],
                    DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3], DC10 = D[1][4],
                    DC11 = D[2][0], DC12 = D[2][1], DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4],
                    DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4],
                    DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3], DC25 = D[4][4];
          if (cb[1] != 0 && ws[1] == 0)
            ws[1] = int16_t(estimate(Q00 * (change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), Q01, cb[1]));
          if (cb[2] != 0 && ws[8] == 0)
            ws[8] = int16_t(estimate(Q00 * (change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), Q10, cb[2]));
          if (cb[3] != 0 && ws[16] == 0)
            ws[16] = int16_t(estimate(Q00 * (change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), Q20, cb[3]));
          if (cb[4] != 0 && ws[9] == 0)
            ws[9] = int16_t(estimate(Q00 * (change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                 DC06 + 10 * DC07 - 10 * DC09)), Q11, cb[4]));
          if (cb[5] != 0 && ws[2] == 0)
            ws[2] = int16_t(estimate(Q00 * (change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                 DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), Q02, cb[5]));
          if (change_dc) {
            if (cb[6] != 0 && ws[3] == 0)
              ws[3] = int16_t(estimate(
                  Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, cb[6]));
            if (cb[7] != 0 && ws[10] == 0)
              ws[10] = int16_t(estimate(
                  Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, cb[7]));
            if (cb[8] != 0 && ws[17] == 0)
              ws[17] = int16_t(estimate(
                  Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, cb[8]));
            if (cb[9] != 0 && ws[24] == 0)
              ws[24] = int16_t(estimate(
                  Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, cb[9]));
            ws[0] = int16_t(estimate(Q00 *
                (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25), Q00, 0));
          }
          idct(ws, c.qt, &c.plane[size_t(y) * ss * stride + size_t(bx) * ss], stride);
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 4; ++j) D[i][j] = D[i][j + 1];
        }
      }
    }
  }

  // Upsample and convert the decoded planes into an oh_ x ow_ RGB image.
  void to_rgb(uint8_t* out) {
    const int W = ow_, H = oh_;
    std::vector<uint8_t> full[4];
    for (size_t i = 0; i < comps_.size(); ++i) full[i] = upsample(comps_[i]);
    if (comps_.size() == 1) {
      const uint8_t* y = full[0].data();
      for (size_t i = 0; i < size_t(W) * H; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
    const ColorTables& t = color_tables();
    if (comps_.size() == 4) {
      // libjpeg's 4-component colour space (jdapimin.c): YCCK under any Adobe
      // transform but 0, else CMYK as stored; YCCK -> CMYK by jdcolor.c's
      // ycck_cmyk_convert; then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
      const bool ycck = adobe_ && adobe_transform_ != 0;
      const uint8_t* k3 = full[3].data();
      for (size_t i = 0; i < size_t(W) * H; ++i) {
        int cc = c0[i], mm = c1[i], yy = c2[i];
        const int k = k3[i];
        if (ycck) {
          const int y = c0[i], cb = c1[i], cr = c2[i];
          cc = clamp_u8(255 - (y + t.cr_r[cr]));
          mm = clamp_u8(255 - (y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
          yy = clamp_u8(255 - (y + t.cb_b[cb]));
        }
        out[3 * i] = uint8_t(k - (((255 - cc) * k) >> 8));
        out[3 * i + 1] = uint8_t(k - (((255 - mm) * k) >> 8));
        out[3 * i + 2] = uint8_t(k - (((255 - yy) * k) >> 8));
      }
      return;
    }
    const bool rgb = rgb_coded();
    if (rgb) {
      for (size_t i = 0; i < size_t(W) * H; ++i) {
        out[3 * i] = c0[i];
        out[3 * i + 1] = c1[i];
        out[3 * i + 2] = c2[i];
      }
      return;
    }
    for (size_t i = 0; i < size_t(W) * H; ++i) {
      int y = c0[i], cb = c1[i], cr = c2[i];
      out[3 * i] = clamp_u8(y + t.cr_r[cr]);
      out[3 * i + 1] = clamp_u8(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp_u8(y + t.cb_b[cb]);
    }
  }

  // One component at the output's width x height, as jdsample.c upsamples it:
  // the ratios count the component's samples after its IDCT, and libjpeg
  // upsamples plainly (no fancy filter) when the smallest IDCT is 1x1.
  std::vector<uint8_t> upsample(const Component& c) {
    const int W = ow_, H = oh_, S = c.bw * c.dct;
    const int hf = hmax_ / (c.h * c.dct / min_dct_), vf = vmax_ / (c.v * c.dct / min_dct_);
    const int cw = c.sw, ch = c.sh;
    const bool fancy = min_dct_ > 1;
    const uint8_t* in = c.plane.data();
    std::vector<uint8_t> out(size_t(W) * H);
    auto row = [&](int r) { return in + size_t(r) * S; };
    if (hf == 1 && vf == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[size_t(y) * W], row(y), W);
    } else if (hf == 2 && vf == 1 && fancy && cw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; ++y) {
        const uint8_t* ip = row(y);
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x) {
          int k = x >> 1;
          op[x] = (x & 1) ? uint8_t((3 * ip[k] + ip[std::min(k + 1, cw - 1)] + 2) >> 2)
                          : uint8_t((3 * ip[k] + ip[std::max(k - 1, 0)] + 1) >> 2);
        }
      }
    } else if (hf == 1 && vf == 2 && fancy) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int r = y >> 1;
        const uint8_t* near = row(r);
        const uint8_t* far = row((y & 1) ? std::min(r + 1, ch - 1) : std::max(r - 1, 0));
        int bias = (y & 1) ? 2 : 1;
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x) op[x] = uint8_t((3 * near[x] + far[x] + bias) >> 2);
      }
    } else if (hf == 2 && vf == 2 && fancy && cw > 2) {  // h2v2_fancy_upsample
      std::vector<int> sum(cw);
      for (int y = 0; y < H; ++y) {
        int r = y >> 1;
        const uint8_t* near = row(r);
        const uint8_t* far = row((y & 1) ? std::min(r + 1, ch - 1) : std::max(r - 1, 0));
        for (int k = 0; k < cw; ++k) sum[k] = 3 * near[k] + far[k];
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x) {
          int k = x >> 1;
          op[x] = (x & 1) ? uint8_t((3 * sum[k] + sum[std::min(k + 1, cw - 1)] + 7) >> 4)
                          : uint8_t((3 * sum[k] + sum[std::max(k - 1, 0)] + 8) >> 4);
        }
      }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      for (int y = 0; y < H; ++y) {
        const uint8_t* ip = row(y / vf);
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x) op[x] = ip[x / hf];
      }
    }
    return out;
  }
};

int report(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
  return 1;
}

}  // namespace

extern "C" {

int fvj_dims_reduced(const uint8_t* data, int64_t n, int route, int denom, int32_t* dims,
                     char* err, int errlen) {
  try {
    if (denom != 1 && denom != 2 && denom != 4 && denom != 8)
      return report("the reduction must be 1, 2, 4 or 8", err, errlen);
    if (route < kMemory || route > kFused) return report("the route must be 0, 1 or 2", err, errlen);
    Decoder d(data, size_t(n), route);
    d.read_header();
    dims[0] = d.out_h(denom);
    dims[1] = d.out_w(denom);
    return 0;
  } catch (const DecodeError& e) {
    return report(e.msg.c_str(), err, errlen);
  } catch (const std::bad_alloc&) {
    return report("out of memory decoding a JPEG", err, errlen);
  }
}

int fvj_decode_reduced(const uint8_t* data, int64_t n, int route, int denom, uint8_t* out,
                       int64_t out_bytes, char* err, int errlen) {
  try {
    if (denom != 1 && denom != 2 && denom != 4 && denom != 8)
      return report("the reduction must be 1, 2, 4 or 8", err, errlen);
    if (route < kMemory || route > kFused) return report("the route must be 0, 1 or 2", err, errlen);
    Decoder d(data, size_t(n), route);
    d.read_header();
    if (int64_t(d.out_h(denom)) * d.out_w(denom) * 3 != out_bytes)
      return report("output buffer does not match the image size", err, errlen);
    Decoder full(data, size_t(n), route);
    full.decode(out, denom);
    return 0;
  } catch (const DecodeError& e) {
    return report(e.msg.c_str(), err, errlen);
  } catch (const std::bad_alloc&) {
    return report("out of memory decoding a JPEG", err, errlen);
  }
}

int fvj_decode_i420_letterbox(const uint8_t* data, int64_t n, int route, int out_size,
                              uint8_t pad_y,
                              int reduce_target, uint8_t* out, float* scale, int32_t* pads,
                              int32_t* dims, char* err, int errlen) {
  try {
    if (out_size < 2 || (out_size & 1)) {
      report("the I420 size must be even and at least 2", err, errlen);
      return 2;
    }
    if (route < kMemory || route > kFused) {
      report("the route must be 0, 1 or 2", err, errlen);
      return 2;
    }
    Decoder d(data, size_t(n), route);
    d.read_header();
    if (d.lossless()) {  // libjpeg 2.1.5, which the JAX package's fused decode links, refuses SOF3
      report("lossless JPEG is not taken by the fused I420 decode: it has no DCT planes, and the "
             "JAX package's native decode (libjpeg 2.1.5) refuses it too",
             err, errlen);
      return 2;
    }
    if (!d.i420_eligible()) return 1;
    Decoder full(data, size_t(n), route);
    full.decode_i420(out_size, pad_y, d.reduction(reduce_target), out, scale, pads, dims);
    return 0;
  } catch (const DecodeError& e) {
    report(e.msg.c_str(), err, errlen);
    return 2;
  } catch (const std::bad_alloc&) {
    report("out of memory decoding a JPEG", err, errlen);
    return 2;
  }
}

}  // extern "C"
