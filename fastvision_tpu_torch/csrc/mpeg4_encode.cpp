// An MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile intra-only frame
// encoder: the port's writer of annotated videos (data/mpeg4.py calls it
// through ctypes and writes the stream headers; data/mp4.py muxes the
// frames). One call encodes one RGB frame into one I-VOP:
//
//   1. RGB -> Y'CbCr 4:2:0, BT.601 limited range: Y = 16 + kY . (R, G, B),
//      each chroma sample 128 + the mean of its 2 x 2 pixels' kC . (R, G, B),
//      rounded half to even and clamped to [0, 255]; the frame padded to
//      whole 16 x 16 macroblocks by repeating its last row and column;
//   2. an 8 x 8 DCT-II of each block (double, separable: rows of the basis
//      against the block's columns, then its rows), F(0, 0) = 8 x the mean;
//   3. H.263 quantisation at the VOP's quantiser q: the DC to
//      floor(F / dc_scaler + 1/2) (Table 7-1's scaler, clamped to
//      [0, 2047 / scaler]), each AC to floor(|F| / 2q) (at least 1 where
//      |F| >= 1.5 q), at most 2047, with F's sign;
//   4. DC prediction (7.4.3): each block's DC level minus the prediction
//      from its left (A) or upper (C) neighbour's dequantised DC, C where
//      |A - B| < |B - C| (B the upper-left), 1024 outside the picture;
//   5. the bitstream: the VOP header (vop_start_code, coding type I,
//      modulo_time_base, vop_time_increment, vop_coded, intra_dc_vlc_thr
//      = 7, vop_quant) and each macroblock in raster order: the I-VOP MCBPC
//      of mb_type 3 (intra), ac_pred_flag 0, CBPY, then for each coded block
//      (Y0 Y1 Y2 Y3 Cb Cr) its non-zero levels in zigzag order, the DC
//      difference first (intra_dc_vlc_thr 7 sends it through the TCOEF
//      path), each as an escape of type 3: ESCAPE (0000 011), '11', last,
//      run (6), marker, level (12, two's complement), marker; then
//      next_start_code() stuffing. Fixed-length escapes are legal for
//      every level, so no TCOEF, DC-size or DC VLC table is needed.
//
// The arithmetic of steps 1-3 is double, in the order written here (the
// build's -ffp-contract=off keeps multiplies and adds unfused); the CPU
// tests hold it against a numpy version of the same steps
// (tests/test_torch_mp4_writer.py).
//
// C interface:
//   int  fvm_yuv420(const uint8_t* rgb, int width, int height,
//                   uint8_t* y, uint8_t* cb, uint8_t* cr)
//     step 1 alone: Y [16 mb_h][16 mb_w], Cb and Cr [8 mb_h][8 mb_w].
//   long fvm_encode_frame(const uint8_t* rgb, int width, int height,
//                         int quant, int seconds, int time_increment,
//                         int time_bits, int16_t* levels, uint8_t* out,
//                         long cap, char* err, int err_len)
//     rgb: [height][width][3] uint8; levels (may be null): the quantised
//     levels [n_mb][6][64] in raster order, the DC as a level (before
//     prediction); -> the VOP's bytes written into out, or -1 with a
//     message in err.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// BT.601 limited range, per 8-bit R, G, B
constexpr double kY[3] = {65.481 / 255, 128.553 / 255, 24.966 / 255};
constexpr double kCb[3] = {-37.797 / 255, -74.203 / 255, 112.0 / 255};
constexpr double kCr[3] = {112.0 / 255, -93.786 / 255, -18.214 / 255};

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// I-VOP MCBPC of mb_type 3 by cbpc, and CBPY by the luma pattern: (code, length)
constexpr uint8_t kMcbpc[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
constexpr uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5},  {9, 4}, {3, 5}, {7, 4},
                                  {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                                  {4, 4}, {8, 4}, {6, 4},  {3, 2}};

uint8_t to_byte(double v) {
  v = std::nearbyint(v);  // half to even, as numpy's rint
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

void yuv420(const uint8_t* rgb, int width, int height, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  const int mb_w = (width + 15) / 16, mb_h = (height + 15) / 16;
  const int pw = 16 * mb_w, cw = 8 * mb_w, ch = 8 * mb_h;
  auto px = [&](int r, int c) {  // the padded frame: the last row and column repeated
    r = r < height ? r : height - 1;
    c = c < width ? c : width - 1;
    return rgb + (static_cast<long>(r) * width + c) * 3;
  };
  auto dot = [](const double* k, const uint8_t* p) {
    return k[0] * p[0] + k[1] * p[1] + k[2] * p[2];
  };
  for (int r = 0; r < 16 * mb_h; ++r)
    for (int c = 0; c < pw; ++c) y[static_cast<long>(r) * pw + c] = to_byte(dot(kY, px(r, c)) + 16);
  for (int r = 0; r < ch; ++r)
    for (int c = 0; c < cw; ++c) {
      const uint8_t* p[4] = {px(2 * r, 2 * c), px(2 * r, 2 * c + 1), px(2 * r + 1, 2 * c),
                             px(2 * r + 1, 2 * c + 1)};
      double b = dot(kCb, p[0]) + dot(kCb, p[1]) + dot(kCb, p[2]) + dot(kCb, p[3]);
      double e = dot(kCr, p[0]) + dot(kCr, p[1]) + dot(kCr, p[2]) + dot(kCr, p[3]);
      cb[static_cast<long>(r) * cw + c] = to_byte(b * 0.25 + 128);
      cr[static_cast<long>(r) * cw + c] = to_byte(e * 0.25 + 128);
    }
}

struct Dct {
  double basis[8][8];  // basis[u][x] = c(u) / 2 cos((2x + 1) u pi / 16)
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        basis[u][x] = std::sqrt((u == 0 ? 1.0 : 2.0) / 8) *
                      std::cos((2 * x + 1) * u * 3.141592653589793 / 16);
  }
  // F = D @ block @ D^T, each sum accumulated from 0 in index order
  void forward(const uint8_t* plane, long stride, double* f) const {
    double tmp[8][8];
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x) {
        double acc = 0;
        for (int yy = 0; yy < 8; ++yy) acc = acc + basis[u][yy] * plane[yy * stride + x];
        tmp[u][x] = acc;
      }
    for (int u = 0; u < 8; ++u)
      for (int v = 0; v < 8; ++v) {
        double acc = 0;
        for (int x = 0; x < 8; ++x) acc = acc + tmp[u][x] * basis[v][x];
        f[u * 8 + v] = acc;
      }
  }
};

void dc_scalers(int q, int* luma, int* chroma) {
  if (q <= 4) {
    *luma = *chroma = 8;
    return;
  }
  *luma = q <= 8 ? 2 * q : q <= 24 ? q + 8 : 2 * q - 16;
  *chroma = q <= 24 ? (q + 13) / 2 : q - 6;
}

void quantize(const double* f, int q, int scaler, int16_t* level) {
  const double inv = 1.0 / (2 * q);
  for (int i = 1; i < 64; ++i) {
    double mag = std::fabs(f[i]);
    double lv = std::floor(mag * inv);
    if (lv > 2047) lv = 2047;
    if (lv == 0 && mag >= 1.5 * q) lv = 1;
    level[i] = static_cast<int16_t>(f[i] < 0 ? -lv : lv);
  }
  double dc = std::floor(f[0] / scaler + 0.5);
  double top = 2047 / scaler;
  level[0] = static_cast<int16_t>(dc < 0 ? 0 : dc > top ? top : dc);
}

struct BitWriter {
  uint8_t* out;
  long cap;
  long pos = 0;
  uint64_t acc = 0;  // pending bits, right-aligned
  int n = 0;         // number of pending bits (< 8 after each put)
  bool overflow = false;

  void put(uint32_t value, int bits) {  // bits <= 32
    acc = (acc << bits) | (value & ((bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u)));
    n += bits;
    while (n >= 8) {
      n -= 8;
      if (pos < cap) {
        out[pos] = static_cast<uint8_t>(acc >> n);
      } else {
        overflow = true;
      }
      ++pos;
    }
  }

  void stuffing() {  // next_start_code(): a zero bit, then ones up to the byte
    put(0, 1);
    int pad = (8 - n) & 7;
    if (pad) put((1u << pad) - 1u, pad);
  }
};

const Dct kDct;

}  // namespace

extern "C" int fvm_yuv420(const uint8_t* rgb, int width, int height, uint8_t* y, uint8_t* cb,
                          uint8_t* cr) {
  if (width < 1 || height < 1) return -1;
  yuv420(rgb, width, height, y, cb, cr);
  return 0;
}

extern "C" long fvm_encode_frame(const uint8_t* rgb, int width, int height, int quant,
                                 int seconds, int time_increment, int time_bits, int16_t* levels,
                                 uint8_t* out, long cap, char* err, int err_len) {
  auto fail = [&](const char* msg) -> long {
    if (err && err_len > 0) std::snprintf(err, err_len, "%s", msg);
    return -1;
  };
  if (width < 1 || height < 1 || width > 8191 || height > 8191)
    return fail("frame size outside the VOL's 13-bit fields");
  if (quant < 1 || quant > 31) return fail("vop_quant must be in [1, 31]");
  if (time_bits < 1 || time_bits > 16 || seconds < 0 || time_increment < 0 ||
      time_increment >= (1 << time_bits))
    return fail("bad VOP time fields");
  const int mb_w = (width + 15) / 16, mb_h = (height + 15) / 16, n_mb = mb_w * mb_h;
  const long pw = 16L * mb_w, cw = 8L * mb_w;
  std::vector<uint8_t> y(pw * 16 * mb_h), cb(cw * 8 * mb_h), cr(cw * 8 * mb_h);
  yuv420(rgb, width, height, y.data(), cb.data(), cr.data());

  int ys, cs;
  dc_scalers(quant, &ys, &cs);
  // levels of every block, raster order, and each plane's grid of DC levels
  std::vector<int16_t> lv(static_cast<long>(n_mb) * 6 * 64);
  std::vector<int> dc_y(4L * n_mb), dc_b(n_mb), dc_r(n_mb);
  const long gw = 2L * mb_w;  // luma DC grid width (blocks)
  double f[64];
  for (int my = 0; my < mb_h; ++my)
    for (int mx = 0; mx < mb_w; ++mx) {
      int16_t* blk = lv.data() + (static_cast<long>(my) * mb_w + mx) * 6 * 64;
      for (int b = 0; b < 4; ++b) {
        int by = 2 * my + b / 2, bx = 2 * mx + b % 2;
        kDct.forward(y.data() + by * 8 * pw + bx * 8, pw, f);
        quantize(f, quant, ys, blk + b * 64);
        dc_y[by * gw + bx] = blk[b * 64];
      }
      kDct.forward(cb.data() + my * 8 * cw + mx * 8, cw, f);
      quantize(f, quant, cs, blk + 4 * 64);
      kDct.forward(cr.data() + my * 8 * cw + mx * 8, cw, f);
      quantize(f, quant, cs, blk + 5 * 64);
      dc_b[my * mb_w + mx] = blk[4 * 64];
      dc_r[my * mb_w + mx] = blk[5 * 64];
    }
  if (levels) std::memcpy(levels, lv.data(), lv.size() * sizeof(int16_t));

  // the DC prediction of block (r, c) of a grid of DC levels, in levels
  auto predict = [](const std::vector<int>& grid, long width_blocks, long r, long c, int scaler) {
    auto at = [&](long rr, long cc) {
      return (rr < 0 || cc < 0) ? 1024 : grid[rr * width_blocks + cc] * scaler;
    };
    int a = at(r, c - 1), b = at(r - 1, c - 1), cc = at(r - 1, c);
    int pred = std::abs(a - b) < std::abs(b - cc) ? cc : a;
    return (pred + scaler / 2) / scaler;
  };

  BitWriter bw{out, cap};
  bw.put(0x000001B6u, 32);  // vop_start_code
  bw.put(0, 2);             // vop_coding_type: I
  for (int s = 0; s < seconds; ++s) bw.put(1, 1);  // modulo_time_base
  bw.put(0, 1);
  bw.put(1, 1);  // marker
  bw.put(static_cast<uint32_t>(time_increment), time_bits);
  bw.put(1, 1);  // marker
  bw.put(1, 1);  // vop_coded
  bw.put(7, 3);  // intra_dc_vlc_thr: the DC through the TCOEF path
  bw.put(static_cast<uint32_t>(quant), 5);  // vop_quant
  int scan[6][64];
  for (int my = 0; my < mb_h; ++my)
    for (int mx = 0; mx < mb_w; ++mx) {
      const int16_t* blk = lv.data() + (static_cast<long>(my) * mb_w + mx) * 6 * 64;
      int last[6];
      for (int b = 0; b < 6; ++b) {
        int pred;
        if (b < 4) {
          pred = predict(dc_y, gw, 2 * my + b / 2, 2 * mx + b % 2, ys);
        } else {
          pred = predict(b == 4 ? dc_b : dc_r, mb_w, my, mx, cs);
        }
        last[b] = -1;
        for (int i = 0; i < 64; ++i) {
          scan[b][i] = i == 0 ? blk[b * 64] - pred : blk[b * 64 + kZigzag[i]];
          if (scan[b][i] != 0) last[b] = i;
        }
      }
      int cbpc = ((last[4] >= 0) << 1) | (last[5] >= 0);
      int cbpy = ((last[0] >= 0) << 3) | ((last[1] >= 0) << 2) | ((last[2] >= 0) << 1) |
                 (last[3] >= 0);
      bw.put(kMcbpc[cbpc][0], kMcbpc[cbpc][1]);
      bw.put(0, 1);  // ac_pred_flag
      bw.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
      for (int b = 0; b < 6; ++b) {
        int run = 0;
        for (int i = 0; i <= last[b]; ++i) {
          int v = scan[b][i];
          if (v == 0) {
            ++run;
            continue;
          }
          bw.put(0x3, 7);  // ESCAPE
          bw.put(0x3, 2);  // escape type 3: fixed length
          bw.put(i == last[b], 1);
          bw.put(static_cast<uint32_t>(run), 6);
          bw.put(1, 1);  // marker
          bw.put(static_cast<uint32_t>(v) & 0xFFFu, 12);
          bw.put(1, 1);  // marker
          run = 0;
        }
      }
      if (bw.overflow) return fail("the output buffer is too small");
    }
  bw.stuffing();
  if (bw.overflow) return fail("the output buffer is too small");
  return bw.pos;
}
