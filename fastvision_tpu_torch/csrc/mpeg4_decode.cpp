// An MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder, the port's reader of
// XviD / DivX / mp4v video (data/mpeg4.py calls it through ctypes with the
// interpreter's lock released; data/avi.py and data/mp4.py demux). Its
// output is FFmpeg's ``mpeg4`` decoder's (libavcodec 59 on x86-64, as
// cv2's VideoCapture and FFmpeg build their frames) bit for bit, and so it
// follows that decoder where the standard leaves a choice or FFmpeg departs
// from it:
//
//   * packets: one call per container sample. The headers before a VOP
//     (VOS, VO, VOL, GOV, user data) are read as start codes are found;
//     user data names the encoder (``XviD####``, ``DivX###b####p``,
//     ``Lavc##.##.##``). A VOP with vop_coded 0 (an N-VOP) gives no frame; a
//     packet holding a P-VOP and then a B-VOP ("packed bitstream") keeps the
//     B-VOP and decodes it in place of the next packet; a 1-byte packet
//     from DivX / XviD is a dropped frame. Frames come out in display order:
//     a B-VOP at once, an I/P-VOP when the next I/P-VOP arrives (at once when
//     the VOL says low_delay), the last one at flush; a B-VOP before any
//     reference is skipped;
//   * the IDCT: FFmpeg's choice per stream. For XviD-tagged streams (user
//     data "XviD", or the XVID FourCC with no encoder named) the XviD IDCT,
//     otherwise the "simple" integer IDCT, each as libavcodec 59's SSE2
//     versions compute them on x86-64: 16-bit saturation between the row
//     and column passes (both), the DC-only row shortcut (simple), and the
//     column pass in saturating 16-bit arithmetic (XviD). Held on 3 million
//     random blocks against libavcodec's own;
//   * dequantisation: H.263 (inter levels dequantised as read, intra ones
//     after AC/DC prediction) and MPEG (default or loaded matrices,
//     mismatch control on inter blocks; FFmpeg's 16-bit products);
//   * prediction: intra DC and AC prediction with FFmpeg's rules at video
//     packet edges (1024 / 0 outside, scaled AC across a quantiser change),
//     motion vector prediction (median of three, slice edges), direct-mode
//     B vectors from the co-located ones (TRB / TRD from the VOP times),
//     B macroblocks skipped where the co-located P macroblock was;
//   * motion compensation: half-pel (rounding control; FFmpeg's x86
//     no-rounding averages, which subtract one from one of the two pixels
//     with saturation) and quarter-pel (the 8-tap filter mirrored at block
//     edges, FFmpeg's combination of passes per position), 8 x 8 (4MV) and
//     16 x 16 blocks, the chroma vector from four (Table 7-6 rounding),
//     unrestricted vectors (the reference extended past its macroblock-
//     aligned edge; FFmpeg's clamps on 8 x 8 blocks);
//   * interlaced VOPs: field DCT, 16 x 8 field prediction (half- and
//     quarter-pel; FFmpeg's field vector prediction and storage), field
//     direct mode, alternate scan;
//   * data partitioning (without RVLC): motion / DC, texture partitions
//     per video packet;
//   * GMC (S-VOPs of a GMC VOL, as XviD writes them): the sprite
//     trajectory to FFmpeg's fixed-point affine map (or a translation),
//     its warp (ff_gmc_c, gmc1), GMC macroblocks' average vectors;
//   * workarounds by encoder build that FFmpeg applies (edge position, DC
//     clipping, direct-mode block size, quarter-pel chroma rounding).
//
// What raises (Unsupported, NotImplementedError in Python): static
// sprites, GMC with 2 warping points or brightness change, RVLC, the short
// video header (H.263), reduced resolution, newpred, scalability,
// complexity estimation, not 8 bit, not 4:2:0, non-rectangular shapes, and
// FFmpeg's workarounds for old DivX / XviD / libavcodec builds beyond those
// above. A stream that does not
// decode (a bad VLC, a missing marker, a VOP that ends early, a P-VOP
// without a reference) fails (DecodeError, ValueError in Python); nothing
// is concealed.
//
// C interface (handles are not shared between threads):
//   void* fvd_open(const uint8_t* config, long n, uint32_t fourcc, char* err, int err_len)
//     config: the VOS / VO / VOL headers from the container (AVI strf
//     extradata, MP4 esds), possibly empty; fourcc: the AVI FourCC (0 for
//     none) -> a handle, or null with a message in err.
//   int  fvd_decode(void* h, const uint8_t* data, long n, long tag, int parse_only,
//                   char* err, int err_len)
//     one packet (n == 0: the end of the stream) -> 1 if a frame is ready
//     (fvd_take), 0 if not, -1 on a stream error, -2 on an unsupported
//     feature (message in err). parse_only: headers and frame order only.
//   int  fvd_take(void* h, uint8_t* y, uint8_t* cb, uint8_t* cr, long* tag)
//     copies the ready frame (width x height, chroma (w+1)/2 x (h+1)/2) and
//     its tag: the packet's, plus 2^32 for a packet's second (packed) VOP.
//   int  fvd_info(void* h, int* out)   width, height, then the stats (kStats)
//   void fvd_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int w, int h, uint8_t* rgb)
//     the planes to RGB as swscale converts them for cv2 (see there)
//   void fvd_reset(void* h)            drops the pictures (a seek), keeps the headers
//   void fvd_close(void* h)
#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw DecodeError(buf);
}

[[noreturn]] void unsupported(const char* what) { throw Unsupported(what); }

// ---- tables (the standard's, as libavcodec stores them) ----------------
const uint16_t k_inter_vlc[103][2] = {
  {2,2},{15,4},{21,6},{23,7},{31,8},{37,9},{36,9},{33,10},
  {32,10},{7,11},{6,11},{32,11},{6,3},{20,6},{30,8},{15,10},
  {33,11},{80,12},{14,4},{29,8},{14,10},{81,12},{13,5},{35,9},
  {13,10},{12,5},{34,9},{82,12},{11,5},{12,10},{83,12},{19,6},
  {11,10},{84,12},{18,6},{10,10},{17,6},{9,10},{16,6},{8,10},
  {22,7},{85,12},{21,7},{20,7},{28,8},{27,8},{33,9},{32,9},
  {31,9},{30,9},{29,9},{28,9},{27,9},{26,9},{34,11},{35,11},
  {86,12},{87,12},{7,4},{25,9},{5,11},{15,6},{4,11},{14,6},
  {13,6},{12,6},{19,7},{18,7},{17,7},{16,7},{26,8},{25,8},
  {24,8},{23,8},{22,8},{21,8},{20,8},{19,8},{24,9},{23,9},
  {22,9},{21,9},{20,9},{19,9},{18,9},{17,9},{7,10},{6,10},
  {5,10},{4,10},{36,11},{37,11},{38,11},{39,11},{88,12},{89,12},
  {90,12},{91,12},{92,12},{93,12},{94,12},{95,12},{3,7}};
const int8_t k_inter_run[102] = {
  0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1,
  1,1,2,2,2,2,3,3,3,4,4,4,5,5,5,6,
  6,6,7,7,8,8,9,9,10,10,11,12,13,14,15,16,
  17,18,19,20,21,22,23,24,25,26,0,0,0,1,1,2,
  3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,
  19,20,21,22,23,24,25,26,27,28,29,30,31,32,33,34,
  35,36,37,38,39,40};
const int8_t k_inter_level[102] = {
  1,2,3,4,5,6,7,8,9,10,11,12,1,2,3,4,
  5,6,1,2,3,4,1,2,3,1,2,3,1,2,3,1,
  2,3,1,2,1,2,1,2,1,2,1,1,1,1,1,1,
  1,1,1,1,1,1,1,1,1,1,1,2,3,1,2,1,
  1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
  1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
  1,1,1,1,1,1};
const uint16_t k_mpeg4_intra_vlc[103][2] = {
  {2,2},{6,3},{15,4},{13,5},{12,5},{21,6},{19,6},{18,6},
  {23,7},{31,8},{30,8},{29,8},{37,9},{36,9},{35,9},{33,9},
  {33,10},{32,10},{15,10},{14,10},{7,11},{6,11},{32,11},{33,11},
  {80,12},{81,12},{82,12},{14,4},{20,6},{22,7},{28,8},{32,9},
  {31,9},{13,10},{34,11},{83,12},{85,12},{11,5},{21,7},{30,9},
  {12,10},{86,12},{17,6},{27,8},{29,9},{11,10},{16,6},{34,9},
  {10,10},{13,6},{28,9},{8,10},{18,7},{27,9},{84,12},{20,7},
  {26,9},{87,12},{25,8},{9,10},{24,8},{35,11},{23,8},{25,9},
  {24,9},{7,10},{88,12},{7,4},{12,6},{22,8},{23,9},{6,10},
  {5,11},{4,11},{89,12},{15,6},{22,9},{5,10},{14,6},{4,10},
  {17,7},{36,11},{16,7},{37,11},{19,7},{90,12},{21,8},{91,12},
  {20,8},{19,8},{26,8},{21,9},{20,9},{19,9},{18,9},{17,9},
  {38,11},{39,11},{92,12},{93,12},{94,12},{95,12},{3,7}};
const int8_t k_mpeg4_intra_run[102] = {
  0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
  0,0,0,0,0,0,0,0,0,0,0,1,1,1,1,1,
  1,1,1,1,1,2,2,2,2,2,3,3,3,3,4,4,
  4,5,5,5,6,6,6,7,7,7,8,8,9,9,10,11,
  12,13,14,0,0,0,0,0,0,0,0,1,1,1,2,2,
  3,3,4,4,5,5,6,6,7,8,9,10,11,12,13,14,
  15,16,17,18,19,20};
const int8_t k_mpeg4_intra_level[102] = {
  1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,
  17,18,19,20,21,22,23,24,25,26,27,1,2,3,4,5,
  6,7,8,9,10,1,2,3,4,5,1,2,3,4,1,2,
  3,1,2,3,1,2,3,1,2,3,1,2,1,2,1,1,
  1,1,1,1,2,3,4,5,6,7,8,1,2,3,1,2,
  1,2,1,2,1,2,1,2,1,1,1,1,1,1,1,1,
  1,1,1,1,1,1};
const uint8_t k_h263_intra_MCBPC_code[9] = {
  1,1,2,3,1,1,2,3,1};
const uint8_t k_h263_intra_MCBPC_bits[9] = {
  1,3,3,3,4,6,6,6,9};
const uint8_t k_h263_inter_MCBPC_code[28] = {
  1,3,2,5,3,4,3,3,3,7,6,5,4,4,3,2,
  2,5,4,5,1,0,0,0,2,12,14,15};
const uint8_t k_h263_inter_MCBPC_bits[28] = {
  1,4,4,6,5,8,8,7,3,7,7,9,6,9,9,9,
  3,7,7,8,9,0,0,0,11,13,13,13};
const uint16_t k_h263_cbpy_tab[16][2] = {
  {3,4},{5,5},{4,5},{9,4},{3,5},{7,4},{2,6},{11,4},
  {2,5},{3,6},{5,4},{10,4},{4,4},{8,4},{6,4},{3,2}};
const uint16_t k_mvtab[33][2] = {
  {1,1},{1,2},{1,3},{1,4},{3,6},{5,7},{4,7},{3,7},
  {11,9},{10,9},{9,9},{17,10},{16,10},{15,10},{14,10},{13,10},
  {12,10},{11,10},{10,10},{9,10},{8,10},{7,10},{6,10},{5,10},
  {4,10},{7,11},{6,11},{5,11},{4,11},{3,11},{2,11},{3,12},
  {2,12}};
const uint16_t k_mpeg4_DCtab_lum[13][2] = {
  {3,3},{3,2},{2,2},{2,3},{1,3},{1,4},{1,5},{1,6},
  {1,7},{1,8},{1,9},{1,10},{1,11}};
const uint16_t k_mpeg4_DCtab_chrom[13][2] = {
  {3,2},{2,2},{1,2},{1,3},{1,4},{1,5},{1,6},{1,7},
  {1,8},{1,9},{1,10},{1,11},{1,12}};
const uint16_t k_mb_type_b_tab[4][2] = {
  {1,1},{1,2},{1,3},{1,4}};
const uint8_t k_mpeg4_default_intra_matrix[64] = {
  8,17,18,19,21,23,25,27,17,18,19,21,23,25,27,28,
  20,21,22,23,24,26,28,30,21,22,23,24,26,28,30,32,
  22,23,24,26,28,30,32,35,23,24,26,28,30,32,35,38,
  25,26,28,30,32,35,38,41,27,28,30,32,35,38,41,45};
const uint8_t k_mpeg4_default_non_intra_matrix[64] = {
  16,17,18,19,20,21,22,23,17,18,19,20,21,22,23,24,
  18,19,20,21,22,23,24,25,19,20,21,22,23,24,26,27,
  20,21,22,23,25,26,27,28,21,22,23,24,26,27,28,30,
  22,23,24,26,27,28,30,31,23,24,25,27,28,30,31,33};
const uint8_t k_zigzag_direct[64] = {
  0,1,8,16,9,2,3,10,17,24,32,25,18,11,4,5,
  12,19,26,33,40,48,41,34,27,20,13,6,7,14,21,28,
  35,42,49,56,57,50,43,36,29,22,15,23,30,37,44,51,
  58,59,52,45,38,31,39,46,53,60,61,54,47,55,62,63};
const uint8_t k_alternate_horizontal_scan[64] = {
  0,1,2,3,8,9,16,17,10,11,4,5,6,7,15,14,
  13,12,19,18,24,25,32,33,26,27,20,21,22,23,28,29,
  30,31,34,35,40,41,48,49,42,43,36,37,38,39,44,45,
  46,47,50,51,56,57,58,59,52,53,54,55,60,61,62,63};
const uint8_t k_alternate_vertical_scan[64] = {
  0,8,16,24,1,9,2,10,17,25,32,40,48,56,57,49,
  41,33,26,18,3,11,4,12,19,27,34,42,50,58,35,43,
  51,59,20,28,5,13,6,14,21,29,36,44,52,60,37,45,
  53,61,22,30,7,15,23,31,38,46,54,62,39,47,55,63};
const uint8_t k_mpeg4_y_dc_scale_table[32] = {
  0,8,8,8,8,10,12,14,16,17,18,19,20,21,22,23,
  24,25,26,27,28,29,30,31,32,34,36,38,40,42,44,46};
const uint8_t k_mpeg4_c_dc_scale_table[32] = {
  0,8,8,8,8,9,9,10,10,11,11,12,12,13,13,14,
  14,15,15,16,16,17,17,18,18,19,20,21,22,23,24,25};
const uint8_t k_mpeg4_dc_threshold[8] = {
  99,13,15,17,19,21,23,0};
const uint16_t k_mpeg4_resync_prefix[8] = {
  32512,32256,31744,30720,28672,24576,16384,0};

// ---- bits ---------------------------------------------------------------

// A big-endian bit reader; reads past the end give zeros (as FFmpeg's
// padded buffers do) and callers check the position.
struct Bits {
  const uint8_t* d = nullptr;
  long nbytes = 0, size = 0, pos = 0;
  Bits() = default;
  Bits(const uint8_t* data, long n) : d(data), nbytes(n), size(n * 8), pos(0) {}
  uint32_t peek32() const {
    long byte = pos >> 3;
    int sh = int(pos & 7);
    uint64_t v = 0;
    for (int i = 0; i < 5; i++) {
      long b = byte + i;
      v = (v << 8) | ((b >= 0 && b < nbytes) ? d[b] : 0);
    }
    return uint32_t(v >> (8 - sh));
  }
  uint32_t show(int n) const { return n ? peek32() >> (32 - n) : 0; }
  uint32_t get(int n) {
    uint32_t v = show(n);
    pos += n;
    return v;
  }
  int get1() { return int(get(1)); }
  int xbits(int n) {  // get_xbits: n bits, negative when the first is 0
    int v = int(get(n));
    return (v >> (n - 1)) ? v : v - ((1 << n) - 1);
  }
  void skip(long n) { pos += n; }
  void align() { pos = (pos + 7) & ~7L; }
  long left() const { return size - pos; }
};

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  void build(int n, const uint16_t* code, const uint16_t* length, int stride) {
    bits = 0;
    for (int i = 0; i < n; i++) bits = std::max<int>(bits, length[i * stride]);
    sym.assign(size_t(1) << bits, -1);
    len.assign(size_t(1) << bits, 0);
    for (int i = 0; i < n; i++) {
      int l = length[i * stride];
      if (!l) continue;
      uint32_t c = code[i * stride];
      uint32_t first = c << (bits - l), count = 1u << (bits - l);
      for (uint32_t k = 0; k < count; k++) {
        sym[first + k] = int16_t(i);
        len[first + k] = uint8_t(l);
      }
    }
  }
  int decode(Bits& b) const {
    uint32_t v = b.show(bits);
    int s = sym[v];
    if (s >= 0) b.skip(len[v]);
    return s;
  }
};

struct RunLevel {  // a TCOEF table: VLC symbol -> run, level, last
  Vlc vlc;
  int n = 0, last_start = 0;
  const int8_t* run = nullptr;
  const int8_t* level = nullptr;
  int max_level[2][64] = {};
  int max_run[2][65] = {};
  void init(const uint16_t (*codes)[2], const int8_t* r, const int8_t* l, int count, int last) {
    n = count;
    last_start = last;
    run = r;
    level = l;
    std::vector<uint16_t> c(count + 1), len(count + 1);
    for (int i = 0; i <= count; i++) {
      c[i] = codes[i][0];
      len[i] = codes[i][1];
    }
    vlc.build(count + 1, c.data(), len.data(), 1);
    for (int i = 0; i < count; i++) {
      int is_last = i >= last;
      max_level[is_last][r[i]] = std::max<int>(max_level[is_last][r[i]], l[i]);
      max_run[is_last][l[i]] = std::max<int>(max_run[is_last][l[i]], r[i]);
    }
  }
};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom, mb_type_b;
  RunLevel intra, inter;
  Tables() {
    auto u16 = [](const uint8_t* a, int n) { return std::vector<uint16_t>(a, a + n); };
    auto ic = u16(k_h263_intra_MCBPC_code, 9), ib = u16(k_h263_intra_MCBPC_bits, 9);
    intra_mcbpc.build(9, ic.data(), ib.data(), 1);
    auto pc = u16(k_h263_inter_MCBPC_code, 28), pb = u16(k_h263_inter_MCBPC_bits, 28);
    inter_mcbpc.build(28, pc.data(), pb.data(), 1);
    cbpy.build(16, &k_h263_cbpy_tab[0][0], &k_h263_cbpy_tab[0][1], 2);
    mv.build(33, &k_mvtab[0][0], &k_mvtab[0][1], 2);
    dc_lum.build(13, &k_mpeg4_DCtab_lum[0][0], &k_mpeg4_DCtab_lum[0][1], 2);
    dc_chrom.build(13, &k_mpeg4_DCtab_chrom[0][0], &k_mpeg4_DCtab_chrom[0][1], 2);
    mb_type_b.build(4, &k_mb_type_b_tab[0][0], &k_mb_type_b_tab[0][1], 2);
    intra.init(k_mpeg4_intra_vlc, k_mpeg4_intra_run, k_mpeg4_intra_level, 102, 67);
    inter.init(k_inter_vlc, k_inter_run, k_inter_level, 102, 58);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---- IDCTs (libavcodec 59's SSE2 versions on x86-64) ---------------------

inline int sat16(int x) { return x > 32767 ? 32767 : x < -32768 ? -32768 : x; }
inline uint8_t clip8(int x) { return uint8_t(x < 0 ? 0 : x > 255 ? 255 : x); }

void idct_simple(int16_t* b) {
  constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
                W7 = 4520;
  for (int i = 0; i < 8; i++) {
    int16_t* r = b + 8 * i;
    if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
      int16_t t = int16_t(uint16_t(r[0] * 8));
      for (int k = 0; k < 8; k++) r[k] = t;
      continue;
    }
    int a0 = W4 * r[0] + (1 << 10), a1 = a0, a2 = a0, a3 = a0;
    a0 += W2 * r[2];
    a1 += W6 * r[2];
    a2 -= W6 * r[2];
    a3 -= W2 * r[2];
    int b0 = W1 * r[1] + W3 * r[3], b1 = W3 * r[1] - W7 * r[3];
    int b2 = W5 * r[1] - W1 * r[3], b3 = W7 * r[1] - W5 * r[3];
    a0 += W4 * r[4] + W6 * r[6];
    a1 += -W4 * r[4] - W2 * r[6];
    a2 += -W4 * r[4] + W2 * r[6];
    a3 += W4 * r[4] - W6 * r[6];
    b0 += W5 * r[5] + W7 * r[7];
    b1 += -W1 * r[5] - W5 * r[7];
    b2 += W7 * r[5] + W3 * r[7];
    b3 += W3 * r[5] - W1 * r[7];
    r[0] = int16_t(sat16((a0 + b0) >> 11));
    r[7] = int16_t(sat16((a0 - b0) >> 11));
    r[1] = int16_t(sat16((a1 + b1) >> 11));
    r[6] = int16_t(sat16((a1 - b1) >> 11));
    r[2] = int16_t(sat16((a2 + b2) >> 11));
    r[5] = int16_t(sat16((a2 - b2) >> 11));
    r[3] = int16_t(sat16((a3 + b3) >> 11));
    r[4] = int16_t(sat16((a3 - b3) >> 11));
  }
  for (int i = 0; i < 8; i++) {
    int16_t* c = b + i;
    int a0 = W4 * int16_t(uint16_t(c[0] + 32)), a1 = a0, a2 = a0, a3 = a0;
    a0 += W2 * c[16];
    a1 += W6 * c[16];
    a2 -= W6 * c[16];
    a3 -= W2 * c[16];
    int b0 = W1 * c[8] + W3 * c[24], b1 = W3 * c[8] - W7 * c[24];
    int b2 = W5 * c[8] - W1 * c[24], b3 = W7 * c[8] - W5 * c[24];
    a0 += W4 * c[32];
    a1 -= W4 * c[32];
    a2 -= W4 * c[32];
    a3 += W4 * c[32];
    b0 += W5 * c[40];
    b1 -= W1 * c[40];
    b2 += W7 * c[40];
    b3 += W3 * c[40];
    a0 += W6 * c[48];
    a1 -= W2 * c[48];
    a2 += W2 * c[48];
    a3 -= W6 * c[48];
    b0 += W7 * c[56];
    b1 -= W5 * c[56];
    b2 += W3 * c[56];
    b3 -= W1 * c[56];
    c[0] = int16_t(sat16((a0 + b0) >> 20));
    c[8] = int16_t(sat16((a1 + b1) >> 20));
    c[16] = int16_t(sat16((a2 + b2) >> 20));
    c[24] = int16_t(sat16((a3 + b3) >> 20));
    c[32] = int16_t(sat16((a3 - b3) >> 20));
    c[40] = int16_t(sat16((a2 - b2) >> 20));
    c[48] = int16_t(sat16((a1 - b1) >> 20));
    c[56] = int16_t(sat16((a0 - b0) >> 20));
  }
}

void xvid_row(int16_t* in, const int* t, int rnd) {
  const int c1 = t[0], c2 = t[1], c3 = t[2], c4 = t[3], c5 = t[4], c6 = t[5], c7 = t[6];
  const int k1 = c4 * in[0] + rnd, k2 = c4 * in[4];
  const int a0 = k1 + c2 * in[2] + k2 + c6 * in[6], a1 = k1 + c6 * in[2] - k2 - c2 * in[6];
  const int a2 = k1 - c6 * in[2] - k2 + c2 * in[6], a3 = k1 - c2 * in[2] + k2 - c6 * in[6];
  const int b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
  const int b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
  const int b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
  const int b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
  in[0] = int16_t(sat16((a0 + b0) >> 11));
  in[1] = int16_t(sat16((a1 + b1) >> 11));
  in[2] = int16_t(sat16((a2 + b2) >> 11));
  in[3] = int16_t(sat16((a3 + b3) >> 11));
  in[4] = int16_t(sat16((a3 - b3) >> 11));
  in[5] = int16_t(sat16((a2 - b2) >> 11));
  in[6] = int16_t(sat16((a1 - b1) >> 11));
  in[7] = int16_t(sat16((a0 - b0) >> 11));
}

inline int mulhi(int x, int c) { return (x * c) >> 16; }  // pmulhw

void idct_xvid(int16_t* b) {
  static const int t04[] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
  static const int t17[] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
  static const int t26[] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
  static const int t35[] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
  xvid_row(b, t04, 65536);
  xvid_row(b + 8, t17, 3597);
  xvid_row(b + 16, t26, 2260);
  xvid_row(b + 24, t35, 1203);
  xvid_row(b + 32, t04, 0);
  xvid_row(b + 40, t35, 120);
  xvid_row(b + 48, t26, 512);
  xvid_row(b + 56, t17, 512);
  for (int i = 0; i < 8; i++) {
    int16_t* in = b + i;
    const int x0 = in[0], x1 = in[8], x2 = in[16], x3 = in[24], x4 = in[32], x5 = in[40],
              x6 = in[48], x7 = in[56];
    const int tm35 = sat16(sat16(mulhi(x3, -21746) + x3) - x5);
    const int tp35 = sat16(sat16(mulhi(x5, -21746) + x5) + x3);
    const int tp17 = sat16(mulhi(x7, 13036) + x1), tm17 = sat16(mulhi(x1, 13036) - x7);
    const int t1 = sat16(tp17 - tp35), b3 = sat16(tm17 - tm35);
    const int b0 = sat16(tp17 + tp35), t2 = sat16(tm17 + tm35);
    int b1 = mulhi(sat16(t1 + t2), 23170), b2 = mulhi(sat16(t1 - t2), 23170);
    b1 = sat16(b1 + b1);
    b2 = sat16(b2 + b2);
    const int tp26 = sat16(mulhi(x6, 27146) + x2), tm26 = sat16(mulhi(x2, 27146) - x6);
    const int tm04 = sat16(x0 - x4), tp04 = sat16(x0 + x4);
    const int a3 = sat16(tp04 - tp26), a0 = sat16(tp04 + tp26);
    const int a2 = sat16(tm04 - tm26), a1 = sat16(tm04 + tm26);
    in[0] = int16_t(sat16(a0 + b0) >> 6);
    in[56] = int16_t(sat16(a0 - b0) >> 6);
    in[8] = int16_t(sat16(a1 + b1) >> 6);
    in[48] = int16_t(sat16(a1 - b1) >> 6);
    in[16] = int16_t(sat16(a2 + b2) >> 6);
    in[40] = int16_t(sat16(a2 - b2) >> 6);
    in[24] = int16_t(sat16(a3 + b3) >> 6);
    in[32] = int16_t(sat16(a3 - b3) >> 6);
  }
}

// ---- motion compensation --------------------------------------------------

enum Op { PUT = 0, PUT_NO_RND = 1, AVG = 2 };

inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

inline void store(Op op, uint8_t& d, int v) { d = op == AVG ? avg2(d, v) : uint8_t(v); }

// half-pel blocks (w x h) from src (w + 1 x h + 1 readable); op PUT_NO_RND
// x2 / y2 are FFmpeg's x86 versions: one of the two pixels less one,
// saturated, then a rounding average.
void hpel(Op op, int dxy, uint8_t* dst, int ds, const uint8_t* s, int ss, int w, int h) {
  for (int y = 0; y < h; y++) {
    const uint8_t* a = s + y * ss;
    const uint8_t* b = a + ss;
    for (int x = 0; x < w; x++) {
      int v;
      switch (dxy) {
        case 0: v = a[x]; break;
        case 1:
          v = op == PUT_NO_RND ? (std::max(a[x] - 1, 0) + a[x + 1] + 1) >> 1
                               : (a[x] + a[x + 1] + 1) >> 1;
          break;
        case 2:
          if (op == PUT_NO_RND) {
            int p = a[x], q = b[x];
            if (y & 1) p = std::max(p - 1, 0); else q = std::max(q - 1, 0);
            v = (p + q + 1) >> 1;
          } else {
            v = (a[x] + b[x] + 1) >> 1;
          }
          break;
        default:
          v = (a[x] + a[x + 1] + b[x] + b[x + 1] + (op == PUT_NO_RND ? 1 : 2)) >> 2;
      }
      store(op, dst[y * ds + x], v);
    }
  }
}

// the MPEG-4 quarter-pel 8-tap filter over n + 1 samples, mirrored at both
// ends; rnd 16 (rounding) or 15 (no rounding)
inline int qtap(const uint8_t* s, int st, int k, int n) {
  auto at = [&](int j) {
    if (j < 0) j = -1 - j;
    if (j > n) j = 2 * n + 1 - j;
    return int(s[j * st]);
  };
  return (at(k) + at(k + 1)) * 20 - (at(k - 1) + at(k + 2)) * 6 + (at(k - 2) + at(k + 3)) * 3 -
         (at(k - 3) + at(k + 4));
}

void h_lowpass(Op op, uint8_t* dst, int ds, const uint8_t* src, int ss, int n, int rows) {
  const int rnd = op == PUT_NO_RND ? 15 : 16;
  for (int y = 0; y < rows; y++)
    for (int x = 0; x < n; x++)
      store(op, dst[y * ds + x], clip8((qtap(src + y * ss, 1, x, n) + rnd) >> 5));
}

void v_lowpass(Op op, uint8_t* dst, int ds, const uint8_t* src, int ss, int n) {
  const int rnd = op == PUT_NO_RND ? 15 : 16;
  for (int x = 0; x < n; x++)
    for (int y = 0; y < n; y++)
      store(op, dst[y * ds + x], clip8((qtap(src + x, ss, y, n) + rnd) >> 5));
}

void l2(Op op, uint8_t* dst, int ds, const uint8_t* a, int as, const uint8_t* b, int bs, int n,
        int rows) {
  for (int y = 0; y < rows; y++)
    for (int x = 0; x < n; x++) {
      int p = a[y * as + x], q = b[y * bs + x];
      store(op, dst[y * ds + x], op == PUT_NO_RND ? (p + q) >> 1 : (p + q + 1) >> 1);
    }
}

// FFmpeg's qpel{8,16}_mcXY: the n x n block at quarter position dxy
// ((y & 3) << 2 | (x & 3)) from src ((n + 1) x (n + 1) readable).
void qpel(Op op, int dxy, uint8_t* dst, int ds, const uint8_t* src, int ss, int n) {
  const Op rnd = op == PUT_NO_RND ? PUT_NO_RND : PUT;  // the intermediate passes
  uint8_t half[17 * 17], halfH[17 * 17], halfHV[16 * 16];
  const int x = dxy & 3, y = dxy >> 2;
  if (y == 0) {
    if (x == 0) {
      for (int r = 0; r < n; r++)
        for (int c = 0; c < n; c++) store(op, dst[r * ds + c], src[r * ss + c]);
    } else if (x == 2) {
      h_lowpass(op, dst, ds, src, ss, n, n);
    } else {
      h_lowpass(rnd, half, n, src, ss, n, n);
      l2(op, dst, ds, src + (x == 3), ss, half, n, n, n);
    }
    return;
  }
  if (x == 0) {
    if (y == 2) {
      v_lowpass(op, dst, ds, src, ss, n);
    } else {
      v_lowpass(rnd, half, n, src, ss, n);
      l2(op, dst, ds, src + (y == 3) * ss, ss, half, n, n, n);
    }
    return;
  }
  h_lowpass(rnd, halfH, n, src, ss, n, n + 1);
  if (x != 2) l2(rnd, halfH, n, halfH, n, src + (x == 3), ss, n, n + 1);
  if (y == 2) {
    v_lowpass(op, dst, ds, halfH, n, n);
    return;
  }
  v_lowpass(rnd, halfHV, n, halfH, n, n);
  l2(op, dst, ds, halfH + (y == 3) * n, n, halfHV, n, n, n);
}

// ---- pictures ---------------------------------------------------------------

enum PictType { PT_I = 1, PT_P = 2, PT_B = 3, PT_S = 4 };
enum MbType : uint16_t {
  MB_INTRA = 1, MB_8X8 = 2, MB_SKIP = 4, MB_DIRECT = 8, MB_L0 = 16, MB_L1 = 32, MB_16X16 = 64,
  MB_INTERLACED = 128, MB_ACPRED = 256, MB_GMC = 512
};

struct Picture {
  int type = 0;
  long tag = 0;
  int lw = 0, lh = 0, cw = 0, ch = 0;
  std::vector<uint8_t> plane[3];
  std::vector<int16_t> mv;  // the 8 x 8 blocks' forward vectors, FFmpeg's motion_val layout
  std::vector<uint8_t> mbskip;
  std::vector<uint16_t> mbtype;
  std::vector<int8_t> qscale;
  std::vector<uint8_t> ref_index;  // a field macroblock's field selects, 4 per macroblock
};

struct Plane {
  const uint8_t* p;
  int stride, ew, eh;  // the edge: reads clamp to [0, ew) x [0, eh)
};

// a (w x h) block at (x, y) of a reference, its coordinates clamped to the
// reference's edge (FFmpeg's emulated edge / padded reference)
void fetch(const Plane& r, int x, int y, int w, int h, uint8_t* dst, int ds) {
  if (x >= 0 && y >= 0 && x + w <= r.ew && y + h <= r.eh) {
    for (int j = 0; j < h; j++) std::memcpy(dst + j * ds, r.p + (y + j) * r.stride + x, w);
    return;
  }
  for (int j = 0; j < h; j++) {
    int yy = std::min(std::max(y + j, 0), r.eh - 1);
    const uint8_t* row = r.p + yy * r.stride;
    for (int i = 0; i < w; i++) dst[j * ds + i] = row[std::min(std::max(x + i, 0), r.ew - 1)];
  }
}

inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

inline int rounded_div(int a, int b) { return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

enum { SLICE_OK = 0, SLICE_END = 1 };
enum { FRAME_SKIPPED = 1 };

enum Bug {
  BUG_EDGE = 1, BUG_DC_CLIP = 2, BUG_DIRECT_BLOCKSIZE = 4, BUG_QPEL_CHROMA = 8,
  BUG_QPEL_CHROMA2 = 16, BUG_NO_PADDING = 32, BUG_HPEL_CHROMA = 64
};

constexpr int kStats = 31;
enum Stat {
  ST_I, ST_P, ST_B, ST_NVOP, ST_PACKED, ST_SKIPPED_B, ST_INTRA_IN_P, ST_4MV, ST_SKIP_P, ST_DIRECT,
  ST_FWD, ST_BWD, ST_BIDIR, ST_SKIP_B, ST_DQUANT, ST_PACKETS, ST_QPEL, ST_MPEG_QUANT,
  ST_LOADED_INTRA, ST_LOADED_INTER, ST_XVID_IDCT, ST_ROUND1, ST_ACPRED, ST_ESC3, ST_INTERLACED,
  ST_FIELD_MBS, ST_PARTITIONED, ST_ALT_SCAN, ST_S, ST_GMC_MBS, ST_GMC_AFFINE
};

struct Decoder {
  uint32_t fourcc = 0;
  std::vector<uint8_t> extradata;
  // VOL
  bool vol_seen = false;
  int vo_type = 0, vol_control_parameters = 0, low_delay = 0, shape = 0;
  int time_res = 0, time_increment_bits = 0, progressive = 1, sprite_usage = 0;
  int quant_precision = 5, mpeg_quant = 0, quarter_sample = 0, resync_marker = 0;
  int data_partitioning = 0, rvlc = 0, new_pred = 0, scalability = 0;
  int cplx_i = 0, cplx_p = 0, cplx_b = 0;
  int sprite_points = 0, sprite_accuracy = 0, real_sprite_points = 0, mcsel = 0;
  int sprite_offset[2][2] = {}, sprite_delta[2][2] = {}, sprite_shift[2] = {};
  uint16_t intra_matrix[64], inter_matrix[64];
  int width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0, mb_stride = 0, b8_stride = 0;
  // encoder identity and workarounds
  int divx_version = -1, divx_build = -1, divx_packed = 0, lavc_build = -1, xvid_build = -1;
  bool xvid_idct = false;
  int bugs = 0, padding_bug_score = 0;
  // time
  long long time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0;
  int pp_time = 0, pb_time = 0, t_frame = 0, picture_number = 0;
  // VOP
  int pict_type = 0, no_rounding = 0, intra_dc_threshold = 0, qscale = 1, f_code = 1, b_code = 1;
  int y_dc_scale = 8, c_dc_scale = 8;
  // pictures
  std::shared_ptr<Picture> cur, last, next, out;
  std::vector<uint8_t> stored;  // a packed B-VOP
  long stored_tag = 0;
  // slice / macroblock state
  Bits gb;
  int mb_x = 0, mb_y = 0, resync_mb_x = 0, resync_mb_y = 0, first_slice_line = 1;
  int mb_intra = 0, mb_skipped = 0, ac_pred = 0, use_intra_dc_vlc = 0, mv_dir = 0, mv_type = 0;
  int mv[2][4][2] = {}, last_mv[2][2][2] = {}, field_select[2][2] = {};
  int interlaced_dct = 0, top_field_first = 0, alternate_scan = 0, partitioned_frame = 0;
  int pp_field_time = 0, pb_field_time = 0, mb_num_left = 0;
  std::vector<uint8_t> cbp_table, pred_dir_table;
  std::vector<int16_t> p_field_mv[2][2];  // FFmpeg's p_field_mv_table[field][select][mb]
  int block_last_index[6] = {};
  int16_t block[6][64];
  std::vector<int> dc_val[3];
  std::vector<int16_t> ac_val[3];  // 16 per entry: 8 left column, 8 top row
  int dc_off[3] = {}, dc_wrap[3] = {};
  std::vector<uint8_t> mbintra;
  long stats[kStats] = {};

  static constexpr int MV_16X16 = 0, MV_8X8 = 1, MV_FIELD = 2;
  static constexpr int DIR_FWD = 1, DIR_BWD = 2, DIR_DIRECT = 4;

  void set_qscale(int q) {
    qscale = std::min(std::max(q, 1), 31);
    y_dc_scale = k_mpeg4_y_dc_scale_table[qscale];
    c_dc_scale = k_mpeg4_c_dc_scale_table[qscale];
  }

  // --- headers -----------------------------------------------------------------
  void vol_header(Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = int(b.get(8));
    if (vo_type == 14 || vo_type == 15) unsupported("studio profile video");
    int ver_id = 1;
    if (b.get1()) {
      ver_id = int(b.get(4));
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // extended pixel aspect ratio
    if ((vol_control_parameters = b.get1())) {
      if (b.get(2) != 1) unsupported("chroma formats other than 4:2:0");
      low_delay = b.get1();
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);  // vbv
    } else if (picture_number == 0) {
      low_delay = (vo_type == 1 || vo_type == 17) ? 1 : 0;  // simple, advanced simple
    }
    shape = int(b.get(2));
    if (shape != 0) unsupported("non-rectangular (shape) VOLs");
    b.skip(1);  // marker
    time_res = int(b.get(16));
    if (!time_res) fail("VOL with vop_time_increment_resolution 0");
    time_increment_bits = 32 - __builtin_clz(unsigned(time_res - 1) | 1);
    b.skip(1);
    if (b.get1()) b.skip(time_increment_bits);  // fixed_vop_rate
    t_frame = 0;
    b.skip(1);
    int w = int(b.get(13));
    b.skip(1);
    int h = int(b.get(13));
    b.skip(1);
    if (!w || !h) fail("VOL without a frame size");
    {
      if (width && (w != width || h != height) && cur)
        unsupported("a VOL that changes the frame size mid-stream");
      width = w;
      height = h;
    }
    progressive = b.get1() ^ 1;
    interlaced_dct = 0;
    b.skip(1);  // obmc_disable
    sprite_usage = ver_id == 1 ? b.get1() : int(b.get(2));
    if (sprite_usage == 1 || sprite_usage == 3) unsupported("MPEG-4 static sprites");
    if (sprite_usage == 2) {  // GMC
      sprite_points = int(b.get(6));
      if (sprite_points > 3) fail("%d sprite warping points", sprite_points);
      if (sprite_points == 2) unsupported("MPEG-4 GMC with 2 warping points");
      sprite_accuracy = int(b.get(2));
      if (b.get1()) unsupported("MPEG-4 GMC with brightness change");
    }
    if (b.get1()) unsupported("MPEG-4 video that is not 8-bit");
    quant_precision = 5;
    if ((mpeg_quant = b.get1())) {
      for (int i = 0; i < 64; i++) {
        intra_matrix[i] = k_mpeg4_default_intra_matrix[i];
        inter_matrix[i] = k_mpeg4_default_non_intra_matrix[i];
      }
      for (int m = 0; m < 2; m++) {
        if (!b.get1()) continue;
        uint16_t* mat = m ? inter_matrix : intra_matrix;
        int last_v = 0, i = 0;
        for (; i < 64; i++) {
          if (b.left() < 8) fail("insufficient data for a custom matrix");
          int v = int(b.get(8));
          if (v == 0) break;
          last_v = v;
          mat[k_zigzag_direct[i]] = uint16_t(v);
        }
        for (; i < 64; i++) mat[k_zigzag_direct[i]] = uint16_t(last_v);
        stats[m ? ST_LOADED_INTER : ST_LOADED_INTRA] = 1;
      }
    }
    quarter_sample = ver_id != 1 ? b.get1() : 0;
    if (b.left() < 4) fail("VOL header truncated");
    if (!b.get1()) unsupported("MPEG-4 complexity estimation headers");
    cplx_i = cplx_p = cplx_b = 0;
    resync_marker = !b.get1();
    data_partitioning = b.get1();
    if (data_partitioning) {
      rvlc = b.get1();
      if (rvlc) unsupported("MPEG-4 reversible VLC (RVLC)");
      if (!progressive) unsupported("interlaced MPEG-4 video with data partitioning");
    }
    if (ver_id != 1) {
      new_pred = b.get1();
      if (new_pred) unsupported("MPEG-4 newpred");
      if (b.get1()) unsupported("MPEG-4 reduced resolution VOPs");
    }
    scalability = b.get1();
    if (scalability) unsupported("MPEG-4 scalability");
    vol_seen = true;
  }

  void user_data(Bits& b) {
    char buf[256];
    int i = 0;
    for (; i < 255 && b.pos < b.size; i++) {
      if (b.show(23) == 0) break;
      buf[i] = char(b.get(8));
    }
    buf[i] = 0;
    int ver = 0, build = 0, ver2 = 0, ver3 = 0;
    char last_c = 0;
    int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last_c);
    if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last_c);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
      divx_packed = e == 3 && last_c == 'p';
    }
    e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && std::strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
  }

  // ff_mpeg4_decode_picture_header: the start codes up to a VOP, then its
  // header. header: parsing the container's config.
  int picture_header(Bits& b, bool header) {
    b.align();
    uint32_t startcode = 0xff;
    bool vol = false;
    for (;;) {
      if (b.pos >= b.size) {
        if (b.size == 8 && (divx_version >= 0 || xvid_build >= 0)) return FRAME_SKIPPED;
        if (header && b.pos == b.size) return 0;
        fail("a packet without a VOP");
      }
      startcode = (startcode << 8) | b.get(8);
      if ((startcode & 0xFFFFFF00u) != 0x100) continue;
      if (startcode >= 0x120 && startcode <= 0x12F) {
        if (!vol) {
          vol = true;
          vol_header(b);
        }
      } else if (startcode == 0x1B2) {
        user_data(b);
      } else if (startcode == 0x1B3) {
        if (b.show(23)) {  // group_of_vop
          int hours = int(b.get(5)), minutes = int(b.get(6));
          b.skip(1);
          int seconds = int(b.get(6));
          time_base = seconds + 60LL * (minutes + 60LL * hours);
          b.skip(2);
        }
      } else if (startcode == 0x1B6) {
        break;
      } else if (startcode >= 0x100 && startcode <= 0x11F) {
        // video_object_start_code: nothing to read
      } else if (startcode == 0x1B0) {
        int profile_level = int(b.get(8));
        if (profile_level >= 0xE1 && profile_level <= 0xE8)
          unsupported("studio profile video");
      }
      b.align();
      startcode = 0xff;
    }
    if (!vol_seen) fail("a VOP before any VOL header");
    return vop_header(b);
  }

  int vop_header(Bits& b) {
    pict_type = int(b.get(2)) + PT_I;
    if (pict_type == PT_S && sprite_usage != 2) unsupported("MPEG-4 S-VOPs without GMC");
    if (pict_type == PT_S && data_partitioning) unsupported("MPEG-4 GMC with data partitioning");
    if (pict_type == PT_B && low_delay && vol_control_parameters == 0) low_delay = 0;
    partitioned_frame = data_partitioning && pict_type != PT_B;
    int time_incr = 0;
    while (b.get1()) {
      if (++time_incr > 60 * 60 * 24) fail("bad modulo_time_base");
    }
    b.skip(1);  // marker
    if (!(b.show(time_increment_bits + 1) & 1)) {
      for (time_increment_bits = 1; time_increment_bits < 16; time_increment_bits++) {
        if (pict_type == PT_P || pict_type == PT_S) {
          if ((b.show(time_increment_bits + 6) & 0x37) == 0x30) break;
        } else if ((b.show(time_increment_bits + 5) & 0x1F) == 0x18) {
          break;
        }
      }
    }
    int time_increment = int(b.get(time_increment_bits));
    if (pict_type != PT_B) {
      last_time_base = time_base;
      time_base += time_incr;
      time = time_base * time_res + time_increment;
      pp_time = int(time - last_non_b_time);
      last_non_b_time = time;
    } else {
      time = (last_time_base + time_incr) * time_res + time_increment;
      pb_time = int(pp_time - (last_non_b_time - time));
      if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0) {
        stats[ST_SKIPPED_B]++;
        return FRAME_SKIPPED;  // FFmpeg: "messed up order, maybe after seeking?"
      }
      if (t_frame == 0) t_frame = pb_time;
      if (t_frame == 0) t_frame = 1;
      auto rdiv = [](long long a, long long b) { return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b; };
      const long long base = rdiv(last_non_b_time - pp_time, t_frame);
      pp_field_time = int((rdiv(last_non_b_time, t_frame) - base) * 2);
      pb_field_time = int((rdiv(time, t_frame) - base) * 2);
      if (pp_field_time <= pb_field_time || pb_field_time <= 1) {
        pb_field_time = 2;
        pp_field_time = 4;
        if (!progressive) {
          stats[ST_SKIPPED_B]++;
          return FRAME_SKIPPED;
        }
      }
    }
    b.skip(1);  // marker
    if (!b.get1()) {  // vop_coded
      stats[ST_NVOP]++;
      return FRAME_SKIPPED;
    }
    no_rounding = (pict_type == PT_P || pict_type == PT_S) ? b.get1() : 0;
    if (b.left() < 3) fail("VOP header truncated");
    intra_dc_threshold = k_mpeg4_dc_threshold[b.get(3)];
    if (!progressive) {
      top_field_first = b.get1();
      alternate_scan = b.get1();
    } else {
      alternate_scan = 0;
    }
    if (pict_type == PT_S) sprite_trajectory(b);
    int q = int(b.get(quant_precision));
    if (q == 0) fail("VOP with vop_quant 0");
    qscale = q;
    f_code = 1;
    b_code = 1;
    if (pict_type != PT_I) {
      f_code = int(b.get(3));
      if (f_code == 0) fail("VOP with fcode_forward 0");
    }
    if (pict_type == PT_B) {
      b_code = int(b.get(3));
      if (b_code == 0) fail("VOP with fcode_backward 0");
    }
    if (vo_type == 0 && vol_control_parameters == 0 && divx_version == -1 && picture_number == 0)
      low_delay = 1;
    picture_number++;
    return 0;
  }

  // ff_mpeg4_workaround_bugs: -> true where the IDCT changed (decode again)
  bool workaround_bugs() {
    auto tag = [](const char* s) { return uint32_t(s[0]) | uint32_t(s[1]) << 8 | uint32_t(s[2]) << 16 | uint32_t(s[3]) << 24; };
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1) {
      if (fourcc == tag("XVID") || fourcc == tag("XVIX") || fourcc == tag("RMP4") ||
          fourcc == tag("ZMP4") || fourcc == tag("SIPP"))
        xvid_build = 0;
    }
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1)
      if (fourcc == tag("DIVX") && vo_type == 0 && vol_control_parameters == 0) divx_version = 400;
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    const unsigned xb = unsigned(xvid_build), lb = unsigned(lavc_build), dv = unsigned(divx_version);
    const unsigned dbuild = unsigned(divx_build);
    if (fourcc == tag("XVIX")) unsupported("interlaced XviD (XVIX) video");
    if (fourcc == tag("UMP4")) unsupported("UMP4 video");
    if (divx_version >= 500 && dbuild < 1814) bugs |= BUG_QPEL_CHROMA;
    if (divx_version > 502 && dbuild < 1814) bugs |= BUG_QPEL_CHROMA2;
    if (xb <= 3u) padding_bug_score = 256 * 256 * 256 * 64;
    if (xb <= 1u) bugs |= BUG_QPEL_CHROMA;
    if (xb <= 12u) bugs |= BUG_EDGE;
    if (xb <= 32u) bugs |= BUG_DC_CLIP;
    if (lb < 4653u) unsupported("pre-2005 libavcodec quarter-pel streams");
    if (lb < 4655u) bugs |= BUG_DIRECT_BLOCKSIZE;
    if (lb < 4670u) bugs |= BUG_EDGE;
    if (lb <= 4712u) bugs |= BUG_DC_CLIP;
    if ((lavc_build & 0xFF) >= 100 && lavc_build > 3621476 && lavc_build < 3752552 &&
        (lavc_build < 3752037 || lavc_build > 3752191))
      unsupported("libavcodec 55.x edge-emulation streams");
    if (divx_version >= 0) bugs |= BUG_DIRECT_BLOCKSIZE | BUG_HPEL_CHROMA;
    if (divx_version == 501 && divx_build == 20020416) padding_bug_score = 256 * 256 * 256 * 64;
    if (dv < 500u) bugs |= BUG_EDGE;
    if (xvid_build >= 0 && !xvid_idct) {
      xvid_idct = true;
      return true;
    }
    return false;
  }

  // --- prediction ---------------------------------------------------------------
  int block_index(int n) const {  // into dc_val / ac_val of plane (n < 4 ? 0 : n - 3)
    if (n < 4) return b8_stride * (2 * mb_y + (n >> 1)) + 2 * mb_x + (n & 1);
    return mb_stride * mb_y + mb_x;
  }

  int pred_dc(int n, int level, int* dir) {
    const int scale = n < 4 ? y_dc_scale : c_dc_scale;
    const int p = n < 4 ? 0 : n - 3, wrap = dc_wrap[p];
    int* dc = dc_val[p].data() + dc_off[p] + block_index(n);
    int a = dc[-1], b = dc[-1 - wrap], c = dc[-wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_mb_x) b = a = 1024;
    }
    if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    const int ret = level;
    level *= scale;
    if (level & ~2047) {
      if (level < 0) level = 0;
      else if (!(bugs & BUG_DC_CLIP)) level = 2047;
    }
    dc[0] = level;
    return ret;
  }

  void pred_ac(int16_t* blk, int n, int dir) {
    const int p = n < 4 ? 0 : n - 3, wrap = dc_wrap[p];
    int16_t* ac1 = ac_val[p].data() + 16 * (dc_off[p] + block_index(n));
    const int8_t* qtab = cur->qscale.data();
    if (ac_pred) {
      if (dir == 0) {
        const int xy = mb_x - 1 + mb_y * mb_stride;
        const int16_t* ac = ac1 - 16;
        if (mb_x == 0 || qscale == qtab[xy] || n == 1 || n == 3) {
          for (int i = 1; i < 8; i++) blk[i << 3] = int16_t(blk[i << 3] + ac[i]);
        } else {
          for (int i = 1; i < 8; i++)
            blk[i << 3] = int16_t(blk[i << 3] + rounded_div(ac[i] * qtab[xy], qscale));
        }
      } else {
        const int xy = mb_x + mb_y * mb_stride - mb_stride;
        const int16_t* ac = ac1 - 16 * wrap;
        if (mb_y == 0 || qscale == qtab[xy] || n == 2 || n == 3) {
          for (int i = 1; i < 8; i++) blk[i] = int16_t(blk[i] + ac[i + 8]);
        } else {
          for (int i = 1; i < 8; i++)
            blk[i] = int16_t(blk[i] + rounded_div(ac[i + 8] * qtab[xy], qscale));
        }
      }
    }
    for (int i = 1; i < 8; i++) ac1[i] = blk[i << 3];
    for (int i = 1; i < 8; i++) ac1[8 + i] = blk[i];
  }

  void clean_intra_table_entries() {
    const int w = b8_stride, xy = dc_off[0] + b8_stride * 2 * mb_y + 2 * mb_x;
    dc_val[0][xy] = dc_val[0][xy + 1] = dc_val[0][xy + w] = dc_val[0][xy + 1 + w] = 1024;
    std::memset(&ac_val[0][16 * xy], 0, 32 * sizeof(int16_t));
    std::memset(&ac_val[0][16 * (xy + w)], 0, 32 * sizeof(int16_t));
    const int cxy = mb_x + mb_y * mb_stride;
    for (int p = 1; p < 3; p++) {
      dc_val[p][dc_off[p] + cxy] = 1024;
      std::memset(&ac_val[p][16 * (dc_off[p] + cxy)], 0, 16 * sizeof(int16_t));
    }
    mbintra[cxy] = 0;
  }

  void clean_buffers() {  // ff_mpeg4_clean_buffers, at a video packet
    const int l_xy = dc_off[0] + (2 * mb_y - 1) * b8_stride + 2 * mb_x - 1;
    std::memset(&ac_val[0][16 * l_xy], 0, size_t(b8_stride * 2 + 1) * 16 * sizeof(int16_t));
    for (int p = 1; p < 3; p++) {
      const int c_xy = dc_off[p] + (mb_y - 1) * mb_stride + mb_x - 1;
      std::memset(&ac_val[p][16 * c_xy], 0, size_t(mb_stride + 1) * 16 * sizeof(int16_t));
    }
    last_mv[0][0][0] = last_mv[0][0][1] = last_mv[1][0][0] = last_mv[1][0][1] = 0;
  }

  int16_t* motion_val(Picture& pic, int idx) { return &pic.mv[2 * (mv_off() + idx)]; }
  int mv_off() const { return 2 * b8_stride + 4; }
  int b8_index(int block) const { return b8_stride * (2 * mb_y + (block >> 1)) + 2 * mb_x + (block & 1); }

  int16_t* pred_motion(int block, int* px, int* py) {  // ff_h263_pred_motion
    static const int off[4] = {2, 1, 1, -1};
    const int wrap = b8_stride;
    int16_t* mot = motion_val(*cur, b8_index(block));
    int16_t* A = mot - 2;
    if (first_slice_line && block < 3) {
      if (block == 0) {
        if (mb_x == resync_mb_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_mb_x) {
          int16_t* C = mot + 2 * (off[block] - wrap);
          if (mb_x == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid_pred(A[0], 0, C[0]);
            *py = mid_pred(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (block == 1) {
        if (mb_x + 1 == resync_mb_x) {
          int16_t* C = mot + 2 * (off[block] - wrap);
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        int16_t* B = mot - 2 * wrap;
        int16_t* C = mot + 2 * (off[block] - wrap);
        if (mb_x == resync_mb_x) A[0] = A[1] = 0;
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      int16_t* B = mot - 2 * wrap;
      int16_t* C = mot + 2 * (off[block] - wrap);
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
    return mot;
  }

  int decode_motion(int pred, int fcode) {  // ff_h263_decode_motion
    const int code = tables().mv.decode(gb);
    if (code == 0) return pred;
    if (code < 0) fail("bad motion vector VLC at macroblock %d, %d", mb_x, mb_y);
    const int sign = gb.get1();
    const int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(gb.get(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + fcode;  // sign_extend(val, 5 + f_code)
    return int(int32_t(uint32_t(val) << (32 - bits)) >> (32 - bits));
  }


  // --- global motion compensation (S-VOPs of a GMC VOL) ---------------------------
  // mpeg4_decode_sprite_trajectory: the warping points -> the affine map's
  // offsets and deltas, FFmpeg's fixed point (16 fraction bits unless it
  // reduces to a translation)
  void sprite_trajectory(Bits& b) {
    static const Vlc traj = [] {
      static const uint16_t lens[15] = {2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};
      uint16_t codes[15];
      uint32_t code = 0;
      for (int i = 0; i < 15; i++) {  // canonical, in order
        if (i) code = (code + 1) << (lens[i] - lens[i - 1]);
        codes[i] = uint16_t(code);
      }
      Vlc v;
      v.build(15, codes, lens, 1);
      return v;
    }();
    const int a = 2 << sprite_accuracy, rho = 3 - sprite_accuracy, r = 16 / a;
    const int w = width, h = height;
    const long long vop_ref[3][2] = {{0, 0}, {w, 0}, {0, h}};
    int d[3][2] = {};
    for (int i = 0; i < sprite_points; i++) {
      for (int c = 0; c < 2; c++) {
        const int len = traj.decode(b);
        if (len < 0) fail("bad sprite trajectory VLC");
        d[i][c] = len > 0 ? b.xbits(len) : 0;
        b.skip(1);  // marker
      }
    }
    int alpha = 1, beta = 0;
    while ((1 << alpha) < w) alpha++;
    while ((1 << beta) < h) beta++;
    const long long w2 = 1LL << alpha, h2 = 1LL << beta;
    long long sref[3][2];
    for (int c = 0; c < 2; c++) {
      sref[0][c] = (a >> 1) * (2 * vop_ref[0][c] + d[0][c]);
      sref[1][c] = (a >> 1) * (2 * vop_ref[1][c] + d[0][c] + d[1][c]);
      sref[2][c] = (a >> 1) * (2 * vop_ref[2][c] + d[0][c] + d[2][c]);
    }
    auto rdiv = [](long long x, long long y) { return (x >= 0 ? x + (y >> 1) : x - (y >> 1)) / y; };
    long long vref[2][2];
    vref[0][0] = 16 * (vop_ref[0][0] + w2) +
                 rdiv((w - w2) * (r * sref[0][0] - 16 * vop_ref[0][0]) +
                      w2 * (r * sref[1][0] - 16 * vop_ref[1][0]), w);
    vref[0][1] = 16 * vop_ref[0][1] +
                 rdiv((w - w2) * (r * sref[0][1] - 16 * vop_ref[0][1]) +
                      w2 * (r * sref[1][1] - 16 * vop_ref[1][1]), w);
    vref[1][0] = 16 * vop_ref[0][0] +
                 rdiv((h - h2) * (r * sref[0][0] - 16 * vop_ref[0][0]) +
                      h2 * (r * sref[2][0] - 16 * vop_ref[2][0]), h);
    vref[1][1] = 16 * (vop_ref[0][1] + h2) +
                 rdiv((h - h2) * (r * sref[0][1] - 16 * vop_ref[0][1]) +
                      h2 * (r * sref[2][1] - 16 * vop_ref[2][1]), h);
    for (int c = 0; c < 2; c++)  // FFmpeg keeps the virtual points in ints
      for (int k = 0; k < 2; k++) vref[c][k] = int(vref[c][k]);
    long long off[2][2], del[2][2];
    int shift[2];
    if (sprite_points == 0) {
      off[0][0] = off[0][1] = off[1][0] = off[1][1] = 0;
      del[0][0] = a;
      del[0][1] = del[1][0] = 0;
      del[1][1] = a;
      shift[0] = shift[1] = 0;
    } else if (sprite_points == 1) {
      off[0][0] = sref[0][0] - a * vop_ref[0][0];
      off[0][1] = sref[0][1] - a * vop_ref[0][1];
      off[1][0] = ((sref[0][0] >> 1) | (sref[0][0] & 1)) - a * (vop_ref[0][0] / 2);
      off[1][1] = ((sref[0][1] >> 1) | (sref[0][1] & 1)) - a * (vop_ref[0][1] / 2);
      del[0][0] = a;
      del[0][1] = del[1][0] = 0;
      del[1][1] = a;
      shift[0] = shift[1] = 0;
    } else {  // 3
      const int min_ab = std::min(alpha, beta);
      const long long w3 = w2 >> min_ab, h3 = h2 >> min_ab;
      const int s0 = alpha + beta + rho - min_ab;
      for (int c = 0; c < 2; c++) {
        const long long dx = -r * sref[0][c] + vref[0][c], dy = -r * sref[0][c] + vref[1][c];
        off[0][c] = sref[0][c] * (1LL << s0) + dx * h3 * (-vop_ref[0][0]) +
                    dy * w3 * (-vop_ref[0][1]) + (1LL << (s0 - 1));
        off[1][c] = dx * h3 * (-2 * vop_ref[0][0] + 1) + dy * w3 * (-2 * vop_ref[0][1] + 1) +
                    2 * w2 * h3 * r * sref[0][c] - 16 * w2 * h3 + (1LL << (s0 + 1));
        del[c][0] = dx * h3;
        del[c][1] = dy * w3;
      }
      shift[0] = s0;
      shift[1] = s0 + 2;
    }
    if (del[0][0] == (long long)a << shift[0] && del[0][1] == 0 && del[1][0] == 0 &&
        del[1][1] == (long long)a << shift[0]) {  // a translation
      for (int c = 0; c < 2; c++) {
        off[0][c] >>= shift[0];
        off[1][c] >>= shift[1];
      }
      del[0][0] = del[1][1] = a;
      del[0][1] = del[1][0] = 0;
      shift[0] = shift[1] = 0;
      real_sprite_points = 1;
    } else {
      const int sy = 16 - shift[0], sc = 16 - shift[1];
      for (int i = 0; i < 2; i++)
        if (sc < 0 || sy < 0 || std::llabs(off[0][i]) >= (INT32_MAX >> sy) ||
            std::llabs(off[1][i]) >= (INT32_MAX >> sc) || std::llabs(del[0][i]) >= (INT32_MAX >> sy) ||
            std::llabs(del[1][i]) >= (INT32_MAX >> sy))
          unsupported("MPEG-4 GMC parameters out of FFmpeg's range");
      for (int i = 0; i < 2; i++) {
        off[0][i] *= 1LL << sy;
        off[1][i] *= 1LL << sc;
        del[0][i] *= 1LL << sy;
        del[1][i] *= 1LL << sy;
        shift[i] = 16;
      }
      for (int i = 0; i < 2; i++) {
        const long long sd0 = del[i][0] - a * (1LL << 16), sd1 = del[i][1] - a * (1LL << 16);
        const long long W = w + 16LL, H = h + 16LL;
        if (std::llabs(off[0][i] + del[i][0] * W) >= INT32_MAX ||
            std::llabs(off[0][i] + del[i][1] * H) >= INT32_MAX ||
            std::llabs(off[0][i] + del[i][0] * W + del[i][1] * H) >= INT32_MAX ||
            std::llabs(del[i][0] * W) >= INT32_MAX || std::llabs(del[i][1] * H) >= INT32_MAX ||
            std::llabs(sd0) >= INT32_MAX || std::llabs(sd1) >= INT32_MAX ||
            std::llabs(off[0][i] + sd0 * W) >= INT32_MAX ||
            std::llabs(off[0][i] + sd1 * H) >= INT32_MAX ||
            std::llabs(off[0][i] + sd0 * W + sd1 * H) >= INT32_MAX)
          unsupported("MPEG-4 GMC parameters out of FFmpeg's range");
      }
      real_sprite_points = sprite_points;
    }
    for (int i = 0; i < 2; i++) {
      for (int c = 0; c < 2; c++) {
        sprite_offset[i][c] = int(off[i][c]);
        sprite_delta[i][c] = int(del[i][c]);
      }
      sprite_shift[i] = shift[i];
    }
  }

  static int rshift(int x, int n) {  // FFmpeg's RSHIFT: rounding half away from zero
    return x > 0 ? (x + ((1 << n) >> 1)) >> n : (x + ((1 << n) >> 1) - 1) >> n;
  }

  int get_amv(int n) {  // a GMC macroblock's average vector, for prediction
    const int len = 1 << (f_code + 4), a = sprite_accuracy;
    int sum;
    if (real_sprite_points == 1) {
      sum = rshift(sprite_offset[0][n] * (1 << quarter_sample), a);
    } else {
      int dx = sprite_delta[n][0], dy = sprite_delta[n][1];
      const int shift = sprite_shift[0];
      if (n) dy -= 1 << (shift + a + 1);
      else dx -= 1 << (shift + a + 1);
      const int mb_v = int(unsigned(sprite_offset[0][n]) + unsigned(dx) * mb_x * 16u +
                           unsigned(dy) * mb_y * 16u);
      sum = 0;
      for (int y = 0; y < 16; y++) {
        int v = int(unsigned(mb_v) + unsigned(dy) * y);
        for (int x = 0; x < 16; x++) {
          sum += v >> shift;
          v = int(unsigned(v) + unsigned(dx));
        }
      }
      sum = rshift(sum, a + 8 - quarter_sample);
    }
    return sum < -len ? -len : sum >= len ? len - 1 : sum;
  }

  // ff_gmc_c: an 8-wide block of h rows warped from the reference
  static void gmc_block(uint8_t* dst, const uint8_t* src, int stride, int h, int ox, int oy,
                        int dxx, int dxy, int dyx, int dyy, int shift, int r, int width,
                        int height) {
    const int s = 1 << shift;
    width--;
    height--;
    for (int y = 0; y < h; y++) {
      int vx = ox, vy = oy;
      for (int x = 0; x < 8; x++) {
        int src_x = vx >> 16, src_y = vy >> 16;
        const int fx = src_x & (s - 1), fy = src_y & (s - 1);
        src_x >>= shift;
        src_y >>= shift;
        int v;
        if (unsigned(src_x) < unsigned(width)) {
          if (unsigned(src_y) < unsigned(height)) {
            const uint8_t* p = src + src_x + src_y * stride;
            v = ((p[0] * (s - fx) + p[1] * fx) * (s - fy) + (p[stride] * (s - fx) + p[stride + 1] * fx) * fy +
                 r) >> (shift * 2);
          } else {
            const uint8_t* p = src + src_x + std::min(std::max(src_y, 0), height) * stride;
            v = ((p[0] * (s - fx) + p[1] * fx) * s + r) >> (shift * 2);
          }
        } else if (unsigned(src_y) < unsigned(height)) {
          const uint8_t* p = src + std::min(std::max(src_x, 0), width) + src_y * stride;
          v = ((p[0] * (s - fy) + p[stride] * fy) * s + r) >> (shift * 2);
        } else {
          v = src[std::min(std::max(src_x, 0), width) + std::min(std::max(src_y, 0), height) * stride];
        }
        dst[y * stride + x] = uint8_t(v);
        vx += dxx;
        vy += dyx;
      }
      ox += dxy;
      oy += dyy;
    }
  }

  void gmc_motion(const Picture& ref, uint8_t* dy, uint8_t* dcb, uint8_t* dcr) {
    const int a = sprite_accuracy, r = (1 << (2 * a + 1)) - no_rounding;
    const int ew = (bugs & BUG_EDGE) ? width : ref.lw, eh = (bugs & BUG_EDGE) ? height : ref.lh;
    const int* d0 = sprite_delta[0];
    const int* d1 = sprite_delta[1];
    int ox = sprite_offset[0][0] + d0[0] * mb_x * 16 + d0[1] * mb_y * 16;
    int oy = sprite_offset[0][1] + d1[0] * mb_x * 16 + d1[1] * mb_y * 16;
    gmc_block(dy, ref.plane[0].data(), ref.lw, 16, ox, oy, d0[0], d0[1], d1[0], d1[1], a + 1, r, ew, eh);
    gmc_block(dy + 8, ref.plane[0].data(), ref.lw, 16, ox + d0[0] * 8, oy + d1[0] * 8, d0[0], d0[1],
              d1[0], d1[1], a + 1, r, ew, eh);
    ox = sprite_offset[1][0] + d0[0] * mb_x * 8 + d0[1] * mb_y * 8;
    oy = sprite_offset[1][1] + d1[0] * mb_x * 8 + d1[1] * mb_y * 8;
    gmc_block(dcb, ref.plane[1].data(), ref.cw, 8, ox, oy, d0[0], d0[1], d1[0], d1[1], a + 1, r,
              (ew + 1) >> 1, (eh + 1) >> 1);
    gmc_block(dcr, ref.plane[2].data(), ref.cw, 8, ox, oy, d0[0], d0[1], d1[0], d1[1], a + 1, r,
              (ew + 1) >> 1, (eh + 1) >> 1);
  }

  // gmc1_motion: a translation, 1/16 pel by gmc1's bilinear weights (or
  // half-pel ops where it falls on a half)
  void gmc1_motion(const Picture& ref, uint8_t* dy, uint8_t* dcb, uint8_t* dcr) {
    const int acc = sprite_accuracy, rounder = 128 - no_rounding;
    auto gmc1 = [](uint8_t* dst, int ds, const uint8_t* src, int ss, int h, int x16, int y16,
                   int rnd) {
      const int A = (16 - x16) * (16 - y16), B = x16 * (16 - y16), C = (16 - x16) * y16,
                D = x16 * y16;
      for (int i = 0; i < h; i++)
        for (int x = 0; x < 8; x++)
          dst[i * ds + x] = uint8_t((A * src[i * ss + x] + B * src[i * ss + x + 1] +
                                     C * src[(i + 1) * ss + x] + D * src[(i + 1) * ss + x + 1] +
                                     rnd) >> 8);
    };
    uint8_t tmp[17 * 17];
    int mx = sprite_offset[0][0], my = sprite_offset[0][1];
    int sx = mb_x * 16 + (mx >> (acc + 1)), sy = mb_y * 16 + (my >> (acc + 1));
    mx *= 1 << (3 - acc);
    my *= 1 << (3 - acc);
    sx = std::min(std::max(sx, -16), width);
    if (sx == width) mx = 0;
    sy = std::min(std::max(sy, -16), height);
    if (sy == height) my = 0;
    fetch(plane_of(ref, 0), sx, sy, 17, 17, tmp, 17);
    if ((mx | my) & 7) {
      gmc1(dy, ref.lw, tmp, 17, 16, mx & 15, my & 15, rounder);
      gmc1(dy + 8, ref.lw, tmp + 8, 17, 16, mx & 15, my & 15, rounder);
    } else {
      const int dxy = ((mx >> 3) & 1) | ((my >> 2) & 2);
      hpel(no_rounding ? PUT_NO_RND : PUT, dxy, dy, ref.lw, tmp, 17, 16, 16);
    }
    mx = sprite_offset[1][0];
    my = sprite_offset[1][1];
    sx = mb_x * 8 + (mx >> (acc + 1));
    sy = mb_y * 8 + (my >> (acc + 1));
    mx *= 1 << (3 - acc);
    my *= 1 << (3 - acc);
    sx = std::min(std::max(sx, -8), width >> 1);
    if (sx == (width >> 1)) mx = 0;
    sy = std::min(std::max(sy, -8), height >> 1);
    if (sy == (height >> 1)) my = 0;
    fetch(plane_of(ref, 1), sx, sy, 9, 9, tmp, 17);
    gmc1(dcb, ref.cw, tmp, 17, 8, mx & 15, my & 15, rounder);
    fetch(plane_of(ref, 2), sx, sy, 9, 9, tmp, 17);
    gmc1(dcr, ref.cw, tmp, 17, 8, mx & 15, my & 15, rounder);
  }

  // --- blocks --------------------------------------------------------------------
  int decode_dc(int n, int* dir) {
    const int code = (n < 4 ? tables().dc_lum : tables().dc_chrom).decode(gb);
    if (code < 0 || code > 9) fail("bad intra DC VLC at macroblock %d, %d", mb_x, mb_y);
    int level = 0;
    if (code) {
      level = gb.xbits(code);
      if (code > 8) gb.skip(1);  // marker
    }
    return pred_dc(n, level, dir);
  }

  void decode_block(int16_t* blk, int n, bool coded, bool intra) {
    const Tables& t = tables();
    int i, dc_dir = 0, qmul = 1, qadd = 0;
    const uint8_t* scan = alternate_scan ? k_alternate_vertical_scan : k_zigzag_direct;
    const RunLevel* rl = &t.inter;
    if (intra) {
      if (use_intra_dc_vlc && partitioned_frame) {  // the DC from partition A's dc_val
        const int scale = n < 4 ? y_dc_scale : c_dc_scale;
        const int p = n < 4 ? 0 : n - 3;
        blk[0] = int16_t((dc_val[p][dc_off[p] + block_index(n)] + (scale >> 1)) / scale);
        dc_dir = (pred_dir_table[mb_x + mb_y * mb_stride] << n) & 32;
        i = 0;
      } else if (use_intra_dc_vlc) {
        blk[0] = int16_t(decode_dc(n, &dc_dir));
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, &dc_dir);
      }
      if (!coded) goto not_coded;
      rl = &t.intra;
      if (ac_pred && !alternate_scan)
        scan = dc_dir == 0 ? k_alternate_vertical_scan : k_alternate_horizontal_scan;
    } else {
      i = -1;
      if (!coded) {
        block_last_index[n] = -1;
        return;
      }
      if (!mpeg_quant) {
        qmul = qscale << 1;
        qadd = (qscale - 1) | 1;
      }
    }
    for (;;) {
      int sym = rl->vlc.decode(gb);
      if (sym < 0) fail("bad DCT coefficient VLC at macroblock %d, %d", mb_x, mb_y);
      int level, run, last;
      if (sym == rl->n) {  // escape
        const uint32_t cache = gb.show(2);
        if (cache & 2) {
          if (cache & 1) {  // third escape: fixed length
            gb.skip(2);
            last = gb.get1();
            run = int(gb.get(6));
            if (!gb.get1()) fail("missing marker in an escaped coefficient at macroblock %d, %d", mb_x, mb_y);
            level = int(int32_t(gb.get(12) << 20) >> 20);
            if (!gb.get1()) fail("missing marker in an escaped coefficient at macroblock %d, %d", mb_x, mb_y);
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (unsigned(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            i += run + 1;
            stats[ST_ESC3]++;
          } else {  // second escape: run + max_run + 1
            gb.skip(2);
            sym = rl->vlc.decode(gb);
            if (sym < 0 || sym == rl->n) fail("bad escaped coefficient at macroblock %d, %d", mb_x, mb_y);
            run = rl->run[sym];
            last = sym >= rl->last_start;
            level = rl->level[sym];
            i += run + rl->max_run[last][level] + 1 + 1;
            level = level * qmul + qadd;
            if (gb.get1()) level = -level;
          }
        } else {  // first escape: level + max_level
          gb.skip(1);
          sym = rl->vlc.decode(gb);
          if (sym < 0 || sym == rl->n) fail("bad escaped coefficient at macroblock %d, %d", mb_x, mb_y);
          run = rl->run[sym];
          last = sym >= rl->last_start;
          level = rl->level[sym] * qmul + qadd + rl->max_level[last][run] * qmul;
          i += run + 1;
          if (gb.get1()) level = -level;
        }
      } else {
        run = rl->run[sym];
        last = sym >= rl->last_start;
        level = rl->level[sym] * qmul + qadd;
        i += run + 1;
        if (gb.get1()) level = -level;
      }
      if (i > 63 || (!last && i > 62))
        fail("DCT coefficients past the block at macroblock %d, %d", mb_x, mb_y);
      blk[scan[i]] = int16_t(level);
      if (last) break;
    }
  not_coded:
    if (intra) {
      if (!use_intra_dc_vlc) {
        blk[0] = int16_t(pred_dc(n, blk[0], &dc_dir));
        if (i < 0) i = 0;
      }
      pred_ac(blk, n, dc_dir);
      if (ac_pred) i = 63;
    }
    block_last_index[n] = i;
  }

  // --- macroblocks ---------------------------------------------------------------
  int is_resync() {  // mpeg4_is_resync
    long bits_count = gb.pos;
    uint32_t v = gb.show(16);
    if ((bugs & BUG_NO_PADDING) && !resync_marker) return 0;
    while (v <= 0xFF) {
      if (pict_type == PT_B || (v >> (8 - pict_type)) != 1 || partitioned_frame) break;
      gb.skip(8 + pict_type);
      bits_count += 8 + pict_type;
      v = gb.show(16);
    }
    if (bits_count + 8 >= gb.size) {
      v >>= 8;
      v |= 0x7F >> (7 - (bits_count & 7));
      if (v == 0x7F) return mb_num;
    } else if (v == k_mpeg4_resync_prefix[bits_count & 7]) {
      const int mb_num_bits = 32 - __builtin_clz(unsigned(mb_num - 1) | 1);
      Bits save = gb;
      gb.skip(1);
      gb.align();
      int len = 0;
      for (; len < 32; len++)
        if (gb.get1()) break;
      int n = int(gb.get(mb_num_bits));
      if (!n || n > mb_num || gb.pos + 6 > gb.size) n = -1;
      gb = save;
      if (len >= prefix_length()) return n;
    }
    return 0;
  }

  int prefix_length() const {
    if (pict_type == PT_I) return 16;
    if (pict_type == PT_P || pict_type == PT_S) return f_code + 15;
    return std::max(std::max(f_code, b_code), 2) + 15;
  }

  int decode_mb() {  // mpeg4_decode_mb
    static const int quant_tab[4] = {-1, -2, 1, 2};
    const Tables& t = tables();
    const int xy = mb_x + mb_y * mb_stride;
    int cbpc = 0, cbpy, cbp, dquant = 0;
    std::memset(block, 0, sizeof block);
    mcsel = 0;
    if (pict_type == PT_P || pict_type == PT_S) {
      do {
        if (gb.get1()) {  // not coded
          mb_intra = 0;
          for (int i = 0; i < 6; i++) block_last_index[i] = -1;
          mv_dir = DIR_FWD;
          mv_type = MV_16X16;
          if (pict_type == PT_S) {  // GMC, its average vector for the neighbours
            cur->mbtype[xy] = MB_SKIP | MB_GMC | MB_16X16 | MB_L0;
            mcsel = 1;
            mv[0][0][0] = get_amv(0);
            mv[0][0][1] = get_amv(1);
            mb_skipped = 0;
            stats[ST_GMC_MBS]++;
          } else {
            cur->mbtype[xy] = MB_SKIP | MB_16X16 | MB_L0;
            mv[0][0][0] = mv[0][0][1] = 0;
            mb_skipped = 1;
          }
          stats[ST_SKIP_P]++;
          goto end;
        }
        cbpc = t.inter_mcbpc.decode(gb);
        if (cbpc < 0) fail("bad MCBPC at macroblock %d, %d", mb_x, mb_y);
      } while (cbpc == 20);
      dquant = cbpc & 8;
      mb_intra = (cbpc & 4) != 0;
      if (mb_intra) {
        stats[ST_INTRA_IN_P]++;
        goto intra;
      }
      if (pict_type == PT_S && (cbpc & 16) == 0) mcsel = gb.get1();
      cbpy = t.cbpy.decode(gb);
      if (cbpy < 0) fail("bad CBPY at macroblock %d, %d", mb_x, mb_y);
      cbpy ^= 0xF;
      cbp = (cbpc & 3) | (cbpy << 2);
      if (dquant) {
        set_qscale(qscale + quant_tab[gb.get(2)]);
        stats[ST_DQUANT]++;
      }
      if (!progressive && cbp) interlaced_dct = gb.get1();
      mv_dir = DIR_FWD;
      if ((cbpc & 16) == 0) {
        int px, py;
        if (mcsel) {  // 16 x 16 global motion
          cur->mbtype[xy] = MB_GMC | MB_16X16 | MB_L0;
          mv_type = MV_16X16;
          mv[0][0][0] = get_amv(0);
          mv[0][0][1] = get_amv(1);
          stats[ST_GMC_MBS]++;
        } else if (!progressive && gb.get1()) {  // 16 x 8 field prediction
          cur->mbtype[xy] = MB_L0 | MB_INTERLACED;
          mv_type = MV_FIELD;
          field_select[0][0] = gb.get1();
          field_select[0][1] = gb.get1();
          pred_motion(0, &px, &py);
          for (int i = 0; i < 2; i++) {
            mv[0][i][0] = decode_motion(px, f_code);
            mv[0][i][1] = decode_motion(py / 2, f_code);
          }
          stats[ST_FIELD_MBS]++;
        } else {
          cur->mbtype[xy] = MB_16X16 | MB_L0;
          mv_type = MV_16X16;
          pred_motion(0, &px, &py);
          mv[0][0][0] = decode_motion(px, f_code);
          mv[0][0][1] = decode_motion(py, f_code);
        }
      } else {
        cur->mbtype[xy] = MB_8X8 | MB_L0;
        mv_type = MV_8X8;
        stats[ST_4MV]++;
        for (int i = 0; i < 4; i++) {
          int px, py;
          int16_t* mot = pred_motion(i, &px, &py);
          const int mx = decode_motion(px, f_code);
          const int my = decode_motion(py, f_code);
          mv[0][i][0] = mx;
          mv[0][i][1] = my;
          mot[0] = int16_t(mx);
          mot[1] = int16_t(my);
        }
      }
    } else if (pict_type == PT_B) {
      int mb_type;
      mb_intra = 0;
      if (mb_x == 0)
        for (int i = 0; i < 2; i++)
          last_mv[i][0][0] = last_mv[i][0][1] = last_mv[i][1][0] = last_mv[i][1][1] = 0;
      mb_skipped = next->mbskip[xy];
      if (mb_skipped) {
        for (int i = 0; i < 6; i++) block_last_index[i] = -1;
        mv_dir = DIR_FWD;
        mv_type = MV_16X16;
        mv[0][0][0] = mv[0][0][1] = mv[1][0][0] = mv[1][0][1] = 0;
        cur->mbtype[xy] = MB_SKIP | MB_16X16 | MB_L0;
        stats[ST_SKIP_B]++;
        goto end;
      }
      if (gb.get1()) {  // modb '1': direct, no vectors, no coefficients
        mb_type = MB_DIRECT | MB_SKIP | MB_L0 | MB_L1;
        cbp = 0;
      } else {
        const int modb2 = gb.get1();
        const int code = t.mb_type_b.decode(gb);
        if (code < 0) fail("bad B macroblock type at macroblock %d, %d", mb_x, mb_y);
        static const int map[4] = {MB_DIRECT | MB_L0 | MB_L1, MB_L0 | MB_L1 | MB_16X16,
                                   MB_L1 | MB_16X16, MB_L0 | MB_16X16};
        mb_type = map[code];
        cbp = modb2 ? 0 : int(gb.get(6));
        if (!(mb_type & MB_DIRECT) && cbp && gb.get1()) {
          set_qscale(qscale + gb.get1() * 4 - 2);
          stats[ST_DQUANT]++;
        }
        if (!progressive) {
          if (cbp) interlaced_dct = gb.get1();
          if (!(mb_type & MB_DIRECT) && gb.get1()) {
            mb_type = (mb_type | MB_INTERLACED) & ~MB_16X16;
            for (int d = 0; d < 2; d++)
              if (mb_type & (d ? MB_L1 : MB_L0)) {
                field_select[d][0] = gb.get1();
                field_select[d][1] = gb.get1();
              }
          }
        }
        mv_dir = 0;
        if (mb_type & MB_INTERLACED) {
          mv_type = MV_FIELD;
          for (int d = 0; d < 2; d++) {
            if (!(mb_type & (d ? MB_L1 : MB_L0))) continue;
            mv_dir |= d ? DIR_BWD : DIR_FWD;
            for (int i = 0; i < 2; i++) {
              const int mx = decode_motion(last_mv[d][i][0], d ? b_code : f_code);
              const int my = decode_motion(last_mv[d][i][1] / 2, d ? b_code : f_code);
              last_mv[d][i][0] = mv[d][i][0] = mx;
              mv[d][i][1] = my;
              last_mv[d][i][1] = my * 2;
            }
          }
          stats[ST_FIELD_MBS]++;
        } else if (!(mb_type & MB_DIRECT)) {
          mv_type = MV_16X16;
          if (mb_type & MB_L0) {
            mv_dir = DIR_FWD;
            const int mx = decode_motion(last_mv[0][0][0], f_code);
            const int my = decode_motion(last_mv[0][0][1], f_code);
            last_mv[0][1][0] = last_mv[0][0][0] = mv[0][0][0] = mx;
            last_mv[0][1][1] = last_mv[0][0][1] = mv[0][0][1] = my;
          }
          if (mb_type & MB_L1) {
            mv_dir |= DIR_BWD;
            const int mx = decode_motion(last_mv[1][0][0], b_code);
            const int my = decode_motion(last_mv[1][0][1], b_code);
            last_mv[1][1][0] = last_mv[1][0][0] = mv[1][0][0] = mx;
            last_mv[1][1][1] = last_mv[1][0][1] = mv[1][0][1] = my;
          }
          stats[(mb_type & MB_L0) && (mb_type & MB_L1) ? ST_BIDIR : (mb_type & MB_L0) ? ST_FWD : ST_BWD]++;
        }
      }
      if (mb_type & MB_DIRECT) {
        int mx = 0, my = 0;
        if (!(mb_type & MB_SKIP)) {
          mx = decode_motion(0, 1);
          my = decode_motion(0, 1);
        }
        mv_dir = DIR_FWD | DIR_BWD | DIR_DIRECT;
        set_direct_mv(mx, my);
        stats[ST_DIRECT]++;
      }
      cur->mbtype[xy] = uint16_t(mb_type);
    } else {  // I-VOP
      do {
        cbpc = t.intra_mcbpc.decode(gb);
        if (cbpc < 0) fail("bad intra MCBPC at macroblock %d, %d", mb_x, mb_y);
      } while (cbpc == 8);
      dquant = cbpc & 4;
      mb_intra = 1;
    intra:
      ac_pred = gb.get1();
      if (ac_pred) stats[ST_ACPRED]++;
      cur->mbtype[xy] = MB_INTRA;
      cbpy = t.cbpy.decode(gb);
      if (cbpy < 0) fail("bad CBPY at macroblock %d, %d", mb_x, mb_y);
      cbp = (cbpc & 3) | (cbpy << 2);
      use_intra_dc_vlc = qscale < intra_dc_threshold;
      if (dquant) {
        set_qscale(qscale + quant_tab[gb.get(2)]);
        stats[ST_DQUANT]++;
      }
      if (!progressive) interlaced_dct = gb.get1();
      for (int i = 0; i < 6; i++) {
        decode_block(block[i], i, cbp & 32, true);
        cbp += cbp;
      }
      goto end;
    }
    for (int i = 0; i < 6; i++) {
      decode_block(block[i], i, cbp & 32, false);
      cbp += cbp;
    }
  end:
    if (gb.pos > gb.size) fail("VOP data ends inside macroblock %d, %d", mb_x, mb_y);
    const int next_mb = is_resync();
    if (next_mb) {
      if (mb_x + mb_y * mb_w + 1 >= next_mb) return SLICE_END;
      if (pict_type == PT_B) {
        const int delta = mb_x + 1 == mb_w ? 2 : 1;
        if (next->mbskip[xy + delta]) return SLICE_OK;
      }
      return SLICE_END;
    }
    return SLICE_OK;
  }

  void set_direct_mv(int mx, int my) {  // ff_mpeg4_set_direct_mv
    const int xy = mb_x + mb_y * mb_stride;
    const uint16_t colocated = next->mbtype[xy];
    const int pp = uint16_t(pp_time), pb = uint16_t(pb_time);
    auto one = [&](int i) {
      const int16_t* p = motion_val(*next, b8_index(i));
      for (int c = 0; c < 2; c++) {
        const int d = c ? my : mx, pm = p[c];
        mv[0][i][c] = pm * pb / pp + d;
        mv[1][i][c] = d ? mv[0][i][c] - pm : pm * (pb - pp) / pp;
      }
    };
    if (colocated & MB_8X8) {
      mv_type = MV_8X8;
      for (int i = 0; i < 4; i++) one(i);
    } else if (colocated & MB_INTERLACED) {
      mv_type = MV_FIELD;
      for (int i = 0; i < 2; i++) {
        const int fs = next->ref_index[4 * xy + 2 * i];
        field_select[0][i] = fs;
        field_select[1][i] = i;
        const int tpp = top_field_first ? pp_field_time - fs + i : pp_field_time + fs - i;
        const int tpb = top_field_first ? pb_field_time - fs + i : pb_field_time + fs - i;
        for (int c = 0; c < 2; c++) {
          const int d = c ? my : mx, pm = p_field_mv[i][fs][2 * xy + c];
          mv[0][i][c] = pm * tpb / tpp + d;
          mv[1][i][c] = d ? mv[0][i][c] - pm : pm * (tpb - tpp) / tpp;
        }
      }
    } else {
      one(0);
      for (int i = 1; i < 4; i++)
        for (int d = 0; d < 2; d++)
          for (int c = 0; c < 2; c++) mv[d][i][c] = mv[d][0][c];
      mv_type = (bugs & BUG_DIRECT_BLOCKSIZE) || !quarter_sample ? MV_16X16 : MV_8X8;
    }
  }

  void update_motion_val() {  // ff_h263_update_motion_val
    const int xy = mb_x + mb_y * mb_stride;
    cur->mbskip[xy] = uint8_t(mb_skipped);
    if (mv_type != MV_8X8) {
      int mx = mb_intra ? 0 : mv[0][0][0], my = mb_intra ? 0 : mv[0][0][1];
      if (!mb_intra && mv_type == MV_FIELD) {
        mx = mv[0][0][0] + mv[0][1][0];
        my = mv[0][0][1] + mv[0][1][1];
        mx = (mx >> 1) | (mx & 1);
        for (int i = 0; i < 2; i++)
          for (int c = 0; c < 2; c++) p_field_mv[i][field_select[0][i]][2 * xy + c] = int16_t(mv[0][i][c]);
        cur->ref_index[4 * xy] = cur->ref_index[4 * xy + 1] = uint8_t(field_select[0][0]);
        cur->ref_index[4 * xy + 2] = cur->ref_index[4 * xy + 3] = uint8_t(field_select[0][1]);
      }
      for (int blk = 0; blk < 4; blk++) {
        int16_t* m = motion_val(*cur, b8_index(blk));
        m[0] = int16_t(mx);
        m[1] = int16_t(my);
      }
    }
  }

  // --- reconstruction ------------------------------------------------------------
  void dequant_intra(int16_t* blk, int n) {
    const int q = qscale;
    blk[0] = int16_t(blk[0] * (n < 4 ? y_dc_scale : c_dc_scale));
    if (mpeg_quant) {  // FFmpeg's MPEG-2 routine on 2 q: 16-bit products (x86)
      const uint16_t* m = intra_matrix;
      for (int i = 1; i < 64; i++) {
        int level = blk[i];
        if (!level) continue;
        const int a = std::abs(level);
        const int v = int16_t(uint16_t(a * uint16_t(2 * q * m[i]))) >> 4;
        blk[i] = int16_t(level < 0 ? -v : v);
      }
    } else {  // x86: 16-bit products
      const int qmul = q << 1, qadd = (q - 1) | 1;
      for (int i = 1; i < 64; i++) {
        int level = blk[i];
        if (!level) continue;
        blk[i] = int16_t(level < 0 ? level * qmul - qadd : level * qmul + qadd);
      }
    }
  }

  void dequant_inter_mpeg(int16_t* blk) {  // MPEG quantisation, with mismatch control
    const int q = qscale;
    int sum = -1;
    for (int i = 0; i < 64; i++) {
      int level = blk[i];
      if (!level) continue;
      const int a = std::abs(level);
      const int v = uint16_t((2 * a + 1) * uint16_t(2 * q * inter_matrix[i])) >> 5;
      blk[i] = int16_t(level < 0 ? -v : v);
      sum += blk[i];
    }
    blk[63] = int16_t(blk[63] ^ (sum & 1));
  }

  void idct_put(int16_t* blk, uint8_t* dst, int stride) {
    xvid_idct ? idct_xvid(blk) : idct_simple(blk);
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) dst[y * stride + x] = clip8(blk[y * 8 + x]);
  }

  void idct_add(int16_t* blk, uint8_t* dst, int stride) {
    xvid_idct ? idct_xvid(blk) : idct_simple(blk);
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) dst[y * stride + x] = clip8(dst[y * stride + x] + blk[y * 8 + x]);
  }

  Plane plane_of(const Picture& p, int c) const {
    if (c == 0) {
      const bool edge = bugs & BUG_EDGE;
      return Plane{p.plane[0].data(), p.lw, edge ? width : p.lw, edge ? height : p.lh};
    }
    const bool edge = bugs & BUG_EDGE;
    return Plane{p.plane[c].data(), p.cw, edge ? width >> 1 : p.cw, edge ? height >> 1 : p.ch};
  }

  // one 8 x 8 or 16 x 16 block at (sx, sy) + half-pel dxy
  void hpel_block(Op op, int dxy, uint8_t* dst, int ds, const Plane& r, int sx, int sy, int n) {
    uint8_t tmp[17 * 17];
    fetch(r, sx, sy, n + 1, n + 1, tmp, 17);
    hpel(op, dxy, dst, ds, tmp, 17, n, n);
  }

  void chroma_4mv(Op op, uint8_t* dcb, uint8_t* dcr, const Picture& ref, int mx, int my) {
    static const uint8_t roundtab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    mx = roundtab[mx & 0xf] + ((mx >> 3) & ~1);
    my = roundtab[my & 0xf] + ((my >> 3) & ~1);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int sx = mb_x * 8 + mx, sy = mb_y * 8 + my;
    sx = std::min(std::max(sx, -8), width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    hpel_block(op, dxy, dcb, ref.cw, plane_of(ref, 1), sx, sy, 8);
    hpel_block(op, dxy, dcr, ref.cw, plane_of(ref, 2), sx, sy, 8);
  }

  // one field of a 16 x 8 field-predicted macroblock (FFmpeg's
  // mpeg_motion_field / qpel_motion with field_based): the reference's
  // field fs, read as every other row of the frame (clamped to the frame)
  void field_motion(int dir, int i, const Picture& ref, Op op, uint8_t* dy, uint8_t* dcb,
                    uint8_t* dcr) {
    const int ls = ref.lw, cs = ref.cw, fs = field_select[dir][i];
    const int mxv = mv[dir][i][0], myv = mv[dir][i][1];
    uint8_t tmp[18 * 17];
    dy += i * ls;
    dcb += i * cs;
    dcr += i * cs;
    auto fetch_field = [&](const Plane& r, int x, int fy, int w, int h, uint8_t* dst) {
      for (int k = 0; k < h; k++) {
        const int yy = std::min(std::max(2 * (fy + k) + fs, 0), r.eh - 1);
        fetch(r, x, yy, w, 1, dst + k * 17, 17);
      }
    };
    int uvdxy, uvx, uvy;
    if (quarter_sample) {
      const int dxy = ((myv & 3) << 2) | (mxv & 3);
      const int sx = mb_x * 16 + (mxv >> 2), sy = mb_y * 8 + (myv >> 2);
      int mx = mxv / 2, my = myv >> 1;
      mx = (mx >> 1) | (mx & 1);
      my = (my >> 1) | (my & 1);
      uvdxy = (mx & 1) | ((my & 1) << 1);
      uvx = mb_x * 8 + (mx >> 1);
      uvy = mb_y * 4 + (my >> 1);
      for (int half = 0; half < 2; half++) {
        fetch_field(plane_of(ref, 0), sx + 8 * half, sy, 9, 9, tmp);
        qpel(op, dxy, dy + 8 * half, 2 * ls, tmp, 17, 8);
      }
    } else {
      const int dxy = ((myv & 1) << 1) | (mxv & 1);
      const int sx = mb_x * 16 + (mxv >> 1), sy = mb_y * 8 + (myv >> 1);
      if (bugs & BUG_HPEL_CHROMA) unsupported("DivX interlaced half-pel chroma");
      uvdxy = dxy | (myv & 2) | ((mxv & 2) >> 1);
      uvx = sx >> 1;
      uvy = sy >> 1;
      fetch_field(plane_of(ref, 0), sx, sy, 17, 9, tmp);
      hpel(op, dxy, dy, 2 * ls, tmp, 17, 16, 8);
    }
    fetch_field(plane_of(ref, 1), uvx, uvy, 9, 5, tmp);
    hpel(op, uvdxy, dcb, 2 * cs, tmp, 17, 8, 4);
    fetch_field(plane_of(ref, 2), uvx, uvy, 9, 5, tmp);
    hpel(op, uvdxy, dcr, 2 * cs, tmp, 17, 8, 4);
  }

  void motion(int dir, const Picture& ref, Op op, uint8_t* dy, uint8_t* dcb, uint8_t* dcr) {
    const int ls = ref.lw, cs = ref.cw;
    if (mcsel) {
      real_sprite_points == 1 ? gmc1_motion(ref, dy, dcb, dcr) : gmc_motion(ref, dy, dcb, dcr);
      return;
    }
    if (mv_type == MV_FIELD) {
      field_motion(dir, 0, ref, op, dy, dcb, dcr);
      field_motion(dir, 1, ref, op, dy, dcb, dcr);
      return;
    }
    if (mv_type == MV_16X16) {
      const int mxv = mv[dir][0][0], myv = mv[dir][0][1];
      if (quarter_sample) {
        const int dxy = ((myv & 3) << 2) | (mxv & 3);
        const int sx = mb_x * 16 + (mxv >> 2), sy = mb_y * 16 + (myv >> 2);
        int mx, my;
        if (bugs & BUG_QPEL_CHROMA2) {
          static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
          mx = (mxv >> 1) + rtab[mxv & 7];
          my = (myv >> 1) + rtab[myv & 7];
        } else if (bugs & BUG_QPEL_CHROMA) {
          mx = (mxv >> 1) | (mxv & 1);
          my = (myv >> 1) | (myv & 1);
        } else {
          mx = mxv / 2;
          my = myv / 2;
        }
        mx = (mx >> 1) | (mx & 1);
        my = (my >> 1) | (my & 1);
        const int uvdxy = (mx & 1) | ((my & 1) << 1);
        mx >>= 1;
        my >>= 1;
        uint8_t tmp[17 * 17];
        fetch(plane_of(ref, 0), sx, sy, 17, 17, tmp, 17);
        qpel(op, dxy, dy, ls, tmp, 17, 16);
        hpel_block(op, uvdxy, dcr, cs, plane_of(ref, 2), mb_x * 8 + mx, mb_y * 8 + my, 8);
        hpel_block(op, uvdxy, dcb, cs, plane_of(ref, 1), mb_x * 8 + mx, mb_y * 8 + my, 8);
      } else {
        const int dxy = ((myv & 1) << 1) | (mxv & 1);
        const int sx = mb_x * 16 + (mxv >> 1), sy = mb_y * 16 + (myv >> 1);
        const int uvdxy = dxy | (myv & 2) | ((mxv & 2) >> 1);
        hpel_block(op, dxy, dy, ls, plane_of(ref, 0), sx, sy, 16);
        hpel_block(op, uvdxy, dcb, cs, plane_of(ref, 1), sx >> 1, sy >> 1, 8);
        hpel_block(op, uvdxy, dcr, cs, plane_of(ref, 2), sx >> 1, sy >> 1, 8);
      }
      return;
    }
    int mx = 0, my = 0;  // 8 x 8
    for (int i = 0; i < 4; i++) {
      const int mxv = mv[dir][i][0], myv = mv[dir][i][1];
      uint8_t* dest = dy + (i & 1) * 8 + (i >> 1) * 8 * ls;
      if (quarter_sample) {
        int dxy = ((myv & 3) << 2) | (mxv & 3);
        int sx = mb_x * 16 + (mxv >> 2) + (i & 1) * 8, sy = mb_y * 16 + (myv >> 2) + (i >> 1) * 8;
        sx = std::min(std::max(sx, -16), width);
        if (sx == width) dxy &= ~3;
        sy = std::min(std::max(sy, -16), height);
        if (sy == height) dxy &= ~12;
        uint8_t tmp[17 * 17];
        fetch(plane_of(ref, 0), sx, sy, 9, 9, tmp, 17);
        qpel(op, dxy, dest, ls, tmp, 17, 8);
        mx += mxv / 2;
        my += myv / 2;
      } else {
        int dxy = 0;
        int sx = mb_x * 16 + (i & 1) * 8 + (mxv >> 1), sy = mb_y * 16 + (i >> 1) * 8 + (myv >> 1);
        sx = std::min(std::max(sx, -16), width);
        if (sx != width) dxy |= mxv & 1;
        sy = std::min(std::max(sy, -16), height);
        if (sy != height) dxy |= (myv & 1) << 1;
        hpel_block(op, dxy, dest, ls, plane_of(ref, 0), sx, sy, 8);
        mx += mxv;
        my += myv;
      }
    }
    chroma_4mv(op, dcb, dcr, ref, mx, my);
  }

  void reconstruct_mb() {  // ff_mpv_reconstruct_mb
    const int mb_xy = mb_x + mb_y * mb_stride;
    cur->qscale[mb_xy] = int8_t(qscale);
    if (!mb_intra) {
      if (mbintra[mb_xy]) clean_intra_table_entries();
    } else {
      mbintra[mb_xy] = 1;
    }
    mb_skipped = 0;
    const int ls = cur->lw, cs = cur->cw;
    uint8_t* dy = cur->plane[0].data() + mb_y * 16 * ls + mb_x * 16;
    uint8_t* dcb = cur->plane[1].data() + mb_y * 8 * cs + mb_x * 8;
    uint8_t* dcr = cur->plane[2].data() + mb_y * 8 * cs + mb_x * 8;
    const int dls = interlaced_dct ? 2 * ls : ls, doff = interlaced_dct ? ls : 8 * ls;
    uint8_t* dst[6] = {dy, dy + 8, dy + doff, dy + doff + 8, dcb, dcr};
    const int stride[6] = {dls, dls, dls, dls, cs, cs};
    if (!mb_intra) {
      Op op = (!no_rounding || pict_type == PT_B) ? PUT : PUT_NO_RND;
      if (mv_dir & DIR_FWD) {
        motion(0, *last, op, dy, dcb, dcr);
        op = AVG;
      }
      if (mv_dir & DIR_BWD) motion(1, *next, op, dy, dcb, dcr);
      for (int i = 0; i < 6; i++) {
        if (block_last_index[i] < 0) continue;
        if (mpeg_quant) dequant_inter_mpeg(block[i]);
        idct_add(block[i], dst[i], stride[i]);
      }
    } else {
      for (int i = 0; i < 6; i++) {
        dequant_intra(block[i], i);
        idct_put(block[i], dst[i], stride[i]);
      }
    }
  }

  // --- data partitioning (I- and P-VOPs of a data-partitioned VOL) ---------------
  static constexpr uint32_t DC_MARKER = 0x6B001, MOTION_MARKER = 0x1F001;

  int partition_a() {  // mpeg4_decode_partition_a: -> the video packet's macroblocks
    static const int quant_tab[4] = {-1, -2, 1, 2};
    const Tables& t = tables();
    int count = 0;
    first_slice_line = 1;
    for (; mb_y < mb_h; mb_y++) {
      for (; mb_x < mb_w; mb_x++) {
        const int xy = mb_x + mb_y * mb_stride;
        count++;
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) first_slice_line = 0;
        if (pict_type == PT_I) {
          int cbpc;
          do {
            if (gb.show(19) == DC_MARKER) return count - 1;
            cbpc = t.intra_mcbpc.decode(gb);
            if (cbpc < 0) fail("bad intra MCBPC at macroblock %d, %d", mb_x, mb_y);
          } while (cbpc == 8);
          cbp_table[xy] = uint8_t(cbpc & 3);
          cur->mbtype[xy] = MB_INTRA;
          mb_intra = 1;
          if (cbpc & 4) {
            set_qscale(qscale + quant_tab[gb.get(2)]);
            stats[ST_DQUANT]++;
          }
          cur->qscale[xy] = int8_t(qscale);
          mbintra[xy] = 1;
          int dir = 0;
          for (int i = 0; i < 6; i++) {
            int d;
            decode_dc(i, &d);
            dir = (dir << 1) | (d ? 1 : 0);
          }
          pred_dir_table[xy] = uint8_t(dir);
        } else {
          int16_t* mot = motion_val(*cur, b8_index(0));
          const int stride = 2 * b8_stride;
          auto set_all = [&](int mx, int my) {
            mot[0] = mot[2] = mot[stride] = mot[2 + stride] = int16_t(mx);
            mot[1] = mot[3] = mot[1 + stride] = mot[3 + stride] = int16_t(my);
          };
          int cbpc;
          for (;;) {
            const uint32_t bits = gb.show(17);
            if (bits == MOTION_MARKER) return count - 1;
            gb.skip(1);
            if (bits & 0x10000) {  // not coded
              cur->mbtype[xy] = MB_SKIP | MB_16X16 | MB_L0;
              set_all(0, 0);
              if (mbintra[xy]) clean_intra_table_entries();
              stats[ST_SKIP_P]++;
              cbpc = -1;
              break;
            }
            cbpc = t.inter_mcbpc.decode(gb);
            if (cbpc < 0) fail("bad MCBPC at macroblock %d, %d", mb_x, mb_y);
            if (cbpc != 20) break;
          }
          if (cbpc < 0) continue;
          cbp_table[xy] = uint8_t(cbpc & (8 + 3));
          mb_intra = (cbpc & 4) != 0;
          if (mb_intra) {
            cur->mbtype[xy] = MB_INTRA;
            mbintra[xy] = 1;
            set_all(0, 0);
            stats[ST_INTRA_IN_P]++;
          } else {
            if (mbintra[xy]) clean_intra_table_entries();
            int px, py;
            if ((cbpc & 16) == 0) {
              pred_motion(0, &px, &py);
              const int mx = decode_motion(px, f_code);
              const int my = decode_motion(py, f_code);
              cur->mbtype[xy] = MB_16X16 | MB_L0;
              set_all(mx, my);
            } else {
              cur->mbtype[xy] = MB_8X8 | MB_L0;
              stats[ST_4MV]++;
              for (int i = 0; i < 4; i++) {
                int16_t* m = pred_motion(i, &px, &py);
                const int mx = decode_motion(px, f_code);
                const int my = decode_motion(py, f_code);
                m[0] = int16_t(mx);
                m[1] = int16_t(my);
              }
            }
          }
        }
        if (gb.pos > gb.size) fail("partition A ends inside macroblock %d, %d", mb_x, mb_y);
      }
      mb_x = 0;
    }
    return count;
  }

  void partition_b(int count) {  // mpeg4_decode_partition_b
    static const int quant_tab[4] = {-1, -2, 1, 2};
    const Tables& t = tables();
    int n = 0;
    mb_x = resync_mb_x;
    first_slice_line = 1;
    for (mb_y = resync_mb_y; n < count; mb_y++) {
      for (; n < count && mb_x < mb_w; mb_x++) {
        const int xy = mb_x + mb_y * mb_stride;
        n++;
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) first_slice_line = 0;
        if (pict_type == PT_I) {
          const int acp = gb.get1();
          const int cbpy = t.cbpy.decode(gb);
          if (cbpy < 0) fail("bad CBPY at macroblock %d, %d", mb_x, mb_y);
          cbp_table[xy] |= uint8_t(cbpy << 2);
          if (acp) {
            cur->mbtype[xy] |= MB_ACPRED;
            stats[ST_ACPRED]++;
          }
        } else if (cur->mbtype[xy] & MB_INTRA) {
          const int acp = gb.get1();
          const int cbpy = t.cbpy.decode(gb);
          if (cbpy < 0) fail("bad CBPY at macroblock %d, %d", mb_x, mb_y);
          if (cbp_table[xy] & 8) {
            set_qscale(qscale + quant_tab[gb.get(2)]);
            stats[ST_DQUANT]++;
          }
          cur->qscale[xy] = int8_t(qscale);
          int dir = 0;
          for (int i = 0; i < 6; i++) {
            int d;
            decode_dc(i, &d);
            dir = (dir << 1) | (d ? 1 : 0);
          }
          cbp_table[xy] = uint8_t((cbp_table[xy] & 3) | (cbpy << 2));
          if (acp) {
            cur->mbtype[xy] |= MB_ACPRED;
            stats[ST_ACPRED]++;
          }
          pred_dir_table[xy] = uint8_t(dir);
        } else if (cur->mbtype[xy] & MB_SKIP) {
          cur->qscale[xy] = int8_t(qscale);
          cbp_table[xy] = 0;
        } else {
          const int cbpy = t.cbpy.decode(gb);
          if (cbpy < 0) fail("bad CBPY at macroblock %d, %d", mb_x, mb_y);
          if (cbp_table[xy] & 8) {
            set_qscale(qscale + quant_tab[gb.get(2)]);
            stats[ST_DQUANT]++;
          }
          cur->qscale[xy] = int8_t(qscale);
          cbp_table[xy] = uint8_t((cbp_table[xy] & 3) | ((cbpy ^ 0xF) << 2));
        }
        if (gb.pos > gb.size) fail("partition B ends inside macroblock %d, %d", mb_x, mb_y);
      }
      if (n >= count) return;
      mb_x = 0;
    }
  }

  void decode_partitions() {  // ff_mpeg4_decode_partitions
    const int count = partition_a();
    if (count <= 0) fail("empty video packet partition at macroblock %d, %d", mb_x, mb_y);
    if (resync_mb_x + resync_mb_y * mb_w + count > mb_num) fail("video packet past the VOP");
    mb_num_left = count;
    if (pict_type == PT_I) {
      while (gb.show(9) == 1) gb.skip(9);
      if (gb.get(19) != DC_MARKER) fail("no DC marker after partition A at macroblock %d, %d", mb_x, mb_y);
    } else {
      while (gb.show(10) == 1) gb.skip(10);
      if (gb.get(17) != MOTION_MARKER)
        fail("no motion marker after partition A at macroblock %d, %d", mb_x, mb_y);
    }
    partition_b(count);
  }

  int decode_partitioned_mb() {  // mpeg4_decode_partitioned_mb
    const int xy = mb_x + mb_y * mb_stride;
    const uint16_t mb_type = cur->mbtype[xy];
    int cbp = cbp_table[xy];
    use_intra_dc_vlc = qscale < intra_dc_threshold;
    if (cur->qscale[xy] != qscale) set_qscale(cur->qscale[xy]);
    std::memset(block, 0, sizeof block);
    if (pict_type == PT_P) {
      for (int i = 0; i < 4; i++) {
        const int16_t* m = motion_val(*cur, b8_index(i));
        mv[0][i][0] = m[0];
        mv[0][i][1] = m[1];
      }
      mb_intra = (mb_type & MB_INTRA) != 0;
      if (mb_type & MB_SKIP) {
        for (int i = 0; i < 6; i++) block_last_index[i] = -1;
        mv_dir = DIR_FWD;
        mv_type = MV_16X16;
        mb_skipped = 1;
      } else if (mb_intra) {
        ac_pred = (mb_type & MB_ACPRED) != 0;
      } else {
        mv_dir = DIR_FWD;
        mv_type = (mb_type & MB_8X8) ? MV_8X8 : MV_16X16;
      }
    } else {
      mb_intra = 1;
      ac_pred = (mb_type & MB_ACPRED) != 0;
    }
    if (!(mb_type & MB_SKIP))
      for (int i = 0; i < 6; i++) {
        decode_block(block[i], i, cbp & 32, mb_intra);
        cbp += cbp;
      }
    if (gb.pos > gb.size) fail("VOP data ends inside macroblock %d, %d", mb_x, mb_y);
    if (--mb_num_left <= 0) {
      if (is_resync()) return SLICE_END;
      fail("a video packet's last macroblock is not followed by its end (macroblock %d, %d)", mb_x, mb_y);
    }
    if (is_resync()) {
      const int delta = mb_x + 1 == mb_w ? 2 : 1;
      if (cbp_table[xy + delta]) return SLICE_END;
    }
    return SLICE_OK;
  }

  // decode_slice: -> true when it reached its end marker
  bool decode_slice() {
    resync_mb_x = mb_x;
    resync_mb_y = mb_y;
    first_slice_line = 1;
    set_qscale(qscale);
    if (partitioned_frame) {
      const int q = qscale;
      decode_partitions();
      first_slice_line = 1;
      mb_x = resync_mb_x;
      mb_y = resync_mb_y;
      set_qscale(q);
    }
    for (; mb_y < mb_h; mb_y++) {
      if (mb_y == resync_mb_y) first_slice_line = 1;
      for (; mb_x < mb_w; mb_x++) {
        if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = 0;
        mv_dir = DIR_FWD;
        mv_type = MV_16X16;
        const int ret = partitioned_frame ? decode_partitioned_mb() : decode_mb();
        if (pict_type != PT_B) update_motion_val();
        reconstruct_mb();
        if (ret == SLICE_END) {
          padding_bug_score--;
          if (++mb_x >= mb_w) {
            mb_x = 0;
            mb_y++;
          }
          return true;
        }
      }
      mb_x = 0;
    }
    // no end marker after the last macroblock: FFmpeg's padding-bug guess
    const long left = gb.left();
    if (left >= 48 && gb.show(24) == 0x4010) padding_bug_score += 32;
    if (left >= 0 && left < 137) {
      if (left == 0) {
        padding_bug_score += 16;
      } else if (left != 1) {
        const int v = int(gb.show(8)) | (0x7F >> (7 - (gb.pos & 7)));
        if (v == 0x7F && left <= 8) padding_bug_score--;
        else if (v == 0x7F && ((gb.pos + 8) & 8) && left <= 16) padding_bug_score += 4;
        else padding_bug_score++;
      }
    }
    if (padding_bug_score > -2 && !data_partitioning) bugs |= BUG_NO_PADDING;
    else bugs &= ~BUG_NO_PADDING;
    return false;
  }

  // ff_mpeg4_decode_video_packet_header, reached by ff_h263_resync at its
  // expected place (after the slice's stuffing)
  void video_packet() {
    gb.skip(1);
    gb.align();
    if (gb.show(16) != 0) fail("no resync marker where the video packet ends (macroblock %d, %d)", mb_x, mb_y);
    if (gb.pos > gb.size - 20) fail("truncated video packet header");
    int len = 0;
    for (; len < 32; len++)
      if (gb.get1()) break;
    if (len != prefix_length()) fail("resync marker does not match the fcode");
    const int mb_num_bits = 32 - __builtin_clz(unsigned(mb_num - 1) | 1);
    const int n = int(gb.get(mb_num_bits));
    if (n >= mb_num || !n) fail("bad macroblock number %d in a video packet", n);
    if (n != mb_x + mb_y * mb_w) fail("video packet at macroblock %d, expected %d", n, mb_x + mb_y * mb_w);
    mb_x = n % mb_w;
    mb_y = n / mb_w;
    const int q = int(gb.get(quant_precision));
    if (q) qscale = q;
    if (gb.get1()) {  // header_extension_code
      while (gb.get1()) {
        if (gb.pos > gb.size) fail("truncated video packet header");
      }
      gb.skip(1);
      gb.skip(time_increment_bits);
      gb.skip(1);
      gb.skip(2);
      gb.skip(3);
      if (pict_type == PT_S) unsupported("MPEG-4 GMC video packets with a header extension");
      if (pict_type != PT_I) gb.skip(3);
      if (pict_type == PT_B) gb.skip(3);
    }
    stats[ST_PACKETS]++;
  }

  void alloc_context() {
    mb_w = (width + 15) / 16;
    mb_h = (height + 15) / 16;
    mb_num = mb_w * mb_h;
    mb_stride = mb_w + 1;
    b8_stride = 2 * mb_w + 1;
    const int y_size = b8_stride * (2 * mb_h + 1), c_size = mb_stride * (mb_h + 1);
    dc_wrap[0] = b8_stride;
    dc_wrap[1] = dc_wrap[2] = mb_stride;
    dc_off[0] = b8_stride + 1;
    dc_off[1] = dc_off[2] = mb_stride + 1;
    for (int p = 0; p < 3; p++) {
      const int n = p ? c_size : y_size;
      dc_val[p].assign(n, 1024);
      ac_val[p].assign(size_t(n) * 16, 0);
    }
    mbintra.assign(size_t(mb_stride) * (mb_h + 1), 1);
    cbp_table.assign(size_t(mb_stride) * (mb_h + 1) + 2, 0);
    pred_dir_table.assign(size_t(mb_stride) * (mb_h + 1) + 2, 0);
    for (auto& f : p_field_mv)
      for (auto& t : f) t.assign(size_t(2) * mb_stride * (mb_h + 1), 0);
  }

  std::shared_ptr<Picture> new_picture(long tag, bool planes) {
    auto p = std::make_shared<Picture>();
    p->type = pict_type;
    p->tag = tag;
    p->lw = mb_w * 16;
    p->lh = mb_h * 16;
    p->cw = mb_w * 8;
    p->ch = mb_h * 8;
    if (planes) {
      p->plane[0].assign(size_t(p->lw) * p->lh, 0);
      p->plane[1].assign(size_t(p->cw) * p->ch, 0);
      p->plane[2].assign(size_t(p->cw) * p->ch, 0);
    }
    p->mv.assign(size_t(2) * (mv_off() + b8_stride * (2 * mb_h + 2) + 8), 0);
    p->mbskip.assign(size_t(mb_stride) * (mb_h + 1) + 2, 0);
    p->mbtype.assign(size_t(mb_stride) * (mb_h + 1) + 2, 0);
    p->qscale.assign(size_t(mb_stride) * (mb_h + 1) + 2, 0);
    p->ref_index.assign(size_t(4) * (mb_stride * (mb_h + 1) + 2), 0);
    return p;
  }

  // ff_h263_decode_frame: -> 1 when a frame is ready in `out`
  int decode(const uint8_t* buf, long size, long tag, bool parse_only) {
    out.reset();
    if (size == 0) {
      if (!low_delay && next) {
        out = next;
        next.reset();
      }
      return out ? 1 : 0;
    }
    for (int attempt = 0;; attempt++) {
      if (divx_packed && !stored.empty()) {
        for (long i = 0; i + 3 < size; i++) {
          if (buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1) {
            if (buf[i + 3] == 0xB0) stored.clear();
            break;
          }
        }
      }
      std::vector<uint8_t> data;
      long data_tag = tag;
      const bool from_stored = !stored.empty() && (divx_packed || size <= 19);
      if (from_stored) {
        data.swap(stored);
        data_tag = stored_tag;
      }
      stored.clear();
      if (!extradata.empty() && picture_number == 0) {
        Bits eb(extradata.data(), long(extradata.size()));
        picture_header(eb, true);
      }
      gb = from_stored ? Bits(data.data(), long(data.size())) : Bits(buf, size);
      if (picture_header(gb, false) == FRAME_SKIPPED) return 0;
      if (!mb_w || mb_w != (width + 15) / 16 || mb_h != (height + 15) / 16) alloc_context();
      if (pict_type != PT_B && mb_num / 2 > gb.left()) fail("VOP too short for its macroblocks");
      if (workaround_bugs() && attempt == 0) continue;
      if ((!last || !next) && pict_type == PT_B) {  // no reference pictures (yet)
        stats[ST_SKIPPED_B]++;
        return 0;
      }
      if (pict_type != PT_S) stats[pict_type == PT_I ? ST_I : pict_type == PT_P ? ST_P : ST_B]++;
      if (no_rounding) stats[ST_ROUND1]++;
      stats[ST_QPEL] = quarter_sample;
      stats[ST_MPEG_QUANT] = mpeg_quant;
      stats[ST_XVID_IDCT] = xvid_idct;
      stats[ST_INTERLACED] = !progressive;
      if (pict_type == PT_S) stats[real_sprite_points > 1 ? ST_GMC_AFFINE : ST_S]++;
      if (partitioned_frame) stats[ST_PARTITIONED]++;
      if (alternate_scan) stats[ST_ALT_SCAN]++;
      cur = new_picture(data_tag, !parse_only);
      if (pict_type != PT_B) {
        last = next;
        next = cur;
      }
      if (!last && pict_type != PT_I) fail("a P-VOP without a reference picture");
      if (!parse_only) decode_macroblocks();
      if (divx_packed) store_packed(buf, size, from_stored, tag);
      if (pict_type == PT_B || low_delay) out = cur;
      else if (last) out = last;
      if (!(last || low_delay)) out.reset();
      return out ? 1 : 0;
    }
  }

  void decode_macroblocks() {  // every macroblock, through the video packets
    mb_x = mb_y = 0;
    decode_slice();
    while (mb_y < mb_h) {
      video_packet();
      clean_buffers();
      decode_slice();
    }
  }

  // ff_mpeg4_frame_end: keep a B-VOP packed after this VOP
  void store_packed(const uint8_t* buf, long size, bool from_stored, long tag) {
    const long current_pos = from_stored ? 0 : (gb.pos >> 3);
    if (size - current_pos <= 7) return;
    for (long i = current_pos; i < size - 4; i++) {
      if (buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1 && buf[i + 3] == 0xB6) {
        if (!(buf[i + 4] & 0x40)) {
          stored.assign(buf + current_pos, buf + size);
          stored_tag = tag | (1L << 32);  // the packet's second VOP
          stats[ST_PACKED]++;
        }
        break;
      }
    }
  }

  void reset() {  // ff_mpeg_flush
    cur.reset();
    last.reset();
    next.reset();
    out.reset();
    stored.clear();
    pp_time = 0;
  }
};

int report(char* err, int err_len, const char* msg, int code) {
  if (err && err_len > 0) std::snprintf(err, size_t(err_len), "%s", msg);
  return code;
}

}  // namespace

extern "C" void* fvd_open(const uint8_t* config, long n, uint32_t fourcc, char* err, int err_len) {
  try {
    auto* d = new Decoder();
    d->fourcc = fourcc;
    if (n > 0) {
      d->extradata.assign(config, config + n);
      Bits b(config, n);
      d->picture_header(b, true);
    }
    return d;
  } catch (const Unsupported& e) {
    report(err, err_len, (std::string("unsupported: ") + e.what()).c_str(), 0);
  } catch (const std::exception& e) {
    report(err, err_len, e.what(), 0);
  }
  return nullptr;
}

extern "C" int fvd_decode(void* h, const uint8_t* data, long n, long tag, int parse_only,
                          char* err, int err_len) {
  auto* d = static_cast<Decoder*>(h);
  try {
    return d->decode(data, n, tag, parse_only != 0);
  } catch (const Unsupported& e) {
    return report(err, err_len, e.what(), -2);
  } catch (const std::exception& e) {
    return report(err, err_len, e.what(), -1);
  }
}

extern "C" int fvd_take(void* h, uint8_t* y, uint8_t* cb, uint8_t* cr, long* tag) {
  auto* d = static_cast<Decoder*>(h);
  if (!d->out) return -1;
  const Picture& p = *d->out;
  const int w = d->width, hh = d->height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  if (y)
    for (int r = 0; r < hh; r++) std::memcpy(y + size_t(r) * w, &p.plane[0][size_t(r) * p.lw], w);
  if (cb)
    for (int r = 0; r < ch; r++) std::memcpy(cb + size_t(r) * cw, &p.plane[1][size_t(r) * p.cw], cw);
  if (cr)
    for (int r = 0; r < ch; r++) std::memcpy(cr + size_t(r) * cw, &p.plane[2][size_t(r) * p.cw], cw);
  if (tag) *tag = p.tag;
  return 0;
}

extern "C" int fvd_info(void* h, long* out) {
  auto* d = static_cast<Decoder*>(h);
  out[0] = d->width;
  out[1] = d->height;
  for (int i = 0; i < kStats; i++) out[2 + i] = d->stats[i];
  return 2 + kStats;
}

// swscale's unscaled yuv420p -> RGB as cv2's VideoCapture gets it on x86
// (BT.601 limited range, each chroma sample over its 2 x 2 pixels, the
// SIMD converter's 16-bit fixed point: coefficients x 2^13 / 2^16 on
// values x 8, truncating multiplies); RGB order, [h][w][3].
extern "C" void fvd_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int w, int h,
                        uint8_t* rgb) {
  const int cw = (w + 1) / 2;
  for (int r = 0; r < h; r++) {
    const uint8_t* yr = y + size_t(r) * w;
    const uint8_t* ur = cb + size_t(r / 2) * cw;
    const uint8_t* vr = cr + size_t(r / 2) * cw;
    uint8_t* o = rgb + size_t(r) * w * 3;
    for (int c = 0; c < w; c++) {
      const int yy = ((yr[c] * 8 - 128) * 9539) >> 16;
      const int u = ur[c / 2] * 8 - 1024, v = vr[c / 2] * 8 - 1024;
      o[3 * c] = clip8(yy + ((v * 13075) >> 16));
      o[3 * c + 1] = clip8(yy + ((u * -3209) >> 16) + ((v * -6660) >> 16));
      o[3 * c + 2] = clip8(yy + ((u * 16525) >> 16));
    }
  }
}

extern "C" void fvd_reset(void* h) { static_cast<Decoder*>(h)->reset(); }

extern "C" void fvd_close(void* h) { delete static_cast<Decoder*>(h); }
