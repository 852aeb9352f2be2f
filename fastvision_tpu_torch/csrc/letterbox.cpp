// Batched letterbox (bilinear resize + centred pad) of RGB uint8 images: the
// port's copy of fastvision_tpu/native/letterbox.cpp, behind
// DetectionLoader(use_native=True). Host code, built with the host compiler
// (cuda_build.load("letterbox")) and called through ctypes, which releases the
// GIL; one std::thread per worker over the batch's images.
//
// The JAX package builds the original with -march=native, where GCC contracts
// each multiply feeding an add into one fused multiply-add. The fmaf calls
// below are those contractions written out (the library is built with
// -ffp-contract=off), so every host computes what an FMA host's build of the
// original computes, bit for bit.
//
// C interface:
//   letterbox_batch(srcs, hs, ws, n, size, pad_value, out, scales, pads, num_threads)
//     srcs: n pointers to HWC uint8 RGB images of hs[i] x ws[i];
//     out [n, size, size, 3] uint8; scales [n] float32; pads [n, 2] int32 (x, y)
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// src (h x w x 3) -> the nh x nw region at (top, left) of a size x size x 3 canvas
void resize_into(const uint8_t* src, int h, int w, uint8_t* canvas, int size, int nh, int nw,
                 int top, int left) {
  const float sy = static_cast<float>(h) / nh;
  const float sx = static_cast<float>(w) / nw;
  for (int y = 0; y < nh; ++y) {
    // align_corners=False convention (cv2.INTER_LINEAR)
    float fy = std::fmaf(y + 0.5f, sy, -0.5f);
    int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1);  // floor
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), h - 1);
    int y1c = std::min(y0c + 1, h - 1);
    if (y0 < 0) {
      y1c = y0c;
      wy = 0.f;
    }
    uint8_t* row = canvas + (static_cast<size_t>(top + y) * size + left) * 3;
    for (int x = 0; x < nw; ++x) {
      float fx = std::fmaf(x + 0.5f, sx, -0.5f);
      int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), w - 1);
      int x1c = std::min(x0c + 1, w - 1);
      if (x0 < 0) {
        x1c = x0c;
        wx = 0.f;
      }
      const uint8_t* p00 = src + (static_cast<size_t>(y0c) * w + x0c) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0c) * w + x1c) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1c) * w + x0c) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1c) * w + x1c) * 3;
      for (int c = 0; c < 3; ++c) {
        // p00 (1-wy)(1-wx) + p01 (1-wy) wx + p10 wy (1-wx) + p11 wy wx, summed
        // left to right, each term's last product fused with the sum before
        // it except the second's (its add already consumed the first)
        float v = std::fmaf(p00[c] * (1 - wy), 1 - wx, p01[c] * (1 - wy) * wx);
        v = std::fmaf(p10[c] * wy, 1 - wx, v);
        v = std::fmaf(p11[c] * wy, wx, v);
        row[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

void one_image(const uint8_t* src, int h, int w, int size, uint8_t pad_value, uint8_t* out,
               float* scale, int32_t* pad_xy) {
  std::memset(out, pad_value, static_cast<size_t>(size) * size * 3);
  const float s = static_cast<float>(size) / std::max(h, w);
  const int nh = static_cast<int>(std::fmaf(static_cast<float>(h), s, 0.5f));
  const int nw = static_cast<int>(std::fmaf(static_cast<float>(w), s, 0.5f));
  const int top = (size - nh) / 2;
  const int left = (size - nw) / 2;
  resize_into(src, h, w, out, size, nh, nw, top, left);
  *scale = s;
  pad_xy[0] = left;
  pad_xy[1] = top;
}

}  // namespace

extern "C" {

void letterbox_batch(const uint8_t** srcs, const int32_t* hs, const int32_t* ws, int32_t n,
                     int32_t size, uint8_t pad_value, uint8_t* out, float* scales, int32_t* pads,
                     int32_t num_threads) {
  const size_t img_bytes = static_cast<size_t>(size) * size * 3;
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i)
      one_image(srcs[i], hs[i], ws[i], size, pad_value, out + i * img_bytes, scales + i,
                pads + i * 2);
    return;
  }
  std::atomic<int> counter(0);
  std::vector<std::thread> pool;
  const int workers = std::min<int>(num_threads, n);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (int i = counter.fetch_add(1); i < n; i = counter.fetch_add(1))
        one_image(srcs[i], hs[i], ws[i], size, pad_value, out + i * img_bytes, scales + i,
                  pads + i * 2);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
