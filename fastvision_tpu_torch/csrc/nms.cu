// Greedy NMS suppression mask for Hopper (sm_90a), batched over images.
//
// Replaces fastvision_tpu/ops/nms_pallas.py::_nms_kernel (and computes what
// fastvision_tpu/ops/nms.py::suppression_mask computes): over K boxes sorted
// by descending score, box i is kept iff its score is > -inf and no KEPT
// earlier box j has inter / (area_j + area_i - inter + 1e-7) > thr.
//
// Two kernels, both on the caller's stream, neither synchronises:
//   1. overlap_mask_kernel: grid (ceil(K/64) column tiles, ceil(K/64) row
//      tiles, B), 64 threads. A block stages its 64 column boxes in shared
//      memory; thread t builds row i = 64 * row_tile + t's 64-bit word over
//      the tile: bit c set iff column j = 64 * col_tile + c > i and
//      iou(i, j) > thr. Tiles below the diagonal are never written and never
//      read. Scratch mask: [B, K, ceil(K/64)] uint64.
//   2. greedy_scan_kernel: one warp per image. Lane w holds word w of the
//      "removed" set (K <= 2048, so ceil(K/64) <= 32 words). Rows are staged
//      64 at a time into shared memory, the valid flags of those 64 rows come
//      from two ballots, and the serial step for row i reads only shared
//      memory and registers: kept iff valid and not removed, and if kept its
//      row is OR-ed into the removed set.
//
// What bounds it on an H100: the pair work is ~K^2/2 IoUs per image at ~14
// fp32 operations each (no tensor cores), and the bytes are only the boxes
// and scores in and the keep mask out (~21 B per box), so phase 1 is bound by
// operations; phase 2 is a K-step dependent chain per image, which the
// design keeps out of device memory (shared memory and registers only) and
// runs for all images at once, one warp each.
//
// Exactness: the plain version rounds every intermediate as its own float32
// tensor. The arithmetic below uses the _rn intrinsics and the build passes
// --fmad=false, so nothing is contracted into an FMA (at class-offset
// magnitudes, ~3.3e5, a contracted area_i + area_j - iw * ih rounds
// otherwise and can flip a pair that sits on the threshold). Division is
// IEEE (__fdiv_rn), and the test is iou > thr in float32, as in the plain
// version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // boxes per tile: one 64-bit mask word
constexpr int kMaxWords = 32;   // one removed-set word per lane: K <= 2048
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__global__ void __launch_bounds__(kTile) overlap_mask_kernel(
    const float* __restrict__ boxes, unsigned long long* __restrict__ mask,
    int K, int n_words, float thr) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  if (col_tile < row_tile) return;  // below the diagonal: every j < i
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const float* img = boxes + (size_t)b * K * 4;

  __shared__ float4 cols[kTile];
  const int j0 = col_tile * kTile;
  if (j0 + t < K) {
    const float* p = img + (size_t)(j0 + t) * 4;
    cols[t] = make_float4(p[0], p[1], p[2], p[3]);
  }
  __syncthreads();

  const int i = row_tile * kTile + t;
  if (i >= K) return;
  const float* q = img + (size_t)i * 4;
  const float x1 = q[0], y1 = q[1], x2 = q[2], y2 = q[3];
  const float area_i = box_area(x1, y1, x2, y2);
  // With inter == 0 (or NaN) the IoU is 0, -0 or NaN, never > thr when
  // thr >= 0: the division is skipped for disjoint pairs only then.
  const bool exact_all = !(thr >= 0.f);
  const int n_cols = min(kTile, K - j0);

  unsigned long long bits = 0ull;
  for (int c = 0; c < n_cols; ++c) {
    if (j0 + c <= i) continue;
    const float4 bj = cols[c];
    const float iw = fmaxf(__fsub_rn(fminf(x2, bj.z), fmaxf(x1, bj.x)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(y2, bj.w), fmaxf(y1, bj.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    if (inter > 0.f || exact_all) {
      const float area_j = box_area(bj.x, bj.y, bj.z, bj.w);
      const float uni = __fadd_rn(__fsub_rn(__fadd_rn(area_i, area_j), inter), 1e-7f);
      if (__fdiv_rn(inter, uni) > thr) bits |= 1ull << c;
    }
  }
  mask[((size_t)b * K + i) * n_words + col_tile] = bits;
}

__global__ void __launch_bounds__(32) greedy_scan_kernel(
    const float* __restrict__ scores, const unsigned long long* __restrict__ mask,
    unsigned char* __restrict__ keep, int K, int n_words) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* s = scores + (size_t)b * K;
  const unsigned long long* m = mask + (size_t)b * K * n_words;
  unsigned char* out = keep + (size_t)b * K;

  __shared__ unsigned long long rows[kTile][kMaxWords];
  unsigned long long removed = 0ull;  // word `lane` of the removed set

  for (int t = 0; t < n_words; ++t) {
    const int i0 = t * kTile;
    const int n_rows = min(kTile, K - i0);
    // stage words t..n_words-1 of rows i0..i0+n_rows-1 (words < t lie
    // below the diagonal and are never needed)
    const int span = n_words - t;
    for (int idx = lane; idx < n_rows * span; idx += 32) {
      const int r = idx / span;
      const int w = t + idx % span;
      rows[r][w] = m[(size_t)(i0 + r) * n_words + w];
    }
    const int ia = i0 + lane;
    const int ib = i0 + 32 + lane;
    const unsigned lo = __ballot_sync(kFullWarp, ia < K && s[ia] > -INFINITY);
    const unsigned hi = __ballot_sync(kFullWarp, ib < K && s[ib] > -INFINITY);
    const unsigned long long valid = (unsigned long long)lo | ((unsigned long long)hi << 32);
    __syncwarp();

    unsigned long long cur = __shfl_sync(kFullWarp, removed, t);  // word t, every lane
    unsigned long long kept = 0ull;
    for (int r = 0; r < n_rows; ++r) {
      const unsigned long long bit = 1ull << r;
      if ((valid & bit) && !(cur & bit)) {  // uniform across the warp
        kept |= bit;
        cur |= rows[r][t];
        if (lane > t && lane < n_words) removed |= rows[r][lane];
      }
    }
    if (ia < K) out[ia] = (unsigned char)((kept >> lane) & 1ull);
    if (ib < K) out[ib] = (unsigned char)((kept >> (32 + lane)) & 1ull);
    __syncwarp();  // the next chunk overwrites `rows`
  }
}

}  // namespace

extern "C" {

// boxes [B, K, 4] float32 xyxy, scores [B, K] float32, mask scratch
// [B, K, ceil(K/64)] uint64, keep out [B, K] bytes (0/1). Returns the first
// non-zero cudaError_t of the launches, 0 on success.
int fv_nms_suppression_mask(const float* boxes, const float* scores, void* mask,
                            unsigned char* keep, int B, int K, float thr,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxWords * kTile || B > 65535) return (int)cudaErrorInvalidValue;
  const int n_words = (K + kTile - 1) / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  overlap_mask_kernel<<<dim3(n_words, n_words, B), kTile, 0, st>>>(
      boxes, (unsigned long long*)mask, K, n_words, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  greedy_scan_kernel<<<B, 32, 0, st>>>(
      scores, (const unsigned long long*)mask, keep, K, n_words);
  return (int)cudaGetLastError();
}

const char* fv_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
